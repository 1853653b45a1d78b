"""The port's optym support modules against the JAX package's.

``problem`` (autodiff derivatives and the finite-difference fall-through),
``governors``, ``linesearch``, ``cost``, ``activation``, ``operators``,
``sample_problems``, ``checkpoint`` (a checkpoint the JAX package writes,
resumed in the port; ``interop.optimizer_state_from_numpy``) and
``plotting``.  Every function on the same inputs from a seeded numpy
generator, under ``jax_enable_x64`` with ``config.precision = 64`` and the
CPU.  Bars: closed forms <= 1e-12 relative; finite differences, computed by
both packages from the same host floats, equal; optimizer iterates <= 1e-10
relative.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prysm_tpu.x import optym as jo
from prysm_tpu.x.optym import checkpoint as jck

from prysm_tpu_torch import interop
from prysm_tpu_torch.conf import config
from prysm_tpu_torch.x import optym as to
from prysm_tpu_torch.x.optym import problem as tpr

torch.set_num_threads(2)

BAR = 1e-12


@pytest.fixture(autouse=True)
def _cpu_f64(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _host(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, bar=BAR):
    a, b = _host(a).astype(np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-300) if b.size else 1.0
    assert np.abs(a - b).max() / scale <= bar if b.size else True


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# problem: autodiff derivatives and the finite-difference fall-through
# ---------------------------------------------------------------------------

class _TorchSmooth(to.Problem):
    has_f = True

    def _f(self, x):
        return torch.sum(torch.sin(x) * x ** 2) + torch.prod(torch.cos(x[:2]))


class _JaxSmooth(jo.Problem):
    has_f = True

    def _f(self, x):
        return jnp.sum(jnp.sin(x) * x ** 2) + jnp.prod(jnp.cos(x[:2]))


def _host_cubic(x):
    x = np.asarray(x, dtype=np.float64)
    return float(np.sum(x ** 3 - 2 * x) + x[0] * x[-1])


class _TorchHost(to.Problem):
    """An objective that reads its input to the host: autodiff cannot trace it."""
    has_f = True

    def _f(self, x):
        return _host_cubic(_host(x))


class _JaxHost(jo.Problem):
    has_f = True

    def _f(self, x):
        return _host_cubic(np.asarray(x))


@pytest.mark.parametrize('hook', ['g', 'h', 'hvp', 'fg'])
def test_autodiff_derivatives_match_jax(hook):
    x, v = _rng(1).standard_normal(5), _rng(2).standard_normal(5)
    mine, ref = _TorchSmooth(), _JaxSmooth()
    args = (x, v) if hook == 'hvp' else (x,)
    got = getattr(mine, hook)(*(torch.as_tensor(a) for a in args))
    want = getattr(ref, hook)(*args)
    if hook == 'fg':
        _close(got[0], want[0])
        _close(got[1], want[1])
    else:
        assert torch.is_tensor(got)
        _close(got, want)


@pytest.mark.parametrize('method', ['central', 'forward'])
@pytest.mark.parametrize('hook', ['g', 'h', 'hvp'])
def test_finite_difference_fallthrough_matches_jax(method, hook):
    x, v = _rng(3).standard_normal(4), _rng(4).standard_normal(4)
    mine, ref = _TorchHost(fd_method=method), _JaxHost(fd_method=method)
    args = (x, v) if hook == 'hvp' else (x,)
    got, want = getattr(mine, hook)(*args), getattr(ref, hook)(*args)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_problem_validation_and_adapters():
    with pytest.raises(ValueError):
        to.Problem(fd_method='backward')
    with pytest.raises(NotImplementedError):
        to.Problem().f(np.ones(2))
    with pytest.raises(TypeError):
        to.as_problem(3)
    p = to.as_problem(lambda x: (torch.sum(x ** 2), 2 * x))
    assert to.as_problem(p) is p
    f, g = to.as_problem(lambda x: torch.sum(x ** 3), scalar=True).fg(np.ones(3) * 2)
    assert float(f) == 24.0
    _close(g, np.full(3, 12.0))
    # a scalar objective that cannot be traced falls through to finite differences
    f, g = to.as_problem(lambda x: _host_cubic(_host(x)), scalar=True).fg(np.ones(3))
    fj, gj = jo.as_problem(lambda x: _host_cubic(np.asarray(x)), scalar=True).fg(np.ones(3))
    np.testing.assert_array_equal(g, np.asarray(gj))


def test_to_host():
    assert isinstance(tpr.to_host(torch.ones(2)), np.ndarray)
    assert tpr.to_host([1.0, 2.0]).tolist() == [1.0, 2.0]


# ---------------------------------------------------------------------------
# governors: the same decisions on the same record stream
# ---------------------------------------------------------------------------

def _governors(m):
    return {
        'max-iterations': m.MaxIterations(4),
        'max-evaluations': m.MaxEvaluations(5),
        'function': m.FunctionTolerance(1e-3),
        'function-absolute': m.FunctionTolerance(1e-3, relative=False),
        'gradient': m.GradientTolerance(0.05),
        'gradient-l2': m.GradientTolerance(0.08, norm=2),
        'step': m.StepTolerance(2e-3),
        'constraint': m.ConstraintTolerance(1e-2),
        'any': m.AnyGovernor([m.MaxIterations(6), m.GradientTolerance(0.02)]),
        'all': m.AllGovernor([m.MaxIterations(2), m.FunctionTolerance(1e-2)]),
        'or': m.MaxIterations(3) | m.GradientTolerance(1e-9),
        'and': m.MaxIterations(3) & m.StepTolerance(0.5),
    }


class _Opt:
    nfev = 0


def _stream(m, as_tensor):
    rng = _rng(5)
    x = rng.standard_normal(3)
    opt = _Opt()
    for k in range(1, 9):
        g = rng.standard_normal(3) / k ** 2
        x_next = x - 0.1 * g / k
        opt.nfev = 2 * k
        wrap = (lambda a: torch.as_tensor(a)) if as_tensor else (lambda a: jnp.asarray(a))
        yield m.StepRecord(optimizer=opt, iteration=k, x=wrap(x), f=1.0 / k, g=wrap(g),
                           x_next=wrap(x_next),
                           metadata={'constraint_violation': 0.1 / k ** 2,
                                     **({'f_next': 1.0 / (k + 1)} if k % 2 else {})})
        x = x_next


@pytest.mark.parametrize('name', list(_governors(to)))
def test_governor_decisions_match_jax(name):
    mine, ref = _governors(to)[name], _governors(jo)[name]
    got = [tuple(mine.observe(r)) for r in _stream(to, True)]
    want = [tuple(ref.observe(r)) for r in _stream(jo, False)]
    assert got == want


def test_governor_validation_and_result():
    with pytest.raises(ValueError):
        to.MaxIterations(-1)
    decision = to.GovernorDecision(True, True, 'done')
    res = to.OptimizationResult(np.zeros(2), decision, [], _Opt())
    assert res.success and res.nit == 0 and res.nfev == 0 and 'done' in repr(res)


# ---------------------------------------------------------------------------
# the strong-Wolfe line search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('start,direction', [([-1.2, 1.0], None), ([0.5, 0.3, -0.2], None),
                                             ([1.0, 1.0], [1.0, 1.0])],
                         ids=['steepest-2d', 'steepest-3d', 'ascent'])
def test_strong_wolfe_matches_jax(start, direction):
    x = np.asarray(start)
    _, g = jo.rosenbrock(jnp.asarray(x))
    pk = -np.asarray(g) if direction is None else np.asarray(direction)
    got = to.ls_strong_wolfe(to.rosenbrock, torch.as_tensor(x), torch.as_tensor(pk))
    want = jo.ls_strong_wolfe(jo.rosenbrock, jnp.asarray(x), pk)
    if want[0] is None:
        assert got == (None, None, None, None)
        return
    for a, b in zip(got[:3], want[:3]):
        assert a == pytest.approx(float(b), rel=BAR)
    _close(got[3], want[3])


# ---------------------------------------------------------------------------
# cost functions, activations, operators, sample problems
# ---------------------------------------------------------------------------

COSTS = ['bias_and_gain_invariant_error', 'mean_square_error', 'negative_loglikelihood']


@pytest.mark.parametrize('masked', [False, True], ids=['full', 'masked'])
@pytest.mark.parametrize('name', COSTS)
def test_costs_match_jax(name, masked):
    rng = _rng(6)
    M, D = rng.uniform(0.1, 0.9, (12, 10)), rng.uniform(0.1, 0.9, (12, 10))
    mask = rng.uniform(size=(12, 10)) > 0.3 if masked else None
    got = getattr(to, name)(torch.as_tensor(M), torch.as_tensor(D), mask=mask)
    want = getattr(jo, name)(jnp.asarray(M), jnp.asarray(D), mask=mask)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_cost_dtype_mismatch_raises():
    with pytest.raises(TypeError, match='dtype mismatch'):
        to.mean_square_error(torch.ones(3), torch.ones(3, dtype=torch.float64))


def _pair(cls_name, *args):
    return getattr(to, cls_name)(*args), getattr(jo, cls_name)(*args)


@pytest.mark.parametrize('name', ['Tanh', 'Arctan', 'Softplus', 'Sigmoid'])
def test_affine_activations_match_jax(name):
    x = _rng(7).standard_normal(20)
    mine, ref = _pair(name, 1.7, 0.3, -0.2)
    _close(mine.forward(torch.as_tensor(x)), ref.forward(jnp.asarray(x)))
    _close(mine.backprop(torch.as_tensor(x)), ref.backprop(jnp.asarray(x)))


def test_softmax_and_discrete_encoder_match_jax():
    rng = _rng(8)
    x, grad = rng.standard_normal((6, 5)), rng.standard_normal((6, 5))
    mine, ref = to.Softmax(), jo.Softmax()
    _close(mine.forward(torch.as_tensor(x)), ref.forward(jnp.asarray(x)))
    _close(mine.backprop(torch.as_tensor(grad)), ref.backprop(jnp.asarray(grad)))
    enc_m, enc_j = to.DiscreteEncoder(to.Softmax(), 5), jo.DiscreteEncoder(jo.Softmax(), 5)
    _close(enc_m.forward(torch.as_tensor(x)), enc_j.forward(jnp.asarray(x)))
    g = rng.standard_normal(6)
    _close(enc_m.backprop(torch.as_tensor(g)), enc_j.backprop(jnp.asarray(g)))
    np.testing.assert_array_equal(_host(enc_m.discretize(torch.as_tensor(x))),
                                  np.asarray(enc_j.discretize(jnp.asarray(x))))


def test_gumbel_softmax_matches_jax_on_the_same_uniforms(monkeypatch):
    """The port draws from a torch.Generator; fed the same uniforms, both packages agree."""
    x = _rng(9).standard_normal((4, 6))
    gen = torch.Generator().manual_seed(3)
    mine = to.GumbelSoftmax(tau=0.7, generator=gen)
    u = torch.rand(x.shape, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    monkeypatch.setattr(jax.random, 'uniform', lambda key, shape: jnp.asarray(u.numpy()))
    ref = jo.GumbelSoftmax(tau=0.7, eps=mine.eps)
    _close(mine.forward(torch.as_tensor(x)), ref.forward(jnp.asarray(x)))
    grad = _rng(10).standard_normal((4, 6))
    _close(mine.backprop(torch.as_tensor(grad)), ref.backprop(jnp.asarray(grad)))
    # the generator advances: a second draw differs
    assert not torch.equal(mine.forward(torch.as_tensor(x)), mine.forward(torch.as_tensor(x)))


@pytest.mark.parametrize('which', ['forward_x', 'adjoint_x', 'forward_y', 'adjoint_y'])
def test_spatial_gradient_matches_jax(which):
    a = _rng(11).standard_normal((7, 9))
    got = getattr(to.SpatialGradient2D(), which)(torch.as_tensor(a))
    _close(got, getattr(jo.SpatialGradient2D(), which)(jnp.asarray(a)))


def test_spatial_gradient_adjoint_identity():
    rng = _rng(12)
    a, b = torch.as_tensor(rng.standard_normal((6, 8))), torch.as_tensor(rng.standard_normal((6, 8)))
    op = to.SpatialGradient2D()
    for fwd, adj in ((op.forward_x, op.adjoint_x), (op.forward_y, op.adjoint_y)):
        assert float(torch.sum(fwd(a) * b)) == pytest.approx(float(torch.sum(a * adj(b))), rel=BAR)


SAMPLES = [('SphereProblem', 4), ('RosenbrockProblem', 4), ('RastriginProblem', 3),
           ('HimmelblauProblem', 2)]


@pytest.mark.parametrize('name,n', SAMPLES, ids=[s[0] for s in SAMPLES])
def test_sample_problems_match_jax(name, n):
    rng = _rng(13)
    x, v = rng.standard_normal(n), rng.standard_normal(n)
    mine, ref = getattr(to, name)(), getattr(jo, name)()
    _close(mine.f(x), ref.f(x))
    for hook in ('g', 'h'):
        _close(getattr(mine, hook)(x), getattr(ref, hook)(x))
    _close(mine.hvp(x, v), ref.hvp(x, v))
    f, g = getattr(to, name.removesuffix('Problem').lower())(x)
    fj, gj = getattr(jo, name.removesuffix('Problem').lower())(x)
    _close(f, fj)
    _close(g, gj)


def test_sample_problem_validation():
    with pytest.raises(ValueError):
        to.rosenbrock(np.ones(1))
    with pytest.raises(ValueError):
        to.himmelblau(np.ones(3))


# ---------------------------------------------------------------------------
# checkpoints: the JAX package writes, the port resumes
# ---------------------------------------------------------------------------

def _run(opt, n):
    xs = []
    for _ in range(n):
        opt.step()
        xs.append(np.array(_host(opt.x), dtype=np.float64))
    return xs


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A PrysmLBFGSB run checkpointed by the JAX package after 4 steps continues in the port
    as it continues in the JAX package."""
    lo = np.full(4, -0.3)
    ref = jo.PrysmLBFGSB(jo.rosenbrock, jnp.zeros(4), lower_bounds=lo)
    _run(ref, 4)
    path = tmp_path / 'jax.pkl'
    jck.save_checkpoint(path, ref)
    mine = to.PrysmLBFGSB(to.rosenbrock, np.zeros(4), lower_bounds=lo)
    payload = to.load_checkpoint(path, mine)
    assert payload['optimizer_type'] == 'PrysmLBFGSB' and mine.iter == 4
    assert torch.is_tensor(mine._S) and mine._prev[0].device.type == 'cpu'
    resumed = jo.PrysmLBFGSB(jo.rosenbrock, jnp.zeros(4), lower_bounds=lo)
    jck.load_checkpoint(path, resumed)
    a, b = _run(mine, 8), _run(resumed, 8)
    for xa, xb in zip(a, b):
        assert np.abs(xa - xb).max() / np.abs(xb).max() <= 1e-10


@pytest.mark.parametrize('cls', ['Adam', 'RMSProp'])
def test_port_checkpoint_loads_in_the_jax_package(tmp_path, cls):
    mine = getattr(to, cls)(to.sphere, np.ones(3), 0.1)
    _run(mine, 3)
    to.save_checkpoint(tmp_path / 'port.pkl', mine, metadata={'who': 'port'})
    ref = getattr(jo, cls)(jo.sphere, jnp.ones(3), 0.1)
    payload = jck.load_checkpoint(tmp_path / 'port.pkl', ref)
    assert payload['metadata'] == {'who': 'port'} and ref.iter == 3
    np.testing.assert_array_equal(np.asarray(ref.x), _host(mine.x))
    with pytest.raises(TypeError):
        to.load_checkpoint(tmp_path / 'port.pkl', to.Yogi(to.sphere, np.ones(3), 0.1))


def test_checkpoint_governor_and_scipy_driver_state(tmp_path):
    path = tmp_path / 'every.pkl'
    opt = to.LBFGSB(to.rosenbrock, np.zeros(3))
    to.run_until(opt, to.AnyGovernor([to.MaxIterations(4), to.CheckpointGovernor(path, every=2)]))
    fresh = to.LBFGSB(to.rosenbrock, np.zeros(3))
    payload = to.load_checkpoint(path, fresh)
    assert [r['iteration'] for r in payload['records']] == [1, 2, 3, 4]
    # the driver's buffers come back as host numpy, so the driver runs on
    assert isinstance(fresh._wa, np.ndarray)
    fresh.step()


def test_interop_optimizer_state_from_numpy(tmp_path):
    lo = np.full(3, -0.2)
    ref = jo.PrysmLBFGSB(jo.rosenbrock, jnp.zeros(3), lower_bounds=lo)
    _run(ref, 3)
    state = jo.optimizer_state(ref)
    values = interop.optimizer_state_from_numpy(state, device='cpu')
    assert torch.is_tensor(values['_S']) and values['_S'].dtype == torch.float64
    assert isinstance(values['_prev'], tuple) and values['iter'] == 3
    mine = to.PrysmLBFGSB(to.rosenbrock, np.zeros(3), lower_bounds=lo)
    vars(mine).update(values)
    resumed = jo.PrysmLBFGSB(jo.rosenbrock, jnp.zeros(3), lower_bounds=lo)
    jo.restore_optimizer_state(resumed, state)
    for xa, xb in zip(_run(mine, 5), _run(resumed, 5)):
        assert np.abs(xa - xb).max() / np.abs(xb).max() <= 1e-10
    # a whole payload of the SciPy driver keeps its buffers on the host
    driver = jo.LBFGSB(jo.rosenbrock, np.zeros(3))
    _run(driver, 2)
    jck.save_checkpoint(tmp_path / 'd.pkl', driver)
    payload = jck.load_checkpoint(tmp_path / 'd.pkl')
    values = interop.optimizer_state_from_numpy(payload)
    assert isinstance(values['_wa'], np.ndarray)
    with pytest.raises(ValueError):
        interop.optimizer_state_from_numpy({'format': 'other', 'state': {}})


def test_plot_convergence_draws():
    pytest.importorskip('matplotlib')
    import matplotlib
    matplotlib.use('Agg')
    res = to.run_until(to.PrysmLBFGSB(to.rosenbrock, np.zeros(3), lower_bounds=np.full(3, 0.2)),
                       to.MaxIterations(5))
    fig, ax = to.plot_convergence(res, ('f', 'g', 'bounded'))
    assert len(ax) == 3
    with pytest.raises(ValueError):
        to.plot_convergence(res, ('speed',))
