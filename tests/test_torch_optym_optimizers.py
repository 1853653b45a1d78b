"""The port's first-order optimizers, drivers and damped least squares against the JAX package's.

Every optimizer (``GradientDescent``, ``AdaGrad``, ``RMSProp``, ``Adam``,
``RAdam``, ``AdaMomentum``, ``Yogi``) runs 20 iterations on the same problem
from the same start, unbounded and inside a box that some coordinates hit,
and its iterates are held to the JAX package's; ``run_until`` / ``runN``
produce the same records; ``DampedLeastSquares`` runs a small nonlinear
least-squares fit with and without constraints, on host float64 in both
packages.  Inputs from seeded numpy generators, ``jax_enable_x64``,
``config.precision = 64``, CPU.  Bars: optimizer iterates <= 1e-10 relative
over the first 20 iterations; DLS iterates and results <= 1e-10 relative.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prysm_tpu.x import optym as jo

from prysm_tpu_torch.conf import config
from prysm_tpu_torch.x import optym as to

torch.set_num_threads(2)

ITERS, BAR = 20, 1e-10


@pytest.fixture(autouse=True)
def _cpu_f64(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _host(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, bar=BAR):
    a, b = np.asarray(_host(a), np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() / max(np.abs(b).max(), 1e-300) <= bar


# (optimizer, step size, extra keyword arguments)
OPTIMIZERS = [('GradientDescent', 1e-3, {}), ('AdaGrad', 0.05, {}), ('RMSProp', 0.01, {}),
              ('RMSProp', 0.01, {'gamma': 0.8}), ('Adam', 0.05, {}),
              ('Adam', 0.05, {'beta1': 0.8, 'beta2': 0.99}), ('RAdam', 2e-3, {}),
              ('AdaMomentum', 0.05, {}), ('Yogi', 0.05, {})]
IDS = [f'{n}-{i}' for i, (n, _, _) in enumerate(OPTIMIZERS)]


def _start(seed=0, n=4):
    return np.random.default_rng(seed).uniform(-1.0, 1.5, n)


def _run(opt, n=ITERS):
    out = []
    for _ in range(n):
        x, f, g = opt.step()
        out.append((np.array(_host(opt.x), np.float64), float(f)))
    return out


@pytest.mark.parametrize('bounded', [False, True], ids=['free', 'box'])
@pytest.mark.parametrize('name,alpha,kwargs', OPTIMIZERS, ids=IDS)
def test_optimizer_trajectory_matches_jax(name, alpha, kwargs, bounded):
    x0 = _start()
    box = dict(lower_bounds=np.full(4, -0.2), upper_bounds=np.full(4, 1.1)) if bounded else {}
    mine = getattr(to, name)(to.rosenbrock, x0, alpha, **kwargs, **box)
    ref = getattr(jo, name)(jo.rosenbrock, jnp.asarray(x0), alpha, **kwargs, **box)
    for k, ((xa, fa), (xb, fb)) in enumerate(zip(_run(mine), _run(ref))):
        assert np.isfinite(xb).all(), k
        _close(xa, np.asarray(xb))
        assert fa == pytest.approx(fb, rel=1e-12), k
    assert mine.x.dtype == torch.float64
    if bounded:
        assert mine.last_step_metadata['bounded_variables'] == \
            ref.last_step_metadata['bounded_variables']
        np.testing.assert_array_equal(_host(mine.last_step_metadata['active_bounds']),
                                      np.asarray(ref.last_step_metadata['active_bounds']))


def test_bounds_validation_and_shapes():
    with pytest.raises(ValueError):
        to.Adam(to.sphere, np.zeros(2), 0.1, lower_bounds=[1.0, 1.0], upper_bounds=[0.0, 0.0])
    with pytest.raises(ValueError):
        to.Adam(to.sphere, np.zeros(2), 0.1, lower_bounds=np.zeros(3))
    opt = to.GradientDescent(to.sphere, np.zeros((2, 2)), 0.1, lower_bounds=np.full(4, 0.5))
    assert opt.l.shape == (2, 2) and float(opt.x.min()) == 0.5


def test_run_until_and_runN_match_jax():
    x0 = _start(1)
    mine = to.run_until(to.Adam(to.rosenbrock, x0, 0.05),
                        to.AnyGovernor([to.MaxIterations(15), to.GradientTolerance(1e-12)]))
    ref = jo.run_until(jo.Adam(jo.rosenbrock, jnp.asarray(x0), 0.05),
                       jo.AnyGovernor([jo.MaxIterations(15), jo.GradientTolerance(1e-12)]))
    assert (mine.nit, mine.message, mine.success) == (ref.nit, ref.message, ref.success)
    np.testing.assert_allclose([r.f for r in mine.records], [r.f for r in ref.records], rtol=1e-12)
    _close(mine.x, np.asarray(ref.x))
    assert to.run_until(to.Adam(to.sphere, x0, 0.1), to.MaxIterations(5), maxiter=0).nit == 0
    assert to.run_until(to.Adam(to.sphere, x0, 0.1), to.MaxIterations(50), maxiter=3).nit == 3
    got = [f for _, f, _ in to.runN(to.Yogi(to.sphere, x0, 0.1), 6)]
    want = [float(f) for _, f, _ in jo.runN(jo.Yogi(jo.sphere, jnp.asarray(x0), 0.1), 6)]
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_run_until_stops_on_stop_iteration():
    opt = to.PrysmLBFGSB(to.sphere, np.zeros(3))
    res = to.run_until(opt, to.MaxIterations(10))
    assert res.nit == 0 and res.success and 'projected gradient' in res.message


# ---------------------------------------------------------------------------
# damped least squares
# ---------------------------------------------------------------------------

T_SAMPLES = np.linspace(0.0, 2.0, 25)
Y_SAMPLES = 1.7 * np.exp(-1.3 * T_SAMPLES) + 0.25 * np.sin(3.0 * T_SAMPLES) + 0.1


class _Fit:
    """A three-parameter exponential + offset fit: host residuals in one package, tensors in
    the other, the same numbers."""

    def __init__(self, as_tensor):
        self.as_tensor = as_tensor

    def x0(self):
        return np.asarray([1.0, -0.5, 0.0])

    def residuals(self, x):
        x = np.asarray(_host(x), dtype=np.float64)
        r = x[0] * np.exp(x[1] * T_SAMPLES) + x[2] - Y_SAMPLES
        return torch.as_tensor(r) if self.as_tensor else jnp.asarray(r)


# (keyword arguments) for the DLS runs
DLS_CASES = {
    'plain': {},
    'adaptive': {'adaptive_damping': True, 'damping': 1e-2},
    'sensitivity': {'damping_mode': 'sensitivity', 'damping': 1e-3, 'trust_radii': 0.3},
    'inequality': {'inequality_constraints': lambda x: np.asarray([1.2 - np.asarray(x)[0]])},
    'equality': {'equality_constraints': lambda x: np.asarray([np.asarray(x)[2] - 0.05])},
}


@pytest.mark.parametrize('case', list(DLS_CASES))
def test_damped_least_squares_matches_jax(case):
    kwargs = DLS_CASES[case]
    mine = to.damped_least_squares(_Fit(True), maxiter=15, **kwargs)
    ref = jo.damped_least_squares(_Fit(False), maxiter=15, **kwargs)
    assert (mine.nit, mine.nfev, mine.njev, mine.ncev, mine.message, mine.success) == \
        (ref.nit, ref.nfev, ref.njev, ref.ncev, ref.message, ref.success)
    _close(mine.x, ref.x)
    assert mine.cost == pytest.approx(ref.cost, rel=BAR)
    for a, b in zip(mine.history, ref.history):
        _close(a['x'], b['x'])
    np.testing.assert_array_equal(mine.active_inequalities, ref.active_inequalities)


def test_damped_least_squares_step_api_and_validation():
    opt = to.DampedLeastSquares(_Fit(True), maxiter=3)
    x, f, g = opt.step()
    assert isinstance(opt.x, np.ndarray) and f > opt.current.cost
    assert opt.constraint_violation == 0.0
    with pytest.raises(ValueError):
        to.DampedLeastSquares(_Fit(True), damping_mode='other')
    with pytest.raises(TypeError):
        to.DampedLeastSquares(object())
    res = to.DampedLeastSquares(_Fit(True), maxiter=0).run()
    assert res.nit == 0 and 'maximum iterations' in res.message


def test_active_set_qp_returns_the_set_it_solved_with():
    """When the rounds run out while the working set still changes, the step, the
    multipliers and the set returned belong together (the JAX package raises here)."""
    from prysm_tpu_torch.x.optym.least_squares import _active_set_qp
    H = np.eye(2)
    g = np.asarray([-4.0, 0.0])
    # x0 <= 1 linearized: cineq + Aineq dx >= 0
    Aineq = np.asarray([[-1.0, 0.0]])
    cineq = np.asarray([1.0])
    dx, lam_eq, lam_ineq, working = _active_set_qp(H, g, np.zeros((0, 2)), np.zeros(0),
                                                   Aineq, cineq, [], 1e-10, 1)
    # one round: the unconstrained step was solved with the empty set
    np.testing.assert_allclose(dx, [4.0, 0.0])
    assert working.size == 0 and lam_ineq.tolist() == [0.0]
    dx, _, lam_ineq, working = _active_set_qp(H, g, np.zeros((0, 2)), np.zeros(0), Aineq, cineq,
                                              [], 1e-10, 5)
    np.testing.assert_allclose(dx, [1.0, 0.0])
    assert working.tolist() == [0] and lam_ineq[0] < 0
