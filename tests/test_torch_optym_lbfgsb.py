"""The port's L-BFGS-B optimizers against the JAX package's, and the dense oracles.

Both routes run iterate for iterate against the JAX package on bound-active
problems: ``PrysmLBFGSB`` (the torch BLNZ algorithm, its Cauchy point a host
loop over the breakpoints) and ``LBFGSB`` (SciPy's compiled driver, with a
tensor x0 so that fg sees tensors).  The objectives are host numpy, shared by
both packages.  The compact form, the generalized Cauchy point and the
subspace step are held against the dense oracles of the JAX package's own
tests (a dense BFGS matrix, a dense segment walk, a dense Newton solve).

Bars: optimizer iterates <= 1e-10 relative over the first 20 iterations;
closed forms <= 1e-12 relative; the oracles at the JAX package's own bars.
CPU, float64 (``config.precision = 64``).  One exception: on Rosenbrock's
valley cut by an active bound, ``PrysmLBFGSB`` amplifies a one-ulp
difference of a dot product's summation order about 5x an iteration
(6.7e-16 at iteration 2, 1.6e-10 at iteration 8, 1.0e-8 at iteration 20
against the JAX package), so that trajectory is held to 1e-10 over its
first 7 iterations and then to the same constrained optimum.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prysm_tpu.x import optym as jo
from prysm_tpu.x.optym import lbfgsb as jlb

from prysm_tpu_torch.conf import config
from prysm_tpu_torch.x import optym as to
from prysm_tpu_torch.x.optym import lbfgsb as tlb

torch.set_num_threads(2)

ITERS, ITERATE_BAR = 20, 1e-10


@pytest.fixture(autouse=True)
def _cpu_f64(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _host(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _sphere_fg(x):
    x = np.asarray(_host(x), dtype=np.float64)
    return float(x @ x), 2.0 * x


def _rosenbrock_fg(x):
    x = np.asarray(_host(x), dtype=np.float64)
    f = float(np.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2))
    g = np.zeros_like(x)
    g[:-1] = -400.0 * x[:-1] * (x[1:] - x[:-1] ** 2) - 2.0 * (1.0 - x[:-1])
    g[1:] += 200.0 * (x[1:] - x[:-1] ** 2)
    return f, g


def _make_quadratic(dim, seed=0):
    """(fg, x_star, A) for f = 0.5 (x - x*)^T A (x - x*), A SPD."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((dim, dim))
    A = Q.T @ Q + np.eye(dim) * dim
    x_star = rng.standard_normal(dim)

    def fg(x):
        d = np.asarray(_host(x), dtype=np.float64) - x_star
        return float(0.5 * d @ A @ d), A @ d

    return fg, x_star, A


def _box_quadratic(seed=5):
    """The JAX package's head-to-head: a PD quadratic whose optimum leaves a +-0.25 box."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((10, 10))
    Q = A @ A.T + 10 * np.eye(10)
    b = rng.standard_normal(10) * 10

    def fg(x):
        x = np.asarray(_host(x), dtype=np.float64)
        return float(0.5 * x @ Q @ x - b @ x), Q @ x - b

    return fg


# (name, fg, x0, lower, upper): bound-active problems
PROBLEMS = [
    ('sphere-corner', _sphere_fg, [3.0, 2.0], [1.0, 0.5], None),
    ('rosenbrock-cut', _rosenbrock_fg, [-1.2, 1.0], None, [0.8, np.inf]),
    ('box-quadratic-10d', _box_quadratic(), np.zeros(10), np.full(10, -0.25), np.full(10, 0.25)),
    ('rosenbrock-5d-box', _rosenbrock_fg, np.zeros(5), np.full(5, -0.5), np.full(5, 0.7)),
    ('quadratic-8d-box', _make_quadratic(8, seed=2)[0], np.full(8, 0.1), np.full(8, -0.3),
     np.full(8, 0.3)),
]


def _trajectory(opt, n=ITERS):
    xs = []
    for _ in range(n):
        try:
            opt.step()
        except StopIteration:
            break
        xs.append(np.array(_host(opt.x), dtype=np.float64))
    return xs


def _close_trajectories(a, b, bar=ITERATE_BAR):
    assert len(a) == len(b) and len(a) > 0
    for k, (xa, xb) in enumerate(zip(a, b)):
        err = np.abs(xa - xb).max() / max(np.abs(xb).max(), 1e-300)
        assert err <= bar, (k, err)


def _bounds(lo, hi, n):
    lo = None if lo is None else np.asarray(lo, dtype=np.float64)
    hi = None if hi is None else np.asarray(hi, dtype=np.float64)
    return lo, hi


def test_prysm_lbfgsb_rosenbrock_cut_matches_jax():
    """Rosenbrock's valley cut by x0 <= 0.8: 7 iterates, then the same constrained optimum."""
    hi = np.asarray([0.8, np.inf])
    mine = to.PrysmLBFGSB(_rosenbrock_fg, np.asarray([-1.2, 1.0]), upper_bounds=hi)
    ref = jo.PrysmLBFGSB(_rosenbrock_fg, jnp.asarray([-1.2, 1.0]), upper_bounds=hi)
    _close_trajectories(_trajectory(mine, 7), _trajectory(ref, 7))
    to.run_until(mine, to.MaxIterations(300))
    jo.run_until(ref, jo.MaxIterations(300))
    assert abs(float(mine.x[0]) - 0.8) < 1e-8
    np.testing.assert_allclose(_host(mine.x), np.asarray(ref.x), rtol=1e-8)
    assert _rosenbrock_fg(mine.x)[0] == pytest.approx(_rosenbrock_fg(ref.x)[0], rel=1e-10)


@pytest.mark.parametrize('name,fg,x0,lo,hi', [p for p in PROBLEMS if p[0] != 'rosenbrock-cut'],
                         ids=[p[0] for p in PROBLEMS if p[0] != 'rosenbrock-cut'])
def test_prysm_lbfgsb_iterates_match_jax(name, fg, x0, lo, hi):
    lo, hi = _bounds(lo, hi, len(x0))
    mine = to.PrysmLBFGSB(fg, np.asarray(x0, dtype=np.float64), lower_bounds=lo,
                          upper_bounds=hi)
    ref = jo.PrysmLBFGSB(fg, jnp.asarray(x0, dtype=jnp.float64), lower_bounds=lo,
                         upper_bounds=hi)
    a, b = _trajectory(mine), _trajectory(ref)
    _close_trajectories(a, b)
    assert mine.nfev == ref.nfev
    assert mine.x.dtype == torch.float64 and mine._S.device.type == 'cpu'


@pytest.mark.parametrize('name,fg,x0,lo,hi', PROBLEMS, ids=[p[0] for p in PROBLEMS])
def test_scipy_lbfgsb_iterates_match_jax(name, fg, x0, lo, hi):
    """The SciPy route: a tensor x0 makes fg see tensors; iterates equal the JAX package's."""
    lo, hi = _bounds(lo, hi, len(x0))
    seen = []

    def fg_seen(x):
        seen.append(type(x))
        return fg(x)

    mine = to.LBFGSB(fg_seen, torch.as_tensor(np.asarray(x0, dtype=np.float64)),
                     lower_bounds=lo, upper_bounds=hi)
    ref = jo.LBFGSB(fg, np.asarray(x0, dtype=np.float64), lower_bounds=lo, upper_bounds=hi)
    _close_trajectories(_trajectory(mine), _trajectory(ref))
    assert mine.nfev == ref.nfev
    assert set(seen) == {torch.Tensor}


def test_prysm_lbfgsb_run_until_records_match_jax():
    fg = _box_quadratic(7)
    lo, hi = np.full(10, -0.25), np.full(10, 0.25)
    mine = to.run_until(to.PrysmLBFGSB(fg, np.zeros(10), lower_bounds=lo, upper_bounds=hi),
                        to.AnyGovernor([to.MaxIterations(30), to.FunctionTolerance(1e-14)]))
    ref = jo.run_until(jo.PrysmLBFGSB(fg, jnp.zeros(10), lower_bounds=lo, upper_bounds=hi),
                       jo.AnyGovernor([jo.MaxIterations(30), jo.FunctionTolerance(1e-14)]))
    assert mine.nit == ref.nit and mine.message == ref.message
    np.testing.assert_allclose([r.f for r in mine.records], [r.f for r in ref.records],
                               rtol=1e-12)
    np.testing.assert_allclose(_host(mine.x), np.asarray(ref.x), rtol=ITERATE_BAR, atol=1e-14)


def test_prysm_lbfgsb_float32_tracks_x0():
    opt = to.PrysmLBFGSB(_sphere_fg, np.ones(4, dtype=np.float32),
                         lower_bounds=np.full(4, 0.5), upper_bounds=np.full(4, 2.0))
    opt.step()
    assert opt.x.dtype == opt._S.dtype == opt.l.dtype == torch.float32
    np.testing.assert_allclose(_host(opt.x), 0.5, atol=1e-7)


def test_prysm_lbfgsb_stops_at_stationary_point():
    opt = to.PrysmLBFGSB(_sphere_fg, np.zeros(3))
    with pytest.raises(StopIteration):
        opt.step()
    x, f, g = to.PrysmLBFGSB(_sphere_fg, np.ones(3)).run_to(50)
    assert f < 1e-20


def test_admit_pair_rolls_without_mutating_history():
    opt = to.PrysmLBFGSB(_sphere_fg, np.ones(3), memory=2)
    S0 = opt._S
    for k in range(3):
        opt._admit_pair(torch.tensor([1.0 + k, 0.0, 0.0], dtype=torch.float64),
                        torch.tensor([2.0, 0.0, 0.0], dtype=torch.float64))
    assert torch.equal(S0, torch.zeros(2, 3, dtype=torch.float64))
    np.testing.assert_array_equal(_host(opt._S)[:, 0], [2.0, 3.0])
    assert _host(opt._valid).all() and opt._theta == pytest.approx(4.0 / 6.0)
    # a pair failing the curvature test is refused
    opt._admit_pair(torch.tensor([1.0, 0, 0], dtype=torch.float64),
                    torch.tensor([-1.0, 0, 0], dtype=torch.float64))
    np.testing.assert_array_equal(_host(opt._S)[:, 0], [2.0, 3.0])


# ---------------------------------------------------------------------------
# the compact form, the Cauchy point and the subspace step against dense oracles
# (the JAX package's tests/test_optym_lbfgsb.py:60-140, 370-510)
# ---------------------------------------------------------------------------

def _dense_bfgs_matrix(S, Y, valid, theta, n):
    """B built by iterated dense BFGS updates (not the compact form)."""
    B = np.eye(n) * float(theta)
    for s, y, ok in zip(S, Y, valid):
        if not ok:
            continue
        Bs = B @ s
        B = B - np.outer(Bs, Bs) / (s @ Bs) + np.outer(y, y) / (y @ s)
    return B


def _dense_cauchy(x, g, lo, hi, B):
    """Generalized Cauchy point by explicit segment walk with dense B."""
    n = x.size
    t_hit = np.full(n, np.inf)
    down, up = g > 0, g < 0
    t_hit[down] = (x[down] - lo[down]) / g[down]
    t_hit[up] = (x[up] - hi[up]) / g[up]
    xc = x.astype(np.float64).copy()
    free = np.ones(n, dtype=bool)
    t_prev = 0.0
    for b in np.argsort(t_hit):
        seg = np.where(free, -g, 0.0)
        slope = g @ seg + (xc - x) @ B @ seg
        curv = seg @ B @ seg
        if slope >= 0:
            t_star = 0.0
        elif curv <= 0:
            t_star = np.inf
        else:
            t_star = -slope / curv
        span = t_hit[b] - t_prev
        if t_star < span:
            return xc + t_star * seg
        if not np.isfinite(t_hit[b]):
            return xc
        xc = xc + span * seg
        xc[b] = lo[b] if g[b] > 0 else hi[b]
        free[b] = False
        t_prev = t_hit[b]
    return xc


def _filled(fg, x0, lo, hi, memory, steps):
    opt = to.PrysmLBFGSB(fg, x0, lower_bounds=lo, upper_bounds=hi, memory=memory)
    for _ in range(steps):
        try:
            opt.step()
        except StopIteration:
            break
    return opt


def _parts(opt, g):
    W, M = tlb._compact_form(opt._S, opt._Y, opt._valid, opt._theta)
    g = torch.as_tensor(g, dtype=opt.x.dtype)
    xc, c = tlb._cauchy_point(opt.x, g, opt.l, opt.u, W, M, opt._theta)
    return W, M, g, xc, c


def _B(opt, W, M):
    n = opt.x.numel()
    return opt._theta * np.eye(n) - _host(W) @ _host(M) @ _host(W).T


def test_compact_form_matches_dense_bfgs():
    fg, _, _ = _make_quadratic(6, seed=4)
    opt = _filled(fg, np.zeros(6), None, None, 5, 5)
    W, M = tlb._compact_form(opt._S, opt._Y, opt._valid, opt._theta)
    dense = _dense_bfgs_matrix(_host(opt._S), _host(opt._Y), _host(opt._valid), opt._theta, 6)
    np.testing.assert_allclose(_B(opt, W, M), dense, rtol=1e-8, atol=1e-8)


def test_compact_form_matches_jax():
    fg, _, _ = _make_quadratic(7, seed=3)
    opt = _filled(fg, np.zeros(7), None, None, 4, 6)
    W, M = tlb._compact_form(opt._S, opt._Y, opt._valid, opt._theta)
    Wj, Mj = jlb._compact_form(jnp.asarray(_host(opt._S)), jnp.asarray(_host(opt._Y)),
                               jnp.asarray(_host(opt._valid)), jnp.asarray(opt._theta))
    np.testing.assert_allclose(_host(W), np.asarray(Wj), rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(_host(M), np.asarray(Mj), rtol=1e-10,
                               atol=1e-12 * np.abs(np.asarray(Mj)).max())


@pytest.mark.parametrize('seed', [0, 1, 2, 3, 4])
def test_cauchy_matches_oracle_and_jax(seed):
    rng = np.random.default_rng(seed)
    fg, _, _ = _make_quadratic(6, seed=seed)
    lo, hi = rng.uniform(-2.0, -0.5, 6), rng.uniform(0.5, 2.0, 6)
    opt = _filled(fg, rng.uniform(-0.4, 0.4, 6), lo, hi, 5, 4)
    _, g = fg(opt.x)
    W, M, gt, xc, c = _parts(opt, g)
    x = _host(opt.x)
    np.testing.assert_allclose(_host(xc), _dense_cauchy(x, g, lo, hi, _B(opt, W, M)),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(_host(c), _host(W).T @ (_host(xc) - x), rtol=1e-8, atol=1e-10)
    Wj, Mj = jlb._compact_form(jnp.asarray(_host(opt._S)), jnp.asarray(_host(opt._Y)),
                               jnp.asarray(_host(opt._valid)), jnp.asarray(opt._theta))
    xcj, cj = jlb._cauchy_point(jnp.asarray(x), jnp.asarray(g), jnp.asarray(lo), jnp.asarray(hi),
                                Wj, Mj, jnp.asarray(opt._theta))
    np.testing.assert_allclose(_host(xc), np.asarray(xcj), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(_host(c), np.asarray(cj), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize('x0,g,lo,hi,want', [
    # no history, unconstrained: the unit steepest-descent step
    ([1.0, -2.0, 3.0], [1.0, -2.0, 3.0], None, None, [0.0, 0.0, 0.0]),
    # a variable pinned with the gradient pulling outward stays; the other hits its face
    ([1.0, 0.0], [-5.0, 1.0], [-1.0, -1.0], [1.0, 1.0], [1.0, -1.0]),
    # every variable clamped at the start
    ([1.0, -1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, 1.0], [1.0, -1.0]),
], ids=['unit-step', 'pinned', 'all-clamped'])
def test_cauchy_edge_cases(x0, g, lo, hi, want):
    x0 = np.asarray(x0)
    lo = None if lo is None else np.asarray(lo)
    hi = None if hi is None else np.asarray(hi)
    opt = to.PrysmLBFGSB(_sphere_fg, x0, lower_bounds=lo, upper_bounds=hi)
    *_, xc, _ = _parts(opt, np.asarray(g, dtype=np.float64))
    np.testing.assert_allclose(_host(xc), want, atol=1e-14)


def test_subspace_unconstrained_matches_dense_newton():
    fg, _, _ = _make_quadratic(6, seed=8)
    opt = _filled(fg, np.zeros(6), None, None, 5, 5)
    _, g = fg(opt.x)
    W, M, gt, xc, c = _parts(opt, g)
    xbar = tlb._subspace_step(opt.x, gt, xc, c, opt.l, opt.u, W, M, opt._theta)
    want = _host(opt.x) - np.linalg.solve(_B(opt, W, M), g)
    np.testing.assert_allclose(_host(xbar), want, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize('seed', [9, 11, 12])
def test_subspace_and_direction_match_jax(seed):
    rng = np.random.default_rng(seed)
    fg, _, _ = _make_quadratic(5, seed=seed)
    lo, hi = rng.uniform(-0.3, -0.05, 5), rng.uniform(0.05, 0.3, 5)
    opt = _filled(fg, np.zeros(5), lo, hi, 4, 3)
    _, g = fg(opt.x)
    W, M, gt, xc, c = _parts(opt, g)
    xbar = tlb._subspace_step(opt.x, gt, xc, c, opt.l, opt.u, W, M, opt._theta)
    fixed = (_host(xc) <= lo) | (_host(xc) >= hi)
    np.testing.assert_allclose(_host(xbar)[fixed], _host(xc)[fixed], atol=1e-12)
    assert np.all(_host(xbar) >= lo - 1e-12) and np.all(_host(xbar) <= hi + 1e-12)
    want = jlb._lbfgsb_direction(jnp.asarray(_host(opt.x)), jnp.asarray(g),
                                 jnp.asarray(_host(opt._S)), jnp.asarray(_host(opt._Y)),
                                 jnp.asarray(_host(opt._valid)), jnp.asarray(opt._theta),
                                 jnp.asarray(lo), jnp.asarray(hi))
    got = tlb._lbfgsb_direction(opt.x, gt, opt._S, opt._Y, opt._valid, opt._theta, opt.l, opt.u)
    np.testing.assert_allclose(_host(got), np.asarray(want), rtol=1e-12, atol=1e-14)


def test_scipy_driver_terminal_codes():
    opt = to.LBFGSB(_sphere_fg, np.zeros(2))
    assert opt._terminal(tlb._TASK_ABNORMAL).success is False
    assert opt._terminal(tlb._TASK_CONVERGENCE).success is True
    assert 'ERROR' in opt._terminal(99).message or not opt._terminal(99).success
    x = opt.x
    x[0] = 5.0
    assert opt.x[0] == 0.0
