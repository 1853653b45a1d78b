"""The slice's two paths on the CPU at a small size, against the same composition in the JAX package.

* ``steps.build_coating_design`` at 9 layers and 32 wavelengths (8 in the
  reflect band, 24 in the transmit band, 2 angles) and a needle synthesis
  at 16 wavelengths x 3 angles: the start, the merit and its gradient, the
  bounded L-BFGS-B refinement iterate for iterate, and the synthesis with
  the same layers, against the JAX package's ``x.coatings`` on the same
  numbers; damped least squares, where the JAX package's active-set loop
  raises, is held to the merit it lowers and the floor it keeps.
* ``steps.build_phase_retrieval_lbfgsb`` on a 64^2 pupil to a 32^2 focal
  grid, the JAX package's pupil and MDFT plan carried over
  (``interop.pupil_from_numpy``, ``interop.mdft_from_numpy``): its
  ``PrysmLBFGSB`` run iterate for iterate against the JAX package's on the
  JAX forward (the mode stack), fused and unfused.

``jax_enable_x64``, ``config.precision = 64``, CPU.  Bars: closed forms
<= 1e-12 relative; optimizer iterates <= 1e-10 relative over the first 20
iterations; the synthesis's layers equal, its thicknesses and merit <= 1e-6
relative (it refines 15 iterations a round).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prysm_tpu.coordinates import make_xy_grid, cart_to_polar
from prysm_tpu.geometry import circle_sdf, antialias
from prysm_tpu.polynomials import zernike_nm_seq, sum_of_2d_modes
from prysm_tpu.propagation import Wavefront, prepare_executor
from prysm_tpu.x import coatings as jc, optym as jo

from prysm_tpu_torch import interop, steps
from prysm_tpu_torch.conf import config

torch.set_num_threads(2)

BAR, ITERATE_BAR, SYNTH_BAR = 1e-12, 1e-10, 1e-6
SMALL = dict(pairs=4, samples=(8, 24), needle_samples=16,
             needle=dict(z_samples=40, max_layers=8, max_iters=2, refine_kwargs={'maxiter': 15}))


@pytest.fixture(autouse=True)
def _cpu_f64(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _host(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(a, b):
    a, b = np.asarray(_host(a), np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope='module')
def design():
    return steps.build_coating_design(**SMALL, dtype=torch.float64, device='cpu')


def _jax_terms(design, needle=False):
    """The design's merit terms, built by the JAX package on the port's grids."""
    terms = design.needle_merit if needle else design.merit
    out = []
    for term in terms:
        cls = getattr(jc, type(term).__name__)
        out.append(cls(np.asarray(term.wvl), np.asarray(term.theta), pol=term.pol,
                       target=float(term.target)))
    return out


def _jax_stack(stack):
    return jc.Stack(stack.indices, _host(stack.thicknesses), stack.substrate_index,
                    stack.ambient_index)


def test_design_start_and_merit(design):
    assert len(design.stack0) == 9
    assert sum(t.wvl.numel() for t in design.merit) == 32
    quarter = steps.COATING_WVL0 / (4 * np.asarray(design.stack0.indices))
    rng = np.random.default_rng(steps.COATING_SEED)
    np.testing.assert_array_equal(_host(design.stack0.thicknesses),
                                  quarter * (1 + steps.COATING_SPREAD * rng.standard_normal(9)))
    ref = jc.MeritFunction(_jax_terms(design))
    mine = design.problem()
    f, g = mine.fg(mine.x0())
    fj, gj = ref.value_and_grad(_jax_stack(design.stack0))
    assert f == pytest.approx(fj, rel=BAR)
    assert _rel(g, gj) <= BAR


def test_design_refine_lbfgsb_matches_jax(design):
    """The path's bounded L-BFGS-B refinement, its first 20 iterations against the JAX package's."""
    mine = design.refine('lbfgsb', 20)
    ref = jc.refine(_jax_stack(design.stack0), _jax_terms(design), method='lbfgsb', maxiter=20,
                    min_thickness=steps.COATING_MIN_THICKNESS)
    recs_t, recs_j = mine.optimizer_result.records, ref.optimizer_result.records
    assert len(recs_t) == len(recs_j) == 20
    for a, b in zip(recs_t, recs_j):
        assert _rel(a.x_next, b.x_next) <= ITERATE_BAR
    start = sum(t.value(design.stack0) for t in design.merit)
    assert mine.merit < 0.6 * start
    assert mine.merit == pytest.approx(ref.merit, rel=ITERATE_BAR)
    assert mine.x.dtype == torch.float64


def test_design_refine_lm_lowers_the_merit_where_jax_raises(design):
    start = sum(t.value(design.stack0) for t in design.merit)
    with pytest.raises(ValueError, match='shape mismatch'):
        jc.refine(_jax_stack(design.stack0), _jax_terms(design), method='lm', maxiter=10,
                  min_thickness=steps.COATING_MIN_THICKNESS)
    res = design.refine('lm', 10)
    assert res.merit < start
    assert float(res.stack.thicknesses.min()) >= steps.COATING_MIN_THICKNESS - 1e-12
    # 2n + 1 residual evaluations an iteration, and the backtracking's
    assert res.optimizer_result.nfev >= res.nit * (2 * 9 + 1)


def test_design_synthesis_matches_jax(design):
    mine = design.synthesize()
    ref = jc.synthesize(_jax_stack(design.needle_start), _jax_terms(design, needle=True),
                        steps.NEEDLE_MATERIALS, **design.needle)
    assert (mine.n_layers, mine.iterations) == (ref.n_layers, ref.iterations)
    assert mine.stack.indices == ref.stack.indices
    assert _rel(mine.stack.thicknesses, ref.stack.thicknesses) <= SYNTH_BAR
    assert mine.merit == pytest.approx(ref.merit, rel=SYNTH_BAR)
    assert mine.n_layers > 2


def test_design_problem_runs_in_its_precision(design):
    """The design's problem evaluates in the path's dtype whatever config says outside."""
    with torch.no_grad():
        config.precision = torch.float32
        try:
            f, g = design.problem().fg(design.problem().x0())
        finally:
            config.precision = torch.float64
    assert g.dtype == torch.float64


# ---------------------------------------------------------------------------
# the phase retrieval
# ---------------------------------------------------------------------------

N, FN = 64, 32


def _jax_retrieval():
    x, y = make_xy_grid(N, diameter=2.2)
    r, t = cart_to_polar(x, y)
    dx = 2.2 / N
    amp = antialias(circle_sdf(1.0, r), dx)
    plan = prepare_executor(dx, (N, N), 0.25 * 256 / FN, FN, steps.WVL, steps.EFL)
    modes = zernike_nm_seq(steps.NMS6, r, t)

    def intensity(c):
        wf = Wavefront.from_amp_and_phase(amp, sum_of_2d_modes(modes, c), steps.WVL, dx)
        return wf.focus_dft(plan).intensity.data

    truth = jnp.asarray(steps.COEFS6)
    I_meas = intensity(truth)
    fg = jax.jit(jax.value_and_grad(lambda c: jnp.sum((intensity(c) - I_meas) ** 2)))
    bound = np.full(6, steps.RETRIEVAL_BOUND)
    opt = jo.PrysmLBFGSB(fg, truth * steps.RETRIEVAL_START, lower_bounds=-bound,
                         upper_bounds=bound)
    return (r, t, amp, dx), plan, opt


def _port_retrieval(geom, plan, fused):
    r, t, amp, dx = geom
    pupil = interop.pupil_from_numpy(np.asarray(r), np.asarray(t), np.asarray(amp), dx,
                                     steps.COEFS6, steps.NMS6, device='cpu')
    carried = interop.mdft_from_numpy(
        np.asarray(plan.Ex_re), np.asarray(plan.Ex_im), np.asarray(plan.Ey_re),
        np.asarray(plan.Ey_im), plan.norm, plan.forward_left_first, plan.adjoint_left_first,
        plan.pupil_dx, plan.focal_dx, None, device='cpu')
    return steps.build_phase_retrieval_lbfgsb(pupil, carried, iters=20, fused=fused)


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'mode-stack'])
def test_phase_retrieval_matches_jax(fused):
    geom, plan, ref_opt = _jax_retrieval()
    pr = _port_retrieval(geom, plan, fused)
    f, g = pr.fg(pr.truth * 0.9)
    fj, gj = ref_opt.problem.fg(jnp.asarray(steps.COEFS6) * 0.9)
    assert float(f) == pytest.approx(float(fj), rel=1e-9)
    assert _rel(g, gj) <= 1e-9
    mine = pr()
    ref = jo.run_until(ref_opt, jo.MaxIterations(20))
    assert mine.nit == ref.nit and mine.message == ref.message
    for a, b in zip(mine.records, ref.records):
        assert _rel(a.x_next, b.x_next) <= ITERATE_BAR
    assert _rel(mine.x, steps.COEFS6) <= 1e-6
    assert mine.x.dtype == torch.float64
