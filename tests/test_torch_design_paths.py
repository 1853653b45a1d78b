"""The phase retrieval path on the CPU at a small size, against the same composition in the JAX package.

``steps.build_phase_retrieval_lbfgsb`` on a 64^2 pupil to a 32^2 focal
grid, the JAX package's pupil and MDFT plan carried over
(``interop.pupil_from_numpy``, ``interop.mdft_from_numpy``): its
``PrysmLBFGSB`` run iterate for iterate against the JAX package's on the
JAX forward (the mode stack), fused and unfused.  The JAX package's run is
made once, by the module fixture ``jax_retrieval``, for both.  The coating
design path is held in ``test_torch_coatings_design.py``.

``jax_enable_x64``, ``config.precision = 64``, CPU.  Bars: the merit and its
gradient <= 1e-9 relative; optimizer iterates <= 1e-10 relative over the
first 20 iterations.
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
from prysm_tpu.x import optym as jo

from prysm_tpu_torch import interop, steps
from prysm_tpu_torch.conf import config

torch.set_num_threads(2)

ITERATE_BAR = 1e-10


@pytest.fixture(autouse=True)
def _cpu_f64(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _host(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(a, b):
    a, b = np.asarray(_host(a), np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


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


@pytest.fixture(scope='module')
def jax_retrieval():
    """The JAX package's side of both cases, run once: the geometry and plan the port
    carries over, the merit and gradient at 0.9 of the truth, and the 20-iteration run."""
    geom, plan, ref_opt = _jax_retrieval()
    fj, gj = ref_opt.problem.fg(jnp.asarray(steps.COEFS6) * 0.9)
    return geom, plan, fj, gj, jo.run_until(ref_opt, jo.MaxIterations(20))


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'mode-stack'])
def test_phase_retrieval_matches_jax(jax_retrieval, fused):
    geom, plan, fj, gj, ref = jax_retrieval
    pr = _port_retrieval(geom, plan, fused)
    f, g = pr.fg(pr.truth * 0.9)
    assert float(f) == pytest.approx(float(fj), rel=1e-9)
    assert _rel(g, gj) <= 1e-9
    mine = pr()
    assert mine.nit == ref.nit and mine.message == ref.message
    for a, b in zip(mine.records, ref.records):
        assert _rel(a.x_next, b.x_next) <= ITERATE_BAR
    assert _rel(mine.x, steps.COEFS6) <= 1e-6
    assert mine.x.dtype == torch.float64
