"""The port's main path (``prysm_tpu_torch.steps``) against the JAX package's.

The cfg1 step (FFT focus, Q=2, L2 PSF loss, MTF), the cfg2 step (MDFT to a
focal grid, phase-retrieval loss) and the ``entry()`` forward run in both
packages on the same numpy inputs, at N=64/128 in float64 on the CPU; the
JAX side is the body of ``bench.py`` cfg1/cfg2 and of
``__graft_entry__.entry()`` at that size.  Inputs and the MDFT plan go to
the port through ``prysm_tpu_torch.interop``.  Bar: 1e-9 relative for
losses, gradients, PSF and MTF: float64 throughout, with FFT and matmul
orders the only difference.  The port's explicit ``*_adjoint`` chains are
held against its autograd gradients at 1e-10.  The JAX package's cfg1 and cfg2
runs are read from their records (``_jax_refs``) where they are current.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _jax_refs import jax_ref
from prysm_tpu.coordinates import make_xy_grid, cart_to_polar
from prysm_tpu.geometry import circle_sdf, antialias
from prysm_tpu.otf import mtf_from_psf as jax_mtf_from_psf
from prysm_tpu.polynomials import zernike_nm_seq as jax_zernike_nm_seq
from prysm_tpu.polynomials import sum_of_2d_modes as jax_sum_of_2d_modes
from prysm_tpu.propagation import Wavefront as JaxWavefront
from prysm_tpu.propagation import prepare_executor as jax_prepare_executor

from prysm_tpu_torch import interop, steps
from prysm_tpu_torch.polynomials import zernike_nm_seq, sum_of_2d_modes_adjoint
from prysm_tpu_torch.propagation import Wavefront

torch.set_num_threads(2)

NMS6 = list(steps.NMS6)
COEFS = np.asarray(steps.COEFS6)
WVL, EFL = steps.WVL, steps.EFL


def _jax_pupil(N):
    x, y = make_xy_grid(N, diameter=2.2)
    r, t = cart_to_polar(x, y)
    dx = 2.2 / N
    return r, t, antialias(circle_sdf(1.0, r), dx), dx


def _port_pupil(r, t, amp, dx):
    return interop.pupil_from_numpy(np.asarray(r), np.asarray(t), np.asarray(amp), dx,
                                    COEFS, NMS6, device='cpu')


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _jax_cfg1(N):
    """bench.py cfg1's loss and gradient at size N."""
    r, t, amp, dx = _jax_pupil(N)
    modes = jax_zernike_nm_seq(NMS6, r, t)

    def psf(c):
        opd = jax_sum_of_2d_modes(modes, c)
        return JaxWavefront.from_amp_and_phase(amp, opd, WVL, dx).focus(EFL, Q=2).intensity

    I_meas = psf(jnp.asarray(COEFS)).data

    def loss(c):
        I = psf(c * 0.9)
        return jnp.sum((I.data - I_meas) ** 2), jax_mtf_from_psf(I.data, I.dx).data

    (value, mtf), grad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(COEFS))
    return (r, t, amp, dx), value, grad, mtf


def _jax_cfg2(N, fN, prec):
    """bench.py cfg2's loss and gradient at size N (its mode-stack path), and its plan's
    fields (``PLAN``)."""
    r, t, amp, dx = _jax_pupil(N)
    plan = jax_prepare_executor(dx, (N, N), 0.25 * 256 / fN, fN, WVL, EFL,
                                matmul_precision=prec)

    def intensity(c):
        opd = jax_sum_of_2d_modes(jax_zernike_nm_seq(NMS6, r, t), c)
        return JaxWavefront.from_amp_and_phase(amp, opd, WVL, dx).focus_dft(plan) \
            .intensity.data

    I_meas = intensity(jnp.asarray(COEFS) * 0.5)
    value, grad = jax.value_and_grad(
        lambda c: jnp.sum((intensity(c) - I_meas) ** 2))(jnp.asarray(COEFS))
    return (r, t, amp, dx), {k: getattr(plan, k) for k in PLAN}, value, grad


PLAN = ('Ex_re', 'Ex_im', 'Ey_re', 'Ey_im', 'norm', 'forward_left_first', 'adjoint_left_first',
        'pupil_dx', 'focal_dx')


def _carry_plan(plan, prec):
    return interop.mdft_from_numpy(*(plan[k] for k in PLAN), prec, device='cpu')


def test_cfg1_step_matches_jax():
    geom, value, grad, mtf = jax_ref('cfg1', _jax_cfg1, 64, bar=1e-9)
    loss, g, m = steps.build_cfg1_step(_port_pupil(*geom))(torch.from_numpy(COEFS))
    assert abs(float(loss) - float(value)) / abs(float(value)) < 1e-9
    assert _rel(g.numpy(), grad) < 1e-9
    assert _rel(m.numpy(), mtf) < 1e-9


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'mode-stack'])
@pytest.mark.parametrize('prec', [None, 'high'])
def test_cfg2_step_matches_jax(fused, prec):
    geom, plan, value, grad = jax_ref('cfg2', _jax_cfg2, 128, 32, prec, bar=1e-9)
    step = steps.build_cfg2_step(_port_pupil(*geom), _carry_plan(plan, prec), fused=fused)
    loss, g = step(torch.from_numpy(COEFS))
    assert abs(float(loss) - float(value)) / abs(float(value)) < 1e-9
    assert _rel(g.numpy(), grad) < 1e-9


def test_entry_matches_jax():
    N = 64
    x, y = make_xy_grid(N, diameter=2.2)
    dx = float(x[0, 1] - x[0, 0])
    r, t = cart_to_polar(x, y)
    amp = antialias(circle_sdf(1.0, r), dx)
    opd = jax_sum_of_2d_modes(jax_zernike_nm_seq(NMS6, r, t), jnp.asarray(COEFS))
    psf = JaxWavefront.from_amp_and_phase(amp, opd, WVL, dx).focus(EFL, Q=2).intensity
    mtf = jax_mtf_from_psf(psf.data, psf.dx).data
    forward, args = steps.entry(N, dtype=torch.float64, device='cpu')
    tpsf, tmtf = forward(*args)
    assert tpsf.shape == (2 * N, 2 * N)
    assert _rel(tpsf.numpy(), psf.data) < 1e-9
    assert _rel(tmtf.numpy(), mtf) < 1e-9
    assert float(tmtf[N, N]) == 1.0


def test_cfg1_adjoint_chain_matches_autograd():
    p = steps.make_pupil(64, dtype=torch.float64, device='cpu')
    loss, grad, _ = steps.build_cfg1_step(p)(p.coefs)
    modes = zernike_nm_seq(p.nms, p.r, p.t)
    opd = lambda c: torch.tensordot(c, modes, dims=([0], [0]))  # noqa: E731
    I_meas = Wavefront.from_amp_and_phase(p.amp, opd(p.coefs), WVL, p.dx).focus(EFL).intensity
    wf = Wavefront.from_amp_and_phase(p.amp, opd(p.coefs * 0.9), WVL, p.dx)
    E = wf.focus(EFL)
    Ibar = 2 * (E.intensity.data - I_meas.data)
    Pbar = E.intensity_adjoint(Ibar).focus_adjoint(EFL)
    phase_bar = wf.from_amp_and_phase_adjoint_phase(Pbar)
    g = 0.9 * sum_of_2d_modes_adjoint(modes, phase_bar).imag
    assert _rel(g.numpy(), grad.numpy()) < 1e-10


def test_cfg2_adjoint_chain_matches_autograd():
    p = steps.make_pupil(64, dtype=torch.float64, device='cpu')
    plan = steps.make_cfg2_plan(p, fN=24, matmul_precision=None)
    loss, grad = steps.build_cfg2_step(p, plan)(p.coefs)
    modes = zernike_nm_seq(p.nms, p.r, p.t)
    opd = lambda c: torch.tensordot(c, modes, dims=([0], [0]))  # noqa: E731
    I_meas = Wavefront.from_amp_and_phase(p.amp, opd(p.coefs * 0.5), WVL, p.dx) \
        .focus_dft(plan).intensity.data
    wf = Wavefront.from_amp_and_phase(p.amp, opd(p.coefs), WVL, p.dx)
    E = wf.focus_dft(plan)
    Ibar = 2 * (E.intensity.data - I_meas)
    Pbar = E.intensity_adjoint(Ibar).focus_dft_adjoint(plan)
    g = sum_of_2d_modes_adjoint(modes, wf.from_amp_and_phase_adjoint_phase(Pbar)).imag
    assert _rel(g.numpy(), grad.numpy()) < 1e-10
    assert float(loss) > 0
