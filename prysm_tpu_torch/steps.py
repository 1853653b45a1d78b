"""The main path: the flagship forward and the two gradient steps.

Counterparts, without any timing harness, of

* ``__graft_entry__.entry()``: Zernike modes -> anti-aliased circular
  pupil -> FFT focus (Q=2) -> PSF -> MTF at a 1024^2 pupil;
* ``bench.py`` cfg1: the same chain as an L2 PSF loss whose coefficient
  gradient comes from autograd, with the MTF as a deliverable beside the
  loss (not part of it);
* ``bench.py`` cfg2: 1024^2 pupil -> 256^2 focal grid by matrix DFT, the
  phase-retrieval gradient step.  With ``fused=True`` (the default) the
  OPD comes from ``zernike_sum_pallas``, which runs the CUDA kernels on
  the card; ``fused=False`` builds the mode stack instead, as the JAX
  step does when its Pallas kernels are off.

Each builder returns a callable that takes the coefficients and returns
the loss and its coefficient gradient (and, for cfg1, the MTF).
"""
from dataclasses import dataclass

import torch

from .conf import complex_for
from .coordinates import make_xy_grid, cart_to_polar
from .geometry import circle_sdf, antialias
from .ops.zernike import zernike_sum_pallas
from .otf import mtf_from_psf
from .polynomials import zernike_nm_seq, sum_of_2d_modes
from .propagation import Wavefront, prepare_executor

__all__ = ['NMS6', 'COEFS6', 'WVL', 'EFL', 'Pupil', 'make_pupil', 'entry',
           'build_cfg1_step', 'make_cfg2_plan', 'build_cfg2_step']

NMS6 = ((2, 0), (2, 2), (2, -2), (3, 1), (3, -1), (4, 0))
COEFS6 = (20.0, -10.0, 8.0, 5.0, -4.0, 3.0)
WVL, EFL = 0.55, 10.0
DIAMETER = 2.2


@dataclass(frozen=True)
class Pupil:
    """The fixed geometry and starting point of a step."""
    r: torch.Tensor
    t: torch.Tensor
    amp: torch.Tensor
    dx: float
    coefs: torch.Tensor
    nms: tuple


def make_pupil(N=1024, nms=NMS6, coefs=COEFS6, dtype=None, device=None):
    """The flagship pupil: an N^2 grid 2.2 across, a unit anti-aliased circle."""
    x, y = make_xy_grid(N, diameter=DIAMETER, dtype=dtype, device=device)
    dx = DIAMETER / N
    r, t = cart_to_polar(x, y)
    amp = antialias(circle_sdf(1.0, r), dx)
    return Pupil(r=r, t=t, amp=amp, dx=dx,
                 coefs=torch.tensor(coefs, dtype=r.dtype, device=r.device),
                 nms=tuple(nms))


def entry(N=1024, dtype=None, device=None):
    """(forward, example_args): the flagship PSF -> MTF forward, as ``entry()``."""
    x, y = make_xy_grid(N, diameter=DIAMETER, dtype=dtype, device=device)
    dx = float(x[0, 1] - x[0, 0])
    r, t = cart_to_polar(x, y)
    amp = antialias(circle_sdf(1.0, r), dx)
    coefs = torch.tensor(COEFS6, dtype=amp.dtype, device=amp.device)

    def forward(coefs, amp, r, t):
        opd = sum_of_2d_modes(zernike_nm_seq(NMS6, r, t), coefs)
        psf = Wavefront.from_amp_and_phase(amp, opd, WVL, dx).focus(EFL, Q=2).intensity
        return psf.data, mtf_from_psf(psf.data, psf.dx).data

    return forward, (coefs, amp, r, t)


def _value_and_grad(loss_fn, coefs):
    c = coefs.detach().requires_grad_(True)
    loss, *rest = loss_fn(c)
    grad, = torch.autograd.grad(loss, c)
    return (loss.detach(), grad, *rest)


def build_cfg1_step(pupil=None, *, N=1024, dtype=None, device=None):
    """cfg1: FFT focus at Q=2, L2 PSF loss at 0.9 x coefs, coefficient gradient, MTF.

    ``pupil`` defaults to ``make_pupil(N, dtype=dtype, device=device)``.
    """
    if pupil is None:
        pupil = make_pupil(N, dtype=dtype, device=device)
    modes = zernike_nm_seq(pupil.nms, pupil.r, pupil.t)

    def psf(c):
        opd = sum_of_2d_modes(modes, c)
        return Wavefront.from_amp_and_phase(pupil.amp, opd, WVL, pupil.dx) \
            .focus(EFL, Q=2).intensity

    with torch.no_grad():
        I_meas = psf(pupil.coefs).data

    def loss(c):
        I = psf(c * 0.9)
        with torch.no_grad():
            mtf = mtf_from_psf(I.data, I.dx).data
        return torch.sum((I.data - I_meas) ** 2), mtf

    def step(coefs):
        """(loss, coefficient gradient, MTF) at coefs."""
        return _value_and_grad(loss, coefs)

    return step


def make_cfg2_plan(pupil, fN=256, matmul_precision='high'):
    """cfg2's MDFT plan: the pupil's grid -> fN^2 samples 0.25 um apart."""
    N = pupil.r.shape[-1]
    return prepare_executor(pupil.dx, (N, N), 0.25, fN, WVL, EFL,
                            dtype=complex_for(pupil.r.dtype),
                            matmul_precision=matmul_precision,
                            device=pupil.r.device)


def build_cfg2_step(pupil=None, plan=None, fused=True, *, N=1024,
                    fN=256, matmul_precision='high', dtype=None, device=None):
    """cfg2: MDFT focus, L2 intensity loss against 0.5 x coefs, coefficient gradient.

    The fused OPD runs ``zernike_sum_pallas(..., grads='coefs')``: the loss
    does not depend on the grids, so the backward is the coefficient
    cotangent alone.

    ``pupil`` defaults to ``make_pupil(N, dtype=dtype, device=device)`` and
    ``plan`` to ``make_cfg2_plan(pupil, fN, matmul_precision=...)``.
    """
    if pupil is None:
        pupil = make_pupil(N, dtype=dtype, device=device)
    if plan is None:
        plan = make_cfg2_plan(pupil, fN, matmul_precision=matmul_precision)

    def intensity(c):
        if fused:
            opd = zernike_sum_pallas(c, pupil.nms, pupil.r, pupil.t, grads='coefs')
        else:
            opd = sum_of_2d_modes(zernike_nm_seq(pupil.nms, pupil.r, pupil.t), c)
        E = Wavefront.from_amp_and_phase(pupil.amp, opd, WVL, pupil.dx).focus_dft(plan)
        return E.intensity.data

    with torch.no_grad():
        I_meas = intensity(pupil.coefs * 0.5)

    def loss(c):
        return (torch.sum((intensity(c) - I_meas) ** 2),)

    def step(coefs):
        """(loss, coefficient gradient) at coefs."""
        return _value_and_grad(loss, coefs)

    return step
