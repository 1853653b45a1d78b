"""Sharded broadband propagation and phase-retrieval steps over a mesh.

Counterpart of ``prysm_tpu/parallel/sharding.py``.  Mesh axes:

* ``wl`` shards the wavelengths: per-wavelength bases and weights split on
  their leading W axis, and the incoherent sum over wavelengths is a
  ``psum``;
* ``ty`` shards the focal-plane rows: each rank holds a horizontal strip of
  every wavelength's Ey basis and of the measured image; the tile ``psum``
  completes the loss.

The step takes the whole logical tensors on every rank and slices its own
shards.  The coefficients enter the rank-local work through ``enter`` over
both axes, so the gradient is each rank's partial cotangent summed over the
mesh: replicated, and equal to the serial gradient.
"""
import math

import torch

from ..mathops import cis
from ._collectives import enter, psum, shard
from .broadband import SpectralMDFT

__all__ = ['broadband_psf', 'shard_broadband_step']


def _abs2(E):
    return E.real * E.real + E.imag * E.imag


def broadband_psf(coefs, amp, modes, wavelengths, weights, plan):
    """Weighted incoherent broadband PSF from shared mode coefficients.

    coefs (K,), amp (Ny, Nx), modes (K, Ny, Nx), wavelengths (W,) um,
    weights (W,), plan SpectralMDFT -> (My, Mx) broadband intensity.
    Works serially or on one rank's shards.
    """
    opd = torch.tensordot(coefs, modes, dims=([0], [0]))        # (Ny, Nx), nm
    scale = 2 * math.pi / (wavelengths * 1e3)                   # (W,) rad/nm
    phase = scale[:, None, None] * opd[None]                    # (W, Ny, Nx)
    fields = amp[None] * cis(phase)
    E = plan(fields)                                            # (W, My, Mx)
    return torch.tensordot(weights, _abs2(E), dims=([0], [0]))  # (My, Mx)


def _local_plan(plan, mesh, wl_axis, tile_axis):
    """This rank's wavelengths of the plan, and its Ey rows."""
    def wl(x):
        return shard(x, mesh, wl_axis, 0, 'wavelength count')

    Ey = shard(wl(plan.Ey), mesh, tile_axis, 1, 'focal row count')
    return SpectralMDFT(Ex=wl(plan.Ex), Ey=Ey, norm=wl(plan.norm),
                        pupil_dx=plan.pupil_dx, focal_dx=plan.focal_dx)


def _shard_broadband_loss(mesh, plan, amp, modes, wavelengths, weights, I_meas,
                          wl_axis='wl', tile_axis='ty'):
    """loss(coefs) of ``shard_broadband_step``: replicated, differentiable by
    autograd and by ``torch.func``."""
    local = _local_plan(plan, mesh, wl_axis, tile_axis)
    wl_local = shard(wavelengths, mesh, wl_axis, 0, 'wavelength count')
    w_local = shard(weights, mesh, wl_axis, 0, 'wavelength count')
    I_rows = shard(I_meas, mesh, tile_axis, 0, 'focal row count')

    def loss(coefs):
        I_partial = broadband_psf(enter(coefs, mesh, (wl_axis, tile_axis)), amp, modes,
                                  wl_local, w_local, local)
        resid = psum(I_partial, mesh, wl_axis) - I_rows
        return psum(torch.sum(resid * resid), mesh, tile_axis)

    return loss


def shard_broadband_step(mesh, plan, amp, modes, wavelengths, weights, I_meas,
                         wl_axis='wl', tile_axis='ty'):
    """Build a mesh-sharded broadband phase-retrieval step.

    Returns step(coefs) -> (loss, grad), both replicated, with
    wavelengths, weights and the plan's W axis sharded over ``wl_axis``,
    the plan's Ey output rows and I_meas rows over ``tile_axis``, and
    coefs, amp and modes replicated.  The wavelength psum comes before
    the data term (the image is nonlinear downstream); the tile psum
    completes the loss.
    """
    loss = _shard_broadband_loss(mesh, plan, amp, modes, wavelengths, weights, I_meas,
                                 wl_axis, tile_axis)

    def step(coefs):
        c = coefs.detach().requires_grad_(True)
        with torch.enable_grad():
            value = loss(c)
            grad, = torch.autograd.grad(value, c)
        return value.detach(), grad

    return step
