"""Angular-spectrum (plane-to-plane) free space propagation.

Counterpart of ``prysm_tpu/propagation/angular_spectrum.py``: the transfer
function is the outer product of two 1D quadratic phasors, and the
propagation is pad -> fft2 -> multiply -> ifft2 on the trailing two axes.
"""
import math

import torch

from ..conf import config, resolve_device
from ..fttools import pad2d, crop_center, fftfreq
from ..mathops import cis

__all__ = ['angular_spectrum_transfer_function', 'angular_spectrum',
           'angular_spectrum_adjoint', 'fresnel_number', 'talbot_distance']

_AX = (-2, -1)


def angular_spectrum_transfer_function(samples, wvl, dx, z, dtype=None, device=None):
    """Free-space transfer function on an FFT-ordered frequency grid.

    samples (y, x); wvl um; dx mm; z mm.  exp(-i pi wvl z (kx^2 + ky^2)),
    evaluated in ``dtype`` (default ``config.precision``) on ``device``.
    """
    if isinstance(samples, int):
        samples = (samples, samples)
    if dtype is None:
        dtype = config.precision
    dev = resolve_device(device)
    wvl = wvl / 1e3
    ky = fftfreq(samples[0], dx, dtype=dtype, device=dev)
    kx = fftfreq(samples[1], dx, dtype=dtype, device=dev)
    prefix = -math.pi * wvl * z
    return torch.outer(cis(prefix * (ky * ky)), cis(prefix * (kx * kx)))


def _transfer_function_for(field, wvl, dx, z):
    return angular_spectrum_transfer_function(tuple(field.shape[-2:]), wvl, dx, z,
                                              dtype=field.real.dtype, device=field.device)


def angular_spectrum(field, wvl, dx, z, Q=2, tf=None):
    """Propagate a field via the angular spectrum method.

    field (..., N, M); wvl um; dx mm; z mm; Q pads the array before the
    transform.  If tf is given it clobbers all other parameters.
    """
    if tf is not None:
        return torch.fft.ifft2(torch.fft.fft2(field, dim=_AX) * tf, dim=_AX)
    if Q != 1:
        field = pad2d(field, Q=Q)
    tf = _transfer_function_for(field, wvl, dx, z)
    return torch.fft.ifft2(torch.fft.fft2(field, dim=_AX) * tf, dim=_AX)


def angular_spectrum_adjoint(field, wvl, dx, z, Q=2, tf=None):
    """Adjoint of angular_spectrum: conjugate transfer function + crop."""
    out_shape = tuple(field.shape[-2:])
    if tf is None:
        tf = _transfer_function_for(field, wvl, dx, z)
        if Q != 1:
            out_shape = tuple(int(s // Q) for s in out_shape)
    out = torch.fft.ifft2(torch.fft.fft2(field, dim=_AX) * torch.conj(tf), dim=_AX)
    if out_shape == tuple(field.shape[-2:]):
        return out
    return crop_center(out, out_shape)


def fresnel_number(a, L, lambda_):
    """Fresnel number a^2 / (L lambda); << 1 means paraxial assumptions hold."""
    return a ** 2 / (L * lambda_)


def talbot_distance(a, lambda_):
    """Talbot distance for grating period a and wavelength lambda (um)."""
    sqrt = torch.sqrt if torch.is_tensor(lambda_) or torch.is_tensor(a) else math.sqrt
    return lambda_ / (1 - sqrt(1 - lambda_ ** 2 / a ** 2))
