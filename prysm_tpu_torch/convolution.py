"""Fourier-domain convolution and transfer-function chains.

Counterpart of ``prysm_tpu/convolution.py``.  The transfer functions
multiply once in the frequency domain; a callable is asked, through its
signature, which frequency grids (fx, fy, fr, ft) it takes.  Real inputs
give real outputs.
"""
import inspect

import torch

from .coordinates import optimize_xy_separable, cart_to_polar
from .fttools import forward_ft_unit

__all__ = ['conv', 'apply_transfer_functions']

_AX = (-2, -1)


def conv(obj, psf):
    """Convolve an object and a PSF via the FFT (both shape (..., M, N))."""
    O = torch.fft.fft2(torch.fft.ifftshift(obj, dim=_AX), dim=_AX)  # NOQA
    H = torch.fft.fft2(torch.fft.ifftshift(psf, dim=_AX), dim=_AX)
    i = torch.fft.fftshift(torch.fft.ifft2(O * H, dim=_AX), dim=_AX)
    return i if obj.is_complex() else i.real


def _frequency_grids(obj, dx, fx, fy, fr, ft, shift):
    """Fill any missing frequency grids from the sample spacing, in obj's real dtype."""
    real = obj.real.dtype if obj.is_complex() else obj.dtype
    if fx is None:
        fx = forward_ft_unit(dx, obj.shape[-1], shift=shift, dtype=real, device=obj.device)
    if fy is None:
        fy = forward_ft_unit(dx, obj.shape[-2], shift=shift, dtype=real, device=obj.device)
    fx, fy = optimize_xy_separable(fx, fy)
    if fr is None or ft is None:
        pr, pt = cart_to_polar(fx, fy)
        fr = pr if fr is None else fr
        ft = pt if ft is None else ft
    return {'fx': fx, 'fy': fy, 'fr': fr, 'ft': ft}


def _materialize_tf(tf, grids):
    """Call a transfer-function callable with whichever grids it accepts."""
    accepted = inspect.signature(tf).parameters
    kwargs = {k: v for k, v in grids.items() if k in accepted}
    if not kwargs:
        raise ValueError(f'{tf} accepts none of fx, fy, fr, ft; a '
                         'transfer function must accept at least one')
    return tf(**kwargs)


def apply_transfer_functions(obj, dx, tfs, fx=None, fy=None, ft=None, fr=None, shift=False):
    """Blur an object by N transfer functions (arrays or callables)."""
    grids = None
    if any(callable(tf) for tf in tfs):
        grids = _frequency_grids(obj, dx, fx, fy, fr, ft, shift)

    O = torch.fft.fft2(torch.fft.ifftshift(obj, dim=_AX), dim=_AX)  # NOQA
    if shift:
        O = torch.fft.fftshift(O, dim=_AX)  # NOQA
    for tf in tfs:
        if callable(tf):
            tf = _materialize_tf(tf, grids)
        O = O * tf  # NOQA
    if shift:
        O = torch.fft.ifftshift(O, dim=_AX)  # NOQA
    i = torch.fft.fftshift(torch.fft.ifft2(O, dim=_AX), dim=_AX)
    return i if obj.is_complex() else i.real
