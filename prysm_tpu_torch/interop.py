"""Carry state from the JAX package into the port.

The functions here take the JAX package's state as numpy arrays (what
``numpy.asarray`` gives for a JAX array) and return the port's objects,
so both packages can compute on the same plan and inputs.  Nothing here
imports JAX.
"""
import numpy as np
import torch

from .conf import resolve_device
from .detector import Detector
from .fttools import MDFT
from .parallel import SpectralMDFT
from .steps import Pupil

__all__ = ['mdft_from_numpy', 'pupil_from_numpy', 'spectral_mdft_from_numpy',
           'detector_from_numpy']


def _tensor(a, device, dtype=None):
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def mdft_from_numpy(Ex_re, Ex_im, Ey_re, Ey_im, norm, forward_left_first,
                    adjoint_left_first, pupil_dx=None, focal_dx=None,
                    matmul_precision=None, device=None):
    """An MDFT plan from the JAX plan's leaves (real and imaginary parts of Ex, Ey)."""
    dev = resolve_device(device)
    Ex = torch.complex(_tensor(Ex_re, dev), _tensor(Ex_im, dev))
    Ey = torch.complex(_tensor(Ey_re, dev), _tensor(Ey_im, dev))
    return MDFT(Ex, Ey, norm=norm, forward_left_first=forward_left_first,
                adjoint_left_first=adjoint_left_first, pupil_dx=pupil_dx,
                focal_dx=focal_dx, matmul_precision=matmul_precision)


def pupil_from_numpy(r, t, amp, dx, coefs, nms, device=None):
    """A ``steps.Pupil`` from the grids r, t, amp, the spacing, coefficients and (n, m) list."""
    dev = resolve_device(device)
    return Pupil(r=_tensor(r, dev), t=_tensor(t, dev), amp=_tensor(amp, dev),
                 dx=float(dx), coefs=_tensor(coefs, dev),
                 nms=tuple((int(n), int(m)) for n, m in nms))


def spectral_mdft_from_numpy(Ex_re, Ex_im, Ey_re, Ey_im, norm, pupil_dx, focal_dx,
                             device=None):
    """A ``parallel.SpectralMDFT`` from the JAX plan's leaves ((W, M, N) parts, (W, 1, 1) norm)."""
    dev = resolve_device(device)
    return SpectralMDFT(Ex=torch.complex(_tensor(Ex_re, dev), _tensor(Ex_im, dev)),
                        Ey=torch.complex(_tensor(Ey_re, dev), _tensor(Ey_im, dev)),
                        norm=_tensor(norm, dev), pupil_dx=pupil_dx, focal_dx=focal_dx)


def detector_from_numpy(dark_current, read_noise, bias, fwc, conversion_gain, bits,
                        exposure_time, prnu=None, dcnu=None, lut=None, device=None):
    """A ``detector.Detector`` from the scalar parameters and optional prnu, dcnu, lut arrays."""
    dev = resolve_device(device)
    maps = [None if a is None else _tensor(a, dev) for a in (prnu, dcnu, lut)]
    return Detector(float(dark_current), float(read_noise), float(bias), float(fwc),
                    float(conversion_gain), int(bits), float(exposure_time), *maps)
