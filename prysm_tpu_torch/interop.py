"""Carry state from the JAX package into the port.

The functions here take the JAX package's state as numpy arrays (what
``numpy.asarray`` gives for a JAX array) and return the port's objects,
so both packages can compute on the same plan and inputs.  Nothing here
imports JAX.
"""
import numpy as np
import torch

from .conf import resolve_device
from .fttools import MDFT
from .steps import Pupil

__all__ = ['mdft_from_numpy', 'pupil_from_numpy']


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
