"""Image-chain degradations: smear and jitter transfer functions.

Counterpart of ``prysm_tpu/degradations.py``.  ``torch.sinc`` is the
normalized sinc, as ``jnp.sinc`` is.
"""
import math

import torch

from .conf import to_tensor

__all__ = ['jitter_ft', 'smear_ft']


def smear_ft(fx, fy, width, height):
    """Analytic Fourier transform of smear: separable sinc."""
    if width == 0 and height == 0:
        raise ValueError('one of width or height must be nonzero')
    out1 = torch.sinc(to_tensor(fx) * width) if width != 0 else 1
    out2 = torch.sinc(to_tensor(fy) * height) if height != 0 else 1
    return out1 * out2


def jitter_ft(fr, scale):
    """Analytic Fourier transform of Gaussian jitter."""
    core = math.pi * scale * to_tensor(fr)
    return torch.exp(-2 * core * core)
