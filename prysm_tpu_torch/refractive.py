"""Refractive index models (counterpart of ``prysm_tpu/refractive.py``).

A wavelength given as a Python number or list becomes a tensor of
``config.precision`` on ``config.device`` (``conf.to_tensor``).
"""
import math

import torch

from .conf import to_tensor

__all__ = ['cauchy', 'sellmeier', 'internal_transmission']


def cauchy(wvl, A, *args):
    """Cauchy's equation: n = A + B/wvl^2 + C/wvl^4 + ..."""
    wvl = to_tensor(wvl)
    seed = A
    for idx, arg in enumerate(args):
        power = 2 * idx + 2
        seed = seed + arg / torch.pow(wvl, power)
    return seed


def sellmeier(wvl, A, B):
    """Sellmeier equation: n^2 = 1 + sum a wvl^2 / (wvl^2 - b)."""
    wvlsq = torch.square(to_tensor(wvl))
    seed = wvlsq * 0 + 1.0
    for a, b in zip(A, B):
        seed = seed + (a * wvlsq) / (wvlsq - b)
    return torch.sqrt(seed)


def internal_transmission(t, k, wvl):
    """Internal transmission of a glass slab of thickness t (mm), wvl nm."""
    wvl = to_tensor(wvl) / 1e3
    return torch.exp(-4 * math.pi * k * t / wvl)
