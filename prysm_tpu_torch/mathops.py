"""Math helpers (counterpart of ``prysm_tpu/mathops.py``, the main path's part)."""
import torch

__all__ = ['cis', 'is_odd', 'sign', 'kronecker']


def cis(theta):
    """exp(i theta) for real theta, as a native complex tensor."""
    return torch.polar(torch.ones_like(theta), theta)


def is_odd(int_to_check):
    """Whether an integer is odd (host-side)."""
    return int_to_check & 0x1


def sign(x):
    """Sign of a scalar with sign(0) = 1 (host-side, Zernike index math)."""
    return -1 if x < 0 else 1


def kronecker(i, j):
    """Kronecker delta (host-side)."""
    return 1 if i == j else 0
