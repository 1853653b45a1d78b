"""Legendre polynomials (counterpart of ``prysm_tpu/polynomials/legendre.py``)."""
import torch

from ..conf import to_tensor
from ._recurrence import recurrence_all, seq_by_recurrence, seq_by_recurrence_with_der

__all__ = ['legendre', 'legendre_seq', 'legendre_der', 'legendre_der_seq']


def _abc(k):
    return (0.0, (2 * k - 1) / k, (k - 1) / k)


def legendre(n, x):
    """Legendre polynomial of order n."""
    x = to_tensor(x)
    if n == 0:
        return torch.ones_like(x)
    return recurrence_all(n, x, x, _abc)[-1]


def legendre_seq(ns, x):
    """Legendre polynomials at orders ns; shape (len(ns), *x.shape)."""
    x = to_tensor(x)
    return seq_by_recurrence(ns, x, x, _abc)


def legendre_der(n, x):
    """d/dx of Legendre polynomial of order n."""
    x = to_tensor(x)
    if n == 0:
        return torch.zeros_like(x)
    return recurrence_all(n, x, x, _abc, dseed1=1)[1][-1]


def legendre_der_seq(ns, x):
    """d/dx of Legendre polynomials at orders ns."""
    x = to_tensor(x)
    return seq_by_recurrence_with_der(ns, x, x, 1, _abc)[1]
