"""Generalized Laguerre polynomials (counterpart of ``prysm_tpu/polynomials/laguerre.py``).

Recurrence: L_k = ((2k - 1 + alpha - x) L_{k-1} - (k - 1 + alpha) L_{k-2}) / k.
Derivative identity: d/dx L_n^alpha = -L_{n-1}^{alpha+1}.
"""
import torch

from ..conf import to_tensor
from ._recurrence import recurrence_all, seq_by_recurrence

__all__ = ['laguerre', 'laguerre_seq', 'laguerre_der', 'laguerre_der_seq']


def _abc(alpha):
    def fn(k):
        return ((2 * k - 1 + alpha) / k, -1.0 / k, (k - 1 + alpha) / k)
    return fn


def _seed1(alpha, x):
    return alpha + 1 - x


def laguerre(n, alpha, x):
    """Generalized Laguerre polynomial of order n, parameter alpha."""
    x = to_tensor(x)
    if n == 0:
        return torch.ones_like(x)
    return recurrence_all(n, x, _seed1(alpha, x), _abc(alpha))[-1]


def laguerre_seq(ns, alpha, x):
    """Laguerre polynomials at orders ns; shape (len(ns), *x.shape)."""
    x = to_tensor(x)
    return seq_by_recurrence(ns, x, _seed1(alpha, x), _abc(alpha))


def laguerre_der(n, alpha, x):
    """d/dx L_n^alpha = -L_{n-1}^{alpha+1}."""
    if n < 1:
        return torch.zeros_like(to_tensor(x))
    return -laguerre(n - 1, alpha + 1, x)


def laguerre_der_seq(ns, alpha, x):
    """d/dx of Laguerre polynomials at orders ns."""
    ns = list(ns)
    x = to_tensor(x)
    nonzero = [n for n in ns if n >= 1]
    if nonzero:
        Pns = iter(laguerre_seq([n - 1 for n in nonzero], alpha + 1, x))
    return torch.stack([torch.zeros_like(x) if n < 1 else -next(Pns) for n in ns])
