"""Hermite polynomials, probabilist's (He) and physicist's (H).

Counterpart of ``prysm_tpu/polynomials/hermite.py``.  Both satisfy
P_k = kind*x P_{k-1} - kind*(k-1) P_{k-2} with kind 1 or 2, and
P'_n = kind * n * P_{n-1}.
"""
import torch

from ..conf import to_tensor
from ._recurrence import recurrence_all, seq_by_recurrence

__all__ = ['hermite_He', 'hermite_He_seq', 'hermite_He_der', 'hermite_He_der_seq',
           'hermite_H', 'hermite_H_seq', 'hermite_H_der', 'hermite_H_der_seq']


def _abc(kind):
    def fn(k):
        return (0.0, float(kind), float(kind * (k - 1)))
    return fn


def _hermite_value(n, x, kind):
    x = to_tensor(x)
    if n == 0:
        return torch.ones_like(x)
    return recurrence_all(n, x, kind * x, _abc(kind))[-1]


def _hermite_value_seq(ns, x, kind):
    x = to_tensor(x)
    return seq_by_recurrence(ns, x, kind * x, _abc(kind))


def _hermite_der_seq(ns, x, kind):
    ns = list(ns)
    x = to_tensor(x)
    nonzero = [n for n in ns if n > 0]
    if nonzero:
        Pns = iter(_hermite_value_seq([n - 1 for n in nonzero], x, kind))
    return torch.stack([torch.zeros_like(x) if n == 0 else kind * n * next(Pns) for n in ns])


def hermite_He(n, x):
    """Probabilist's Hermite polynomial He_n."""
    return _hermite_value(n, x, kind=1)


def hermite_He_seq(ns, x):
    """He_n at sorted orders ns."""
    return _hermite_value_seq(ns, x, kind=1)


def hermite_He_der(n, x):
    """d/dx He_n = n He_{n-1}."""
    if n == 0:
        return torch.zeros_like(to_tensor(x))
    return n * hermite_He(n - 1, x)


def hermite_He_der_seq(ns, x):
    """d/dx He_n at sorted orders ns."""
    return _hermite_der_seq(ns, x, kind=1)


def hermite_H(n, x):
    """Physicist's Hermite polynomial H_n."""
    return _hermite_value(n, x, kind=2)


def hermite_H_seq(ns, x):
    """H_n at sorted orders ns."""
    return _hermite_value_seq(ns, x, kind=2)


def hermite_H_der(n, x):
    """d/dx H_n = 2n H_{n-1}."""
    if n == 0:
        return torch.zeros_like(to_tensor(x))
    return 2 * n * hermite_H(n - 1, x)


def hermite_H_der_seq(ns, x):
    """d/dx H_n at sorted orders ns."""
    return _hermite_der_seq(ns, x, kind=2)
