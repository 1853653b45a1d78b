"""Dickson polynomials of the first and second kind.

Counterpart of ``prysm_tpu/polynomials/dickson.py``.  Both satisfy
P_k = x P_{k-1} - alpha P_{k-2}; the first kind has D_0 = 2, the second
E_0 = 1.
"""
import torch

from ..conf import to_tensor
from ._recurrence import recurrence_all, seq_by_recurrence, seq_by_recurrence_with_der

__all__ = ['dickson1', 'dickson1_seq', 'dickson1_der', 'dickson1_der_seq',
           'dickson2', 'dickson2_seq', 'dickson2_der', 'dickson2_der_seq']


def _abc(alpha):
    def fn(k):
        return (0.0, 1.0, float(alpha))
    return fn


def dickson1(n, alpha, x):
    """Dickson polynomial of the first kind, order n with parameter alpha."""
    x = to_tensor(x)
    if n == 0:
        return torch.full_like(x, 2.0)
    return seq_by_recurrence([n], x, x, _abc(alpha), seed0=2)[0]


def dickson1_seq(ns, alpha, x):
    """Dickson-D at orders ns; shape (len(ns), *x.shape)."""
    x = to_tensor(x)
    return seq_by_recurrence(ns, x, x, _abc(alpha), seed0=2)


def dickson2(n, alpha, x):
    """Dickson polynomial of the second kind, order n with parameter alpha."""
    x = to_tensor(x)
    if n == 0:
        return torch.ones_like(x)
    return recurrence_all(n, x, x, _abc(alpha))[-1]


def dickson2_seq(ns, alpha, x):
    """Dickson-E at orders ns."""
    x = to_tensor(x)
    return seq_by_recurrence(ns, x, x, _abc(alpha))


def _dickson_der(n, alpha, x, seed0):
    x = to_tensor(x)
    if n == 0:
        return torch.zeros_like(x)
    if seed0 == 2:
        # first kind: the value and derivative tracks from D_0 = 2, written
        # out (the generic track assumes P_0 = 1)
        Pnm2, Dnm2 = torch.full_like(x, 2.0), torch.zeros_like(x)
        Pnm1, Dnm1 = x * torch.ones_like(x), torch.ones_like(x)
        for _ in range(2, n + 1):
            Pn = x * Pnm1 - alpha * Pnm2
            Dn = Pnm1 + x * Dnm1 - alpha * Dnm2
            Pnm2, Pnm1 = Pnm1, Pn
            Dnm2, Dnm1 = Dnm1, Dn
        return Dnm1
    return recurrence_all(n, x, x, _abc(alpha), dseed1=1)[1][-1]


def dickson1_der(n, alpha, x):
    """d/dx of Dickson-D order n."""
    return _dickson_der(n, alpha, x, seed0=2)


def dickson1_der_seq(ns, alpha, x):
    """d/dx of Dickson-D at orders ns."""
    return torch.stack([_dickson_der(n, alpha, x, seed0=2) for n in ns])


def dickson2_der(n, alpha, x):
    """d/dx of Dickson-E order n."""
    return _dickson_der(n, alpha, x, seed0=1)


def dickson2_der_seq(ns, alpha, x):
    """d/dx of Dickson-E at orders ns."""
    x = to_tensor(x)
    return seq_by_recurrence_with_der(ns, x, x, 1, _abc(alpha))[1]
