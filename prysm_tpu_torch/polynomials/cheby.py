"""Chebyshev polynomials of the first through fourth kinds.

Counterpart of ``prysm_tpu/polynomials/cheby.py``.  All four kinds share
the recurrence P_{k+1} = 2x P_k - P_{k-1} and differ only in P_1; they run
through ``_recurrence``.
"""
import torch

from ..conf import to_tensor
from ._recurrence import (grid_zeros, recurrence_all, seq_by_recurrence,
                          seq_by_recurrence_with_der)

__all__ = ['cheby1', 'cheby1_seq', 'cheby1_der', 'cheby1_der_seq',
           'cheby2', 'cheby2_seq', 'cheby2_der', 'cheby2_der_seq',
           'cheby3', 'cheby3_seq', 'cheby3_der', 'cheby3_der_seq',
           'cheby4', 'cheby4_seq', 'cheby4_der', 'cheby4_der_seq',
           'cheby1_2d_sum', 'cheby1_2d_sum_der_xy']


def _abc(k):
    return (0.0, 2.0, 1.0)


# P_1 and dP_1/dx of each kind
_SEEDS = {1: (lambda x: x, 1), 2: (lambda x: 2 * x, 2),
          3: (lambda x: 2 * x - 1, 2), 4: (lambda x: 2 * x + 1, 2)}


def _value(kind, n, x):
    x = to_tensor(x)
    if n == 0:
        return torch.ones_like(x)
    return recurrence_all(n, x, _SEEDS[kind][0](x), _abc)[-1]


def _seq(kind, ns, x):
    x = to_tensor(x)
    return seq_by_recurrence(ns, x, _SEEDS[kind][0](x), _abc)


def _der(kind, n, x):
    x = to_tensor(x)
    if n == 0:
        return torch.zeros_like(x)
    seed, dseed = _SEEDS[kind]
    return recurrence_all(n, x, seed(x), _abc, dseed1=dseed)[1][-1]


def _der_seq(kind, ns, x):
    x = to_tensor(x)
    seed, dseed = _SEEDS[kind]
    return seq_by_recurrence_with_der(ns, x, seed(x), dseed, _abc)[1]


def cheby1(n, x):
    """Chebyshev polynomial of the first kind, order n."""
    return _value(1, n, x)


def cheby1_seq(ns, x):
    """Chebyshev-T at orders ns; shape (len(ns), *x.shape)."""
    return _seq(1, ns, x)


def cheby1_der(n, x):
    """d/dx of Chebyshev-T order n."""
    return _der(1, n, x)


def cheby1_der_seq(ns, x):
    """d/dx of Chebyshev-T at orders ns."""
    return _der_seq(1, ns, x)


def cheby2(n, x):
    """Chebyshev polynomial of the second kind, order n."""
    return _value(2, n, x)


def cheby2_seq(ns, x):
    """Chebyshev-U at orders ns."""
    return _seq(2, ns, x)


def cheby2_der(n, x):
    """d/dx of Chebyshev-U order n."""
    return _der(2, n, x)


def cheby2_der_seq(ns, x):
    """d/dx of Chebyshev-U at orders ns."""
    return _der_seq(2, ns, x)


def cheby3(n, x):
    """Chebyshev polynomial of the third kind, order n."""
    return _value(3, n, x)


def cheby3_seq(ns, x):
    """Chebyshev-V at orders ns."""
    return _seq(3, ns, x)


def cheby3_der(n, x):
    """d/dx of Chebyshev-V order n."""
    return _der(3, n, x)


def cheby3_der_seq(ns, x):
    """d/dx of Chebyshev-V at orders ns."""
    return _der_seq(3, ns, x)


def cheby4(n, x):
    """Chebyshev polynomial of the fourth kind, order n."""
    return _value(4, n, x)


def cheby4_seq(ns, x):
    """Chebyshev-W at orders ns."""
    return _seq(4, ns, x)


def cheby4_der(n, x):
    """d/dx of Chebyshev-W order n."""
    return _der(4, n, x)


def cheby4_der_seq(ns, x):
    """d/dx of Chebyshev-W at orders ns."""
    return _der_seq(4, ns, x)


def cheby1_2d_sum(coefs, mns, x, y):
    """Weighted tensor-product Chebyshev-T sum on separable (x, y)."""
    mns = tuple(mns)
    x, y = to_tensor(x), to_tensor(y)
    if not mns:
        return torch.zeros_like(x)
    Tx = cheby1_seq(range(max(m for m, _ in mns) + 1), x)
    Ty = cheby1_seq(range(max(n for _, n in mns) + 1), y)
    z = grid_zeros(x, y)
    for c, (m, n) in zip(coefs, mns):
        z = z + c * Tx[m] * Ty[n]
    return z


def cheby1_2d_sum_der_xy(coefs, mns, x, y, x_norm=1.0, y_norm=1.0):
    """Weighted Chebyshev-T sum plus Cartesian first derivatives."""
    mns = tuple(mns)
    x, y = to_tensor(x), to_tensor(y)
    if not mns:
        z = torch.zeros_like(x)
        return z, z, torch.zeros_like(y)
    Tx, Tx_d = seq_by_recurrence_with_der(range(max(m for m, _ in mns) + 1), x, x, 1, _abc)
    Ty, Ty_d = seq_by_recurrence_with_der(range(max(n for _, n in mns) + 1), y, y, 1, _abc)
    z, dzdx, dzdy = grid_zeros(x, y), grid_zeros(x, y), grid_zeros(x, y)
    for c, (m, n) in zip(coefs, mns):
        z = z + c * Tx[m] * Ty[n]
        dzdx = dzdx + c * Tx_d[m] * Ty[n]
        dzdy = dzdy + c * Tx[m] * Ty_d[n]
    return z, dzdx / x_norm, dzdy / y_norm
