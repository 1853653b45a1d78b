"""Three-term recurrences for the classical families.

Counterpart of ``prysm_tpu/polynomials/_recurrence.py``.  Every family
here satisfies P_k = (a_k + b_k x) P_{k-1} - c_k P_{k-2} with scalar
per-order coefficients; the derivative track is
D_k = b_k P_{k-1} + (a_k + b_k x) D_{k-1} - c_k D_{k-2}.  The JAX package
runs the chain as one ``lax.scan`` over a host table of (a, b, c); here
it is a Python loop over orders with the same table, built in numpy
float64 and rounded to the dtype of x, in the same association order, so
float64 results agree with the JAX package to the last few ulps.
"""
import numpy as np
import torch

from ..conf import to_tensor

__all__ = ['recurrence_all', 'seq_by_recurrence', 'seq_by_recurrence_with_der',
           'host_scalars', 'coef_vector', 'grid_zeros']


_NUMPY_DTYPE = {torch.float16: np.float16, torch.float32: np.float32}


def host_scalars(rows, dtype):
    """Host float64 rows as nested lists of Python floats rounded to ``dtype``.

    A Python float that a float32 tensor multiplies is rounded to float32
    once more, which leaves it unchanged: the arithmetic is that of the
    JAX package's table cast to x's dtype.
    """
    rounded = np.asarray(rows, dtype=np.float64).astype(_NUMPY_DTYPE.get(dtype, np.float64))
    return rounded.astype(np.float64).tolist()


def coef_vector(coefs, like):
    """The coefficients as a vector in like's dtype, on its device (a tensor keeps its graph)."""
    if torch.is_tensor(coefs):
        return coefs.to(like.dtype)
    return torch.as_tensor(np.asarray(coefs, dtype=np.float64), dtype=like.dtype,
                           device=like.device)


def grid_zeros(x, y):
    """Zeros over the broadcast shape of x and y, in x's dtype and on its device."""
    return torch.zeros(torch.broadcast_shapes(x.shape, y.shape), dtype=x.dtype, device=x.device)


def _abc_rows(nmax, abc_fn, dtype):
    """[(a_k, b_k, c_k) for k = 2..nmax] rounded to dtype."""
    return host_scalars([abc_fn(k) for k in range(2, nmax + 1)], dtype) if nmax >= 2 else []


def _recurrence_lists(nmax, x, seed0, seed1, abc_fn, dseed1=None):
    """([P_0..P_nmax], [D_0..D_nmax] or None) as lists of tensors."""
    ones = torch.ones_like(x)
    zeros = torch.zeros_like(x)
    with_der = dseed1 is not None
    P = [ones if seed0 is None else seed0 * ones, seed1 * ones]
    D = [zeros, dseed1 * ones] if with_der else None
    for a, b, c in _abc_rows(nmax, abc_fn, x.dtype):
        lin = a + b * x
        P.append(lin * P[-1] - c * P[-2])
        if with_der:
            D.append(b * P[-2] + lin * D[-1] - c * D[-2])
    if with_der:
        return P[:nmax + 1], D[:nmax + 1]
    return P[:nmax + 1], None


def recurrence_all(nmax, x, seed1, abc_fn, dseed1=None):
    """All orders 0..nmax of a three-term recurrence, stacked on axis 0.

    seed1 is P_1 (P_0 = 1); abc_fn(k) gives the host scalars (a_k, b_k,
    c_k) for k >= 2.  With dseed1 (dP_1/dx) the derivative track is also
    returned.  Shape (nmax+1, *x.shape).
    """
    x = to_tensor(x)
    P, D = _recurrence_lists(nmax, x, None, seed1, abc_fn, dseed1)
    if D is None:
        return torch.stack(P)
    return torch.stack(P), torch.stack(D)


def seq_by_recurrence(ns, x, seed1, abc_fn, seed0=None):
    """Orders ns of a recurrence; shape (len(ns), *x.shape).

    seed0 overrides P_0 (Dickson's D_0 = 2); the recurrence then uses it.
    """
    ns = list(ns)
    x = to_tensor(x)
    P, _ = _recurrence_lists(max(ns), x, seed0, seed1, abc_fn)
    return torch.stack([P[n] for n in ns])


def seq_by_recurrence_with_der(ns, x, seed1, dseed1, abc_fn):
    """Orders ns of a recurrence and its derivative track."""
    ns = list(ns)
    x = to_tensor(x)
    P, D = _recurrence_lists(max(ns), x, None, seed1, abc_fn, dseed1)
    return torch.stack([P[n] for n in ns]), torch.stack([D[n] for n in ns])
