"""Clenshaw summation for three-term-recurrence polynomial families.

Counterpart of ``prysm_tpu/polynomials/_clenshaw.py``.  The per-order
linear factors lin_n(x) = p_n + q_n x and the scalars c_n are host tables;
the downward recurrence runs as a Python loop for the value and all j
derivative tracks together (the JAX package's ``lax.scan``).  Only the two
lowest alpha slots are kept, the ones every caller reads, so memory is
O((j+1) * 2 * x.size) whatever the number of coefficients.
"""
import numpy as np
import torch

from ..conf import to_tensor
from ._recurrence import host_scalars

__all__ = ['clenshaw_alphas_scan', 'clenshaw_sum']


def clenshaw_alphas_scan(coefs, p, q, c, x, j=0):
    """Clenshaw alpha tables for P_n(x) = (p_n + q_n x) P_{n-1} - c_n P_{n-2}.

    coefs is the dense coefficient vector c_0 .. c_M (scalars, or tensors
    that broadcast with x); p, q, c are host scalar tables indexed by
    order, of length >= M+1 (c[n] multiplies P_{n-2}); j is the number of
    derivative tracks.  Returns shape (j+1, 2, *x.shape): [jj, 0] is
    alphas[jj][0] (the jj-th derivative of the sum, since P_0 = 1) and
    [jj, 1] is alphas[jj][1].
    """
    x = to_tensor(x)
    M = len(coefs) - 1
    out_shape = (j + 1, 2) + tuple(x.shape)
    if M < 0:
        return torch.zeros(out_shape, dtype=x.dtype, device=x.device)
    ones = torch.ones_like(x)
    zeros = torch.zeros_like(x)
    if M == 0:
        out = torch.zeros(out_shape, dtype=x.dtype, device=x.device)
        out[0, 0] = coefs[0] * ones
        return out

    p, q, c = host_scalars([np.asarray(t, dtype=np.float64)[:M + 1] for t in (p, q, c)],
                           x.dtype)
    # a harmless 0 slot at index M+1 (referenced, multiplied by 0)
    c_ext = c + [0.0]
    if all(np.isscalar(cc) or np.ndim(cc) == 0 for cc in coefs):
        coef_at = host_scalars([float(cc) for cc in coefs], x.dtype)
    else:
        coef_at = [torch.broadcast_to(torch.as_tensor(cc, dtype=x.dtype, device=x.device),
                                      x.shape) for cc in coefs]

    # a1[jj], a2[jj] = alpha_jj[n+1], alpha_jj[n+2]; n runs M-1 .. 0.  The
    # derivative tracks start at 0 and fill in because alpha_jj[n] = 0 for n > M - jj
    a1 = [coefs[M] * ones if jj == 0 else zeros for jj in range(j + 1)]
    a2 = [zeros] * (j + 1)
    for n in range(M - 1, -1, -1):
        lin = p[n] + q[n] * x
        cnp1 = c_ext[n + 1]
        new = []
        for jj in range(j + 1):
            base = lin * a1[jj] - cnp1 * a2[jj]
            new.append(coef_at[n] + base if jj == 0 else jj * q[n] * a1[jj - 1] + base)
        a1, a2 = new, a1
    return torch.stack([torch.stack([a0, a_1]) for a0, a_1 in zip(a1, a2)])


def clenshaw_sum(coefs, p, q, c, x):
    """Weighted polynomial sum via Clenshaw; returns alphas[0] (P0 = 1)."""
    return clenshaw_alphas_scan(coefs, p, q, c, x, j=0)[0, 0]
