"""Jacobi polynomials via the three-term recurrence.

Counterpart of ``prysm_tpu/polynomials/jacobi.py``.  The recurrence runs
as a Python loop over orders, carrying (P_{n-1}, P_{n-2}) and, when asked,
the derivative track; the (A, B, C) scalars are host-side float64 rounded
to the dtype of x.  Every entry point takes tensors of any shape or
Python numbers, and is differentiable by autograd.
"""
from functools import lru_cache

import torch

from ..conf import to_tensor
from ._recurrence import coef_vector, host_scalars

__all__ = ['weight', 'recurrence_abc', 'jacobi', 'jacobi_seq', 'jacobi_with_der',
           'jacobi_seq_with_der', 'jacobi_der', 'jacobi_der_seq', 'jacobi_sum_clenshaw',
           'jacobi_sum_clenshaw_der', 'jacobi_radial_sum', 'jacobi_radial_sum_der_xy']


def weight(alpha, beta, x):
    """Weight function of the Jacobi polynomials for a given alpha, beta."""
    return (1 - x) ** alpha * (1 + x) ** beta


@lru_cache(512)
def recurrence_abc(n, alpha, beta):
    """(A, B, C) for P_n = (A x + B) P_{n-1} - C P_{n-2}; host-side scalars.

    See DLMF 18.9, including the degenerate alpha+beta in {0, -1}, n=0 case.
    """
    aplusb = alpha + beta
    if n == 0 and (aplusb == 0 or aplusb == -1):
        A = 0.5 * (alpha + beta) + 1
        B = 0.5 * (alpha - beta)
        C = 1.0
    else:
        Anum = (2 * n + aplusb + 1) * (2 * n + aplusb + 2)
        Aden = 2 * (n + 1) * (n + aplusb + 1)
        A = Anum / Aden
        Bnum = (alpha ** 2 - beta ** 2) * (2 * n + aplusb + 1)
        Bden = 2 * (n + 1) * (n + aplusb + 1) * (2 * n + aplusb)
        B = Bnum / Bden
        Cnum = (n + alpha) * (n + beta) * (2 * n + aplusb + 2)
        Cden = (n + 1) * (n + aplusb + 1) * (2 * n + aplusb)
        C = Cnum / Cden
    return float(A), float(B), float(C)


def _p1(alpha, beta, x):
    """P_1^{(alpha, beta)}(x)."""
    return alpha + 1 + (alpha + beta + 2) * ((x - 1) / 2)


def _jacobi_lists(nmax, alpha, beta, x, with_der=False):
    """([P_0..P_nmax], [P'_0..P'_nmax] or None) at x."""
    ones = torch.ones_like(x)
    P = [ones, _p1(alpha, beta, x) * ones]
    D = [torch.zeros_like(x), ones * (0.5 * (alpha + beta + 2))] if with_der else None
    rows = [recurrence_abc(k, alpha, beta) for k in range(1, nmax)]
    for A, B, C in (host_scalars(rows, x.dtype) if rows else []):
        lin = A * x + B
        P.append(lin * P[-1] - C * P[-2])
        if with_der:
            D.append(A * P[-2] + lin * D[-1] - C * D[-2])
    if with_der:
        return P[:nmax + 1], D[:nmax + 1]
    return P[:nmax + 1], None


def jacobi(n, alpha, beta, x):
    """Jacobi polynomial of order n with weight parameters alpha, beta."""
    return _jacobi_lists(n, alpha, beta, to_tensor(x))[0][-1]


def jacobi_seq(ns, alpha, beta, x):
    """Jacobi polynomials of orders ns; shape (len(ns), *x.shape)."""
    ns = list(ns)
    P, _ = _jacobi_lists(max(ns), alpha, beta, to_tensor(x))
    return torch.stack([P[n] for n in ns])


def jacobi_with_der(n, alpha, beta, x):
    """(P_n, dP_n/dx) via the differentiated three-term recurrence."""
    P, D = _jacobi_lists(n, alpha, beta, to_tensor(x), with_der=True)
    return P[-1], D[-1]


def jacobi_seq_with_der(ns, alpha, beta, x):
    """(P_n, dP_n/dx) stacked for orders ns."""
    ns = list(ns)
    P, D = _jacobi_lists(max(ns), alpha, beta, to_tensor(x), with_der=True)
    return torch.stack([P[n] for n in ns]), torch.stack([D[n] for n in ns])


def jacobi_der(n, alpha, beta, x):
    """First derivative of P_n w.r.t. x: 0.5 (n+a+b+1) P_{n-1}^{(a+1, b+1)}."""
    x = to_tensor(x)
    if n == 0:
        return torch.zeros_like(x)
    if n == 1:
        return torch.ones_like(x) * (0.5 * (n + alpha + beta + 1))
    return (0.5 * (n + alpha + beta + 1)) * jacobi(n - 1, alpha + 1, beta + 1, x)


def jacobi_der_seq(ns, alpha, beta, x):
    """First derivatives of P_n for orders ns; shape (len(ns), *x.shape)."""
    ns = list(ns)
    x = to_tensor(x)
    nonzero = [n for n in ns if n > 0]
    if nonzero:
        Pns = iter(jacobi_seq([n - 1 for n in nonzero], alpha + 1, beta + 1, x))
    return torch.stack([torch.zeros_like(x) if n == 0
                        else next(Pns) * (0.5 * (n + alpha + beta + 1)) for n in ns])


def jacobi_sum_clenshaw(s, alpha, beta, x):
    """Weighted sum  sum_n s[n] P_n(x)  by Clenshaw's downward recurrence.

    One loop from high order to low; never materializes the mode stack.
    """
    s = list(s)
    x = to_tensor(x)
    N = len(s) - 1
    if N < 0:
        return torch.zeros_like(x)
    if N == 0:
        return s[0] * torch.ones_like(x)
    # tables for orders 0..N (b_n uses abc(n); the step touches abc(n+1))
    abc = host_scalars([recurrence_abc(k, alpha, beta) for k in range(0, N + 1)], x.dtype)
    svec = host_scalars([float(v) for v in s], x.dtype)
    b1, b2 = svec[N] * torch.ones_like(x), torch.zeros_like(x)
    for n in range(N - 1, 0, -1):
        A, B, _ = abc[n]
        b1, b2 = svec[n] + (A * x + B) * b1 - abc[n + 1][2] * b2, b1
    # the last step with P0 = 1, P1 = (A0 x + B0) P0 (degenerate-aware abc(0))
    A0, B0, _ = recurrence_abc(0, alpha, beta)
    C1 = recurrence_abc(1, alpha, beta)[2]
    return svec[0] + (A0 * x + B0) * b1 - C1 * b2


def jacobi_radial_sum(coefs, ns, alpha, beta, x, y, normalization_radius):
    """Weighted radial Jacobi sum on (x, y) points."""
    ns = tuple(ns)
    x, y = to_tensor(x), to_tensor(y)
    if not ns:
        return torch.zeros_like(x)
    R = float(normalization_radius)
    u = 2.0 * (x * x + y * y) / (R * R) - 1.0
    P = jacobi_seq(ns, alpha, beta, u)
    return torch.tensordot(coef_vector(coefs, P), P, dims=([0], [0]))


def jacobi_radial_sum_der_xy(coefs, ns, alpha, beta, x, y, normalization_radius):
    """Radial Jacobi sum and its Cartesian derivatives."""
    ns = tuple(ns)
    x, y = to_tensor(x), to_tensor(y)
    if not ns:
        z = torch.zeros_like(x)
        return z, z, torch.zeros_like(y)
    R = float(normalization_radius)
    inv_Rsq = 1.0 / (R * R)
    u = 2.0 * (x * x + y * y) * inv_Rsq - 1.0
    P = jacobi_seq(ns, alpha, beta, u)
    Pp = jacobi_der_seq(ns, alpha, beta, u)
    c = coef_vector(coefs, P)
    z = torch.tensordot(c, P, dims=([0], [0]))
    dzdu = torch.tensordot(c, Pp, dims=([0], [0]))
    return z, dzdu * (4.0 * x * inv_Rsq), dzdu * (4.0 * y * inv_Rsq)


def jacobi_sum_clenshaw_der(s, alpha, beta, x, j=1):
    """jth partial derivative w.r.t. x of the weighted Jacobi sum.

    As in the JAX package, this returns the j-th derivative itself (not
    the reference's Clenshaw alpha table), by j nested forward-mode
    passes (``torch.func.jvp``) through ``jacobi_sum_clenshaw``.
    """
    def f(xv):
        return jacobi_sum_clenshaw(s, alpha, beta, xv)

    for _ in range(int(j)):
        f = (lambda g: lambda xv: torch.func.jvp(g, (xv,), (torch.ones_like(xv),))[1])(f)
    return f(to_tensor(x))
