"""Jacobi polynomials via the three-term recurrence.

Counterpart of ``prysm_tpu/polynomials/jacobi.py`` (the main path's
part).  The recurrence runs as a Python loop over orders, carrying
(P_{n-1}, P_{n-2}); the (A, B, C) scalars are host-side float64.
"""
from functools import lru_cache

import torch

__all__ = ['recurrence_abc', 'jacobi', 'jacobi_seq']


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


def _jacobi_all(nmax, alpha, beta, x):
    """[P_0, ..., P_nmax] at x."""
    Ps = [torch.ones_like(x)]
    if nmax >= 1:
        Ps.append(_p1(alpha, beta, x) * Ps[0])
    for k in range(1, nmax):
        A, B, C = recurrence_abc(k, alpha, beta)
        Ps.append((A * x + B) * Ps[-1] - C * Ps[-2])
    return Ps


def jacobi(n, alpha, beta, x):
    """Jacobi polynomial of order n with weight parameters alpha, beta."""
    return _jacobi_all(n, alpha, beta, x)[-1]


def jacobi_seq(ns, alpha, beta, x):
    """Jacobi polynomials of orders ns; shape (len(ns), *x.shape)."""
    ns = list(ns)
    Ps = _jacobi_all(max(ns), alpha, beta, x)
    return torch.stack([Ps[n] for n in ns])
