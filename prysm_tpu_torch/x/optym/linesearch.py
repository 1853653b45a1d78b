"""Strong-Wolfe line search.

Counterpart of ``prysm_tpu/x/optym/linesearch.py``: bracket + zoom search
from Nocedal & Wright, *Numerical Optimization*, Algorithms 3.5/3.6, for
the host-side optimizer drivers.  All math is numpy float64 — line searches
are inherently sequential and data-dependent, so they stay on the host;
the trial points are formed in x's own kind (a tensor stays on its device)
and each probe reads f and the slope back through ``to_host``.
"""
import numpy as np

import torch

from .problem import as_problem, to_host


def _interp_min(lo, f_lo, g_lo, hi, f_hi, mid=None, f_mid=None):
    """Minimizer of a cubic (if a third point is known) or quadratic model.

    Falls back through quadratic to bisection whenever the higher-order
    model is degenerate or its minimizer leaves the bracket interior.
    """
    span = hi - lo
    if span == 0.0:
        return lo
    # cubic through (lo, f_lo, g_lo), (hi, f_hi), (mid, f_mid)
    if mid is not None and f_mid is not None and mid not in (lo, hi):
        with np.errstate(all='ignore'):
            db = hi - lo
            dc = mid - lo
            denom = (db * dc) ** 2 * (db - dc)
            r1 = f_hi - f_lo - g_lo * db
            r2 = f_mid - f_lo - g_lo * dc
            A = (dc ** 2 * r1 - db ** 2 * r2) / denom
            B = (-dc ** 3 * r1 + db ** 3 * r2) / denom
            disc = B * B - 3.0 * A * g_lo
            if np.isfinite(disc) and disc >= 0 and A != 0:
                cand = lo + (-B + np.sqrt(disc)) / (3.0 * A)
                if _interior(cand, lo, hi):
                    return cand
    # quadratic through (lo, f_lo, g_lo), (hi, f_hi)
    with np.errstate(all='ignore'):
        denom = 2.0 * (f_hi - f_lo - g_lo * span)
        if denom != 0 and np.isfinite(denom):
            cand = lo - g_lo * span * span / denom
            if _interior(cand, lo, hi):
                return cand
    return lo + 0.5 * span


def _interior(cand, lo, hi):
    a, b = (lo, hi) if lo < hi else (hi, lo)
    margin = 0.05 * (b - a)
    return np.isfinite(cand) and a + margin <= cand <= b - margin


def ls_strong_wolfe(problem, xk, pk, fg_at_xk=None, maxalpha=None,
                    c1=1e-4, c2=0.9, maxiter=10):
    """Step length along pk satisfying the strong Wolfe conditions.

    Sufficient decrease  phi(a) <= phi(0) + c1*a*phi'(0)  and curvature
    |phi'(a)| <= c2*|phi'(0)|, where phi(a) = f(xk + a*pk).  When the
    search hits ``maxalpha`` with decrease satisfied and the slope still
    negative, the capped step is accepted (curvature unmet) so bounded
    callers can step onto a box face.

    Returns (alpha, f_a, dphi_a, g_a); all None when no step is found.
    """
    problem = as_problem(problem)
    pk_host = to_host(pk)
    if torch.is_tensor(xk):
        pk = torch.as_tensor(pk, dtype=xk.dtype, device=xk.device)
    else:
        pk = pk_host
    if fg_at_xk is None:
        fg_at_xk = problem.fg(xk)
    f0, g0 = fg_at_xk
    f0 = float(f0)
    dphi0 = float(np.dot(to_host(g0).ravel(), pk_host.ravel()))
    if dphi0 >= 0:
        return None, None, None, None

    # single memo slot: phi/derphi/gradient at one alpha share an fg call
    memo = {'a': None, 'f': None, 'd': None, 'g': None}

    def probe(a):
        if memo['a'] != a:
            fa, ga = problem.fg(xk + a * pk)
            memo.update(a=a, f=float(fa), g=ga,
                        d=float(np.dot(to_host(ga).ravel(), pk_host.ravel())))
        return memo['f'], memo['d']

    def _accept(a):
        fa, da = probe(a)
        return a, fa, da, memo['g']

    def wolfe_ok(a, fa, da):
        return (fa <= f0 + c1 * a * dphi0) and (abs(da) <= -c2 * dphi0)

    def zoom(a_lo, f_lo, d_lo, a_hi, f_hi, a_rec=None, f_rec=None):
        # Algorithm 3.6: shrink [a_lo, a_hi] keeping the Wolfe invariants
        for _ in range(30):
            a_j = _interp_min(a_lo, f_lo, d_lo, a_hi, f_hi, a_rec, f_rec)
            f_j, d_j = probe(a_j)
            if f_j > f0 + c1 * a_j * dphi0 or f_j >= f_lo:
                a_rec, f_rec = a_hi, f_hi
                a_hi, f_hi = a_j, f_j
            else:
                if abs(d_j) <= -c2 * dphi0:
                    return _accept(a_j)
                if d_j * (a_hi - a_lo) >= 0:
                    a_rec, f_rec = a_hi, f_hi
                    a_hi, f_hi = a_lo, f_lo
                else:
                    a_rec, f_rec = a_lo, f_lo
                a_lo, f_lo, d_lo = a_j, f_j, d_j
            if abs(a_hi - a_lo) < 1e-14 * max(1.0, abs(a_hi)):
                break
        return None, None, None, None

    cap = np.inf if maxalpha is None else float(maxalpha)
    a_prev, f_prev, d_prev = 0.0, f0, dphi0
    a_i = min(1.0, cap)

    for i in range(maxiter):
        f_i, d_i = probe(a_i)
        if f_i > f0 + c1 * a_i * dphi0 or (i > 0 and f_i >= f_prev):
            return zoom(a_prev, f_prev, d_prev, a_i, f_i)
        if abs(d_i) <= -c2 * dphi0:
            return _accept(a_i)
        if d_i >= 0:
            return zoom(a_i, f_i, d_i, a_prev, f_prev)
        if a_i >= cap:
            # capped step with decrease and descending slope: take it
            return _accept(a_i)
        a_prev, f_prev, d_prev = a_i, f_i, d_i
        a_i = min(2.0 * a_i, cap)
    return None, None, None, None


__all__ = ['ls_strong_wolfe']
