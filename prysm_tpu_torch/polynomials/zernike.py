"""Zernike polynomials.

Counterpart of ``prysm_tpu/polynomials/zernike.py`` (the main path's
part).  Z_n^m = P_{(n-|m|)/2}^{(0, |m|)}(2r^2 - 1) * r^|m| * trig(|m| t);
the sequence evaluator runs one Jacobi chain per unique |m| and shares
r^|m| and the trig factors across modes of the same |m|.
"""
from collections import defaultdict

import numpy as np
import torch

from .jacobi import jacobi, jacobi_seq
from ..mathops import kronecker, sign, is_odd

__all__ = ['zernike_norm', 'zernike_nm', 'zernike_nm_seq', 'zernike_sum',
           'nm_to_fringe', 'nm_to_ansi_j', 'ansi_j_to_nm', 'noll_to_nm',
           'fringe_to_nm']


def zernike_norm(n, m):
    """Norm of Zernike polynomial (n, m); unit RMS over the disk."""
    return float(np.sqrt((2 * (n + 1)) / (1 + kronecker(m, 0))))


def zernike_nm(n, m, r, t, norm=True):
    """Zernike polynomial of radial order n, azimuthal order m at (r, t)."""
    x = 2 * (r * r) - 1
    am = abs(m)
    out = jacobi((n - am) // 2, 0, am, x)
    if m != 0:
        if m < 0:
            out = out * (r ** am * torch.sin(am * t))
        else:
            out = out * (r ** am * torch.cos(m * t))
    if norm:
        out = out * zernike_norm(n, m)
    return out


def _zernike_static_plan(nms):
    """Host-side evaluation plan: the largest Jacobi order for each |m|."""
    max_nj_by_am = defaultdict(int)
    for n, m in nms:
        am = abs(m)
        max_nj_by_am[am] = max(max_nj_by_am[am], (n - am) // 2)
    return dict(max_nj_by_am)


def zernike_nm_seq(nms, r, t, norm=True):
    """Zernike basis stack for (n, m) pairs; shape (len(nms), *r.shape)."""
    nms = list(nms)
    x = 2 * (r * r) - 1
    plan = _zernike_static_plan(nms)
    jacobi_tables = {am: jacobi_seq(range(max_nj + 1), 0, am, x)
                     for am, max_nj in plan.items()}
    powers, sines, cosines = {}, {}, {}
    for am in plan:
        if am == 0:
            continue
        powers[am] = r ** am
        sines[am] = torch.sin(am * t)
        cosines[am] = torch.cos(am * t)

    out = []
    for n, m in nms:
        am = abs(m)
        jac = jacobi_tables[am][(n - am) // 2]
        if norm:
            jac = jac * zernike_norm(n, m)
        if m == 0:
            out.append(jac)
        else:
            az = sines[am] if m < 0 else cosines[am]
            out.append(jac * az * powers[am])
    return torch.stack(out)


def zernike_sum(coefs, nms, x, y, norm=True):
    """Weighted Zernike sum on Cartesian unit-disk coordinates.

    2D grids go through the fused synthesis (``ops.zernike``): its CUDA
    kernel for CUDA tensors, its plain version for CPU tensors.  Other
    shapes build the mode stack.
    """
    nms = tuple(nms)
    if not nms:
        return torch.zeros_like(x)
    r = torch.hypot(x, y)
    t = torch.atan2(y, x)
    if r.ndim == 2:
        from ..ops.zernike import zernike_sum_pallas  # local: ops imports this package
        return zernike_sum_pallas(coefs, nms, r, t, norm=norm)
    Zk = zernike_nm_seq(nms, r, t, norm=norm)
    coefs = torch.as_tensor(coefs, dtype=Zk.dtype, device=Zk.device)
    return torch.tensordot(coefs, Zk, dims=([0], [0]))


# ---------------------------------------------------------------------------
# index conversions (host-side)
# ---------------------------------------------------------------------------

def nm_to_fringe(n, m):
    """Convert (n, m) two term index to Fringe index."""
    term1 = (1 + (n + abs(m)) / 2) ** 2
    term2 = 2 * abs(m)
    term3 = (1 + sign(m)) / 2
    return int(term1 - term2 - term3) + 1


def nm_to_ansi_j(n, m):
    """Convert (n, m) two term index to ANSI single term index."""
    return int((n * (n + 2) + m) / 2)


def ansi_j_to_nm(idx):
    """Convert ANSI single term to (n, m) two-term index."""
    n = int(np.ceil((-3 + np.sqrt(9 + 8 * idx)) / 2))
    m = 2 * idx - n * (n + 2)
    return n, m


def noll_to_nm(idx):
    """Convert Noll Z index to (n, m) two-term index."""
    n = int(np.ceil((-1 + np.sqrt(1 + 8 * idx)) / 2) - 1)
    if n == 0:
        m = 0
    else:
        nseries = int((n + 1) * (n + 2) / 2)
        res = idx - nseries - 1
        sgn = -1 if is_odd(idx) else 1
        ms = [1, 1] if is_odd(n) else [0]
        for _ in range(n // 2):
            ms.append(ms[-1] + 2)
            ms.append(ms[-1])
        m = ms[res] * sgn
    return n, m


def fringe_to_nm(idx):
    """Convert Fringe Z index to (n, m) two-term index."""
    m_n = 2 * (np.ceil(np.sqrt(idx)) - 1)
    g_s = (m_n / 2) ** 2 + 1
    n = m_n / 2 + np.floor((idx - g_s) / 2)
    m = (m_n - n) * (1 - np.mod(idx - g_s, 2) * 2)
    return int(n), int(m)
