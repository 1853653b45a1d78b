"""Zernike polynomials.

Counterpart of ``prysm_tpu/polynomials/zernike.py``; the barplots are
host-side and import matplotlib (through ``plotting``) when called.
Z_n^m = P_{(n-|m|)/2}^{(0, |m|)}(2r^2 - 1) * r^|m| * trig(|m| t); the
sequence evaluators run one Jacobi chain per unique |m| and share r^|m|
and the trig factors across modes of the same |m|.
``zernike_sum_der_xy`` gives a coefficient sum and its Cartesian gradient
by one Clenshaw pass per |m| branch, without the mode stack.
"""
from collections import defaultdict

import numpy as np
import torch

from ..conf import to_tensor
from ._clenshaw import clenshaw_alphas_scan
from .jacobi import (  # NOQA: F401 - re-exported as part of the zernike toolkit
    jacobi, jacobi_der, jacobi_seq, jacobi_seq_with_der, jacobi_sum_clenshaw_der,
    jacobi_with_der, recurrence_abc)
from ..mathops import kronecker, sign, is_odd

__all__ = ['zernike_norm', 'zero_separation', 'zernike_nm', 'zernike_nm_seq', 'zernike_sum',
           'zernike_nm_der', 'zernike_nm_der_seq', 'zernike_nm_der_xy',
           'zernike_nm_der_xy_seq', 'zernike_sum_der_xy', 'nm_to_fringe', 'nm_to_ansi_j',
           'ansi_j_to_nm', 'noll_to_nm', 'fringe_to_nm', 'zernikes_to_magnitude_angle_nmkey',
           'zernikes_to_magnitude_angle', 'nm_to_name', 'top_n', 'barplot',
           'barplot_magnitudes']


def zernike_norm(n, m):
    """Norm of Zernike polynomial (n, m); unit RMS over the disk."""
    return float(np.sqrt((2 * (n + 1)) / (1 + kronecker(m, 0))))


def zero_separation(n):
    """Zero separation in normalized r based on radial order n."""
    return 1 / n ** 2


def zernike_nm(n, m, r, t, norm=True):
    """Zernike polynomial of radial order n, azimuthal order m at (r, t)."""
    r, t = to_tensor(r), to_tensor(t)
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
    r, t = to_tensor(r), to_tensor(t)
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
    x, y = to_tensor(x), to_tensor(y)
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


def zernike_nm_der(n, m, r, t, norm=True):
    """(dZ/dr, dZ/dt) for Zernike (n, m)."""
    r, t = to_tensor(r), to_tensor(t)
    x = 2 * (r * r) - 1
    am = abs(m)
    v, Jp = jacobi_with_der((n - am) // 2, 0, am, x)
    dv = (4 * r) * Jp
    if m == 0:
        dr = dv
        dt = torch.zeros_like(dv)
    else:
        u = r ** am
        du = am * r ** (am - 1)
        dr = v * du + u * dv
        if m < 0:
            dr = dr * torch.sin(am * t)
            dt = am * torch.cos(am * t) * u * v
        else:
            dr = dr * torch.cos(m * t)
            dt = -m * torch.sin(m * t) * u * v
    if norm:
        znorm = zernike_norm(n, m)
        dr = dr * znorm
        dt = dt * znorm
    return dr, dt


def zernike_nm_der_seq(nms, r, t, norm=True):
    """Stacked (dZ/dr, dZ/dt): shape (len(nms), 2, *r.shape)."""
    nms = list(nms)
    r, t = to_tensor(r), to_tensor(t)
    if not nms:
        return torch.zeros((0, 2) + tuple(r.shape), dtype=r.dtype, device=r.device)
    x = 2 * (r * r) - 1
    plan = _zernike_static_plan(nms)
    tables = {am: jacobi_seq_with_der(range(max_nj + 1), 0, am, x)
              for am, max_nj in plan.items()}
    powers, dpowers, sines, cosines = {}, {}, {}, {}
    for am in plan:
        if am == 0:
            continue
        if am == 1:
            powers[am] = r
            dpowers[am] = torch.ones_like(r)
        else:
            r_am_m1 = r ** (am - 1)
            powers[am] = r_am_m1 * r
            dpowers[am] = am * r_am_m1
        sines[am] = torch.sin(am * t)
        cosines[am] = torch.cos(am * t)

    four_r = 4 * r
    out = []
    for n, m in nms:
        am = abs(m)
        n_j = (n - am) // 2
        v = tables[am][0][n_j]
        dv = four_r * tables[am][1][n_j]
        if m == 0:
            dr = dv
            dt = torch.zeros_like(dv)
        else:
            u, du = powers[am], dpowers[am]
            dr = v * du + u * dv
            if m < 0:
                dr = dr * sines[am]
                dt = am * cosines[am] * u * v
            else:
                dr = dr * cosines[am]
                dt = -m * sines[am] * u * v
        if norm:
            znorm = zernike_norm(n, m)
            dr = dr * znorm
            dt = dt * znorm
        out.append(torch.stack([dr, dt]))
    return torch.stack(out)


def _harmonic_ladder(mmax, x, y):
    """Real/imag part pairs of (x + iy)^k for k = 0..mmax, as a list."""
    ladder = [(torch.ones_like(x), torch.zeros_like(x))]
    for _ in range(mmax):
        re, im = ladder[-1]
        ladder.append((x * re - y * im, x * im + y * re))
    return ladder


def _angular_factor(m, ladder):
    """(H, dH/dx, dH/dy) for the harmonic polynomial H = Re/Im (x+iy)^|m|.

    From d(x+iy)^k = k (x+iy)^(k-1) {dx + i dy}: the gradient of either
    component is |m| times the rung below, rotated.
    """
    am = abs(m)
    re_lo, im_lo = ladder[am - 1]
    re_hi, im_hi = ladder[am]
    if m > 0:
        return re_hi, am * re_lo, -am * im_lo
    return im_hi, am * im_lo, am * re_lo


def zernike_nm_der_xy(n, m, x, y, norm=True):
    """Cartesian (dZ/dx, dZ/dy), smooth everywhere including the origin.

    Z = J(2 rho^2 - 1) * H(x, y) with H the harmonic polynomial
    Re/Im (x + iy)^|m|; the gradient is the product rule through that
    factoring.
    """
    x, y = to_tensor(x), to_tensor(y)
    am = abs(m)
    u = 2 * (x * x + y * y) - 1
    J, Jp = jacobi_with_der((n - am) // 2, 0, am, u)
    # du/dx = 4x, du/dy = 4y
    gx, gy = 4 * x * Jp, 4 * y * Jp
    if am == 0:
        dzdx, dzdy = gx, gy
    else:
        H, Hx, Hy = _angular_factor(m, _harmonic_ladder(am, x, y))
        dzdx = gx * H + J * Hx
        dzdy = gy * H + J * Hy
    if not norm:
        return dzdx, dzdy
    N = zernike_norm(n, m)
    return dzdx * N, dzdy * N


def zernike_nm_der_xy_seq(nms, x, y, norm=True):
    """Stacked Cartesian derivatives: shape (len(nms), 2, *x.shape)."""
    nms = list(nms)
    x, y = to_tensor(x), to_tensor(y)
    if not nms:
        return torch.zeros((0, 2) + tuple(x.shape), dtype=x.dtype, device=x.device)
    u = 2 * (x * x + y * y) - 1
    plan = _zernike_static_plan(nms)
    tables = {am: jacobi_seq_with_der(range(max_nj + 1), 0, am, u)
              for am, max_nj in plan.items()}
    ladder = _harmonic_ladder(max(plan) if plan else 0, x, y)
    out = []
    for n, m in nms:
        am = abs(m)
        J, Jp = (tab[(n - am) // 2] for tab in tables[am])
        gx, gy = 4 * x * Jp, 4 * y * Jp
        if am == 0:
            dzdx, dzdy = gx, gy
        else:
            H, Hx, Hy = _angular_factor(m, ladder)
            dzdx = gx * H + J * Hx
            dzdy = gy * H + J * Hy
        if norm:
            N = zernike_norm(n, m)
            dzdx, dzdy = dzdx * N, dzdy * N
        out.append(torch.stack([dzdx, dzdy]))
    return torch.stack(out)


def zernike_sum_der_xy(coefs, nms, x, y, norm=True):
    """Zernike sum W and (dW/dx, dW/dy) in one Clenshaw pass per |m| branch.

    Never materializes individual modes; peak memory is O(x.size) per |m|
    branch.  Coefficients are host numbers; for tensor coefficients use
    zernike_nm_seq and tensordot.
    """
    by_m_cos, by_m_sin = {}, {}
    for c, (n, m) in zip(coefs, nms):
        am = abs(m)
        n_j = (n - am) // 2
        cc = c * zernike_norm(n, m) if norm else c
        arr = (by_m_cos if m >= 0 else by_m_sin).setdefault(am, [])
        while len(arr) <= n_j:
            arr.append(0.0)
        arr[n_j] = arr[n_j] + cc

    x, y = to_tensor(x), to_tensor(y)
    used_ms = set(by_m_cos) | set(by_m_sin)
    W, dWdx, dWdy = torch.zeros_like(x), torch.zeros_like(x), torch.zeros_like(x)
    if not used_ms:
        return W, dWdx, dWdy

    u = 2 * (x * x + y * y) - 1

    def _radial(am, s):
        M = len(s) - 1
        tab = np.asarray([recurrence_abc(k, 0, am) for k in range(0, max(M, 0) + 2)])
        # lin_n = A_n x + B_n -> p = B, q = A; c = C
        alphas = clenshaw_alphas_scan(s, tab[:, 1], tab[:, 0], tab[:, 2], u, j=1)
        return alphas[0, 0], alphas[1, 0]  # R(u), dR/du

    if 0 in by_m_cos:
        R, Ru = _radial(0, by_m_cos[0])
        W = W + R
        dWdx = dWdx + 4 * x * Ru
        dWdy = dWdy + 4 * y * Ru

    max_am = max(used_ms)
    if max_am >= 1:
        ladder = _harmonic_ladder(max_am, x, y)
        branches = [(m, by_m_cos[m]) for m in range(1, max_am + 1) if m in by_m_cos]
        branches += [(-m, by_m_sin[m]) for m in range(1, max_am + 1) if m in by_m_sin]
        for signed_m, coefs_m in branches:
            R, Ru = _radial(abs(signed_m), coefs_m)
            H, Hx, Hy = _angular_factor(signed_m, ladder)
            W = W + R * H
            dWdx = dWdx + (4 * x * Ru) * H + R * Hx
            dWdy = dWdy + (4 * y * Ru) * H + R * Hy
    return W, dWdx, dWdy


# ---------------------------------------------------------------------------
# index conversions and naming (host-side)
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


def zernikes_to_magnitude_angle_nmkey(coefs):
    """Zernike set -> {(n, |m|): (magnitude, angle)} representation."""
    combinations = defaultdict(list)
    for n, m, coef in coefs:
        combinations[(n, abs(m))].append(coef)
    out = {}
    for key, value in combinations.items():
        if len(value) == 1:
            magnitude, angle = value[0], 0
        else:
            magnitude = float(np.sqrt(sum(v ** 2 for v in value)))
            angle = float(np.degrees(np.arctan2(*value)))
        out[key] = (magnitude, angle)
    return out


def zernikes_to_magnitude_angle(coefs):
    """Zernike set -> {friendly name: (magnitude, angle)} representation."""
    d2 = {}
    for k, v in zernikes_to_magnitude_angle_nmkey(coefs).items():
        name = nm_to_name(*k)
        split = name.split(' ')
        d2[name if len(split) < 3 and 'Tilt' not in name else ' '.join(split[:-1])] = v
    return d2


# ordinal prefixes (1-based) and azimuthal family names (|m|, 1-based)
_ORDINALS = ('Primary', 'Secondary', 'Tertiary', 'Quaternary', 'Quinary')
_FAMILIES = ('Coma', 'Astigmatism', 'Trefoil', 'Quadrafoil', 'Pentafoil',
             'Hexafoil', 'Septafoil', 'Octafoil')


def _ordinal(k):
    return _ORDINALS[k - 1] if 1 <= k <= len(_ORDINALS) else f'{k}th'


def _family(am):
    return _FAMILIES[am - 1] if 1 <= am <= len(_FAMILIES) else f'{am}-foil'


def _order_rank(n, m):
    """Which Primary/Secondary/... copy of the family (n, m) belongs to."""
    if m == 0 and n >= 4:
        return n // 2 + 1
    if is_odd(m) and n >= 3:
        return abs((n - 3) // 2 + 1)
    return int(n / abs(m))


def nm_to_name(n, m):
    """Convert an (n, m) index into a human readable name."""
    positive = sign(m) == 1
    if n == 0:
        return 'Piston'
    if n == 1:
        return 'Tilt X' if positive else 'Tilt Y'
    if m == 0:
        return 'Defocus' if n == 2 else f'{_ordinal(n // 2 - 1)} Spherical'
    if is_odd(m):
        suffix = 'X' if positive else 'Y'
    else:
        suffix = '00°' if positive else '45°'
    return f'{_ordinal(_order_rank(n, m))} {_family(abs(m))} {suffix}'


def top_n(coefs, n=5):
    """Identify the top n terms in the wavefront expansion."""
    coefsv = np.asarray(list(coefs.values()))
    coefs_work = abs(coefsv)
    oidxs = np.asarray(list(coefs.keys()))
    idxs = np.argpartition(coefs_work, -n)[-n:]
    idxs = idxs[np.argsort(coefs_work[idxs])[::-1]]
    names = np.asarray([nm_to_name(*p) for p in oidxs])[idxs]
    return list(zip(coefsv[idxs], idxs, names))


def barplot(coefs, names=None, orientation='h', buffer=1, zorder=3,
            number=True, offset=0, width=0.8, fig=None, ax=None):
    """Bar plot of Zernike coefficients with names and index labels."""
    from ..plotting import share_fig_ax
    fig, ax = share_fig_ax(fig, ax)
    if torch.is_tensor(coefs):
        coefs = coefs.detach().cpu()
    coefs = np.asarray(coefs, dtype=float)
    idxs = np.arange(len(coefs))
    lims = (idxs[0] - buffer, idxs[-1] + buffer)
    if names is None:
        names = [str(i) for i in idxs]
    horizontal = orientation.lower() in ('h', 'horizontal')
    if horizontal:
        ax.bar(idxs + offset, coefs, zorder=zorder, width=width)
        ax.set_xticks(idxs, names, rotation=90)
        if number:
            dy = 0.01 * (coefs.max() - coefs.min())
            for i in idxs:
                ax.text(i, dy, str(i), ha='center')
        ax.set(xlim=lims)
    else:
        ax.barh(idxs + offset, coefs, zorder=zorder, height=width)
        ax.set_yticks(idxs, names)
        if number:
            for i in idxs:
                ax.text(0, i, str(i), ha='center')
        ax.set(ylim=lims)
    return fig, ax


def barplot_magnitudes(coefs, nms, errorbars=None, orientation='h',
                       sort=False, buffer=1, zorder=3, offset=0, width=0.8,
                       fig=None, ax=None):
    """Bar plot of Zernike magnitude pairs (one bar per astigmatism etc.)."""
    from ..plotting import share_fig_ax
    pak = zernikes_to_magnitude_angle(
        [(*nm, v) for nm, v in zip(nms, coefs)])
    mags = np.asarray([abs(v[0]) for v in pak.values()], dtype=float)
    names = np.asarray(list(pak.keys()), dtype=object)
    if errorbars is not None:
        epak = zernikes_to_magnitude_angle(
            [(*nm, v) for nm, v in zip(nms, errorbars)])
        errorbars = np.asarray([abs(v[0]) for v in epak.values()],
                                dtype=float)
    if sort:
        order = np.argsort(mags)
        mags = mags[order]
        names = names[order]
        if errorbars is not None:
            errorbars = errorbars[order]
    idxs = np.arange(len(names))
    lims = (idxs[0] - buffer, idxs[-1] + buffer)
    fig, ax = share_fig_ax(fig, ax)
    if orientation.lower() in ('h', 'horizontal'):
        ax.bar(idxs + offset, mags, zorder=zorder, width=width)
        if errorbars is not None:
            ax.errorbar(idxs + offset, mags, errorbars, fmt='o')
        ax.set_xticks(idxs, names, rotation=90)
        ax.set(xlim=lims)
    else:
        ax.barh(idxs + offset, mags, zorder=zorder, height=width)
        if errorbars is not None:
            ax.errorbar(mags, idxs + offset, xerr=errorbars, fmt='.',
                        color='r', zorder=zorder + 1, capsize=5)
        ax.set_yticks(idxs, names)
        ax.set(ylim=lims)
    return fig, ax
