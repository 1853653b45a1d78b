"""Q (Forbes) polynomials: Qbfs, Qcon, and 2D-Q freeforms.

Counterpart of ``prysm_tpu/polynomials/qpoly.py``.  All scalar recurrence
coefficients (g/h/f for Qbfs per oe-18-19-19700 App. A; A/B/C, G/F/g/f for
Q2D per oe-20-3-2483 App. A) are host-side cached Python floats, computed
in Python and numpy, never in torch (torch's CPU float64 ``sqrt`` is not
correctly rounded); the array recurrences and Clenshaw sums are Python
loops over the order axis, one elementwise pass per operation.  Sums never
materialize mode stacks: ``compute_z_zprime_*`` give the sag and its
derivatives from Clenshaw alpha tables, the path freeform sags take.
"""
import math
from functools import lru_cache
from collections import defaultdict

import torch

from ..conf import to_tensor
from ..mathops import kronecker, gamma, sign
from ._recurrence import grid_zeros
from .jacobi import jacobi_sum_clenshaw_der  # NOQA: F401 - importable from qpoly as in the reference

_INV_SQRT19 = 1.0 / math.sqrt(19)


def _factorial2(n):
    """Double factorial n!! for integer n >= -1 (host-side)."""
    if n <= 0:
        return 1.0
    out = 1.0
    while n > 0:
        out *= n
        n -= 2
    return out


def _trim_trailing_zeros(coefs):
    """Drop trailing exact-zero coefficients from a dense coefficient vector."""
    if coefs is None:
        return []
    if not hasattr(coefs, '__len__'):
        coefs = list(coefs)
    n = len(coefs)
    while n > 0 and _is_exact_zero(coefs[n - 1]):
        n -= 1
    if n == 0:
        return []
    return list(coefs[:n])


def _is_exact_zero(c):
    try:
        return float(c) == 0.0
    except (TypeError, ValueError, RuntimeError):
        return False  # a tensor of several values; keep it


# ---------------------------------------------------------------------------
# Qbfs scalar machinery (oe-18-19-19700 App. A)
# ---------------------------------------------------------------------------

@lru_cache(1000)
def g_qbfs(n_minus_1):
    """g(m-1) from oe-18-19-19700 eq. (A.15)."""
    if n_minus_1 == 0:
        return -0.5
    n_minus_2 = n_minus_1 - 1
    return -(1 + g_qbfs(n_minus_2) * h_qbfs(n_minus_2)) / f_qbfs(n_minus_1)


@lru_cache(1000)
def h_qbfs(n_minus_2):
    """h(m-2) from oe-18-19-19700 eq. (A.14)."""
    n = n_minus_2 + 2
    return -n * (n - 1) / (2 * f_qbfs(n_minus_2))


@lru_cache(1000)
def f_qbfs(n):
    """f(m) from oe-18-19-19700 eq. (A.16)."""
    if n == 0:
        return 2.0
    if n == 1:
        return math.sqrt(19) / 2
    term1 = n * (n + 1) + 3
    term2 = g_qbfs(n - 1) ** 2
    term3 = h_qbfs(n - 2) ** 2
    return math.sqrt(term1 - term2 - term3)


def Qbfs(n, x):
    """Qbfs polynomial of order n at point(s) x (prefix x^2(1-x^2) included)."""
    x = to_tensor(x)
    rho = x * x
    c_Q = rho * (1 - rho)
    if n == 0:
        return c_Q
    if n == 1:
        return _INV_SQRT19 * (13 - 16 * rho) * c_Q
    c = 2 - 4 * rho
    Pnm2, Pnm1 = 2.0, 6 - 8 * rho
    Qnm2, Qnm1 = 1.0, _INV_SQRT19 * (13 - 16 * rho)
    for nn in range(2, n + 1):
        Pn = c * Pnm1 - Pnm2
        Pnm2, Pnm1 = Pnm1, Pn
        g = g_qbfs(nn - 1)
        h = h_qbfs(nn - 2)
        f = f_qbfs(nn)
        Qn = (Pn - g * Qnm1 - h * Qnm2) * (1 / f)
        Qnm2, Qnm1 = Qnm1, Qn
    return Qn * c_Q


def Qbfs_seq(ns, x):
    """Qbfs polynomials of orders ns; shape (len(ns), *x.shape)."""
    x = to_tensor(x)
    ns = list(ns)
    rho = x * x
    c_Q = rho * (1 - rho)
    nmax = max(ns)
    Q_list, _ = _qbfs_tables(nmax, rho)
    return torch.stack([Q_list[n] * c_Q for n in ns])


def Qbfs_der(n, x):
    """d/dx Qbfs_n = (2x - 4x^3) Q_n(x^2) + x^2(1-x^2) 2x Q'_n(x^2)."""
    x = to_tensor(x)
    rho = x * x
    env = rho * (1 - rho)
    denv_dx = 2 * x - 4 * x * rho
    Q_list, dQ_list = _qbfs_tables(n, rho)
    return denv_dx * Q_list[n] + env * (2 * x) * dQ_list[n]


def Qbfs_der_seq(ns, x):
    """d/dx Qbfs at orders ns."""
    x = to_tensor(x)
    ns = list(ns)
    rho = x * x
    env = rho * (1 - rho)
    denv_dx = 2 * x - 4 * x * rho
    two_x = 2 * x
    Q_list, dQ_list = _qbfs_tables(max(ns), rho)
    return torch.stack([denv_dx * Q_list[n] + env * two_x * dQ_list[n] for n in ns])


def change_basis_Qbfs_to_Pn(cs):
    """Change basis Qbfs -> auxiliary P_n (shifted Chebyshev third kind).

    Host-side for float coefficients; tensor coefficients work as well.
    """
    cs = list(cs)
    M = len(cs) - 1
    bs = [None] * (M + 1)
    bs[M] = cs[M] / f_qbfs(M)
    if M == 0:
        return bs
    bs[M - 1] = (cs[M - 1] - g_qbfs(M - 1) * bs[M]) / f_qbfs(M - 1)
    for i in range(M - 2, -1, -1):
        bs[i] = (cs[i] - g_qbfs(i) * bs[i + 1] - h_qbfs(i) * bs[i + 2]) / f_qbfs(i)
    return bs


def _clenshaw_alphas_py(coefs, lin_fn, linx_fn, c_fn, x, j=0):
    """Dense Clenshaw alpha tables, a Python loop over orders.

    Returns nested lists alphas[jj][n] of tensors; the slot axis is
    padded to at least 4 entries (callers read alphas[...][1] and, for Q2D
    m=1, alphas[...][3]).
    """
    ones = torch.ones_like(x)
    zeros = torch.zeros_like(x)
    M = len(coefs) - 1
    nslots = max(len(coefs), 4)
    a = [[zeros for _ in range(nslots + 2)] for _ in range(j + 1)]
    if M < 0:
        return a
    a[0][M] = coefs[M] * ones
    if M >= 1:
        a[0][M - 1] = coefs[M - 1] + lin_fn(M - 1) * a[0][M]
        for n in range(M - 2, -1, -1):
            a[0][n] = coefs[n] + lin_fn(n) * a[0][n + 1] - c_fn(n + 1) * a[0][n + 2]
    for jj in range(1, j + 1):
        if jj > M:
            continue
        a[jj][M - jj] = jj * linx_fn(M - jj) * a[jj - 1][M - jj + 1]
        for n in range(M - jj - 1, -1, -1):
            a[jj][n] = (jj * linx_fn(n) * a[jj - 1][n + 1]
                        + lin_fn(n) * a[jj][n + 1]
                        - c_fn(n + 1) * a[jj][n + 2])
    return a


def clenshaw_qbfs(cs, usq):
    """Clenshaw alpha sums of a Qbfs surface; see compute_z_Qbfs."""
    usq = to_tensor(usq)
    cs = _trim_trailing_zeros(cs)
    x = usq
    if len(cs) == 0:
        zeros = torch.zeros_like(x)
        return [zeros, zeros]
    bs = change_basis_Qbfs_to_Pn(cs)
    prefix = 2 - 4 * x
    a = _clenshaw_alphas_py(bs, lambda n: prefix, lambda n: -4.0, lambda n: 1.0, x)
    return a[0]


def clenshaw_qbfs_der(cs, usq, j=1):
    """Clenshaw alpha tables with j derivative tracks for a Qbfs surface."""
    usq = to_tensor(usq)
    cs = _trim_trailing_zeros(cs)
    x = usq
    if len(cs) == 0:
        zeros = torch.zeros_like(x)
        return [[zeros, zeros] for _ in range(j + 1)]
    bs = change_basis_Qbfs_to_Pn(cs)
    prefix = 2 - 4 * x
    return _clenshaw_alphas_py(bs, lambda n: prefix, lambda n: -4.0,
                               lambda n: 1.0, x, j=j)


def product_rule(u, v, du, dv):
    """d/dx uv = u dv + v du."""
    return u * dv + v * du


def compute_z_zprime_Qbfs(coefs, u, usq):
    """Sag and first radial derivative of a Qbfs surface (no base sphere)."""
    u, usq = to_tensor(u), to_tensor(usq)
    coefs = _trim_trailing_zeros(coefs)
    if len(coefs) == 0:
        return torch.zeros_like(u), torch.zeros_like(u)
    alphas = clenshaw_qbfs_der(coefs, usq, j=1)
    S = 2 * (alphas[0][0] + alphas[0][1])
    Sprime = (alphas[1][0] + alphas[1][1]) * 4 * u
    prefix = usq * (1 - usq)
    dprefix = 2 * u - 4 * (usq * u)
    Sprime = product_rule(prefix, S, dprefix, Sprime)
    S = S * prefix
    return S, Sprime


def compute_z_Qbfs(coefs, u, usq):
    """Sag-only sibling of compute_z_zprime_Qbfs."""
    u, usq = to_tensor(u), to_tensor(usq)
    alphas = clenshaw_qbfs(coefs, usq)
    return (usq * (1 - usq)) * (2 * (alphas[0] + alphas[1]))


# ---------------------------------------------------------------------------
# Qcon (jacobi alpha=0, beta=4 on x -> 2x^2 - 1, times x^4)
# ---------------------------------------------------------------------------

@lru_cache(512)
def _qcon_abc(n):
    """A, B, C of the jacobi(0, 4) recurrence Qcon is built on."""
    A = (2 * n + 5) * (n + 3) / ((n + 1) * (n + 5))
    B = -4 * (2 * n + 5) / ((n + 1) * (n + 5) * (n + 2))
    C = n * (n + 4) * (n + 3) / ((n + 1) * (n + 5) * (n + 2))
    return A, B, C


def _qcon_jacobi_all(nmax, xx, with_der=False):
    A0, B0, _ = _qcon_abc(0)
    ones = torch.ones_like(xx)
    zeros = torch.zeros_like(xx)
    P = [ones, A0 * xx + B0]
    D = [zeros, ones * A0]
    for k in range(2, nmax + 1):
        A, B, C = _qcon_abc(k - 1)
        lin = A * xx + B
        P.append(lin * P[-1] - C * P[-2])
        if with_der:
            D.append(A * P[-2] + lin * D[-1] - C * D[-2])
    if with_der:
        return P[:nmax + 1], D[:nmax + 1]
    return P[:nmax + 1]


def Qcon(n, x):
    """Qcon polynomial of order n: x^4 * P_n^{(0,4)}(2x^2 - 1)."""
    x = to_tensor(x)
    x2 = x * x
    xx = 2 * x2 - 1
    Pn = _qcon_jacobi_all(max(n, 1), xx)[n]
    return Pn * x2 * x2


def Qcon_seq(ns, x):
    """Qcon polynomials at orders ns."""
    x = to_tensor(x)
    ns = list(ns)
    x2 = x * x
    xx = 2 * x2 - 1
    x4 = x2 * x2
    P = _qcon_jacobi_all(max(max(ns), 1), xx)
    return torch.stack([P[n] * x4 for n in ns])


def Qcon_der(n, x):
    """d/dx Qcon_n = 4x^3 P_n + 4x^5 P'_n."""
    x = to_tensor(x)
    xx = 2 * x * x - 1
    x3 = x * x * x
    P, D = _qcon_jacobi_all(max(n, 1), xx, with_der=True)
    return 4 * x3 * P[n] + 4 * x3 * (x * x) * D[n]


def Qcon_der_seq(ns, x):
    """d/dx Qcon at orders ns."""
    x = to_tensor(x)
    ns = list(ns)
    xx = 2 * x * x - 1
    x3 = x * x * x
    x5 = x3 * x * x
    P, D = _qcon_jacobi_all(max(max(ns), 1), xx, with_der=True)
    return torch.stack([4 * x3 * P[n] + 4 * x5 * D[n] for n in ns])


def compute_z_zprime_Qcon(coefs, u, usq):
    """Sag and first radial derivative of a Qcon surface (no base sphere)."""
    u, usq = to_tensor(u), to_tensor(usq)
    coefs = _trim_trailing_zeros(coefs)
    if len(coefs) == 0:
        return torch.zeros_like(u), torch.zeros_like(u)
    x = 2 * usq - 1
    from .jacobi import recurrence_abc

    def lin(n):
        A, B, _ = recurrence_abc(n, 0, 4)
        return A * x + B

    def linx(n):
        return recurrence_abc(n, 0, 4)[0]

    def c_fn(n):
        return recurrence_abc(n, 0, 4)[2]

    alphas = _clenshaw_alphas_py(list(coefs), lin, linx, c_fn, x, j=1)
    S = alphas[0][0]
    Sprime = alphas[1][0] * 4 * u
    prefix = usq * usq
    dprefix = 4 * (usq * u)
    Sprime = product_rule(prefix, S, dprefix, Sprime)
    S = S * prefix
    return S, Sprime


# ---------------------------------------------------------------------------
# 2D-Q scalar machinery (oe-20-3-2483 App. A)
# ---------------------------------------------------------------------------

@lru_cache(4000)
def abc_q2d(n, m):
    """A, B, C terms for 2D-Q polynomials, oe-20-3-2483 Eq. (A.3).

    Written in terms of the ladder s_k = m + 2n - k that the paper's
    appendix builds everything from; all three share denominator D.
    """
    s1, s2, s3 = m + 2 * n - 1, m + 2 * n - 2, m + 2 * n - 3
    D = (4 * n ** 2 - 1) * (m + n - 2) * s3
    A = ((2 * n - 1) * s2 * (4 * n * (m + n - 2) + (m - 3) * (2 * m - 1))) / D
    B = (-2 * (2 * n - 1) * s3 * s2 * s1) / D
    C = (n * (2 * n - 3) * s1 * (2 * m + 2 * n - 3)) / D
    return A, B, C


@lru_cache(4000)
def G_q2d(n, m):
    """G term for 2D-Q polynomials, oe-20-3-2483 Eq. (A.15)."""
    if n == 0:
        return (_factorial2(2 * m - 1)
                / (2 ** (m + 1) * math.factorial(m - 1)))
    if m == 1:
        axial = (2 * n ** 2 - 1) * (n ** 2 - 1) / (8 * (4 * n ** 2 - 1))
        return -axial - kronecker(n, 1) / 24
    num = (2 * n * (m + n - 1) - m) * ((n + 1) * (2 * m + 2 * n - 1))
    den = ((m + 2 * n - 2) * (m + 2 * n - 1)
           * (m + 2 * n) * (2 * n + 1))
    return -(num / den) * gamma(n, m)


@lru_cache(4000)
def F_q2d(n, m):
    """F term for 2D-Q polynomials, oe-20-3-2483 Eq. (A.13)."""
    if n == 0:
        if m == 1:
            return 0.25
        return (m ** 2 * _factorial2(2 * m - 3)
                / (2 ** (m + 1) * math.factorial(m - 1)))
    if m == 1:
        axial = (4 * (n - 1) ** 2 * n ** 2 + 1) / (8 * (2 * n - 1) ** 2)
        return axial + 11 / 32 * kronecker(n, 1)
    rise = 4 * n * (m + n - 2)
    num = (2 * n * (m + n - 2) * (3 - 5 * m + rise)
           + m ** 2 * (3 - m + rise))
    den = ((m + 2 * n - 3) * (m + 2 * n - 2)
           * (m + 2 * n - 1) * (2 * n - 1))
    return (num / den) * gamma(n, m)


@lru_cache(4000)
def g_q2d(n, m):
    """Lowercase g, oe-20-3-2483 Eq. (A.18a)."""
    return G_q2d(n, m) / f_q2d(n, m)


@lru_cache(4000)
def f_q2d(n, m):
    """Lowercase f, oe-20-3-2483 Eq. (A.18b)."""
    if n == 0:
        return math.sqrt(F_q2d(n=0, m=m))
    return math.sqrt(F_q2d(n, m) - g_q2d(n - 1, m) ** 2)


# ---------------------------------------------------------------------------
# 2D-Q evaluation
# ---------------------------------------------------------------------------

def _qbfs_tables(Nmax, u):
    """Tables of the auxiliary Qbfs polynomial Q_n(u) and dQ_n/du."""
    ones = torch.ones_like(u)
    zeros = torch.zeros_like(u)
    Q_list = [ones]
    dQ_list = [zeros]
    if Nmax == 0:
        return Q_list, dQ_list
    Q1 = _INV_SQRT19 * (13 - 16 * u)
    dQ1 = -16 * _INV_SQRT19 * ones
    Q_list.append(Q1)
    dQ_list.append(dQ1)
    if Nmax == 1:
        return Q_list, dQ_list
    P_prev, P_curr = 2.0 * ones, 6 - 8 * u
    dP_prev, dP_curr = zeros, -8.0 * ones
    Q_prev, Q_curr = Q_list[0], Q1
    dQ_prev, dQ_curr = zeros, dQ1
    lin = 2 - 4 * u
    for nn in range(2, Nmax + 1):
        Pn = lin * P_curr - P_prev
        dPn = lin * dP_curr - dP_prev - 4 * P_curr
        g, h = g_qbfs(nn - 1), h_qbfs(nn - 2)
        inv_f = 1 / f_qbfs(nn)
        Qn = (Pn - g * Q_curr - h * Q_prev) * inv_f
        dQn = (dPn - g * dQ_curr - h * dQ_prev) * inv_f
        P_prev, P_curr, dP_prev, dP_curr = P_curr, Pn, dP_curr, dPn
        Q_prev, Q_curr, dQ_prev, dQ_curr = Q_curr, Qn, dQ_curr, dQn
        Q_list.append(Qn)
        dQ_list.append(dQn)
    return Q_list, dQ_list


def _q2d_tables(Nmax, m, u):
    """Tables of Q_n^m(u) and dQ_n^m/du for n=0..Nmax, m >= 1."""
    if m < 1:
        raise ValueError(f'_q2d_tables requires m >= 1, got {m}')
    ones = torch.ones_like(u)
    zeros = torch.zeros_like(u)
    f0 = f_q2d(0, m)
    Q_prev = ones * (1 / (2 * f0))
    dQ_prev = zeros
    Q_list = [Q_prev]
    dQ_list = [dQ_prev]
    if Nmax == 0:
        return Q_list, dQ_list
    P_prev = ones * 0.5
    dP_prev = zeros
    if m == 1:
        P_curr = 1 - u / 2
        dP_curr = ones * -0.5
    else:
        P_curr = (m - 0.5) + (1 - m) * u
        dP_curr = ones * (1.0 - m)
    g0 = g_q2d(0, m)
    inv_f1 = 1 / f_q2d(1, m)
    Q_curr = (P_curr - g0 * Q_prev) * inv_f1
    dQ_curr = (dP_curr - g0 * dQ_prev) * inv_f1
    Q_list.append(Q_curr)
    dQ_list.append(dQ_curr)
    if Nmax == 1:
        return Q_list, dQ_list
    if m == 1:
        P2 = (3 - u * (12 - 8 * u)) / 6
        dP2 = (-12 + 16 * u) / 6
        g1 = g_q2d(1, 1)
        inv_f2 = 1 / f_q2d(2, 1)
        Q2 = (P2 - g1 * Q_curr) * inv_f2
        dQ2 = (dP2 - g1 * dQ_curr) * inv_f2
        Q_list.append(Q2)
        dQ_list.append(dQ2)
        if Nmax == 2:
            return Q_list, dQ_list
        P3 = (5 - u * (60 - u * (120 - 64 * u))) / 10
        dP3 = (-60 + u * (240 - 192 * u)) / 10
        g2 = g_q2d(2, 1)
        inv_f3 = 1 / f_q2d(3, 1)
        Q3 = (P3 - g2 * Q2) * inv_f3
        dQ3 = (dP3 - g2 * dQ2) * inv_f3
        Q_list.append(Q3)
        dQ_list.append(dQ3)
        if Nmax == 3:
            return Q_list, dQ_list
        P_prev, P_curr = P2, P3
        dP_prev, dP_curr = dP2, dP3
        Q_curr, dQ_curr = Q3, dQ3
        start_n = 4
    else:
        start_n = 2
    for nn in range(start_n, Nmax + 1):
        A, B, C = abc_q2d(nn - 1, m)
        Pn = (A + B * u) * P_curr - C * P_prev
        dPn = B * P_curr + (A + B * u) * dP_curr - C * dP_prev
        gnm1 = g_q2d(nn - 1, m)
        inv_fn = 1 / f_q2d(nn, m)
        Qn = (Pn - gnm1 * Q_curr) * inv_fn
        dQn = (dPn - gnm1 * dQ_curr) * inv_fn
        P_prev, P_curr = P_curr, Pn
        dP_prev, dP_curr = dP_curr, dPn
        Q_curr, dQ_curr = Qn, dQn
        Q_list.append(Qn)
        dQ_list.append(dQn)
    return Q_list, dQ_list


def _ladder_and_factor():
    # deferred import: zernike owns the harmonic-ladder helpers and also
    # imports jacobi, but never this module, so there is no cycle
    from .zernike import _harmonic_ladder, _angular_factor
    return _harmonic_ladder, _angular_factor


def Q2d(n, m, r, t):
    """2D-Q polynomial Q2d_n^m(r, t), prefixes included."""
    r, t = to_tensor(r), to_tensor(t)
    if m == 0:
        return Qbfs(n, r)
    u = r
    x = u * u
    am = abs(m)
    if sign(m) == -1:
        prefix = u ** am * torch.sin(am * t)
    else:
        prefix = u ** am * torch.cos(m * t)
    Q_list, _ = _q2d_tables(n, am, x)
    return Q_list[n] * prefix


def _q2d_plan(nms):
    """(orders, signed_ms): per-|m| max radial order and signed m's in use."""
    orders = defaultdict(int)
    signed = set()
    for n, m in nms:
        am = abs(m)
        orders[am] = max(orders[am], n)
        if m != 0:
            signed.add(m)
    return dict(orders), signed


def _azimuthal_pair(m, t):
    """(T, dT/dt): T = cos(|m| t) for m > 0, sin(|m| t) for m < 0."""
    am = abs(m)
    if m > 0:
        return torch.cos(am * t), -am * torch.sin(am * t)
    return torch.sin(am * t), am * torch.cos(am * t)


def Q2d_seq(nms, r, t):
    """Stack of 2D-Q polynomials at (n, m) pairs."""
    r, t = to_tensor(r), to_tensor(t)
    nms = list(nms)
    orders, signed = _q2d_plan(nms)
    angular = {m: _azimuthal_pair(m, t)[0] * r ** abs(m) for m in signed}
    radial = {
        am: (list(Qbfs_seq(range(N + 1), r)) if am == 0
             else _q2d_tables(N, am, r * r)[0])
        for am, N in orders.items()
    }
    return torch.stack([
        radial[abs(m)][n] * angular[m] if m != 0 else radial[0][n]
        for n, m in nms
    ])


def Q2d_der(n, m, r, t):
    """Polar partial derivatives (d/dr, d/dt) of Q2d_n^m."""
    r, t = to_tensor(r), to_tensor(t)
    if m == 0:
        return Qbfs_der(n, r), grid_zeros(r, t)
    u = r * r
    am = abs(m)
    Q_list, dQ_list = _q2d_tables(n, am, u)
    Q = Q_list[n]
    dQdu = dQ_list[n]
    if m > 0:
        trig = torch.cos(am * t)
        trig_der = -am * torch.sin(am * t)
    else:
        trig = torch.sin(am * t)
        trig_der = am * torch.cos(am * t)
    if am == 1:
        r_am_minus_1 = torch.ones_like(r)
        r_am = r
    else:
        r_am_minus_1 = r ** (am - 1)
        r_am = r_am_minus_1 * r
    F = r_am * Q
    Fp = am * r_am_minus_1 * Q + 2 * r_am * r * dQdu
    return trig * Fp, trig_der * F


def Q2d_der_xy(n, m, x, y):
    """Cartesian partial derivatives (d/dx, d/dy) of Q2d_n^m, origin-smooth."""
    x, y = to_tensor(x), to_tensor(y)
    rho_sq = x * x + y * y
    am = abs(m)
    if m == 0:
        Q_list, dQ_list = _qbfs_tables(n, rho_sq)
        Q = Q_list[n]
        dQdu = dQ_list[n]
        u = rho_sq
        env = u * (1 - u)
        denv_du = 1 - 2 * u
        common = denv_du * Q + env * dQdu
        return 2 * x * common, 2 * y * common
    Q_list, dQ_list = _q2d_tables(n, am, rho_sq)
    J, Jp = Q_list[n], dQ_list[n]
    ladder, factor = _ladder_and_factor()
    H, Hx, Hy = factor(m, ladder(am, x, y))
    return 2 * x * Jp * H + J * Hx, 2 * y * Jp * H + J * Hy


def Q2d_der_seq(nms, r, t):
    """Polar derivative stacks (d/dr, d/dt) for (n, m) pairs."""
    r, t = to_tensor(r), to_tensor(t)
    nms = list(nms)
    orders, signed = _q2d_plan(nms)
    trig = {m: _azimuthal_pair(m, t) for m in signed}
    prefix_lo = {am: (torch.ones_like(r) if am == 1 else r ** (am - 1))
                 for am in {abs(m) for m in signed}}

    tables = {}
    for am, Nmax in orders.items():
        if am == 0:
            tables[0] = (Qbfs_der_seq(range(Nmax + 1), r), None)
        else:
            Q_list, dQ_list = _q2d_tables(Nmax, am, r * r)
            tables[am] = (Q_list, dQ_list)

    zeros = grid_zeros(r, t)
    out_dr, out_dt = [], []
    for n, m in nms:
        if m == 0:
            out_dr.append(tables[0][0][n] * torch.ones_like(zeros))
            out_dt.append(zeros)
            continue
        am = abs(m)
        Q, dQdu = (tab[n] for tab in tables[am])
        lo = prefix_lo[am]
        hi = lo * r  # r^|m|
        F = hi * Q
        Fp = am * lo * Q + 2 * hi * r * dQdu
        T, dT = trig[m]
        out_dr.append(T * Fp)
        out_dt.append(dT * F)
    return torch.stack(out_dr), torch.stack(out_dt)


def Q2d_der_xy_seq(nms, x, y):
    """Cartesian derivative stacks (d/dx, d/dy) for (n, m) pairs."""
    x, y = to_tensor(x), to_tensor(y)
    nms = list(nms)
    rho_sq = x * x + y * y
    max_ns = defaultdict(int)
    for n, m in nms:
        am = abs(m)
        if max_ns[am] < n:
            max_ns[am] = n
    Q_tables = {}
    dQ_tables = {}
    for am, Nmax in max_ns.items():
        if am == 0:
            Q_tables[0], dQ_tables[0] = _qbfs_tables(Nmax, rho_sq)
        else:
            Q_tables[am], dQ_tables[am] = _q2d_tables(Nmax, am, rho_sq)
    am_max = max(max_ns) if max_ns else 0
    make_ladder, factor = _ladder_and_factor()
    ladder = make_ladder(am_max, x, y) if am_max > 0 else None
    if 0 in max_ns:
        env = rho_sq * (1 - rho_sq)
        denv_du = 1 - 2 * rho_sq
    out_dx = []
    out_dy = []
    for n, m in nms:
        am = abs(m)
        Q, dQdu = Q_tables[am][n], dQ_tables[am][n]
        if m == 0:
            common = denv_du * Q + env * dQdu
            pair = (2 * x * common, 2 * y * common)
        else:
            H, Hx, Hy = factor(m, ladder)
            pair = (2 * x * dQdu * H + Q * Hx,
                    2 * y * dQdu * H + Q * Hy)
        out_dx.append(pair[0])
        out_dy.append(pair[1])
    return torch.stack(out_dx), torch.stack(out_dy)


def change_of_basis_Q2d_to_Pnm(cns, m):
    """Change of basis Q_n^m -> auxiliary P_n^m (oe-20-3-2483 A.1)."""
    if m < 0:
        m = -m
    cs = list(cns)
    N = len(cs) - 1
    ds = [None] * (N + 1)
    ds[N] = cs[N] / f_q2d(N, m)
    for n in range(N - 1, -1, -1):
        ds[n] = (cs[n] - g_q2d(n, m) * ds[n + 1]) / f_q2d(n, m)
    return ds


@lru_cache(4000)
def abc_q2d_clenshaw(n, m):
    """Special twist on A.3 for B.7: 5 patched low-order cases."""
    if m == 1:
        if n == 0:
            return 2, -1, 0
        if n == 1:
            return -4 / 3, -8 / 3, -11 / 3
        if n == 2:
            return 9 / 5, -24 / 5, 0
    if m == 2 and n == 0:
        return 3, -2, 0
    if m == 3 and n == 0:
        return 5, -4, 0
    return abc_q2d(n, m)


def clenshaw_q2d(cns, m, usq):
    """Clenshaw alpha sums for one azimuthal branch of a Q2D surface."""
    usq = to_tensor(usq)
    cns = _trim_trailing_zeros(cns)
    x = usq
    if len(cns) == 0:
        zeros = torch.zeros_like(x)
        return [zeros] * 6
    ds = change_of_basis_Q2d_to_Pnm(cns, m)

    def lin(n):
        A, B, _ = abc_q2d_clenshaw(n, m)
        return A + B * x

    def linx(n):
        return abc_q2d_clenshaw(n, m)[1]

    def c_fn(n):
        return abc_q2d_clenshaw(n, m)[2]

    return _clenshaw_alphas_py(ds, lin, linx, c_fn, x)[0]


def clenshaw_q2d_der(cns, m, usq, j=1):
    """Clenshaw alpha tables with j derivative tracks for a Q2D branch."""
    usq = to_tensor(usq)
    cns = _trim_trailing_zeros(cns)
    x = usq
    if len(cns) == 0:
        zeros = torch.zeros_like(x)
        return [[zeros] * 6 for _ in range(j + 1)]
    ds = change_of_basis_Q2d_to_Pnm(cns, m)

    def lin(n):
        A, B, _ = abc_q2d_clenshaw(n, m)
        return A + B * x

    def linx(n):
        return abc_q2d_clenshaw(n, m)[1]

    def c_fn(n):
        return abc_q2d_clenshaw(n, m)[2]

    return _clenshaw_alphas_py(ds, lin, linx, c_fn, x, j=j)


def compute_z_zprime_Q2d(cm0, ams, bms, u, t):
    """Sag, radial, and azimuthal derivative of a Q2D surface (no base sphere).

    cm0: m=0 coefficients; ams/bms: per-m cosine/sine coefficient lists
    beginning at m=1 (oe-20-3-2483 Eq. 2.2 / App. B).
    """
    u, t = to_tensor(u), to_tensor(t)
    usq = u * u
    z, dr, dt = grid_zeros(u, t), grid_zeros(u, t), grid_zeros(u, t)

    cm0 = _trim_trailing_zeros(cm0)
    if len(cm0) > 0:
        zm0, zprimem0 = compute_z_zprime_Qbfs(cm0, u, usq)
        z = z + zm0
        dr = dr + zprimem0

    m = 0
    for a_coef, b_coef in zip(ams, bms):
        m += 1
        a_coef = _trim_trailing_zeros(a_coef)
        b_coef = _trim_trailing_zeros(b_coef)
        if len(a_coef) == 0 and len(b_coef) == 0:
            continue
        Na = len(a_coef) - 1
        Nb = len(b_coef) - 1
        Sa = Sb = Sprimea = Sprimeb = 0
        if len(a_coef) > 0:
            alphas_a = clenshaw_q2d_der(a_coef, m, usq)
            Sa = 0.5 * alphas_a[0][0]
            Sprimea = 0.5 * alphas_a[1][0]
        if len(b_coef) > 0:
            alphas_b = clenshaw_q2d_der(b_coef, m, usq)
            Sb = 0.5 * alphas_b[0][0]
            Sprimeb = 0.5 * alphas_b[1][0]
        if m == 1 and Na > 2:
            Sa = Sa - 2 / 5 * alphas_a[0][3]
            Sprimea = Sprimea - 2 / 5 * alphas_a[1][3]
        if m == 1 and Nb > 2:
            Sb = Sb - 2 / 5 * alphas_b[0][3]
            Sprimeb = Sprimeb - 2 / 5 * alphas_b[1][3]
        um = u ** m
        cost = torch.cos(m * t)
        sint = torch.sin(m * t)
        kernel = cost * Sa + sint * Sb
        z = z + um * kernel
        umm1 = u ** (m - 1)
        twousq = 2 * usq
        aterm = cost * (twousq * Sprimea + m * Sa)
        bterm = sint * (twousq * Sprimeb + m * Sb)
        dr = dr + umm1 * (aterm + bterm)
        dt = dt + m * um * (-Sa * sint + Sb * cost)
    return z, dr, dt


def compute_z_Q2d(cm0, ams, bms, u, t):
    """Sag-only sibling of compute_z_zprime_Q2d."""
    u, t = to_tensor(u), to_tensor(t)
    usq = u * u
    z = grid_zeros(u, t)
    cm0 = _trim_trailing_zeros(cm0)
    if len(cm0) > 0:
        z = z + compute_z_Qbfs(cm0, u, usq)
    m = 0
    for a_coef, b_coef in zip(ams, bms):
        m += 1
        a_coef = _trim_trailing_zeros(a_coef)
        b_coef = _trim_trailing_zeros(b_coef)
        if len(a_coef) == 0 and len(b_coef) == 0:
            continue
        Na = len(a_coef) - 1
        Nb = len(b_coef) - 1
        Sa = Sb = 0
        if len(a_coef) > 0:
            alphas_a = clenshaw_q2d(a_coef, m, usq)
            Sa = 0.5 * alphas_a[0]
        if len(b_coef) > 0:
            alphas_b = clenshaw_q2d(b_coef, m, usq)
            Sb = 0.5 * alphas_b[0]
        if m == 1 and Na > 2:
            Sa = Sa - 2 / 5 * alphas_a[3]
        if m == 1 and Nb > 2:
            Sb = Sb - 2 / 5 * alphas_b[3]
        um = u ** m
        z = z + um * (torch.cos(m * t) * Sa + torch.sin(m * t) * Sb)
    return z


def Q2d_nm_c_to_a_b(nms, coefs):
    """Restructure sparse (n, m, c) Q2D coefficients into (cms, ams, bms)."""
    def expand_and_copy(cs, N):
        cs2 = [None] * (N + 1)
        for i, cc in enumerate(cs):
            cs2[i] = cc
        return cs2

    cms = []
    ac = defaultdict(list)
    bc = defaultdict(list)
    for (n, m), c in zip(nms, coefs):
        if _is_exact_zero(c):
            continue
        if m == 0:
            if len(cms) < n + 1:
                cms = expand_and_copy(cms, n)
            cms[n] = c
        elif m > 0:
            if len(ac[m]) < n + 1:
                ac[m] = expand_and_copy(ac[m], n)
            ac[m][n] = c
        else:
            m = -m
            if len(bc[m]) < n + 1:
                bc[m] = expand_and_copy(bc[m], n)
            bc[m][n] = c
    cms = [0 if c is None else c for c in cms]
    for k in ac:
        ac[k] = [0 if c is None else c for c in ac[k]]
    for k in bc:
        bc[k] = [0 if c is None else c for c in bc[k]]
    cms = list(_trim_trailing_zeros(cms))
    for k in list(ac.keys()):
        ac[k] = list(_trim_trailing_zeros(ac[k]))
        if len(ac[k]) == 0:
            del ac[k]
    for k in list(bc.keys()):
        bc[k] = list(_trim_trailing_zeros(bc[k]))
        if len(bc[k]) == 0:
            del bc[k]
    max_m = max([*ac.keys(), *bc.keys(), 0])
    ac_ret = []
    bc_ret = []
    for i in range(1, max_m + 1):
        ac_ret.append(ac.get(i, []))
        bc_ret.append(bc.get(i, []))
    return cms, ac_ret, bc_ret
