"""Sag jets: one-pass value+derivative evaluation for surface shapes.

This module is the numeric core under the shape kind table in
``surfaces.py`` and the parity wrappers in ``sags.py``.  It deliberately
does not follow the reference's sag-function decomposition (separate
``*_sag`` / ``*_sag_der`` twins over rho): every rotationally symmetric
profile here is expressed over ``s = x**2 + y**2`` and evaluated as a
*jet* ``(z, dz/ds)`` in a single pass.  Cartesian gradients then follow
from the chain rule ``(dz/dx, dz/dy) = (2x, 2y) * dz/ds`` with no
``1/rho`` singularity anywhere, and sag + gradient (hence the surface
normal) always come from one traversal of the profile.

Counterpart of ``prysm_tpu/x/raytracing/sagjets.py``: the same jets in
elementwise torch.  Inputs (x, y, s) are tensors; parameters are Python
numbers or tensors (a tensor parameter keeps its graph).
"""
import torch


def unit_normal(gx, gy):
    """Unit surface normal of z = f(x, y) from its gradient.

    The implicit surface F = z - f has grad F = (-gx, -gy, 1); one rsqrt
    normalizes it.  Last axis of the result is xyz.
    """
    inv = torch.rsqrt(gx * gx + gy * gy + 1.0)
    return torch.stack([-gx * inv, -gy * inv, inv], dim=-1)


def conic_jet(c, k, s):
    """(z, dz/ds) of a conicoid of curvature c, conic constant k, s = rho^2.

    z = c s / (1 + q) with q = sqrt(1 - (1+k) c^2 s); differentiating and
    simplifying with 1 - q^2 = (1+k) c^2 s collapses dz/ds to c / (2 q),
    expressed through rsqrt so the normal-only callers (the closed-form
    intersectors, which drop z) need a single rsqrt and no divide.
    """
    arg = 1.0 - (1.0 + k) * (c * c) * s
    z = c * s / (1.0 + torch.sqrt(arg))
    return z, 0.5 * c * torch.rsqrt(arg)


def power_series_jet(coefs, s):
    """(A, dA/ds) of the even-asphere departure A(s) = sum_i a_i s^(i+2).

    One Horner recurrence carries the polynomial value and its derivative
    together (dual-number Horner): for B(s) = sum a_i s^i,
    ``db <- db*s + b; b <- b*s + a``; then A = s^2 B and
    A' = s (2 B + s B').
    """
    b = db = torch.zeros_like(s)
    for a in reversed(tuple(coefs)):
        db = db * s + b
        b = b * s + a
    return b * s * s, s * (2.0 * b + s * db)


def asphere_jet(c, k, coefs, s):
    """(z, dz/ds) of a conicoid plus even-power departure series."""
    z, d = conic_jet(c, k, s)
    if len(coefs):
        dep, ddep = power_series_jet(coefs, s)
        z = z + dep
        d = d + ddep
    return z, d


def radial_field(x, y, z, dz_ds):
    """(z, gx, gy) of a radial jet evaluated at cartesian (x, y)."""
    g = 2.0 * dz_ds
    return z, g * x, g * y


def zero_field(x, y):
    """(z, gx, gy) = (0, 0, 0) on the broadcast grid of (x, y) — a plane."""
    z = torch.zeros(torch.broadcast_shapes(x.shape, y.shape),
                    dtype=torch.result_type(x, y), device=x.device)
    return z, z, z


def biconic_field(cx, cy, kx, ky, x, y):
    """(z, gx, gy) of a biconic via per-axis jets.

    z = N / (1 + q), N = cx x^2 + cy y^2,
    q = sqrt(1 - (1+kx) cx^2 x^2 - (1+ky) cy^2 y^2).
    The partial of z wrt sx = x^2 at fixed y^2 is
    cx / (1+q) + N (1+kx) cx^2 / (2 q (1+q)^2), symmetrically in y; the
    cartesian gradient is 2x / 2y times those s-partials.
    """
    sx = x * x
    sy = y * y
    ex = (1.0 + kx) * (cx * cx)
    ey = (1.0 + ky) * (cy * cy)
    q = torch.sqrt(1.0 - ex * sx - ey * sy)
    opq = 1.0 + q
    N = cx * sx + cy * sy
    w = N / (2.0 * q * opq * opq)
    return N / opq, 2.0 * x * (cx / opq + w * ex), 2.0 * y * (cy / opq + w * ey)


def toroid_field(cx, cy, ky, coefs_y, x, y):
    """(z, gx, gy) of a toroid: circular x profile + even-asphere y profile.

    The two 1D jets are independent; their values add and each supplies
    one gradient component.
    """
    zx, dx = conic_jet(cx, 0.0, x * x)
    zy, dy = asphere_jet(cy, ky, coefs_y, y * y)
    return zx + zy, 2.0 * x * dx, 2.0 * y * dy


def is_concrete_zero(v):
    """True only for a host scalar (Python or numpy number) equal to zero.

    A tensor is never static: a tensor curvature of 0 keeps the general
    conic code path, so its gradient survives and no device value is read
    back to decide a branch.
    """
    if torch.is_tensor(v):
        return False
    try:
        return bool(v == 0.0)
    except Exception:
        return False


def add_conic_base(c, k, x, y, z, gx, gy):
    """Add a conic base field to a polynomial departure field.

    A concretely-zero curvature skips the base entirely (the common
    plano-freeform case traces no dead sqrt).
    """
    if is_concrete_zero(c):
        return z, gx, gy
    zc, dc = conic_jet(c, k, x * x + y * y)
    g = 2.0 * dc
    return z + zc, gx + g * x, gy + g * y


def conic_scaled_departure(c, k, xs, ys, P, Px, Py):
    """Base conic plus the Forbes normal-departure-scaled polynomial.

    The Q2d freeform convention (Forbes, Opt. Express 20(3):2483, Eq.
    5.1/5.2) measures the polynomial departure along the base conic's
    NORMAL, so the sag contribution is sigma^-1 P with
    sigma = n_z(base conic), i.e. sigma^-1 = sqrt(1 + |grad z_base|^2).
    In jet form with w = c/q (so grad z_base = w (xs, ys)):

        sigma^-1           = sqrt(1 + w^2 s),           s = xs^2 + ys^2
        d(sigma^-1)/ds     = (w^2 + 2 w w' s) / (2 sigma^-1),
        w'                 = (1+k) c^3 / (2 q^3)

    Returns (z, gx, gy) of conic + sigma^-1 P with the product rule
    applied against the departure's cartesian gradient (Px, Py).
    """
    s = xs * xs + ys * ys
    q = torch.sqrt(1.0 - (1.0 + k) * (c * c) * s)
    w = c / q
    si = torch.sqrt(1.0 + (w * w) * s)
    wp = (1.0 + k) * (c * c * c) / (2.0 * q * q * q)
    dsi_ds = (w * w + 2.0 * w * wp * s) / (2.0 * si)
    z = (c * s) / (1.0 + q) + si * P
    gx = w * xs + si * Px + P * (2.0 * xs * dsi_ds)
    gy = w * ys + si * Py + P * (2.0 * ys * dsi_ds)
    return z, gx, gy


def polar_departure_field(x, y, scale, value, d_du, d_dt):
    """(z, gx, gy) in cartesian from a polar-evaluated departure.

    value/d_du/d_dt are f, df/du, df/dtheta at u = rho/scale,
    theta = atan2(y, x); the chain rule runs through (rho, theta) with the
    on-axis point masked to zero where the polar frame degenerates.
    """
    r = torch.hypot(x, y)
    r_inv = torch.where(r == 0.0, 0.0, 1.0 / torch.where(r == 0.0, 1.0, r))
    cos_t = x * r_inv
    sin_t = y * r_inv
    du = d_du / scale
    gx = du * cos_t - d_dt * sin_t * r_inv
    gy = du * sin_t + d_dt * cos_t * r_inv
    return value, gx, gy
