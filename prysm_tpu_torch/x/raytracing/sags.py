"""Sag functions and analytic surface normals for raytracing.

Counterpart of ``prysm_tpu/x/raytracing/sags.py``: the same function
names with the same call signatures, as thin adapters over
:mod:`sagjets` (every profile evaluated as ``(value, d/d(rho^2))`` in a
single pass), so there is no duplicated derivative algebra here.  The
``phi`` keyword several signatures expose is accepted for compatibility
but recomputed internally.  The JAX package's ``jax.vmap`` /
``jax.value_and_grad`` / ``jax.jvp`` become ``torch.func.vmap`` /
``grad_and_value`` / ``jvp``.
"""
import torch
from torch import func as tfunc

from ...conf import config, to_tensor
from ...polynomials import compute_z_Q2d, compute_z_zprime_Q2d

from .sagjets import (
    add_conic_base,
    asphere_jet,
    conic_jet,
    conic_scaled_departure,
    is_concrete_zero,
    polar_departure_field,
    unit_normal,
    zero_field,
)

# back-compat alias; intersections and surfaces share the same notion of
# "concretely zero curvature skips the conic entirely"
_statically_zero = is_concrete_zero


def _float_tensor(v, like=None):
    """v as a floating tensor: a tensor keeps its dtype (an integer one takes
    config.precision); host values take config.precision on config.device,
    or like's dtype and device."""
    if torch.is_tensor(v):
        return v if v.is_floating_point() else v.to(config.precision)
    if like is not None:
        return torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return to_tensor(v).to(config.precision)


def fd_step(finite_difference_step, *arrs):
    """Default finite-difference step from the dtype of the arrays."""
    if finite_difference_step is not None:
        return finite_difference_step
    dtype = torch.result_type(*arrs) if len(arrs) > 1 else arrs[0].dtype
    return float(torch.finfo(dtype).eps) ** (1 / 3)


def product_rule(u, v, du, dv):
    """d(uv) = u dv + v du."""
    return u * dv + v * du


def gradient_to_unit_normal(Fx, Fy):
    """Unit surface normal from sag partial derivatives (dz/dx, dz/dy)."""
    return unit_normal(Fx, Fy)


def plane_sag_and_normal(x, y):
    """Sag (0) and normal (+z) of a plane."""
    z, _, _ = zero_field(x, y)
    n = torch.zeros((*z.shape, 3), dtype=z.dtype, device=z.device)
    n[..., 2] = 1.0
    return z, n


def phi_conic(c, k, rhosq):
    """sqrt(1 - (1+k) c^2 rho^2), the conic sag denominator root."""
    return torch.sqrt(1.0 - (1.0 + k) * (c * c) * rhosq)


def sphere_sag(c, rhosq, phi=None):
    """Sag of a sphere of curvature c."""
    return conic_jet(c, 0.0, rhosq)[0]


def sphere_sag_der(c, rho, phi=None):
    """d(sag)/d(rho) for a sphere."""
    return 2.0 * rho * conic_jet(c, 0.0, rho * rho)[1]


def conic_sag(c, kappa, rhosq, phi=None):
    """Sag of a conicoid of curvature c and conic constant kappa."""
    return conic_jet(c, kappa, rhosq)[0]


def conic_sag_der(c, kappa, rho, phi=None):
    """d(sag)/d(rho) for a conicoid."""
    return 2.0 * rho * conic_jet(c, kappa, rho * rho)[1]


def conic_sag_der_xy(c, kappa, x, y, phi=None):
    """(dz/dx, dz/dy) for a conicoid."""
    _, d = conic_jet(c, kappa, x * x + y * y)
    g = 2.0 * d
    return g * x, g * y


def conic_sag_and_normal(c, kappa, X, Y):
    """Sag and unit normal of a conicoid at (X, Y)."""
    z, d = conic_jet(c, kappa, X * X + Y * Y)
    g = 2.0 * d
    return z, unit_normal(g * X, g * Y)


def even_asphere_sag(c, kappa, coefs, rsq):
    """Conic base + even-power polynomial: sum coefs[i] r^(4+2i) over r^2."""
    return asphere_jet(c, kappa, coefs, rsq)[0]


def even_asphere_sag_der_xy(c, kappa, coefs, x, y, phi=None):
    """(dz/dx, dz/dy) for an even asphere."""
    _, d = asphere_jet(c, kappa, coefs, x * x + y * y)
    g = 2.0 * d
    return g * x, g * y


def _add_conic_base_sag(c, kappa, x, y, z_p):
    """Add the conic base to a polynomial departure sag."""
    if is_concrete_zero(c):
        return z_p
    return z_p + conic_jet(c, kappa, x * x + y * y)[0]


def _add_conic_base_derivatives(c, kappa, x, y, z_p, ddx_p, ddy_p):
    """Add conic base sag + derivatives to polynomial departures."""
    return add_conic_base(c, kappa, x, y, z_p, ddx_p, ddy_p)


def Q2d_sag(cm0, ams, bms, x, y, normalization_radius, c, k, dx=0, dy=0):
    """Sag of a 2D-Q freeform on a conic base.

    The polynomial departure rides the base conic's NORMAL (Forbes
    convention), so it enters scaled by sigma^-1 = sqrt(1 + |grad
    z_base|^2); a flat base (c concretely 0) has sigma = 1.
    """
    xs = x + dx
    ys = y + dy
    u = torch.hypot(xs, ys) / normalization_radius
    t = torch.atan2(ys, xs)
    z_p = compute_z_Q2d(cm0, ams, bms, u, t)
    if is_concrete_zero(c):
        return z_p
    s = xs * xs + ys * ys
    zc, dc = conic_jet(c, k, s)
    w = 2.0 * dc
    sigma_inv = torch.sqrt(1.0 + (w * w) * s)
    return zc + sigma_inv * z_p


def Q2d_and_der(cm0, ams, bms, x, y, normalization_radius, c, k, dx=0, dy=0):
    """Sag and cartesian derivatives of a 2D-Q freeform on a conic base.

    Normal-departure (sigma^-1) convention as in Q2d_sag, with the
    product rule applied through the conic's sigma^-1 jet.
    """
    xs = x + dx
    ys = y + dy
    R = normalization_radius
    u = torch.hypot(xs, ys) / R
    t = torch.atan2(ys, xs)
    z_p, d_du, d_dt = compute_z_zprime_Q2d(cm0, ams, bms, u, t)
    z_p, gx_p, gy_p = polar_departure_field(xs, ys, R, z_p, d_du, d_dt)
    if is_concrete_zero(c):
        return z_p, gx_p, gy_p
    return conic_scaled_departure(c, k, xs, ys, z_p, gx_p, gy_p)


def der_direction_cosine_conic(c, k, rho, rhosq=None, phi=None):
    """d/drho of (1 / phi), phi = sqrt(1 - (1+k) c^2 rho^2).

    The product-rule term for Q-type aspheres whose polynomial part is
    divided by the conic denominator root.
    """
    if rhosq is None:
        rhosq = rho * rho
    if phi is None:
        phi = phi_conic(c, k, rhosq)
    return (1.0 + k) * (c * c) * rho / (phi * phi * phi)


def autodiff_sag_and_normal(sag):
    """Build sag_and_normal from a scalar sag(x, y) via torch.func.

    The returned callable evaluates the sag and its gradient in one
    vmapped grad_and_value pass; this is the generic path for
    CallableShape.
    """
    gav = tfunc.vmap(tfunc.grad_and_value(sag, argnums=(0, 1)))

    def sag_and_normal(x, y):
        shape = torch.broadcast_shapes(x.shape, y.shape)
        xf = torch.broadcast_to(x, shape).reshape(-1)
        yf = torch.broadcast_to(y, shape).reshape(-1)
        (Fx, Fy), z = gav(xf, yf)
        n = unit_normal(Fx, Fy)
        return z.reshape(shape), n.reshape((*shape, 3))

    return sag_and_normal


def conic_sag_hessian(c, kappa, x, y, phi=None):
    """Cartesian second derivatives (sag_xx, sag_xy, sag_yy) of a conic.

    Forward-mode derivatives of the jet gradient: smooth in (x, y) with
    no 1/r singularity; reduces to the sphere Hessian at kappa = 0.
    """
    x = _float_tensor(x)
    y = _float_tensor(y, like=x)

    def grad(xv, yv):
        return conic_sag_der_xy(c, kappa, xv, yv)

    ones = torch.ones_like(x)
    zeros = torch.zeros_like(x)
    _, (sag_xx, sag_xy) = tfunc.jvp(grad, (x, y), (ones, zeros))
    _, (_, sag_yy) = tfunc.jvp(grad, (x, y), (zeros, ones))
    return sag_xx, sag_xy, sag_yy


def conic_sag_param_partials(c, kappa, x, y, name, phi=None):
    """(sag_t, gx_t, gy_t): partials of sag and gradient wrt 'c' or 'k'.

    The explicit parameter channel of the differential ray trace's
    intersection tangent, at fixed (x, y).
    """
    if name not in ('c', 'k'):
        raise ValueError(f"name must be 'c' or 'k', got {name!r}")
    x = _float_tensor(x)
    y = _float_tensor(y, like=x)

    def f(cv, kv):
        z, d = conic_jet(cv, kv, x * x + y * y)
        g = 2.0 * d
        return z, g * x, g * y

    tangent = (1.0, 0.0) if name == 'c' else (0.0, 1.0)
    _, (sag_t, gx_t, gy_t) = tfunc.jvp(
        f, tuple(_float_tensor(float(v), like=x) for v in (c, kappa)),
        tuple(_float_tensor(t, like=x) for t in tangent))
    return sag_t, gx_t, gy_t


def zernike_irregularity_partials(n, m, x, y, normalization_radius,
                                  norm=True):
    """Amplitude partials of one Zernike surface-irregularity term.

    For delta z = a * Z_n^m(x / R, y / R):
    d(sag)/da = Z_n^m, d(dz/dx)/da = (1/R) dZ/dx, d(dz/dy)/da = (1/R) dZ/dy.
    With norm=True unit amplitude is unit RMS over the disk of radius R.
    """
    from ...polynomials.zernike import zernike_sum, zernike_nm_der_xy

    R = float(normalization_radius)
    xn = _float_tensor(x) / R
    yn = _float_tensor(y, like=xn) / R
    sag = zernike_sum([1.0], [(n, m)], xn, yn, norm=norm)
    dzdx, dzdy = zernike_nm_der_xy(n, m, xn, yn, norm=norm)
    return sag, dzdx / R, dzdy / R
