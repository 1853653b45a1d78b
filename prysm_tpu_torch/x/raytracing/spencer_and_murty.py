"""Spencer & Murty's general ray-trace algorithm on batched ray bundles.

Counterpart of ``prysm_tpu/x/raytracing/spencer_and_murty.py``.  The
kernel is a function of batched (N, 3) ray bundles, written as plain
elementwise torch:

* the Newton surface intersection freezes each ray once it converges and
  runs under ``torch.no_grad`` on detached inputs, then takes one tracked
  polish step, so autograd sees a single Newton step whose derivative is
  the implicit one (-dF/dinput / dF/ds at the root);
* the loop leaves as soon as every ray is frozen (checked every few
  iterations), which gives the same result as running all ``maxiter``
  iterations: a frozen ray never moves again;
* dead rays are masked with ``torch.where`` (NaN fill), never in-place
  writes, so the whole trace differentiates end to end with autograd.

Status encoding is that of the JAX package: complex, the surface index
in the real part and the failure family in the imaginary part.

Tensors follow the device of the rays.  A ray bundle given as numpy goes
to ``config.device``; P and S take ``config.precision`` whatever dtype
comes in.  Host planners read results back through :func:`to_host`.
"""
import numpy as onp
import torch

from ...conf import config, to_tensor
from ...mathops import row_dot

SURFACE_INTERSECTION_DEFAULT_MAXITER = 100
DEFAULT_TOL_SAG = 1e-12

# the Newton loop asks whether every ray is frozen once per this many
# iterations: each ask is a device-to-host read
NEWTON_CHECK_EVERY = 4

STYPE_REFLECT = -1
STYPE_REFRACT = -2
STYPE_EVAL = -3
STYPE_OBJ = -4
STYPE_IMG = -5


_MEASUREMENT_STYPES = frozenset((STYPE_EVAL, STYPE_OBJ, STYPE_IMG))


def _is_measurement_surf(typ):
    """True for a non-bending measurement surface (EVAL, OBJECT, or IMAGE)."""
    return typ in _MEASUREMENT_STYPES


# status-code values and label strings follow the JAX package's encoding;
# positive codes are numerical failures (Newton non-convergence, aperture
# clip), negative are geometric (no intersection, TIR, evanescent)
STATUS_OK = 0
STATUS_NEWTON = 1
STATUS_CLIP = 2
STATUS_MISS = -1
STATUS_TIR = -2
STATUS_EVANESCENT = -3

_STATUS_LABELS = dict(zip(
    (STATUS_OK, STATUS_NEWTON, STATUS_CLIP,
     STATUS_MISS, STATUS_TIR, STATUS_EVANESCENT),
    ('OK', 'NEWTON', 'CLIPPED', 'MISS', 'TIR', 'EVANESCENT'),
))


def to_host(a):
    """A tensor as a detached host numpy array; anything else through numpy."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return onp.asarray(a)


def _like(v, ref):
    """A host pose, scalar or array as a tensor in ref's dtype, on ref's device.

    A tensor keeps its graph and device; only its dtype follows ref.
    """
    if torch.is_tensor(v):
        return v.to(ref.dtype)
    return torch.as_tensor(onp.asarray(v), dtype=ref.dtype, device=ref.device)


class RayTraceResult:
    """Structured return type for raytrace: P, S, OPL, status histories."""

    __slots__ = ('P', 'S', 'OPL', 'status', 'intermediates')

    def __init__(self, P, S, OPL, status, intermediates=None):
        self.P = P
        self.S = S
        self.OPL = OPL
        self.status = status
        self.intermediates = intermediates

    @property
    def status_record(self):
        """Decoded (surface, code) status view, read back to the host."""
        return RayStatus.from_encoded(to_host(self.status))

    def __repr__(self):
        """Compact summary."""
        return (f'RayTraceResult(N_rays={self.status.shape[0]}, '
                f'N_surfaces={self.P.shape[0] - 1}, '
                f'valid={int(valid_mask(self.status).sum())})')


class RayStatus:
    """Host-side (surface, code) view of the complex status array.

    A plain record of two int arrays: both components of the packed
    status, materialized once on decode.
    """

    def __init__(self, surface, code):
        self.surface = onp.asarray(surface)
        self.code = onp.asarray(code)

    @classmethod
    def from_encoded(cls, status):
        """Split a packed complex status array into int component views."""
        z = to_host(status)
        return cls(z.real.astype(int), z.imag.astype(int))

    @property
    def encoded(self):
        """Pack back into the compact complex representation."""
        return self.surface + 1j * self.code

    @property
    def text(self):
        """Human-readable status strings."""
        return decode_status(self.encoded)


def decode_status(status):
    """Decode the compact complex status encoding to strings.

    Scalar in -> ``str`` out; array in -> object ndarray of the same
    shape.
    """
    status = to_host(status)
    surf = onp.atleast_1d(onp.real(status)).astype(int).ravel()
    code = onp.atleast_1d(onp.imag(status)).astype(int).ravel()
    out = onp.empty(surf.shape, dtype=object)
    for i in range(surf.size):
        c = int(code[i])
        name = _STATUS_LABELS.get(c, f'UNKNOWN({c})')
        out[i] = name if c == STATUS_OK else f'{name} at surface {int(surf[i])}'
    if onp.ndim(status) == 0:
        return out[0]
    return out.reshape(onp.shape(status))


def _finite_ray_mask(P):
    if torch.is_tensor(P):
        return torch.isfinite(P).all(dim=-1)
    return onp.isfinite(P).all(axis=-1)


def valid_mask(status, P=None):
    """Reduce status (and optional positions) to a bool valid-ray mask.

    Tensors in give a tensor out; a host (numpy) status or P gives numpy.
    """
    if status is None:
        if P is None:
            return None
        return _finite_ray_mask(P)
    if torch.is_tensor(status) and (P is None or torch.is_tensor(P)):
        imag = status.imag if status.is_complex() else torch.zeros_like(status)
        valid = imag == STATUS_OK
    else:
        valid = onp.imag(to_host(status)) == STATUS_OK
        if P is not None:
            P = to_host(P)
    if P is not None:
        valid = valid & _finite_ray_mask(P)
    return valid


def resolve_tol_sag(tol_sag, dtype):
    """Dtype-aware Newton convergence tolerance."""
    if tol_sag is None:
        return max(DEFAULT_TOL_SAG, float(torch.finfo(dtype).eps) * 100.0)
    return tol_sag


def newton_raphson_solve_s(P1, S, sag_and_normal, s1=0.0, tol_sag=None,
                           maxiter=SURFACE_INTERSECTION_DEFAULT_MAXITER):
    """Newton-Raphson ray-surface intersection, batched and masked.

    P1: (N, 3) positions on the vertex tangent plane; S: (N, 3) direction
    cosines; sag_and_normal(x, y) -> (sag, n_hat).  Returns (Q, n_hat,
    valid).  Each ray freezes once converged (or once its step is not
    finite); the loop runs at most ``maxiter`` iterations and leaves early
    when every ray is frozen, which changes no result.

    Gradients use the implicit function theorem rather than the loop: the
    iteration runs under ``torch.no_grad`` on detached inputs and one
    tracked Newton polish step reattaches the solution to its inputs.  At
    a root F(s*) = 0 the polish step's derivative is exactly the implicit
    derivative -dF/dinput / dF/ds.
    """
    dtype = P1.dtype
    tol = resolve_tol_sag(tol_sag, dtype)
    sj0 = torch.broadcast_to(_like(s1, P1), P1.shape[:-1])
    finite = (torch.isfinite(P1).all(dim=-1) & torch.isfinite(S).all(dim=-1)
              & torch.isfinite(sj0))

    with torch.no_grad():
        P1_d, S_d = P1.detach(), S.detach()
        sj = sj0.detach().clone()
        done = torch.zeros_like(finite)
        for it in range(1, int(maxiter) + 1):
            Pj = P1_d + sj[..., None] * S_d
            sagj, n_hat = sag_and_normal(Pj[..., 0], Pj[..., 1])
            Fj = Pj[..., 2] - sagj
            done = done | (torch.abs(Fj) < tol)
            Fpj = row_dot(S_d, n_hat) / n_hat[..., 2]
            step = Fj / Fpj
            frozen = done | ~torch.isfinite(step)
            sj = torch.where(frozen, sj, sj - step)
            if it % NEWTON_CHECK_EVERY == 0 and bool(frozen.all()):
                break
    converged = done
    # differentiable polish step: value unchanged at a root, gradient exact
    Pj = P1 + sj[..., None] * S
    sagj, n_hat = sag_and_normal(Pj[..., 0], Pj[..., 1])
    Fj = Pj[..., 2] - sagj
    converged = (converged | (torch.abs(Fj) < tol)) & finite
    Fpj = row_dot(S, n_hat) / n_hat[..., 2]
    # grazing lanes (Fpj ~ 0) would put inf into the quotient and NaN into
    # the backward pass through the where; substitute a benign denominator
    graze = ~(torch.abs(Fpj) > 1e-300)
    step = Fj / torch.where(graze, 1.0, Fpj)
    sj = torch.where(graze | ~torch.isfinite(step), sj, sj - step)
    # final evaluation at the polished solution for outputs
    Pj = P1 + sj[..., None] * S
    sagj, n_hat = sag_and_normal(Pj[..., 0], Pj[..., 1])
    nan = float('nan')
    Q = torch.where(converged[..., None], Pj, nan)
    n_out = torch.where(converged[..., None], n_hat, nan)
    return Q, n_out, converged


def _atleast_2d(a):
    return a if a.ndim >= 2 else a.reshape(1, -1)


def intersect(P0, S, sag_and_normal, s1=0, tol_sag=None,
              maxiter=SURFACE_INTERSECTION_DEFAULT_MAXITER):
    """Find ray-surface intersections from arbitrary local-frame origins."""
    P0 = _atleast_2d(P0)
    S = _atleast_2d(S)
    Z0 = P0[..., 2]
    m = S[..., 2]
    s0 = -Z0 / m
    P1 = P0 + s0[..., None] * S
    return newton_raphson_solve_s(P1, S, sag_and_normal, s1,
                                  tol_sag=tol_sag, maxiter=maxiter)


def transform_to_global_coords(XYZ, P, S, R=None):
    """Local -> global: rotate by R^T (applied as right-multiply), add P.

    A host (numpy) P or R is converted to XYZ's dtype and device.
    """
    if R is not None:
        R = _like(R, XYZ)
        XYZ = torch.matmul(XYZ, R)
        S = torch.matmul(S, R)
    return XYZ + _like(P, XYZ), S


def transform_to_local_coords(XYZ, P, S, R=None):
    """Global -> local: subtract P, rotate by R.

    A host (numpy) P or R is converted to XYZ's dtype and device.
    """
    XYZ2 = XYZ - _like(P, XYZ)
    if R is not None:
        Rt = torch.swapaxes(_like(R, XYZ), -1, -2)
        XYZ2 = torch.matmul(XYZ2, Rt)
        S = torch.matmul(S, Rt)
    return XYZ2, S


def refract(n, nprime, S, n_hat):
    """Snell's law for exitant direction cosines (NaN where TIR)."""
    S = _atleast_2d(S)
    n_hat = _atleast_2d(n_hat)
    out, tir = refract_with_tir(n, nprime, S, n_hat)
    return torch.where(tir[..., None], float('nan'), out)


def refract_with_tir(n, nprime, S, n_hat):
    """(Sprime, tir_mask) with finite values on TIR lanes.

    TIR is reported through the mask, NOT by sqrt(negative): the clamped
    sqrt keeps the backward pass finite on TIR lanes (a zero cotangent
    times the NaN derivative of sqrt(<0) would otherwise poison every
    gradient in the bundle).
    """
    S = _atleast_2d(S)
    n_hat = _atleast_2d(n_hat)
    mu = n / nprime
    cosI = row_dot(n_hat, S)
    sinT_sq = mu * mu * (1.0 - cosI * cosI)
    tir = sinT_sq >= 1.0
    cosT = torch.sqrt(torch.where(tir, 1.0, 1.0 - sinT_sq))
    factor = torch.sign(cosI) * cosT - mu * cosI
    return mu * S + factor[..., None] * n_hat, tir


def reflect(S, n_hat):
    """Reflect rays off a surface."""
    S = _atleast_2d(S)
    n_hat = _atleast_2d(n_hat)
    cosI = row_dot(S, n_hat)
    return S - 2.0 * cosI[..., None] * n_hat


def diffract(S_specular, n_hat, gx, gy, n_post):
    """Tangential momentum kick of a grating OPL gradient.

    (gx, gy) is the in-plane gradient of the grating OPL (order and
    period folded in).  Returns (S_out, valid); evanescent orders keep
    the specular direction and are masked invalid.
    """
    G = torch.stack([gx, gy, torch.zeros_like(gx)], dim=-1)
    G_dot_n = (G * n_hat).sum(-1, keepdim=True)
    G_tan = G - G_dot_n * n_hat
    s_dot_n = (S_specular * n_hat).sum(-1, keepdim=True)
    s_specular_tan = S_specular - s_dot_n * n_hat
    s_diff_tan = s_specular_tan + G_tan / n_post
    tan_sq = (s_diff_tan * s_diff_tan).sum(-1)
    valid = tan_sq <= 1.0
    normal_mag = torch.sqrt(torch.where(valid, 1.0 - tan_sq, 0.0))
    sign = torch.sign(s_dot_n[..., 0])
    S_diff = s_diff_tan + (sign * normal_mag)[..., None] * n_hat
    S_diff = torch.where(valid[..., None], S_diff, S_specular)
    return S_diff, valid


def eic_closing(P, S, C, kappa):
    """Determinate EIC closing segment to the reference sphere.

    s~ = -b - kappa m / (1 + sqrt(max(1 + kappa^2 m, 0))) with
    r = P - C, b = S.r, m = b^2 - r.r; spans finite pupils and the
    telecentric kappa -> 0 limit without cancellation.  Returns (s, disc):
    disc is the unclamped discriminant, so host callers can check that
    the clamp was not exercised.  A host C or kappa array is converted to
    P's dtype and device.
    """
    r = P - _like(C, P)
    b = torch.sum(S * r, dim=-1)
    m = b * b - torch.sum(r * r, dim=-1)
    if not isinstance(kappa, (int, float)):
        kappa = _like(kappa, P)
    disc = 1.0 + kappa * kappa * m
    s = -b - kappa * m / (1.0 + torch.sqrt(torch.clamp(disc, min=0.0)))
    return s, disc


def _index_value(n):
    """A material index as a Python float, or a tensor unchanged."""
    return n if torch.is_tensor(n) else float(onp.asarray(n))


def _launch_medium_index(surfaces, wvl):
    """Index of the medium the bundle launches in (object-space material)."""
    first = surfaces[0] if len(surfaces) else None
    mat = getattr(first, 'material', None)
    if mat is not None and _is_measurement_surf(getattr(first, 'typ', None)):
        return _index_value(mat.n(wvl))
    return 1.0


def raytrace(surfaces, P, S, wvl, tol_sag=None, keep_intermediates=False):
    """Trace a batched ray bundle through a sequence of surfaces.

    surfaces: compiled Surface sequence; P, S: (3,) or (N, 3) starting
    positions/directions (tensors, or host arrays that go to
    ``config.device``); wvl: microns.  Returns a RayTraceResult with
    (n_surf+1, N, 3) position/direction histories, per-segment OPL, and
    the complex status encoding.  Differentiable with autograd.
    """
    if hasattr(surfaces, 'to_surfaces'):
        raise TypeError('raytrace requires a compiled surface sequence; call '
                        'system.trace(...) for an OpticalSystem or pass '
                        'lens.to_surfaces() explicitly')
    try:
        len(surfaces)
    except TypeError as e:
        raise TypeError('raytrace requires a sized compiled surface sequence') from e

    # config.precision wins over the input dtype, as in the JAX package
    dtype = config.precision
    P = to_tensor(P).to(dtype)
    S = to_tensor(S, device=P.device).to(device=P.device, dtype=dtype)
    squeeze_batch = (P.ndim == 1)
    if squeeze_batch:
        P = P[None, :]
        S = S[None, :]
    n_rays = P.shape[0]

    P_hist = [P]
    S_hist = [S]
    OPL_hist = [torch.zeros(P.shape[:-1], dtype=P.dtype, device=P.device)]
    status_surf = torch.zeros(n_rays, dtype=torch.int32, device=P.device)
    status_code = torch.zeros(n_rays, dtype=torch.int32, device=P.device)

    Pj, Sj = P, S
    nj = _launch_medium_index(surfaces, wvl)
    intermediates = [] if keep_intermediates else None
    nan = float('nan')
    for j, surf in enumerate(surfaces):
        surf_idx = j + 1
        step = surf.interact(Pj, Sj, nj, wvl, tol_sag=tol_sag,
                             first_segment=(j == 0))

        active = status_code == STATUS_OK
        failed = active & (step.code != STATUS_OK)
        status_surf = torch.where(failed, surf_idx, status_surf)
        status_code = torch.where(failed, step.code, status_code)
        active = active & ~failed

        dead = ~active
        Pjp1 = torch.where(dead[..., None], nan, step.P)
        Sjp1 = torch.where(dead[..., None], nan, step.S)
        opl = torch.where(dead, nan, step.opl)
        if surf.typ == STYPE_REFRACT:
            nj = step.n_post
        P_hist.append(Pjp1)
        S_hist.append(Sjp1)
        OPL_hist.append(opl)
        Pj, Sj = Pjp1, Sjp1
        if intermediates is not None:
            intermediates.append(step)

    fully_valid = status_code == STATUS_OK
    status_surf = torch.where(fully_valid, len(surfaces), status_surf)
    status = torch.complex(status_surf.to(dtype), status_code.to(dtype))

    P_out = torch.stack(P_hist)
    S_out = torch.stack(S_hist)
    OPL_out = torch.stack(OPL_hist)
    if squeeze_batch:
        P_out = P_out.squeeze(1)
        S_out = S_out.squeeze(1)
        OPL_out = OPL_out.squeeze(1)
    return RayTraceResult(P_out, S_out, OPL_out, status, intermediates)
