"""Ray/surface intersection helpers for sequential raytracing.

Counterpart of ``prysm_tpu/x/raytracing/intersections.py``: analytic
plane/sphere/conic intersections (Welford's rationalized quadratic), the
conic-seeded Newton path for polynomial shapes, and the departure-band
first-root machinery: the monotonicity certificate plus the
Lipschitz-march rescue.  Everything is branch-free masked torch, so
intersections differentiate with autograd; the march keeps every lane
resident and freezes lanes on convergence, in a loop under
``torch.no_grad`` that leaves once no lane is live, and the
value-dependent "any rays need rescue?" gates are masks.
"""
import torch

from ...mathops import row_dot
from .spencer_and_murty import (
    DEFAULT_TOL_SAG,  # NOQA - re-export
    SURFACE_INTERSECTION_DEFAULT_MAXITER,
    intersect as newton_intersect,
    newton_raphson_solve_s,
    resolve_tol_sag,  # NOQA - re-export
    _atleast_2d,
    _like,
)
from .sagjets import is_concrete_zero
from .sags import conic_sag_and_normal

MARCH_RADIUS_MARGIN = 1.1
# floor on |cos(incidence)| used to widen the acceptance band at grazing
# incidence
COS_INCIDENCE_FLOOR = 1e-3
# margin on the monotonicity certificate
CERTIFICATE_MARGIN = 1e-3
# cap on Lipschitz-march steps before a ray is rejected
LIPSCHITZ_MARCH_MAXSTEPS = 256
# switch from Lipschitz descent to local Newton near the first root
NEWTON_SWITCH_FRACTION = 1e-2


# the check that every lane of the march has stopped is made once per this
# many steps: each check is a device-to-host read
MARCH_CHECK_EVERY = 4


def _statically_zero(c):
    """True only when c is a host (Python or numpy) scalar equal to zero.

    A tensor is never static: a tensor curvature of 0 keeps the analytic
    conic path, and with it the gradient with respect to c, instead of
    taking the plane branch (which would also read the value back from
    the device to decide).
    """
    return is_concrete_zero(c)


def _unit_z(Q):
    """(..., 3) normals along +z, shaped like Q."""
    n = torch.zeros_like(Q)
    n[..., 2] = 1.0
    return n


def ray_plane_intersect(P, S):
    """Intersect rays P + t S with the local plane Z = 0 -> (Q, n, valid)."""
    P = _atleast_2d(P)
    S = _atleast_2d(S)
    Sz = S[..., 2]
    t = -P[..., 2] / Sz
    Q = P + t[..., None] * S
    return Q, _unit_z(Q.detach()), (Sz != 0)


def _conic_quadratic_coeffs(c, kappa, P1, S, dx, dy):
    """(A, B, C) of the conic quadratic in Welford's rationalized form.

    Shared by the vertex-side root and the closest-approach rescue band
    for seed-miss rays.  Assembled component-wise, as in the JAX package.
    """
    Sz = S[..., 2]
    px = P1[..., 0] + dx
    py = P1[..., 1] + dy
    A_ = 1.0 + kappa * Sz * Sz
    B_ = px * S[..., 0] + py * S[..., 1] - Sz / c
    C_ = px * px + py * py
    return A_, B_, C_


def _conic_quadratic_t(c, kappa, P1, S, dx, dy):
    """Vertex-side root of the conic quadratic (Welford's form).

    A tensor curvature may be 0 (it is never static), where Welford's B
    holds -Sz / c.  For a tensor c the quadratic is multiplied through by
    c: t = C c / (z_dir sqrt((B c)^2 - A C c^2) - B c), the same root for
    c != 0, and at c = 0 the plane's root t = 0 with a finite d/dc.  A
    host c keeps the JAX package's arithmetic (c = 0 never gets here).
    """
    Sz = S[..., 2]
    z_dir = torch.where(Sz < 0, -1.0, 1.0)
    if torch.is_tensor(c):
        c = c.to(P1.dtype)
        px = P1[..., 0] + dx
        py = P1[..., 1] + dy
        A_ = 1.0 + kappa * Sz * Sz
        Bc = c * (px * S[..., 0] + py * S[..., 1]) - Sz
        AC = A_ * (px * px + py * py)
        disc = Bc * Bc - AC * (c * c)
        disc_nonneg = disc >= 0
        denom = z_dir * torch.sqrt(torch.where(disc_nonneg, disc, 0.0)) - Bc
        vertex_tangent = denom == 0
        t = (px * px + py * py) * c / torch.where(vertex_tangent, 1.0, denom)
        return torch.where(vertex_tangent, 0.0, t), disc_nonneg
    A_, B_, C_ = _conic_quadratic_coeffs(c, kappa, P1, S, dx, dy)
    disc = B_ * B_ - A_ * C_
    disc_nonneg = disc >= 0
    sqrt_disc = torch.sqrt(torch.where(disc_nonneg, disc, 0.0))
    sign_c = 1.0 if c > 0 else -1.0
    denom = z_dir * sign_c * sqrt_disc - B_
    vertex_tangent = denom == 0
    t = C_ / torch.where(vertex_tangent, 1.0, denom)
    t = torch.where(vertex_tangent, 0.0, t)
    return t, disc_nonneg


def ray_conic_intersect(P, S, c, kappa, dx=0.0, dy=0.0):
    """Intersect rays with a (possibly off-axis) conicoid -> (Q, n, valid)."""
    if _statically_zero(c):
        return ray_plane_intersect(P, S)
    P = _atleast_2d(P)
    S = _atleast_2d(S)
    Sz = S[..., 2]
    s0 = -P[..., 2] / Sz
    P1 = P + s0[..., None] * S
    t, disc_nonneg = _conic_quadratic_t(c, kappa, P1, S, dx, dy)
    Q = P1 + t[..., None] * S
    Xq = Q[..., 0] + dx
    Yq = Q[..., 1] + dy
    phi_arg = 1.0 - (1.0 + kappa) * c * c * (Xq * Xq + Yq * Yq)
    _, n = conic_sag_and_normal(c, kappa, Xq, Yq)
    return Q, n, disc_nonneg & (phi_arg >= 0)


def ray_sphere_intersect(P, S, c):
    """Intersect rays with a sphere of curvature c -> (Q, n, valid)."""
    return ray_conic_intersect(P, S, c, 0.0)


def _domain_corridor(P1, S, s_lo, s_hi, domain_radius):
    """Clip each ray's band to where its transverse radius stays <= R.

    Branch-free; rays that never enter the disk return with lo > hi.
    """
    Sx = S[..., 0]
    Sy = S[..., 1]
    Px = P1[..., 0]
    Py = P1[..., 1]
    a = Sx * Sx + Sy * Sy
    b = Px * Sx + Py * Sy
    c = Px * Px + Py * Py - domain_radius * domain_radius
    lo = torch.broadcast_to(_like(s_lo, P1), a.shape)
    hi = torch.broadcast_to(_like(s_hi, P1), a.shape)
    disc = b * b - a * c
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.where(a > 0, a, 1.0)
    s_a = (-b - sqrt_disc) / a_safe
    s_b = (-b + sqrt_disc) / a_safe
    swept = a > 0
    real = swept & (disc >= 0)
    lo = torch.where(real, torch.maximum(lo, s_a), lo)
    hi = torch.where(real, torch.minimum(hi, s_b), hi)
    # swept miss, or axial ray outside the disk: empty corridor
    empty = (swept & ~real) | (~swept & (c > 0))
    hi = torch.where(empty, lo - 1.0, hi)
    return lo, hi


def _lipschitz_march_solve_s(sag_and_normal, P1, S, s_lo, s_hi,
                             sag_lipschitz, tol_sag, maxiter,
                             domain_radius=None, active=None):
    """First-root solve by Lipschitz (sphere-tracing) descent from the floor.

    Steps abs(F) / Lip from s_lo and switches to local Newton near the
    root.  Every lane stays resident and freezes on convergence or
    exhaustion; the loop runs under ``torch.no_grad`` on detached inputs
    and leaves once no lane is live (checked every ``MARCH_CHECK_EVERY``
    steps: a frozen lane never moves, so the extra steps change nothing).

    ``active`` masks lanes that should march at all (the rescue subset);
    inactive lanes return invalid.  Gradients flow through one tracked
    Newton polish step at the accepted root (implicit-function style,
    matching ``newton_raphson_solve_s``).
    """
    if domain_radius is not None:
        s_lo, s_hi = _domain_corridor(P1, S, s_lo, s_hi,
                                      MARCH_RADIUS_MARGIN * domain_radius)
    else:
        shape = P1.shape[:-1]
        s_lo = torch.broadcast_to(_like(s_lo, P1), shape)
        s_hi = torch.broadcast_to(_like(s_hi, P1), shape)

    Sz = S[..., 2]
    S_t = torch.sqrt(torch.clamp(1.0 - Sz * Sz, min=0.0))
    Lip = torch.abs(Sz) + sag_lipschitz * S_t
    # Lip == 0 only for an in-plane ray over locally flat sag
    Lip = torch.where(Lip > 0.0, Lip, 1.0)

    live = s_lo <= s_hi
    if active is not None:
        live = live & active

    with torch.no_grad():
        P1_d, S_d = P1.detach(), S.detach()
        lo_d, hi_d = s_lo.detach(), s_hi.detach()
        Lip_d = Lip.detach()
        s = lo_d.clone()
        valid = torch.zeros_like(live)
        for i in range(int(maxiter)):
            if i % MARCH_CHECK_EVERY == 0 and not bool(live.any()):
                break
            Pj = P1_d + s[..., None] * S_d
            sagj, n_hat = sag_and_normal(Pj[..., 0], Pj[..., 1])
            Fj = Pj[..., 2] - sagj
            newly = live & (torch.abs(Fj) < tol_sag)
            valid = valid | newly
            step_lip = torch.abs(Fj) / Lip_d
            Fp = row_dot(S_d, n_hat) / n_hat[..., 2]
            Fp_safe = torch.where(torch.abs(Fp) > 0, Fp, 1.0)
            step_newton = -Fj / Fp_safe
            # switch to Newton only near the root and away from tangency
            near = (torch.isfinite(step_newton)
                    & (torch.abs(Fp) > COS_INCIDENCE_FLOOR)
                    & (step_lip < NEWTON_SWITCH_FRACTION * (1.0 + torch.abs(s))))
            s_new = torch.where(near, s + step_newton, s + step_lip)
            # clamp Newton to the corridor; descent alone detects passing s_hi
            s_new = torch.minimum(torch.maximum(s_new, lo_d), hi_d)
            exhausted = (~near) & ~newly & (s + step_lip > hi_d)
            live = live & ~newly & ~exhausted & torch.isfinite(Fj)
            s = torch.where(live, s_new, s)

    # differentiable polish step: value unchanged at a root, gradient exact
    Pj = P1 + s[..., None] * S
    sagj, n_hat = sag_and_normal(Pj[..., 0], Pj[..., 1])
    Fj = Pj[..., 2] - sagj
    Fpj = row_dot(S, n_hat) / n_hat[..., 2]
    graze = ~(torch.abs(Fpj) > 1e-300)
    step = Fj / torch.where(graze, 1.0, Fpj)
    s = torch.where(graze | ~torch.isfinite(step), s, s - step)
    Pj = P1 + s[..., None] * S
    sagj, n_hat = sag_and_normal(Pj[..., 0], Pj[..., 1])
    nan = float('nan')
    Q = torch.where(valid[..., None], Pj, nan)
    n_out = torch.where(valid[..., None], n_hat, nan)
    return Q, n_out, valid


def bracketed_newton_solve_s(P1, S, sag_and_normal, s_lo, s_hi,
                             tol_sag=None,
                             maxiter=SURFACE_INTERSECTION_DEFAULT_MAXITER,
                             lipschitz=None, domain_radius=None):
    """First-root solve in a band by Lipschitz (sphere-tracing) descent.

    The Lipschitz bound makes the march provably unable to step over the
    first root, so it needs no segment scan or bracket-refinement
    heuristics.

    Parameters
    ----------
    P1 : Tensor
        (N, 3) ray origins, expressed on the surface vertex plane.
    S : Tensor
        (N, 3) unit direction cosines.
    sag_and_normal : callable
        maps (x, y) to the surface sag and its unit normal.
    s_lo, s_hi : Tensor or float
        (N,) endpoints of the search band (path length along each ray
        measured from P1).
    tol_sag : float, optional
        absolute convergence tolerance on the residual Z - sag.
    maxiter : int, optional
        iteration cap per solve.
    lipschitz : float
        max abs(grad sag) over the domain; required: it is what guarantees
        the march finds the first root.
    domain_radius : float, optional
        radius of the characterized disk; clips the march to where the bound
        holds.

    Returns
    -------
    Q, n_hat, valid : Tensor, Tensor, Tensor
        intersection points, unit surface normals, and a length-N boolean
        convergence mask.  Failed rays are NaN.
    """
    if lipschitz is None:
        raise ValueError(
            'a lipschitz bound (the max |grad sag| over the domain) is '
            'required: it is what guarantees the march cannot step over '
            'the first root.')
    P1 = _atleast_2d(P1)
    S = _atleast_2d(S)
    tol_sag = resolve_tol_sag(tol_sag, P1.dtype)
    steps = max(maxiter, LIPSCHITZ_MARCH_MAXSTEPS)
    return _lipschitz_march_solve_s(sag_and_normal, P1, S, s_lo, s_hi,
                                    lipschitz, tol_sag, steps,
                                    domain_radius=domain_radius)


def seeded_newton_intersect(seed, P, S, sag_and_normal, tol_sag=None,
                            maxiter=None, departure=None, domain_radius=None,
                            departure_gradient=None, sag_lipschitz=None,
                            forward_only=False):
    """Conic-seeded Newton intersection -> (Q, n, valid).

    ``seed`` is the (c, k, dx, dy) conic approximant of the shape; its
    analytic root seeds the Newton iteration on the full sag, cutting
    iterations to a handful for realistic departures.  With
    ``departure``/``domain_radius`` bounds (from the owning Surface's
    DepartureBand), the Newton root is accepted only inside the
    seed-relative band; uncertified rays run the Lipschitz rescue, as a
    masked march rather than a value-dependent branch.
    """
    if maxiter is None:
        maxiter = SURFACE_INTERSECTION_DEFAULT_MAXITER
    P = _atleast_2d(P)
    S = _atleast_2d(S)
    c, k, dx, dy = seed
    Sz = S[..., 2]
    s0 = -P[..., 2] / Sz
    P1 = P + s0[..., None] * S
    nan = float('nan')
    if _statically_zero(c):
        seed = torch.zeros_like(s0)
        seed_ok = torch.ones_like(s0, dtype=torch.bool)
        Q_conic = P1
        n_conic = _unit_z(P1.detach())
    else:
        seed, seed_ok = _conic_quadratic_t(c, k, P1, S, dx, dy)
        seed = torch.where(seed_ok, seed, 0.0)
        Q_conic = P1 + seed[..., None] * S
        _, n_conic = conic_sag_and_normal(
            c, k, Q_conic[..., 0] + dx, Q_conic[..., 1] + dy)
    Q, n, valid = newton_raphson_solve_s(P1, S, sag_and_normal, s1=seed,
                                         tol_sag=tol_sag, maxiter=maxiter)
    tol = resolve_tol_sag(tol_sag, P1.dtype)

    band_active = departure is not None and domain_radius is not None
    if band_active:
        s_root = row_dot(Q - P1, S)
        cosi = torch.abs(row_dot(S, n_conic))
        # monotonicity certificate on the unfloored seed incidence
        if departure_gradient is not None:
            S_t = torch.sqrt(torch.clamp(1.0 - Sz * Sz, min=0.0))
            certified = (cosi - departure_gradient * S_t) > CERTIFICATE_MARGIN
        else:
            certified = torch.ones(cosi.shape, dtype=torch.bool, device=cosi.device)
        # grazing/NaN incidence gets the widest finite band
        cosi = torch.where(cosi >= COS_INCIDENCE_FLOOR, cosi,
                           COS_INCIDENCE_FLOOR)
        # slack for Newton convergence noise in near-zero departure bands
        band = (departure + 100.0 * tol * (1.0 + torch.abs(seed))) / cosi
        rseed_sq = (Q_conic[..., 0] * Q_conic[..., 0]
                    + Q_conic[..., 1] * Q_conic[..., 1])
        seed_hit = seed_ok & torch.isfinite(seed)
        police = seed_hit & (rseed_sq <= domain_radius * domain_radius)
        in_band = torch.abs(s_root - seed) <= band
        # departure bounds do not certify roots outside the domain
        rroot_sq = Q[..., 0] * Q[..., 0] + Q[..., 1] * Q[..., 1]
        in_domain = rroot_sq <= domain_radius * domain_radius
        # preserve roots the band-only guard would have accepted
        old_anchorless = ~seed_hit & ~in_domain
        prior_accept = (valid & (~police | (in_band & in_domain))
                        & ~old_anchorless)
        certified_accept = valid & police & in_band & in_domain & certified
        rescue = police & ~certified_accept
        lo = seed - band
        hi = seed + band
        if not _statically_zero(c):
            # closest-approach band for rays whose seed conic misses.  The
            # band only feeds masks and the detached march, so it carries
            # no graph (-Sz / c holds inf for a tensor c of 0, whose
            # derivative would poison d/dc)
            with torch.no_grad():
                A_, B_, C_ = _conic_quadratic_coeffs(
                    c.detach() if torch.is_tensor(c) else c, k,
                    P1.detach(), S.detach(), dx, dy)
                abs_c = torch.abs(_like(c, P1).detach())
                z_max = (abs_c * domain_radius * domain_radius / 2.0
                         + departure)
                scale = (2.0 / abs_c
                         + 2.0 * torch.abs(_like(1.0 + k, P1).detach()) * z_max)
                d_imp = (departure + 100.0 * tol) * scale
                A_safe = torch.where(A_ > 0, A_, 1.0)
                t_star = -B_ / A_safe
                c_min = C_ - B_ * B_ / A_safe
                wsq = (d_imp - c_min) / A_safe
                rescuable = (~seed_hit & (A_ > 0) & (wsq >= 0)
                             & torch.isfinite(t_star))
                w = torch.sqrt(torch.abs(wsq))
                lo = torch.where(rescuable, t_star - w, lo.detach())
                hi = torch.where(rescuable, t_star + w, hi.detach())
            rescue = rescue | rescuable
        if sag_lipschitz is not None:
            Qr, nr, vr = _lipschitz_march_solve_s(
                sag_and_normal, P1, S, lo, hi, sag_lipschitz, tol,
                max(maxiter, LIPSCHITZ_MARCH_MAXSTEPS),
                domain_radius=domain_radius, active=rescue)
        else:
            Qr, nr = Q, n
            vr = torch.zeros(rescue.shape, dtype=torch.bool, device=rescue.device)
        won = rescue & vr
        Q = torch.where(won[..., None], Qr, Q)
        n = torch.where(won[..., None], nr, n)
        # the rescue wins where it converged; where it stalls, previous
        # band-only accepts survive; non-rescued accepts keep Newton
        accept = certified_accept | won | (rescue & ~vr & prior_accept)
        accept = accept | (prior_accept & ~rescue)
        valid = accept
        Q = torch.where(valid[..., None], Q, nan)
        n = torch.where(valid[..., None], n, nan)

    if forward_only:
        # reject roots behind the incoming ray origin: total march
        # s0 + s must move the ray forward along S, with slack for
        # Newton noise
        s_root = row_dot(Q - P1, S)
        backward = (s0 + s_root) < (-100.0 * tol * (1.0 + torch.abs(s0)))
        valid = valid & ~backward
        Q = torch.where(valid[..., None], Q, nan)
        n = torch.where(valid[..., None], n, nan)
    return Q, n, valid
