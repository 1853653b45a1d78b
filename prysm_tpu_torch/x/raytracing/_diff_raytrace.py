"""Forward-mode differential raytracing on ``torch.func.jvp``.

Counterpart of ``prysm_tpu/x/raytracing/_diff_raytrace.py``: every
tangent is one ``torch.func.jvp`` sweep of the same trace kernel the
nominal path runs, one sweep per seed in the seeds' order, so the tangent
columns line up with the seeds.  The Newton intersection carries
implicit-function derivatives (its loop runs on detached inputs, which
drops the tangents, and one tracked polish step restores them), and the
reference-sphere center/curvature tangents fall out of differentiating
the closing itself.  The per-primitive ``d_*`` functions below are jvp
wrappers kept for unit-level validation.

Host reads stay outside the differentiated functions: the valid-ray set,
the chief index and the nominal geometry are read from a nominal trace
first, and a host read inside ``torch.func.jvp`` raises rather than drop
a tangent.  Tangents come back as host numpy; the traces run on
``config.device`` in ``config.precision``.

Seed vocabulary (``seed_curvature`` &c) is shared with the reverse-mode
engine (`adjoint/seeds.py`); both directions differentiate the identical
functional perturbation ``apply_seeds(surfaces, seeds, eps)``.
"""
import numpy as onp
import torch
from torch import func as tfunc

from ...conf import config, numpy_dtype, to_tensor
from .spencer_and_murty import (
    _like,
    raytrace,
    to_host,
    valid_mask,
    intersect,
    reflect,
    diffract,
    eic_closing,
    transform_to_local_coords,
    transform_to_global_coords,
    STYPE_REFRACT,
    STYPE_REFLECT,
)
from .adjoint.seeds import (  # noqa: F401  (re-exported, as in the JAX package)
    seed_curvature,
    seed_conic,
    seed_shape_param,
    seed_irregularity,
    seed_decenter,
    seed_despace,
    seed_tilt,
    seed_index,
    seed_from_perturbation,
    seeds_from_perturbations,
)


class DiffSeed:
    """Named launch-tangent seed (dx / dy / du / dv).

    Design-parameter seeds (curvature, decenter, tilt, index, ...) come
    from `adjoint.seeds`; this bare seed names a launch-tangent column
    supplied through Pdot0 / Sdot0 (parabasal beams use it).
    """

    __slots__ = ('name',)

    def __init__(self, name=None):
        self.name = name


class DiffTraceResult:
    """A trace plus per-seed tangent histories.

    Pdot / Sdot have shape (n_hist, N, 3, n_params) and Ldot
    (n_hist, N, n_params), indexed like the trace histories with a
    trailing parameter axis (host numpy).
    """

    __slots__ = ('trace', 'Pdot', 'Sdot', 'Ldot', 'seeds')

    def __init__(self, trace, Pdot, Sdot, seeds, Ldot=None):
        self.trace = trace
        self.Pdot = Pdot
        self.Sdot = Sdot
        self.Ldot = Ldot
        self.seeds = seeds

    @property
    def n_params(self):
        return len(self.seeds)

    @property
    def P(self):
        """Nominal position history (passthrough to .trace)."""
        return self.trace.P

    @property
    def S(self):
        """Nominal direction history (passthrough to .trace)."""
        return self.trace.S

    @property
    def OPL(self):
        """Nominal per-segment OPL history (passthrough to .trace)."""
        return self.trace.OPL

    @property
    def status(self):
        """Nominal per-ray status codes (passthrough to .trace)."""
        return self.trace.status


def _is_design_seed(seed):
    """True for adjoint.seeds.DiffSeed (acts on the prescription)."""
    return hasattr(seed, 'pose')


def _has_design_action(seeds):
    for s in seeds:
        if not _is_design_seed(s):
            continue
        if s.pose or s.shapes or s.sag_term is not None or s.index is not None:
            return True
    return False


def _broadcast_tangent0(dot0, shape, n_params):
    if dot0 is None:
        return onp.zeros(shape + (n_params,))
    dot0 = onp.asarray(to_host(dot0), dtype=float)
    if dot0.shape != shape + (n_params,):
        dot0 = onp.array(onp.broadcast_to(dot0, shape + (n_params,)))
    return dot0


def _working(a):
    """A host array as a ``config.precision`` tensor on ``config.device``."""
    return to_tensor(onp.asarray(to_host(a), dtype=float)).to(config.precision)


def _unit(n_params, k, like):
    """The k-th unit vector of length n_params, like ``like``."""
    e = torch.zeros(n_params, dtype=like.dtype, device=like.device)
    e[k] = 1.0
    return e


def raytrace_with_tangents(surfaces, P, S, wvl, seeds, Pdot0=None,
                           Sdot0=None, tol_sag=None):
    """Trace a bundle and propagate per-seed tangents by forward-mode AD.

    seeds may be design seeds (`adjoint.seeds.DiffSeed`: curvature,
    decenter, tilt, index, irregularity, ...) and/or bare launch seeds;
    Pdot0 / Sdot0 ((N, 3, n_params)) add launch-recipe tangents on the
    starting position / direction of each parameter column.  Returns a
    DiffTraceResult whose trace keeps per-surface intermediates.
    """
    P = onp.asarray(to_host(P), dtype=float)
    S = onp.asarray(to_host(S), dtype=float)
    seeds = list(seeds)
    n_params = len(seeds)
    Pdot0 = _broadcast_tangent0(Pdot0, P.shape, n_params)
    Sdot0 = _broadcast_tangent0(Sdot0, S.shape, n_params)
    design = _has_design_action(seeds)
    if design:
        from .adjoint.engine import apply_seeds
        from .adjoint.seeds import DiffSeed as _DesignSeed
        # launch-only seeds become empty (no-action) design seeds so the
        # eps axis stays aligned with the caller's seed order
        eff_seeds = [s if _is_design_seed(s) else _DesignSeed(name=s.name)
                     for s in seeds]

    Pj = _working(P)
    Sj = _working(S)
    eps0 = torch.zeros(n_params, dtype=Pj.dtype, device=Pj.device)

    def f(eps, Pv, Sv):
        surfs = apply_seeds(surfaces, eff_seeds, eps) if design else surfaces
        r = raytrace(surfs, Pv, Sv, wvl, tol_sag=tol_sag)
        return r.P, r.S, r.OPL

    Pdots, Sdots, Ldots = [], [], []
    for k in range(n_params):
        tangents = (_unit(n_params, k, Pj), _like(Pdot0[..., k], Pj),
                    _like(Sdot0[..., k], Pj))
        _, (dP, dS, dL) = tfunc.jvp(f, (eps0, Pj, Sj), tangents)
        Pdots.append(to_host(dP))
        Sdots.append(to_host(dS))
        Ldots.append(to_host(dL))
    trace = raytrace(surfaces, Pj, Sj, wvl, tol_sag=tol_sag,
                     keep_intermediates=True)
    if n_params:
        Pdot = onp.stack(Pdots, axis=-1)
        Sdot = onp.stack(Sdots, axis=-1)
        Ldot = onp.stack(Ldots, axis=-1)
    else:
        Pdot = onp.zeros(tuple(trace.P.shape) + (0,))
        Sdot = onp.zeros_like(Pdot)
        Ldot = onp.zeros(tuple(trace.OPL.shape) + (0,))
    return DiffTraceResult(trace, Pdot, Sdot, list(seeds), Ldot=Ldot)


# ---------- wavefront tangents ----------------------------------------------

def _closest_point_on_axis_t(P, S, axis_point, axis_dir):
    """Tensor twin of _line_math.closest_point_on_line_to_line."""
    B = _like(axis_point, P)
    Sa = _like(axis_dir, P)
    Sa = Sa / torch.sqrt(torch.sum(Sa * Sa))
    w = P - B
    a = torch.sum(S * S)
    b = torch.sum(S * Sa)
    d = torch.sum(S * w)
    e = torch.sum(Sa * w)
    denom = a - b * b  # Sa is unit: c == 1
    t = (a * e - b * d) / denom
    return B + t * Sa


def image_index_tangents(surfaces, seeds):
    """Tangent of the image-medium index after all refractive transitions.

    Each seed's index action lands on the medium following its target
    surface; only the final refractive transition's medium reaches the
    image space.
    """
    seeds = list(seeds)
    out = onp.zeros(len(seeds), dtype=numpy_dtype())
    j_img = None
    for j, surf in enumerate(surfaces):
        if getattr(surf, 'typ', None) == STYPE_REFRACT:
            j_img = j
    if j_img is None:
        return out
    for k, sd in enumerate(seeds):
        idx = getattr(sd, 'index', None)
        if idx is not None and idx[0] == j_img:
            out[k] += idx[1]
    return out


def wavefront_with_tangents(surfaces, P, S, wavelength, seeds, *,
                            chief_index=None,
                            axis_point=None, axis_dir=None, P_xp=None,
                            P_xp_dot=None, reference_curvature=None,
                            reference_curvature_dot=None,
                            field=None, output='length',
                            Pdot0=None, Sdot0=None, tol_sag=None):
    """OPD and per-seed OPD tangents on the chief reference sphere.

    The whole chain — seed-perturbed trace, chief image point, exit-pupil
    anchor, reference-sphere curvature, Hopkins EIC closing, launch-frame
    field tilt — is one differentiable function of the seed vector, so a
    single ``torch.func.jvp`` per seed carries every coupling.

    Returns
    -------
    opd : ndarray, (Nvalid,)
        nominal OPD, chief == 0.
    x_pupil, y_pupil : ndarray, (Nvalid,)
        launch (x, y) pupil coordinates (chief-relative).
    dW : ndarray, (Nvalid, n_params)
        per-seed wavefront-derivative maps, column k = dOPD/dtau_k.
    """
    from .adjoint.engine import apply_seeds
    from .opt import _pupil_center_chief_index
    from ._resolve import trace_context
    from .analysis import _require_valid_chief

    seeds = list(seeds)
    n_params = len(seeds)
    P = onp.asarray(to_host(P), dtype=float)
    S = onp.asarray(to_host(S), dtype=float)
    if chief_index is None:
        chief_index = _pupil_center_chief_index(P)
    chief_index = int(chief_index)
    if reference_curvature is not None and (
            P_xp is not None or P_xp_dot is not None):
        raise ValueError(
            'reference_curvature is mutually exclusive with P_xp/P_xp_dot')

    # nominal trace: fixes the valid-ray set so the jvp linearizes on
    # all-finite lanes (dead-lane NaNs poison forward mode exactly as they
    # poison reverse mode)
    r0 = raytrace(surfaces, P, S, wavelength, tol_sag=tol_sag)
    valid = to_host(valid_mask(r0.status, r0.P[-1]))
    _require_valid_chief(valid, chief_index)
    fchief = int(valid[:chief_index].sum())
    Pv = P[valid]
    Sv = S[valid]
    Pdot0 = _broadcast_tangent0(Pdot0, P.shape, n_params)[valid]
    Sdot0 = _broadcast_tangent0(Sdot0, S.shape, n_params)[valid]

    n_image0 = trace_context(surfaces, wavelength).n_image
    n_image_dot = image_index_tangents(surfaces, seeds)

    if reference_curvature is None and P_xp is None:
        if axis_point is None:
            axis_point = onp.zeros(3)
        if axis_dir is None:
            axis_dir = onp.array([0.0, 0.0, 1.0])
        S_chief = to_host(r0.S)[-1][valid][fchief]
        ad = onp.asarray(axis_dir, dtype=float)
        ad = ad / onp.sqrt(onp.sum(ad * ad))
        perp = S_chief - onp.dot(S_chief, ad) * ad
        if float(onp.sqrt(onp.sum(perp * perp))) < 1e-6:
            raise ValueError(
                'cannot locate the exit pupil from a near-axial chief ray; '
                'pass P_xp to anchor the reference sphere')
    if reference_curvature is not None:
        if reference_curvature_dot is None:
            kappa_dot_in = onp.zeros(n_params, dtype=numpy_dtype())
        else:
            kappa_dot_in = onp.asarray(reference_curvature_dot,
                                       dtype=numpy_dtype())
            if kappa_dot_in.shape != (n_params,):
                raise ValueError(
                    'reference_curvature_dot must have shape (n_params,)')
    if P_xp is not None:
        P_xp = onp.asarray(to_host(P_xp), dtype=float)
        if P_xp_dot is None:
            P_xp_dot = onp.zeros((3, n_params))
        else:
            P_xp_dot = onp.asarray(P_xp_dot, dtype=float)
            if P_xp_dot.shape != (3, n_params):
                raise ValueError('P_xp_dot must have shape (3, n_params)')

    if field is not None:
        ax, ay = field.angle_radians()
        sin_ax = float(onp.sin(ax))
        sin_ay = float(onp.sin(ay))

    design = _has_design_action(seeds)
    if design:
        from .adjoint.seeds import DiffSeed as _DesignSeed
        # launch-only seeds become empty (no-action) design seeds so the
        # eps axis stays aligned with the caller's seed order, matching
        # raytrace_with_tangents
        eff_seeds = [s if _is_design_seed(s)
                     else _DesignSeed(name=getattr(s, 'name', None))
                     for s in seeds]

    def f(eps, Pb, Sb):
        surfs = apply_seeds(surfaces, eff_seeds, eps) if design else surfaces
        r = raytrace(surfs, Pb, Sb, wavelength, tol_sag=tol_sag)
        P_last = r.P[-1]
        S_last = r.S[-1]
        L = r.OPL.sum(dim=0)
        C = P_last[fchief]
        if reference_curvature is not None:
            kappa = reference_curvature + torch.sum(eps * _like(kappa_dot_in, eps))
        else:
            if P_xp is not None:
                xp = _like(P_xp, eps) + _like(P_xp_dot, eps) @ eps
            else:
                xp = _closest_point_on_axis_t(C, S_last[fchief], axis_point, axis_dir)
            delta = xp - C
            kappa = 1.0 / torch.sqrt(torch.sum(delta * delta))
        n_img = n_image0 + torch.sum(eps * _like(n_image_dot, eps))
        s, _ = eic_closing(P_last, S_last, C, kappa)
        L_tot = L + n_img * s
        opd = L_tot - L_tot[fchief]
        if field is not None:
            x0 = r.P[0][:, 0] - r.P[0][fchief, 0]
            y0 = r.P[0][:, 1] - r.P[0][fchief, 1]
            opd = opd + sin_ax * x0 + sin_ay * y0
        return opd

    Pj = _working(Pv)
    Sj = _working(Sv)
    eps0 = torch.zeros(n_params, dtype=Pj.dtype, device=Pj.device)
    opd = None
    cols = []
    for k in range(n_params):
        tangents = (_unit(n_params, k, Pj), _like(Pdot0[..., k], Pj),
                    _like(Sdot0[..., k], Pj))
        opd_k, dk = tfunc.jvp(f, (eps0, Pj, Sj), tangents)
        opd = opd_k if opd is None else opd
        cols.append(to_host(dk))
    if opd is None:
        opd = f(eps0, Pj, Sj)
    opd = to_host(opd)
    dW = (onp.stack(cols, axis=-1) if cols
          else onp.zeros(opd.shape + (0,)))

    if reference_curvature is None:
        # host-side diagnostics on the nominal geometry (the closing clamps
        # disc >= 0; validate it was not exercised)
        P_last0 = to_host(r0.P)[-1][valid]
        S_last0 = to_host(r0.S)[-1][valid]
        C0 = P_last0[fchief]
        if P_xp is not None:
            delta0 = P_xp - C0
        else:
            xp0 = to_host(_closest_point_on_axis_t(
                torch.as_tensor(C0), torch.as_tensor(S_last0[fchief]),
                axis_point, axis_dir))
            delta0 = xp0 - C0
        R0 = float(onp.sqrt(onp.sum(delta0 * delta0)))
        if R0 <= 1e-12:
            raise ValueError(
                'reference-sphere radius is degenerate; pass a '
                'nondegenerate P_xp')
        kappa0 = 1.0 / R0
        _, disc0 = eic_closing(torch.as_tensor(P_last0), torch.as_tensor(S_last0),
                               C0, kappa0)
        disc_min = float(torch.min(disc0))
        tol = 64.0 * onp.finfo(onp.float64).eps
        if disc_min < -tol:
            raise ValueError(
                'ray does not intersect the reference sphere; check '
                'P_xp/center or use the telecentric curvature=0 limit')

    x_pupil = P[valid, 0] - P[chief_index, 0]
    y_pupil = P[valid, 1] - P[chief_index, 1]
    if output == 'length':
        scale = 1.0
    elif output == 'waves':
        scale = -1.0 / (float(wavelength) * 1e-3)
    else:
        raise ValueError(
            f"output must be 'length' or 'waves', got {output!r}")
    return opd * scale, x_pupil, y_pupil, dW * scale


# ---------- per-primitive differentials (jvp wrappers) ----------------------
#
# Unit-level differentials: each takes nominal inputs plus tangent columns
# with a trailing parameter axis and returns (nominal, tangent) via
# torch.func.jvp of the corresponding spencer_and_murty primitive.

def _jvp_cols(fn, primals, tangent_cols):
    """jvp of fn per trailing-axis tangent column; stacks a trailing axis.

    primals: tuple of arrays; tangent_cols: matching tuple whose members
    have one extra trailing axis of size n_params (or None for a zero
    tangent).  Returns (nominal_outputs, tangent_outputs) with the same
    trailing axis appended to every output, as host numpy.
    """
    primals = tuple(_working(p) for p in primals)
    n_params = 0
    for t in tangent_cols:
        if t is not None:
            n_params = onp.asarray(to_host(t)).shape[-1]
            break
    outs = None
    dcols = []
    for k in range(n_params):
        tangents = tuple(
            torch.zeros_like(p) if t is None
            else _like(onp.asarray(to_host(t))[..., k], p)
            for p, t in zip(primals, tangent_cols))
        o, d = tfunc.jvp(fn, primals, tangents)
        outs = o
        dcols.append(d)
    if outs is None:
        outs = fn(*primals)
        dcols = None
    single = not isinstance(outs, tuple)
    if single:
        outs = (outs,)
        dcols = None if dcols is None else [(d,) for d in dcols]
    outs = tuple(to_host(o) for o in outs)
    if dcols is None:
        douts = tuple(onp.zeros(o.shape + (0,)) for o in outs)
    else:
        douts = tuple(
            onp.stack([to_host(d[i]) for d in dcols], axis=-1)
            for i in range(len(outs)))
    if single:
        return outs[0], douts[0]
    return outs, douts


def d_transform_local(P, S, Q, R, Pdot, Sdot, Qdot, Rdot):
    """Differential of transform_to_local_coords.

    P, S: (N, 3); Q: (3,) vertex; R: (3, 3) or None.  Tangents carry a
    trailing parameter axis ((N, 3, P), (3, P), (3, 3, P)); None means
    zero.  Returns (P_loc, S_loc, P_locdot, S_locdot).
    """
    if R is None:
        R = onp.eye(3)
        Rdot = None

    def fn(Pv, Sv, Qv, Rv):
        return transform_to_local_coords(Pv, Qv, Sv, Rv)

    (P_loc, S_loc), (P_locdot, S_locdot) = _jvp_cols(
        fn, (P, S, Q, R), (Pdot, Sdot, Qdot, Rdot))
    return P_loc, S_loc, P_locdot, S_locdot


def d_transform_global(P, S, Q, R, Pdot, Sdot, Qdot, Rdot):
    """Differential of transform_to_global_coords (inverse of local)."""
    if R is None:
        R = onp.eye(3)
        Rdot = None

    def fn(Pv, Sv, Qv, Rv):
        return transform_to_global_coords(Pv, Qv, Sv, Rv)

    (Pg, Sg), (Pgdot, Sgdot) = _jvp_cols(
        fn, (P, S, Q, R), (Pdot, Sdot, Qdot, Rdot))
    return Pg, Sg, Pgdot, Sgdot


def d_intersect(sag_and_normal, P0, S_loc, P0dot, S_locdot, *, s1=0.0,
                tol_sag=None, params=(), params_dot=()):
    """Differential of the implicit ray/surface intersection.

    sag_and_normal(x, y, *params) -> (sag, n_hat); explicit surface-
    parameter partials enter through the ``params`` scalars and their
    ``params_dot`` tangents (each (n_params,)).  Returns (Q, n_hat, Qdot,
    n_hatdot); the tangent is the implicit-function derivative carried by
    the Newton polish step.
    """
    params = tuple(onp.asarray(to_host(p), dtype=float) for p in params)

    def fn(Pv, Sv, *ps):
        def san(x, y):
            return sag_and_normal(x, y, *ps)
        Q, n_hat, _ = intersect(Pv, Sv, san, s1=s1, tol_sag=tol_sag)
        return Q, n_hat

    (Q, n_hat), (Qdot, n_hatdot) = _jvp_cols(
        fn, (P0, S_loc) + params,
        (P0dot, S_locdot) + tuple(params_dot or (None,) * len(params)))
    return Q, n_hat, Qdot, n_hatdot


def d_refract(n, nprime, S_loc, n_hat, S_locdot, dn_hat, ndot_pre=None,
              ndot_post=None):
    """Differential of refract; index tangents enter via ndot_pre/post.

    TIR lanes return the clamped finite continuation (cosT = 0) with
    finite tangents; callers hold the TIR mask from the trace.
    """
    from .spencer_and_murty import refract_with_tir

    def fn(nv, npv, Sv, nh):
        out, _ = refract_with_tir(nv, npv, Sv, nh)
        return out

    Sp, dSp = _jvp_cols(
        fn, (onp.asarray(n, dtype=float), onp.asarray(nprime, dtype=float),
             S_loc, n_hat),
        (ndot_pre, ndot_post, S_locdot, dn_hat))
    return Sp, dSp


def d_reflect(S_loc, n_hat, S_locdot, dn_hat):
    """Differential of reflect: S' = S - 2 (S . n_hat) n_hat."""
    Sp, dSp = _jvp_cols(reflect, (S_loc, n_hat), (S_locdot, dn_hat))
    return Sp, dSp


def d_diffract(S_specular, n_hat, n_post, opl_grad_fn, Pj, dPj,
               dS_specular, dn_hat, n_post_dot=None):
    """Differential of the grating bend on the specular direction.

    opl_grad_fn(x, y) -> (gx, gy) is the in-plane OPL-gradient of the
    grating phase (cycles x period-vector form already folded in); its
    spatial Hessian is carried by AD through (x, y) = Pj[:, :2].
    """
    def fn(Ss, nh, Pv, npost):
        gx, gy = opl_grad_fn(Pv[..., 0], Pv[..., 1])
        out, _ = diffract(Ss, nh, gx, gy, npost)
        return out

    Sd, dSd = _jvp_cols(
        fn, (S_specular, n_hat, Pj, onp.asarray(n_post, dtype=float)),
        (dS_specular, dn_hat, dPj, n_post_dot))
    return Sd, dSd


def d_opl_segment(n_pre, n_pre_dot, seg, dseg, S=None):
    """Differential of the signed OPL segment L = n_pre * sign * |seg|."""
    if S is None:
        def fn(nv, segv):
            return nv * torch.sqrt(torch.sum(segv * segv, dim=-1))
        _, dL = _jvp_cols(fn, (onp.asarray(n_pre, dtype=float), seg),
                          (n_pre_dot, dseg))
        return dL

    def fn(nv, segv):
        ln = torch.sqrt(torch.sum(segv * segv, dim=-1))
        sign = torch.sign(torch.sum(segv * _like(S, segv), dim=-1))
        return nv * sign * ln

    _, dL = _jvp_cols(fn, (onp.asarray(n_pre, dtype=float), seg),
                      (n_pre_dot, dseg))
    return dL


def d_closest_point_on_axis(P, S, Pdot, Sdot, axis_point, axis_dir):
    """Exit-pupil point on the optical axis and its tangent.

    Returns (P_xp (3,), P_xp_dot (3, n_params)).
    """
    def fn(Pv, Sv):
        return _closest_point_on_axis_t(Pv, Sv, axis_point, axis_dir)

    xp, xpdot = _jvp_cols(fn, (P, S), (Pdot, Sdot))
    return xp, xpdot


def d_eic_closing(P, S, Pdot, Sdot, C, Cdot, kappa, kappa_dot):
    """Tangent of the determinate EIC closing segment s~ per ray.

    s~ = -b - kappa m / (1 + sqrt(1 + kappa^2 m)), r = P - C, b = S.r,
    m = b^2 - r.r.  Returns (N, n_params).
    """
    def fn(Pv, Sv, Cv, kv):
        return eic_closing(Pv, Sv, Cv, kv)[0]

    _, sdot = _jvp_cols(
        fn, (P, S, C, onp.asarray(kappa, dtype=float)),
        (Pdot, Sdot, Cdot, kappa_dot))
    return sdot


# ---------- paraxial tangents ------------------------------------------------
#
# The scalar ABCD walk re-expressed in tensor scalars over the seed vector
# and differentiated with torch.func.jvp; sag terms, transverse pose motion
# and unknown shape DOFs are ineligible (None), as in the JAX package.

def _paraxial_seed_arrays(surfaces, seeds):
    """(zdot_s, cdot_s, ndot_s) per-surface x per-seed, or None."""
    seeds = list(seeds)
    n_params = len(seeds)
    n_surf = len(surfaces)
    zdot = onp.zeros((n_surf, n_params))
    cdot = onp.zeros((n_surf, n_params))
    ndot = onp.zeros((n_surf, n_params))
    for k, sd in enumerate(seeds):
        if not _is_design_seed(sd):
            continue
        if sd.sag_term is not None:
            return None
        for j, (Qdot, Rdot) in sd.pose.items():
            if Rdot is not None and onp.any(to_host(Rdot)):
                return None
            if Qdot is not None:
                Qdot = onp.asarray(to_host(Qdot), dtype=float)
                if onp.any(Qdot[:2]):
                    return None
                zdot[j, k] += Qdot[2]
        for sidx, pname, scale in sd.shapes:
            if pname in ('c', 'c_y'):
                cdot[sidx, k] += scale
            elif pname not in ('c_x', 'k', 'k_x', 'k_y'):
                # unknown first-order vertex-curvature tangent
                return None
        if sd.index is not None:
            ndot[sd.index[0], k] += sd.index[1]
    return zdot, cdot, ndot


def _refraction_matrix(pw):
    one, zero = torch.ones_like(pw), torch.zeros_like(pw)
    return torch.stack([torch.stack([one, zero]), torch.stack([-pw, one])])


def _moved(value, eps, dots):
    """value + eps . dots as a 0-d tensor in eps's dtype.

    A host value becomes a tensor first: under ``torch.func.jvp`` a Python
    float combined with a 0-d float32 tensor gives the tangent float64, and
    the ABCD matrices stacked from such scalars then fail to multiply.
    """
    return _like(value, eps) + torch.sum(eps * dots)


def _walk_matrix_traced(surfaces, wvl, eps, zdot, cdot, ndot, n_object, *,
                        start=0, end_index=None, include_end_surface=True):
    """Tensor ABCD walk with eps-perturbed z, curvature, and indices."""
    from .paraxial import _paraxial_curvature

    surfaces = list(surfaces)
    if end_index is None:
        end_index = len(surfaces) - 1
    M = torch.eye(2, dtype=eps.dtype, device=eps.device)
    # n_object may be the tensor n_at_stop of an upstream walk (stop-to-
    # image leg); _like keeps its tangent where float() would drop it
    n = _like(n_object, eps)
    z_prev = _moved(surfaces[start].P[2], eps, zdot[start])
    for k in range(start, len(surfaces)):
        surf = surfaces[k]
        if k > end_index:
            break
        z_k = _moved(surf.P[2], eps, zdot[k])
        if k > start:
            t = z_k - z_prev
            T = torch.stack([torch.stack([torch.ones_like(t), t / n]),
                             torch.stack([torch.zeros_like(t), torch.ones_like(t)])])
            M = T @ M
        if include_end_surface or k != end_index:
            c = _moved(_paraxial_curvature(surf), eps, cdot[k])
            if surf.typ == STYPE_REFLECT:
                n_prime = -n
                M = _refraction_matrix((n_prime - n) * c) @ M
                n = n_prime
            elif surf.typ == STYPE_REFRACT:
                n_prime = _moved(surf.material.n(wvl), eps, ndot[k])
                M = _refraction_matrix((n_prime - n) * c) @ M
                n = n_prime
        z_prev = z_k
    return M, n


def _seed_tensors(data):
    return tuple(to_tensor(onp.asarray(a, dtype=float)).to(config.precision)
                 for a in data)


def paraxial_system_matrix_tangents(surfaces, wvl, seeds):
    """(M, n_image, Mdot, n_image_dot), or None if ineligible."""
    from .paraxial import _first_order_surfaces, object_space_index

    surfaces = _first_order_surfaces(surfaces)
    data = _paraxial_seed_arrays(surfaces, seeds)
    if data is None:
        return None
    zdot, cdot, ndot = _seed_tensors(data)
    n_object = object_space_index(surfaces, wvl)
    n_params = len(list(seeds))

    def f(eps):
        return _walk_matrix_traced(surfaces, wvl, eps, zdot, cdot, ndot,
                                   n_object)

    eps0 = torch.zeros(n_params, dtype=zdot.dtype, device=zdot.device)
    M, n_img = f(eps0)
    Mdot_cols, ndot_cols = [], []
    for k in range(n_params):
        _, (dM, dn) = tfunc.jvp(f, (eps0,), (_unit(n_params, k, eps0),))
        Mdot_cols.append(to_host(dM))
        ndot_cols.append(float(dn))
    Mdot = (onp.stack(Mdot_cols, axis=-1) if n_params
            else onp.zeros((2, 2, 0)))
    return (to_host(M), float(n_img), Mdot,
            onp.asarray(ndot_cols, dtype=numpy_dtype()))


def _pupil_z_tangents(surfaces, wvl, seeds, *, stop_index, which):
    """Shared EP/XP z-tangent kernel; which in {'ep', 'xp'}."""
    from .paraxial import _first_order_surfaces, object_space_index

    seeds = list(seeds)
    n_params = len(seeds)
    if stop_index is None:
        return onp.zeros(n_params, dtype=numpy_dtype())
    surfaces = _first_order_surfaces(surfaces)
    k = int(stop_index)
    if k < 0 or k >= len(surfaces):
        raise IndexError(
            f'stop_index {k} out of range for surfaces of length '
            f'{len(surfaces)}')
    data = _paraxial_seed_arrays(surfaces, seeds)
    if data is None:
        return None
    zdot, cdot, ndot = _seed_tensors(data)
    n_object = object_space_index(surfaces, wvl)

    def f(eps):
        if which == 'ep':
            M_to, _ = _walk_matrix_traced(
                surfaces, wvl, eps, zdot, cdot, ndot, n_object,
                end_index=k, include_end_surface=False)
            A_b = M_to[0, 0]
            B_b = M_to[0, 1]
            z0 = _moved(surfaces[0].P[2], eps, zdot[0])
            return z0 + B_b * _like(n_object, eps) / A_b
        M_to, n_at_stop = _walk_matrix_traced(
            surfaces, wvl, eps, zdot, cdot, ndot, n_object,
            end_index=k, include_end_surface=False)
        M_from, n_img = _walk_matrix_traced(
            surfaces, wvl, eps, zdot, cdot, ndot, n_at_stop, start=k)
        B_a = M_from[0, 1]
        D_a = M_from[1, 1]
        z_last = _moved(surfaces[-1].P[2], eps, zdot[len(surfaces) - 1])
        return z_last - B_a * n_img / D_a

    # degenerate (telecentric) nominal geometry -> None, as in the JAX package
    eps0 = torch.zeros(n_params, dtype=zdot.dtype, device=zdot.device)
    nominal = float(f(eps0))
    if not onp.isfinite(nominal):
        return None
    out = onp.zeros(n_params, dtype=numpy_dtype())
    for p in range(n_params):
        _, d = tfunc.jvp(f, (eps0,), (_unit(n_params, p, eps0),))
        out[p] = float(d)
    return out


def paraxial_entrance_pupil_z_tangents(surfaces, wvl, seeds, *,
                                       stop_index=None):
    """Entrance-pupil z tangent, or None for an ineligible case."""
    return _pupil_z_tangents(surfaces, wvl, seeds,
                             stop_index=stop_index, which='ep')


def paraxial_exit_pupil_z_tangents(surfaces, wvl, seeds, *,
                                   stop_index=None):
    """Exit-pupil z tangent (ynu_first_order .xp_z), or None."""
    return _pupil_z_tangents(surfaces, wvl, seeds,
                             stop_index=stop_index, which='xp')


def paraxial_launch_tangents(system, field, wavelength, sampling, seeds, *,
                             epd=None, P=None, S=None):
    """(Pdot0, Sdot0) tangents of the paraxial launch recipe, or None.

    Covers the analytic-launch-eligible cases (paraxial aiming,
    deterministic sampling, axial first-order seed actions); returns
    None when the launch uses real aiming, random sampling, a
    paraxially-ineligible seed, or an aperture mode whose extent
    tangent is unavailable — callers then treat the launch as fixed.
    """
    from .launch import launch
    from ._resolve import compiled_surfaces
    from .paraxial import object_space_index

    seeds = list(seeds)
    n_params = len(seeds)
    if str(getattr(system, 'ray_aiming', 'paraxial')).lower() != 'paraxial':
        return None
    if sampling.opts.get('distribution') == 'random':
        return None
    surfaces = compiled_surfaces(system)
    data = _paraxial_seed_arrays(surfaces, seeds)
    if data is None:
        return None
    zdot_s = data[0]
    stop_index = getattr(system, 'stop_index', None)
    ep_z_dot = paraxial_entrance_pupil_z_tangents(
        surfaces, wavelength, seeds, stop_index=stop_index)
    if ep_z_dot is None:
        return None
    if P is None or S is None:
        P, S = launch(system, field, wavelength, sampling, epd=epd)
    dtype = numpy_dtype()
    P = onp.asarray(to_host(P), dtype=dtype)
    S = onp.asarray(to_host(S), dtype=dtype)
    n_rays = P.shape[0]
    Pdot = onp.zeros((n_rays, 3, n_params), dtype=dtype)
    Sdot = onp.zeros_like(Pdot)

    aperture = getattr(system, 'aperture', None)
    bc = None
    object_mode = False
    if epd is None and aperture is not None:
        bc = aperture.resolve(system, wavelength)
        object_mode = bc[0] in ('NA_OBJECT', 'FNO_OBJECT')

    ep_z = (None if stop_index is None
            else system.entrance_pupil_z(wavelength))

    if object_mode:
        # the cone direction moves only through the chief aim at the EP
        if ep_z is None:
            return Pdot, Sdot
        na = bc[1] if bc[0] == 'NA_OBJECT' else 1.0 / (2.0 * bc[1])
        n_obj = object_space_index(surfaces, wavelength)
        sin_u = float(na) / float(n_obj)
        from .launch import _apply_vignetting
        rho = _apply_vignetting(sampling.build(1.0), field)
        rho = onp.asarray(rho, dtype=dtype)
        obj = onp.array([field.hx, field.hy, field.object_z], dtype=dtype)

        def f(ez):
            axis_pt = torch.stack([torch.zeros_like(ez), torch.zeros_like(ez), ez])
            chief = axis_pt - _like(obj, ez)
            chief = chief / torch.sqrt(torch.sum(chief * chief))
            st = torch.sqrt(chief[0] * chief[0] + chief[1] * chief[1])
            # deterministic axial gauge matches launch._perp_basis away
            # from the axial limit; the limit itself has zero tangent
            e1 = torch.stack([chief[1], -chief[0], torch.zeros_like(st)]) / st
            flip = torch.where(
                (e1[0] < 0.0) | ((e1[0] == 0.0) & (e1[1] < 0.0)), -1.0, 1.0)
            e1 = e1 * flip
            e2 = torch.linalg.cross(chief, e1)
            r = _like(rho, ez)
            trans = sin_u * (r[:, 0:1] * e1[None, :] + r[:, 1:2] * e2[None, :])
            axial = torch.sqrt(torch.clamp(
                1.0 - sin_u * sin_u * torch.sum(r * r, dim=1), min=0.0))
            return axial[:, None] * chief[None, :] + trans

        if abs(float(obj[0])) < 1e-12 and abs(float(obj[1])) < 1e-12:
            return Pdot, Sdot  # axial field: gauge-fixed basis, zero tangent
        ez0 = _working(float(ep_z))
        for k in range(n_params):
            _, dS = tfunc.jvp(f, (ez0,), (_like(float(ep_z_dot[k]), ez0),))
            Sdot[..., k] = to_host(dS)
        return Pdot, Sdot

    # pupil-plane extent and its tangent
    if epd is not None or sampling.kind == 'chief':
        extent = (float(epd) / 2.0 if epd is not None else 0.0)
        extent_dot = onp.zeros(n_params, dtype=dtype)
    else:
        extent = float(system.entrance_pupil_diameter(wavelength)) / 2.0
        extent_dot = onp.zeros(n_params, dtype=dtype)
        mode = aperture.mode if aperture is not None else 'EPD'
        if mode != 'EPD':
            mres = paraxial_system_matrix_tangents(
                surfaces, wavelength, seeds)
            if mres is None:
                return None
            M, _, Mdot, _ = mres
            C = float(M[1, 0])
            Cdot = Mdot[1, 0]
            if abs(C) < 1e-30:
                return None
            n_obj = object_space_index(surfaces, wavelength)
            if mode == 'FNO_IMAGE':
                efl = -float(n_obj) / C
                efl_dot = float(n_obj) * Cdot / (C * C)
                extent_dot = (onp.sign(efl) * efl_dot / aperture.value) / 2.0
            elif mode == 'NA_IMAGE':
                extent_dot = (-aperture.value * onp.sign(C) * Cdot
                              / (abs(C) ** 2))
            else:
                return None

    from .launch import _apply_vignetting
    pupil_xy = _apply_vignetting(sampling.build(extent), field)
    pupil_xy = onp.asarray(pupil_xy, dtype=dtype)
    hex_fixed = (sampling.kind == 'hex'
                 and sampling.opts.get('spacing') is not None)
    if hex_fixed or extent <= 0.0:
        pupil_xy_dot = onp.zeros((n_rays, 2, n_params), dtype=dtype)
    else:
        pupil_xy_dot = (pupil_xy[:, :, None] / extent
                        * extent_dot[None, None, :])

    pupil_z_dot = zdot_s[0]
    if field.kind == 'angle':
        # collimated: direction fixed; positions slide with the pattern
        # and with the EP plane along the beam
        Pdot[:, :2, :] = pupil_xy_dot
        Pdot[:, 2, :] += pupil_z_dot[None, :]
        if ep_z is not None:
            S0 = S[0]
            shift_dot = (pupil_z_dot - ep_z_dot) / S0[2]
            Pdot[:, 0, :] += shift_dot[None, :] * S0[0]
            Pdot[:, 1, :] += shift_dot[None, :] * S0[1]
        return Pdot, Sdot

    # finite conjugates: P is the object point (fixed); S re-aims at the
    # moving pupil target
    obj = onp.array([field.hx, field.hy, field.object_z], dtype=dtype)
    target_z0 = float(ep_z) if ep_z is not None else float(surfaces[0].P[2])
    target_z_dot = (ep_z_dot if ep_z is not None else pupil_z_dot)

    def g(xy, tz):
        target = torch.cat(
            [xy, torch.broadcast_to(tz, (xy.shape[0], 1))], dim=1)
        d = target - _like(obj, xy)
        return d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))

    xy0 = _working(pupil_xy)
    tz0 = _working(target_z0)
    for k in range(n_params):
        _, dS = tfunc.jvp(
            g, (xy0, tz0),
            (_like(pupil_xy_dot[..., k], xy0), _like(float(target_z_dot[k]), tz0)))
        Sdot[..., k] = to_host(dS)
    return Pdot, Sdot


__all__ = [
    'd_transform_local',
    'd_intersect',
    'd_refract',
    'd_reflect',
    'd_diffract',
    'd_transform_global',
    'd_opl_segment',
    'd_closest_point_on_axis',
    'd_eic_closing',
    'DiffSeed',
    'DiffTraceResult',
    'raytrace_with_tangents',
    'wavefront_with_tangents',
    'image_index_tangents',
    'paraxial_system_matrix_tangents',
    'paraxial_entrance_pupil_z_tangents',
    'paraxial_exit_pupil_z_tangents',
    'paraxial_launch_tangents',
    'seed_curvature',
    'seed_conic',
    'seed_shape_param',
    'seed_irregularity',
    'seed_decenter',
    'seed_despace',
    'seed_tilt',
    'seed_index',
    'seed_from_perturbation',
    'seeds_from_perturbations',
]
