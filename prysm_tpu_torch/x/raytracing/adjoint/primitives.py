"""Per-primitive reverse-mode differentials (``torch.func.vjp`` wrappers).

Counterpart of ``prysm_tpu/x/raytracing/adjoint/primitives.py``: each
``adj_*`` function is one ``torch.func.vjp`` pullback of the same
spencer_and_murty primitive the nominal trace runs, so the reverse rules
cannot drift from the forward model.  The full-trace reverse sweep does
not chain these by hand —
``engine.adjoint_gradient`` differentiates the whole trace program in
one pass — they exist for unit-level validation against the forward
``d_*`` twins (inner-product identities) and for callers composing
custom sweeps.

Cotangent arguments are named ``*_bar`` and have the primal output's
shape; returns follow the primal argument order, as host numpy.  Primals
go to ``config.device`` in ``config.precision``.
"""
import numpy as onp
import torch
from torch import func as tfunc

from ....conf import config, to_tensor
from ..spencer_and_murty import (
    to_host,
    intersect,
    refract_with_tir,
    reflect,
    diffract,
    eic_closing,
    transform_to_local_coords,
    transform_to_global_coords,
)


def _primal(p):
    """A primal as a ``config.precision`` tensor on ``config.device``."""
    return to_tensor(onp.array(to_host(p))).to(config.precision)


def _vjp(fn, primals, cotangents):
    """One pullback; returns host arrays in primal order."""
    primals = tuple(_primal(p) for p in primals)
    out, pull = tfunc.vjp(fn, *primals)
    if not isinstance(cotangents, tuple):
        cotangents = (cotangents,)
    single = not isinstance(out, tuple)
    if single:
        out = (out,)
    cts = tuple(
        torch.zeros_like(o) if c is None
        else torch.as_tensor(onp.array(to_host(c)), dtype=o.dtype, device=o.device)
        for o, c in zip(out, cotangents))
    bars = pull(cts[0] if single else cts)
    return tuple(to_host(b) for b in bars)


def adj_transform_local(P, S, Q, R, P_loc_bar, S_loc_bar):
    """Pullback of transform_to_local_coords.

    Returns (P_bar, S_bar, Q_bar, R_bar); R=None treats the rotation as
    identity and returns R_bar=None.
    """
    if R is None:
        def fn(Pv, Sv, Qv):
            return transform_to_local_coords(Pv, Qv, Sv, None)
        bars = _vjp(fn, (P, S, Q), (P_loc_bar, S_loc_bar))
        return bars + (None,)

    def fn(Pv, Sv, Qv, Rv):
        return transform_to_local_coords(Pv, Qv, Sv, Rv)

    return _vjp(fn, (P, S, Q, R), (P_loc_bar, S_loc_bar))


def adj_transform_global(P_loc, S_loc, Q, R, P_bar, S_bar):
    """Pullback of transform_to_global_coords.

    Returns (P_loc_bar, S_loc_bar, Q_bar, R_bar); R=None returns
    R_bar=None.
    """
    if R is None:
        def fn(Pv, Sv, Qv):
            return transform_to_global_coords(Pv, Qv, Sv, None)
        bars = _vjp(fn, (P_loc, S_loc, Q), (P_bar, S_bar))
        return bars + (None,)

    def fn(Pv, Sv, Qv, Rv):
        return transform_to_global_coords(Pv, Qv, Sv, Rv)

    return _vjp(fn, (P_loc, S_loc, Q, R), (P_bar, S_bar))


def adj_intersect(sag_and_normal, P0, S_loc, Q_bar, n_hat_bar, *, s1=0.0,
                  tol_sag=None, params=()):
    """Pullback of the implicit ray/surface intersection.

    sag_and_normal(x, y, *params) -> (sag, n_hat).  Returns
    (P0_bar, S_loc_bar, *params_bar) — the implicit-function cotangent
    carried by the Newton polish step.
    """
    params = tuple(onp.asarray(to_host(p), dtype=float) for p in params)

    def fn(Pv, Sv, *ps):
        def san(x, y):
            return sag_and_normal(x, y, *ps)
        Q, n_hat, _ = intersect(Pv, Sv, san, s1=s1, tol_sag=tol_sag)
        return Q, n_hat

    return _vjp(fn, (P0, S_loc) + params, (Q_bar, n_hat_bar))


def adj_refract(n, nprime, S_loc, n_hat, Sprime_bar):
    """Pullback of refract (clamped finite continuation on TIR lanes).

    Returns (n_bar, nprime_bar, S_loc_bar, n_hat_bar).
    """
    def fn(nv, npv, Sv, nh):
        out, _ = refract_with_tir(nv, npv, Sv, nh)
        return out

    return _vjp(fn, (onp.asarray(n, dtype=float),
                     onp.asarray(nprime, dtype=float), S_loc, n_hat),
                Sprime_bar)


def adj_reflect(S_loc, n_hat, Sprime_bar):
    """Pullback of reflect.  Returns (S_loc_bar, n_hat_bar)."""
    return _vjp(reflect, (S_loc, n_hat), Sprime_bar)


def adj_diffract(S_specular, n_hat, n_post, opl_grad_fn, Pj, S_diff_bar):
    """Pullback of the grating bend (see d_diffract for the forward map).

    Returns (S_specular_bar, n_hat_bar, n_post_bar, Pj_bar).
    """
    def fn(Ss, nh, npost, Pv):
        gx, gy = opl_grad_fn(Pv[..., 0], Pv[..., 1])
        out, _ = diffract(Ss, nh, gx, gy, npost)
        return out

    return _vjp(fn, (S_specular, n_hat, onp.asarray(n_post, dtype=float),
                     Pj), S_diff_bar)


def adj_opl_segment(n_pre, seg, L_bar, S=None):
    """Pullback of the signed OPL segment L = n_pre * sign * |seg|.

    Returns (n_pre_bar, seg_bar).
    """
    if S is None:
        def fn(nv, segv):
            return nv * torch.sqrt(torch.sum(segv * segv, dim=-1))
    else:
        def fn(nv, segv):
            ln = torch.sqrt(torch.sum(segv * segv, dim=-1))
            sign = torch.sign(torch.sum(
                segv * torch.as_tensor(to_host(S), dtype=segv.dtype, device=segv.device),
                dim=-1))
            return nv * sign * ln

    return _vjp(fn, (onp.asarray(n_pre, dtype=float), seg), L_bar)


def _eic_closing_expr(Pv, Sv, Cv, kv):
    return eic_closing(Pv, Sv, Cv, kv)[0]


def adj_eic_closing(P, S, C, kappa, s_bar):
    """Pullback of the determinate EIC closing segment.

    Returns (P_bar, S_bar, C_bar, kappa_bar).
    """
    return _vjp(_eic_closing_expr,
                (P, S, C, onp.asarray(kappa, dtype=float)), s_bar)


def adj_eic_closing_full(P, S, C, kappa, s_bar, *, n_image=1.0, OPL_bar=None):
    """Pullback of the closed OPL contribution n_image * s~.

    OPL_bar (per-ray) scales the closing cotangent; returns
    (P_bar, S_bar, C_bar, kappa_bar, n_image_bar).
    """
    def fn(Pv, Sv, Cv, kv, nv):
        return nv * _eic_closing_expr(Pv, Sv, Cv, kv)

    bar = s_bar if OPL_bar is None else to_host(s_bar) * to_host(OPL_bar)
    return _vjp(fn, (P, S, C, onp.asarray(kappa, dtype=float),
                     onp.asarray(n_image, dtype=float)), bar)


def adj_closest_point_on_axis(P, S, axis_point, axis_dir, P_xp_bar):
    """Pullback of the on-axis exit-pupil point.  Returns (P_bar, S_bar)."""
    # deferred: _diff_raytrace imports adjoint.seeds at module scope
    from .._diff_raytrace import _closest_point_on_axis_t

    def fn(Pv, Sv):
        return _closest_point_on_axis_t(Pv, Sv, axis_point, axis_dir)

    return _vjp(fn, (P, S), P_xp_bar)


__all__ = [
    'adj_transform_local',
    'adj_transform_global',
    'adj_intersect',
    'adj_refract',
    'adj_reflect',
    'adj_diffract',
    'adj_opl_segment',
    'adj_eic_closing',
    'adj_eic_closing_full',
    'adj_closest_point_on_axis',
]
