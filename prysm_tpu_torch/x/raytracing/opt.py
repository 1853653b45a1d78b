"""Ray aiming, pupil location, OPD closing, and spot statistics.

Counterpart of ``prysm_tpu/x/raytracing/opt.py``.  Aiming is a host-side
damped-Newton loop whose inner landing evaluation is a batched trace —
every ray in the bundle aims concurrently, with per-ray step damping.  The
loop is decomposed into an adapter for the varied quantity
(:func:`_aim_variable`), a per-ray 2x2 forward-difference Jacobian solve
(:func:`_newton_deltas`), and a vectorized backtracking stage.  The
traces run on ``config.device`` and are read back with ``to_host``; the
host statistics take tensors or arrays.
"""
import copy

import numpy as np
import torch

from ...conf import numpy_dtype
from . import spencer_and_murty
from .spencer_and_murty import to_host, valid_mask
from ._line_math import (closest_point_on_line_to_line, normalize_vector,
                         unit_vector_between)


def declipped(surfaces):
    """Surfaces with clips removed; aiming registers rays, never clips them.

    A ray aimed onto a stop edge would otherwise NaN mid-solve when a
    Newton iterate steps past the clip.  Clips apply in the real trace.
    """
    def without_clip(surf):
        if getattr(surf.aperture, 'clip', None) is None:
            return surf
        surf = copy.copy(surf)
        surf.aperture = None
        return surf

    return [without_clip(s) for s in surfaces]


def _aim_variable(vary, P, S):
    """(apply(knob), knob0) pair writing the varied quantity into P or S."""
    if vary == 'position':
        def apply(knob):
            P[:, 0], P[:, 1] = knob[:, 0], knob[:, 1]

        return apply, P[:, :2].copy()

    # direction: vary (Sx, Sy), renormalizing against an anchored Sz
    z_sign = np.sign(S[:, 2])
    z_sign[z_sign == 0] = 1.0
    z_anchor = z_sign * np.abs(S[:, 2])

    def apply(knob):
        sx, sy = knob[:, 0], knob[:, 1]
        scale = np.sqrt(sx * sx + sy * sy + z_anchor * z_anchor)
        degenerate = scale == 0
        scale[degenerate] = 1.0
        S[:, 0], S[:, 1] = sx / scale, sy / scale
        S[:, 2] = np.where(degenerate, z_sign, z_anchor / scale)

    return apply, S[:, :2].copy()


def _newton_deltas(miss, land0, land_dx, land_dy, h, eps):
    """Per-ray 2x2 Newton steps from forward-difference Jacobian columns.

    Returns (delta, singular mask).
    """
    J00 = (land_dx[:, 0] - land0[:, 0]) / h
    J10 = (land_dx[:, 1] - land0[:, 1]) / h
    J01 = (land_dy[:, 0] - land0[:, 0]) / h
    J11 = (land_dy[:, 1] - land0[:, 1]) / h

    det = J00 * J11 - J01 * J10
    frobenius = J00 * J00 + J01 * J01 + J10 * J10 + J11 * J11
    singular = (~np.isfinite(det)) | (np.abs(det) < eps * frobenius)
    det = np.where(singular, 1.0, det)

    mx, my = miss[:, 0], miss[:, 1]
    step0 = (-mx * J11 + J01 * my) / det
    step1 = (mx * J10 - J00 * my) / det
    return np.stack([step0, step1], axis=1), singular


def aim_rays(P, S, surfaces, surface_index, target_xy, wvl, tol=1e-12,
             maxiter=20, strict=True, vary='position'):
    """Aim a bundle so each ray lands at target_xy on a surface.

    target_xy is in the aim surface's local frame; either one (x, y)
    shared by every ray or an (N, 2) per-ray array.  vary selects whether
    launch position or direction is adjusted.  Returns (P, S, converged).
    """
    if vary not in ('position', 'direction'):
        raise ValueError(f"vary must be 'position' or 'direction', got {vary!r}")
    dtype = numpy_dtype()
    P = np.asarray(to_host(P), dtype=dtype).copy()
    S = np.asarray(to_host(S), dtype=dtype).copy()
    target = np.asarray(target_xy, dtype=dtype).reshape(-1, 2)
    path = declipped(surfaces[:surface_index + 1])
    goal_surf = surfaces[surface_index]
    apply, knob = _aim_variable(vary, P, S)

    def landing(candidate):
        apply(candidate)
        tr = spencer_and_murty.raytrace(path, P, S, wvl)
        local, _ = spencer_and_murty.transform_to_local_coords(
            tr.P[-1], goal_surf.P, tr.S[-1], goal_surf.R)
        return to_host(local[:, :2])

    eps = float(np.finfo(dtype).eps)
    half_eps = eps ** 0.5

    miss = landing(knob) - target
    miss_norm = np.sqrt((miss * miss).sum(axis=1))
    hopeless = ~np.isfinite(miss_norm)  # NaN landing (TIR / miss)

    for _round in range(int(maxiter)):
        active = (~hopeless) & (miss_norm > tol)
        if not bool(np.any(active)):
            break

        h = half_eps * np.maximum(
            1.0, np.abs(knob).max(axis=1))
        bumped_x = knob.copy()
        bumped_x[:, 0] += h
        bumped_y = knob.copy()
        bumped_y[:, 1] += h
        delta, singular = _newton_deltas(
            miss, miss + target, landing(bumped_x), landing(bumped_y), h, eps)
        delta[~active | singular] = 0.0
        hopeless |= singular
        active &= ~singular

        # per-ray damped step so one stubborn ray cannot stall the bundle
        damp = np.ones_like(miss_norm)
        knob_try, miss_try, norm_try = knob, miss, miss_norm
        for _halving in range(40):
            knob_try = knob + damp[:, np.newaxis] * delta
            miss_try = landing(knob_try) - target
            norm_try = np.sqrt((miss_try * miss_try).sum(axis=1))
            still_bad = active & ~(norm_try <= miss_norm) & (damp > half_eps)
            if not bool(np.any(still_bad)):
                break
            damp[still_bad] *= 0.5

        improved = active & (norm_try <= miss_norm)
        hopeless |= active & ~improved
        knob = np.where(improved[:, np.newaxis], knob_try, knob)
        miss = np.where(improved[:, np.newaxis], miss_try, miss)
        miss_norm = np.where(improved, norm_try, miss_norm)

    apply(knob)
    converged = np.isfinite(miss_norm) & (miss_norm <= tol)

    if strict and not converged.all():
        failed = np.flatnonzero(~converged).tolist()
        worst = float(np.nanmax(np.where(hopeless, 0.0, miss_norm)))
        raise RuntimeError(
            f'aim_rays failed to converge {len(failed)} of '
            f'{converged.shape[0]} rays (indices {failed}); worst finite '
            f'residual {worst:.3e}. Pass strict=False to return best-effort '
            'launch parameters.')
    return P, S, converged


# ---------- pupil location along the chief ----------


def _closest_approach_on_axis(P_chief, S_chief, axis_point, axis_dir):
    return closest_point_on_line_to_line(P_chief, S_chief, axis_point,
                                         axis_dir)


def _chief_axis_perp_norm(S_chief, axis_dir):
    direction = np.asarray(S_chief)
    axis_unit = normalize_vector(np.asarray(axis_dir), axis=-1)
    transverse = direction - np.sum(direction * axis_unit) * axis_unit
    return float(np.sqrt(np.sum(transverse * transverse)))


def _pupil_on_axis(P_chief, S_chief, axis_p1, axis_p2):
    anchor = np.asarray(axis_p1)
    along = unit_vector_between(anchor, np.asarray(axis_p2))
    return _closest_approach_on_axis(P_chief, S_chief, anchor, along)


def locate_ep(P_chief, S_chief, P_obj, P_s1):
    """Entrance pupil: the chief's closest approach to the object axis."""
    return _pupil_on_axis(P_chief, S_chief, P_obj, P_s1)


def locate_xp(P_chief, S_chief, P_img, P_sk):
    """Exit pupil: the chief's closest approach to the image axis."""
    return _pupil_on_axis(P_chief, S_chief, P_img, P_sk)


def xp_reference_sphere(P_chief, S_chief, axis_point=None, axis_dir=None,
                        min_perp=1e-6):
    """(C, R, P_xp): the exit-pupil reference sphere for one chief ray."""
    dtype = np.asarray(P_chief).dtype
    if axis_point is None:
        axis_point = np.zeros(3, dtype=dtype)
    if axis_dir is None:
        axis_dir = np.array([0., 0., 1.], dtype=dtype)
    if _chief_axis_perp_norm(S_chief, axis_dir) < min_perp:
        raise ValueError(
            'a near-axial chief ray cannot locate the exit pupil; pass '
            'P_xp or a resolvable stop/pupil route anchoring the reference '
            'sphere')
    C = np.asarray(P_chief)
    P_xp = _closest_approach_on_axis(P_chief, S_chief, np.asarray(axis_point),
                                     np.asarray(axis_dir))
    return C, float(np.sqrt(np.sum((P_xp - C) ** 2))), P_xp


def _pupil_center_chief_index(P, valid=None):
    """Index of the launch ray nearest the bundle's pupil center."""
    transverse = to_host(P)[:, :2]
    dist_sq = np.sum((transverse - transverse.mean(axis=0)) ** 2, axis=1)
    if valid is not None:
        dist_sq = np.where(to_host(valid), dist_sq, np.inf)
    return int(np.argmin(dist_sq))


def eic_distance(P_a, d_a, P_b, d_b):
    """Hopkins equally-inclined-chord distance between two pencils."""
    separation = P_a - P_b
    return (((d_a + d_b) * separation).sum(axis=-1)
            / (1.0 + (d_a * d_b).sum(axis=-1)))


def reference_sphere_curvature(P_xp, center):
    """Curvature 1/R of the chief-image reference sphere (0 for XP at inf)."""
    if P_xp is None:
        return 0.0
    gap = np.asarray(P_xp) - np.asarray(center)
    R = float(np.sqrt(np.sum(gap * gap)))
    if R <= 1e-12:
        raise ValueError(
            'the reference-sphere radius is degenerate (exit pupil at the '
            'image point); pass a separated P_xp')
    return 1.0 / R


def hopkins_eic_closing(P_hist, S_hist, OPL_hist, *, center, curvature,
                        n_image=1.0, chief_index=None):
    """Chief-referenced OPD on the image reference sphere, branch-free.

    Parametrized by the sphere center and curvature kappa = 1/R so the
    single expression s = -b - kappa m / (1 + sqrt(1 + kappa^2 m)), with
    r = P_last - center, b = S_last.r, m = b^2 - r.r, spans finite pupils
    and the telecentric kappa -> 0 limit without cancellation (reference:
    prysm/x/raytracing/opt.py:401-468).
    """
    from .spencer_and_murty import eic_closing

    P_last, S_last = to_host(P_hist[-1]), to_host(S_hist[-1])
    OPL_through = to_host(OPL_hist).sum(axis=0)
    if chief_index is None:
        chief_index = _pupil_center_chief_index(to_host(P_hist[0]))
    s, disc = eic_closing(torch.as_tensor(P_last), torch.as_tensor(S_last),
                          to_host(center), float(curvature))
    s, disc = to_host(s), to_host(disc)
    if float(np.min(disc)) < -64.0 * np.finfo(disc.dtype).eps:
        raise ValueError('a ray misses the reference sphere; check '
                         'P_xp/center, or use the telecentric curvature=0 '
                         'limit')
    OPL_total = OPL_through + n_image * s
    return OPL_total - OPL_total[chief_index]


# ---------- spot statistics ----------


def _centered_r2(x, y, axis, center):
    x, y = np.asarray(x), np.asarray(y)
    if center is None:
        center = tuple(np.nanmean(v, axis=axis, keepdims=True)
                       for v in (x, y))
    dx, dy = x - center[0], y - center[1]
    return dx * dx + dy * dy


def centroid_referenced_rms(x, y, *, axis=-1, center=None):
    """NaN-aware RMS distance from the per-slice centroid (or center)."""
    return np.sqrt(np.nanmean(_centered_r2(x, y, axis, center), axis=axis))


def centroid_referenced_max(x, y, *, axis=-1, center=None):
    """NaN-aware max distance from the per-slice centroid (or center)."""
    return np.sqrt(np.nanmax(_centered_r2(x, y, axis, center), axis=axis))


def _surviving(P_final, status):
    P_final = to_host(P_final)
    alive = valid_mask(None if status is None else to_host(status), P_final)
    return P_final if alive is None else P_final[alive]


def spot_centroid(P_final, status=None):
    """Mean (x, y) of valid rays at a surface plane."""
    survivors = _surviving(P_final, status)
    if not survivors.shape[0]:
        return np.full(2, np.nan, dtype=survivors.dtype)
    return survivors[..., :2].mean(axis=0)


def rms_spot_radius(P_final, status=None, centroid=None):
    """RMS distance of valid rays from their centroid (or given center)."""
    survivors = _surviving(P_final, status)
    if not survivors.shape[0]:
        return float('nan')
    about = None if centroid is None else tuple(np.asarray(centroid))
    return float(centroid_referenced_rms(
        survivors[..., 0], survivors[..., 1], axis=0, center=about))


def geometric_psf_histogram(P_final, status=None, bins=64, extent=None):
    """(H, xedges, yedges): 2D histogram of valid rays — the geometric PSF."""
    survivors = _surviving(P_final, status)
    x, y = survivors[..., 0], survivors[..., 1]
    if extent is None:
        if not x.size:
            extent = [(-1.0, 1.0), (-1.0, 1.0)]
        else:
            cx, cy = float(x.mean()), float(y.mean())
            half = max(float(np.abs(x - cx).max()),
                       float(np.abs(y - cy).max())) * 1.05
            half = max(half, 1e-12)
            extent = [(cx - half, cx + half), (cy - half, cy + half)]
    return np.histogram2d(x, y, bins=bins, range=extent)
