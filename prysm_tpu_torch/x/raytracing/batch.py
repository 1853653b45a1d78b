"""Batched raytrace analysis: all fields of one wavelength in one bundle.

Counterpart of ``prysm_tpu/x/raytracing/batch.py``:

* all fields of one wavelength merge into a single (F*N, 3) ray batch:
  rays are independent, so each surface sees one wide bundle instead of
  F small traces;
* launch geometry, chief indices, exit-pupil anchors, field-tilt ramps,
  and Zernike design matrices are host-built constants (tiny, static);
* trace -> EIC closing -> masked Zernike normal-equation solve run as
  tensor work with no host read between the launch arrays going up and
  the fitted coefficients coming back.

The bundles go to ``config.device`` (the card unless the CPU is asked
for) once per wavelength.  On an OpticalSystem the EIC closing's sphere
passes through ``system.exit_pupil`` (``analysis.resolve_exit_pupil``).
"""
from collections import namedtuple

import numpy as np
import torch

from ...conf import resolve_device
from ...polynomials import zernike_nm_seq
from .spencer_and_murty import raytrace, eic_closing
from .launch import launch, Sampling
from ._resolve import compiled_surfaces, trace_context
from .opt import _pupil_center_chief_index
from ._trace_grid import _resolve_fields, _resolve_wavelengths

_PREC = np.float64


def _host_launches(system, fields, wavelength, sampling, epd):
    """Stacked (F, N, 3) launch bundles for one wavelength (host, tiny)."""
    Ps, Ss = [], []
    for f in fields:
        P, S = launch(system, f, wavelength, sampling, epd=epd)
        Ps.append(np.asarray(P, dtype=_PREC))
        Ss.append(np.asarray(S, dtype=_PREC))
    n = {p.shape[0] for p in Ps}
    if len(n) != 1:
        raise ValueError(
            'fields launched different ray counts; device batching needs a '
            'uniform pattern (disable vignetting-dependent dropping)')
    return np.stack(Ps), np.stack(Ss)


def _chief_indices(P0):
    """Pupil-center ray index per field (same rule as the host path)."""
    return np.asarray([_pupil_center_chief_index(P0[i])
                       for i in range(P0.shape[0])])


def _tilt_ramps(fields, P0, chiefs):
    """Static launch-plane field-tilt ramps, (F, N)."""
    ramps = np.zeros(P0.shape[:2], dtype=_PREC)
    for i, f in enumerate(fields):
        ax, ay = f.angle_radians()
        u = P0[i, :, 0] - P0[i, chiefs[i], 0]
        v = P0[i, :, 1] - P0[i, chiefs[i], 1]
        ramps[i] = np.sin(ax) * u + np.sin(ay) * v
    return ramps


def _design_matrices(P0, chiefs, nms, norm, normalization_radius):
    """Static Zernike design matrices (F, N, K) on the launch coordinates.

    Evaluated in float64 on the CPU: they are host constants.
    """
    F, N = P0.shape[:2]
    out = np.empty((F, N, len(nms)), dtype=_PREC)
    uv_out = np.empty((F, 2, N), dtype=_PREC)
    for i in range(F):
        u = P0[i, :, 0] - P0[i, chiefs[i], 0]
        v = P0[i, :, 1] - P0[i, chiefs[i], 1]
        rr = np.hypot(u, v)
        nr = (float(rr.max()) if normalization_radius is None
              else float(normalization_radius))
        basis = zernike_nm_seq(nms, torch.as_tensor(rr / nr),
                               torch.as_tensor(np.arctan2(v, u)), norm=norm)
        out[i] = np.moveaxis(basis.numpy(), 0, -1)
        uv_out[i] = np.stack([u, v])
    return out, uv_out


def merged_trace(system, fields=None, wavelengths=None, sampling=None, *,
                 epd=None, device=None):
    """One wide-batch trace per wavelength: all fields' rays merged.

    Returns (wavelengths, results) where results[w] is the RayTraceResult
    of the (F*N)-ray merged bundle; reshape leading ray axes with
    ``unmerge`` below.  Histories stay on ``device`` (default
    ``config.device``).
    """
    fields = _resolve_fields(system, fields)
    wavelengths = _resolve_wavelengths(system, wavelengths)
    sampling = Sampling.hex(nrings=6) if sampling is None else sampling
    surfaces = compiled_surfaces(system)
    dev = resolve_device(device)
    results = []
    for wvl in wavelengths:
        P, S = _host_launches(system, fields, float(wvl), sampling, epd)
        F, N = P.shape[:2]
        # upload once per wavelength
        results.append(raytrace(surfaces, torch.as_tensor(P.reshape(F * N, 3), device=dev),
                                torch.as_tensor(S.reshape(F * N, 3), device=dev), float(wvl)))
    return wavelengths, results


def unmerge(history, F):
    """(n_surf, F*N, ...) -> (n_surf, F, N, ...)."""
    h = history if torch.is_tensor(history) else torch.as_tensor(history)
    n_surf, FN = h.shape[:2]
    return h.reshape(n_surf, F, FN // F, *h.shape[2:])


def fit_from_trace(P_end, S_end, OPL, alive, A, ramps, chief_onehot,
                   P_xp, n_image, reduce_rays=lambda x: x):
    """Masked Zernike normal-equation fit from merged-trace outputs.

    Chief-ray quantities are gathered through one-hot sums rather than
    indexing, and every ray-axis contraction funnels through
    ``reduce_rays``: identity serially; an all-reduce over the ray axis
    in a sharded path, where each device holds a slice of the ray axis
    and the chief may live on another shard.  The two paths agree because
    the one-hot products contribute exact zeros off the chief.
    """
    # (F, 3) chief landing point; (F,) chief path total.  Dead rays carry
    # NaN histories; select-before-multiply keeps the 0 * NaN products out
    # of the one-hot sums.
    chief_mask = chief_onehot > 0
    center = reduce_rays(torch.einsum(
        'fn,fnc->fc', chief_onehot,
        torch.where(chief_mask[..., None], P_end, 0.0)))
    if P_xp is None:
        kappa = torch.zeros(P_end.shape[0], dtype=P_end.dtype, device=P_end.device)
    else:
        R = torch.linalg.norm(P_xp[None] - center, dim=-1)
        kappa = 1.0 / R
    s, _ = eic_closing(P_end, S_end, center[:, None, :], kappa[:, None])
    total = OPL + n_image * s
    chief_total = reduce_rays(torch.einsum(
        'fn,fn->f', chief_onehot, torch.where(chief_mask, total, 0.0)))
    opd = total - chief_total[:, None] + ramps
    # masked normal equations: dead (and pad) rays weight zero
    w = alive.to(opd.dtype)
    opd0 = torch.where(alive, opd, 0.0)
    Aw = A * w[..., None]
    G = reduce_rays(torch.einsum('fnk,fnl->fkl', Aw, A))
    b = reduce_rays(torch.einsum('fnk,fn->fk', Aw, opd0))
    coefs = torch.linalg.solve(G, b[..., None])[..., 0]
    fit = torch.einsum('fnk,fk->fn', A, coefs)
    err2 = torch.where(alive, (opd0 - fit) ** 2, 0.0)
    rms = torch.sqrt(reduce_rays(err2.sum(dim=1))
                     / reduce_rays(w.sum(dim=1)))
    return coefs, rms


class WavefrontFitPlan(namedtuple('WavefrontFitPlan', 'wvl P S A ramps chiefs P_xp n_image')):
    """The host half of ``device_wavefront_fit`` for one wavelength.

    The launch bundles P, S (F, N, 3), the Zernike design matrices A
    (F, N, K), the field-tilt ramps (F, N), the chief indices (F,), the
    exit-pupil point (or None) and the image-space index, all host float64.
    """


def plan_wavefront_fit(system, nms, wvl, fields, sampling, *, epd=None, norm=True,
                       normalization_radius=None):
    """Plan one wavelength of ``device_wavefront_fit`` on the host.

    Launches every field (real aiming when the system asks for it), builds
    the design matrices and ramps, and resolves the exit pupil.
    """
    P, S = _host_launches(system, fields, wvl, sampling, epd)
    chiefs = _chief_indices(P)
    ramps = _tilt_ramps(fields, P, chiefs)
    A, _ = _design_matrices(P, chiefs, nms, norm, normalization_radius)
    xp = system.exit_pupil(wvl) if hasattr(system, 'exit_pupil') else None
    P_xp = None if xp is None else np.asarray(xp, dtype=_PREC)
    return WavefrontFitPlan(wvl, P, S, A, ramps, chiefs, P_xp,
                            float(trace_context(system, wvl).n_image))


def fit_planned(surfaces, plan, device=None):
    """(coefs (F, K), rms (F,)) of one planned wavelength: one merged trace of
    the plan's bundles on ``device``, then ``fit_from_trace``."""
    dev = resolve_device(device)
    F, N = plan.P.shape[:2]
    chief_onehot = np.zeros((F, N), dtype=_PREC)
    chief_onehot[np.arange(F), plan.chiefs] = 1.0
    Pt, St, At, rt, ct = (torch.as_tensor(a, device=dev)
                          for a in (plan.P, plan.S, plan.A, plan.ramps, chief_onehot))
    res = raytrace(surfaces, Pt.reshape(F * N, 3), St.reshape(F * N, 3), plan.wvl)
    return fit_from_trace(
        res.P[-1].reshape(F, N, 3), res.S[-1].reshape(F, N, 3),
        res.OPL.sum(dim=0).reshape(F, N),
        (res.status.imag == 0).reshape(F, N),
        At.to(res.P.dtype), rt.to(res.P.dtype), ct.to(res.P.dtype),
        None if plan.P_xp is None
        else torch.as_tensor(plan.P_xp, dtype=res.P.dtype, device=dev),
        plan.n_image)


def device_wavefront_fit(system, nms, fields=None, wavelengths=None,
                         sampling=None, *, epd=None, norm=True,
                         normalization_radius=None, device=None):
    """Zernike coefficients for every (wavelength, field), as tensor work.

    For each wavelength, one merged trace of all fields' rays, closed on
    the chief-image reference sphere (EIC closing, curvature from the
    exit pupil), with the launch-plane field-tilt ramp applied and the
    masked Zernike normal equations solved.  Dead rays weight zero in the
    fit; there are no host reads between launch and the coefficients.
    The host half is ``plan_wavefront_fit``, the tensor half
    ``fit_planned``.

    Returns (coefs, rms) with shapes (W, F, K) and (W, F), on ``device``
    (default ``config.device``).  For an OpticalSystem the exit pupil comes
    from ``system.exit_pupil``; a bare surface sequence closes on the
    telecentric (kappa = 0) limit.
    """
    fields = _resolve_fields(system, fields)
    wavelengths = _resolve_wavelengths(system, wavelengths)
    sampling = Sampling.hex(nrings=6) if sampling is None else sampling
    surfaces = compiled_surfaces(system)

    coef_out, rms_out = [], []
    for wvl in wavelengths:
        plan = plan_wavefront_fit(system, nms, float(wvl), fields, sampling, epd=epd, norm=norm,
                                  normalization_radius=normalization_radius)
        c, r = fit_planned(surfaces, plan, device)
        coef_out.append(c)
        rms_out.append(r)
    return torch.stack(coef_out), torch.stack(rms_out)


__all__ = ['device_wavefront_fit', 'fit_from_trace', 'fit_planned', 'merged_trace',
           'plan_wavefront_fit', 'unmerge', 'WavefrontFitPlan']
