"""Sharded batched raytrace: the merged ray axis over a mesh axis.

Counterpart of ``prysm_tpu/parallel/raytrace.py``.  The merged (field x
ray) bundle of ``x/raytracing/batch.py`` shards over a mesh axis.  Rays are
independent through the trace, so the only communication is in the
wavefront fit: the chief-ray gather, the Zernike normal-equation Gram and
right-hand side, and the residual sums are all-reduces over the ray axis (a
handful of (F, K, K)-sized collectives after an arbitrarily large per-rank
trace).  ``shard_wavefront_fit`` reproduces ``device_wavefront_fit``: the
same fit (``batch.fit_from_trace``) with its ray reductions swapped from
identity to an all-reduce; pad rays carry zero weight.  Nothing here is
differentiated.  The trace runs in ``config.precision`` on the mesh's
device, as ``batch.fit_planned`` does.
"""
import numpy as np
import torch

from ..x.raytracing._resolve import compiled_surfaces
from ..x.raytracing._trace_grid import _resolve_fields, _resolve_wavelengths
from ..x.raytracing.batch import _host_launches, fit_from_trace, plan_wavefront_fit
from ..x.raytracing.launch import Sampling
from ..x.raytracing.spencer_and_murty import raytrace
from ._collectives import _groups, all_reduce_, axis_size, psum, shard
from .mesh import mesh_device

__all__ = ['shard_wavefront_fit', 'shard_merged_trace_rate']

_PREC = np.float64


def _pad_rays(arrays, N, n_shards):
    """Pad the ray axis (axis 1) up to a multiple of n_shards.

    Pad rays replicate ray 0 of their field (they trace fine) and are
    excluded from the fit by the weight mask.
    """
    Np = -(-N // n_shards) * n_shards
    if Np == N:
        return arrays, N
    pad = Np - N

    def pad_one(a):
        return np.concatenate([a, np.repeat(a[:, :1], pad, axis=1)], axis=1)

    return [pad_one(a) for a in arrays], Np


def _default_axis(mesh, axis):
    return axis or mesh.mesh_dim_names[-1]


def _local_rays(arrays, mesh, axis, dev):
    """This rank's block of each host (F, N, ...) array along the ray axis, on ``dev``
    (only the block is uploaded)."""
    return [shard(torch.from_numpy(a), mesh, axis, 1, 'ray count').to(dev) for a in arrays]


def shard_wavefront_fit(mesh, system, nms, fields=None, wavelengths=None, sampling=None, *,
                        axis=None, epd=None, norm=True, normalization_radius=None):
    """Zernike coefficients per (wavelength, field), rays sharded over the mesh.

    axis defaults to the mesh's last axis name.  Returns (coefs, rms) with
    shapes (W, F, K) and (W, F), replicated, matching device_wavefront_fit.
    """
    axis = _default_axis(mesh, axis)
    n_shards = axis_size(mesh, axis)
    groups = _groups(mesh, axis)
    dev = mesh_device(mesh)
    fields = _resolve_fields(system, fields)
    wavelengths = _resolve_wavelengths(system, wavelengths)
    sampling = Sampling.hex(nrings=6) if sampling is None else sampling
    surfaces = compiled_surfaces(system)

    def reduce_rays(x):
        return all_reduce_(x.contiguous(), groups)

    coef_out, rms_out = [], []
    for wvl in wavelengths:
        plan = plan_wavefront_fit(system, nms, float(wvl), fields, sampling, epd=epd,
                                  norm=norm, normalization_radius=normalization_radius)
        F, N = plan.P.shape[:2]
        (P, S, A, ramps), Np = _pad_rays([plan.P, plan.S, plan.A, plan.ramps], N, n_shards)
        # masks are padded with ZEROS, never replicated: a pad ray must
        # not double the chief weight nor enter the fit
        chief_onehot = np.zeros((F, Np), dtype=_PREC)
        chief_onehot[np.arange(F), plan.chiefs] = 1.0
        valid = np.zeros((F, Np), dtype=bool)
        valid[:, :N] = True
        Pl, Sl, Al, rl, cl, vl = _local_rays((P, S, A, ramps, chief_onehot, valid), mesh, axis,
                                             dev)
        Nl = Np // n_shards
        res = raytrace(surfaces, Pl.reshape(F * Nl, 3), Sl.reshape(F * Nl, 3), plan.wvl)
        dtype = res.P.dtype
        c, r = fit_from_trace(
            res.P[-1].reshape(F, Nl, 3), res.S[-1].reshape(F, Nl, 3),
            res.OPL.sum(dim=0).reshape(F, Nl),
            (res.status.imag == 0).reshape(F, Nl) & vl,
            Al.to(dtype), rl.to(dtype), cl.to(dtype),
            None if plan.P_xp is None else torch.as_tensor(plan.P_xp, dtype=dtype, device=dev),
            plan.n_image, reduce_rays=reduce_rays)
        coef_out.append(c)
        rms_out.append(r)
    return torch.stack(coef_out), torch.stack(rms_out)


def shard_merged_trace_rate(mesh, system, wavelength, sampling=None, *, axis=None, epd=None):
    """One sharded merged trace; returns (summed landing coordinates, ray-surfaces).

    The throughput witness of the sharded trace: every rank traces its
    slice of the merged bundle (pad rays included, as in the JAX package),
    one psum closes the result.
    """
    axis = _default_axis(mesh, axis)
    n_shards = axis_size(mesh, axis)
    dev = mesh_device(mesh)
    fields = _resolve_fields(system, None)
    sampling = Sampling.hex(nrings=6) if sampling is None else sampling
    surfaces = compiled_surfaces(system)
    P, S = _host_launches(system, fields, float(wavelength), sampling, epd)
    F, N = P.shape[:2]
    (P, S), Np = _pad_rays([P, S], N, n_shards)
    Pl, Sl = _local_rays((P, S), mesh, axis, dev)
    res = raytrace(surfaces, Pl.reshape(-1, 3), Sl.reshape(-1, 3), float(wavelength))
    landed = psum(torch.nan_to_num(res.P[-1]).sum(dim=0), mesh, axis)
    return landed, F * Np * len(surfaces)
