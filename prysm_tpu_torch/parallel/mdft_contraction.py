"""Distributed matrix DFT: shard the contraction (pupil row) axis.

Counterpart of ``prysm_tpu/parallel/mdft_contraction.py``.
``out = norm * Ey @ a @ Ex.T`` contracts over the pupil rows, so each rank
holds a horizontal slab of the pupil and the matching columns of ``Ey``;
the partial products combine with one ``psum``.  This is the layout for
pupils too large for one card: the focal result is replicated, the pupil
never is.

The pupil comes in whole on every rank and enters the rank-local product
through ``enter``: its gradient is summed over the axis and equals the
serial one.  In the round trip the replicated focal field feeds each
rank's back-projection, so it passes through ``enter`` as well (JAX's
``shard_map`` inserts the same broadcast, whose transpose is a psum).
"""
import numpy as np
import torch

from ._collectives import axis_size, enter, psum, shard

__all__ = ['shard_mdft_contraction', 'shard_mdft_contraction_roundtrip']


def _check_rows(mesh, plan, axis):
    n_shard = axis_size(mesh, axis)
    Ny = plan.Ey.shape[1]
    if Ny % n_shard:
        raise ValueError(f'pupil row count {Ny} does not divide over {n_shard} '
                         f'devices on axis {axis!r}')


def _partial_focal(a, plan, mesh, axis):
    """(this rank's pupil rows, its Ey columns, the replicated focal field)."""
    rows = shard(enter(a, mesh, axis), mesh, axis, 0, 'pupil row count')
    Ey_cols = shard(plan.Ey, mesh, axis, 1, 'pupil row count')
    partial = torch.matmul(Ey_cols, rows.to(Ey_cols.dtype))
    return Ey_cols, torch.matmul(psum(partial, mesh, axis), plan.Ex.T) * plan.norm


def shard_mdft_contraction(mesh, plan, axis='ct'):
    """pupil -> focal apply with the pupil rows sharded over ``axis``.

    plan: an fttools.MDFT.  Returns apply(a) taking the whole (Ny, Nx)
    pupil and returning the replicated (My, Mx) focal field.  Ny must
    divide over the axis.
    """
    _check_rows(mesh, plan, axis)

    def apply(a):
        return _partial_focal(a, plan, mesh, axis)[1]

    return apply


def shard_mdft_contraction_roundtrip(mesh, plan, focal_factor=None, axis='ct'):
    """pupil -> focal -> (factor) -> pupil round trip, pupil rows sharded.

    focal_factor: an optional (My, Mx) array multiplied at the focal plane
    (a mask, a window), moved to the plan's device once.  Returns apply(a)
    taking the whole (Ny, Nx) pupil and returning THIS rank's (Ny/d, Nx)
    block of the result: the adjoint leg needs no second collective, the
    focal field being replicated.
    """
    _check_rows(mesh, plan, axis)
    ff = None
    if focal_factor is not None:
        if not torch.is_tensor(focal_factor):
            focal_factor = torch.as_tensor(np.asarray(focal_factor))
        ff = focal_factor.to(device=plan.Ex.device, dtype=plan.Ex.dtype)

    def apply(a):
        Ey_cols, focal = _partial_focal(a, plan, mesh, axis)
        if ff is not None:
            focal = focal * ff
        focal = enter(focal, mesh, axis)
        back = torch.matmul(focal, plan.Ex.conj()) * plan.norm
        return torch.matmul(Ey_cols.conj().T, back)

    return apply
