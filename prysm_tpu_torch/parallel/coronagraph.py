"""Mesh-sharded multi-resolution coronagraph propagation.

Counterpart of ``prysm_tpu/parallel/coronagraph.py``.  The levels of a
multi-resolution focal stack are independent windowed round trips until one
final sum, so they shard over a mesh axis and the level sum is one
``psum``.  The serial oracle is
``propagation.coronagraph.to_fpm_and_back_multiresolution``.

Masks and windows depend only on static geometry, so ``window * fpm`` is
evaluated per level when the stack is built; a call is two batched complex
matmul pairs plus the collective.  Unlike the JAX package's real/imaginary
leaf pairs, ``StackedMultiRes`` holds complex tensors, as the port's plans
do.
"""
from dataclasses import dataclass

import torch

from ._collectives import axis_size, enter, psum, shard

__all__ = ['StackedMultiRes', 'stack_multiresolution', 'multires_roundtrip',
           'shard_multires_roundtrip', 'shard_multires_babinet']


@dataclass(frozen=True)
class StackedMultiRes:
    """All levels of a MultiResolutionExecutor stacked on a leading axis.

    Ex (L, Mx, Nx), Ey (L, My, Ny) complex; norm (L,) real; maskwin
    (L, My, Mx) complex: the per-level ``window * fpm`` focal-plane factor.
    """

    Ex: torch.Tensor
    Ey: torch.Tensor
    norm: torch.Tensor
    maskwin: torch.Tensor

    def __len__(self):
        """Number of levels."""
        return self.Ex.shape[0]


def _complex_dtype(dtype, default):
    if dtype is None:
        return default
    return dtype if dtype.is_complex else dtype.to_complex()


def stack_multiresolution(mre, fpm, *, babinet=False, dtype=None):
    """StackedMultiRes from a MultiResolutionExecutor and a mask callable.

    Requires every level to share one focal shape (build the executor
    with fine_samples == focal_samples); babinet=True bakes the 1 - fpm
    complement in, for use behind a Lyot-style subtraction.  ``fpm`` is
    called with each level's focal grids (tensors), as in the serial
    path; ``dtype`` (a torch dtype, real or complex) sets the stack's
    complex dtype, by default the plans'.
    """
    shapes = {(tuple(ex.Ey.shape), tuple(ex.Ex.shape)) for ex in mre.executors}
    if len(shapes) != 1:
        raise ValueError(
            'stack_multiresolution requires uniform level shapes; build '
            'the executor with fine_samples == focal_samples '
            f'(got {sorted(shapes)})')
    cdtype = _complex_dtype(dtype, mre.executors[0].Ex.dtype)
    Ex = torch.stack([ex.Ex for ex in mre.executors]).to(cdtype)
    Ey = torch.stack([ex.Ey for ex in mre.executors]).to(cdtype)
    norm = torch.tensor([ex.norm for ex in mre.executors], dtype=torch.float64)
    mws = []
    for win, xf, yf in zip(mre.windows, mre.xf, mre.yf):
        m = fpm(xf, yf)
        if babinet:
            m = 1 - m
        mws.append(m * win)
    return StackedMultiRes(Ex=Ex, Ey=Ey, norm=norm.to(Ex.device, cdtype.to_real()),
                           maskwin=torch.stack(mws).to(cdtype))


def multires_roundtrip(a, plan):
    """Sum of windowed per-level round trips over the plan's levels.

    Equal to to_fpm_and_back_multiresolution when plan holds every level;
    on one rank's levels it is that rank's partial sum.
    """
    a = a.to(plan.Ex.dtype)
    nrm = plan.norm[:, None, None]
    focal = torch.matmul(torch.matmul(plan.Ey, a), plan.Ex.transpose(-1, -2)) * nrm
    gated = focal * plan.maskwin
    back = torch.matmul(torch.matmul(plan.Ey.conj().transpose(-1, -2), gated), plan.Ex.conj())
    return (back * nrm).sum(dim=0)


def _local_levels(plan, mesh, lvl_axis):
    def lv(x):
        return shard(x, mesh, lvl_axis, 0, 'level count')

    return StackedMultiRes(Ex=lv(plan.Ex), Ey=lv(plan.Ey), norm=lv(plan.norm),
                           maskwin=lv(plan.maskwin))


def shard_multires_roundtrip(mesh, plan, lvl_axis='lv'):
    """a -> c with levels sharded over ``lvl_axis``.

    Each rank round-trips its levels; the level sum is one psum and the
    result is replicated.  The level count must divide over the axis.
    """
    n_shard = axis_size(mesh, lvl_axis)
    if len(plan) % n_shard:
        raise ValueError(f'{len(plan)} levels do not divide over {n_shard} '
                         f'devices on axis {lvl_axis!r}')
    local = _local_levels(plan, mesh, lvl_axis)

    def apply(a):
        return psum(multires_roundtrip(enter(a, mesh, lvl_axis), local), mesh, lvl_axis)

    return apply


def shard_multires_babinet(mesh, plan, lyot, lvl_axis='lv'):
    """a -> field_after_lyot for a Babinet-style Lyot coronagraph.

    ``plan`` must be stacked with babinet=True (the 1 - fpm complement).
    The complement round trip c is psum'd over the level axis and the
    subtraction a - c with the Lyot stop runs replicated.
    """
    roundtrip = shard_multires_roundtrip(mesh, plan, lvl_axis=lvl_axis)
    if lyot is not None and not torch.is_tensor(lyot):
        lyot = torch.as_tensor(lyot, device=plan.Ex.device)

    def babinet_fn(a):
        field_at_lyot = a - roundtrip(a)
        if lyot is None:
            return field_at_lyot
        return lyot * field_at_lyot

    return babinet_fn
