"""Coefficient-gradient all-reduce overlapped with the backward pass.

Counterpart of ``prysm_tpu/parallel/overlap.py``.  Sharded over a mesh, the
coefficient gradient's reduction is an all-reduce that naively waits for
the whole backward pass.  Here each rank splits its wavelengths into
``n_chunks`` independent slices; each slice runs its own forward and
backward, and its gradient all-reduce is issued (``async_op=True``) as soon
as its backward ends, so chunk k's reduction runs on the process group's
stream while chunk k+1 computes.  All reductions are awaited at the end,
and the loss reduction comes last.  This is torch's form of the JAX
module's barrier chain, which keeps XLA's combiner from merging the
per-chunk psums; the JAX module's HLO readers (``overlap_evidence``,
``interleaved_compute``) have no torch counterpart and are not ported.
"""
import math

import torch
import torch.distributed as dist

from ..mathops import cis
from ._collectives import _groups, all_reduce_, shard
from .broadband import SpectralMDFT
from .sharding import _abs2

__all__ = ['overlapped_spectral_grad']


def overlapped_spectral_grad(mesh, plan, amp, modes, wavelengths, weights, I_meas,
                             n_chunks=2, wl_axis='wl'):
    """A sharded broadband gradient step with one all-reduce per chunk.

    The W wavelengths shard over ``wl_axis``; each rank splits its local
    wavelengths into ``n_chunks`` slices whose data terms are independent
    (per-wavelength residuals against per-wavelength measured frames,
    I_meas of shape (W, My, Mx)):
    loss = sum_w weights[w] * sum((|E_w|^2 - I_meas[w])^2).

    Returns step(coefs) -> (loss, grad), both replicated, equal to a
    single monolithic reduction (floating-point reassociation aside).
    """
    groups = _groups(mesh, wl_axis)

    def wl(x):
        return shard(x, mesh, wl_axis, 0, 'wavelength count')

    local = SpectralMDFT(Ex=wl(plan.Ex), Ey=wl(plan.Ey), norm=wl(plan.norm),
                         pupil_dx=plan.pupil_dx, focal_dx=plan.focal_dx)
    wl_local, w_local, I_local = wl(wavelengths), wl(weights), wl(I_meas)
    W_loc = wl_local.shape[0]
    if W_loc % n_chunks:
        raise ValueError(f'local wavelength count {W_loc} does not split into '
                         f'{n_chunks} chunks')
    size = W_loc // n_chunks
    chunks = []
    for k in range(n_chunks):
        sl = slice(k * size, (k + 1) * size)
        chunks.append((SpectralMDFT(Ex=local.Ex[sl], Ey=local.Ey[sl], norm=local.norm[sl]),
                       wl_local[sl], w_local[sl], I_local[sl]))

    def chunk_loss(c, p, wvls, wts, I_chunk):
        opd = torch.tensordot(c, modes, dims=([0], [0]))
        scale = 2 * math.pi / (wvls * 1e3)
        fields = amp[None] * cis(scale[:, None, None] * opd[None])
        resid = _abs2(p(fields)) - I_chunk
        return torch.sum(wts[:, None, None] * resid * resid)

    def step(coefs):
        losses, grads, pending = [], [], []
        for chunk in chunks:
            c = coefs.detach().requires_grad_(True)
            with torch.enable_grad():
                lk = chunk_loss(c, *chunk)
                gk, = torch.autograd.grad(lk, c)
            # this chunk's reduction runs while the next chunk computes
            pending.append(dist.all_reduce(gk, group=groups[0], async_op=True))
            losses.append(lk.detach())
            grads.append(gk)
        for work in pending:
            work.wait()
        loss = all_reduce_(torch.stack(losses).sum(), groups)
        return loss, torch.stack(grads).sum(dim=0)

    return step
