"""Distributed FFT focus/unfocus: pupils sharded over mesh rows.

Counterpart of ``prysm_tpu/parallel/fft.py``.  The single-card ``focus``
is the ortho-normalised shift sandwich ``fftshift(fft2(ifftshift(pad(E))))``.
For even N, ``fftshift(fft(ifftshift(x)))[j] = s * (-1)^j * FFT[(-1)^m x[m]][j]``
with ``s = (-1)^(N/2)``: the shifts become local checkerboard sign
multiplies (a literal roll of a sharded axis would be a collective per
shift), and the only communication is two all-to-all transposes:

1. pad + checkerboard along the (fully local) column axis, column FFT;
2. ``all_to_all`` transpose -> full columns local;
3. pad + checkerboard along rows, row FFT, row output signs;
4. ``all_to_all`` back -> rows sharded again; column output signs + norm.

The backward of an all-to-all is the opposite all-to-all, so autograd's
backward moves as many bytes as the forward.
"""
import math

import numpy as np
import torch

from ..conf import numpy_dtype
from ..fttools import _pad_split
from ._collectives import all_to_all, axis_size, enter, psum, shard
from .mesh import mesh_device

__all__ = ['plan_distributed_focus', 'plan_distributed_unfocus', 'shard_focus_grad_step']


def _checkerboard(n, dtype):
    """(-1)^index along one axis, host-built."""
    return np.where(np.arange(n) % 2 == 0, 1.0, -1.0).astype(dtype)


def _axis_sign(n):
    """The global sign s = (-1)^(n/2) of the centered-FFT identity."""
    if n % 2:
        raise ValueError(f'distributed centered FFTs need even sizes, got {n}')
    return 1.0 if (n // 2) % 2 == 0 else -1.0


def _pad_axis(block, dim, target):
    """FFT-aligned symmetric zero pad of one axis (the split of pad2d)."""
    n = block.shape[dim]
    if n == target:
        return block
    before, after = _pad_split(target - n)
    pads = [0, 0] * block.ndim
    # torch's pad lists the last axis first
    pads[2 * (block.ndim - 1 - dim)] = before
    pads[2 * (block.ndim - 1 - dim) + 1] = after
    return torch.nn.functional.pad(block, pads)


def _np_dtype(dtype):
    return numpy_dtype(dtype) if isinstance(dtype, torch.dtype) else np.dtype(dtype)


def _local_focus(mesh, shape, Q, axis, inverse, dtype):
    """rows -> this rank's rows of the padded focal field, for E's (Ny/d, Nx) block."""
    d = axis_size(mesh, axis)
    Ny, Nx = shape
    My, Mx = math.ceil(Ny * Q), math.ceil(Nx * Q)
    for n, label in ((Ny, 'Ny'), (My, 'padded Ny'), (Mx, 'padded Nx')):
        if n % d:
            raise ValueError(f'{label}={n} does not divide over {d} devices on axis {axis!r}')
    npdt = _np_dtype(dtype)
    dev = mesh_device(mesh)

    def sign(v):
        return torch.from_numpy(v).to(dev)

    col_in = sign(_checkerboard(Mx, npdt))
    col_out = sign(_checkerboard(Mx, npdt) * _axis_sign(Mx))
    row_in = sign(_checkerboard(My, npdt))
    row_out = sign(_checkerboard(My, npdt) * _axis_sign(My))
    norm = math.sqrt(My * Mx) if inverse else 1.0 / math.sqrt(My * Mx)
    fft = torch.fft.ifft if inverse else torch.fft.fft

    def local(E_rows):
        a = _pad_axis(E_rows, 1, Mx)
        a = fft(a * col_in[None, :], dim=1)
        # transpose: full columns local, rows split -> (Ny, Mx/d)
        a = all_to_all(a, mesh, axis, split_axis=1, concat_axis=0)
        a = _pad_axis(a, 0, My)
        a = fft(a * row_in[:, None], dim=0) * row_out[:, None]
        # transpose back: rows sharded again -> (My/d, Mx)
        a = all_to_all(a, mesh, axis, split_axis=0, concat_axis=1)
        return a * col_out[None, :] * norm

    return local


def plan_distributed_focus(mesh, shape, Q, *, axis='fy', inverse=False, dtype=np.float32):
    """Build a sharded focus (or unfocus) over ``mesh``.

    shape: the unpadded logical pupil shape (Ny, Nx), both even; Ny and
    the padded sizes must divide over ``axis``.  Q: the padding factor,
    as in ``focus``.  inverse: build ``unfocus`` instead.  dtype: the real
    dtype of the sign vectors (numpy or torch; match the field's).

    Returns apply(E) taking the whole (Ny, Nx) complex pupil and returning
    THIS rank's (QNy/d, QNx) rows of the padded focal field; the blocks in
    rank order are ``propagation.fft.focus(E, Q)`` (``unfocus``).
    """
    local = _local_focus(mesh, shape, Q, axis, inverse, dtype)

    def apply(E):
        return local(shard(enter(E, mesh, axis), mesh, axis, 0, 'Ny'))

    return apply


def plan_distributed_unfocus(mesh, shape, Q, *, axis='fy', dtype=np.float32):
    """Sharded ``unfocus`` (inverse centered transform); see
    :func:`plan_distributed_focus`."""
    return plan_distributed_focus(mesh, shape, Q, axis=axis, inverse=True, dtype=dtype)


def shard_focus_grad_step(mesh, shape, Q, *, axis='fy', dtype=np.float32):
    """A sharded PSF data-consistency step through the focus FFT.

    loss(E) = sum((|focus(E)|^2 - I_meas)^2).  Returns
    step(E_re, E_im, I_meas) -> (loss, (dE_re, dE_im)): the arguments are
    the whole logical (Ny, Nx) planes and (QNy, QNx) image, the loss is
    replicated, and the cotangents are THIS rank's (Ny/d, Nx) row blocks.
    The field travels as real planes, so no complex-gradient convention
    enters.
    """
    local = _local_focus(mesh, shape, Q, axis, False, dtype)

    def step(E_re, E_im, I_meas):
        re, im = (shard(p, mesh, axis, 0, 'Ny').detach().requires_grad_(True)
                  for p in (E_re, E_im))
        I_rows = shard(I_meas, mesh, axis, 0, 'padded Ny')
        with torch.enable_grad():
            F = local(torch.complex(re, im))
            resid = F.real * F.real + F.imag * F.imag - I_rows
            loss = psum(torch.sum(resid * resid), mesh, axis)
            grads = torch.autograd.grad(loss, (re, im))
        return loss.detach(), grads

    return step
