"""A bilinear warp on fixed grids, planned once, with a sort-free backward kernel.

``coordinates.warp`` pulls each output sample from four source samples
(``_bilinear_lookup``), and autograd's backward of its four advanced-index
gathers is a deterministic ``index_put(accumulate=True)``: on the card it
computes linear indices, radix-sorts them and scatters, four times a call.
For the DM's fold that backward was 1.53 of the wavefront-control step's
2.28 ms of device work at 1024^2.  A DM's projection grids are fixed when
it is built, so which source samples an output sample pulls from, with
which weights, and which outputs fall outside the source grid need not be
found again on each call.  ``WarpPlan`` holds them, built once on the
grids' device:

* the forward taps: per output sample the four clamped source indices (in
  ``_bilinear_lookup``'s corner order: (r0, c0), (r0, c0 + 1), (r0 + 1, c0),
  (r0 + 1, c0 + 1)), the fractions ``fr`` and ``fc`` and the ``inside`` mask;
* their transpose, padded ELL laid out (K, source samples): column j lists
  the taps that read source sample j as ``4 * output + corner``, in
  ascending order, then -1 in its padding slots.  Outputs outside the
  source grid are left out, since autograd's ``where`` gives them a zero
  cotangent; a tap inside whose weight happens to be 0 (``fr == 0`` on the
  fold's integer rows) is kept, because autograd multiplies it too, so a
  non-finite cotangent reaches the same source samples.

``warp_planned`` is one autograd Function.  Its forward gathers the four
taps and runs ``_bilinear_lookup``'s arithmetic in its order, so its output
equals ``coordinates.warp``'s bit for bit.  Its backward is
``csrc/warp.cu`` warp_bwd_kernel: one thread per source sample walks its
column and sums ``(g (1 - fr)) (1 - fc)``, ``(g (1 - fr)) fc``,
``(g fr) (1 - fc)`` or ``(g fr) fc``, each product formed as autograd forms
it.  Only the order of the sum differs from autograd's (which sums each
corner's scatter in output order, then the four corners), and it is fixed:
no atomics, no sort, the same bits from run to run.  The kernel replaces no
Pallas kernel: the JAX package leaves this transpose to XLA.

CUDA tensors launch the kernel; CPU tensors take ``warp_bwd_plain``, the
same walk in plain torch.  There is no fallback.
"""
import ctypes
from functools import lru_cache

import torch

from . import _cuda
from .zernike import _looped

__all__ = ['WarpPlan', 'warp_planned', 'warp_fwd', 'warp_bwd', 'warp_bwd_plain',
           'LAUNCHES', 'reset_launches']

# launches of the kernel wrapper, eager or captured; the plain version does not count
LAUNCHES = {'warp_bwd': 0}

_DTYPES = {torch.float32: 0, torch.float64: 1}


def reset_launches():
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class WarpPlan:
    """The taps of a bilinear pull from a ``src_shape`` image at fixed (rows, cols), and
    their transpose (the module's docstring says how they are laid out).

    Built from the grids with torch operations on their device and one stable sort;
    reading the transpose's depth K is the one host read.  The plan works in the
    grids' dtype.
    """

    def __init__(self, rows, cols, src_shape):
        nr, nc = (int(s) for s in src_shape)
        if rows.shape != cols.shape or rows.ndim != 2:
            raise ValueError('a warp plan takes 2-D rows and cols grids of one shape')
        nout = rows.numel()
        if 4 * nout >= 2 ** 31 or nr * nc >= 2 ** 31:
            raise ValueError('the warp plan counts taps and source samples in 32 bits')
        self.out_shape = tuple(rows.shape)
        self.src_shape = (nr, nc)
        # _bilinear_lookup's own derivation of the taps
        inside = (rows >= 0) & (rows <= nr - 1) & (cols >= 0) & (cols <= nc - 1)
        r0 = torch.floor(rows)
        c0 = torch.floor(cols)
        fr = rows - r0
        fc = cols - c0
        r0 = r0.long()
        c0 = c0.long()
        ri = (torch.clamp(r0, 0, nr - 1), torch.clamp(r0 + 1, 0, nr - 1))
        ci = (torch.clamp(c0, 0, nc - 1), torch.clamp(c0 + 1, 0, nc - 1))
        taps = torch.stack([ri[a] * nc + ci[b] for a in (0, 1) for b in (0, 1)])
        self.taps = taps.reshape(4, -1).to(torch.int32)
        self.inside = inside
        self.fr, self.fc = fr.reshape(-1).contiguous(), fc.reshape(-1).contiguous()
        self.fr1, self.fc1 = 1 - self.fr, 1 - self.fc
        # the transpose: the inside outputs' taps, numbered 4 * output + corner in
        # ascending order, stably sorted by the source sample each reads
        out = torch.nonzero(inside.reshape(-1)).reshape(-1)
        entry = (4 * out[:, None] + torch.arange(4, device=out.device)).reshape(-1)
        src = self.taps[:, out].T.reshape(-1).long()
        src, order = torch.sort(src, stable=True)
        entry = entry[order]
        nsrc = nr * nc
        counts = torch.bincount(src, minlength=nsrc)
        self.depth = int(counts.max()) if src.numel() else 0
        slot = torch.arange(src.numel(), device=src.device) - (torch.cumsum(counts, 0)
                                                              - counts)[src]
        table = torch.full((self.depth, nsrc), -1, dtype=torch.int32, device=src.device)
        table[slot, src] = entry.to(torch.int32)
        self.table = table

    @property
    def dtype(self):
        return self.fr.dtype

    @property
    def device(self):
        return self.fr.device


def _check(plan, x, shape, what):
    if tuple(x.shape) != shape or x.dtype != plan.dtype or x.device != plan.device:
        raise ValueError(f'the warp plan takes a {what} of shape {shape}, {plan.dtype} on '
                         f'{plan.device}, got {tuple(x.shape)} {x.dtype} on {x.device}')


def warp_fwd(plan, img):
    """The pull: the four taps gathered, then ``_bilinear_lookup``'s arithmetic in its
    order, so the result is ``coordinates.warp``'s bit for bit."""
    _check(plan, img, plan.src_shape, 'source image')
    v = img.reshape(-1).index_select(0, plan.taps.reshape(-1)).reshape(4, *plan.out_shape)
    fr, fc = plan.fr.view(plan.out_shape), plan.fc.view(plan.out_shape)
    fr1, fc1 = plan.fr1.view(plan.out_shape), plan.fc1.view(plan.out_shape)
    top = v[0] * fc1 + v[1] * fc
    bot = v[2] * fc1 + v[3] * fc
    out = top * fr1 + bot * fr
    return torch.where(plan.inside, out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# plain version (CPU tensors; the reference the kernel is held against)
# ---------------------------------------------------------------------------

def warp_bwd_plain(plan, g):
    """Plain version of warp_bwd_kernel: the source image's cotangent, on any device.

    Slot by slot down the transpose's columns, as a thread of the kernel walks
    its column: each real tap's product is added to its source sample's sum; a
    padding slot's is discarded by ``where`` and never enters the sum.
    """
    _check(plan, g, plan.out_shape, 'cotangent')
    g = g.reshape(-1)
    acc = torch.zeros(plan.table.shape[1], dtype=g.dtype, device=g.device)
    for k in range(plan.depth):
        e = plan.table[k].long()
        real = e >= 0
        e = torch.clamp(e, min=0)
        i, corner = e >> 2, e & 3
        a = torch.where(corner & 2 != 0, plan.fr[i], plan.fr1[i])
        b = torch.where(corner & 1 != 0, plan.fc[i], plan.fc1[i])
        acc = torch.where(real, acc + g[i] * a * b, acc)
    return acc.reshape(plan.src_shape)


# ---------------------------------------------------------------------------
# kernel wrapper (CUDA tensors)
# ---------------------------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@lru_cache(None)
def _lib():
    lib = _cuda.load('warp')
    lib.prysm_warp_bwd.argtypes = [_I, _P, _I, _LL, _P, _P, _P, _P, _P]
    lib.prysm_warp_bwd.restype = _I
    return lib


def _launch(plan, g):
    _check(plan, g, plan.out_shape, 'cotangent')
    if g.dtype not in _DTYPES:
        raise ValueError(f'the warp kernel takes float32 or float64, got {g.dtype}')
    g = g.contiguous()
    out = torch.empty(plan.src_shape, dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        rc = _lib().prysm_warp_bwd(_DTYPES[g.dtype], plan.table.data_ptr(), plan.depth,
                                   plan.table.shape[1], g.data_ptr(), plan.fr.data_ptr(),
                                   plan.fc.data_ptr(), out.data_ptr(),
                                   torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'warp_bwd launch failed with cudaError_t {rc}')
    LAUNCHES['warp_bwd'] += 1
    return out


def warp_bwd(plan, g):
    """The source image's cotangent: warp_bwd_kernel for CUDA tensors, its plain
    version for CPU tensors."""
    if g.device.type == 'cpu':
        return warp_bwd_plain(plan, g)
    if g.device.type != 'cuda':
        raise ValueError(f'the warp backward takes CUDA or CPU tensors, got {g.device}')
    return _launch(plan, g)


# ---------------------------------------------------------------------------
# the autograd Functions
# ---------------------------------------------------------------------------

class _WarpVJP(torch.autograd.Function):
    """The transpose of the warp at a cotangent.  Linear, so its own backward is the
    warp and its tangent is the transpose of the input's tangent."""

    @staticmethod
    def forward(g, plan):
        return warp_bwd(plan, g)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan = inputs[1]

    @staticmethod
    def backward(ctx, gg):
        return _Warp.apply(gg, ctx.plan), None

    @staticmethod
    def jvp(ctx, dg, _):
        return _WarpVJP.apply(dg, ctx.plan)

    @staticmethod
    def vmap(info, in_dims, g, plan):
        return _looped(_WarpVJP.apply, info, in_dims, g, plan)


class _Warp(torch.autograd.Function):
    """The planned warp: the forward as ``coordinates.warp`` computes it, the backward
    one kernel launch.  ``jvp``: the warp is linear, so the tangent is the warp of
    the input's tangent.  ``vmap``: one call per batch item."""

    @staticmethod
    def forward(img, plan):
        return warp_fwd(plan, img)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _WarpVJP.apply(g, ctx.plan), None

    @staticmethod
    def jvp(ctx, dimg, _):
        return _Warp.apply(dimg, ctx.plan)

    @staticmethod
    def vmap(info, in_dims, img, plan):
        return _looped(_Warp.apply, info, in_dims, img, plan)


def warp_planned(img, plan):
    """``coordinates.warp(img, xnew, ynew)`` for a 2-D ``img`` on the plan's fixed grids
    (``WarpPlan(ynew, xnew, img.shape)``), with the planned backward."""
    return _Warp.apply(img, plan)
