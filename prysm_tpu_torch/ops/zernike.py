"""Fused Zernike mode synthesis: CUDA kernels, their plain versions, one autograd Function.

Counterpart of ``prysm_tpu/ops/zernike.py``.  ``zernike_sum_pallas``
computes ``sum_k coefs[k] * Z_{nms[k]}(r, t)`` without materializing the
(K, N, N) mode stack, with exact gradients:

* forward: ``csrc/zernike.cu`` zernike_kernel in mode kFwd (replaces
  ``_fwd_kernel``);
* ``grads='coefs'`` backward: mode kCoefs, one launch (replaces
  ``_bwd_coefs_kernel``); the r and t cotangents are declared zero;
* ``grads='all'`` backward: mode kAll, one launch (replaces ``_bwd_kernel``).

The host side of a launch lives here: the plan compiled to the kernel's
walk program (``_program``), the compiled program size that runs it
(``_bucket``), a program longer than the largest cut into pieces, one
launch each (``_chunks``), each packed as the kernel's by-value parameter
(``_params``), the pixel partition (``_span``) and the per-stream ticket
of the coefficient reduction (``_ticket``).

The choice is made on the tensors' device: CUDA tensors launch the
kernels, CPU tensors take the plain PyTorch versions below.  There is no
mode switch and no fallback: on CUDA the wrapper launches or raises.

Dtypes follow the JAX wrapper on the card: the kernels take float32 and
cast r, t and coefs to it; the output and cotangents are float32 and the
autograd Function casts the cotangents back to the inputs' dtypes.  The
plain versions compute in the inputs' own floating dtype, so the float64
CPU tests hold them to float64 oracles.
"""
import ctypes
import itertools
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import _cuda
from ..polynomials.jacobi import recurrence_abc
from ..polynomials.zernike import zernike_norm

__all__ = ['zernike_sum_pallas', 'zernike_fwd', 'zernike_bwd_coefs',
           'zernike_bwd_all', 'zernike_fwd_plain', 'zernike_bwd_coefs_plain',
           'zernike_bwd_all_plain', 'LAUNCHES', 'reset_launches']

# launches of each kernel wrapper; the plain versions do not count
LAUNCHES = {'zernike_fwd': 0, 'zernike_bwd_coefs': 0, 'zernike_bwd_all': 0}


def reset_launches():
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class ZernikePlan(NamedTuple):
    """Host-side mode table, sorted by (|m|, n_j); the kernels' layout.

    groups: (|m|, n_max, first slot, end slot, first abc row) per unique |m|
    modes:  (coefficient index, n_j, +1 cos / -1 sin) per slot
    weights: norm factor per slot
    abc: Jacobi (A, B, C) = recurrence_abc(n, 0, |m|), n < n_max, per group
    """
    groups: tuple
    modes: tuple
    weights: tuple
    abc: tuple


@lru_cache(256)
def _plan(nms, norm):
    entries = sorted(
        ((abs(m), (n - abs(m)) // 2, 1 if m >= 0 else -1, idx,
          zernike_norm(n, m) if norm else 1.0)
         for idx, (n, m) in enumerate(nms)),
        key=lambda e: e[:2])  # stable: ties keep coefficient order
    groups, abc = [], []
    slot = 0
    for am, members in itertools.groupby(entries, key=lambda e: e[0]):
        members = list(members)
        nmax = max(e[1] for e in members)
        groups.append((am, nmax, slot, slot + len(members), len(abc)))
        abc.extend(recurrence_abc(n, 0, am) for n in range(nmax))
        slot += len(members)
    return ZernikePlan(groups=tuple(groups),
                       modes=tuple((e[3], e[1], e[2]) for e in entries),
                       weights=tuple(e[4] for e in entries),
                       abc=tuple(abc))


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; the reference the kernels are held against)
# ---------------------------------------------------------------------------

def _walk(plan, r, t, with_der=False):
    """Yield (slot, |m|, Z, dZ/dr, dZ/dt) per mode, in the kernels' order and arithmetic."""
    x = 2 * (r * r) - 1
    four_r = 4 * r
    c1, s1 = torch.cos(t), torch.sin(t)
    ca, sa = torch.ones_like(r), torch.zeros_like(r)
    ram = ram_m1 = torch.ones_like(r)
    cur = 0
    for am, nmax, j, end, ab in plan.groups:
        while cur < am:
            ca, sa = ca * c1 - sa * s1, sa * c1 + ca * s1
            ram_m1, ram = ram, ram * r
            cur += 1
        P, Pp = torch.ones_like(r), torch.zeros_like(r)
        D, Dp = torch.zeros_like(r), torch.zeros_like(r)
        for n in range(nmax + 1):
            while j < end and plan.modes[j][1] == n:
                dZdr = dZdt = None
                if am == 0:
                    Z = P
                    if with_der:
                        dZdr = D * four_r
                else:
                    cosine = plan.modes[j][2] > 0
                    az = ca if cosine else sa
                    Z = P * (ram * az)
                    if with_der:
                        daz = -am * sa if cosine else am * ca
                        dZdr = (P * (am * ram_m1) + (D * four_r) * ram) * az
                        dZdt = P * (ram * daz)
                yield j, am, Z, dZdr, dZdt
                j += 1
            if n < nmax:
                A, B, C = plan.abc[ab + n]
                lin = A * x + B
                if with_der:
                    D, Dp = A * P + lin * D - C * Dp, D
                P, Pp = lin * P - C * Pp, P


def _slot_coefs(plan, coefs, dtype):
    """c[index] * w per slot, in ``dtype``."""
    c = coefs.to(dtype)
    return [c[idx] * w for (idx, _, _), w in zip(plan.modes, plan.weights)]


def _float_dtype(*ts):
    return torch.promote_types(ts[0].dtype, ts[1].dtype)


def zernike_fwd_plain(plan, coefs, r, t):
    """Plain version of fwd_kernel: sum over slots of c*w * Z."""
    dt = _float_dtype(r, t)
    r, t = r.to(dt), t.to(dt)
    cw = _slot_coefs(plan, coefs, dt)
    acc = torch.zeros_like(r)
    for j, _, Z, _, _ in _walk(plan, r, t):
        acc = acc + cw[j] * Z
    return acc


def zernike_bwd_coefs_plain(plan, r, t, g):
    """Plain version of the coefficient cotangent: <Z_k, g> * w_k."""
    dt = _float_dtype(r, t)
    r, t, g = r.to(dt), t.to(dt), g.to(dt)
    cg = torch.zeros(len(plan.modes), dtype=dt, device=r.device)
    for j, _, Z, _, _ in _walk(plan, r, t):
        cg[plan.modes[j][0]] = torch.sum(g * Z) * plan.weights[j]
    return cg


def zernike_bwd_all_plain(plan, coefs, r, t, g):
    """Plain version of the full VJP: (coefficient, r, t) cotangents."""
    dt = _float_dtype(r, t)
    r, t, g = r.to(dt), t.to(dt), g.to(dt)
    cw = _slot_coefs(plan, coefs, dt)
    cg = torch.zeros(len(plan.modes), dtype=dt, device=r.device)
    gr, gt = torch.zeros_like(r), torch.zeros_like(r)
    for j, am, Z, dZdr, dZdt in _walk(plan, r, t, with_der=True):
        cg[plan.modes[j][0]] = torch.sum(g * Z) * plan.weights[j]
        gr = gr + cw[j] * (g * dZdr)
        if am != 0:
            gt = gt + cw[j] * (g * dZdt)
    return cg, gr, gt


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors)
# ---------------------------------------------------------------------------

# kernel modes (csrc/zernike.cu Mode)
_MODES = {'zernike_fwd': 0, 'zernike_bwd_coefs': 1, 'zernike_bwd_all': 2}
# what a slot does before it uses its modes (csrc/zernike.cu kTurn, kReset,
# kStep), and its two uses
_TURN, _RESET, _STEP, _COS, _SIN = 1, 2, 4, 8, 16
# the (A, B, C) of a slot that takes no recurrence step: P_n+1 = P_n
_NO_STEP = (0.0, 1.0, 0.0)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@lru_cache(None)
def _lib():
    lib = _cuda.load('zernike')
    signatures = {
        'prysm_zernike_block_threads': ([], _I),
        'prysm_zernike_buckets': ([ctypes.POINTER(_I), _I], _I),
        'prysm_zernike_resident_blocks': ([_I, _I, _I], _I),
        'prysm_zernike_launch': ([_I, _I, _P, _LL, _LL, _LL, _LL, _I, _I,
                                  *[_P] * 11], _I),
    }
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


@lru_cache(None)
def _buckets():
    """The program sizes the kernels are compiled for, smallest first (from the library)."""
    out = (_I * 16)()
    n = _lib().prysm_zernike_buckets(out, len(out))
    return tuple(out[:n])


@lru_cache(256)
def _program(plan):
    """The plan as the kernels' walk program: (op, |m|, (cos index, w), (sin index, w), (A, B, C)) per slot.

    The walk's events, in the order _walk takes them (a turn per unit rise
    of |m|, a reset per group, a step per Jacobi row, a use per mode, the
    cos mode of an n_j before its sin mode), are packed into slots, each of
    which takes at most one event of each kind, in the order turn, reset,
    step, cos use, sin use (at |m| = 0 the radial mode is the cos use).  A
    missing use has index -1 and w 0; a slot with no step has (A, B, C) =
    (0, 1, 0), the step that leaves P as it is.
    """
    events, am = [], 0
    for gam, _, first, end, ab in plan.groups:
        events += [(_TURN,)] * (gam - am)
        am = gam
        events.append((_RESET,))
        n = 0
        # a group's modes in n_j order, cos before sin (Python's sort is stable)
        for j in sorted(range(first, end), key=lambda j: (plan.modes[j][1], -plan.modes[j][2])):
            idx, nj, sign = plan.modes[j]
            events += [(_STEP, plan.abc[ab + k]) for k in range(n, nj)]
            n = nj
            events.append((_COS if sign > 0 else _SIN, (idx, plan.weights[j])))
    slots, last, am = [], _SIN, 0
    for kind, *rest in events:
        if kind <= last:  # this slot has done this kind, or a later one
            slots.append([0, am, (-1, 0.0), (-1, 0.0), _NO_STEP])
        slot, last = slots[-1], kind
        if kind == _TURN:
            am += 1
            slot[1] = am
        if kind == _STEP:
            slot[4] = rest[0]
        if kind in (_TURN, _RESET, _STEP):
            slot[0] |= kind
        else:
            slot[2 if kind == _COS else 3] = rest[0]
    return tuple(tuple(slot) for slot in slots)


def _bucket(n_slots, buckets):
    """The smallest program size in buckets that holds n_slots; the largest for a longer program."""
    return next((kmax for kmax in buckets if n_slots <= kmax), buckets[-1])


class _Piece(NamedTuple):
    """Slots of the walk program that one launch runs, and where the walk stands before them.

    turns: angle turns of the prologue (|m| before the first slot)
    rows: (A, B, C) of the recurrence steps the prologue takes after its reset
    slots: the program's slots, at most the program size
    """
    turns: int
    rows: tuple
    slots: tuple


def _uses(slot):
    return slot[2][0] >= 0 or slot[3][0] >= 0


@lru_cache(256)
def _chunks(prog, kmax):
    """The walk program cut into pieces of at most kmax slots, one launch each.

    A program that fits is one piece with an empty prologue.  A longer one
    is cut before the last group start (a slot that turns or resets) within
    kmax slots of the piece's first, or after kmax slots where there is
    none.  Slots that use no mode at a piece's start go into its prologue,
    and at its end are dropped.  The prologue replays the walk to where the
    slots before the piece leave it: the turns (the same angle additions),
    a reset, and the steps of the group in progress.
    """
    if len(prog) <= kmax:
        return (_Piece(0, (), prog),)
    pieces, s = [], 0
    while s < len(prog):
        while not _uses(prog[s]):  # the program's last slot uses a mode
            s += 1
        end = min(s + kmax, len(prog))
        if end < len(prog):
            starts = [b for b in range(s + 1, end + 1) if prog[b][0] & (_TURN | _RESET)]
            end = starts[-1] if starts else end
        reset = max(j for j in range(s + 1) if prog[j][0] & _RESET)
        rows = tuple(prog[j][4] for j in range(reset, s) if prog[j][0] & _STEP)
        last = max(j for j in range(s, end) if _uses(prog[j]))
        pieces.append(_Piece(prog[s - 1][1] if s else 0, rows, prog[s:last + 1]))
        s = end
    return tuple(pieces)


@lru_cache(256)
def _params(plan, kmax):
    """(blobs, rows): the plan's pieces packed as csrc/zernike.cu Params<kmax>, one per launch.

    A blob: int32 K (slots), turns, pre (prologue steps), pre_at (their
    first row) and add (1 after the first piece); int32 op and |m| per
    slot, int32 cos and sin index per slot, float32 cos and sin w per slot,
    float32 (A, B, C) per slot; little-endian, no padding between fields.
    The slots past K, up to kmax, are never run.  rows: the float32 (n, 3)
    table of every piece's prologue steps, in piece order.  w and (A, B, C)
    are made in float64 and rounded to float32.
    """
    blobs, rows = [], []
    for i, piece in enumerate(_chunks(_program(plan), kmax)):
        K = len(piece.slots)
        ints = np.zeros((2, kmax), '<i4')
        idx = np.full((kmax, 2), -1, '<i4')
        w = np.zeros((kmax, 2), '<f4')
        abc = np.tile(np.array(_NO_STEP, '<f4'), (kmax, 1))
        for j, (op, am, cos, sin, row) in enumerate(piece.slots):
            ints[:, j] = op, am
            idx[j] = cos[0], sin[0]
            w[j] = np.array([cos[1], sin[1]], np.float64)
            abc[j] = np.array(row, np.float64)
        head = np.array([K, piece.turns, len(piece.rows), len(rows), int(i > 0)], '<i4')
        blobs.append(b''.join(a.tobytes() for a in (head, ints, idx, w, abc)))
        rows += piece.rows
    return tuple(blobs), np.array(rows, np.float64).astype('<f4').reshape(-1, 3)


@lru_cache(256)
def _device_rows(plan, kmax, device):
    """_params's prologue table on the device, or None when no piece has a prologue step."""
    rows = _params(plan, kmax)[1]
    return torch.from_numpy(rows).to(device) if len(rows) else None


def _span(ptr, npix):
    """(head, quads, tail): the kernels' partition of npix float32 pixels at address ptr.

    head pixels come before the first 16-byte-aligned one, then whole
    quads of 4, then the tail; head and tail are each 0-3 pixels.
    """
    head = min((-ptr % 16) // 4, npix)
    quads = (npix - head) // 4
    return head, quads, npix - head - 4 * quads


def _vec_bits(ptrs, head):
    """Bit a set where ptrs[a] is 16-byte aligned at pixel head (None: not there)."""
    return sum(1 << a for a, p in enumerate(ptrs) if p is not None and (p + 4 * head) % 16 == 0)


@lru_cache(None)
def _resident_blocks(device_index, mode, kmax):
    n = _lib().prysm_zernike_resident_blocks(mode, kmax, device_index)
    if n <= 0:
        raise RuntimeError(f'zernike kernel occupancy query failed ({n})')
    return n


# one ticket per (device, stream): csrc/zernike.cu's last block resets it to 0
_TICKETS = {}


def _ticket(device):
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _TICKETS[key]


def _f32(x, device):
    if x.device != device:
        raise ValueError(f'all tensors must be on {device}, got one on {x.device}')
    return x.to(torch.float32).contiguous()


def _check(rc, name):
    if rc != 0:
        raise RuntimeError(f'{name} launch failed with code {rc} (cudaError_t when '
                           'positive; csrc/zernike.cu kBadParams/kBadBucket when negative)')


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch(name, plan, coefs, r, t, g):
    """The kernel in mode ``name``, one launch per piece; (OPD,), (cg,) or (cg, gr, gt)."""
    dev = r.device
    kmax = _bucket(len(_program(plan)), _buckets())
    blobs, _ = _params(plan, kmax)
    pieces = _chunks(_program(plan), kmax)
    rows = _device_rows(plan, kmax, dev)
    r, t = _f32(r, dev), _f32(t, dev)
    c = None if coefs is None else _f32(coefs, dev)
    g = None if g is None else _f32(g, dev)
    lib, mode = _lib(), _MODES[name]
    head, quads, tail = _span(r.data_ptr(), r.numel())
    # a persistent grid: at most the blocks that fit at once, at least one
    # (whose threads 0 and 1 take the head and the tail)
    threads = lib.prysm_zernike_block_threads()
    blocks = max(1, min(_resident_blocks(dev.index, mode, kmax), -(-quads // threads)))
    o0 = None if name == 'zernike_bwd_coefs' else torch.empty_like(r)
    o1 = torch.empty_like(r) if name == 'zernike_bwd_all' else None
    partial = ticket = cg = None
    if name != 'zernike_fwd':
        # one partial sum per block and use (two per slot), for each piece
        # in turn; each piece writes the cotangents of its own modes
        partial = torch.empty((blocks, 2 * max(len(p.slots) for p in pieces)),
                              dtype=torch.float32, device=dev)
        ticket = _ticket(dev)
        cg = torch.empty(len(plan.modes), dtype=torch.float32, device=dev)
    vec = _vec_bits([_ptr(x) for x in (r, t, g, o0, o1)], head)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for blob, piece in zip(blobs, pieces):
        rc = lib.prysm_zernike_launch(mode, kmax, blob, len(blob), head, quads, tail, vec,
                                      blocks, *(_ptr(x) for x in (c, rows, r, t, g, o0, o1,
                                                                  partial, ticket, cg)),
                                      stream)
        _check(rc, name)
        LAUNCHES[name] += 1
    return tuple(x for x in (cg, o0, o1) if x is not None)


def _launch_fwd(plan, coefs, r, t):
    return _launch('zernike_fwd', plan, coefs, r, t, None)[0]


def _launch_bwd_coefs(plan, r, t, g):
    return _launch('zernike_bwd_coefs', plan, None, r, t, g)[0]


def _launch_bwd_all(plan, coefs, r, t, g):
    return _launch('zernike_bwd_all', plan, coefs, r, t, g)


def _on_cpu(r):
    if r.device.type == 'cpu':
        return True
    if r.device.type == 'cuda':
        return False
    raise ValueError(f'zernike kernels take CUDA or CPU tensors, got {r.device}')


def zernike_fwd(plan, coefs, r, t):
    """OPD: fwd_kernel for CUDA tensors, its plain version for CPU tensors."""
    if _on_cpu(r):
        return zernike_fwd_plain(plan, coefs, r, t)
    return _launch_fwd(plan, coefs, r, t)


def zernike_bwd_coefs(plan, r, t, g):
    """Coefficient cotangent: the coefs backward kernel, or its plain version on CPU."""
    if _on_cpu(r):
        return zernike_bwd_coefs_plain(plan, r, t, g)
    return _launch_bwd_coefs(plan, r, t, g)


def zernike_bwd_all(plan, coefs, r, t, g):
    """Full VJP: the full backward kernel, or its plain version on CPU."""
    if _on_cpu(r):
        return zernike_bwd_all_plain(plan, coefs, r, t, g)
    return _launch_bwd_all(plan, coefs, r, t, g)


class _ZernikeSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coefs, r, t, plan, grads):
        ctx.save_for_backward(coefs, r, t)
        ctx.plan, ctx.grads = plan, grads
        return zernike_fwd(plan, coefs, r, t)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        coefs, r, t = ctx.saved_tensors
        if ctx.grads == 'coefs':
            cg = zernike_bwd_coefs(ctx.plan, r, t, g)
            # the grids' cotangents are declared zero; made only if asked for
            _, need_r, need_t = ctx.needs_input_grad[:3]
            return (cg.to(coefs.dtype), torch.zeros_like(r) if need_r else None,
                    torch.zeros_like(t) if need_t else None, None, None)
        cg, gr, gt = zernike_bwd_all(ctx.plan, coefs, r, t, g)
        return cg.to(coefs.dtype), gr.to(r.dtype), gt.to(t.dtype), None, None


def zernike_sum_pallas(coefs, nms, r, t, norm=True, grads='all'):
    """Fused ``sum_k coefs[k] * Z_{nms[k]}(r, t)`` on one 2D (r, t) grid.

    CUDA tensors run the hand-written kernels in float32; CPU tensors run
    the plain versions in their own dtype.
    grads='all' (default): exact VJPs for coefs, r, and t.
    grads='coefs': the backward computes only the coefficient cotangent
    and declares the grids constant (zero cotangent); use it only when the
    loss does not depend on the grids, as in phase retrieval.
    """
    if grads not in ('all', 'coefs'):
        raise ValueError(f"grads must be 'all' or 'coefs', got {grads!r}")
    nms = tuple((int(n), int(m)) for n, m in nms)
    if not nms:
        return torch.zeros_like(r)
    if r.ndim != 2 or t.ndim != 2 or r.shape != t.shape:
        raise ValueError('zernike_sum_pallas requires 2D r, t grids of one shape')
    coefs = torch.as_tensor(coefs, device=r.device)
    if coefs.shape != (len(nms),):
        raise ValueError(f'coefs must have shape ({len(nms)},), got {tuple(coefs.shape)}')
    return _ZernikeSum.apply(coefs, r, t, _plan(nms, bool(norm)), grads)
