"""Fused Zernike mode synthesis: CUDA kernels, their plain versions, one autograd Function.

Counterpart of ``prysm_tpu/ops/zernike.py``.  ``zernike_sum_pallas``
computes ``sum_k coefs[k] * Z_{nms[k]}(r, t)`` without materializing the
(K, N, N) mode stack, with exact gradients:

* forward: ``csrc/zernike.cu`` fwd_kernel (replaces ``_fwd_kernel``);
* ``grads='coefs'`` backward: bwd_kernel<false> + reduce_kernel (replaces
  ``_bwd_coefs_kernel``); the r and t cotangents are declared zero;
* ``grads='all'`` backward: bwd_kernel<true> + reduce_kernel (replaces
  ``_bwd_kernel``).

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

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_TABLE = [_P, _P, _P, _P, _I, _I, _I]


@lru_cache(None)
def _lib():
    lib = _cuda.load('zernike')
    signatures = {
        'prysm_zernike_block_threads': ([], _I),
        'prysm_zernike_shared_bytes': ([_I, _I, _I], _LL),
        'prysm_zernike_fwd': ([_P, _P, _P, _P, _LL, *_TABLE, _P], _I),
        'prysm_zernike_bwd_coefs': ([_P, _P, _P, _P, _P, _LL, *_TABLE, _P], _I),
        'prysm_zernike_bwd_all': ([_P, _P, _P, _P, _P, _P, _P, _P, _LL, *_TABLE, _P], _I),
    }
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


# a block may hold at most this much shared memory without opting in
_MAX_SHARED = 48 * 1024


class _DeviceTable(NamedTuple):
    gi: torch.Tensor
    mi: torch.Tensor
    w: torch.Tensor
    abc: torch.Tensor

    def args(self):
        return [self.gi.data_ptr(), self.mi.data_ptr(), self.w.data_ptr(),
                self.abc.data_ptr(), self.gi.shape[0], self.mi.shape[0],
                self.abc.shape[0]]


@lru_cache(64)
def _device_table(plan, device):
    """The plan's tables on ``device``: built in float64 on the host, cast to f32, kept."""
    G, K, R = len(plan.groups), len(plan.modes), len(plan.abc)
    need = _lib().prysm_zernike_shared_bytes(G, K, R)
    if need > _MAX_SHARED:
        raise ValueError(f'{K} modes need {need} bytes of shared memory per block; '
                         f'the kernels take at most {_MAX_SHARED}')

    def dev(values, dtype, shape):
        return torch.tensor(values, dtype=torch.float64 if dtype.is_floating_point
                            else dtype).reshape(shape).to(device=device, dtype=dtype)

    return _DeviceTable(gi=dev(plan.groups, torch.int32, (G, 5)),
                        mi=dev(plan.modes, torch.int32, (K, 3)),
                        w=dev(plan.weights, torch.float32, (K,)),
                        abc=dev(plan.abc, torch.float32, (R, 3)))


def _f32(x, device):
    if x.device != device:
        raise ValueError(f'all tensors must be on {device}, got one on {x.device}')
    return x.to(torch.float32).contiguous()


def _check(rc, name):
    if rc != 0:
        raise RuntimeError(f'{name} launch failed with cudaError_t {rc}')


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _num_blocks(npix):
    threads = _lib().prysm_zernike_block_threads()
    return (npix + threads - 1) // threads


def _launch_fwd(plan, coefs, r, t):
    dev = r.device
    tb = _device_table(plan, dev)
    c, r, t = _f32(coefs, dev), _f32(r, dev), _f32(t, dev)
    out = torch.empty_like(r)
    rc = _lib().prysm_zernike_fwd(c.data_ptr(), r.data_ptr(), t.data_ptr(),
                                  out.data_ptr(), r.numel(), *tb.args(), _stream())
    _check(rc, 'zernike_fwd')
    LAUNCHES['zernike_fwd'] += 1
    return out


def _launch_bwd_coefs(plan, r, t, g):
    dev = r.device
    tb = _device_table(plan, dev)
    r, t, g = _f32(r, dev), _f32(t, dev), _f32(g, dev)
    K = len(plan.modes)
    partial = torch.empty((_num_blocks(r.numel()), K), dtype=torch.float32, device=dev)
    cg = torch.empty(K, dtype=torch.float32, device=dev)
    rc = _lib().prysm_zernike_bwd_coefs(r.data_ptr(), t.data_ptr(), g.data_ptr(),
                                        partial.data_ptr(), cg.data_ptr(), r.numel(),
                                        *tb.args(), _stream())
    _check(rc, 'zernike_bwd_coefs')
    LAUNCHES['zernike_bwd_coefs'] += 1
    return cg


def _launch_bwd_all(plan, coefs, r, t, g):
    dev = r.device
    tb = _device_table(plan, dev)
    c, r, t, g = _f32(coefs, dev), _f32(r, dev), _f32(t, dev), _f32(g, dev)
    K = len(plan.modes)
    partial = torch.empty((_num_blocks(r.numel()), K), dtype=torch.float32, device=dev)
    cg = torch.empty(K, dtype=torch.float32, device=dev)
    gr, gt = torch.empty_like(r), torch.empty_like(r)
    rc = _lib().prysm_zernike_bwd_all(c.data_ptr(), r.data_ptr(), t.data_ptr(),
                                      g.data_ptr(), partial.data_ptr(), cg.data_ptr(),
                                      gr.data_ptr(), gt.data_ptr(), r.numel(),
                                      *tb.args(), _stream())
    _check(rc, 'zernike_bwd_all')
    LAUNCHES['zernike_bwd_all'] += 1
    return cg, gr, gt


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
            return (cg.to(coefs.dtype), torch.zeros_like(r), torch.zeros_like(t),
                    None, None)
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
