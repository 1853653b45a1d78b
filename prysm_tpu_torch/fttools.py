"""Fourier transform tooling: grids, padding, and the transform plans.

Counterpart of ``prysm_tpu/fttools.py``.  The FFT-alignment conventions of
``fftrange``/``pad2d``/``crop_center`` are kept exactly: the left/top side
receives the extra sample.  The plans (``MDFT``, ``CZT``, ``FFTDFT``) are
built on the host in float64, then cast to the working complex dtype and
kept on the plan's device as native complex tensors (the JAX package
splits them into real and imaginary leaves; ``interop`` takes those).
Applying a plan is plain torch, so autograd through it gives the plan's
``adjoint``.
"""
import math
from contextlib import contextmanager

import numpy as np
import torch

from .conf import config, resolve_device

__all__ = ['fftrange', 'fftfreq', 'forward_ft_unit', 'next_fast_len', 'pad2d',
           'crop_center', 'MDFT', 'plan_mdft', 'CZT', 'plan_czt', 'stack_czt_plans',
           'FFTDFT', 'plan_fftdft', 'fourier_resample']


def fftrange(n, dtype=None, device=None):
    """FFT-aligned coordinate grid for n samples: [-(n//2), ..., n - n//2)."""
    if dtype is None:
        dtype = config.precision
    return torch.arange(-(n // 2), -(n // 2) + n, dtype=dtype,
                        device=resolve_device(device))


def _host_fftrange(n, dtype=np.float64):
    """Host-side (numpy) twin of fftrange for plan construction."""
    return np.arange(-(n // 2), -(n // 2) + n, dtype=dtype)


def fftfreq(n, d=1.0, dtype=None, device=None):
    """FFT sample frequency vector."""
    if dtype is None:
        dtype = config.precision
    return torch.fft.fftfreq(n, d, dtype=dtype, device=resolve_device(device))


def forward_ft_unit(dx, samples, shift=True, dtype=None, device=None):
    """Frequency units of an FFT of `samples` points with spacing `dx`."""
    unit = fftfreq(samples, dx, dtype=dtype, device=device)
    if shift:
        return torch.fft.fftshift(unit)
    return unit


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _complex_tensor(a, dtype, device):
    """A host array as a complex tensor of ``dtype`` on ``device``."""
    return torch.from_numpy(np.asarray(a, dtype=np.complex128)).to(device=device, dtype=dtype)


def _pad_split(delta):
    """(left, right) padding of delta samples; the left side takes the extra one."""
    left = math.ceil(delta / 2)
    return left, delta - left


def next_fast_len(n):
    """The next 5-smooth FFT size >= n (the JAX package's rule, so CZT lengths agree)."""
    if n <= 2:
        return n
    best = 1 << math.ceil(math.log2(n))
    # search 5-smooth numbers (2^a 3^b 5^c) in [n, 2^ceil(log2 n)]
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            k = p35
            while k < n:
                k *= 2
            if k < best:
                best = k
            p35 *= 3
        p5 *= 5
    return best


# jnp.pad / np.pad modes that repeat input samples: the source index of
# every padded sample is np.pad of the index vector in the same mode
_INDEX_MODES = ('edge', 'reflect', 'symmetric', 'wrap')


def _pad_axis(array, dim, before, after, mode):
    """Pad one axis in an index mode by gathering the samples it repeats."""
    n = array.shape[dim]
    index = np.pad(np.arange(n), (before, after), mode=mode)
    return torch.index_select(array, dim, torch.from_numpy(index).to(array.device))


def pad2d(array, Q=2, value=0, mode='constant', out_shape=None):
    """Symmetrically pad the trailing two axes, FFT-aligned.

    ``mode`` is 'constant' (with ``value``) or one of numpy's modes that
    repeat samples: 'edge', 'reflect', 'symmetric', 'wrap'.
    """
    if Q == 1 and out_shape is None:
        return array
    in_shape = array.shape[-2:]
    if out_shape is None:
        out_shape = tuple(math.ceil(s * Q) for s in in_shape)
    elif isinstance(out_shape, int):
        out_shape = (out_shape, out_shape)
    (top, bottom), (left, right) = (_pad_split(o - s)
                                    for o, s in zip(out_shape, in_shape))
    if mode == 'constant':
        return torch.nn.functional.pad(array, (left, right, top, bottom), value=value)
    if mode not in _INDEX_MODES:
        raise ValueError(f"mode must be 'constant' or one of {_INDEX_MODES}, got {mode!r}")
    return _pad_axis(_pad_axis(array, -2, top, bottom, mode), -1, left, right, mode)


def crop_center(img, out_shape):
    """Crop the central out_shape of the trailing two axes (adjoint of pad2d)."""
    if isinstance(out_shape, int):
        out_shape = (out_shape, out_shape)
    (top, _), (left, _) = (_pad_split(s - o)
                           for o, s in zip(out_shape, img.shape[-2:]))
    return img[..., top:top + out_shape[0], left:left + out_shape[1]]


@contextmanager
def _tf32_matmuls():
    """Allow TF32 in float32 matmuls for the scope only, then restore.

    Torch has no per-call matmul precision, so this flips the
    process-wide flag.  The legacy ``allow_tf32`` setter is used because
    it keeps the legacy and the newer ``fp32_precision`` readings in step;
    setting ``matmul.fp32_precision`` alone makes
    ``torch.get_float32_matmul_precision()`` raise.
    """
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class _HighPrecisionApply(torch.autograd.Function):
    """plan(ary) or plan.adjoint(ary) with TF32 scoped around the matmuls.

    The backward is the other direction of the same plan, under the same
    scope, so ``'high'`` covers the gradient's matmuls as it covers the
    JAX transpose's.  The plan is linear, so a tangent takes the same
    direction of it (``jvp``); the forward is torch matmuls, so ``vmap``
    is torch's generated rule.
    """

    generate_vmap_rule = True

    @staticmethod
    def forward(ary, plan, adjoint):
        with _tf32_matmuls():
            return plan._apply(ary, adjoint)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.plan, ctx.adjoint = inputs

    @staticmethod
    def backward(ctx, grad):
        with _tf32_matmuls():
            return ctx.plan._apply(grad, not ctx.adjoint), None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        with _tf32_matmuls():
            return ctx.plan._apply(tangent, ctx.adjoint)


class MDFT:
    """Matrix DFT plan: out = norm * Ey @ ary @ Ex.T.

    ``out[i, j] = norm * sum_{k, l} ary[k, l] * exp(sign*2j*pi*(y[k]*fy[i] +
    x[l]*fx[j]))`` as two dense complex matmuls.  ``Ex`` (Mx, Nx) and
    ``Ey`` (My, Ny) are native complex tensors.  ``matmul_precision``:
    None runs full-precision matmuls; ``'high'`` allows TF32 for the two
    basis matmuls of the transform and of its gradient, and nowhere else in
    this thread.  The switch is torch's process-wide TF32 flag, set for the
    duration of those matmuls (the gradient's run on the autograd engine's
    thread): a float32 matmul that another thread issues meanwhile may
    take TF32 too.
    """

    def __init__(self, Ex, Ey, norm=1.0, forward_left_first=True,
                 adjoint_left_first=True, pupil_dx=None, focal_dx=None,
                 matmul_precision=None):
        if matmul_precision not in (None, 'highest', 'high'):
            raise ValueError("matmul_precision must be None, 'highest' or 'high', "
                             f'got {matmul_precision!r}')
        self.Ex = Ex
        self.Ey = Ey
        self.norm = float(norm)
        self.forward_left_first = bool(forward_left_first)
        self.adjoint_left_first = bool(adjoint_left_first)
        self.pupil_dx = pupil_dx
        self.focal_dx = focal_dx
        self.matmul_precision = matmul_precision

    def _apply(self, ary, adjoint):
        Ex, Ey = self.Ex, self.Ey
        ary = ary.to(Ex.dtype)
        if adjoint:
            L, R, left_first = Ey.conj().T, Ex.conj(), self.adjoint_left_first
        else:
            L, R, left_first = Ey, Ex.T, self.forward_left_first
        if left_first:
            out = torch.matmul(torch.matmul(L, ary), R)
        else:
            out = torch.matmul(L, torch.matmul(ary, R))
        return out * self.norm

    def _run(self, ary, adjoint):
        if self.matmul_precision == 'high':
            return _HighPrecisionApply.apply(ary, self, adjoint)
        return self._apply(ary, adjoint)

    def __call__(self, ary):
        """Apply the forward DFT to ary (..., Ny, Nx) -> (..., My, Mx)."""
        return self._run(ary, False)

    def adjoint(self, grad):
        """Apply the adjoint (conjugate transpose) of the forward DFT."""
        return self._run(grad, True)

    def nbytes(self):
        """Total size in memory of the basis matrices, bytes."""
        return _nbytes(self.Ex, self.Ey)


def plan_mdft(x, y, fx, fy, sign=-1, norm=1.0, dtype=None, pupil_dx=None,
              focal_dx=None, matmul_precision=None, device=None):
    """Construct an MDFT plan from input coordinates and output frequencies.

    Bases are evaluated on the host in float64 for phase accuracy, then
    cast to ``dtype`` (default ``config.precision_complex``) on ``device``.
    """
    if dtype is None:
        dtype = config.precision_complex
    dev = resolve_device(device)
    x, y, fx, fy = (np.asarray(v, dtype=np.float64) for v in (x, y, fx, fy))
    prefix = sign * 2j * np.pi
    Ex = np.exp(prefix * np.outer(fx, x))
    Ey = np.exp(prefix * np.outer(fy, y))
    Nx, Ny, Mx, My = len(x), len(y), len(fx), len(fy)
    # matmul order: the cheaper association of the two products
    fwd_left = My * Nx * (Ny + Mx) <= Ny * Mx * (Nx + My)
    adj_left = Ny * Mx * (My + Nx) <= My * Nx * (Mx + Ny)
    return MDFT(
        Ex=_complex_tensor(Ex, dtype, dev), Ey=_complex_tensor(Ey, dtype, dev),
        norm=norm, forward_left_first=fwd_left, adjoint_left_first=adj_left,
        pupil_dx=pupil_dx, focal_dx=focal_dx, matmul_precision=matmul_precision)


# ----------------------------------------------------------------------------
# Chirp-Z transform plan (Bluestein factorization)
# ----------------------------------------------------------------------------

class CZT:
    """Chirp-Z transform plan with the semantics of the MDFT plan.

    O(N log N) per axis via the Bluestein factorization; needs uniformly
    spaced coordinates and frequencies.  The chirps are complex tensors:
    ``brow`` (Ny, 1), ``bcol`` (Nx,), ``Hrow`` (Ky, 1), ``Hcol`` (Kx,),
    ``arow`` (My, 1), ``acol`` (Mx,), ``x_phase`` (Mx,), ``y_phase``
    (My, 1), each with a leading wavelength axis in a stacked plan.
    ``x_first`` picks the cheaper order of the two axis passes.
    """

    def __init__(self, brow, bcol, Hrow, Hcol, arow, acol, x_phase, y_phase, norm=1.0,
                 Nx=0, Ny=0, Mx=0, My=0, Kx=0, Ky=0, x_first=True, pupil_dx=None,
                 focal_dx=None):
        self.brow, self.bcol, self.Hrow, self.Hcol = brow, bcol, Hrow, Hcol
        self.arow, self.acol, self.x_phase, self.y_phase = arow, acol, x_phase, y_phase
        self.norm = float(norm)
        self.Nx, self.Ny, self.Mx, self.My, self.Kx, self.Ky = Nx, Ny, Mx, My, Kx, Ky
        self.x_first = bool(x_first)
        self.pupil_dx = pupil_dx
        self.focal_dx = focal_dx

    def _conv_x(self, out):
        sx = self.Nx - 1
        out = torch.fft.ifft(torch.fft.fft(out, n=self.Kx, dim=-1) * self.Hcol, dim=-1)
        return out[..., sx:sx + self.Mx] * self.acol * self.x_phase

    def _conv_y(self, out):
        sy = self.Ny - 1
        out = torch.fft.ifft(torch.fft.fft(out, n=self.Ky, dim=-2) * self.Hrow, dim=-2)
        return out[..., sy:sy + self.My, :] * self.arow * self.y_phase

    def __call__(self, ary):
        """Apply the CZT to ary (..., Ny, Nx) -> (..., My, Mx)."""
        out = ary.to(self.bcol.dtype) * self.bcol * self.brow
        if self.x_first:
            out = self._conv_y(self._conv_x(out))
        else:
            out = self._conv_x(self._conv_y(out))
        return out * self.norm

    def _adj_x(self, out):
        sx = self.Nx - 1
        tmp = torch.nn.functional.pad(out, (sx, self.Kx - sx - self.Mx))
        tmp = torch.fft.ifft(torch.fft.fft(tmp, dim=-1) * self.Hcol.conj(), dim=-1)
        return tmp[..., :self.Nx]

    def _adj_y(self, out):
        sy = self.Ny - 1
        tmp = torch.nn.functional.pad(out, (0, 0, sy, self.Ky - sy - self.My))
        tmp = torch.fft.ifft(torch.fft.fft(tmp, dim=-2) * self.Hrow.conj(), dim=-2)
        return tmp[..., :self.Ny, :]

    def adjoint(self, grad):
        """Apply the adjoint (conjugate transpose) of the forward CZT."""
        out = (grad.to(self.bcol.dtype) * self.x_phase.conj() * self.y_phase.conj()
               * self.acol.conj() * self.arow.conj())
        if self.x_first:
            out = self._adj_x(self._adj_y(out))
        else:
            out = self._adj_y(self._adj_x(out))
        return out * self.bcol.conj() * self.brow.conj() * self.norm

    def nbytes(self):
        """Total size in memory of the chirps, bytes."""
        return _nbytes(self.brow, self.bcol, self.Hrow, self.Hcol, self.arow, self.acol,
                       self.x_phase, self.y_phase)


def _host_czt_basis(N, M, K, shift, alpha, sign):
    """(H, b, a): the FFT of the length-K chirp filter and the input and output chirps."""
    n = _host_fftrange(N)
    m = _host_fftrange(M)
    q = m + shift
    prefix = sign * 1j * np.pi * alpha
    a = np.exp(prefix * q * q)
    b = np.exp(prefix * n * n)
    d = np.arange(m[0] - n[-1], m[-1] - n[0] + 1, dtype=np.float64)
    h = np.zeros(K, dtype=np.complex128)
    h[:len(d)] = np.exp(-prefix * (d + shift) * (d + shift))
    return np.fft.fft(h), b, a


def _x_first(Nx, Ny, Mx, My, Kx, Ky):
    """Whether the x pass first costs no more FFT work than the y pass first."""
    x_first_cost = Ny * Kx * math.log2(Kx) + Mx * Ky * math.log2(Ky)
    y_first_cost = Nx * Ky * math.log2(Ky) + My * Kx * math.log2(Kx)
    return x_first_cost <= y_first_cost


def plan_czt(x, y, fx, fy, sign=-1, norm=1.0, dtype=None, pupil_dx=None, focal_dx=None,
             device=None):
    """Construct a CZT plan; arguments as plan_mdft, grids must be uniform."""
    if sign not in (-1, 1):
        raise ValueError(f'sign must be -1 or +1, got {sign}')
    if dtype is None:
        dtype = config.precision_complex
    dev = resolve_device(device)
    x, y, fx, fy = (np.asarray(v, dtype=np.float64) for v in (x, y, fx, fy))
    Nx, Mx = len(x), len(fx)
    Ny, My = len(y), len(fy)
    dfx = float(fx[1] - fx[0])
    dfy = float(fy[1] - fy[0])
    alpha_x = float(x[1] - x[0]) * dfx
    alpha_y = float(y[1] - y[0]) * dfy
    Kx = next_fast_len(Nx + Mx - 1)
    Ky = next_fast_len(Ny + My - 1)
    Hx, bx, ax = _host_czt_basis(Nx, Mx, Kx, float(fx[Mx // 2]) / dfx, alpha_x, sign)
    Hy, by, ay = _host_czt_basis(Ny, My, Ky, float(fy[My // 2]) / dfy, alpha_y, sign)
    prefix = sign * 2j * np.pi
    x_phase = np.exp(prefix * float(x[Nx // 2]) * fx)
    y_phase = np.exp(prefix * float(y[Ny // 2]) * fy)
    parts = {name: _complex_tensor(arr, dtype, dev) for name, arr in (
        ('brow', by[:, None]), ('bcol', bx), ('Hrow', Hy[:, None]), ('Hcol', Hx),
        ('arow', ay[:, None]), ('acol', ax), ('x_phase', x_phase),
        ('y_phase', y_phase[:, None]))}
    return CZT(**parts, norm=norm, Nx=Nx, Ny=Ny, Mx=Mx, My=My, Kx=Kx, Ky=Ky,
               x_first=_x_first(Nx, Ny, Mx, My, Kx, Ky), pupil_dx=pupil_dx,
               focal_dx=focal_dx)


def stack_czt_plans(plans):
    """Fuse same-geometry CZT plans into one plan over a leading wavelength axis.

    The result maps (W, Ny, Nx) -> (W, My, Mx) with one batched FFT
    pipeline.  The static geometry (N, M, K, axis order) must agree; each
    plan's scalar norm is folded into its ``x_phase``, so forward and
    adjoint stay exact.
    """
    plans = tuple(plans)
    if not plans:
        raise ValueError('stack_czt_plans needs at least one plan')
    first = plans[0]
    geometry = lambda p: (p.Nx, p.Ny, p.Mx, p.My, p.Kx, p.Ky, p.x_first)  # noqa: E731
    for p in plans[1:]:
        if not isinstance(p, CZT) or geometry(p) != geometry(first):
            raise ValueError('stacked plans must be CZTs with identical static geometry')

    def stack(name, row):
        arrs = torch.stack([getattr(p, name) for p in plans])  # (W, a[, 1])
        return arrs if row else arrs[:, None, :]                # (W, 1, a)

    parts = {name: stack(name, row) for name, row in (
        ('brow', True), ('bcol', False), ('Hrow', True), ('Hcol', False),
        ('arow', True), ('acol', False), ('y_phase', True))}
    norms = torch.tensor([p.norm for p in plans], dtype=first.x_phase.real.dtype,
                         device=first.x_phase.device)[:, None, None]
    parts['x_phase'] = stack('x_phase', False) * norms
    return CZT(**parts, norm=1.0, Nx=first.Nx, Ny=first.Ny, Mx=first.Mx, My=first.My,
               Kx=first.Kx, Ky=first.Ky, x_first=first.x_first, pupil_dx=first.pupil_dx,
               focal_dx=first.focal_dx)


# ----------------------------------------------------------------------------
# FFT-compatible DFT plan (one FFT per axis)
# ----------------------------------------------------------------------------

class FFTDFT:
    """DFT plan run as a single FFT per axis on compatible grids.

    Needs |dx*dfx| == 1/K for an integer K >= max(N, M) on each axis.  The
    phase vectors are complex tensors: ``pre_x`` (Nx,), ``pre_y`` (Ny, 1),
    ``post_x`` (Mx,), ``post_y`` (My, 1).  ``x_direction`` and
    ``y_direction`` are the sign of each axis's exponent: a negative
    spacing product flips it.
    """

    def __init__(self, pre_x, pre_y, post_x, post_y, norm=1.0, Nx=0, Ny=0, Mx=0, My=0,
                 Kx=0, Ky=0, x_direction=-1, y_direction=-1, x_first=True, pupil_dx=None,
                 focal_dx=None):
        self.pre_x, self.pre_y, self.post_x, self.post_y = pre_x, pre_y, post_x, post_y
        self.norm = float(norm)
        self.Nx, self.Ny, self.Mx, self.My, self.Kx, self.Ky = Nx, Ny, Mx, My, Kx, Ky
        self.x_direction = int(x_direction)
        self.y_direction = int(y_direction)
        self.x_first = bool(x_first)
        self.pupil_dx = pupil_dx
        self.focal_dx = focal_dx

    @staticmethod
    def _fft_fwd(ary, K, dim, direction):
        if direction == -1:
            return torch.fft.fft(ary, n=K, dim=dim)
        return torch.fft.ifft(ary, n=K, dim=dim) * K

    @staticmethod
    def _fft_adj(ary, K, N, dim, direction):
        pad = [0, 0] * (-dim)
        pad[-1] = K - ary.shape[dim]
        tmp = torch.nn.functional.pad(ary, pad)
        if direction == -1:
            out = torch.fft.ifft(tmp, dim=dim) * K
        else:
            out = torch.fft.fft(tmp, dim=dim)
        return out.narrow(dim, 0, N)

    def _pass_x(self, out):
        return self._fft_fwd(out, self.Kx, -1, self.x_direction)[..., :self.Mx]

    def _pass_y(self, out):
        return self._fft_fwd(out, self.Ky, -2, self.y_direction)[..., :self.My, :]

    def __call__(self, ary):
        """Apply the FFT-factored DFT to ary (..., Ny, Nx) -> (..., My, Mx)."""
        out = ary.to(self.pre_x.dtype) * self.pre_x * self.pre_y
        if self.x_first:
            out = self._pass_y(self._pass_x(out))
        else:
            out = self._pass_x(self._pass_y(out))
        return out * self.post_x * self.post_y * self.norm

    def adjoint(self, grad):
        """Apply the adjoint (conjugate transpose) of the FFT DFT."""
        out = grad.to(self.pre_x.dtype) * self.post_x.conj() * self.post_y.conj()
        adj_y = lambda a: self._fft_adj(a, self.Ky, self.Ny, -2, self.y_direction)  # noqa: E731
        adj_x = lambda a: self._fft_adj(a, self.Kx, self.Nx, -1, self.x_direction)  # noqa: E731
        out = adj_x(adj_y(out)) if self.x_first else adj_y(adj_x(out))
        return out * self.pre_x.conj() * self.pre_y.conj() * self.norm

    def nbytes(self):
        """Total size in memory of the phase vectors, bytes."""
        return _nbytes(self.pre_x, self.pre_y, self.post_x, self.post_y)


def _uniform_spacing(values, name):
    """The spacing of a uniformly spaced host vector; raises otherwise."""
    if len(values) < 2:
        raise ValueError(f'{name} must contain at least two samples')
    spacing = float(values[1] - values[0])
    if spacing == 0:
        raise ValueError(f'{name} must have nonzero spacing')
    tol = 32 * np.finfo(np.float64).eps
    scale = max(1.0, abs(float(values[0])), abs(float(values[-1])), abs(spacing))
    if not np.allclose(np.diff(values), spacing, rtol=tol, atol=tol * scale):
        raise ValueError(f'{name} must be uniformly spaced')
    return spacing


def _fft_compatible_length(alpha, N, M, name):
    """The FFT length K = 1/|alpha|; raises unless it is an integer >= max(N, M)."""
    inv_alpha = 1 / abs(alpha)
    K = round(inv_alpha)
    tol = 32 * np.finfo(np.float64).eps
    if not math.isclose(inv_alpha, K, rel_tol=tol, abs_tol=tol):
        raise ValueError(
            f'{name} spacings are not FFT-compatible: '
            'abs(input spacing * output spacing) must be 1/integer')
    if K < max(N, M):
        raise ValueError(
            f'{name} requires FFT length {K}, smaller than input/output length {max(N, M)}')
    return K


def plan_fftdft(x, y, fx, fy, sign=-1, norm=1.0, dtype=None, pupil_dx=None, focal_dx=None,
                device=None):
    """Construct an FFTDFT plan; arguments as plan_mdft, FFT-compatible grids."""
    if sign not in (-1, 1):
        raise ValueError(f'sign must be -1 or +1, got {sign}')
    if dtype is None:
        dtype = config.precision_complex
    dev = resolve_device(device)
    x, y, fx, fy = (np.asarray(v, dtype=np.float64) for v in (x, y, fx, fy))
    Nx, Ny = len(x), len(y)
    Mx, My = len(fx), len(fy)
    dx = _uniform_spacing(x, 'x')
    dy = _uniform_spacing(y, 'y')
    dfx = _uniform_spacing(fx, 'fx')
    dfy = _uniform_spacing(fy, 'fy')
    Kx = _fft_compatible_length(dx * dfx, Nx, Mx, 'x/fx')
    Ky = _fft_compatible_length(dy * dfy, Ny, My, 'y/fy')
    prefix = sign * 2j * np.pi
    pre_x = np.exp(prefix * np.arange(Nx, dtype=np.float64) * dx * float(fx[0]))
    pre_y = np.exp(prefix * np.arange(Ny, dtype=np.float64) * dy * float(fy[0]))
    post_x = np.exp(prefix * float(x[0]) * fx)
    post_y = np.exp(prefix * float(y[0]) * fy)
    parts = {name: _complex_tensor(arr, dtype, dev) for name, arr in (
        ('pre_x', pre_x), ('pre_y', pre_y[:, None]), ('post_x', post_x),
        ('post_y', post_y[:, None]))}
    return FFTDFT(**parts, norm=norm, Nx=Nx, Ny=Ny, Mx=Mx, My=My, Kx=Kx, Ky=Ky,
                  x_direction=sign if dx * dfx > 0 else -sign,
                  y_direction=sign if dy * dfy > 0 else -sign,
                  x_first=_x_first(Nx, Ny, Mx, My, Kx, Ky), pupil_dx=pupil_dx,
                  focal_dx=focal_dx)


def fourier_resample(f, zoom):
    """Resample f by Fourier methods (truncated sinc interpolation).

    The spectrum of f goes through an MDFT with ``sign=+1`` onto the zoomed
    grid; a real f gives a real result.
    """
    if zoom == 1:
        return f
    if isinstance(zoom, (float, int)):
        zoom = (float(zoom), float(zoom))
    else:
        zoom = tuple(float(z) for z in zoom)
    if len(zoom) != 2 or any(z <= 0 for z in zoom):
        raise ValueError('zoom must contain two positive values')

    m, n = f.shape[-2:]
    M = int(m * zoom[0])
    N = int(n * zoom[1])
    if M < 1 or N < 1:
        raise ValueError('zoom produces an empty output')

    ax = (-2, -1)
    F = torch.fft.fftshift(torch.fft.fft2(torch.fft.ifftshift(f, dim=ax), dim=ax), dim=ax)
    x = _host_fftrange(n)
    y = _host_fftrange(m)
    fx = _host_fftrange(N) * (1.0 / zoom[1] / n)
    fy = _host_fftrange(M) * (1.0 / zoom[0] / m)
    plan = plan_mdft(x, y, fx, fy, sign=+1, dtype=F.dtype, device=F.device)
    fprime = plan(F) * (1.0 / (m * n))
    if not f.is_complex():
        fprime = fprime.real
    return fprime
