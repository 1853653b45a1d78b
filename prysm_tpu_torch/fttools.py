"""Fourier transform tooling: grids, padding, and the matrix-DFT plan.

Counterpart of ``prysm_tpu/fttools.py`` (the main path's part).  The
FFT-alignment conventions of ``fftrange``/``pad2d``/``crop_center`` are
kept exactly: the left/top side receives the extra sample.  MDFT bases are
built on the host in float64, then cast to the working complex dtype and
kept on the plan's device as native complex tensors.
"""
import math
from contextlib import contextmanager

import numpy as np
import torch

from .conf import config, resolve_device

__all__ = ['fftrange', 'fftfreq', 'forward_ft_unit', 'pad2d', 'crop_center',
           'MDFT', 'plan_mdft']


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


def _pad_split(delta):
    """(left, right) padding of delta samples; the left side takes the extra one."""
    left = math.ceil(delta / 2)
    return left, delta - left


def pad2d(array, Q=2, value=0, out_shape=None):
    """Symmetrically zero- (or ``value``-) pad the trailing two axes, FFT-aligned."""
    if Q == 1 and out_shape is None:
        return array
    in_shape = array.shape[-2:]
    if out_shape is None:
        out_shape = tuple(math.ceil(s * Q) for s in in_shape)
    elif isinstance(out_shape, int):
        out_shape = (out_shape, out_shape)
    (top, bottom), (left, right) = (_pad_split(o - s)
                                    for o, s in zip(out_shape, in_shape))
    return torch.nn.functional.pad(array, (left, right, top, bottom), value=value)


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
    JAX transpose's.
    """

    @staticmethod
    def forward(ctx, ary, plan, adjoint):
        ctx.plan = plan
        ctx.adjoint = adjoint
        with _tf32_matmuls():
            return plan._apply(ary, adjoint)

    @staticmethod
    def backward(ctx, grad):
        with _tf32_matmuls():
            return ctx.plan._apply(grad, not ctx.adjoint), None, None


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
        Ex=torch.from_numpy(Ex).to(device=dev, dtype=dtype),
        Ey=torch.from_numpy(Ey).to(device=dev, dtype=dtype),
        norm=norm, forward_left_first=fwd_left, adjoint_left_first=adj_left,
        pupil_dx=pupil_dx, focal_dx=focal_dx, matmul_precision=matmul_precision)
