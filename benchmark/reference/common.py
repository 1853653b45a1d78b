"""Plain physics shared by the references: grids, apertures, Zernike modes, matrix DFTs.

Written from the optics, in plain PyTorch, for the benchmark's judgement of
the program.  Nothing here imports the program: every grid, aperture, mode
and transform matrix is formed again from the numbers a configuration
states.  The default precision is float64.  Two lower precisions exist for
the controls (the comparison that has to fail):

* ``'tf32'``: float32, with TF32 allowed in the matrix products;
* ``'bf16'``: float32, with every stage's output and each transform's
  operands rounded to bfloat16 (products then accumulate in float32, as a
  bfloat16 GEMM does), in the forward pass and, for the cotangents, in the
  backward pass.
"""
import math
from contextlib import contextmanager

import numpy as np
import torch

PRECISIONS = ('f64', 'tf32', 'bf16')


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


class _RoundBF16(torch.autograd.Function):
    """x rounded to bfloat16 (kept in its dtype); the cotangent rounded alike."""

    @staticmethod
    def forward(ctx, x):
        return _bf16(x)

    @staticmethod
    def backward(ctx, grad):
        return _bf16(grad)


class Precision:
    """How a reference computes: its real and complex dtypes and its rounding."""

    def __init__(self, name='f64'):
        if name not in PRECISIONS:
            raise ValueError(f'precision must be one of {PRECISIONS}, got {name!r}')
        self.name = name
        self.real = torch.float64 if name == 'f64' else torch.float32
        self.complex = torch.complex128 if name == 'f64' else torch.complex64

    def round(self, x):
        """x at this precision's stage rounding (bfloat16 for 'bf16'; else x)."""
        if self.name != 'bf16':
            return x
        if x.is_complex():
            return torch.complex(self.round(x.real), self.round(x.imag))
        return _RoundBF16.apply(x)

    @contextmanager
    def matmuls(self):
        """TF32 products for 'tf32' and none otherwise, restored after."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.name == 'tf32'
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def centred(n, dtype=torch.float64, device=None):
    """Sample indices with the zero at n // 2: -(n // 2), ..., n - n // 2 - 1."""
    return torch.arange(n, dtype=dtype, device=device) - (n // 2)


def grid(n, diameter, dtype=torch.float64, device=None):
    """(x, y, dx): an n x n grid of spacing diameter / n, x along columns."""
    dx = diameter / n
    v = centred(n, dtype, device) * dx
    y, x = torch.meshgrid(v, v, indexing='ij')
    return x, y, dx


def polar(x, y):
    """(r, theta) of the points (x, y)."""
    return torch.hypot(x, y), torch.atan2(y, x)


def coverage(d, dx):
    """Pixel coverage of a shape from its signed distance (negative inside)."""
    return torch.clamp(0.5 - d / dx, 0, 1)


def circle_distance(radius, r):
    """Signed distance to a disk."""
    return r - radius


def annulus_distance(r_in, r_out, r):
    """Signed distance to an annulus."""
    return torch.abs(r - (r_in + r_out) / 2) - (r_out - r_in) / 2


def spider_distance(vanes, width, x, y):
    """Signed distance to ``vanes`` straight vanes of full ``width`` from the centre
    outwards, the first along -x, the others turned by 2 pi / vanes each."""
    d = None
    for j in range(vanes):
        a = 2 * math.pi * j / vanes
        along = x * math.cos(a) - y * math.sin(a)
        across = x * math.sin(a) + y * math.cos(a)
        vane = torch.hypot(torch.clamp(along, max=0), across) - width / 2
        d = vane if d is None else torch.minimum(d, vane)
    return d


def zernike_radial(n, m, r):
    """R_n^|m|(r) by its finite sum."""
    m = abs(m)
    out = torch.zeros_like(r)
    for k in range((n - m) // 2 + 1):
        c = ((-1) ** k * math.factorial(n - k)
             / (math.factorial(k) * math.factorial((n + m) // 2 - k)
                * math.factorial((n - m) // 2 - k)))
        out = out + c * r ** (n - 2 * k)
    return out


def zernike(n, m, r, t):
    """The Zernike mode (n, m) of unit RMS over the unit disk: cos for m >= 0, sin below."""
    norm = math.sqrt(2 * (n + 1) / (1 + (m == 0)))
    out = norm * zernike_radial(n, m, r)
    if m > 0:
        out = out * torch.cos(m * t)
    elif m < 0:
        out = out * torch.sin(-m * t)
    return out


def zernike_stack(nms, r, t):
    """(K, *r.shape) modes in the order of ``nms``."""
    return torch.stack([zernike(n, m, r, t) for n, m in nms])


def dft_matrix(n_out, d_out, n_in, d_in, scale, dtype, device):
    """exp(-2 pi i f x): f = centred(n_out) d_out scale, x = centred(n_in) d_in, in float64,
    rounded once to ``dtype``."""
    f = centred(n_out, device=device) * (d_out * scale)
    x = centred(n_in, device=device) * d_in
    return torch.polar(torch.ones((), dtype=torch.float64, device=device),
                       -2 * math.pi * torch.outer(f, x)).to(dtype)


class Focus:
    """The Fraunhofer focus of a pupil field by matrix DFT: pupil samples dx (mm) ->
    focal samples fdx (um) at wavelength wvl (um) and focal length efl (mm)."""

    def __init__(self, n, dx, fn, fdx, wvl, efl, prec, device):
        scale = 1.0 / (wvl * efl)
        self.prec = prec
        self.E = prec.round(dft_matrix(fn, fdx, n, dx, scale, prec.complex, device))
        self.norm = dx * fdx * scale

    def __call__(self, field):
        """(..., n, n) pupil field -> (..., fn, fn) focal field."""
        with self.prec.matmuls():
            return (self.E @ self.prec.round(field) @ self.E.T) * self.norm


def field(amp, opd_nm, wvl, prec):
    """amp exp(i 2 pi opd / wvl): opd in nm, wvl in um."""
    phase = (2 * math.pi / (wvl * 1e3)) * opd_nm
    return prec.round(torch.polar(amp.to(prec.real), phase.to(prec.real)))


def intensity(E):
    """|E|^2."""
    return E.real * E.real + E.imag * E.imag


def rotation_matrix(zyx_degrees):
    """R = Rx Ry Rz from (Z, Y, X) Euler angles in degrees, float64 numpy."""
    g, b, a = np.radians(np.asarray(zyx_degrees, dtype=np.float64))
    rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
    rz = np.array([[np.cos(g), -np.sin(g), 0], [np.sin(g), np.cos(g), 0], [0, 0, 1]])
    return rx @ ry @ rz


def peak_error(got, want, scale=None):
    """max |got - want| over max |scale| (``want`` where no scale is given)."""
    got = got.to(want.dtype)
    scale = want if scale is None else scale
    return float(torch.max(torch.abs(got - want)) / torch.max(torch.abs(scale)))
