"""Phase Shifting Interferometry.

Counterpart of ``prysm_tpu/x/psi.py``.  The de Groot accumulation is a
mode-weighted sum over frames (``sum_of_2d_modes``, one contraction);
phase unwrapping is the unweighted least-squares Poisson solve of Ghiglia
and Romero, by the orthonormal 2-D DCT-II.  Torch has no DCT, so
``dctn2``/``idctn2`` build it from ``torch.fft`` by Makhoul's reordering,
for even and odd sizes.
"""
import math
from collections import namedtuple

import numpy as np
import torch

from ..conf import to_tensor
from ..fttools import _host_fftrange
from .._richdata import RichData
from ..polynomials import sum_of_2d_modes

__all__ = ['Scheme', 'ZYGO_THIRTEEN_FRAME', 'SCHWIDER', 'psi_accumulate',
           'degroot_formalism_psi', 'design_scheme', 'dctn2', 'idctn2', 'unwrap_phase']

Scheme = namedtuple('Scheme', ['shifts', 's', 'c'])

ZYGO_THIRTEEN_FRAME = Scheme(
    _host_fftrange(13) * np.pi / 4,
    np.asarray((-3, -4, 0, 12, 21, 16, 0, -16, -21, -12, 0, 4, 3)),
    np.asarray((0, -4, -12, -12, 0, 16, 24, 16, 0, -12, -12, -4, 0)),
)

SCHWIDER = Scheme(
    _host_fftrange(5) * np.pi / 2,
    np.asarray((0, 2, 0, -2, 0)),
    np.asarray((-1, 0, 2, 0, -1)),
)


def psi_accumulate(gs, scheme):
    """Accumulate PSI numerator (sine) and denominator (cosine) images."""
    if isinstance(gs, (list, tuple)):
        gs = torch.stack([to_tensor(g) for g in gs])
    gs = to_tensor(gs)
    return sum_of_2d_modes(gs, scheme.s), sum_of_2d_modes(gs, scheme.c)


def degroot_formalism_psi(gs, scheme):
    """de Groot's PSI formalism -> wrapped phase estimate."""
    was_rd = isinstance(gs[0], RichData)
    if was_rd:
        g00 = gs[0]
        gs = [g.data for g in gs]
    num, den = psi_accumulate(gs, scheme)
    out = torch.atan2(num, den)
    if was_rd:
        out = RichData(out, g00.dx, g00.wavelength)
    return out


def design_scheme(N, stepsize=None, window=None):
    """Design a PSI scheme of N steps, optionally windowed (host numpy)."""
    if stepsize is None:
        stepsize = (2 * np.pi) / (N - 1)
    shifts = _host_fftrange(N) * stepsize
    s = np.sin(shifts)
    c = np.cos(shifts)
    if window is not None:
        if isinstance(window, str):
            from scipy import signal
            window = signal.windows.get_window(window, N)
        s = s * window
        c = c * window
    return Scheme(shifts, s, c)


def _dct_scale(N, like):
    """The orthonormal DCT-II's factors: sqrt(1/4N) for k = 0, sqrt(1/2N) after."""
    f = torch.full((N,), math.sqrt(1 / (2 * N)), dtype=like.dtype, device=like.device)
    f[0] = math.sqrt(1 / (4 * N))
    return f


def _twiddle(N, sign, like):
    """exp(sign i pi k / 2N) for k < N."""
    k = torch.arange(N, dtype=like.dtype, device=like.device)
    return torch.polar(torch.ones_like(k), sign * math.pi * k / (2 * N))


def _dct_last(x):
    """Orthonormal DCT-II along the last axis (Makhoul: one FFT of length N)."""
    N = x.shape[-1]
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1)
    X = 2 * (torch.fft.fft(v, dim=-1) * _twiddle(N, -1, x)).real
    return X * _dct_scale(N, x)


def _idct_last(X):
    """Inverse of the orthonormal DCT-II (the orthonormal DCT-III) along the last axis."""
    N = X.shape[-1]
    Xu = X / _dct_scale(N, X)
    # X_{N-k}, with X_N = 0
    Xr = torch.cat([torch.zeros_like(Xu[..., :1]), Xu[..., 1:].flip(-1)], dim=-1)
    V = 0.5 * _twiddle(N, 1, X) * torch.complex(Xu, -Xr)
    v = torch.fft.ifft(V, dim=-1).real
    h = (N + 1) // 2
    x = torch.empty_like(v)
    x[..., ::2] = v[..., :h]
    x[..., 1::2] = v[..., h:].flip(-1)
    return x


def dctn2(x):
    """Orthonormal 2-D DCT-II over the last two axes (scipy.fft.dctn, type 2, 'ortho')."""
    return _dct_last(_dct_last(x).transpose(-1, -2)).transpose(-1, -2)


def idctn2(X):
    """Inverse of dctn2 (scipy.fft.idctn, type 2, 'ortho')."""
    return _idct_last(_idct_last(X).transpose(-1, -2)).transpose(-1, -2)


def unwrap_phase(wrapped, mask=None):
    """Unwrap phase via DCT-based least-squares (Ghiglia & Romero 1994).

    Solves the discrete Poisson equation whose source is the divergence of
    the wrapped phase gradients.  Unweighted, so exact only for residue-free
    phase; for masked data, fill invalid regions beforehand (e.g. with 0).
    """
    was_rd = isinstance(wrapped, RichData)
    if was_rd:
        w0 = wrapped
        wrapped = wrapped.data
    psi = to_tensor(wrapped)
    if mask is not None:
        psi = torch.where(torch.as_tensor(mask, device=psi.device), psi, 0.0)

    def wrap(d):
        return (d + math.pi) % (2 * math.pi) - math.pi

    dy = wrap(torch.diff(psi, dim=0))
    dx = wrap(torch.diff(psi, dim=1))
    # divergence with Neumann boundaries
    pad = torch.nn.functional.pad
    rho = pad(dy, (0, 0, 0, 1))
    rho = rho - pad(dy, (0, 0, 1, 0))
    rho = rho + pad(dx, (0, 1, 0, 0))
    rho = rho - pad(dx, (1, 0, 0, 0))

    N0, N1 = psi.shape
    RHO = dctn2(rho)
    k0 = torch.arange(N0, dtype=psi.dtype, device=psi.device)
    k1 = torch.arange(N1, dtype=psi.dtype, device=psi.device)
    denom = (2 * torch.cos(math.pi * k0 / N0)[:, None]
             + 2 * torch.cos(math.pi * k1 / N1)[None, :] - 4)
    dc = torch.zeros_like(denom, dtype=torch.bool)
    dc[0, 0] = True
    PHI = torch.where(dc, 0.0, RHO / torch.where(dc, 1.0, denom))
    out = idctn2(PHI)

    # restore the mean of the wrapped input (unwrap is defined up to 2 pi k)
    offset = torch.round((psi - out).mean() / (2 * math.pi)) * 2 * math.pi
    out = out + offset
    if was_rd:
        out = RichData(out, w0.dx, w0.wavelength)
    return out
