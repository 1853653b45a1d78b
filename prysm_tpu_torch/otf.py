"""MTF/PTF/OTF from PSFs.

Counterpart of ``prysm_tpu/otf.py`` (the main path's part; encircled
energy and the analytic helpers come with a later slice).  The forward
paths are plain torch, differentiable by autograd; all transforms act on
the trailing two axes.
"""
import math

import torch

from ._richdata import RichData

__all__ = ['transform_psf', 'transform_psf_adjoint', 'mtf_from_psf',
           'ptf_from_psf', 'otf_from_psf']

_AX = (-2, -1)


def _center(shape):
    """Pixel index of the (floor) center of a 2D array of given shape."""
    return tuple(int(math.floor(s / 2)) for s in shape[-2:])


def _unwrap_psf(psf, dx):
    """Resolve a PSF container-or-tensor to (tensor, dx)."""
    if isinstance(psf, RichData):
        dx = psf.dx
        psf = psf.data
    if dx is None:
        raise ValueError('dx is None: dx must be provided if psf is an array')
    return psf, dx


def transform_psf(psf, dx=None):
    """Transform a PSF to k-space: fftshift(fft2(ifftshift(psf))); returns (data, df)."""
    psf, dx = _unwrap_psf(psf, dx)
    data = torch.fft.fftshift(
        torch.fft.fft2(torch.fft.ifftshift(psf, dim=_AX), dim=_AX), dim=_AX)
    df = 1000 / (data.shape[-2] * dx)  # cy/um to cy/mm
    return data, df


def transform_psf_adjoint(data_bar):
    """Adjoint of transform_psf: the unnormalized inverse transform."""
    return torch.fft.fftshift(
        torch.fft.ifft2(torch.fft.ifftshift(data_bar, dim=_AX), dim=_AX, norm='forward'),
        dim=_AX)


def _normalized_transform(psf, dx):
    """Forward-transform a PSF and divide by its central value."""
    data, df = transform_psf(psf, dx)
    cy, cx = _center(data.shape)
    return data / data[..., cy:cy + 1, cx:cx + 1], data, df


def _mtf_magnitude_rfft(psf):
    """|fftshift(fft2(ifftshift(psf)))| for a REAL psf via rfft2 + mirror.

    Hermitian symmetry |F(-k)| = |F(k)| rebuilds the full magnitude plane
    from the rfft2 half plane, about half the FFT work.  Needs even
    trailing dims.  The input ifftshift only flips signs per frequency for
    even dims, which the magnitude erases, so it is skipped; the shifted
    plane is assembled directly from the half plane.
    """
    My, M = psf.shape[-2:]
    half = torch.abs(torch.fft.rfft2(psf, dim=_AX))        # (..., My, M//2+1)
    # shifted (q, p) is unshifted ((q + My/2) % My, p - M/2); for p < M/2
    # the mirror |F(ky, kx)| = |F(-ky % My, M - kx)| supplies it
    right = torch.roll(half[..., :, :M // 2], -(My // 2), dims=-2)
    left = torch.roll(torch.flip(half[..., :, 1:M // 2 + 1], dims=(-1, -2)),
                      My // 2 + 1, dims=-2)
    return torch.cat([left, right], dim=-1)


def mtf_from_psf(psf, dx=None, return_more=False):
    """MTF = |center-normalized transform of the PSF| as RichData."""
    unwrapped, dxv = _unwrap_psf(psf, dx)
    even = all(s % 2 == 0 for s in unwrapped.shape[-2:])
    if not return_more and even and not unwrapped.is_complex():
        mag = _mtf_magnitude_rfft(unwrapped)
        cy, cx = _center(mag.shape)
        df = 1000 / (mag.shape[-2] * dxv)
        return RichData(data=mag / mag[..., cy:cy + 1, cx:cx + 1], dx=df,
                        wavelength=None)
    normalized, data, df = _normalized_transform(psf, dx)
    rd = RichData(data=torch.abs(normalized), dx=df, wavelength=None)
    if return_more:
        return rd, data
    return rd


def ptf_from_psf(psf, dx=None, return_more=False):
    """PTF = angle of the center-normalized transform of the PSF.

    Normalizing before taking the angle references the phase to the
    central value with the JAX package's wrap placement.
    """
    normalized, data, df = _normalized_transform(psf, dx)
    rd = RichData(data=torch.angle(normalized), dx=df, wavelength=None)
    if return_more:
        return rd, data
    return rd


def otf_from_psf(psf, dx=None, return_more=False):
    """OTF = center-normalized complex transform of the PSF."""
    normalized, data, df = _normalized_transform(psf, dx)
    rd = RichData(data=normalized, dx=df, wavelength=None)
    if return_more:
        return rd, data
    return rd
