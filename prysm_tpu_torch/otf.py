"""MTF/PTF/OTF from PSFs, encircled energy, and atmospheric OTF analytics.

Counterpart of ``prysm_tpu/otf.py``.  The forward paths are plain torch,
differentiable by autograd; the explicit ``*_adjoint`` functions are the
hand-derived adjoints (with the centre-normalization coupling term), held
against autograd in the tests.  All transforms act on the trailing two
axes.
"""
import functools
import math
import numbers

import torch

from ._richdata import RichData
from .conf import config, resolve_device, to_tensor
from .coordinates import make_xy_grid
from .mathops import _j1

__all__ = ['transform_psf', 'transform_psf_adjoint', 'mtf_from_psf', 'ptf_from_psf',
           'otf_from_psf', 'mtf_ptf_otf_from_psf', 'mtf_from_psf_adjoint',
           'ptf_from_psf_adjoint', 'otf_from_psf_adjoint', 'encircled_energy',
           'encircled_energy_adjoint', 'analytical_encircled_energy_circular_aperture',
           'diffraction_limited_mtf', 'longexposure_otf', 'komogorov', 'estimate_Cn']

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


def mtf_ptf_otf_from_psf(psf, dx=None, return_more=False):
    """(MTF, PTF, OTF) from one forward transform."""
    normalized, data, df = _normalized_transform(psf, dx)
    mtf = RichData(data=torch.abs(normalized), dx=df, wavelength=None)
    ptf = RichData(data=torch.angle(normalized), dx=df, wavelength=None)
    otf = RichData(data=normalized, dx=df, wavelength=None)
    if return_more:
        return mtf, ptf, otf, data
    return mtf, ptf, otf


def _subtract_at_center(data_bar, correction, cy, cx):
    """data_bar with ``correction`` taken from its (cy, cx) sample, out of place."""
    out = data_bar.clone()
    out[..., cy, cx] -= correction
    return out


def mtf_from_psf_adjoint(mtf_bar, psf=None, dx=None, data=None):
    """Adjoint of mtf_from_psf, including the centre-normalization coupling."""
    if data is None:
        data, _ = transform_psf(psf, dx)
    cy, cx = _center(data.shape)
    mag = torch.abs(data)
    a = mag[..., cy, cx]
    data_bar = mtf_bar * data / mag / a[..., None, None]
    S = torch.sum(mtf_bar * mag, dim=_AX)
    correction = S * data[..., cy, cx] / a ** 3
    return torch.real(transform_psf_adjoint(_subtract_at_center(data_bar, correction, cy, cx)))


def ptf_from_psf_adjoint(ptf_bar, psf=None, dx=None, data=None):
    """Adjoint of ptf_from_psf, including the centre-phase reference term."""
    if data is None:
        data, _ = transform_psf(psf, dx)
    cy, cx = _center(data.shape)
    msq = data.real * data.real + data.imag * data.imag
    data_bar = ptf_bar * 1j * data / msq
    correction = torch.sum(ptf_bar, dim=_AX) * 1j * data[..., cy, cx] / msq[..., cy, cx]
    return torch.real(transform_psf_adjoint(_subtract_at_center(data_bar, correction, cy, cx)))


def otf_from_psf_adjoint(otf_bar, psf=None, dx=None, data=None):
    """Adjoint of otf_from_psf, including the centre-normalization coupling."""
    if data is None:
        data, _ = transform_psf(psf, dx)
    cy, cx = _center(data.shape)
    cc = torch.conj(data[..., cy, cx])
    data_bar = otf_bar / cc[..., None, None]
    correction = torch.sum(torch.conj(data) * otf_bar, dim=_AX) / cc ** 2
    return torch.real(transform_psf_adjoint(_subtract_at_center(data_bar, correction, cy, cx)))


# ---------------------------------------------------------------------------
# encircled energy (Baliga & Cohn MTF-Hankel method)
# ---------------------------------------------------------------------------

def _encircled_energy_geometry(shape, df, dtype, device):
    """Radial frequency grid (zero bin nudged) and frequency cell deltas."""
    nx, ny = make_xy_grid(tuple(shape[-2:]), dx=df, dtype=dtype, device=device)
    nu_p = torch.hypot(nx, ny)
    nu_p = torch.where(nu_p == 0, torch.full_like(nu_p, 1e-16), nu_p)
    dnx = ny[1, 0] - ny[0, 0]
    dny = nx[0, 1] - nx[0, 0]
    return nu_p, dnx, dny


def _encircled_energy_core(mtf_data, radius, nu_p, dx, dy):
    """EE(radius) = radius * sum(MTF * J1(2 pi radius nu)/nu) * dx * dy."""
    integration_fourier = _j1(2 * math.pi * radius * nu_p) / nu_p
    return radius * torch.sum(mtf_data * integration_fourier, dim=_AX) * dx * dy


@functools.lru_cache(maxsize=8)
def _encircled_energy_rfft_weights(shape, dxv, radii, dtype, device):
    """The Baliga-Cohn weights J1(2 pi r nu)/nu on the rfft2 half plane, one per radius.

    Static geometry: built once per (shape, dx, radii, dtype, device) and
    reused, where XLA hoists it out of the JAX package's loops.  The
    interior kx columns count twice: they stand in for their conjugate
    mirrors.  ``df`` is the y-derived step on both axes, as in the JAX
    package.
    """
    Ny, Nx = shape
    df = 1000 / (Ny * dxv)
    ky = torch.arange(Ny, device=device)
    fy = torch.where(ky <= Ny // 2, ky, ky - Ny).to(dtype) * df
    fx = torch.arange(Nx // 2 + 1, device=device).to(dtype) * df
    nu = torch.hypot(fy[:, None], fx[None, :])
    nu = torch.where(nu == 0, torch.full_like(nu, 1e-16), nu)
    mult = torch.ones(Nx // 2 + 1, dtype=dtype, device=device)
    mult[1:Nx // 2] = 2.0
    return tuple(_j1(2 * math.pi * (r / 1e3) * nu) / nu * mult[None, :] for r in radii)


def _encircled_energy_rfft(psf, dxv, radii):
    """EE on the rfft2 half plane: one rfft2, one multiply and one reduction per radius.

    The weight is even in both frequency axes, so the full-plane sum is the
    half-plane sum with the interior kx columns counted twice
    (|F(-k)| = |F(k)| for a real PSF).  The input ifftshift is dropped: it
    only flips signs under the magnitude.  Needs even trailing dims.
    """
    Ny, Nx = psf.shape[-2:]
    half = torch.abs(torch.fft.rfft2(psf, dim=_AX))       # (..., Ny, Nx//2+1)
    df = 1000 / (Ny * dxv)
    weights = _encircled_energy_rfft_weights((Ny, Nx), float(dxv), tuple(radii),
                                             psf.dtype, psf.device)
    center = half[..., 0, 0]
    return [(r / 1e3) * (torch.sum(half * w, dim=_AX) / center) * df * df
            for r, w in zip(radii, weights)]


def encircled_energy(psf, dx, radius, return_more=False):
    """Encircled energy of a PSF at radius (um), Baliga-Cohn method.

    An even, real PSF takes the rfft2 half plane; other PSFs, and
    ``return_more``, take the full-plane MTF.
    """
    radii = (radius,) if isinstance(radius, numbers.Number) else tuple(radius)
    unwrapped, dxv = _unwrap_psf(psf, dx)
    even = all(s % 2 == 0 for s in unwrapped.shape[-2:])
    if not return_more and even and not unwrapped.is_complex():
        out = _encircled_energy_rfft(unwrapped, dxv, radii)
        return out[0] if isinstance(radius, numbers.Number) else torch.stack(out)
    mtf, data = mtf_from_psf(psf, dx, return_more=True)
    nu_p, dnx, dny = _encircled_energy_geometry(mtf.shape, mtf.dx, mtf.data.dtype,
                                                mtf.data.device)
    out = [_encircled_energy_core(mtf.data, r / 1e3, nu_p, dnx, dny) for r in radii]
    out = out[0] if isinstance(radius, numbers.Number) else torch.stack(out)
    if return_more:
        return out, data
    return out


def encircled_energy_adjoint(ee_bar, psf=None, dx=None, radius=None, data=None):
    """Adjoint of encircled_energy: fold the per-radius cotangents back to the PSF."""
    if data is not None:
        if dx is None:
            raise ValueError('dx is None: dx must be provided to set the frequency grid')
        shape, dxv, like = data.shape, dx, data.real
    else:
        arr, dxv = _unwrap_psf(psf, dx)
        shape, like = arr.shape, arr
    df = 1000 / (shape[-2] * dxv)
    nu_p, dnx, dny = _encircled_energy_geometry(shape, df, like.dtype, like.device)
    if isinstance(radius, numbers.Number):
        radii, ee_bar = (radius,), (ee_bar,)
    else:
        radii = radius
    mtf_bar = 0.0
    for rb, r in zip(ee_bar, radii):
        ri = r / 1e3
        kernel = _j1(2 * math.pi * ri * nu_p) / nu_p
        mtf_bar = mtf_bar + rb * ri * kernel * dnx * dny
    return mtf_from_psf_adjoint(mtf_bar, psf=psf, dx=dx, data=data)


def analytical_encircled_energy_circular_aperture(fno, wavelength, points):
    """Analytical encircled energy of a diffraction-limited circular aperture.

    EE(r) = 1 - J0^2(pi r / (wvl fno)) - J1^2(pi r / (wvl fno)).
    """
    p = to_tensor(points) * math.pi / fno / wavelength
    return 1 - _j0(p) ** 2 - _j1(p) ** 2


def _j0(x):
    """Bessel J0 by the Abramowitz & Stegun rational approximations."""
    x = to_tensor(x)
    ax = torch.abs(x)
    y = x * x
    num_s = 57568490574.0 + y * (-13362590354.0 + y * (651619640.7 + y * (
        -11214424.18 + y * (77392.33017 + y * -184.9052456))))
    den_s = 57568490411.0 + y * (1029532985.0 + y * (9494680.718 + y * (
        59272.64853 + y * (267.8532712 + y))))
    small = num_s / den_s
    z = 8.0 / torch.clamp(ax, min=1e-30)
    yb = z * z
    xx = ax - 0.785398164
    p0 = 1.0 + yb * (-0.1098628627e-2 + yb * (0.2734510407e-4 + yb * (
        -0.2073370639e-5 + yb * 0.2093887211e-6)))
    p1 = -0.1562499995e-1 + yb * (0.1430488765e-3 + yb * (-0.6911147651e-5 + yb * (
        0.7621095161e-6 + yb * -0.934935152e-7)))
    big = torch.sqrt(0.636619772 / torch.clamp(ax, min=1e-30)) * (
        torch.cos(xx) * p0 - z * torch.sin(xx) * p1)
    return torch.where(ax < 8.0, small, big)


def diffraction_limited_mtf(fno, wavelength, frequencies=None, samples=128, dtype=None,
                            device=None):
    """Diffraction limited MTF for a circular pupil.

    Returns (frequencies, mtf) if frequencies is None (``samples`` points
    in ``dtype`` on ``device``), else the MTF at the given frequencies
    (cy/mm).
    """
    extinction = 1 / (wavelength / 1000 * fno)
    if frequencies is None:
        normalized_frequency = torch.linspace(
            0, 1, samples, dtype=config.precision if dtype is None else dtype,
            device=resolve_device(device))
    else:
        normalized_frequency = torch.abs(to_tensor(frequencies, device) / extinction)
        normalized_frequency = torch.clamp(normalized_frequency, max=1)
    mtf = _difflim_mtf_core(normalized_frequency)
    if frequencies is None:
        return normalized_frequency * extinction, mtf
    return mtf


def _difflim_mtf_core(normalized_frequency):
    """(2/pi)(arccos(nu) - nu sqrt(1 - nu^2))."""
    nu = normalized_frequency
    return (2 / math.pi) * (torch.arccos(nu) - nu * torch.sqrt(1 - nu ** 2))


def longexposure_otf(nu, Cn, z, f, lambdabar, h_z_by_r=2.91):
    """Long exposure atmospheric OTF (Goodman, Statistical Optics 8.5-37/38)."""
    nu = to_tensor(nu) / 1e3
    f = f / 1e3
    lambdabar = lambdabar / 1e6
    power = 5 / 3
    const1 = -math.pi ** 2 * 2 * h_z_by_r * Cn ** 2
    const2 = z * f ** power / (lambdabar ** 3)
    return torch.exp(const1 * const2 * nu ** power)


def komogorov(r, r0):
    """Kolmogorov phase structure function D_phi = 6.88 (r/r0)^(5/3)."""
    return 6.88 * (r / r0) ** (5 / 3)


def estimate_Cn(P=1013, T=273.15, Ct=1e-4):
    """Estimate Cn from meteorological data (Weng et al)."""
    return (79 * P / (T ** 2)) * Ct ** 2 * 1e-12
