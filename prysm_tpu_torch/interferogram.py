"""Interferometric data analysis: PSD, filtering, synthesis, Interferogram.

Counterpart of ``prysm_tpu/interferogram.py``.  The array math is torch on
the data's device, NaN-tolerant through masked reductions (``util``).
Operations whose result shape depends on the data (cropping to the valid
region) and the choice of a window read the data back to the host once.

Random synthesis takes a ``torch.Generator`` where the JAX package takes a
``jax.random`` key.  The uniform draw is kept apart from the synthesis
(``synthesize_surface_from_draws``), so that both packages can be fed the
same draws.  ``fit_psd`` descends with torch autograd in float64 on its
inputs' device.
"""
import inspect
import math
import warnings

import numpy as np
import torch

from ._richdata import RichData
from .conf import config, resolve_device, to_tensor
from .mathops import jinc
from .io import (
    read_zygo_dat,
    read_zygo_datx,
    write_zygo_ascii,
    write_zygo_dat,
)
from .fttools import forward_ft_unit, pad2d
from .coordinates import cart_to_polar, broadcast_1d_to_2d, make_xy_grid
from .polynomials import lstsq
from .util import mean, rms, pv, Sa, std  # NOQA
from .wavelengths import HeNe
from .plotting import share_fig_ax

__all__ = ['fit_plane', 'fit_sphere', 'window_2d_welch', 'make_window', 'psd',
           'bandlimited_rms', 'abc_psd', 'ab_psd', 'synthesize_surface_from_psd',
           'synthesize_surface_from_draws', 'render_synthetic_surface', 'fit_psd', 'hann2d',
           'ideal_lpf_iir2d', 'designfilt2d', 'make_random_subaperture_mask',
           'Interferogram']


def _rmax_square_array(r):
    loc = list(r.shape)
    loc[1] = loc[1] // 2
    loc[0] = loc[0] - 1
    return r[tuple(loc)]


def _to_host(t):
    return t.detach().cpu().numpy()


def fit_plane(x, y, z):
    """Least-squares plane fit; returns the plane evaluated on (x, y)."""
    coefs = lstsq(torch.stack([torch.broadcast_to(x, z.shape),
                               torch.broadcast_to(y, z.shape)]), z)
    return coefs[0] * x + coefs[1] * y


def fit_sphere(z):
    """Least-squares sphere (power) fit; returns (finite mask, sphere)."""
    x = torch.linspace(-1, 1, z.shape[1], dtype=z.dtype, device=z.device)
    y = torch.linspace(-1, 1, z.shape[0], dtype=z.dtype, device=z.device)
    yy, xx = torch.meshgrid(y, x, indexing='ij')
    pts = torch.isfinite(z)
    focus = xx * xx + yy * yy
    # weighted normal equations over finite points (static shapes)
    A = torch.stack([focus.ravel(), torch.ones_like(focus).ravel()], dim=1)
    w = pts.ravel()
    zz = torch.where(w, z.ravel(), 0)
    Aw = A * w[:, None]
    coefs = torch.linalg.solve(Aw.T @ A, Aw.T @ zz)
    return pts, focus * coefs[0]


def window_2d_welch(r, alpha=8):
    """2D Welch window, 1 - |r/rmax|^alpha."""
    rmax = _rmax_square_array(r)
    return 1 - torch.abs(r / rmax) ** alpha


def _hann_outer(shape, like):
    y = torch.hann_window(shape[0], periodic=False, dtype=like.dtype, device=like.device)
    x = torch.hann_window(shape[1], periodic=False, dtype=like.dtype, device=like.device)
    return torch.outer(y, x)


def _welch(shape, dx, alpha, like):
    x, y = make_xy_grid(tuple(shape), dx=dx, dtype=like.dtype, device=like.device)
    r, _ = cart_to_polar(x, y)
    return window_2d_welch(r, alpha=alpha)


def make_window(signal, dx, which=None, alpha=4):
    """Window for PSD analysis; auto-selects Welch (circular) or Hann.

    With ``which=None`` one boolean is read back to the host, whether the
    signal's four corners are all zero: a circular aperture (Welch) or a
    full-field map (Hann).
    """
    s = signal.shape
    if which is None:
        ys = int(round(s[0] * 0.02, 0))
        xs = int(round(s[1] * 0.02, 0))
        # the corners as numpy slices them (a -0 start is the whole axis)
        corners = torch.cat([c.reshape(-1) for c in (
            signal[:ys, :xs], signal[-ys:, :xs], signal[:ys, -xs:], signal[-ys:, -xs:])])
        if bool((corners == 0).all()):
            return _welch(s, dx, alpha, signal)
        return _hann_outer(s, signal)
    if isinstance(which, str):
        wl = which.lower()
        if wl == 'welch':
            return _welch(s, dx, alpha, signal)
        if wl in ('hann', 'hanning'):
            return _hann_outer(s, signal)
        raise ValueError('unknown window type')
    return which


def psd(height, dx, window=None):
    """Power spectral density (GH_FFT normalization): (ux, uy, psd)."""
    window = make_window(height, dx, window)
    if not torch.is_tensor(window):
        window = torch.as_tensor(np.asarray(window), dtype=height.dtype, device=height.device)
    ft = torch.fft.ifftshift(torch.fft.fft2(torch.fft.fftshift(height * window)))
    psd_ = torch.abs(ft) ** 2
    fs = 1 / dx
    S2 = torch.sum(window ** 2)
    psd_ = psd_ / (S2 * fs * fs)
    ux = forward_ft_unit(dx, height.shape[1], dtype=height.dtype, device=height.device)
    uy = forward_ft_unit(dx, height.shape[0], dtype=height.dtype, device=height.device)
    ux, uy = broadcast_1d_to_2d(ux, uy)
    return ux, uy, psd_


def _trapezoid(y, dx):
    """The trapezoid rule along axis 0 at uniform spacing dx."""
    return 0.5 * torch.sum(dx * (y[1:] + y[:-1]), dim=0)


def bandlimited_rms(r, psd, wllow=None, wlhigh=None, flow=None, fhigh=None):
    """Bandlimited RMS from a PSD between spatial periods or frequencies."""
    default_max = r.max()
    if wllow is not None or wlhigh is not None:
        # period arguments take precedence; this truth table keeps the
        # reference's quirk that a lone wllow pins only the warning path,
        # not fhigh
        flow = None if wlhigh is None else 1 / wlhigh
        fhigh = (default_max if wlhigh is None
                 else (1 / wllow if wllow is not None else None))
    elif flow is not None or fhigh is not None:
        flow = 0 if flow is None else flow
        fhigh = default_max if fhigh is None else fhigh
    else:
        raise ValueError('must specify either period (wavelength) or frequency')
    if flow is None:
        warnings.warn('no lower limit given, using 0 for low frequency')
        flow = 0
    if fhigh is None:
        warnings.warn('no upper limit given, using limit imposed by data.')
        fhigh = r.max()

    # frequency step from the two samples straddling the grid center
    if r.ndim == 2:
        cy, cx = (s // 2 for s in r.shape)
        df = torch.abs(r[cy - 1, cx] - r[cy, cx])
    else:
        c = r.shape[0] // 2
        df = torch.abs(r[c - 1] - r[c])
    band = torch.where((r < flow) | (r > fhigh), 0, psd)
    total = _trapezoid(band, df)
    if r.ndim == 2:
        total = _trapezoid(total, df)
    return torch.sqrt(total)


def abc_psd(nu, a, b, c):
    """Lorentzian PSD model a / (1 + (nu/b)^c)."""
    return a / (1 + (nu / b) ** c)


def ab_psd(nu, a, b):
    """Inverse-power PSD model a nu^-b."""
    return a * nu ** (-b)


def synthesize_surface_from_draws(psd, nu_x, nu_y, randnums):
    """A surface height map from PSD data, its random phase from uniform draws.

    ``randnums`` holds uniform [0, 1) draws of the PSD's shape; the phase
    is the angle of their FFT.  Returns (x, y, height).
    """
    phase = torch.angle(torch.fft.fft2(randnums))
    fs = -2 * nu_y[0]
    dx = dy = 1 / fs
    ny, nx = psd.shape
    x = torch.arange(nx, dtype=psd.dtype, device=psd.device) * float(dx)
    y = torch.arange(ny, dtype=psd.dtype, device=psd.device) * float(dy)
    A = x[-1] * y[-1]
    signal = torch.complex(torch.cos(phase), torch.sin(phase)) * torch.sqrt(A * psd)
    coef = 1 / dx / dy
    out = torch.fft.ifftshift(torch.fft.ifft2(torch.fft.fftshift(signal))) * float(coef)
    return x, y, out.real


def synthesize_surface_from_psd(psd, nu_x, nu_y, generator=None):
    """Synthesize a surface height map from PSD data (random phase).

    Requires a ``torch.Generator``; the draws are made on its device and
    moved to the PSD's.
    """
    if generator is None:
        raise ValueError('synthesize_surface_from_psd requires a torch.Generator')
    randnums = torch.rand(tuple(psd.shape), generator=generator, dtype=psd.dtype,
                          device=generator.device).to(psd.device)
    return synthesize_surface_from_draws(psd, nu_x, nu_y, randnums)


def _psd_grid(size, samples):
    """(nu, nu_r) of render_synthetic_surface: host arrays in config.precision."""
    dxg = size / (samples - 1)
    nu = forward_ft_unit(dxg, samples, device='cpu').numpy().copy()
    center = samples // 2
    nu[center] = nu[center + 1] / 10
    nu_xx, nu_yy = np.meshgrid(nu, nu)
    return nu, np.hypot(nu_xx, nu_yy)


def render_synthetic_surface(size, samples, rms=None, mask=None,
                             psd_fcn=abc_psd, generator=None, **psd_fcn_kwargs):
    """Render a synthetic surface with given RMS from a PSD model."""
    nu, nu_r = _psd_grid(size, samples)
    psd_ = psd_fcn(to_tensor(nu_r), **psd_fcn_kwargs)
    x, y, z = synthesize_surface_from_psd(psd_, nu, nu, generator=generator)
    if isinstance(mask, str):
        if mask.lower() != 'circle':
            raise ValueError("mask must be an array, None, or 'circle'")
        gx, gy = make_xy_grid(samples, diameter=size, dtype=z.dtype, device=z.device)
        mask = torch.hypot(gx, gy) <= size / 2
    if mask is not None:
        mask = torch.as_tensor(mask, device=z.device)
        z = torch.where(mask == 0, torch.nan, z)
    if rms is not None:
        from .util import rms as rms_fn
        z = z * (rms / rms_fn(z))
    return x, y, z


def _loglog_linear_psd_fit(f, psd):
    """Closed-form least-squares fit of ab_psd in log-log space."""
    logf = torch.log10(f)
    logp = torch.log10(psd)
    lf = logf - logf.mean()
    slope = (lf * (logp - logp.mean())).sum() / (lf * lf).sum()
    a = 10.0 ** (logp.mean() - slope * logf.mean())
    return a, -slope


def _abc_psd_guess(f, psd):
    """Data-derived seed for abc_psd fitting (host-side)."""
    f = _to_host(f)
    psd = _to_host(psd)
    npts = psd.shape[0]
    k = max(3, npts // 10)
    a = float(np.median(psd[:k]))
    _, c = _loglog_linear_psd_fit(torch.from_numpy(f[npts // 2:]),
                                  torch.from_numpy(psd[npts // 2:]))
    c = max(float(c), 0.5)
    below = np.nonzero(psd < (a / 2))[0]
    if below.size > 0:
        b = float(f[below[0]])
    else:
        b = float(np.sqrt(f[0] * f[-1]))
    return [a, b, c]


def fit_psd(f, psd, callable=abc_psd, guess=None, return_='coefficients'):
    """Fit PSD model parameters by log-space least squares.

    ab_psd is solved in closed form; other models run 500 steps of an Adam
    descent on the log residuals, in log parameters (positivity for free),
    with torch autograd in float64 on the inputs' device.  Returns the
    coefficients as a numpy array.
    """
    sig = inspect.signature(callable)
    nparams = len(sig.parameters) - 1
    f = to_tensor(f)
    psd = to_tensor(psd)
    if nparams < 3:
        f = f[5:]
        psd = psd[5:]
    D = torch.log10(psd)

    if callable is ab_psd:
        a, b = _loglog_linear_psd_fit(f, psd)
        return np.asarray([float(a), float(b)])

    if guess is None:
        if callable is abc_psd:
            initial_args = _abc_psd_guess(f, psd)
        else:
            initial_args = [1.0] * nparams
            initial_args[0] = 100.0
    else:
        initial_args = list(guess)

    # the model and residuals in float64, as the JAX package's float64
    # parameters promote them
    f64, D64 = f.to(torch.float64), D.to(torch.float64)
    logx = torch.log(torch.as_tensor(initial_args, dtype=torch.float64, device=f.device))

    def grad(logx):
        logx = logx.detach().requires_grad_(True)
        M = callable(f64, *torch.exp(logx))
        resid = torch.log10(M) - D64
        return torch.autograd.grad(torch.sum(resid * resid), logx)[0]

    lr = 0.05
    m = torch.zeros_like(logx)
    v = torch.zeros_like(logx)
    for i in range(500):
        gi = grad(logx)
        m = 0.9 * m + 0.1 * gi
        v = 0.999 * v + 0.001 * gi * gi
        mhat = m / (1 - 0.9 ** (i + 1))
        vhat = v / (1 - 0.999 ** (i + 1))
        logx = logx - lr * mhat / (torch.sqrt(vhat) + 1e-12)
    return _to_host(torch.exp(logx))


def hann2d(M, N, dtype=None, device=None):
    """Rotationally-symmetric 2D Hann window."""
    dtype = config.precision if dtype is None else dtype
    dev = resolve_device(device)
    n = torch.arange(N, dtype=dtype, device=dev)[None, :] - (N // 2)
    m = torch.arange(M, dtype=dtype, device=dev)[:, None] - (M // 2)
    nn = torch.hypot(n, m)
    N2 = min(N, M)
    w = torch.cos(math.pi / N2 * nn) ** 2
    return torch.where(nn > N2 // 2, 0, w)


def ideal_lpf_iir2d(r, dx, fc_over_nyq):
    """Ideal impulse response of a 2D lowpass filter (jinc kernel)."""
    c = math.pi * fc_over_nyq / dx
    return jinc(r * c) * (fc_over_nyq ** 2 * math.pi / 2)


def designfilt2d(r, dx, fc, typ='lowpass'):
    """Design a rotationally symmetric 2D filter transfer function |H|."""
    w = hann2d(*r.shape, dtype=r.dtype, device=r.device)
    nyq = 1 / (2 * dx)
    tl = typ.lower()
    if tl in ('lp', 'lowpass'):
        h = ideal_lpf_iir2d(r, dx, fc / nyq)
        H = torch.abs(torch.fft.fft2(w * h))
    elif tl in ('hp', 'highpass'):
        h = ideal_lpf_iir2d(r, dx, fc / nyq)
        H = 1 - torch.abs(torch.fft.fft2(w * h))
    elif tl in ('bp', 'bandpass', 'br', 'bandreject'):
        hl = ideal_lpf_iir2d(r, dx, fc[0] / nyq)
        hh = ideal_lpf_iir2d(r, dx, fc[1] / nyq)
        Hl = torch.abs(torch.fft.fft2(hl * w))
        Hh = 1 - torch.abs(torch.fft.fft2(hh * w))
        H = 1 - (Hh + Hl) if tl in ('bp', 'bandpass') else Hh + Hl
    else:
        raise ValueError('unknown filter type')
    return H


def _place_subaperture(shape, mask, dy, dx):
    """mask placed in a False array of ``shape`` at offset (dy, dx)."""
    mask = torch.as_tensor(mask)
    out = torch.zeros(shape, dtype=torch.bool, device=mask.device)
    out[dy:dy + mask.shape[0], dx:dx + mask.shape[1]] = mask.to(torch.bool)
    return out


def make_random_subaperture_mask(shape, mask, generator=None):
    """Random subaperture placement of mask within shape (a torch.Generator draws it)."""
    if generator is None:
        raise ValueError('make_random_subaperture_mask requires a torch.Generator')
    max_shift = [(s1 - s2) for s1, s2 in zip(shape, mask.shape)]
    if any(s < 0 for s in max_shift):
        raise ValueError('mask must fit inside shape')
    dy = int(torch.randint(0, max_shift[0] + 1, (), generator=generator,
                           device=generator.device))
    dx = int(torch.randint(0, max_shift[1] + 1, (), generator=generator,
                           device=generator.device))
    return _place_subaperture(tuple(shape), mask, dy, dx)


class Interferogram(RichData):
    """Analysis class for interferometric data (phase in nm, dx in mm)."""

    def __init__(self, phase, dx=0, wavelength=HeNe, intensity=None, meta=None):
        """phase nm; dx mm (0 = not laterally calibrated); wavelength um."""
        if not wavelength:
            if meta:
                wavelength = meta.get('wavelength', None)
                if wavelength is None:
                    wavelength = meta.get('Wavelength')
                if wavelength is not None:
                    wavelength *= 1e6  # m -> um
        super().__init__(data=phase, dx=dx, wavelength=wavelength)
        self.intensity = intensity
        self.meta = meta
        self._latcaled = dx != 0

    @property
    def dropout_percentage(self):
        """Percentage of NaN pixels."""
        return int(torch.count_nonzero(torch.isnan(self.data))) / self.data.numel() * 100

    @property
    def pv(self):
        """Peak-to-Valley phase error (DIN/ISO St)."""
        return pv(self.data)

    @property
    def rms(self):
        """RMS phase error (DIN/ISO Sq)."""
        return rms(self.data)

    @property
    def Sa(self):
        """Sa phase error (DIN/ISO Sa)."""
        return Sa(self.data)

    @property
    def strehl(self):
        """Strehl ratio assuming the data is wavefront error."""
        wvl = self.wavelength * 1e3
        phase_variance = (2 * math.pi * std(self.data) / wvl) ** 2
        return torch.exp(-phase_variance)

    @property
    def std(self):
        """Standard deviation of phase error."""
        return std(self.data)

    def pvr(self, normalization_radius=None):
        """Peak-to-Valley residual (Evans 2008): PV of Z36 fit + 3 RMS resid."""
        from .polynomials import zernike_nm_seq, fringe_to_nm, sum_of_2d_modes
        r = self.r
        t = self.t
        if normalization_radius is None:
            shp = self.data.shape
            if shp[0] != shp[1]:
                raise ValueError('pvr: if normalization_radius is None, data must be square')
            normalization_radius = _rmax_square_array(r)
        r = r / normalization_radius
        mask = r > 1
        data = torch.where(mask, torch.nan, self.data)
        nms = [fringe_to_nm(j) for j in range(1, 38)]
        basis = zernike_nm_seq(nms, r, t, norm=False)
        coefs = lstsq(basis, data)
        projected = sum_of_2d_modes(basis, coefs)
        projected = torch.where(mask, torch.nan, projected)
        fit_err = data - projected
        return pv(projected) + 3 * rms(fit_err)

    def fill(self, _with=0):
        """Fill NaN values with a constant."""
        self.data = torch.where(torch.isnan(self.data), _with, self.data)
        return self

    def crop(self):
        """Crop data to the rectangle bounding the finite region (host-side)."""
        finite = np.isfinite(_to_host(self.data))
        cols = np.any(finite, axis=0)
        rows = np.any(finite, axis=1)
        if not cols.any():
            return self
        r0, r1 = np.nonzero(rows)[0][[0, -1]]
        c0, c1 = np.nonzero(cols)[0][[0, -1]]
        lr = slice(int(r0), int(r1) + 1)
        tb = slice(int(c0), int(c1) + 1)
        xy = None if self._x is None else (self.x[lr, tb], self.y[lr, tb])
        rt = None if self._r is None else (self.r[lr, tb], self.t[lr, tb])
        self.data = self.data[lr, tb]
        if xy is not None:
            self._x, self._y = xy
        if rt is not None:
            self._r, self._t = rt
        return self

    def recenter(self):
        """Shift x/y so the data contains a zero sample FFT-style."""
        c = tuple(s // 2 for s in self.shape)
        x = self.x
        y = self.y
        self._x = x - x[c]
        self._y = y - y[c]
        self._r = None
        self._t = None
        return self

    def remove_piston(self):
        """Subtract the mean (piston)."""
        self.data = self.data - mean(self.data)
        return self

    def remove_tiptilt(self):
        """Subtract a least-squares plane (tip/tilt)."""
        plane = fit_plane(self.x, self.y, self.data)
        self.data = self.data - plane
        return self

    def remove_power(self):
        """Subtract a least-squares sphere (power)."""
        mask, sphere = fit_sphere(self.data)
        self.data = torch.where(mask, self.data - sphere, self.data)
        return self

    def mask(self, mask):
        """NaN out pixels where mask is False."""
        mask = torch.as_tensor(mask, device=self.data.device)
        self.data = torch.where(mask, self.data, torch.nan)
        return self

    def strip_latcal(self):
        """Revert to pixel units."""
        self.dx = 1.
        self._x = self._y = self._r = self._t = None
        self._latcaled = False
        return self

    def latcal(self, plate_scale):
        """Laterally calibrate with a plate scale (units per pixel)."""
        self.strip_latcal()
        self.dx = plate_scale
        self._latcaled = True
        return self

    def pad(self, value=math.nan, *, samples=None, shape=None):
        """Pad the data, filling the periphery with value."""
        if samples is None and shape is None:
            raise ValueError('Neither samples nor shape specified')
        if samples is not None and shape is not None:
            raise ValueError('Both samples and shape provided: only one can be given')
        if samples is not None:
            if isinstance(samples, int):
                samples = (samples, samples)
            shape = tuple(s + p for s, p in zip(self.data.shape, samples))
        self.data = pad2d(self.data, value=value, out_shape=shape)
        return self.latcal(self.dx)

    def spike_clip(self, nsigma=3):
        """NaN out points beyond nsigma standard deviations."""
        over = torch.abs(self.data) > nsigma * self.std
        self.data = torch.where(over, torch.nan, self.data)
        return self

    def psd(self):
        """PSD of the data as RichData (~nm^2/mm^2)."""
        ux, uy, psd_ = psd(self.data, self.dx)
        p = RichData(psd_, 0, self.wavelength)
        p._x = ux
        p._y = uy
        p.dx = float(ux[0, 1] - ux[0, 0])
        p._default_twosided = False
        return p

    def filter(self, fc, typ='lowpass'):
        """Apply a rotationally symmetric frequency-domain filter."""
        H = designfilt2d(self.r, self.dx, fc, typ)
        D = torch.fft.fft2(self.data)
        self.data = torch.fft.ifft2(D * H).real
        return self

    def bandlimited_rms(self, wllow=None, wlhigh=None, flow=None, fhigh=None):
        """Bandlimited RMS from the PSD of the data."""
        p = self.psd()
        return bandlimited_rms(r=p.r, psd=p.data, wllow=wllow, wlhigh=wlhigh,
                               flow=flow, fhigh=fhigh)

    def total_integrated_scatter(self, wavelength, incident_angle=0):
        """Total integrated scatter at a wavelength (um) and AOI (deg)."""
        upper_limit = 1000 / wavelength
        kernel = 4 * math.pi * math.cos(math.radians(incident_angle))
        kernel = kernel * self.bandlimited_rms(fhigh=upper_limit) / wavelength
        return 1 - torch.exp(-kernel ** 2)

    def slope(self):
        """(slope x, slope y, slope magnitude) as RichData."""
        dx = self.dx
        gy, gx = torch.gradient(self.data, spacing=dx)
        gr = torch.hypot(gx, gy)
        return RichData(gx, dx, None), RichData(gy, dx, None), RichData(gr, dx, None)

    def interferogram(self, visibility=1, passes=2, tilt_waves=(0, 0),
                      interpolation=None, fig=None, ax=None):
        """Plot synthetic fringes for the data (host-side)."""
        data = _to_host(self.data)
        yramp = np.linspace(-1, 1, data.shape[0]) * (tilt_waves[1] / 2)
        xramp = np.linspace(-1, 1, data.shape[1]) * (tilt_waves[0] / 2)
        yramp = np.broadcast_to(yramp, tuple(reversed(data.shape))).T
        xramp = np.broadcast_to(xramp, data.shape)
        phase = data / (1e3 * self.wavelength)
        phase = phase + (xramp + yramp)
        fig, ax = share_fig_ax(fig, ax)
        plotdata = visibility * np.cos(2 * np.pi * passes * phase)
        x, y = _to_host(self.x), _to_host(self.y)
        im = ax.imshow(plotdata,
                       extent=[x.min(), x.max(), y.min(), y.max()],
                       cmap='gray', interpolation=interpolation,
                       clim=(-1, 1), origin='lower')
        fig.colorbar(im, label='Intensity', ax=ax, fraction=0.046)
        return fig, ax

    def save_zygo_ascii(self, file):
        """Save to a Zygo ASCII file."""
        sf = 1 / (self.wavelength * 1e3)
        phase = _to_host(self.data) * sf
        write_zygo_ascii(file, phase=phase, dx=self.dx, intensity=None,
                         wavelength=self.wavelength)

    def save_zygo_dat(self, file):
        """Save to a Zygo binary dat file."""
        write_zygo_dat(file, phase=_to_host(self.data), dx=self.dx,
                       intensity=None, wavelength=self.wavelength)

    def __str__(self):
        """Pretty-print string representation."""
        z_unit = 'mm' if self._latcaled else 'px'
        diameter_y, diameter_x = self.support_y, self.support_x
        return inspect.cleandoc(f"""Interferogram with:
                Size: ({diameter_x:.3f}x{diameter_y:.3f}){z_unit}
                {float(self.pv):.3f} PV, {float(self.rms):.3f} RMS nm""")

    @staticmethod
    def from_zygo_dat(path, multi_intensity_action='first'):
        """Create an Interferogram from a Zygo dat/datx file."""
        if str(path).lower().endswith('datx'):
            zydat = read_zygo_datx(path)
            res = zydat['meta']['Lateral Resolution']
        else:
            zydat = read_zygo_dat(path, multi_intensity_action=multi_intensity_action)
            res = zydat['meta']['lateral_resolution']
        return Interferogram(phase=zydat['phase'], dx=res * 1e3,
                             intensity=zydat['intensity'],
                             meta=zydat['meta'], wavelength=None)

    @staticmethod
    def render_from_psd(size, samples, rms=None, mask='circle',
                        psd_fcn=abc_psd, generator=None, **psd_fcn_kwargs):
        """Render a synthetic interferogram from a PSD model."""
        x, y, z = render_synthetic_surface(size=size, samples=samples, rms=rms,
                                           mask=mask, psd_fcn=psd_fcn, generator=generator,
                                           **psd_fcn_kwargs)
        dx = float(x[1] - x[0])
        return Interferogram(phase=z, dx=dx, wavelength=HeNe)
