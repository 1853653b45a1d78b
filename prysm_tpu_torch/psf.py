"""Evaluation routines for point spread functions.

Counterpart of ``prysm_tpu/psf.py``.  Size estimation works on the polar
resampling of the data, with the crossing search as masked reductions over
every azimuthal row at once, as in the JAX package.
"""
import math
import numbers

import torch

from .coordinates import uniform_cart_to_polar
from .fttools import fftrange
from .mathops import jinc

__all__ = ['FIRST_AIRY_ZERO', 'SECOND_AIRY_ZERO', 'THIRD_AIRY_ZERO',
           'FIRST_AIRY_ENCIRCLED', 'SECOND_AIRY_ENCIRCLED', 'THIRD_AIRY_ENCIRCLED',
           'AIRYDATA', 'estimate_size', 'fwhm', 'one_over_e', 'one_over_e_sq', 'centroid',
           'autocrop', 'airydisk', 'airydisk_efield', 'airydisk_ft']

FIRST_AIRY_ZERO = 1.220
SECOND_AIRY_ZERO = 2.233
THIRD_AIRY_ZERO = 3.238
FIRST_AIRY_ENCIRCLED = 0.8377850436212378
SECOND_AIRY_ENCIRCLED = 0.9099305350850819
THIRD_AIRY_ENCIRCLED = 0.9376474743695488

AIRYDATA = {
    1: (FIRST_AIRY_ZERO, FIRST_AIRY_ENCIRCLED),
    2: (SECOND_AIRY_ZERO, SECOND_AIRY_ENCIRCLED),
    3: (THIRD_AIRY_ZERO, THIRD_AIRY_ENCIRCLED),
}


def estimate_size(data, metric, dx=None, x=None, y=None, criteria='last'):
    """Radial coordinate at which the azimuthal rows cross <metric>.

    metric in {'fwhm', '1/e', '1/e^2'} or a float threshold; criteria picks
    the first or last crossing per azimuthal row; the result is the mean of
    the per-row linearly interpolated crossing radii.
    """
    criteria = criteria.lower()
    metric_name = metric.lower() if isinstance(metric, str) else None

    if x is None and y is None:
        y, x = (fftrange(s, dtype=data.dtype, device=data.device) * dx for s in data.shape)

    r, p, polar = uniform_cart_to_polar(x, y, data)
    max_ = polar.max()
    if metric_name == 'fwhm':
        hm = max_ / 2
    elif metric_name == '1/e':
        hm = 1 / math.e * max_
    elif metric_name == '1/e^2':
        hm = 1 / (math.e ** 2) * max_
    elif isinstance(metric, numbers.Number):
        hm = metric
    else:
        raise ValueError('unknown metric, use fwhm, 1/e, or 1/e^2')
    if criteria not in ('first', 'last'):
        raise ValueError('unknown criteria, use first or last')

    above = polar > hm
    crossing = above[:, :-1] != above[:, 1:]        # (rows, nr-1)
    ncols = crossing.shape[1]
    cols = torch.arange(ncols, device=data.device)
    if criteria == 'first':
        idx = torch.where(crossing, cols, ncols + 1).min(dim=1).values
    else:
        idx = torch.where(crossing, cols, -1).max(dim=1).values
    has = torch.any(crossing, dim=1)
    idx_safe = torch.clamp(idx, 0, ncols - 1)
    rows = torch.arange(polar.shape[0], device=data.device)
    y0 = polar[rows, idx_safe]
    y1 = polar[rows, idx_safe + 1]
    same = y1 == y0
    frac = torch.where(same, torch.zeros_like(y0),
                       (hm - y0) / torch.where(same, torch.ones_like(y0), y1 - y0))
    cross_r = r[idx_safe] + frac * (r[idx_safe + 1] - r[idx_safe])
    total = torch.sum(torch.where(has, cross_r, torch.zeros_like(cross_r)))
    return total / torch.sum(has)


def fwhm(data, dx=None, x=None, y=None, criteria='last'):
    """Full width at half maximum (2x the HWHM radius)."""
    return estimate_size(x=x, y=y, dx=dx, data=data, metric='fwhm', criteria=criteria) * 2


def one_over_e(data, dx=None, x=None, y=None, criteria='last'):
    """1/e diameter."""
    return estimate_size(x=x, y=y, dx=dx, data=data, metric='1/e', criteria=criteria) * 2


def one_over_e_sq(data, dx=None, x=None, y=None, criteria='last'):
    """1/e^2 diameter."""
    return estimate_size(x=x, y=y, dx=dx, data=data, metric='1/e^2', criteria=criteria) * 2


def centroid(data, dx=None, unit='spatial'):
    """Centroid of the data; 'pixels' corner-indexed or 'spatial' center-indexed."""
    ny, nx = data.shape
    total = torch.sum(data)
    rows = torch.arange(ny, dtype=data.dtype, device=data.device)
    cols = torch.arange(nx, dtype=data.dtype, device=data.device)
    com_y = torch.sum(data.sum(dim=1) * rows) / total
    com_x = torch.sum(data.sum(dim=0) * cols) / total
    if unit != 'spatial':
        return com_y, com_x
    cy, cx = ny // 2, nx // 2
    return dx * (com_y - cy), dx * (com_x - cx)


def autocrop(data, px):
    """Crop a px-wide window around the centroid (host-side index math)."""
    com = centroid(data, unit='pixels')
    cy, cx = (int(c) for c in com)
    w = px // 2
    aoi_y_l = cy - w
    aoi_y_h = aoi_y_l + px
    aoi_x_l = cx - w
    aoi_x_h = aoi_x_l + px
    pad_y = (max(0, -aoi_y_l), max(0, aoi_y_h - data.shape[0]))
    pad_x = (max(0, -aoi_x_l), max(0, aoi_x_h - data.shape[1]))
    if any(pad_y) or any(pad_x):
        data = torch.nn.functional.pad(data, (*pad_x, *pad_y))
        aoi_y_l += pad_y[0]
        aoi_y_h += pad_y[0]
        aoi_x_l += pad_x[0]
        aoi_x_h += pad_x[0]
    return data[aoi_y_l:aoi_y_h, aoi_x_l:aoi_x_h]


def airydisk(unit_r, fno, wavelength):
    """Airy pattern intensity over radial coordinate in um."""
    return torch.abs(airydisk_efield(unit_r, fno, wavelength)) ** 2


def airydisk_efield(unit_r, fno, wavelength):
    """Airy pattern complex E-field: 2 jinc(pi r / (wvl fno))."""
    return 2 * jinc(unit_r * math.pi / wavelength / fno)


def airydisk_ft(r, fno, wavelength):
    """Fourier transform of the Airy disk (the diffraction-limited MTF cone)."""
    extinction = 1 / (wavelength * fno)
    s = torch.clamp(torch.abs(r) / extinction, max=1)
    return (2 / math.pi) * (torch.arccos(s) - s * torch.sqrt(1 - s ** 2))
