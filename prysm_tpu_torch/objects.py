"""Scene objects for image simulation: slits, pinholes, stars, edges.

Counterpart of ``prysm_tpu/objects.py``: masked assignment is a
``torch.where`` selection, so every target is an elementwise program.
"""
import math

import torch

from .conf import config, to_tensor
from .mathops import jinc
from .coordinates import optimize_xy_separable

__all__ = ['slit', 'slit_ft', 'pinhole', 'pinhole_ft', 'siemensstar', 'tiltedsquare',
           'slantededge']


def _contrast_rails(contrast):
    """(low, high) gray levels for a target of the given contrast."""
    lo = (1 - contrast) / 2
    return lo, 1 - lo


def _canon_background(background):
    """Normalize a background color spec to 'b' or 'w'."""
    b = background.lower()
    if b in ('b', 'black'):
        return 'b'
    if b in ('w', 'white'):
        return 'w'
    raise ValueError('invalid background color')


def _rotate_grid(x, y, angle_deg):
    """Rotate (x, y) by angle_deg; returns (xp, yp)."""
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)
    return x * c - y * s, x * s + y * c


def slit(x, y, width_x, width_y=None):
    """Boolean mask of a slit or pair of crossed slits."""
    x, y = optimize_xy_separable(x, y)
    mask = torch.zeros((y.numel(), x.numel()), dtype=torch.bool, device=x.device)
    for g, w in ((x, width_x), (y, width_y)):
        if w is not None:
            mask = mask | (torch.abs(g) <= w / 2)
    return mask


def slit_ft(width_x, width_y, fx, fy):
    """Analytic FT of a slit, normalized to 1 at DC.

    The grid's support along the slit's long axis is recovered from the
    frequency sample spacing.  The result is in ``config.precision``.
    """
    wx = width_x or None
    wy = width_y or None
    if wx is None and wy is None:
        raise ValueError('slit_ft: at least one of width_x, width_y must be nonzero')
    fx, fy = optimize_xy_separable(fx, fy)
    on_fx_axis = fy == 0
    on_fy_axis = fx == 0
    if wy is None:
        out = torch.sinc(fx * wx) * on_fx_axis
    elif wx is None:
        out = torch.sinc(fy * wy) * on_fy_axis
    else:
        # two crossed slits: the union is the sum of the bands less the
        # overlap counted twice, normalized by the union's area
        Lx, Ly = 1 / (fx[0, 1] - fx[0, 0]), 1 / (fy[1, 0] - fy[0, 0])
        sx, sy = torch.sinc(fx * wx), torch.sinc(fy * wy)
        union_area = wx * Ly + wy * Lx - wx * wy
        out = (wx * Ly * sx * on_fx_axis
               + wy * Lx * sy * on_fy_axis
               - wx * wy * sx * sy) / union_area
    return out.to(config.precision)


def pinhole(radius, rho):
    """Boolean mask of a pinhole."""
    return rho <= radius


def pinhole_ft(radius, fr):
    """Analytic FT of a pinhole: jinc(2 pi radius fr)."""
    return jinc(to_tensor(fr) * (radius * 2 * math.pi))


def siemensstar(r, t, spokes, oradius=0.9, iradius=0, background='black',
                contrast=0.9, sinusoidal=False):
    """Siemens star target in [0, 1]."""
    lo, hi = _contrast_rails(contrast)
    arr = (contrast * torch.cos(spokes / 2 * t) + 1) / 2
    outside = (r > oradius) | (r < iradius)
    fill = 0.0 if _canon_background(background) == 'b' else 1.0
    arr = torch.where(outside, torch.full_like(arr, fill), arr)
    # the threshold runs after masking, so background pixels map onto the
    # bottom or top contrast level
    if not sinusoidal:
        arr = torch.where(arr < 0.5, torch.full_like(arr, lo),
                          torch.where(arr > 0.5, torch.full_like(arr, hi), arr))
    return arr


def tiltedsquare(x, y, angle=4, radius=0.5, contrast=0.9, background='white'):
    """Tilted square target (for MTF slanted-edge work)."""
    lo, hi = _contrast_rails(contrast)
    xp, yp = _rotate_grid(x, y, angle)
    inside = (torch.abs(xp) <= radius) & (torch.abs(yp) <= radius)
    if _canon_background(background) == 'w':
        lo, hi = hi, lo
    return torch.where(inside, torch.full_like(xp, hi), torch.full_like(xp, lo))


def slantededge(x, y, angle=4, contrast=0.9, crossed=False):
    """Slanted-edge target; optionally crossed (4 edges)."""
    lo, hi = _contrast_rails(contrast)
    xp, _ = _rotate_grid(x, y, angle)
    mask = xp > 0
    if crossed:
        upperright = mask & torch.rot90(mask)
        mask = upperright | torch.rot90(upperright, 2)
    return torch.where(mask, torch.full_like(xp, lo), torch.full_like(xp, hi))
