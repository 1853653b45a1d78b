"""Shack-Hartmann lenslet-array phase screens.

Counterpart of ``prysm_tpu/x/shack_hartmann.py``: each lenslet's quadratic
phase is added into its window of the screen, one lenslet after the other,
as the JAX package's unrolled loop adds them.  A window spans
``2 * int(pitch / dx + 1)`` samples, so neighbouring windows overlap and the
aperture decides what each adds; where a sample lies on two lenslets' edges
both add to it.  The screen is built once, in the grids' dtype and on their
device.
"""
import inspect
from math import ceil, pi

import torch

from ..coordinates import make_xy_grid
from ..segmented import _local_window
from ..geometry import rectangle
from ..mathops import is_odd, cis

__all__ = ['shack_hartmann']


def shack_hartmann(pitch, n, efl, wavelength, x, y,
                   aperture=rectangle, aperture_kwargs=None, shift=False):
    """Complex screen for a Shack-Hartmann lenslet array.

    pitch (mm) between lenslets, n lenslets across (or (nx, ny)), efl (mm)
    of each, wavelength (um), on the grids x, y (mm).  ``aperture`` masks
    each lenslet: called as ``aperture(pitch / 2, x=lx, y=ly)`` when it
    takes x and y, else ``aperture((pitch / 2)**2, r=rsq)``.  ``shift``
    moves an even count's lenslets by half a pitch so that one sits on the
    axis.
    """
    if not hasattr(n, '__iter__'):
        n = (n, n)
    if aperture_kwargs is None:
        aperture_kwargs = {}

    sig = inspect.signature(aperture)
    params = sig.parameters
    callxy = 'x' in params and 'y' in params

    dx = float(x[0, 1] - x[0, 0])
    samples_per_lenslet = int(pitch / dx + 1)

    xc, yc = make_xy_grid(n, dx=pitch, grid=False, host=True, dtype=x.dtype)
    yc = yc.ravel()
    if shift:
        if not is_odd(n[0]):
            xc = xc + (pitch / 2)
        if not is_odd(n[1]):
            yc = yc + (pitch / 2)

    cx = ceil(x.shape[1] / 2)
    cy = ceil(y.shape[0] / 2)
    lenslet_rsq = (pitch / 2) ** 2
    total_phase = torch.zeros_like(x)

    for yy in yc:
        for xx in xc:
            win = _local_window(cy, cx, (xx, yy), dx, samples_per_lenslet, x, y)
            lx = x[win] - float(xx)
            ly = y[win] - float(yy)
            rsq = lx * lx + ly * ly
            phase = rsq / (2 * efl)
            if callxy:
                phase = phase * aperture(pitch / 2, x=lx, y=ly, **aperture_kwargs)
            else:
                phase = phase * aperture(lenslet_rsq, r=rsq, **aperture_kwargs)
            total_phase[win] += phase

    prefix = -2 * pi / (wavelength / 1e3)
    return cis(prefix * total_phase)
