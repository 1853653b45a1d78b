"""Coordinate grids and conversions (counterpart of ``prysm_tpu/coordinates.py``)."""
import torch

from .conf import config, resolve_device
from .fttools import fftrange

__all__ = ['make_xy_grid', 'cart_to_polar', 'polar_to_cart']


def cart_to_polar(x, y, vec_to_grid=True):
    """(rho, phi) polar coordinates of the (x, y) input points."""
    if vec_to_grid and x.ndim == 1:
        y = y[:, None]
        x = x[None, :]
    return torch.hypot(x, y), torch.atan2(y, x)


def polar_to_cart(rho, phi):
    """(x, y) cartesian coordinates of the (rho, phi) input points."""
    return rho * torch.cos(phi), rho * torch.sin(phi)


def make_xy_grid(shape, *, dx=0, diameter=0, grid=True, dtype=None, device=None):
    """Create an FFT-aligned x, y grid with given spacing or diameter.

    Samples sit at fftrange(n) * dx: the zero-coordinate sample is at index
    n//2.  ``dtype`` defaults to ``config.precision``, ``device`` to
    ``config.device``.
    """
    if not isinstance(shape, tuple):
        shape = (shape, shape)
    if diameter != 0:
        dx = diameter / max(shape)
    if dtype is None:
        dtype = config.precision
    dev = resolve_device(device)
    y, x = (fftrange(s, dtype=dtype, device=dev) * dx for s in shape)
    if grid:
        y, x = torch.meshgrid(y, x, indexing='ij')
    return x, y
