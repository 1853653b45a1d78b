"""Anti-aliased aperture geometry via signed distance functions.

Counterpart of ``prysm_tpu/geometry.py`` (the main path's part): a shape is
a signed distance field (negative inside), turned into pixel coverage by a
one-pixel linear edge ramp.
"""
import torch

__all__ = ['antialias', 'circle_sdf', 'circle']


def antialias(d, dx):
    """Convert signed distance to pixel coverage: clip(0.5 - d/dx, 0, 1)."""
    return torch.clamp(0.5 - d / dx, 0, 1)


def circle_sdf(radius, r):
    """Signed distance to a circle, negative inside."""
    return r - radius


def circle(radius, r):
    """Binary circular mask; True inside the radius."""
    return circle_sdf(radius, r) <= 0
