"""Anti-aliased aperture geometry via signed distance functions.

Counterpart of ``prysm_tpu/geometry.py``: every shape is a signed distance
field (negative inside), composed with min/max and turned into pixel
coverage by a one-pixel linear edge ramp (``antialias``).  Every function
is elementwise torch on its inputs' dtype and device; polygon vertices are
generated on the host.  ``polygon_sdf`` (and the regular polygon) and
``antialias`` also take numpy arrays and return numpy: host-side planners
(the hexagonal composite aperture) evaluate them there, as the JAX
package's planners do, where numpy's square root is correctly rounded.
"""
import math

import numpy as np
import torch

from .coordinates import cart_to_polar, optimize_xy_separable, polar_to_cart

__all__ = ['antialias', 'union', 'intersect', 'subtract', 'multisample', 'gaussian',
           'rectangle_sdf', 'rectangle', 'rotated_ellipse_sdf', 'rotated_ellipse',
           'square', 'circle_sdf', 'circle', 'annulus_sdf', 'annulus', 'polygon_sdf',
           'regular_polygon_sdf', 'regular_polygon', 'spider_sdf', 'spider',
           'offset_circle', 'rectangle_with_corner_fillets_sdf',
           'rectangle_with_corner_fillets']


def _xp(a):
    """numpy for numpy arrays, torch otherwise."""
    return np if isinstance(a, np.ndarray) else torch


def _radians(angle):
    """Degrees to radians for a Python number or a tensor."""
    return torch.deg2rad(angle) if torch.is_tensor(angle) else math.radians(angle)


def antialias(d, dx):
    """Convert signed distance to pixel coverage: clip(0.5 - d/dx, 0, 1).

    Combine shapes on distance (union/intersect/subtract) and ramp once;
    multiplying ramped masks double counts shared edges.
    """
    return _xp(d).clip(0.5 - d / dx, 0, 1)


def union(*ds):
    """Signed distance of the union of shapes (pointwise min)."""
    out = ds[0]
    for d in ds[1:]:
        out = torch.minimum(out, d)
    return out


def intersect(*ds):
    """Signed distance of the intersection of shapes (pointwise max)."""
    out = ds[0]
    for d in ds[1:]:
        out = torch.maximum(out, d)
    return out


def subtract(d1, d2):
    """Signed distance of shape 1 with shape 2 removed."""
    return torch.maximum(d1, -d2)


def multisample(func, x, y, samples=8):
    """Anti-alias a membership function by multisampling within edge pixels.

    For membership functions with no signed distance: every pixel takes
    the mean of samples^2 subsamples, and only pixels on an edge (any
    disagreement in their 3x3 neighbourhood) keep it.  Coverage is in the
    grids' dtype.
    """
    x, y = optimize_xy_separable(x, y)
    xr = x.ravel()
    yr = y.ravel()
    dtype = xr.dtype
    dx = xr[1] - xr[0]
    dy = yr[1] - yr[0]
    cover = torch.broadcast_to(func(x, y).to(dtype), (yr.numel(), xr.numel()))
    p = torch.nn.functional.pad(cover[None], (1, 1, 1, 1), mode='replicate')[0]
    N0, N1 = cover.shape
    mn = mx = cover
    for i in range(3):
        for j in range(3):
            window = p[i:i + N0, j:j + N1]
            mn = torch.minimum(mn, window)
            mx = torch.maximum(mx, window)
    edge = mn != mx

    off = (torch.arange(samples, dtype=dtype, device=xr.device) + 0.5) / samples - 0.5
    xs = x[None, None, ...] + (off * dx)[:, None, None, None]
    ys = y[None, None, ...] + (off * dy)[None, :, None, None]
    vals = torch.broadcast_to(func(xs, ys).to(dtype), (samples, samples, N0, N1))
    return torch.where(edge, vals.mean(dim=(0, 1)), cover)


def gaussian(sigma, x, y, center=(0, 0)):
    """Gaussian falloff mask with FWHM-parameterized width sigma."""
    x, y = optimize_xy_separable(x, y)
    x0, y0 = center
    return torch.exp(-4 * math.log(2) * ((x - x0) ** 2 + (y - y0) ** 2) / sigma ** 2)


def _box_sdf(qx, qy):
    """Signed distance of a box from |p| minus its half sizes."""
    outside = torch.hypot(torch.clamp(qx, min=0), torch.clamp(qy, min=0))
    inside = torch.clamp(torch.maximum(qx, qy), max=0)
    return outside + inside


def rectangle_sdf(width, x, y, height=None, angle=0):
    """Signed distance to a rectangle with half-width/height, negative inside."""
    if angle != 0:
        if angle == 90:
            x, y = y, x
        else:
            r, p = cart_to_polar(x, y)
            x, y = polar_to_cart(r, p + _radians(angle))
    else:
        x, y = optimize_xy_separable(x, y)
    if height is None:
        height = width
    return _box_sdf(torch.abs(x) - width, torch.abs(y) - height)


def rectangle(width, x, y, height=None, angle=0):
    """Binary rectangle mask; True inside."""
    return rectangle_sdf(width, x, y, height=height, angle=angle) <= 0


def rotated_ellipse_sdf(width_major, width_minor, x, y, major_axis_angle=0):
    """First-order (Taubin) signed distance to an origin-centered ellipse."""
    if width_minor > width_major:
        raise ValueError('By definition, major axis must be larger than minor.')
    A = _radians(-major_axis_angle)
    cA, sA = (torch.cos(A), torch.sin(A)) if torch.is_tensor(A) else (math.cos(A), math.sin(A))
    a, b = width_major, width_minor
    xr = x * cA + y * sA
    yr = x * sA - y * cA
    F = (xr / a) ** 2 + (yr / b) ** 2 - 1
    g = torch.hypot(2 * xr / (a * a), 2 * yr / (b * b))
    return F / torch.clamp(g, min=1e-15)


def rotated_ellipse(width_major, width_minor, x, y, major_axis_angle=0):
    """Binary ellipse mask; True inside."""
    return rotated_ellipse_sdf(width_major, width_minor, x, y,
                               major_axis_angle=major_axis_angle) <= 0


def square(x, y):
    """All-ones mask (the full square array)."""
    return torch.ones_like(x)


def circle_sdf(radius, r):
    """Signed distance to a circle, negative inside."""
    return r - radius


def circle(radius, r):
    """Binary circular mask; True inside the radius."""
    return circle_sdf(radius, r) <= 0


def annulus_sdf(rin, rout, r):
    """Signed distance to an annulus, negative inside."""
    center = (rin + rout) / 2
    halfwidth = (rout - rin) / 2
    return torch.abs(r - center) - halfwidth


def annulus(rin, rout, r):
    """Binary annular mask; True between the radii."""
    return annulus_sdf(rin, rout, r) <= 0


def polygon_sdf(vertices, x, y):
    """Signed distance to a polygon (segment distance + even-odd parity).

    vertices is a host-side (N, 2) array; the loop over edges runs once
    per edge on the whole grid.
    """
    xp = _xp(x)
    if math.prod(x.shape) and math.prod(y.shape):
        x, y = optimize_xy_separable(x, y)
    vertices = np.asarray(vertices, dtype=np.float64)
    n = len(vertices)
    d2 = None
    inside = None
    for i in range(n):
        x0, y0 = (float(v) for v in vertices[i])
        x1, y1 = (float(v) for v in vertices[(i + 1) % n])
        ex = x1 - x0
        ey = y1 - y0
        wx = x - x0
        wy = y - y0
        t = xp.clip((wx * ex + wy * ey) / (ex * ex + ey * ey), 0, 1)
        px = wx - t * ex
        py = wy - t * ey
        seg = px * px + py * py
        d2 = seg if d2 is None else xp.minimum(d2, seg)
        straddle = (y0 > y) != (y1 > y)
        crosses = straddle & ((wx * ey < ex * wy) == (y1 > y0))
        inside = crosses if inside is None else inside ^ crosses
    d = xp.sqrt(d2)
    return xp.where(inside, -d, d)


def _generate_vertices(sides, radius=1, center=(0, 0), rotation=0):
    """Host-side vertex list for a regular polygon."""
    angle = 2 * np.pi / sides
    rotation = np.radians(rotation)
    x0, y0 = center
    points = np.arange(sides, dtype=np.float64)
    x = radius * np.sin(points * angle + rotation) + x0
    y = radius * np.cos(points * angle + rotation) + y0
    return np.stack((x, y), axis=1)


def regular_polygon_sdf(sides, radius, x, y, center=(0, 0), rotation=0):
    """Signed distance to a regular polygon, negative inside."""
    return polygon_sdf(_generate_vertices(sides, radius, center, rotation), x, y)


def regular_polygon(sides, radius, x, y, center=(0, 0), rotation=0):
    """Binary regular polygon mask; True inside."""
    return regular_polygon_sdf(sides, radius, x, y, center=center, rotation=rotation) <= 0


def spider_sdf(vanes, width, x, y, rotation=0, center=(0, 0), rotation_is_rad=False):
    """Signed distance to spider vanes (semi-infinite capsules), negative inside."""
    half_width = width / 2
    x0, y0 = center
    x = x - x0
    y = y - y0
    if not rotation_is_rad:
        rotation = _radians(rotation)
    step = 2 * math.pi / vanes
    d = None
    for multiple in range(vanes):
        angle = step * multiple - rotation
        if torch.is_tensor(angle):
            c, s = torch.cos(angle), torch.sin(angle)
        else:
            c, s = math.cos(angle), math.sin(angle)
        along = x * c - y * s
        across = x * s + y * c
        vane = torch.hypot(torch.clamp(along, max=0), across) - half_width
        d = vane if d is None else torch.minimum(d, vane)
    return d


def spider(vanes, width, x, y, rotation=0, center=(0, 0), rotation_is_rad=False):
    """Binary spider-vane mask; True inside the vanes."""
    return spider_sdf(vanes, width, x, y, rotation=rotation, center=center,
                      rotation_is_rad=rotation_is_rad) <= 0


def offset_circle(radius, x, y, center):
    """Binary mask of a circle offset from the grid center."""
    x, y = optimize_xy_separable(x, y)
    return circle(radius, torch.hypot(x - center[0], y - center[1]))


def rectangle_with_corner_fillets_sdf(width, height, cradius, x, y, center=(0, 0),
                                      rotation=0):
    """Signed distance to a rectangle with filleted corners, negative inside."""
    if rotation != 0:
        r, t = cart_to_polar(x, y)
        x, y = polar_to_cart(r, t + _radians(rotation))
    else:
        x, y = optimize_xy_separable(x, y)
    x = x - center[0]
    y = y - center[1]
    qx = torch.abs(x) - (width - cradius)
    qy = torch.abs(y) - (height - cradius)
    return _box_sdf(qx, qy) - cradius


def rectangle_with_corner_fillets(width, height, cradius, x, y, center=(0, 0), rotation=0):
    """Binary mask of a rectangle with filleted corners; True inside."""
    return rectangle_with_corner_fillets_sdf(
        width, height, cradius, x, y, center=center, rotation=rotation) <= 0
