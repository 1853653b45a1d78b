"""Ray bundle generators: fans, grids, hexapolar and spiral samplings.

Counterpart of ``prysm_tpu/x/raytracing/raygen.py``.  Generation is
trace-time setup producing (N, 3) position/direction arrays; every
generator funnels through :func:`_bundle` (stack transverse samples with a
z plane) and :func:`_tilted_axis` (the collimated direction field).

Generators run in host numpy on purpose: ray patterns are launch-time
geometry planning consumed by host aiming code, and building them as
tensors on the card would force device-to-host reads inside every
launch.  The trace uploads the finished bundle once.

``distribution='random'`` draws from a ``torch.Generator`` (``key=``),
where the JAX package takes a ``jax.random`` key.
"""
from itertools import accumulate

import numpy as onp
import torch

from ...conf import numpy_dtype


def _host_dtype():
    return numpy_dtype()


# host twins of the coordinates helpers (the tensor originals live on
# config.device; converting their results back would be a device read)

def _host_rotation(zyx, radians=False):
    ZYX = onp.zeros(3)
    ZYX[:len(zyx)] = zyx
    if not radians:
        ZYX = onp.radians(ZYX)
    gamma, beta, alpha = ZYX
    c1, c2, c3 = onp.cos(alpha), onp.cos(beta), onp.cos(gamma)
    s1, s2, s3 = onp.sin(alpha), onp.sin(beta), onp.sin(gamma)
    Rx = onp.asarray([[1, 0, 0], [0, c1, -s1], [0, s1, c1]])
    Ry = onp.asarray([[c2, 0, s2], [0, 1, 0], [-s2, 0, c2]])
    Rz = onp.asarray([[c3, -s3, 0], [s3, c3, 0], [0, 0, 1]])
    return (Rx @ Ry @ Rz).astype(_host_dtype())


def _host_sample_axis(distribution, lo, hi, n, key=None):
    dtype = _host_dtype()
    if n == 1:
        return onp.asarray([(lo + hi) / 2.0], dtype=dtype)
    distribution = distribution.lower()
    if distribution == 'uniform':
        return onp.linspace(lo, hi, n, dtype=dtype)
    if distribution == 'random':
        if not isinstance(key, torch.Generator):
            raise ValueError(
                "distribution 'random' requires a torch.Generator (key=)")
        # drawn on the generator's device, then read back: random launch
        # patterns are a debug feature, not a hot path
        u = torch.rand(n, generator=key, dtype=torch.float64,
                       device=key.device)
        return (lo + (hi - lo) * u).cpu().numpy().astype(dtype)
    if distribution == 'cheby':
        k = onp.arange(n)
        nodes = onp.cos(k * onp.pi / (n - 1))
        return ((lo + hi) / 2.0 - (hi - lo) / 2.0 * nodes).astype(dtype)
    raise ValueError(f'unknown distribution {distribution!r}; '
                     "expected 'uniform', 'random', or 'cheby'")


def _host_promote_3d_point(P):
    dtype = _host_dtype()
    if not hasattr(P, '__iter__'):
        return onp.asarray([0, 0, P], dtype=dtype)
    P = list(P)
    if not 1 <= len(P) <= 3:
        raise ValueError('P must contain one to three coordinates')
    out = [0.0, 0.0, 0.0]
    out[-len(P):] = P
    return onp.asarray(out, dtype=dtype)


def concat_rayfans(*rayfans):
    """Merge N (P, S) rayfans into one batch."""
    return (onp.vstack([onp.asarray(p) for p, _ in rayfans]),
            onp.vstack([onp.asarray(s) for _, s in rayfans]))


def split_rayfans(P, chunksizes, S=None):
    """Split concatenated rayfans back into the input chunks."""
    if P.shape[0] != sum(chunksizes):
        raise ValueError('P is not sum(chunksizes) in length')
    edges = [0, *accumulate(chunksizes)]
    spans = list(zip(edges[:-1], edges[1:]))
    ps = [P[a:b] for a, b in spans]
    if S is None:
        return ps
    return ps, [S[a:b] for a, b in spans]


def _tilted_axis(npoints, yangle=0, xangle=0):
    """(npoints, 3) direction cosines of a tilted +z axis."""
    nominal = onp.asarray([0., 0., 1.], dtype=_host_dtype())
    R = _host_rotation((0, yangle, -xangle))
    tilted = R @ nominal
    return onp.broadcast_to(tilted[None, :], (npoints, 3))


def _bundle(x, y, z):
    """Stack transverse samples against a constant-z launch plane."""
    x = onp.asarray(x)
    plane = onp.broadcast_to(onp.asarray(z, dtype=_host_dtype()), x.shape)
    return onp.stack([x, onp.asarray(y), plane], axis=1)


def generate_collimated_ray_fan(nrays, maxr, z=0, minr=None, azimuth=90,
                                yangle=0, xangle=0, distribution='uniform',
                                key=None):
    """1D fan of collimated rays -> (P, S)."""
    if minr is None:
        minr = -maxr
    radii = _host_sample_axis(distribution, minr, maxr, nrays, key=key)
    azi = onp.broadcast_to(onp.radians(onp.asarray(azimuth,
                                                   dtype=_host_dtype())),
                           radii.shape)
    x, y = radii * onp.cos(azi), radii * onp.sin(azi)
    return _bundle(x, y, z), _tilted_axis(nrays, yangle=yangle, xangle=xangle)


def generate_collimated_rect_ray_grid(nrays, maxx, z=0, minx=None, maxy=None,
                                      miny=None, yangle=0, xangle=0,
                                      distribution='uniform', key=None):
    """2D rectangular grid of collimated rays -> (P, S); nrays^2 total."""
    minx = -maxx if minx is None else minx
    maxy = maxx if maxy is None else maxy
    miny = -maxy if miny is None else miny
    distribution = distribution.lower()
    cols = _host_sample_axis(distribution, minx, maxx, nrays, key=key)
    rows = _host_sample_axis(distribution, miny, maxy, nrays, key=key)
    xx, yy = onp.meshgrid(cols, rows)
    return (_bundle(xx.ravel(), yy.ravel(), z),
            _tilted_axis(nrays * nrays, yangle=yangle, xangle=xangle))


def generate_finite_ray_fan(nrays, na, P=0, min_na=None, azimuth=90,
                            yangle=0, xangle=0, n=1, distribution='uniform',
                            key=None):
    """1D fan of rays from a finite point with given NA -> (P, S)."""
    origin = _host_promote_3d_point(P)
    if min_na is None:
        min_na = -na
    angles = _host_sample_axis(distribution, float(onp.arcsin(min_na / n)),
                               float(onp.arcsin(na / n)), nrays, key=key)
    sin_t = onp.sin(angles)
    cos_t = onp.sqrt(1 - sin_t * sin_t)
    flat = onp.zeros_like(sin_t)
    # azimuth 90 puts the fan in the y plane, 0 in the x plane
    k, l = (sin_t, flat) if azimuth == 0 else (flat, sin_t)  # NOQA: E741
    S = onp.stack([k, l, cos_t], axis=1)
    if yangle != 0 or xangle != 0:
        R = _host_rotation((0, yangle, -xangle))
        S = (R @ S[..., None]).squeeze(-1)
    return onp.broadcast_to(origin[None, :], (nrays, 3)), S


def clip_to_aperture(rayfan, aperture):
    """Pre-trace filter: keep rays whose origins pass the aperture."""
    P, S = rayfan
    passes = onp.asarray(aperture(P[..., 0], P[..., 1]), dtype=bool)
    return P[passes], S[passes]


def _ring_points(radius, count, offset=0.0):
    """(x list, y list) of count points evenly around a ring."""
    azimuths = onp.linspace(0, 2 * onp.pi, count, endpoint=False) + offset
    return ((radius * onp.cos(azimuths)).tolist(),
            (radius * onp.sin(azimuths)).tolist())


def generate_collimated_hex_ray_grid(nrings, spacing, z=0, yangle=0, xangle=0):
    """Hexapolar grid of collimated rays: N = 1 + 3 nrings (nrings+1)."""
    if nrings < 0:
        raise ValueError(f'nrings must be >= 0, got {nrings}')
    xs, ys = [0.0], [0.0]
    for ring in range(1, nrings + 1):
        rx, ry = _ring_points(ring * spacing, 6 * ring)
        xs += rx
        ys += ry
    count = 1 + 3 * nrings * (nrings + 1)
    P = _bundle(onp.asarray(xs, dtype=_host_dtype()),
                onp.asarray(ys, dtype=_host_dtype()), z)
    return P, _tilted_axis(count, yangle=yangle, xangle=xangle)


def generate_collimated_radial_spiral_ray_grid(nrings, maxr, z=0,
                                               samples_per_ring=None,
                                               radial_distribution='cheby',
                                               include_center=True,
                                               yangle=0, xangle=0):
    """Radial-azimuthal spiral grid (Forbes-style Q-fitting sampling)."""
    if nrings < 1:
        raise ValueError(f'nrings must be >= 1, got {nrings}')
    if samples_per_ring is None:
        samples_per_ring = lambda ring: 6 * ring  # NOQA: E731
    if radial_distribution == 'cheby':
        ring_no = onp.arange(1, nrings + 1)
        radii = maxr * onp.cos((nrings - ring_no + 0.5) * onp.pi
                               / (2 * nrings))
    else:
        radii = _host_sample_axis(radial_distribution, 0.0, maxr,
                                  nrings + 1)[1:]
    xs, ys = ([0.0], [0.0]) if include_center else ([], [])
    for ring, radius in enumerate(radii, start=1):
        count = int(samples_per_ring(ring))
        if count > 0:
            # alternate a half-step azimuthal offset ring to ring
            rx, ry = _ring_points(float(radius), count,
                                  offset=(onp.pi / count) * (ring % 2))
            xs += rx
            ys += ry
    P = _bundle(onp.asarray(xs, dtype=_host_dtype()),
                onp.asarray(ys, dtype=_host_dtype()), z)
    return P, _tilted_axis(len(xs), yangle=yangle, xangle=xangle)
