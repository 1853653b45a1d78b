"""Segmented apertures: hexagonal and keystone composites.

Counterpart of ``prysm_tpu/segmented.py``.  The geometry is planned on the
host, as in the JAX package: the hex-lattice bookkeeping and the window
offsets in Python on the grids' numpy values (so every window lands where
the JAX planner puts it), the per-segment masks and bases in torch on the
CPU in the grids' dtype.  The planned tensors then move once to
``device``.  ``compose_opd`` is a differentiable function of the
coefficients: a loop of per-segment slice-adds into a fresh tensor (the
JAX package records a scatter formulation as a loss on the TPU).
"""
import inspect
import math
import numbers
from collections import namedtuple

import numpy as np
import torch

from .conf import resolve_device
from .coordinates import cart_to_polar, polar_to_cart
from .geometry import regular_polygon_sdf, circle_sdf, annulus_sdf, spider, antialias
from .polynomials import sum_of_2d_modes

__all__ = ['FLAT_TO_FLAT_TO_VERTEX_TO_VERTEX', 'VERTEX_TO_VERTEX_TO_FLAT_TO_FLAT', 'Hex',
           'add_hex', 'sub_hex', 'mul_hex', 'hex_dirs', 'hex_dir', 'hex_neighbor',
           'hex_to_xy', 'scale_hex', 'hex_ring', 'CompositeHexagonalAperture',
           'CompositeKeystoneAperture']

FLAT_TO_FLAT_TO_VERTEX_TO_VERTEX = 1.1547005383792515  # 2/sqrt(3)
VERTEX_TO_VERTEX_TO_FLAT_TO_FLAT = 1 / FLAT_TO_FLAT_TO_VERTEX_TO_VERTEX

Hex = namedtuple('Hex', ['q', 'r', 's'])


def add_hex(h1, h2):
    """Add two hex coordinates together."""
    return Hex(h1.q + h2.q, h1.r + h2.r, h1.s + h2.s)


def sub_hex(h1, h2):
    """Subtract two hex coordinates."""
    return Hex(h1.q - h2.q, h1.r - h2.r, h1.s - h2.s)


def mul_hex(h1, h2):
    """Multiply two hex coordinates."""
    return Hex(h1.q * h2.q, h1.r * h2.r, h1.s * h2.s)


hex_dirs = [
    Hex(1, 0, -1), Hex(1, -1, 0), Hex(0, -1, 1),
    Hex(-1, 0, 1), Hex(-1, 1, 0), Hex(0, 1, -1),
]


def hex_dir(i):
    """Hex direction associated with a given integer, wrapped at 6."""
    return hex_dirs[i % 6]


def hex_neighbor(h, direction):
    """Neighboring hex in a given direction."""
    return add_hex(h, hex_dir(direction))


def hex_to_xy(h, radius, rot=90):
    """Convert hexagon coordinate to (x, y) given segment radius and rotation."""
    if rot == 90:
        x = 3 / 2 * h.q
        y = VERTEX_TO_VERTEX_TO_FLAT_TO_FLAT * h.q + math.sqrt(3) * h.r
    else:
        x = math.sqrt(3) * h.q + VERTEX_TO_VERTEX_TO_FLAT_TO_FLAT * h.r
        y = 3 / 2 * h.r
    return x * radius, y * radius


def scale_hex(h, k):
    """Scale a hex coordinate by some constant factor."""
    return Hex(h.q * k, h.r * k, h.s * k)


def hex_ring(radius):
    """All hex coordinates in a given ring, first element 'north'."""
    start = Hex(-radius, radius, 0)
    tile = start
    results = []
    for i in range(6):
        for _ in range(radius):
            results.append(tile)
            tile = hex_neighbor(tile, i)
    for _ in range(radius):
        results.append(results.pop(0))
    return results


def _local_window(cy, cx, center, dx, samples_per_seg, x, y):
    """Static slice pair delimiting a segment's local window (host-side)."""
    if isinstance(samples_per_seg, int):
        samples_per_seg = (samples_per_seg, samples_per_seg)
    offset_x = cx + int(center[0] / dx) - samples_per_seg[0]
    offset_y = cy + int(center[1] / dx) - samples_per_seg[1]
    upper_x = offset_x + (2 * samples_per_seg[0])
    upper_y = offset_y + (2 * samples_per_seg[1])
    offset_x = min(max(offset_x, 0), x.shape[1])
    offset_y = min(max(offset_y, 0), y.shape[0])
    upper_x = min(max(upper_x, 0), x.shape[1])
    upper_y = min(max(upper_y, 0), y.shape[0])
    return slice(offset_y, upper_y), slice(offset_x, upper_x)


def _host(a, dtype=None):
    """A numpy grid (or a tensor) as a CPU tensor for host-side planning, in ``dtype``.

    Local grids are cast to the aperture's dtype before any basis is
    evaluated on them, as JAX casts numpy inputs to its working precision.
    """
    a = a.cpu() if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
    return a if dtype is None else a.to(dtype)


def _max_into(mask, window, tile):
    """mask[window] = max(mask[window], tile), in place on a planning tensor."""
    mask[window] = torch.maximum(mask[window], tile.to(mask.dtype))


def _stack_basis(basis_func, orders, **grids):
    """The basis stack of basis_func(orders, **grids), on the host."""
    return torch.stack(list(basis_func(orders, **grids)))


def _compose(acc, windows, masks, bases, coefs):
    """acc with sum_k(bases[k] . coefs[k]) * masks[k] added into windows[k].

    ``acc`` is a fresh tensor, never a leaf: the slice-adds are in place.
    """
    for win, mask, base, c in zip(windows, masks, bases, coefs):
        acc[win] += sum_of_2d_modes(base, c) * mask
    return acc


class CompositeHexagonalAperture:
    """An aperture composed of several hexagonal segments.

    Attributes of interest: ``amp`` (the composite amplitude mask, on
    ``device``), ``windows``/``local_coords``/``local_masks``/``segment_ids``,
    and after ``prepare_opd_bases``, ``opd_bases``/``opd_grids``.  ``x``
    and ``y`` are host grids (numpy, as ``make_xy_grid(host=True)`` gives
    them); ``local_coords`` stay on the host, ``local_masks`` and
    ``opd_bases`` live on ``device``.
    """

    def __init__(self, x, y, rings, segment_diameter, segment_separation, segment_angle=90,
                 exclude=(), device=None):
        """rings of hexagons of flat-to-flat ``segment_diameter`` around a center one.

        ``segment_separation`` is the gap between flats, ``segment_angle``
        0 or 90 degrees, ``exclude`` the segment ids left out (0 the center).
        """
        self.device = resolve_device(device)
        (self.vtov,
         self.all_centers,
         self.windows,
         self.local_coords,
         local_masks,
         self.segment_ids,
         amp) = _composite_hexagonal_aperture(rings, segment_diameter, segment_separation,
                                              x, y, segment_angle, exclude)
        self.local_masks = [m.to(self.device) for m in local_masks]
        self.amp = amp.to(self.device)
        self.x = x
        self.y = y
        self.segment_diameter = segment_diameter
        self.segment_separation = segment_separation
        self.segment_angle = segment_angle
        self.exclude = exclude

    def prepare_opd_bases(self, basis_func, orders, basis_func_kwargs=None,
                          normalization_radius=None):
        """Prepare (deduplicated) per-segment polynomial bases.

        ``basis_func`` takes (orders, r=, t=) or (orders, x=, y=), which
        its signature decides.  The bases are computed on the host and
        moved to the aperture's device.
        """
        if normalization_radius is None:
            normalization_radius = self.vtov / 2
        if not isinstance(normalization_radius, (tuple, list)):
            normalization_radius = (normalization_radius, normalization_radius)
        if basis_func_kwargs is None:
            basis_func_kwargs = {}
        params = inspect.signature(basis_func).parameters
        polar = 'r' in params and 't' in params
        gridcache = {}
        polycache = {}
        grids = []
        bases = []
        for x, y in self.local_coords:
            key = (float(x[0, 0]), *x.shape)
            if key not in gridcache:
                x, y = _host(x, self.amp.dtype), _host(y, self.amp.dtype)
                if polar:
                    r, t = cart_to_polar(x, y)
                    grid = {'r': r / normalization_radius[0], 't': t}
                else:
                    grid = {'x': x / normalization_radius[0], 'y': y / normalization_radius[1]}
                gridcache[key] = tuple(grid.values())
                polycache[key] = _stack_basis(basis_func, orders, **grid,
                                              **basis_func_kwargs).to(self.device)
            grids.append(gridcache[key])
            bases.append(polycache[key])
        self.opd_bases = bases
        self.opd_grids = grids
        return grids, bases

    def compose_opd(self, coefs, out=None):
        """Compose the per-segment OPD; a differentiable function of coefs.

        coefs has shape (len(self.segment_ids), len(orders)).  When ``out``
        is given the composed OPD is added onto a copy of it and the sum
        returned.
        """
        acc = torch.zeros_like(self.amp) if out is None else out.clone()
        return _compose(acc, self.windows, self.local_masks, self.opd_bases, coefs)


def _composite_hexagonal_aperture(rings, segment_diameter, segment_separation, x, y,
                                  segment_angle=90, exclude=(0,)):
    if segment_angle not in {0, 90}:
        raise ValueError('can only synthesize composite apertures with '
                         'hexagons along a cartesian axis')
    segment_vtov = segment_diameter * FLAT_TO_FLAT_TO_VERTEX_TO_VERTEX
    segment_separation = (segment_separation * FLAT_TO_FLAT_TO_VERTEX_TO_VERTEX) / 2
    rseg = segment_vtov / 2

    # planning reads the grids' numpy values: the windows come from the same
    # numbers as the JAX planner's, so none moves by a pixel
    x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    y = y.cpu().numpy() if torch.is_tensor(y) else np.asarray(y)
    dx = float(x[0, 1] - x[0, 0])
    samples_per_seg = int(rseg / dx + 1)
    cx = int(np.ceil(x.shape[1] / 2))
    cy = int(np.ceil(y.shape[0] / 2))
    center_segment_window = _local_window(cy, cx, (0, 0), dx, samples_per_seg, x, y)

    # the masks are numpy, evaluated on the host as the JAX planner does
    mask = np.zeros(x.shape, dtype=x.dtype)

    segment_id = 0
    xx = x[center_segment_window]
    yy = y[center_segment_window]
    center_mask = antialias(regular_polygon_sdf(6, rseg, xx, yy, center=(0, 0),
                                                rotation=segment_angle), dx)
    if 0 not in exclude:
        mask[center_segment_window] = np.maximum(mask[center_segment_window], center_mask)
        local_masks = [center_mask]
        segment_ids = [0]
        all_centers = [(0., 0.)]
        windows = [center_segment_window]
        local_coords = [(xx, yy)]
    else:
        local_masks = []
        local_coords = []
        segment_ids = []
        all_centers = []
        windows = []

    for i in range(1, rings + 1):
        hexes = hex_ring(i)
        centers = [hex_to_xy(h, rseg + segment_separation, rot=segment_angle) for h in hexes]
        ids = np.arange(segment_id + 1, segment_id + 1 + len(centers), dtype=int)
        id_mask = ~np.isin(ids, exclude, assume_unique=True)
        valid_ids = ids[id_mask]
        centers_arr = np.asarray(centers)[id_mask]
        all_centers += centers_arr.tolist()
        for seg_id, center in zip(valid_ids, centers_arr):
            segment_ids.append(int(seg_id))
            local_window = _local_window(cy, cx, center, dx, samples_per_seg, x, y)
            windows.append(local_window)
            xx = x[local_window]
            yy = y[local_window]
            local_coords.append((xx - center[0], yy - center[1]))
            local_mask = antialias(regular_polygon_sdf(6, rseg, xx, yy, center=center,
                                                       rotation=segment_angle), dx)
            local_masks.append(local_mask)
            mask[local_window] = np.maximum(mask[local_window], local_mask)
        segment_id = ids[-1]

    local_masks = [torch.from_numpy(m) for m in local_masks]
    return (segment_vtov, all_centers, windows, local_coords, local_masks, segment_ids,
            torch.from_numpy(mask))


class CompositeKeystoneAperture:
    """Composite aperture with a circular center and keystone ring segments.

    ``amp``, ``center_mask`` and ``segment_masks`` live on ``device``; the
    grids (``center_xx``..., ``segment_grids``) stay on the host.
    """

    def __init__(self, x, y, center_circle_diameter, rings, ring_radius, segments_per_ring,
                 radial_gap, azimuthal_gap=None, rotation_per_ring=None, device=None):
        """A center circle and ``rings`` rings of keystones.

        ``ring_radius``, ``segments_per_ring``, ``radial_gap`` and
        ``rotation_per_ring`` (degrees) are numbers or one value per ring;
        ``azimuthal_gap`` (default ``radial_gap``) is the spider width
        between keystones.
        """
        if azimuthal_gap is None:
            azimuthal_gap = radial_gap
        self.device = resolve_device(device)
        pak = _composite_keystone_aperture(
            x=x, y=y, center_circle_diameter=center_circle_diameter, rings=rings,
            ring_radius=ring_radius, segments_per_ring=segments_per_ring,
            radial_gap=radial_gap, azimuthal_gap=azimuthal_gap,
            rotation_per_ring=rotation_per_ring)
        cs = pak['center_segment']
        ks = pak['keystones']
        cs['mask'] = cs['mask'].to(self.device)
        ks['masks'] = [mk.to(self.device) for mk in ks['masks']]

        # single-letter grid keys double up: center_xx, center_rr, ...
        for key in ('x', 'y', 'r', 't', 'mask', 'window'):
            setattr(self, f'center_{key * 2 if len(key) == 1 else key}', cs[key])
        keystone_view = {
            'segment_centers': 'centers', 'segment_corners': 'corners',
            'segment_ids_ods': 'ids_ods', 'segment_windows': 'windows',
            'segment_grids': 'local_xy', 'segment_masks': 'masks',
            'segment_rotations': 'rotations', 'segment_ledges': 'left_edges',
            'segment_redges': 'right_edges',
            'segment_radial_diameters': 'radial_diameters',
            'segment_ids': 'ids',
        }
        for attr, key in keystone_view.items():
            setattr(self, attr, ks[key])
        self.amp = pak['amplitude_mask'].to(self.device)
        self.__dict__.update(
            x=x, y=y, center_circle_diameter=center_circle_diameter, radial_gap=radial_gap,
            azimuthal_gap=azimuthal_gap, rings=rings, ring_radius=ring_radius,
            segments_per_ring=segments_per_ring, rotation_per_ring=rotation_per_ring)

    def prepare_opd_bases(self, center_basis, center_orders, segment_basis, segment_orders,
                          center_basis_kwargs=None, segment_basis_kwargs=None,
                          rotate_xyaxes=False):
        """Prepare the center and per-keystone polynomial bases (on the host, then moved)."""
        if center_basis_kwargs is None:
            center_basis_kwargs = {}
        if segment_basis_kwargs is None:
            segment_basis_kwargs = {}
        bases = []
        grids = []

        nr = self.center_circle_diameter / 2
        params = inspect.signature(center_basis).parameters
        if 'r' in params and 't' in params:
            grid = {'r': self.center_rr / nr, 't': self.center_tt}
        else:
            grid = {'x': self.center_xx / nr, 'y': self.center_yy / nr}
        bases.append(_stack_basis(center_basis, center_orders, **grid, **center_basis_kwargs))
        grids.append(tuple(grid.values()))

        params = inspect.signature(segment_basis).parameters
        if 'r' in params and 't' in params:
            for x, y in self.segment_grids:
                x, y = _host(x, self.amp.dtype), _host(y, self.amp.dtype)
                xext = float(x[0, -1] - x[0, 0])
                yext = float(y[-1, 0] - y[0, 0])
                r, t = cart_to_polar(x, y)
                grid = {'r': r / (min(xext, yext) / 2), 't': t}
                bases.append(_stack_basis(segment_basis, segment_orders, **grid,
                                          **segment_basis_kwargs))
                grids.append(tuple(grid.values()))
        else:
            if not rotate_xyaxes:
                raise ValueError('must rotate xy axes')
            for i, (x, y) in enumerate(self.segment_grids):
                t_offset = self.segment_rotations[i]
                r, t = cart_to_polar(_host(x, self.amp.dtype), _host(y, self.amp.dtype))
                x, y = polar_to_cart(r, t - t_offset)

                xc, yc = self.segment_centers[i]
                xcorner, ycorner = self.segment_corners[i]
                xcenter, ycenter = self.segment_ids_ods[i]
                xcenter = np.asarray(xcenter) - xc
                ycenter = np.asarray(ycenter) - yc
                xcorner = np.asarray(xcorner) - xc
                ycorner = np.asarray(ycorner) - yc

                rcenter = np.hypot(xcenter, ycenter)
                tcenter = np.arctan2(ycenter, xcenter) - t_offset
                xmax = (rcenter * np.cos(tcenter)).max()

                rcorner = np.hypot(xcorner, ycorner)
                tcorner = np.arctan2(ycorner, xcorner) - t_offset
                xcorner = rcorner * np.cos(tcorner)
                ycorner = rcorner * np.sin(tcorner)

                xnorm = (xmax - xcorner.min()) / 2
                ynorm = (ycorner.max() - ycorner.min()) / 2
                grid = {'x': x / xnorm, 'y': y / ynorm}
                bases.append(_stack_basis(segment_basis, segment_orders, **grid,
                                          **segment_basis_kwargs))
                grids.append(tuple(grid.values()))

        self.opd_bases = [b.to(self.device) for b in bases]
        self.opd_grids = grids
        return grids, self.opd_bases

    def compose_opd(self, center_coefs, segment_coefs, out=None):
        """Compose the center + segment OPD; differentiable in both coefficient sets.

        When ``out`` is given the composed OPD is added onto a copy of it
        and the sum returned.
        """
        acc = torch.zeros_like(self.amp) if out is None else out.clone()
        dtype = self.opd_bases[0].dtype
        coefs = [torch.as_tensor(center_coefs, dtype=dtype, device=self.device)]
        coefs += [torch.as_tensor(c, dtype=dtype, device=self.device) for c in segment_coefs]
        return _compose(acc, [self.center_window, *self.segment_windows],
                        [self.center_mask, *self.segment_masks], self.opd_bases, coefs)


def _composite_keystone_aperture(x, y, center_circle_diameter, rings, ring_radius,
                                 segments_per_ring, rotation_per_ring, radial_gap,
                                 azimuthal_gap):
    if isinstance(rotation_per_ring, numbers.Number) or rotation_per_ring is None:
        rotation_per_ring = [rotation_per_ring] * rings
    if isinstance(ring_radius, numbers.Number):
        ring_radius = [ring_radius] * rings
    if isinstance(segments_per_ring, numbers.Number):
        segments_per_ring = [segments_per_ring] * rings
    if isinstance(radial_gap, numbers.Number):
        radial_gap = [radial_gap] * rings

    center_radius = center_circle_diameter / 2
    x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    y = y.cpu().numpy() if torch.is_tensor(y) else np.asarray(y)

    local_masks = []
    local_coords = []
    segment_ids = []
    all_centers = []
    windows = []
    center_angles = []
    left_edges = []
    right_edges = []
    radial_diameters = []
    corners = []
    idods = []
    xh, yh = _host(x), _host(y)
    primary_mask = torch.zeros(x.shape, dtype=xh.dtype)
    all_spiders = torch.zeros(x.shape, dtype=torch.bool)

    dx = float(x[0, 1] - x[0, 0])
    r, t = cart_to_polar(xh, yh)
    ccx = int(np.ceil(x.shape[1] / 2))
    ccy = int(np.ceil(y.shape[0] / 2))

    center_diameter_samples = math.ceil(center_circle_diameter / dx)
    win = _local_window(ccy, ccx, (0, 0), dx, center_diameter_samples, x, y)
    center_xx = xh[win]
    center_yy = yh[win]
    center_rr = r[win]
    center_tt = t[win]
    center_mask = antialias(circle_sdf(center_radius, center_rr), dx)
    primary_mask[win] = center_mask
    outer_radius = center_radius

    segment_id = 0
    iterable = (segments_per_ring, ring_radius, radial_gap, rotation_per_ring)
    for (nsegments, local_radius, gap, rotation) in zip(*iterable):
        inner_radius = outer_radius + gap
        outer_radius = inner_radius + local_radius
        arc_per_seg = 360 / nsegments
        arc_rad = np.radians(arc_per_seg)
        if rotation is None:
            rotation = arc_per_seg
        segment_angles = np.arange(nsegments, dtype=np.float64) * arc_per_seg + rotation
        segment_angles = np.radians(segment_angles) - np.pi

        for angle in segment_angles:
            lo = angle
            hi = angle + arc_rad
            while hi > 2 * np.pi:
                hi = hi - 2 * np.pi
            while lo > 2 * np.pi:
                lo = lo - 2 * np.pi
            if hi < lo:
                lo, hi = hi, lo
            mid = lo + arc_rad / 2
            center_angles.append(mid)

            # a pie has five corners
            arr = np.asarray([(inner_radius, lo), (inner_radius, hi), (outer_radius, lo),
                              (outer_radius, hi), (outer_radius, mid)])
            xx = arr[:, 0] * np.cos(arr[:, 1])
            yy = arr[:, 0] * np.sin(arr[:, 1])
            minx, maxx = xx.min(), xx.max()
            miny, maxy = yy.min(), yy.max()
            rangex = maxx - minx
            rangey = maxy - miny
            samples = [math.ceil(v / dx / 2) for v in (rangex, rangey)]
            window = _local_window(ccy, ccx, (minx + rangex / 2, miny + rangey / 2), dx,
                                   samples, x, y)
            rr = r[window]
            tt = t[window]
            # radial (ring) edges are antialiased via SDF; the angular wedge
            # cut stays a hard boolean gate
            arc = antialias(annulus_sdf(inner_radius, outer_radius, rr), dx)
            ang_mask = (tt > lo) & (tt < hi)
            if (lo < np.pi) & (hi > np.pi):
                ang_mask = ang_mask | (tt < (hi - 2 * np.pi))
            elif (lo >= np.pi) & (hi > np.pi):
                llo = lo - 2 * np.pi
                lhi = hi - 2 * np.pi
                ang_mask = (tt > llo) & (tt < lhi)
                lo, hi = llo, lhi

            seg_mask = arc * ang_mask
            _max_into(primary_mask, window, seg_mask)

            mid_r = (inner_radius + outer_radius) / 2
            center = (mid_r * np.cos(mid), mid_r * np.sin(mid))
            cid = (inner_radius * np.cos(mid), inner_radius * np.sin(mid))
            cod = (outer_radius * np.cos(mid), outer_radius * np.sin(mid))

            segment_ids.append(segment_id)
            local_masks.append(seg_mask)
            local_coords.append((x[window] - center[0], y[window] - center[1]))
            all_centers.append(center)
            windows.append(window)
            left_edges.append((mid_r * np.cos(lo), mid_r * np.sin(lo)))
            right_edges.append((mid_r * np.cos(hi), mid_r * np.sin(hi)))
            radial_diameters.append(outer_radius - inner_radius)
            idods.append(([cid[0], cod[0]], [cid[1], cod[1]]))
            corners.append((xx, yy))
            segment_id += 1

            # spider between this arc and the next, at the right-hand seam
            minx = min(xx[1], xx[3])
            maxx = max(xx[1], xx[3])
            miny = min(yy[1], yy[3])
            maxy = max(yy[1], yy[3])
            rangex = maxx - minx
            rangey = maxy - miny
            samples = tuple(math.ceil(v) for v in (rangex / dx + gap / dx,
                                                   rangey / dx + gap / dx))
            window = _local_window(ccy, ccx, (minx + rangex / 2, miny + rangey / 2), dx,
                                   samples, x, y)
            rr = r[window]
            spid = spider(1, azimuthal_gap, xh[window], yh[window], rotation=hi,
                          rotation_is_rad=True)
            spid = spid & (circle_sdf(inner_radius, rr) > 0)
            spid = spid & (circle_sdf(outer_radius, rr) <= 0)
            all_spiders[window] |= spid

    primary_mask = torch.where(all_spiders, torch.zeros_like(primary_mask), primary_mask)
    return {
        'center_segment': {
            'x': center_xx, 'y': center_yy, 'r': center_rr, 't': center_tt,
            'mask': center_mask, 'window': win,
        },
        'keystones': {
            'centers': all_centers, 'corners': corners, 'ids_ods': idods,
            'windows': windows, 'local_xy': local_coords, 'masks': local_masks,
            'rotations': center_angles, 'left_edges': left_edges,
            'right_edges': right_edges, 'radial_diameters': radial_diameters,
            'ids': segment_ids,
        },
        'amplitude_mask': primary_mask,
    }
