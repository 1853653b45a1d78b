"""Field, Sampling, launch, and stop-aim ergonomics.

Counterpart of ``prysm_tpu/x/raytracing/launch.py``.  Field descriptions,
pupil sampling patterns, and the launch() entry that seeds bundles onto the
entrance pupil and (under real aiming) drives them onto the stop with an
adaptive field-continuation ladder.  Host-side numpy orchestration; the
traces it drives run the tensor kernel on ``config.device`` and are read
back with ``to_host``; so do the continuation ladder's parabasal chief
traces.

Design notes: pupil patterns are realized through a builder registry on
:class:`Sampling` (one closure per pattern kind); the real-aiming homotopy
is decomposed into bundle construction, stop-map probing, ladder walking,
and a caustic-fold extrapolation rescue.
"""
import warnings
from dataclasses import dataclass

import numpy as onp
import torch

from . import raygen
from ._resolve import compiled_surfaces, trace_context
from .opt import aim_rays, declipped
from .paraxial import NonAxialSystemError, entrance_pupil_z
from .spencer_and_murty import (raytrace, to_host, transform_to_local_coords,
                                valid_mask)

_PREC = onp.float64
_SIDE_KEYS = ('vux', 'vlx', 'vuy', 'vly')


def _entrance_pupil_z(system, wvl_um):
    """Entrance-pupil z, preferring a system-level cached resolver."""
    resolver = getattr(system, 'entrance_pupil_z', None)
    if not callable(resolver):
        compiler = getattr(system, 'to_surfaces', None)
        prescription = compiler() if callable(compiler) else system
        stop = getattr(system, 'stop_index', None)
        resolver = lambda w: entrance_pupil_z(  # NOQA: E731
            prescription, w, stop_index=stop)
    try:
        return resolver(wvl_um)
    except NonAxialSystemError:
        # decentered geometry has no paraxial EP; launch warned instead
        return None


def _normalize_vignetting(vignetting):
    """Normalize per-field Code V vignetting factors."""
    if vignetting is None:
        return None
    factors = {key: float(vignetting.get(key, 0.0)) for key in _SIDE_KEYS}
    collapsed = [k for k, v in factors.items() if v >= 1.0]
    if collapsed:
        raise ValueError(
            f'vignetting factor {collapsed[0].upper()}='
            f'{factors[collapsed[0]]:g} collapses its side of the pupil; '
            'factors must stay below 1')
    return factors if any(factors.values()) else None


class Field:
    """A field point: kind='angle' (collimated) or 'height' (finite)."""

    __slots__ = ('hx', 'hy', 'object_z', 'kind', 'unit', 'vignetting')

    def __init__(self, hx=0.0, hy=0.0, kind='angle', unit='deg',
                 object_z=None, vignetting=None):
        """hx, hy: angles (unit) for 'angle', object heights for 'height';
        'height' requires object_z; vignetting holds the Code V side
        factors vux/vlx/vuy/vly."""
        if kind not in ('angle', 'height'):
            raise ValueError(f"Field kind must be 'angle' or 'height', "
                             f'got {kind!r}')
        if kind == 'angle' and unit not in ('deg', 'rad'):
            raise ValueError(f"Field unit for kind='angle' must be 'deg' "
                             f"or 'rad', got {unit!r}")
        if kind == 'height' and object_z is None:
            raise ValueError("Field kind='height' needs object_z (absolute "
                             'z of the object plane)')
        self.hx, self.hy, self.kind, self.unit = (float(hx), float(hy),
                                                  kind, unit)
        self.object_z = float(object_z) if object_z is not None else None
        self.vignetting = _normalize_vignetting(vignetting)

    def angle_radians(self):
        """(hx, hy) in radians; kind must be 'angle'."""
        if self.kind != 'angle':
            raise ValueError("Field.angle_radians: kind must be 'angle', "
                             f'got {self.kind!r}')
        if self.unit == 'rad':
            return (self.hx, self.hy)
        return float(onp.deg2rad(self.hx)), float(onp.deg2rad(self.hy))

    def __repr__(self):
        if self.kind == 'angle':
            return f'Field(hx={self.hx}, hy={self.hy}, unit={self.unit!r})'
        return (f'Field(hx={self.hx}, hy={self.hy}, kind=height, '
                f'object_z={self.object_z})')


# ---------- pupil sampling patterns -----------------------------------------


def _build_chief(opts, extent):
    return onp.zeros((1, 2), dtype=_PREC)


def _build_points(opts, extent):
    return onp.asarray(opts['xy'], dtype=_PREC) * extent


def _build_fan(opts, extent):
    bundle, _ = raygen.generate_collimated_ray_fan(
        opts['n'], maxr=extent, azimuth=opts.get('azimuth', 90),
        distribution=opts.get('distribution', 'uniform'))
    return onp.asarray(bundle[:, :2])


def _build_cross(opts, extent):
    dist = opts.get('distribution', 'uniform')
    arms = [raygen.generate_collimated_ray_fan(
        opts['n'], maxr=extent, azimuth=azi, distribution=dist)[0]
        for azi in (0, 90)]
    return onp.concatenate([onp.asarray(a[:, :2]) for a in arms], axis=0)


def _build_rect(opts, extent):
    bundle, _ = raygen.generate_collimated_rect_ray_grid(
        opts['n'], maxx=extent,
        distribution=opts.get('distribution', 'uniform'))
    return onp.asarray(bundle[:, :2])


def _build_hex(opts, extent):
    nrings = opts['nrings']
    spacing = opts.get('spacing')
    if spacing is None:
        spacing = extent / nrings if nrings else 0.0
    bundle, _ = raygen.generate_collimated_hex_ray_grid(nrings, spacing)
    return onp.asarray(bundle[:, :2])


def _build_spiral(opts, extent):
    bundle, _ = raygen.generate_collimated_radial_spiral_ray_grid(
        opts['nrings'], maxr=extent,
        samples_per_ring=opts.get('samples_per_ring'),
        radial_distribution=opts.get('radial_distribution', 'cheby'),
        include_center=opts.get('include_center', True))
    return onp.asarray(bundle[:, :2])


_PATTERN_BUILDERS = {
    'chief': _build_chief, 'points': _build_points, 'fan': _build_fan,
    'cross': _build_cross, 'rect': _build_rect, 'hex': _build_hex,
    'spiral': _build_spiral,
}


def _odd_grid_center(n, obscuration, center):
    """The exact-chief slot of an odd unobscured pattern, else None."""
    return center if (n % 2 and not obscuration) else None


class Sampling:
    """Pupil sampling pattern; build(extent) -> (N, 2) pupil coordinates."""

    __slots__ = ('kind', 'opts', 'chief_index')

    def __init__(self, kind, *, chief_index=None, **opts):
        self.kind, self.opts, self.chief_index = kind, opts, chief_index

    def build(self, extent):
        """Pupil sample coordinates, scaled to the given extent."""
        builder = _PATTERN_BUILDERS.get(self.kind)
        if builder is None:
            raise ValueError(f'unknown sampling kind {self.kind!r}')
        samples = builder(self.opts, extent)
        hole = self.opts.get('obscuration')
        if hole:
            r = onp.hypot(samples[:, 0], samples[:, 1])
            samples = samples[r >= float(hole) * extent]
        return onp.asarray(samples, dtype=_PREC)

    @classmethod
    def chief(cls):
        """One chief ray at the pupil origin."""
        return cls(kind='chief', chief_index=0)

    @classmethod
    def points(cls, xy):
        """Explicit normalized pupil samples."""
        xy = onp.asarray(xy)
        at_origin = onp.flatnonzero(onp.all(xy == 0, axis=1))
        slot = int(at_origin[0]) if len(at_origin) else None
        return cls('points', xy=xy, chief_index=slot)

    @classmethod
    def fan(cls, n=11, axis='y', distribution='uniform', obscuration=None):
        """A 1D fan of n rays along one axis ('x' or 'y')."""
        try:
            azi = {'x': 0, 'y': 90}[axis]
        except KeyError:
            raise ValueError(f"axis must be 'x' or 'y', got {axis!r}") \
                from None
        n = int(n)
        return cls('fan', n=n, azimuth=azi, obscuration=obscuration,
                   distribution=distribution,
                   chief_index=_odd_grid_center(n, obscuration, n // 2))

    @classmethod
    def cross(cls, n=11, distribution='uniform', obscuration=None):
        """An x and a y fan, 2*n rays in total."""
        n = int(n)
        return cls('cross', n=n, obscuration=obscuration,
                   distribution=distribution,
                   chief_index=_odd_grid_center(n, obscuration, n // 2))

    @classmethod
    def rect(cls, n=21, distribution='uniform', obscuration=None):
        """A rectangular grid of n x n rays."""
        n = int(n)
        return cls('rect', n=n, obscuration=obscuration,
                   distribution=distribution,
                   chief_index=_odd_grid_center(n, obscuration,
                                                n * n // 2))

    @classmethod
    def hex(cls, nrings=5, spacing=None, obscuration=None):
        """A hexapolar grid with nrings concentric rings."""
        return cls('hex', nrings=int(nrings), obscuration=obscuration,
                   spacing=spacing,
                   chief_index=None if obscuration else 0)

    @classmethod
    def spiral(cls, nrings=5, samples_per_ring=None,
               radial_distribution='cheby', include_center=True,
               obscuration=None):
        """A radial-azimuthal spiral grid."""
        center = 0 if include_center and not obscuration else None
        return cls('spiral', nrings=int(nrings), obscuration=obscuration,
                   samples_per_ring=samples_per_ring,
                   radial_distribution=radial_distribution,
                   include_center=bool(include_center), chief_index=center)

    def __repr__(self):
        body = ', '.join(f'{k}={v!r}' for k, v in self.opts.items())
        return f"Sampling({self.kind!r}{', ' if body else ''}{body})"


# ---------- bundle construction ---------------------------------------------


def _collimated_PS(samples_xy, plane_z, field):
    ax, ay = field.angle_radians()
    Sx, Sy = (float(onp.sin(a)) for a in (ax, ay))
    Sz_sq = 1.0 - (Sx * Sx + Sy * Sy)
    if Sz_sq < 0.0:
        raise ValueError(f'field angles ({ax}, {ay}) rad have sin^2 sum '
                         '> 1; beam direction is not physical')
    n_rays = samples_xy.shape[0]
    P = onp.empty((n_rays, 3), dtype=samples_xy.dtype)
    P[:, :2] = samples_xy
    P[:, 2] = plane_z
    direction = onp.array([Sx, Sy, float(onp.sqrt(Sz_sq))],
                          dtype=samples_xy.dtype)
    return P, onp.broadcast_to(direction, (n_rays, 3)).copy()


def _finite_PS(samples_xy, plane_z, field):
    n_rays = samples_xy.shape[0]
    source = onp.array([field.hx, field.hy, field.object_z],
                       dtype=samples_xy.dtype)
    P = onp.broadcast_to(source, (n_rays, 3)).copy()
    landing = onp.empty((n_rays, 3), dtype=samples_xy.dtype)
    landing[:, :2] = samples_xy
    landing[:, 2] = plane_z
    direction = landing - P
    length = onp.sqrt(onp.sum(direction * direction, axis=-1,
                              keepdims=True))
    if not onp.all(length > 0):
        raise ValueError('one or more pupil samples coincide with the '
                         'object point; no finite-conjugate direction')
    return P, direction / length


def _perp_basis(w):
    """Meridional T/S basis perpendicular to the unit vector w."""
    transverse = float(onp.sqrt(w[0] * w[0] + w[1] * w[1]))
    if transverse < 1e-12:
        return (onp.array([1.0, 0.0, 0.0], dtype=w.dtype),
                onp.array([0.0, float(onp.sign(w[2])), 0.0], dtype=w.dtype))
    e1 = onp.array([float(w[1]), -float(w[0]), 0.0],
                   dtype=w.dtype) / transverse
    flipped = (float(e1[0]) < 0.0
               or (float(e1[0]) == 0.0 and float(e1[1]) < 0.0))
    if flipped:
        e1 = -e1
    return e1, onp.cross(w, e1)


def _object_space_cone_PS(system, field, wvl_um, sampling, na,
                          ep_z='paraxial'):
    """Sine-condition object cone for an object-space NA / F/# aperture."""
    if field.kind != 'height':
        raise ValueError('an object-space NA / F-number aperture needs a '
                         "finite-conjugate (kind='height') field")
    n_obj = trace_context(system, wvl_um).n_object
    sinU = float(na) / float(n_obj)
    if not 0.0 < sinU < 1.0:
        raise ValueError(f'object-space NA {na:g} over index {n_obj:g} '
                         f'gives sin(U)={sinU:g}, not a physical cone '
                         'half-angle')

    rho_norm = onp.asarray(
        _apply_vignetting(sampling.build(1.0), field), dtype=_PREC)
    n_rays = rho_norm.shape[0]
    source = onp.array([field.hx, field.hy, field.object_z], dtype=_PREC)

    if ep_z == 'paraxial':
        ep_z = _entrance_pupil_z(system, wvl_um)
    if ep_z is None:
        toward_pupil = onp.array([0.0, 0.0, 1.0], dtype=_PREC)
    else:
        toward_pupil = onp.array([0.0, 0.0, float(ep_z)],
                                 dtype=_PREC) - source
    toward_pupil = toward_pupil / onp.sqrt(onp.sum(toward_pupil ** 2))

    e1, e2 = _perp_basis(toward_pupil)
    skew = sinU * (rho_norm[:, 0:1] * e1[onp.newaxis, :]
                   + rho_norm[:, 1:2] * e2[onp.newaxis, :])
    axial_sq = 1.0 - sinU * sinU * onp.sum(rho_norm * rho_norm, axis=1)
    axial = onp.sqrt(onp.clip(axial_sq, 0.0, None))
    S = axial[:, onp.newaxis] * toward_pupil[onp.newaxis, :] + skew
    return onp.broadcast_to(source, (n_rays, 3)).copy(), S, rho_norm


def _apply_vignetting(samples_xy, field):
    """Scale pupil samples by per-field side-vignetting factors."""
    factors = getattr(field, 'vignetting', None)
    if not factors:
        return samples_xy
    x, y = samples_xy[:, 0], samples_xy[:, 1]
    x = x * onp.where(x >= 0.0, 1.0 - factors.get('vux', 0.0),
                      1.0 - factors.get('vlx', 0.0))
    y = y * onp.where(y >= 0.0, 1.0 - factors.get('vuy', 0.0),
                      1.0 - factors.get('vly', 0.0))
    return onp.stack([x, y], axis=1)


def _has_decentered_geometry(system):
    def off_axis(surf):
        P = to_host(getattr(surf, 'P', (0.0, 0.0, 0.0)))
        if P.shape[0] >= 2 and bool(onp.any(onp.abs(P[:2]) > 1e-12)):
            return True
        R = getattr(surf, 'R', None)
        return R is not None and bool(onp.any(
            onp.abs(to_host(R) - onp.eye(3)) > 1e-12))

    return any(off_axis(surf) for surf in system)


def _warn_paraxial_aiming(system, ray_aiming):
    if ray_aiming == 'paraxial' and _has_decentered_geometry(system):
        warnings.warn(
            "launch: the system carries tilts/decenters but ray_aiming is "
            "'paraxial'; the paraxial entrance pupil ignores them and "
            "bundles may miss the stop.  Consider ray_aiming='real' or an "
            'explicit aim_to=stop.', stacklevel=3)


# ---------- real aiming onto the stop ---------------------------------------


@dataclass(frozen=True)
class _StopTarget:
    """Stop-local center and normalized-pupil affine map."""

    center: 'onp.ndarray'
    pupil_map: 'onp.ndarray' = None

    def scaled(self, scale):
        """Keep the center fixed; scale the pupil extent."""
        if self.pupil_map is None:
            return self
        return _StopTarget(self.center, self.pupil_map * scale)


def _probe_pupil_map(P, S, rho_norm, system, stop_index, wvl_um):
    """Diagonal rho->stop-local affine map inferred from the bundle."""
    tr = raytrace(declipped(system[:stop_index + 1]), P, S, wvl_um)
    stop_surf = system[stop_index]
    landing, _ = transform_to_local_coords(tr.P[-1], stop_surf.P, tr.S[-1],
                                           stop_surf.R)
    landing = to_host(landing)[:, :2]
    usable = onp.isfinite(landing).all(axis=1)

    def axis_slope(rho_k, landing_k):
        rho_k, landing_k = rho_k[usable], landing_k[usable]
        if rho_k.size < 2:
            return 0.0
        top, bottom = int(onp.argmax(rho_k)), int(onp.argmin(rho_k))
        span = float(rho_k[top] - rho_k[bottom])
        return (float(landing_k[top] - landing_k[bottom]) / span
                if abs(span) > 1e-12 else 0.0)

    return onp.array([[axis_slope(rho_norm[:, 0], landing[:, 0]), 0.0],
                      [0.0, axis_slope(rho_norm[:, 1], landing[:, 1])]],
                     dtype=_PREC)


def _real_aim_to_stop(P, S, rho_norm, system, stop_index, wvl_um,
                      finite_conjugate, stop_goal=None):
    """Aim a normalized pupil grid onto a stop-local affine target."""
    if stop_goal is None:
        stop_goal = _StopTarget(onp.zeros(2, dtype=_PREC), None)
    pupil_map = stop_goal.pupil_map
    if pupil_map is None:
        pupil_map = _probe_pupil_map(P, S, rho_norm, system, stop_index,
                                     wvl_um)
    else:
        pupil_map = onp.asarray(pupil_map, dtype=_PREC)
    target = (onp.asarray(stop_goal.center, dtype=_PREC)
              + rho_norm @ pupil_map.T)
    P, S, landed = aim_rays(
        P, S, system, stop_index, target, wvl_um,
        vary='direction' if finite_conjugate else 'position', strict=False)
    return P, S, landed


def _axial_field(field):
    """The on-axis sibling of a field (same conjugate, no vignetting)."""
    if field.kind == 'angle':
        return Field(kind='angle', unit=field.unit)
    return Field(kind='height', object_z=field.object_z)


# rim probes for the stop pupil map: +/-x and +/-y at rho = 1
_STOP_RIM_XY = ((+1.0, 0.0), (-1.0, 0.0), (0.0, +1.0), (0.0, -1.0))


def _stop_target(system, stop_index, wvl_um, build_bundle, field):
    """Stop-local center + normalized-pupil affine map from rim probes."""
    rim = Sampling.points(onp.asarray(_STOP_RIM_XY, dtype=_PREC))
    P0, S0, _ = build_bundle(_axial_field(field), 'paraxial', samp=rim)
    tr = raytrace(declipped(system[:stop_index + 1]), P0, S0, wvl_um)
    surf = system[stop_index]
    landing, _ = transform_to_local_coords(tr.P[-1], surf.P, tr.S[-1],
                                           surf.R)
    landing = to_host(landing)
    center = onp.asarray(surf.aperture.center(), dtype=_PREC)
    if not bool(onp.isfinite(landing[:, :2]).all()):
        return _StopTarget(center, None)
    pupil_map = onp.stack([0.5 * (landing[0, :2] - landing[1, :2]),
                           0.5 * (landing[2, :2] - landing[3, :2])], axis=1)

    # a stop clip tighter than the axial marginal binds the pupil edge
    clip_r = surf.aperture.limiting_radius(None)
    rim_r = float(onp.max(onp.sqrt(onp.sum(pupil_map * pupil_map, axis=0))))
    if clip_r is not None and clip_r < rim_r:
        pupil_map = onp.eye(2, dtype=_PREC) * (float(clip_r) * (1.0 - 1e-9))
    return _StopTarget(center, pupil_map)


# adaptive field-continuation homotopy tuning: initial fractional-field
# step, growth factor after a successful rung, the subdivision floor below
# which a field is declared untransmittable, and an iteration backstop
_CONTINUATION = {'step0': 0.25, 'grow': 1.6,
                 'min_step': 1.0 / 128, 'maxiter': 200}


def _scaled_field(field, frac):
    return field._replace(hx=field.hx * frac, hy=field.hy * frac) \
        if hasattr(field, '_replace') else Field(
            hx=field.hx * frac, hy=field.hy * frac, kind=field.kind,
            unit=field.unit, object_z=field.object_z,
            vignetting=field.vignetting)


class _PinnedAimingProxy:
    """Delegating system view whose ray_aiming is pinned to 'paraxial'.

    Breaks the recursion where the continuation ladder's parabasal EP
    seed would launch an aimed chief that re-enters the ladder.
    """

    ray_aiming = 'paraxial'

    def __init__(self, system):
        self._inner = system

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __getitem__(self, key):
        return self._inner[key]

    def __len__(self):
        return len(self._inner)

    def __iter__(self):
        return iter(self._inner)


def _parabasal_ep_z(system, field, wvl_um):
    """Field-dependent entrance-pupil z, with paraxial fallback.

    As the JAX package: where ``first_order`` cannot place the pupil
    (ValueError, IndexError, ArithmeticError, LinAlgError) or places none,
    the paraxial entrance pupil is taken.
    """
    from .parabasal import first_order
    try:
        ep = first_order(_PinnedAimingProxy(system), field, wvl_um).ep_z
    except (ValueError, IndexError, ArithmeticError,
            onp.linalg.LinAlgError):
        ep = None
    if ep is None:
        return _entrance_pupil_z(system, wvl_um)
    return float(onp.mean(ep)) if hasattr(ep, '__len__') else float(ep)


def _warm_start_bundle(P, S, warmP, warmS, finite_conjugate, good):
    """Seed the varied transverse component from the previous ladder rung."""
    if finite_conjugate:
        S[good, 0] = warmS[good, 0]
        S[good, 1] = warmS[good, 1]
        S /= onp.sqrt(onp.sum(S * S, axis=1, keepdims=True))
    else:
        P[good, 0] = warmP[good, 0]
        P[good, 1] = warmP[good, 1]


def _extrapolation_rescue(P, S, rho_norm, aimed, system, stop_index,
                          wvl_um, finite_conjugate, stop_goal):
    """Linearly extrapolate landed solutions in rho to re-seed the lost."""
    n_aimed = int(aimed.sum())
    design = onp.stack([onp.ones(n_aimed), rho_norm[aimed, 0],
                        rho_norm[aimed, 1]], axis=1)
    varied = S if finite_conjugate else P
    coef, *_ = onp.linalg.lstsq(design, varied[aimed, :2], rcond=None)
    lost = ~aimed
    guess = onp.stack([onp.ones(int(lost.sum())), rho_norm[lost, 0],
                       rho_norm[lost, 1]], axis=1) @ coef
    P2, S2 = P.copy(), S.copy()
    if finite_conjugate:
        S2[lost, 0], S2[lost, 1] = guess[:, 0], guess[:, 1]
        S2 /= onp.sqrt(onp.sum(S2 * S2, axis=1, keepdims=True))
    else:
        P2[lost, 0], P2[lost, 1] = guess[:, 0], guess[:, 1]
    P2, S2, landed2 = _real_aim_to_stop(P2, S2, rho_norm, system,
                                        stop_index, wvl_um,
                                        finite_conjugate,
                                        stop_goal=stop_goal)
    recovered = landed2 & lost
    if bool(onp.any(recovered)):
        P, S = P.copy(), S.copy()
        P[recovered] = P2[recovered]
        S[recovered] = S2[recovered]
        aimed = aimed | recovered
    return P, S, aimed


def _aim_to_stop_with_ladder(P, S, rho_norm, build_bundle, field, system,
                             stop_index, wvl_um, finite_conjugate,
                             drop_unaimed=False, stop_goal=None):
    """Real aiming with an adaptive field-and-pupil continuation fallback.

    Walks field and pupil from on-axis to the target, warm-starting each
    rung from the last and bisecting the step whenever the chief is lost,
    so the seed stays inside the next rung's Newton basin (reference:
    prysm/x/raytracing/launch.py:588-694).
    """
    P, S, landed = _real_aim_to_stop(P, S, rho_norm, system, stop_index,
                                     wvl_um, finite_conjugate,
                                     stop_goal=stop_goal)
    if bool(onp.all(landed)):
        return P, S

    chief = int(onp.argmin(rho_norm[:, 0] ** 2 + rho_norm[:, 1] ** 2))
    warmP = warmS = None
    warm_landed = onp.zeros(rho_norm.shape[0], dtype=bool)
    landed_full = onp.zeros(rho_norm.shape[0], dtype=bool)
    P_full = S_full = None
    progress, rung = 0.0, _CONTINUATION['step0']
    for _ in range(_CONTINUATION['maxiter']):
        if progress >= 1.0:
            break
        reach = min(1.0, progress + rung)
        field_k = _scaled_field(field, reach)
        Pk, Sk, rho_k = build_bundle(field_k,
                                     _parabasal_ep_z(system, field_k,
                                                     wvl_um),
                                     escale=reach)
        if warmP is not None:
            _warm_start_bundle(Pk, Sk, warmP, warmS, finite_conjugate,
                               warm_landed)
        goal_k = None if stop_goal is None else stop_goal.scaled(reach)
        Pk, Sk, landed_k = _real_aim_to_stop(Pk, Sk, rho_k, system,
                                             stop_index, wvl_um,
                                             finite_conjugate,
                                             stop_goal=goal_k)
        if bool(landed_k[chief]):
            if warmP is None:
                warmP, warmS = Pk.copy(), Sk.copy()
            else:
                warmP[landed_k] = Pk[landed_k]
                warmS[landed_k] = Sk[landed_k]
            warm_landed = warm_landed | landed_k
            progress = reach
            rung = min(rung * _CONTINUATION['grow'], 1.0)
            if progress >= 1.0:
                landed_full, P_full, S_full = landed_k, Pk, Sk
        else:
            rung *= 0.5
            if rung < _CONTINUATION['min_step']:
                break

    rescued = landed_full & ~landed
    if bool(onp.any(rescued)):
        P, S = P.copy(), S.copy()
        P[rescued] = P_full[rescued]
        S[rescued] = S_full[rescued]

    aimed = landed | landed_full
    # caustic-fold rescue: extrapolate landed solutions linearly in rho
    if not bool(onp.all(aimed)) and int(onp.sum(aimed)) >= 3:
        P, S, aimed = _extrapolation_rescue(P, S, rho_norm, aimed, system,
                                            stop_index, wvl_um,
                                            finite_conjugate, stop_goal)

    if drop_unaimed and not bool(onp.all(aimed)):
        S = onp.array(S, copy=True)
        S[~aimed] = onp.nan
    return P, S


# ---------- the launch entry point ------------------------------------------


def _resolve_object_mode(system, wvl_um, epd, pupil_extent):
    """(object mode flag, NA) from the system aperture specification."""
    if epd is not None or pupil_extent is not None:
        return False, None
    aperture = getattr(system, 'aperture', None)
    resolved = (aperture.resolve(system, wvl_um)
                if aperture is not None else None)
    if resolved is None or resolved[0] not in ('NA_OBJECT', 'FNO_OBJECT'):
        return False, None
    na = (resolved[1] if resolved[0] == 'NA_OBJECT'
          else 1.0 / (2.0 * resolved[1]))
    return True, na


def launch(system, field, wavelength, sampling, *,
           epd=None, pupil_extent=None, pupil_z=None,
           aim_to=None, aim_target=(0.0, 0.0), aim_strict=True,
           drop_unaimed=True):
    """Build (P, S) for one field, wavelength, and pupil sampling.

    epd / pupil_extent size the pupil pattern (else the system aperture
    resolves it); aim_to aims every ray at aim_target on that surface;
    real ray_aiming (system attribute) drives the bundle onto the stop.
    """
    ray_aiming = str(getattr(system, 'ray_aiming', 'paraxial')).lower()
    real_aiming = ray_aiming == 'real' and aim_to is None
    stop_index = getattr(system, 'stop_index', None)
    if aim_to is None:
        _warn_paraxial_aiming(system, ray_aiming)

    object_mode, na = _resolve_object_mode(system, wavelength, epd,
                                           pupil_extent)
    finite_conjugate = object_mode or field.kind != 'angle'

    if not object_mode:
        if epd is None and pupil_extent is None:
            resolver = getattr(system, 'entrance_pupil_diameter', None)
            if callable(resolver):
                epd = resolver(wavelength)
        if sampling.kind != 'chief' and epd is None and pupil_extent is None:
            raise ValueError(f'sampling kind {sampling.kind!r} needs an '
                             'entrance pupil size; pass epd=... or '
                             'pupil_extent=...')
        if pupil_extent is not None:
            half_aperture = float(pupil_extent)
        else:
            half_aperture = float(epd) / 2.0 if epd is not None else 0.0
        pupil_z = float(pupil_z if pupil_z is not None
                        else system[0].P[2])

    def _build(fld, ep_z, escale=1.0, samp=None):
        """Bundle (P, S, rho) for one field seeded onto the EP at ep_z."""
        samp = sampling if samp is None else samp
        if object_mode:
            return _object_space_cone_PS(system, fld, wavelength, samp, na,
                                         ep_z=ep_z)
        ep = (_entrance_pupil_z(system, wavelength)
              if ep_z == 'paraxial' else ep_z)
        scaled_extent = half_aperture * escale
        samples_xy = onp.asarray(
            _apply_vignetting(samp.build(scaled_extent), fld), dtype=_PREC)
        if fld.kind == 'angle':
            P, S = _collimated_PS(samples_xy, pupil_z, fld)
            if ep is not None:
                # slide the collimated bundle to the entrance-pupil plane
                S0 = S[0]
                slide = (pupil_z - ep) / S0[2]
                P = P + onp.stack([slide * S0[0], slide * S0[1],
                                   onp.zeros_like(slide)])
        else:
            P, S = _finite_PS(samples_xy,
                              float(ep) if ep is not None else pupil_z, fld)
        rho_norm = (samples_xy / scaled_extent if scaled_extent > 0.0
                    else onp.zeros_like(samples_xy))
        return P, S, rho_norm

    # primary bundle: paraxial-EP seed (no seed when explicitly aiming)
    P, S, rho_norm = _build(field, None if aim_to is not None
                            else 'paraxial')

    if aim_to is not None:
        P, S, _ = aim_rays(
            P, S, system, aim_to, aim_target, wavelength,
            strict=aim_strict,
            vary='direction' if finite_conjugate else 'position')
    elif real_aiming and stop_index is not None:
        stop_goal = _stop_target(system, stop_index, wavelength, _build,
                                 field)
        P, S = _aim_to_stop_with_ladder(
            P, S, rho_norm, _build, field, system, stop_index, wavelength,
            finite_conjugate, drop_unaimed=drop_unaimed,
            stop_goal=stop_goal)

    return P, S


# ---------- solves over launches --------------------------------------------


def _resolve_fields(system, fields):
    """Resolve a fields spec to a list (system field set if None)."""
    if fields is None:
        carried = getattr(system, 'fields', None)
        if carried is not None and len(carried):
            return list(carried)
        return [Field(0.0, 0.0)]
    resolver = getattr(system, 'field', None)
    return [resolver(f) if callable(resolver) else f for f in fields]


def _footprint_radii(prescription, P_track):
    """Per-surface max valid ray radius in each surface's local frame."""
    radii = onp.zeros(len(prescription))
    for j, surf in enumerate(prescription):
        at_surface = torch.as_tensor(P_track[j + 1])
        local, _ = transform_to_local_coords(
            at_surface, surf.P, torch.zeros_like(at_surface), surf.R)
        local = to_host(local)
        r = onp.hypot(local[..., 0], local[..., 1])
        if onp.isfinite(r).any():
            radii[j] = float(onp.nanmax(r))
    return radii


def solve_apertures(system, *, fields=None, wavelength=None, oversize=1.05,
                    sampling=None):
    """Size each auto surface aperture from the traced ray footprint."""
    from .lensdata import SurfaceRow
    lens = system.lens
    wvl = wavelength if wavelength is not None else system.wavelength()
    fields = _resolve_fields(system, fields)
    if sampling is None:
        sampling = Sampling.hex(nrings=6)
    prescription = system.to_surfaces()

    footprint = onp.zeros(len(prescription))
    for field in fields:
        field = system.field(field)
        P, S = launch(system, field, wvl, sampling, drop_unaimed=True)
        result = raytrace(prescription, P, S, wvl)
        P_track = onp.array(to_host(result.P), copy=True)
        alive = valid_mask(to_host(result.status), P_track[-1])
        if alive is not None:
            P_track[:, ~onp.asarray(alive), :] = onp.nan
        footprint = onp.maximum(footprint,
                                _footprint_radii(prescription, P_track))

    si = 0
    for row in lens.rows:
        if not isinstance(row, SurfaceRow):
            continue
        if row.aperture.is_auto:
            row.aperture.solve_extent(footprint[si], lens._version,
                                      oversize=oversize)
        si += 1
    return system


def solve_vignetting(system, fields=None, wavelength=None, *, tol=1e-3,
                     maxiter=20):
    """Solve and store Code V-style vignetting factors per field."""
    wvl = system.wavelength(wavelength)
    fields = _resolve_fields(system, fields)
    if len(system.fields) == 0:
        from .system import FieldSet
        system.fields = FieldSet(fields)
    for field in fields:
        field = system.field(field)
        field.vignetting = _normalize_vignetting(
            _solve_vignetting_factors(system, field, wvl, tol=tol,
                                      maxiter=maxiter))
    return system


def _solve_vignetting_factors(system, field, wvl_um, *, tol=1e-3,
                              maxiter=20):
    """Solve the four vignetting factors for one field by bisection."""
    bare = Field(field.hx, field.hy, kind=field.kind, unit=field.unit,
                 object_z=field.object_z)
    probes = onp.asarray([[0.0, 0.0], [1.0, 0.0], [-1.0, 0.0],
                          [0.0, 1.0], [0.0, -1.0]], dtype=_PREC)

    def transmits(scales):
        scaling = onp.asarray([1.0, *scales], dtype=_PREC)
        xy = probes * scaling[:, onp.newaxis]
        P, S = launch(system, bare, wvl_um, Sampling.points(xy),
                      drop_unaimed=False)
        result = raytrace(compiled_surfaces(system), P, S, wvl_um)
        return to_host(valid_mask(result.status))

    alive = transmits([1.0] * 4)
    if not bool(alive[0]):
        raise ValueError('solve_vignetting: the chief ray does not '
                         'transmit; vignetting factors are referenced to '
                         'it')
    lo = [1.0 if bool(v) else 0.0 for v in alive[1:]]
    hi = [1.0] * 4
    open_sides = [not bool(v) for v in alive[1:]]
    for _ in range(maxiter):
        gaps = [h - l for h, l, a in zip(hi, lo, open_sides) if a]
        if not gaps or max(gaps) <= tol:
            break
        mid = [(l + h) / 2.0 if a else 1.0
               for l, h, a in zip(lo, hi, open_sides)]
        mid_alive = transmits(mid)
        for i in range(4):
            if open_sides[i]:
                if bool(mid_alive[i + 1]):
                    lo[i] = mid[i]
                else:
                    hi[i] = mid[i]
    for key, l, a in zip(_SIDE_KEYS, lo, open_sides):  # NOQA: E741
        if a and l == 0.0:
            raise ValueError(f'solve_vignetting: the {key} edge ray fails '
                             'at every probed pupil scale; the side '
                             'appears fully vignetted')
    return {key: 1.0 - l for key, l in zip(_SIDE_KEYS, lo)}
