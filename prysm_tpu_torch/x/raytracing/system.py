"""OpticalSystem: aperture/field/wavelength metadata over a LensData spine.

Counterpart of ``prysm_tpu/x/raytracing/system.py``.  Design notes:

* aperture modes are rows in a traits registry (``_MODE_TRAITS``) carrying
  their legality flags and an EPD-conversion strategy, instead of a
  per-mode if/elif ladder;
* every version-keyed derived quantity funnels through one memoization
  helper (:meth:`OpticalSystem._memo`);
* metadata coercion happens in small standalone normalizers so the
  constructor reads as a checklist.

This layer is host-side editor code; tensor work happens in the trace
kernel and the batched launch/analysis paths.
"""
import warnings
from collections import namedtuple
from copy import deepcopy
from numbers import Integral as _Int, Number as _Num

import numpy as np

from .paraxial import (effective_focal_length, system_matrix,
                       entrance_pupil_z as _paraxial_ep_z)
from .spencer_and_murty import _is_measurement_surf as _is_meas, to_host
from .lensdata import DesignState, LensData
from ._cache import structural_key, StateCache
from ._meta import object_space_index as _n_object_space
from ._namespaces import (_AnalysisNamespace, _OptNamespace,
                          _PlotNamespace, _SolveNamespace, _TolNamespace)

# aperture-mode tags
EPD = 'EPD'
FNO_IMAGE, FNO_OBJECT = 'FNO_IMAGE', 'FNO_OBJECT'
NA_IMAGE, NA_OBJECT = 'NA_IMAGE', 'NA_OBJECT'

_AFOCAL_EPS = 1e-30


# ---------------------------------------------------------------------------
# Aperture-mode traits
# ---------------------------------------------------------------------------

def _epd_passthrough(spec, system, wvl, surfaces, C):
    return spec.value


def _epd_from_na_image(spec, system, wvl, surfaces, C):
    # NA_img = |C| EPD / 2, inverted
    return 2.0 * spec.value / abs(C)


def _epd_from_fno_image(spec, system, wvl, surfaces, C):
    # infinite-conjugate working F/# = |EFL| / EPD, inverted
    return abs(effective_focal_length(surfaces, wvl=wvl)) / spec.value


def _epd_from_object_cone(spec, system, wvl, surfaces, C):
    # marginal ray of the object-space cone, object plane -> entrance pupil:
    # u = NA_obj / n_obj, half-height at the EP = u |z_EP - z_obj|
    if spec.mode == FNO_OBJECT:
        na_obj = 0.5 / spec.value
    else:
        na_obj = spec.value
    u = na_obj / _n_object_space(system, wvl)
    z_ep = _paraxial_ep_z(surfaces, wvl=wvl, stop_index=system.stop_index)
    z_obj = float(to_host(surfaces[0].P)[2])
    if z_ep is None:
        raise ValueError(
            'cannot resolve an object-space aperture: the entrance '
            'pupil is at infinity (object-space telecentric) or the '
            'stop is unknown')
    return 2.0 * u * abs(z_ep - z_obj)


_ModeTraits = namedtuple('_ModeTraits', ['object_space', 'needs_power',
                                         'to_epd'])

_MODE_TRAITS = {
    EPD: _ModeTraits(False, False, _epd_passthrough),
    FNO_IMAGE: _ModeTraits(False, True, _epd_from_fno_image),
    FNO_OBJECT: _ModeTraits(True, True, _epd_from_object_cone),
    NA_IMAGE: _ModeTraits(False, True, _epd_from_na_image),
    NA_OBJECT: _ModeTraits(True, True, _epd_from_object_cone),
}

_APERTURE_MODES = tuple(_MODE_TRAITS)
_OBJECT_SPACE_MODES = tuple(m for m, t in _MODE_TRAITS.items()
                            if t.object_space)


class ApertureSpec:
    """One aperture boundary condition: a mode tag plus its value."""

    __slots__ = ('mode', 'value')

    def __init__(self, value, mode=EPD):
        """value in the units of mode (EPD diameter, F-number, or NA)."""
        mode = f'{mode}'.upper()
        if mode not in _MODE_TRAITS:
            raise ValueError(
                f'aperture mode {mode!r} must be one of {_APERTURE_MODES}')
        self.mode, self.value = mode, float(value)
        if np.isfinite(self.value) is False or self.value <= 0.0:
            raise ValueError('an aperture value must be a positive finite '
                             'number')

    @classmethod
    def epd(cls, value):
        """A spec giving the entrance-pupil diameter directly."""
        return cls(value, mode=EPD)

    @classmethod
    def fno(cls, value, *, object_space=False):
        """An F-number spec; image-space unless object_space=True."""
        return cls(value, FNO_OBJECT if object_space
                   else FNO_IMAGE)

    @classmethod
    def na(cls, value, *, object_space=False):
        """A numerical-aperture spec; image-space unless object_space."""
        return cls(value, NA_OBJECT if object_space
                   else NA_IMAGE)

    def validate(self, object_at_infinity, *, has_power=True):
        """Raise if this spec is illegal for the conjugate or power."""
        traits = _MODE_TRAITS[self.mode]
        if traits.object_space and object_at_infinity:
            raise ValueError(
                f'aperture mode {self.mode!r} measures the object-space '
                'cone, which needs a finite conjugate; this system images '
                'from infinity')
        if traits.needs_power and not has_power:
            raise ValueError(
                f'aperture mode {self.mode!r} needs net focusing power, '
                'but this system is afocal -- use an EPD spec instead')

    def _power_term(self, system, wvl):
        """The C element of the paraxial system matrix (power proxy)."""
        abcd, _ = system_matrix(system.to_surfaces(), wvl=wvl)
        return float(abcd[1][0])

    def _validate_for_system(self, system, wvl=None):
        at_inf = bool(getattr(system, 'object_at_infinity', True))
        self.validate(at_inf, has_power=True)
        if self.mode == EPD:
            return None
        wvl_um = system.wavelength(wvl)
        C = self._power_term(system, wvl_um)
        self.validate(at_inf, has_power=abs(C) >= _AFOCAL_EPS)
        return C

    def resolve(self, system, wvl=None):
        """(kind, value) launch boundary condition for this spec."""
        self._validate_for_system(system, wvl)
        return self.mode, self.value

    def entrance_pupil_diameter(self, system, wvl=None):
        """Equivalent paraxial entrance-pupil diameter for this spec."""
        if self.mode == EPD:
            at_inf = bool(getattr(system, 'object_at_infinity', True))
            self.validate(at_inf, has_power=True)
            return self.value
        C = self._validate_for_system(system, wvl)
        wvl_um = system.wavelength(wvl)
        return _MODE_TRAITS[self.mode].to_epd(
            self, system, wvl_um, system.to_surfaces(), C)

    def __repr__(self):
        head = 'EPD' if self.mode == EPD else self.mode
        return f'ApertureSpec({head}={self.value:g})'


# ---------------------------------------------------------------------------
# Field sets
# ---------------------------------------------------------------------------

def _homogeneity_rule(kind):
    """What must agree across a FieldSet of the given kind."""
    if kind == 'angle':
        return ('unit', 'an angular FieldSet must use one angular unit')
    if kind == 'height':
        return ('object_z', 'a height FieldSet must use one object plane')
    return None


class FieldSet:
    """Ordered field points with a tabular repr."""

    __slots__ = ('fields',)

    def __init__(self, fields=None):
        self.fields = _as_field_list(fields)
        self._check_homogeneous()

    def _check_homogeneous(self):
        if not self.fields:
            return
        lead = self.fields[0]
        for f in self.fields[1:]:
            if f.kind != lead.kind:
                raise ValueError('every field in a FieldSet must share one kind')
        rule = _homogeneity_rule(lead.kind)
        if rule is not None:
            attr, complaint = rule
            anchor = getattr(lead, attr)
            if any(getattr(f, attr) != anchor for f in self.fields[1:]):
                raise ValueError(complaint)

    def __len__(self):
        return self.fields.__len__()

    def __iter__(self):
        return self.fields.__iter__()

    def __getitem__(self, item):
        return self.fields.__getitem__(item)

    def __repr__(self):
        if not self.fields:
            return 'FieldSet (empty)'
        angular = self.fields[0].kind == 'angle'
        tail_col = 'unit' if angular else f'{"object_z":>10s}'
        body = [f'  {"#":>3s}  {"hx":>10s}  {"hy":>10s}  {tail_col}']
        for i, f in enumerate(self.fields):
            tail = f.unit if angular else f'{f.object_z:>10.4g}'
            body.append(f'  {i:>3d}  {f.hx:>10.4g}  {f.hy:>10.4g}  {tail}')
        return '\n'.join(['FieldSet'] + body)


# ---------------------------------------------------------------------------
# Metadata normalizers
# ---------------------------------------------------------------------------

def _as_field(field):
    """A literal field spec (Field or (hx, hy) pair) as a Field."""
    if isinstance(field, Field):
        return field
    if isinstance(field, _Num):
        raise TypeError(  # a bare number is ambiguous: index or height?
            f'{field!r} is a bare scalar; a literal field is a Field or '
            'an (hx, hy) pair (an int indexes the FieldSet instead)')
    hx, hy = field
    return Field(float(hx), float(hy))


def _as_field_list(fields):
    """Field metadata as a plain list (bare numbers mean y-field)."""
    if fields is None:
        return []
    if isinstance(fields, FieldSet) is True:
        return [*fields.fields]
    return [Field(0.0, float(f)) if isinstance(f, _Num)
            else _as_field(f) for f in fields]


def _as_wavelength_array(wavelengths):
    """Wavelength metadata as a finite positive 1-D micron array."""
    if wavelengths is None:
        return np.zeros(0, dtype=np.float64)
    if hasattr(wavelengths, 'keys') is True:
        raise TypeError(
            'wavelengths want a sequence of micron floats, not a mapping; '
            'e.g. pass list(FRAUNHOFER_LINES_UM.values()) and pick the '
            'reference with an integer index')
    out = np.asarray([float(w) for w in wavelengths], dtype=np.float64)
    bad = len(out) and (not bool(np.all(np.isfinite(out)))
                        or bool(np.any(out <= 0.0)))
    if bad:
        raise ValueError('every wavelength must be positive and finite')
    return out


def _as_weight_array(weights, wavelengths):
    """Spectral weights parallel to wavelengths (default: all ones)."""
    n = int(len(wavelengths))
    if weights is None:
        return np.ones(n, dtype=np.float64)
    out = np.asarray([float(w) for w in weights], dtype=np.float64)
    if len(out) != n:
        raise ValueError(
            f'weights length {len(out)} does not match the {n} '
            'wavelengths')
    if len(out):
        if not bool(np.all(np.isfinite(out))) or bool(np.any(out < 0.0)):
            raise ValueError('every weight must be finite and nonnegative')
        if not bool(np.any(out > 0.0)):
            raise ValueError('some wavelength weight must be positive')
    return out


def _checked_reference(reference, n_wavelengths):
    if reference is None:
        return 0
    if not isinstance(reference, _Int):
        raise TypeError('reference wants an integer index or None')
    ref = int(reference)
    if ref < 0 or (n_wavelengths and ref >= n_wavelengths):
        raise IndexError('the reference wavelength index is out of range')
    if n_wavelengths == 0 and ref != 0:
        raise IndexError('with no wavelengths, only reference=0 is legal')
    return ref


def _checked_stop_index(stop_index, lens):
    if stop_index is None:
        return None
    if not isinstance(stop_index, _Int):
        raise TypeError('stop_index wants an integer or None')
    idx = int(stop_index)
    if idx < 0 or idx >= len(lens.to_surfaces()):
        raise IndexError('stop_index falls outside the surface list')
    return idx


def _checked_aiming(ray_aiming):
    mode = str(ray_aiming).lower()
    if mode not in ('paraxial', 'real'):
        raise ValueError(
            f"{ray_aiming!r} is not a ray-aiming mode; use 'paraxial' or "
            "'real'")
    return mode


# cache-key snapshot helpers ------------------------------------------------

def _vec_key(value):
    if value is None:
        return value
    return tuple(np.asarray(to_host(value), dtype=np.float64).ravel().tolist())


def _fkey(field):
    if field is None:
        return field
    vig = getattr(field, 'vignetting', None)
    vig = None if vig is None else tuple(
        (k, float(v)) for k, v in sorted(vig.items()))
    return tuple(getattr(field, a, None)
                 for a in ('hx', 'hy', 'kind', 'unit', 'object_z')) + (vig,)


def _apkey(aperture):
    if aperture is None:
        return aperture
    return aperture.mode, float(aperture.value)


# ---------------------------------------------------------------------------
# OpticalSystem
# ---------------------------------------------------------------------------

class OpticalSystem:
    """System metadata around a LensData surface spine.

    Owns exactly one lens (enforced), carries aperture / fields /
    wavelengths / stop metadata, exposes the verb namespaces (.opt /
    .solve / .plot / .analysis / .tol), and memoizes derived paraxial
    quantities keyed to the lens edit version.
    """

    __slots__ = ('_lens', 'aperture', 'fields', 'wavelengths',
                 'weights', 'reference', 'title', 'stop_index', 'ray_aiming',
                 'source_path', 'source_format', 'extras', '_design',
                 '_paraxial_cache', '_grid_cache',
                 '_cache_gen', '__weakref__')

    def __init__(self, lens, *, aperture=None, fields=None,
                 wavelengths=None, weights=None, reference=None, title=None,
                 stop_index=None, ray_aiming='paraxial',
                 source_path=None, source_format=None, extras=None):
        if isinstance(lens, LensData) is False:
            raise TypeError('OpticalSystem wraps a LensData instance')
        if lens.system_owner is not None:  # exclusivity is load-bearing
            raise ValueError(
                'this lens already backs an OpticalSystem; .copy() it to '
                'build a second system')
        self._lens = lens
        del lens  # everything below goes through self._lens
        if aperture is not None:
            if not isinstance(aperture, ApertureSpec):
                aperture = ApertureSpec.epd(aperture)  # bare number = EPD
        self.aperture = aperture
        self.fields = (fields if isinstance(fields, FieldSet)
                       else FieldSet(fields))
        self.wavelengths = _as_wavelength_array(wavelengths)
        self.weights = _as_weight_array(weights, self.wavelengths)
        if len(self.wavelengths) and self.wavelengths.max() >= 200.0:
            warnings.warn(
                f'wavelengths are micrometers; '
                f'{float(self.wavelengths.max()):g} looks like nanometers',
                stacklevel=2)
        self.reference = _checked_reference(reference, len(self.wavelengths))
        self.title, self.ray_aiming = title, _checked_aiming(ray_aiming)
        self.stop_index = _checked_stop_index(stop_index, self._lens)
        self.source_path, self.source_format = source_path, source_format
        self.extras = {} if not extras else dict(extras)
        self._lens._attach_system(self)
        self._design = DesignState(self._lens)
        self._paraxial_cache = StateCache()  # version-keyed derived scalars
        self._grid_cache = StateCache()      # analysis grids for plot verbs
        self._cache_gen = self._lens._version

    # -- lens delegation --
    @property
    def lens(self):
        """The exclusively attached LensData spine."""
        return self._lens

    def to_surfaces(self):
        """Posed surfaces compiled by the underlying lens."""
        return self._lens.to_surfaces()

    @property
    def surfaces(self):
        """Posed surfaces compiled by the underlying lens."""
        return self._lens.surfaces

    @property
    def rows(self):
        """The underlying lens's editable rows."""
        return self._lens.rows

    def __len__(self):
        return self._lens.__len__()

    def __iter__(self):
        return self._lens.__iter__()

    def __getitem__(self, item):
        return self._lens.__getitem__(item)

    def trace(self, P, S, wavelength=None, **kwargs):
        """Trace a fixed launch bundle through this system's surfaces."""
        from .spencer_and_murty import raytrace as kernel
        return kernel(self.to_surfaces(), P, S,
                      self.wavelength(wavelength), **kwargs)

    # -- verb namespaces --
    def _verb(self, ns_cls):
        return ns_cls(self)

    @property
    def opt(self):
        """Design + optimization verbs."""
        return self._verb(_OptNamespace)

    @property
    def solve(self):
        """State-writing solve verbs."""
        return self._verb(_SolveNamespace)

    @property
    def plot(self):
        """Plotting verbs."""
        return self._verb(_PlotNamespace)

    @property
    def analysis(self):
        """Analysis verbs."""
        return self._verb(_AnalysisNamespace)

    @property
    def tol(self):
        """Tolerancing verbs."""
        return self._verb(_TolNamespace)

    # -- metadata resolvers --
    @property
    def reference_wavelength(self):
        """The reference wavelength in microns, or None."""
        if len(self.wavelengths):
            return float(self.wavelengths[self.reference])
        return None

    def wavelength(self, wavelength=None):
        """Resolve a wavelength to microns; None selects the reference."""
        if wavelength is not None:
            return float(wavelength)
        ref = self.reference_wavelength
        if ref is not None:
            return ref
        return 0.6328  # HeNe default when the system has no spectrum

    def field(self, field=None):
        """Resolve a field selector (None / index / (hx, hy) / Field)."""
        if field is None:
            return self.fields[0] if self.fields else Field(0.0, 0.0)
        if isinstance(field, _Int):
            return self.fields[field]
        return _as_field(field)

    @property
    def object_at_infinity(self):
        """True when the OBJECT endpoint is at infinity."""
        rows = self._lens.rows
        if len(rows) == 0:
            return True
        from .surfaces import _map_stype as _code_of
        lead = rows[0]
        typ = getattr(lead, 'typ', None)
        # a leading eval row is treated like OBJECT for raw decks
        if typ is None or _is_meas(_code_of(typ)) is False:
            return True
        gap = float(getattr(lead, 'thickness', float('inf')))
        return not np.isfinite(gap)

    # -- derived-quantity memoization --
    def _memo(self, key, thunk):
        """Version-synced compute-on-miss for derived scalars."""
        self._refresh_generation()  # caches never serve stale generations
        return self._paraxial_cache.get_or_compute(key, thunk)

    def _refresh_generation(self):
        """Drop prior-generation values before serving a live cache."""
        live = self.lens._version
        if live != self._cache_gen:
            self._paraxial_cache.clear()
            self._grid_cache.clear()
            self._cache_gen = live

    def reset_raytrace_cache(self):
        """Drop cached values without rewinding the lens generation."""
        self._paraxial_cache.clear()
        self._grid_cache.clear()
        self.lens._surfaces_cache = None
        self._cache_gen = self.lens._version
        return self

    # reference-parity aliases for the internal cache dictionaries
    @property
    def _derived(self):
        """Derived paraxial/pupil value cache (reference spelling)."""
        return self._paraxial_cache

    @property
    def _trace_cache(self):
        """Traced-grid cache (reference spelling)."""
        return self._grid_cache

    @property
    def epd(self):
        """Equivalent entrance-pupil diameter, or None (no aperture)."""
        return self.entrance_pupil_diameter()

    def entrance_pupil_diameter(self, wvl=None):
        """Equivalent entrance-pupil diameter at wvl, cached."""
        if self.aperture is None:
            self._refresh_generation()
            return None
        wvl_um = self.wavelength(wvl)
        return self._memo(
            ('epd', self.lens._version, float(wvl_um),
             self.aperture.mode, self.aperture.value),
            lambda: float(
                self.aperture.entrance_pupil_diameter(self, wvl_um)))

    def _stop_or_default(self, stop_index):
        return stop_index if stop_index is not None else self.stop_index

    def first_order(self, field=0, wavelength=None, *,
                    epd=None, stop_index=None, force_sym=False):
        """Parabasal first-order properties about a chief ray, cached."""
        from .parabasal import _resolve_field, first_order
        wvl = self.wavelength(wavelength)  # key on the resolved micron value
        stop = self._stop_or_default(stop_index)
        return self._memo(
            ('fo', self.lens._version,
             _fkey(_resolve_field(self, field)), float(wvl), epd,
             stop, bool(force_sym)),
            lambda: first_order(self, field=field, wavelength=wvl, epd=epd,
                                stop_index=stop_index, force_sym=force_sym))

    def _ynu_first_order(self, wvl=None, *, epd=None,
                         stop_index=None):
        """Internal YNU first-order properties, cached."""
        from .paraxial import ynu_first_order as ynu
        wvl = self.wavelength(wvl)  # resolved before keying
        stop = self._stop_or_default(stop_index)
        if epd is None:
            epd = self.entrance_pupil_diameter(wvl)
        else:
            epd = float(epd)
        surf_list = self.to_surfaces()
        return self._memo(
            ('ynu_fo', self.lens._version, float(wvl), epd, stop),
            lambda: ynu(surf_list, wvl=wvl, epd=epd, stop_index=stop))

    def entrance_pupil_z(self, wvl=None, stop_index=None):
        """Lab-frame z of the paraxial entrance pupil, cached."""
        wvl = self.wavelength(wvl)  # resolved before keying
        stop = self._stop_or_default(stop_index)
        surf_list = self.to_surfaces()
        return self._memo(
            ('ep_z', self.lens._version, float(wvl), stop),
            lambda: _paraxial_ep_z(surf_list, wvl, stop_index=stop))

    def exit_pupil(self, wvl=None, field=None, *, stop_index=None,
                   epd=None, axis_point=None, axis_dir=None):
        """Resolved exit-pupil reference point P_xp, cached."""
        from .analysis import resolve_exit_pupil
        wvl = self.wavelength(wvl)  # resolved before keying
        stop = self._stop_or_default(stop_index)
        return self._memo(
            ('exit_pupil', self.lens._version, float(wvl),
             _fkey(field), stop, None if epd is None else float(epd),
             _vec_key(axis_point), _vec_key(axis_dir),
             _apkey(self.aperture), self.ray_aiming),
            lambda: resolve_exit_pupil(
                self, wvl, stop_index=stop, epd=epd, field=field,
                axis_point=axis_point,
                axis_dir=axis_dir))

    # -- grid caching for plot verbs --
    def _fingerprint(self):
        """Hashable snapshot of metadata that drives a grid trace."""
        return (self.lens._version, _apkey(self.aperture),
                tuple(_fkey(f) for f in self.fields),
                tuple(self.wavelengths.tolist()),
                tuple(self.weights.tolist()),
                self.reference, self.stop_index,
                self.ray_aiming)

    def _cached_grid(self, kind, fn, kwargs):
        """fn(self, **kwargs), memoized on the live fingerprint."""
        self.lens.to_surfaces()  # settle lazy deps before fingerprinting
        self._refresh_generation()
        tag = (self._fingerprint(), kind, structural_key(kwargs))
        return self._grid_cache.get_or_compute(
            tag, lambda: fn(self, **kwargs))

    # -- listings --
    def list_surfaces(self, *, unit='mm'):
        """Tabular lens-data-editor listing."""
        return self._lens.list_surfaces(stop_index=self.stop_index,
                                        unit=unit)

    def list_apertures(self):
        """Per-surface clear-aperture listing."""
        return self._lens.list_apertures()

    def list_decenters(self):
        """Coordinate-break decenter / tilt listing."""
        return self._lens.list_decenters()

    def copy(self):
        """A copy: lens, design state, and metadata containers cloned."""
        twin = OpticalSystem(
            self._lens.copy(), aperture=deepcopy(self.aperture),
            fields=deepcopy([*self.fields]),
            wavelengths=self.wavelengths.copy(),
            weights=self.weights.copy(),
            reference=self.reference, title=self.title,
            stop_index=self.stop_index, ray_aiming=self.ray_aiming,
            source_path=self.source_path,
            source_format=self.source_format,
            extras=deepcopy(self.extras))
        # carry the DOF registry, pickups, and solves onto the cloned lens;
        # construction may already have compiled the twin (stop-index
        # validation) with an empty registry, so drop that cache or the
        # next to_surfaces() would skip dependency resolution entirely
        twin._design = self._design.copy(twin.lens)
        twin.lens._invalidate()
        return twin

    def __repr__(self):
        ap = repr(self.aperture) if self.aperture is not None else 'None'
        return ('OpticalSystem('
                f'rows={len(self.lens.rows)}, aperture={ap}, '
                f'fields={len(self.fields)}, '
                f'wavelengths={len(self.wavelengths)}, '
                f'stop_index={self.stop_index}'
                ')')


# late import: launch itself imports from this module at load time
from .launch import Field  # noqa: E402  (cycle-breaking tail import)


__all__ = ['ApertureSpec', 'FieldSet', 'OpticalSystem', 'EPD',
           'FNO_IMAGE', 'FNO_OBJECT', 'NA_IMAGE', 'NA_OBJECT']
