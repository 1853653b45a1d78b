"""Sample-table materials: n(wvl) and n(wvl, T) lookup with interpolation.

Counterpart of ``prysm_tpu/x/materials/tabulated.py``.  Design: interpolation
is compiled once at construction into closures (``_make_interpolator``),
selected from a registry of interpolator factories; queries just call the
prepared closure.  The temperature grid uses one shared bracketing helper
(:func:`_segment_weights`) for both axes of the separable bilinear lookup.
"""
import warnings

import numpy as np
from scipy import interpolate as _scipy_interp

from .core import BaseMaterial, MaterialRangeError, MissingKError


def _out_of_range(name, lo, hi):
    raise MaterialRangeError(
        f'wavelength for {name} outside material range {lo:g} to {hi:g} um')


class MaterialData:
    """Validated wavelength, n, optional k / uncertainty samples."""

    def __init__(self, wavelengths, n, *, k=None, sigma_n=None, metadata=None):
        self.wavelengths = wavelengths.copy()
        self.n = n.copy()
        self.k = None if k is None else k.copy()
        self.sigma_n = None if sigma_n is None else sigma_n.copy()
        self.metadata = dict(metadata or {})

    @property
    def wavelength_range(self):
        """Sample range in microns."""
        return float(self.wavelengths[0]), float(self.wavelengths[-1])


def _query_dtype(query):
    """The query's own float dtype, else the working precision."""
    dtype = getattr(query, 'dtype', None)
    if dtype is not None and np.issubdtype(dtype, np.floating):
        return dtype
    from ...conf import numpy_dtype
    return numpy_dtype()


def _cast_like(values, query):
    dtype = _query_dtype(query)
    if hasattr(values, 'astype'):
        return values.astype(dtype, copy=False)
    return dtype.type(values)


def _segment_weights(knots, queries, allow_outside):
    """Bracket queries in a sorted knot vector.

    Returns (lo index, hi index, fraction).  Fractions are clamped to [0, 1]
    unless ``allow_outside``, in which case the edge segments extend.
    """
    if knots.shape[0] == 1:
        zero = np.zeros_like(np.asarray(queries, dtype=float))
        return 0, 0, zero
    hi = np.clip(np.searchsorted(knots, queries, side='right'), 1,
                 knots.shape[0] - 1)
    lo = hi - 1
    t = (queries - knots[lo]) / (knots[hi] - knots[lo])
    if not allow_outside:
        t = np.clip(t, 0.0, 1.0)
    return lo, hi, t


# -- interpolator factories: (knots, values, allow_outside) -> f(query) ------


def _build_linear(knots, values, allow_outside):
    def run(q):
        lo, hi, t = _segment_weights(knots, q, allow_outside)
        return _cast_like(values[lo] + (values[hi] - values[lo]) * t, q)
    return run


def _build_nearest(knots, values, allow_outside):
    def run(q):
        left = np.clip(np.searchsorted(knots, q, side='left'), 0,
                       knots.size - 1)
        prior = np.clip(left - 1, 0, knots.size - 1)
        take_prior = np.abs(q - knots[prior]) <= np.abs(q - knots[left])
        return values[np.where(take_prior, prior, left)]
    return run


def _build_log(knots, values, allow_outside):
    if np.any(values <= 0):
        raise ValueError('log interpolation requires positive samples')
    inner = _build_linear(knots, np.log(values), allow_outside)
    return lambda q: np.exp(inner(q))


def _build_pchip(knots, values, allow_outside):
    spline = _scipy_interp.PchipInterpolator(knots, values,
                                             extrapolate=allow_outside)
    return lambda q: _cast_like(spline(q), q)


_INTERPOLATORS = {
    'linear': _build_linear,
    'nearest': _build_nearest,
    'log': _build_log,
    'pchip': _build_pchip,
}


def _make_interpolator(method, knots, values, allow_outside):
    factory = _INTERPOLATORS.get(str(method).lower())
    if factory is None:
        raise ValueError(
            "interpolation method must be 'linear', 'nearest', 'pchip', or 'log'")
    return factory(knots, values, allow_outside)


def _valid_method(method):
    key = str(method).lower()
    if key not in _INTERPOLATORS:
        raise ValueError(
            "interpolation method must be 'linear', 'nearest', 'pchip', or 'log'")
    return key


# -- validation --------------------------------------------------------------


def _require(cond, message):
    if not cond:
        raise ValueError(message)


def _check_axis(axis, label):
    _require(np.all(np.isfinite(axis)), f'{label} must contain only finite values')
    _require(not np.any(axis <= 0), f'{label} must be positive')
    if axis.size > 1:
        _require(np.all(np.diff(axis) > 0),
                 f'{label} must be strictly increasing with no duplicates')


def _check_table(wavelengths, n, extras):
    _require(wavelengths.ndim == 1, 'wavelengths must be a 1D array')
    _require(wavelengths.size > 0, 'wavelengths must contain at least one value')
    _check_axis(wavelengths, 'wavelengths')
    _require(n.shape == wavelengths.shape, 'n samples must match wavelengths')
    _require(np.all(np.isfinite(n)), 'n samples must contain only finite values')
    for label, column in extras.items():
        if column is None:
            continue
        _require(column.shape == wavelengths.shape,
                 f'{label} samples must match wavelengths')
        _require(np.all(np.isfinite(column)),
                 f'{label} samples must contain only finite values')
    k = extras.get('k')
    if k is not None:
        _require(not np.any(k < 0), 'k must be nonnegative')


def _working_precision():
    from ...conf import numpy_dtype
    return numpy_dtype()


def _optional_f64(value):
    return (None if value is None
            else np.array(value, dtype=_working_precision()))


class TabulatedMaterial(BaseMaterial):
    """Material with tabulated n(wvl) and optional k(wvl)."""

    def __init__(self, name, wavelengths, n, *, k=None,
                 interpolation='linear', n_interpolation=None,
                 k_interpolation=None, sigma_n=None, sigma_k=None,
                 extrapolate=False, method=None, k_zero_policy='raise',
                 **kwargs):
        missing_k = kwargs.pop('missing_k', 'zero' if k is None else 'raise')
        wavelengths = np.array(wavelengths, dtype=_working_precision())
        n = np.array(n, dtype=_working_precision())
        k = _optional_f64(k)
        sigma_n = _optional_f64(sigma_n)
        sigma_k = _optional_f64(sigma_k)
        _check_table(wavelengths, n,
                     {'k': k, 'sigma_n': sigma_n, 'sigma_k': sigma_k})
        if method is not None:
            interpolation = method
        if wavelengths.size < 2 and interpolation != 'nearest':
            raise ValueError('at least two samples are required for interpolation')
        n_method = _valid_method(n_interpolation or interpolation)
        k_method = _valid_method(k_interpolation or interpolation)
        if k_zero_policy not in ('raise', 'linear'):
            raise ValueError("k_zero_policy must be 'raise' or 'linear'")
        if k_method == 'log' and k is not None and np.any(k == 0):
            if k_zero_policy == 'raise':
                raise ValueError(
                    "log interpolation for k requires positive k samples; set "
                    "k_zero_policy='linear' to handle zeros explicitly")
            k_method = 'linear'

        metadata = dict(kwargs.pop('metadata', {}) or {})
        if extrapolate:
            metadata['extrapolate_wavelength'] = True
        metadata.update(method=n_method, extrapolate=bool(extrapolate),
                        missing_k=missing_k, k_zero_policy=k_zero_policy)
        wavelength_range = kwargs.pop(
            'wavelength_range', (float(wavelengths[0]), float(wavelengths[-1])))
        super().__init__(name, wavelength_range=wavelength_range,
                         metadata=metadata, missing_k=missing_k, **kwargs)
        self.wavelengths, self.n_samples, self.k_samples = wavelengths, n, k
        self.sigma_n, self.sigma_k = sigma_n, sigma_k
        self.n_interpolation = self.method = n_method
        self.k_interpolation, self.k_zero_policy = k_method, k_zero_policy
        self.extrapolate = bool(extrapolate)
        self.data = MaterialData(wavelengths, n, k=k, sigma_n=sigma_n,
                                 metadata=metadata)
        self.fit_report = None
        # compile the lookups once
        self._n_of = _make_interpolator(n_method, wavelengths, n, self.extrapolate)
        self._k_of = (None if k is None else
                      _make_interpolator(k_method, wavelengths, k, self.extrapolate))

    def _check_wavelength(self, wvl):
        if self.metadata.get('extrapolate_wavelength'):
            return
        lo, hi = self.wavelength_range
        if np.any(np.less(wvl, lo) | np.greater(wvl, hi)):
            _out_of_range(self.name, lo, hi)

    def _guard(self, wvl, temperature):
        self._check_wavelength(wvl)
        self._check_temperature(temperature)

    def n(self, wvl_um, temperature=None):
        """Interpolated real index."""
        self._guard(wvl_um, temperature)
        return self._n_of(wvl_um)

    def k(self, wvl_um, temperature=None):
        """Interpolated extinction coefficient."""
        self._guard(wvl_um, temperature)
        if self._k_of is None:
            if self.missing_k == 'raise':
                raise MissingKError(f'no k samples on material {self.name}')
            return self._missing_k(wvl_um)
        return self._k_of(wvl_um)


# -- wavelength x temperature grids ------------------------------------------


def _orient_grid(grid, n_temps, n_wvls, label, layout):
    """Coerce a 2D sample grid into (temperature, wavelength) layout."""
    if grid is None:
        return None
    arr = np.array(grid, dtype=_working_precision())
    if n_temps == n_wvls and arr.shape == (n_temps, n_wvls):
        # square: ambiguous; honor the explicit layout, default (T, w)
        return arr.T if layout == ('wavelength', 'temperature') else arr
    if arr.shape == (n_temps, n_wvls):
        return arr
    if arr.shape == (n_wvls, n_temps):
        return arr.T
    raise ValueError(f'{label} grid must have shape temperature x wavelength')


class TemperatureGridMaterial(BaseMaterial):
    """Material with n(wvl, T) sampled on a rectangular grid.

    Lookup is separable bilinear: one bracketing per axis, then a lerp of
    lerps, fully vectorized over broadcast (wvl, T) queries.
    """

    def __init__(self, name, wavelengths, temperatures, n, *, k=None,
                 dn_dlambda=None, dn_dT=None, sigma_n=None,
                 extrapolate=False, layout=None, **kwargs):
        missing_k = kwargs.pop('missing_k', 'zero' if k is None else 'raise')
        wavelengths = np.array(wavelengths, dtype=_working_precision())
        temperatures = np.array(temperatures, dtype=_working_precision())
        _require(wavelengths.ndim == 1, 'wavelengths must be a 1D array')
        _require(temperatures.ndim == 1, 'temperatures must be a 1D array')
        w_sort = np.argsort(wavelengths)
        t_sort = np.argsort(temperatures)
        wavelengths = wavelengths[w_sort]
        temperatures = temperatures[t_sort]
        _check_axis(wavelengths, 'wavelengths')
        _check_axis(temperatures, 'temperatures')
        if layout is None and wavelengths.size == temperatures.size:
            warnings.warn(
                f'{name} grid is square; assuming (temperature, wavelength) '
                "layout. Pass layout=('temperature', 'wavelength') or "
                "('wavelength', 'temperature') to disambiguate.",
                stacklevel=2)

        def prepared(g, label):
            g = _orient_grid(g, temperatures.size, wavelengths.size, label, layout)
            return None if g is None else g[t_sort][:, w_sort]

        metadata = dict(kwargs.pop('metadata', {}) or {})
        if extrapolate:
            metadata['extrapolate_wavelength'] = True
            metadata['extrapolate_temperature'] = True
        wavelength_range = kwargs.pop(
            'wavelength_range', (float(wavelengths[0]), float(wavelengths[-1])))
        temperature_range = kwargs.pop(
            'temperature_range', (float(temperatures[0]), float(temperatures[-1])))
        super().__init__(name, wavelength_range=wavelength_range,
                         temperature_range=temperature_range,
                         metadata=metadata, missing_k=missing_k, **kwargs)
        self.wavelengths, self.temperatures = wavelengths, temperatures
        self.n_grid = prepared(n, 'n')
        self.k_grid = prepared(k, 'k')
        self.dn_dlambda_grid = prepared(dn_dlambda, 'dn_dlambda')
        self.dn_dT_grid = prepared(dn_dT, 'dn_dT')
        self.sigma_n = prepared(sigma_n, 'sigma_n')
        self.extrapolate = bool(extrapolate)

    def _lookup(self, grid, wvl, temp):
        wvl_b, temp_b = np.broadcast_arrays(wvl, temp)
        w = wvl_b.reshape(-1)
        t = temp_b.reshape(-1)
        wl_lo, wl_hi, wf = _segment_weights(self.wavelengths, w, self.extrapolate)
        t_lo, t_hi, tf = _segment_weights(self.temperatures, t, self.extrapolate)
        cold = grid[t_lo, wl_lo] * (1 - wf) + grid[t_lo, wl_hi] * wf
        warm = grid[t_hi, wl_lo] * (1 - wf) + grid[t_hi, wl_hi] * wf
        out = cold * (1 - tf) + warm * tf
        if hasattr(out, 'astype'):
            out = out.astype(grid.dtype, copy=False)
        return out.reshape(wvl_b.shape)

    def _guarded_temp(self, wvl, temperature):
        """Default a missing temperature, then run both range checks."""
        if temperature is None:
            if self.temperatures.size != 1:
                raise ValueError(f'temperature is required for {self.name}')
            temperature = self.temperatures[0]
        self._check_wavelength(wvl)
        self._check_temperature(temperature)
        return temperature

    def n(self, wvl_um, temperature=None):
        """Bilinear n(wvl, T)."""
        temp = self._guarded_temp(wvl_um, temperature)
        return self._lookup(self.n_grid, wvl_um, temp)

    def k(self, wvl_um, temperature=None):
        """Bilinear k(wvl, T), or the missing-k policy."""
        temp = self._guarded_temp(wvl_um, temperature)
        if self.k_grid is None:
            if self.missing_k == 'raise':
                raise MissingKError(f'no k grid on material {self.name}')
            wvl_b, temp_b = np.broadcast_arrays(wvl_um, temp)
            return np.zeros(wvl_b.shape, dtype=self.n_grid.dtype) + temp_b * 0
        return self._lookup(self.k_grid, wvl_um, temp)

    def dn_dlambda(self, wvl_um, temperature=None):
        """Measured dn/dwvl if gridded, else finite differences."""
        if self.dn_dlambda_grid is None:
            return super().dn_dlambda(wvl_um, temperature=temperature)
        temp = self._guarded_temp(wvl_um, temperature)
        return self._lookup(self.dn_dlambda_grid, wvl_um, temp)

    def dn_dT(self, wvl_um, temperature):
        """Measured dn/dT if gridded, else finite differences."""
        if self.dn_dT_grid is None:
            return super().dn_dT(wvl_um, temperature)
        self._guarded_temp(wvl_um, temperature)
        return self._lookup(self.dn_dT_grid, wvl_um, temperature)
