"""Opt-in material transforms for process and environment effects.

Counterpart of ``prysm_tpu/x/materials/transforms.py``, the transform
layer.  A transform wraps a parent
material and perturbs its index; here every correction spec is coerced
once into a canonical ``term(wvl, T)`` callable by :func:`_as_term`, and
the wrapper classes are thin layers over those terms plus the
field-table inheritance in :class:`MaterialTransform`.
"""
import inspect

from .core import BaseMaterial, _PROVENANCE_FIELDS


def _as_term(spec):
    """Coerce a correction spec into a canonical (wvl_um, T) callable.

    A material-like object contributes through its n; a non-callable is
    a constant; a plain callable is adapted to whichever of the accepted
    calling conventions its signature admits.  The convention is picked
    once here so a TypeError raised *inside* a correction later is never
    mistaken for an arity mismatch.
    """
    n_method = getattr(spec, 'n', None)
    if callable(n_method):
        return lambda wvl, T: n_method(wvl, temperature=T)
    if not callable(spec):
        return lambda wvl, T: spec
    convention = _calling_convention(spec)
    return _TERM_ADAPTERS[convention](spec)


def _calling_convention(func):
    """Classify func as 'positional', 'keyword', 'bare', or 'probe'."""
    try:
        sig = inspect.signature(func)
    except (TypeError, ValueError):
        return 'probe'
    for attempt, convention in (
            (lambda: sig.bind(0.0, None), 'positional'),
            (lambda: sig.bind(0.0, temperature=None), 'keyword')):
        try:
            attempt()
        except TypeError:
            continue
        return convention
    return 'bare'


def _probe_adapter(func):
    def call(wvl, T):
        try:
            return func(wvl, T)
        except TypeError:
            return func(wvl)
    return call


_TERM_ADAPTERS = {
    'positional': lambda f: lambda wvl, T: f(wvl, T),
    'keyword': lambda f: lambda wvl, T: f(wvl, temperature=T),
    'bare': lambda f: lambda wvl, T: f(wvl),
    'probe': _probe_adapter,
}


def _lineage_metadata(parent, extra):
    """Parent metadata merged with extra, plus a provenance chain entry."""
    merged = dict(getattr(parent, 'metadata', None) or {})
    merged.update(extra or {})
    entry = {key: getattr(parent, key, None)
             for key in ('name', 'catalog', 'variant')}
    merged['parent_chain'] = (*merged.get('parent_chain', ()), entry)
    return merged


class MaterialTransform(BaseMaterial):
    """Base wrapper preserving material provenance.

    Provenance fields not overridden by the caller are inherited from
    the parent via the shared field table.
    """

    def __init__(self, parent, *, name=None, metadata=None, **kwargs):
        self.parent = parent
        inherited = {field: kwargs.pop(field, getattr(parent, field, None))
                     for field in _PROVENANCE_FIELDS}
        policy = kwargs.pop('missing_k', getattr(parent, 'missing_k', 'zero'))
        super().__init__(
            name or getattr(parent, 'name', type(parent).__name__),
            metadata=_lineage_metadata(parent, metadata),
            missing_k=policy,
            **inherited,
            **kwargs,
        )

    def _parent_n(self, wvl_um, temperature):
        return self.parent.n(wvl_um, temperature=temperature)

    def k(self, wvl_um, temperature=None):
        """Delegate extinction to the parent."""
        if hasattr(self.parent, 'k'):
            return self.parent.k(wvl_um, temperature=temperature)
        return super().k(wvl_um, temperature=temperature)


class TemperatureShiftedMaterial(MaterialTransform):
    """Explicit dn/dT correction away from a reference temperature."""

    def __init__(self, parent, dn_dT, reference_temperature, **kwargs):
        super().__init__(parent, **kwargs)
        self.dn_dT_model = dn_dT
        self.reference_temperature = reference_temperature
        self._slope_term = _as_term(dn_dT)

    def n(self, wvl_um, temperature=None):
        """Parent n at the reference point, shifted by slope * delta-T."""
        T = self.reference_temperature if temperature is None else temperature
        self._check_temperature(T)
        delta = T - self.reference_temperature
        anchor = self._parent_n(wvl_um, self.reference_temperature)
        return anchor + self._slope_term(wvl_um, T) * delta


class IsothermalMaterial(MaterialTransform):
    """Bind a temperature-dependent material to a fixed temperature.

    Lets a model that demands a temperature answer the bare n(wvl)
    query a ray trace makes; an explicit temperature still overrides.
    """

    def __init__(self, parent, temperature, **kwargs):
        super().__init__(parent, **kwargs)
        self.temperature = temperature

    def _bound_T(self, temperature):
        return self.temperature if temperature is None else temperature

    def n(self, wvl_um, temperature=None):
        """Parent n at the bound (or overridden) temperature."""
        return self._parent_n(wvl_um, self._bound_T(temperature))

    def k(self, wvl_um, temperature=None):
        """Parent k at the bound (or overridden) temperature."""
        return self.parent.k(wvl_um, temperature=self._bound_T(temperature))


class IndexOffsetMaterial(MaterialTransform):
    """Additive offset to n and optionally k."""

    def __init__(self, parent, offset, *, k_offset=None, **kwargs):
        super().__init__(parent, **kwargs)
        self.offset = offset
        self.k_offset = k_offset
        self._n_term = _as_term(offset)
        self._k_term = None if k_offset is None else _as_term(k_offset)

    def n(self, wvl_um, temperature=None):
        """Parent n plus offset."""
        shift = self._n_term(wvl_um, temperature)
        return self._parent_n(wvl_um, temperature) + shift

    def k(self, wvl_um, temperature=None):
        """Parent k plus optional offset."""
        base = super().k(wvl_um, temperature=temperature)
        if self._k_term is None:
            return base
        return base + self._k_term(wvl_um, temperature)


class StressOpticMaterial(MaterialTransform):
    """Scalar stress-optic index correction."""

    def __init__(self, parent, coefficient, stress, **kwargs):
        super().__init__(parent, **kwargs)
        self.coefficient = coefficient
        self.stress = stress
        self._coefficient_term = _as_term(coefficient)

    def n(self, wvl_um, temperature=None):
        """Parent n plus coefficient * stress."""
        correction = self._coefficient_term(wvl_um, temperature) * self.stress
        return self._parent_n(wvl_um, temperature) + correction


class ThicknessDependentMaterial(MaterialTransform):
    """Opt-in thickness-dependent index correction (e.g. thin films)."""

    def __init__(self, parent, model, thickness, *, thickness_range=None,
                 **kwargs):
        super().__init__(parent, **kwargs)
        self.model = model
        self.thickness = thickness
        self.thickness_range = thickness_range
        if thickness_range is not None:
            lo, hi = thickness_range
            below = lo is not None and thickness < lo
            above = hi is not None and thickness > hi
            if below or above:
                raise ValueError('thickness is outside the model range')

    def _model_offset(self, wvl_um, temperature):
        if not callable(self.model):
            return self.model
        try:
            return self.model(self.thickness, wvl_um, temperature)
        except TypeError:
            return self.model(self.thickness, wvl_um)

    def n(self, wvl_um, temperature=None):
        """Parent n plus thickness-dependent correction."""
        offset = self._model_offset(wvl_um, temperature)
        return self._parent_n(wvl_um, temperature) + offset


class ProcessVariantMaterial(MaterialTransform):
    """Metadata-only process variant; optics delegate to the parent."""

    def __init__(self, parent, *, process=None, variant=None, **kwargs):
        super().__init__(parent, process=process, variant=variant, **kwargs)

    def n(self, wvl_um, temperature=None):
        """Delegate n to the parent."""
        self._check_wavelength(wvl_um)
        self._check_temperature(temperature)
        return self._parent_n(wvl_um, temperature)
