"""Material protocol, records, and the shared material base class.

Counterpart of ``prysm_tpu/x/materials/core.py``.  Wavelengths are
microns, temperatures Kelvin, and the complex index convention is
n + 1j*k.  Materials are host-side metadata objects; ``n``/``k`` evaluate
through numpy (float64) because trace and thin-film consumers sample them
at setup time, before any tensor work starts.

Architecture notes (differs from the reference's subclass-override
design): provenance fields are declared once in ``_PROVENANCE_FIELDS``
and plumbed by table, band guards live in the small ``_Band`` value
type, and concrete materials supply *evaluation channels* (``_Channel``)
rather than overriding ``n``/``k`` wholesale.
"""
import inspect

import numpy as np


class MaterialRangeError(ValueError):
    """A material was evaluated outside its valid range."""


class MissingKError(ValueError):
    """Extinction data was requested but is not available."""


def _normalize_name(name):
    """Case/punctuation-insensitive key used for all material name matching."""
    keep = (c for c in str(name).strip().upper() if c not in set('-_ '))
    return ''.join(keep)


class _Band:
    """Half-open-tolerant validity interval with a named error message.

    Wraps the (lo, hi) tuples materials carry for wavelength and
    temperature.  Either endpoint may be None (unbounded).
    """

    __slots__ = ('lo', 'hi')

    def __init__(self, pair):
        self.lo, self.hi = (None, None) if pair is None else pair

    @property
    def unbounded(self):
        return self.lo is None and self.hi is None

    def covers(self, other):
        """True if this band fully contains the other band (both closed)."""
        if self.unbounded or other is None:
            return False
        olo, ohi = other
        edges = (self.lo, self.hi, olo, ohi)
        if any(e is None for e in edges):
            return False
        return self.lo <= olo and ohi <= self.hi

    def holds(self, values):
        """True if every value lies inside the band."""
        lo = -np.inf if self.lo is None else self.lo
        hi = np.inf if self.hi is None else self.hi
        v = np.asarray(values, dtype=float)
        return bool(np.all((v >= lo) & (v <= hi)))

    def describe(self):
        """Human-readable band text for error messages."""
        if self.lo is None:
            return f'<= {self.hi:g}'
        if self.hi is None:
            return f'>= {self.lo:g}'
        return f'{self.lo:g} to {self.hi:g}'

    def demand(self, values, label, owner):
        """Raise MaterialRangeError unless all values are inside the band."""
        if self.unbounded or self.holds(values):
            return
        raise MaterialRangeError(
            f'{label} for {owner} is outside valid range {self.describe()}')


def _range_contains(outer, inner):
    """True if the (lo, hi) interval outer fully contains inner."""
    return _Band(outer).covers(inner)


def _validate_range(values, valid_range, label, name):
    """Module-level band check kept for the format-specific catalogs."""
    _Band(valid_range).demand(values, label, name)


def _accepts_temperature(func):
    """True when func can receive temperature as a keyword."""
    if func is None:
        return False
    try:
        params = inspect.signature(func).parameters
    except (TypeError, ValueError):
        return False
    kinds_ok = (inspect.Parameter.KEYWORD_ONLY,
                inspect.Parameter.POSITIONAL_OR_KEYWORD)
    return any(
        p.kind is inspect.Parameter.VAR_KEYWORD
        or (p.name == 'temperature' and p.kind in kinds_ok)
        for p in params.values()
    )


def _fill(like, value):
    """value broadcast to the shape (and array-ness) of the query.

    A dtype-carrying query keeps its dtype; plain Python sequences land
    in the working precision (config.precision), matching the reference
    so float32 pipelines are not silently upcast.
    """
    if np.isscalar(like):
        return like * 0 + value
    if hasattr(like, 'shape'):
        return np.zeros_like(like) + value
    from ...conf import numpy_dtype
    return np.full(np.shape(like), value, dtype=numpy_dtype())


class _Channel:
    """One evaluation channel (n or k): a formula plus calling convention.

    Decouples "how do I call this user function" from the material
    classes.  The convention is resolved once at construction.
    """

    __slots__ = ('formula', 'coefficients', 'wants_temperature')

    def __init__(self, formula, coefficients=()):
        self.formula = formula
        self.coefficients = tuple(coefficients)
        self.wants_temperature = _accepts_temperature(formula)

    def __call__(self, wvl_um, temperature):
        if temperature is not None and self.wants_temperature:
            return self.formula(wvl_um, *self.coefficients,
                                temperature=temperature)
        return self.formula(wvl_um, *self.coefficients)

    @classmethod
    def constant(cls, value):
        """Channel returning a constant, broadcast to the query shape."""
        return cls(lambda wvl: _fill(wvl, value))


def _user_page_info(material):
    """Default refractiveindex.info-shaped provenance view."""
    band = _Band(material.wavelength_range)
    label = material.catalog or 'USER'
    meta = material.metadata
    return {
        'shelf': 'user',
        'book': label,
        'page': material.name,
        'filepath': material.source or '',
        'catalog': label,
        'rangeMin': band.lo,
        'rangeMax': band.hi,
        'model': meta.get('model', meta.get('method')),
    }


class MaterialProtocol:
    """Duck-typed material interface: n / k / nk of (wvl_um, temperature)."""

    def n(self, wvl_um, temperature=None):
        """Real refractive index at wavelength in microns."""

    def k(self, wvl_um, temperature=None):
        """Extinction coefficient at wavelength in microns."""

    def nk(self, wvl_um, temperature=None):
        """Complex refractive index n + 1j*k."""

    def __call__(self, wvl_um):
        """Alias for n(wvl_um)."""


# the provenance surface shared by records and materials, declared once
_PROVENANCE_FIELDS = (
    'catalog', 'variant', 'source', 'citation', 'license',
    'wavelength_range', 'temperature_range', 'process',
)


class MaterialRecord:
    """Metadata-only catalog entry with a lazy loader."""

    __slots__ = _PROVENANCE_FIELDS + (
        'name', 'aliases', 'material_class', 'metadata', 'loader',
        'material_id',
    )

    def __init__(self, name, *, aliases=(), material_class=None,
                 metadata=None, loader=None, material_id=None, **provenance):
        self.name = name
        self.aliases = tuple(aliases or ())
        for field in _PROVENANCE_FIELDS:
            setattr(self, field, provenance.pop(field, None))
        if provenance:
            unexpected = ', '.join(sorted(provenance))
            raise TypeError(f'unexpected record fields: {unexpected}')
        self.metadata = dict(metadata or {})
        self.loader = loader
        self.material_class = (material_class
                               if material_class is not None
                               else self.metadata.get('material_class'))
        if material_id is None:
            tags = (self.catalog, name, self.variant)
            material_id = ':'.join(str(t) for t in tags if t)
        self.material_id = material_id

    def load(self):
        """Instantiate (or return) the material this record describes."""
        if self.loader is None:
            raise ValueError(f'material record {self.name!r} has no loader')
        return self.loader()

    def names_for_match(self):
        """Name, variant, and aliases used for normalized lookup."""
        head = (self.name, self.variant) if self.variant else (self.name,)
        return head + self.aliases


class BaseMaterial:
    """Shared metadata, band validation, and derived optical metrics.

    Subclasses either supply evaluation channels or implement ``n``
    (and optionally ``k``) directly; range checking is uniform via the
    ``_check_*`` guards.
    """

    def __init__(self, name, *, metadata=None, missing_k='zero', **provenance):
        if missing_k not in ('zero', 'raise'):
            raise ValueError("missing_k must be 'zero' or 'raise'")
        self.name = name
        for field in _PROVENANCE_FIELDS:
            setattr(self, field, provenance.pop(field, None))
        if provenance:
            unexpected = ', '.join(sorted(provenance))
            raise TypeError(f'unexpected material fields: {unexpected}')
        self.metadata = dict(metadata or {})
        self.missing_k = missing_k
        self._page_info_builder = _user_page_info

    def __call__(self, wvl_um):
        """Alias for n(wvl_um)."""
        return self.n(wvl_um)

    @property
    def page_info(self):
        """Provenance view derived from this material's attributes."""
        return self._page_info_builder(self)

    def _check_wavelength(self, wvl):
        if not self.metadata.get('extrapolate_wavelength'):
            _Band(self.wavelength_range).demand(wvl, 'wavelength', self.name)

    def _check_temperature(self, temperature):
        if temperature is None:
            return
        if not self.metadata.get('extrapolate_temperature'):
            _Band(self.temperature_range).demand(
                temperature, 'temperature', self.name)

    def _missing_k(self, wvl_um):
        if self.missing_k == 'raise':
            raise MissingKError(
                f'extinction data k is not available for {self.name}')
        return _fill(wvl_um, 0.0)

    def k(self, wvl_um, temperature=None):
        """Extinction coefficient, or the configured missing-k policy."""
        self._check_wavelength(wvl_um)
        self._check_temperature(temperature)
        return self._missing_k(wvl_um)

    def nk(self, wvl_um, temperature=None):
        """Complex refractive index n + 1j*k."""
        parts = (self.n(wvl_um, temperature=temperature),
                 self.k(wvl_um, temperature=temperature))
        return parts[0] + 1j * parts[1]

    def n_at(self, wvl_um, temperature=None):
        """n at one wavelength; registry-search convenience."""
        return self.n(wvl_um, temperature=temperature)

    def dispersion(self, wvl1_um, wvl2_um, temperature=None):
        """n(wvl1) - n(wvl2)."""
        n1, n2 = (self.n(w, temperature=temperature)
                  for w in (wvl1_um, wvl2_um))
        return n1 - n2

    def partial_dispersion(self, wvl1_um, wvl2_um, wvl3_um, wvl4_um,
                           temperature=None):
        """(n1 - n2) / (n3 - n4)."""
        pairs = ((wvl1_um, wvl2_um), (wvl3_um, wvl4_um))
        num, den = (self.dispersion(*p, temperature=temperature)
                    for p in pairs)
        return num / den

    def abbe(self, wvl_short_um, wvl_center_um, wvl_long_um, temperature=None):
        """Abbe-like number for arbitrary line choices."""
        center = self.n(wvl_center_um, temperature=temperature)
        spread = self.dispersion(wvl_short_um, wvl_long_um,
                                 temperature=temperature)
        return (center - 1) / spread

    def _band_derivative(self, evaluate, x, h_floor, band_pair, extrapolate):
        """Finite difference of evaluate() about x, clamped to the band.

        At a closed band edge the stencil degrades to one-sided rather
        than sampling out of range; a fully collapsed stencil returns 0.
        """
        h = np.maximum(np.abs(x) * 1e-6, h_floor)
        band = _Band(band_pair if not extrapolate else None)
        lo = -np.inf if band.lo is None else band.lo
        hi = np.inf if band.hi is None else band.hi
        upper = np.clip(np.add(x, h), lo, hi)
        lower = np.clip(np.subtract(x, h), lo, hi)
        span = upper - lower
        rise = evaluate(upper) - evaluate(lower)
        degenerate = span == 0
        return np.where(degenerate, 0.0,
                        rise / np.where(degenerate, 1.0, span))

    def dn_dlambda(self, wvl_um, temperature=None):
        """Finite-difference dn/dwvl."""
        return self._band_derivative(
            lambda w: self.n(w, temperature=temperature),
            wvl_um, 1e-6, self.wavelength_range,
            self.metadata.get('extrapolate_wavelength'))

    def dn_dT(self, wvl_um, temperature):
        """Finite-difference dn/dT."""
        return self._band_derivative(
            lambda t: self.n(wvl_um, temperature=t),
            temperature, 1e-3, self.temperature_range,
            self.metadata.get('extrapolate_temperature'))

    def provenance(self):
        """The provenance fields as a dict (record-construction helper)."""
        return {f: getattr(self, f) for f in _PROVENANCE_FIELDS}

    def record(self, *, loader=None, catalog=None):
        """Create a metadata record for this material."""
        fields = self.provenance()
        if catalog is not None:
            fields['catalog'] = catalog
        return MaterialRecord(
            name=self.name,
            aliases=tuple(self.metadata.get('aliases', ())),
            material_class=self.metadata.get('material_class',
                                             type(self).__name__),
            metadata=dict(self.metadata),
            loader=loader if loader is not None else (lambda: self),
            **fields,
        )


class ConstantMaterial(BaseMaterial):
    """Material with constant n and optional constant k."""

    def __init__(self, n, *, name=None, k=None, **kwargs):
        n = float(n)
        if not np.isfinite(n):
            raise ValueError('the constant index n must be finite')
        if k is not None:
            k = float(k)
            if not (np.isfinite(k) and k >= 0):
                raise ValueError('the constant k must be finite and >= 0')
        policy = kwargs.pop('missing_k', 'zero' if k is None else 'raise')
        super().__init__(name if name is not None else f'const_{n:g}',
                         missing_k=policy, **kwargs)
        self.n_value, self.k_value = n, k
        self.index = n
        self.extinction = k if k is not None else 0.0
        self.fit_report = None
        self._n_channel = _Channel.constant(n)
        self._k_channel = None if k is None else _Channel.constant(k)
        self.metadata.setdefault('model', 'constant')
        self.metadata.setdefault('extrapolate', True)

    def n(self, wvl_um, temperature=None):
        """Constant real index, shaped like the query."""
        self._check_wavelength(wvl_um)
        self._check_temperature(temperature)
        return self._n_channel(wvl_um, temperature)

    def k(self, wvl_um, temperature=None):
        """Constant extinction, shaped like the query."""
        self._check_wavelength(wvl_um)
        self._check_temperature(temperature)
        if self._k_channel is None:
            return self._missing_k(wvl_um)
        return self._k_channel(wvl_um, temperature)


class FormulaMaterial(BaseMaterial):
    """Material backed by a dispersion-formula callable."""

    def __init__(self, name, formula, coefficients=(), *, k_formula=None,
                 k_coefficients=(), **kwargs):
        policy = kwargs.pop('missing_k',
                            'zero' if k_formula is None else 'raise')
        super().__init__(name, missing_k=policy, **kwargs)
        self._n_channel = _Channel(formula, coefficients)
        self._k_channel = (None if k_formula is None
                           else _Channel(k_formula, k_coefficients))

    # formula/coefficients exposed as properties so the channel is the
    # single source of truth
    @property
    def formula(self):
        return self._n_channel.formula

    @property
    def coefficients(self):
        return self._n_channel.coefficients

    @property
    def k_formula(self):
        return None if self._k_channel is None else self._k_channel.formula

    @property
    def k_coefficients(self):
        return () if self._k_channel is None else self._k_channel.coefficients

    def n(self, wvl_um, temperature=None):
        """Formula-derived real index."""
        self._check_wavelength(wvl_um)
        self._check_temperature(temperature)
        return self._n_channel(wvl_um, temperature)

    def k(self, wvl_um, temperature=None):
        """Formula-derived extinction coefficient."""
        self._check_wavelength(wvl_um)
        self._check_temperature(temperature)
        if self._k_channel is None:
            return self._missing_k(wvl_um)
        return self._k_channel(wvl_um, temperature)


# d/F/C spectral lines, microns (nd / Abbe definition)
_LINE_D, _LINE_F, _LINE_C = 0.5875618, 0.4861327, 0.6562725


def model_glass(nd, vd, name=None):
    """Two-term Cauchy stand-in glass hitting (nd, Vd) at the d/F/C lines."""
    from .formulas import cauchy
    inv_sq_spread = 1.0 / _LINE_F ** 2 - 1.0 / _LINE_C ** 2
    B = (nd - 1.0) / (vd * inv_sq_spread)
    A = nd - B / _LINE_D ** 2
    label = name if name is not None else f'model {nd:.4f}/{vd:.2f}'
    return FormulaMaterial(label, cauchy, (A, B),
                           metadata={'model_glass': True, 'nd': nd, 'vd': vd})
