"""Zemax AGF glass-catalog backend.

Counterpart of ``prysm_tpu/x/materials/agf.py``.  Design: the AGF text is
tokenized into a stream of (tag, payload) records (:func:`_records`), and a
fold over that stream groups the per-glass records between NM markers into
:class:`_GlassSpec` bundles, each of which builds one FormulaMaterial over
the shared AGF dispersion formulas.

The AGF record vocabulary (NM/CD/LD/TD/...) and dispersion-formula numbering
are fixed by the Zemax file format.
"""
from dataclasses import dataclass, field
from functools import partial
from pathlib import Path

from .catalog import Catalog
from .core import FormulaMaterial, _normalize_name
from .formulas import agf_formula

# vendor spellings that normalize to a canonical catalog key
_VENDOR_KEYS = ('SCHOTT', 'OHARA', 'HOYA', 'HIKARI', 'CDGM', 'SUMITA')

# records that carry free-text metadata we keep but do not interpret
_KEPT_TAGS = frozenset({'GC', 'ED', 'TD', 'IT', 'MD', 'OD', 'BD'})


def _canonical_vendor(label):
    norm = _normalize_name(label or '')
    return next((v for v in _VENDOR_KEYS if norm.startswith(v)), norm)


def _vendor_from_filename(path):
    stem = Path(path).stem.upper()
    norm = _normalize_name(stem)
    return next((v for v in _VENDOR_KEYS if v in norm), stem)


def _read_agf_text(raw):
    """Decode AGF bytes; vendors ship UTF-16, UTF-8+BOM, UTF-8, or cp1252."""
    if raw[:2] in (b'\xff\xfe', b'\xfe\xff'):
        return raw.decode('utf-16')
    if raw[:3] == b'\xef\xbb\xbf':
        return raw.decode('utf-8-sig')
    try:
        return raw.decode('utf-8')
    except UnicodeDecodeError:
        return raw.decode('cp1252')


def _records(text):
    """Yield (tag, token list) for every non-comment record in AGF text."""
    for raw in text.splitlines():
        stripped = raw.strip()
        if stripped and not stripped.startswith('!'):
            tag, *payload = stripped.split()
            yield tag.upper(), payload


@dataclass
class _GlassSpec:
    """Accumulated state for one glass between NM records."""

    name: str
    formula: int
    extra: dict = field(default_factory=dict)
    coefficients: tuple = ()
    wvl_lo: float = None
    wvl_hi: float = None

    def absorb(self, tag, payload):
        if tag == 'CD':
            self.coefficients = tuple(float(t) for t in payload)
        elif tag == 'LD' and len(payload) >= 2:
            self.wvl_lo, self.wvl_hi = float(payload[0]), float(payload[1])
        elif tag in _KEPT_TAGS:
            self.extra[tag] = self.extra.get(tag, ()) + (' '.join(payload),)


def _derived_aliases(glass_name):
    trimmed = glass_name.upper()
    return (trimmed[2:],) if trimmed.startswith('N-') else ()


def _describe_page(material):
    span = material.wavelength_range or (None, None)
    vendor = material.catalog
    return {
        'shelf': 'agf',
        'book': f'{vendor}-agf' if vendor else 'agf',
        'page': material.name,
        'filepath': material.source or '',
        'catalog': vendor,
        'formula': material.metadata.get('formula'),
        'rangeMin': span[0],
        'rangeMax': span[1],
    }


def AGFMaterial(name, catalog, formula, coefficients, *, wavelength_min=None,
                wavelength_max=None, metadata=None, source_path=None,
                variant=None, source=None, citation=None, license=None,
                process=None, temperature_range=None):
    """Build a FormulaMaterial from one parsed AGF NM record."""
    info = dict(metadata or {})
    info.setdefault('formula', formula)
    info.setdefault('aliases', _derived_aliases(name))
    info.setdefault('material_class', 'AGFMaterial')
    span = (None if wavelength_min is None else float(wavelength_min),
            None if wavelength_max is None else float(wavelength_max))
    built = FormulaMaterial(
        name, partial(agf_formula, formula, name=name),
        tuple(float(c) for c in coefficients),
        catalog=catalog or '', variant=variant,
        source=source or source_path, citation=citation, license=license,
        wavelength_range=span, temperature_range=temperature_range,
        process=process, metadata=info)
    built._page_info_builder = _describe_page
    return built


class AGFCatalog(Catalog):
    """Collection of AGF glasses."""

    def __init__(self, materials, catalog=None, namespace=None, comments=()):
        namespace = namespace if namespace is not None else catalog
        self.materials = tuple(materials)
        self.catalog = namespace or (self.materials[0].catalog
                                     if self.materials else '')
        self.comments = tuple(comments)
        super().__init__([m.record() for m in self.materials],
                         namespace=self.catalog)

    @classmethod
    def from_file(cls, path, namespace=None, catalog=None):
        """Parse one AGF file from disk."""
        path = Path(path)
        label = namespace if namespace is not None else catalog
        return cls.from_text(_read_agf_text(path.read_bytes()),
                             namespace=label or _vendor_from_filename(path),
                             source_path=str(path))

    @classmethod
    def from_files(cls, paths, namespace=None):
        """Parse several AGF files into one catalog."""
        glasses, remarks = [], []
        for path in paths:
            parsed = cls.from_file(path)
            glasses += list(parsed.materials)
            remarks += list(parsed.comments)
        return cls(glasses, namespace=namespace or 'AGF', comments=remarks)

    @classmethod
    def from_text(cls, text, namespace='AGF', source_path=None, catalog=None):
        """Parse AGF text into a catalog."""
        if catalog is not None and namespace == 'AGF':
            namespace = catalog
        namespace = _canonical_vendor(namespace)
        specs, remarks = [], []
        for tag, payload in _records(text):
            if tag == 'CC':
                remarks.append(' '.join(payload))
            elif tag == 'NM':
                if len(payload) < 2:
                    raise ValueError('malformed AGF NM record: '
                                     f"{'NM ' + ' '.join(payload)!r}")
                specs.append(_GlassSpec(
                    name=payload[0], formula=int(float(payload[1])),
                    extra={'NM': (' '.join(payload[2:]),)}))
            elif specs:
                specs[-1].absorb(tag, payload)
        glasses = [
            AGFMaterial(name=s.name, catalog=namespace, formula=s.formula,
                        coefficients=s.coefficients, wavelength_min=s.wvl_lo,
                        wavelength_max=s.wvl_hi, metadata=s.extra,
                        source_path=source_path)
            for s in specs
        ]
        return cls(glasses, namespace=namespace, comments=remarks)


def load_agf_catalog(path_or_paths, namespace=None):
    """Load one AGF file or an iterable of AGF files."""
    if isinstance(path_or_paths, (str, Path)):
        return AGFCatalog.from_file(path_or_paths, namespace=namespace)
    return AGFCatalog.from_files(path_or_paths, namespace=namespace)
