"""refractiveindex.info database backend.

Counterpart of ``prysm_tpu/x/materials/rii.py``.  Reads ``catalog-nk.yml``
plus per-page YAML data files.  Design: a recursive walker flattens the
shelf/book/page nesting (:func:`_walk_catalog`); each page's DATA blocks are
parsed into typed segments (:func:`_page_segments`) and assembled into a
formula or tabulated material; name resolution filters candidate records
through qualifier predicates and picks the best by an additive score.

The optional ``refractiveindex`` package is used only to auto-download the
database folder (unavailable in hermetic environments; pass an existing
db_path instead).
"""
import io as _io
from functools import partial
from pathlib import Path

import numpy as np

from .catalog import Catalog
from .core import FormulaMaterial, MaterialRecord, _normalize_name
from .formulas import riinfo_formula
from .tabulated import TabulatedMaterial


def default_db_path():
    """The refractiveindex package's default database folder."""
    return Path.home() / '.refractiveindex.info-database'


# -- catalog index -----------------------------------------------------------


def _walk_catalog(db_path):
    """Yield (shelf, book, page, data file path) from catalog-nk.yml."""
    import yaml
    text = (Path(db_path) / 'catalog-nk.yml').read_text(encoding='utf-8')
    tree = yaml.load(text, Loader=yaml.BaseLoader)

    def entries(seq, key):
        for node in seq or []:
            if 'DIVIDER' not in node:
                yield node[key], node

    for shelf, shelf_node in entries(tree, 'SHELF'):
        for book, book_node in entries(shelf_node.get('content'), 'BOOK'):
            for page, page_node in entries(book_node.get('content'), 'PAGE'):
                yield shelf, book, page, Path(db_path) / 'data' / Path(page_node['data'])


def _fetch_database(db_path):
    """Populate db_path via the refractiveindex package's auto-download."""
    try:
        from refractiveindex import RefractiveIndexMaterial as _Trigger
    except ImportError as exc:
        raise ImportError(
            'the refractiveindex.info database is absent and downloading it '
            'requires the optional refractiveindex package; install it, or '
            'pass an existing db_path') from exc
    try:
        # constructing any material triggers the package's download side
        # effect; the bogus identifiers then raise, which we swallow
        _Trigger('__prysm__', '__prysm__', '__prysm__',
                 db_path=str(db_path), auto_download=True)
    except Exception:
        pass
    if not (Path(db_path) / 'catalog-nk.yml').exists():
        raise FileNotFoundError(
            f'auto-download did not populate the refractiveindex.info '
            f'database at {db_path}')


# -- page parsing ------------------------------------------------------------


def _page_segments(doc):
    """Classify a page's DATA blocks.

    Returns a dict with any of the keys 'formula' -> (id, coeffs, lo, hi)
    and 'n'/'k' -> (wavelengths, values).
    """
    segments = {}
    for block in doc['DATA']:
        kind, _, flavor = block['type'].partition(' ')
        if kind == 'tabulated':
            table = np.loadtxt(_io.StringIO(block['data']), ndmin=2)
            wl = table[:, 0]
            if flavor == 'n':
                segments['n'] = (wl, table[:, 1])
            elif flavor == 'k':
                segments['k'] = (wl, table[:, 1])
            elif flavor == 'nk':
                segments['n'] = (wl, table[:, 1])
                segments['k'] = (wl, table[:, 2])
        elif kind == 'formula':
            coeffs = tuple(float(v) for v in block['coefficients'].split())
            span = block.get('range', block.get('wavelength_range'))
            lo, hi = (float(v) for v in span.split())
            segments['formula'] = (int(flavor), coeffs, lo, hi)
    return segments


def _page_info(material):
    wr = material.wavelength_range
    lo, hi = wr if wr is not None else (None, None)
    meta = material.metadata
    return {
        'shelf': meta.get('shelf'),
        'book': meta.get('book'),
        'page': meta.get('page'),
        'filepath': material.source or meta.get('filepath') or '',
        'rangeMin': lo,
        'rangeMax': hi,
    }


class RefractiveIndexMaterial(TabulatedMaterial):
    """Tabulated material loaded from a refractiveindex.info data file."""

    def __init__(self, name, wavelengths, n, *, k=None, variant=None,
                 catalog='RII', source=None, metadata=None):
        # single-sample pages are constant-index: nearest + extrapolate
        constant = len(wavelengths) < 2
        super().__init__(
            name, wavelengths, n, k=k, catalog=catalog, variant=variant,
            source=source, license='CC0', metadata=dict(metadata or {}),
            missing_k='zero' if k is None else 'raise',
            method='nearest' if constant else None,
            extrapolate=constant)
        self._page_info_builder = _page_info


def _build_page_material(shelf, book, page, filepath, namespace):
    """Parse one refractiveindex.info YAML page into a material."""
    import yaml
    doc = yaml.load(Path(filepath).read_text(encoding='utf-8'),
                    Loader=yaml.BaseLoader)
    segments = _page_segments(doc)
    provenance = {'shelf': shelf, 'book': book, 'page': page,
                  'filepath': str(filepath)}

    if 'formula' in segments:
        fid, coeffs, lo, hi = segments['formula']
        k_callable = None
        if 'k' in segments:
            # n stays analytic; the tabulated k interpolates independently
            wl_k, k_vals = segments['k']
            k_callable = partial(np.interp, xp=wl_k, fp=k_vals)
        material = FormulaMaterial(
            book, partial(riinfo_formula, fid), coeffs,
            k_formula=k_callable, catalog=namespace, variant=page,
            source=str(filepath), license='CC0',
            wavelength_range=(lo, hi), metadata=provenance)
        material._page_info_builder = _page_info
        return material

    if 'n' not in segments:
        raise ValueError(
            f'refractiveindex.info material {filepath} has no n data')
    wl, n_vals = segments['n']
    k_vals = None
    if 'k' in segments:
        wl_k, k_raw = segments['k']
        same_grid = len(wl_k) == len(wl) and np.array_equal(wl_k, wl)
        k_vals = k_raw if same_grid else np.interp(wl, wl_k, k_raw).astype(
            wl.dtype, copy=False)
    return RefractiveIndexMaterial(book, wl, n_vals, k=k_vals, variant=page,
                                   catalog=namespace, source=str(filepath),
                                   metadata=provenance)


# -- name resolution ---------------------------------------------------------

_BRAND_PREFIX_BOOKS = {
    'N-': 'SCHOTT-optical',
    'P-': 'SCHOTT-optical',
    'S-': 'OHARA-optical',
    'J-': 'HIKARI-optical',
    'H-': 'CDGM-optical',
    'K-': 'SUMITA-optical',
}


def _score(record, name):
    """Lower is better: prefer the canonical dataset for a glass name."""
    meta = record.metadata
    page = meta.get('page') or ''
    book = meta.get('book') or ''
    shelf = meta.get('shelf') or ''
    upper = str(name).upper()
    points = 100
    points -= 50 * (page.upper() == upper)
    points -= 25 * (_normalize_name(page) == _normalize_name(str(name)))
    points -= 10 * (shelf == 'specs')
    brand = next((b for p, b in _BRAND_PREFIX_BOOKS.items()
                  if upper.startswith(p)), None)
    points -= 20 * (brand is not None and book == brand)
    points -= 5 * book.endswith('-optical')
    return (points, shelf, book, page)


def _qualifier_predicates(shelf, book, page, extra):
    def match(field, want):
        def check(meta):
            return _normalize_name(meta.get(field) or '') == _normalize_name(want)
        return check

    preds = []
    for field, want in (('shelf', shelf), ('book', book), ('page', page)):
        if want is not None:
            preds.append(match(field, want))
    for key, value in extra.items():
        preds.append(lambda meta, k=key, v=value: meta.get(k) == v)
    return preds


class RefractiveIndexCatalog(Catalog):
    """Catalog adapter over the refractiveindex.info YAML database."""

    def __init__(self, records, *, db_path=None, namespace='RII'):
        self.db_path = None if db_path is None else Path(db_path)
        self.namespace = namespace
        super().__init__(records, namespace=namespace)
        # normalized-name index: O(1) candidate pull + rank among candidates
        by_name = {}
        for record in self.records():
            for alias in record.names_for_match():
                if alias:
                    by_name.setdefault(_normalize_name(alias), []).append(record)
        self._by_name = by_name

    @classmethod
    def from_database(cls, db_path=None, *, download=True, namespace='RII'):
        """Build from the ri.info database folder, downloading if absent."""
        db_path = Path(db_path) if db_path is not None else default_db_path()
        if not (db_path / 'catalog-nk.yml').exists():
            if not download:
                raise FileNotFoundError(
                    f'refractiveindex.info database not found at {db_path}')
            _fetch_database(db_path)
        records = []
        for shelf, book, page, filepath in _walk_catalog(db_path):
            aliases = tuple(a for a in (page, str(filepath)) if a and a != book)
            records.append(MaterialRecord(
                name=book, catalog=namespace, variant=page, aliases=aliases,
                source=str(filepath), license='CC0',
                material_class='RefractiveIndexMaterial',
                metadata={'shelf': shelf, 'book': book, 'page': page,
                          'filepath': str(filepath)},
                loader=partial(_build_page_material, shelf, book, page,
                               filepath, namespace),
                material_id=f'{namespace}:{shelf}:{book}:{page}'))
        return cls(records, db_path=db_path, namespace=namespace)

    def material_for_name(self, name, **qualifiers):
        """Resolve a glass name to its best-ranked ri.info page."""
        catalog = qualifiers.pop('catalog', qualifiers.pop('namespace', None))
        if catalog is not None and (_normalize_name(catalog)
                                    != _normalize_name(self.namespace)):
            raise KeyError(f'no material named {name!r} in catalog {catalog!r}')
        preds = _qualifier_predicates(qualifiers.pop('shelf', None),
                                      qualifiers.pop('book', None),
                                      qualifiers.pop('page', None),
                                      qualifiers)
        candidates = [
            record for record in self._by_name.get(_normalize_name(name), ())
            if all(p(record.metadata) for p in preds)
        ]
        if not candidates:
            raise KeyError(f'no refractiveindex.info material named {name!r}')
        return min(candidates, key=lambda r: _score(r, name)).load()
