"""Catalog containers, namespaced lookup, explicit ambiguity handling.

Counterpart of ``prysm_tpu/x/materials/catalog.py``, the catalog layer.
Queries compile to predicate lists and name resolution is score-based
(exact primary-name hits outrank alias hits).
"""
from .core import MaterialRecord, _normalize_name, _range_contains  # NOQA: F401


class AmbiguousMaterialError(KeyError):
    """A material lookup matched more than one record."""

    def __init__(self, query, candidates):
        self.query = query
        self.candidates = tuple(candidates)
        labels = ', '.join(_record_label(r) for r in self.candidates)
        super().__init__(f'ambiguous material {query!r}; candidates: {labels}')


def _record_label(record):
    tags = (record.catalog, record.name, record.variant)
    return ':'.join(t for t in tags if t)


# --------------------------- query compilation ---------------------------
#
# A filter dict compiles to a list of record predicates once per query;
# matching is then all(p(record)).  Special keys get dedicated builders;
# anything else is a metadata equality test.

def _attr_predicate(attr, want):
    target = _normalize_name(want)
    return lambda rec: _normalize_name(getattr(rec, attr) or '') == target


def _class_predicate(want):
    return lambda rec: rec.material_class == want


def _band_predicate(attr, want):
    return lambda rec: _range_contains(getattr(rec, attr), want)


def _metadata_predicate(key, want):
    return lambda rec: rec.metadata.get(key) == want


_PREDICATE_BUILDERS = {
    'catalog': lambda v: _attr_predicate('catalog', v),
    'variant': lambda v: _attr_predicate('variant', v),
    'process': lambda v: _attr_predicate('process', v),
    'material_class': _class_predicate,
    'wavelength_range_contains':
        lambda v: _band_predicate('wavelength_range', v),
    'temperature_range_contains':
        lambda v: _band_predicate('temperature_range', v),
}


def _compile_filters(filters):
    """Compile a filter dict into a list of record predicates."""
    predicates = []
    for key, value in filters.items():
        if value is None:
            continue
        build = _PREDICATE_BUILDERS.get(key)
        predicates.append(build(value) if build is not None
                          else _metadata_predicate(key, value))
    return predicates


def _passes(record, predicates):
    return all(p(record) for p in predicates)


# ----------------------------- name matching -----------------------------

_PRIMARY_HIT, _ALIAS_HIT = 2, 1


def _name_score(record, norm_query):
    """2 for an exact primary-name hit, 1 for alias/variant, 0 for none."""
    if _normalize_name(record.name) == norm_query:
        return _PRIMARY_HIT
    for candidate in record.names_for_match()[1:]:
        if _normalize_name(candidate) == norm_query:
            return _ALIAS_HIT
    return 0


def _loose_name_match(record, query):
    """Substring-tolerant match used by search()."""
    if query is None:
        return True
    norm = _normalize_name(query)
    for candidate in record.names_for_match():
        normalized = _normalize_name(candidate)
        if norm == normalized or norm in normalized:
            return True
    return False


def _resolve_record(records, name, qualifiers):
    """The one record matching name+qualifiers, or KeyError/Ambiguous.

    catalog and namespace are accepted as synonyms.  Among equally-valid
    candidates, an exact primary-name hit beats alias hits (so e.g.
    LAF3 resolves even when N-LAF3 carries LAF3 as an alias); a tie at
    the top score is ambiguous.
    """
    qualifiers = dict(qualifiers)
    namespace = qualifiers.pop('catalog', None) or qualifiers.pop('namespace', None)
    predicates = _compile_filters({'catalog': namespace, **qualifiers})
    norm = _normalize_name(name)

    scored = [(score, rec) for rec in records
              if (score := _name_score(rec, norm)) and _passes(rec, predicates)]
    if not scored:
        raise KeyError(f'no material named {name!r}')
    best = max(s for s, _ in scored)
    winners = [rec for s, rec in scored if s == best]
    if len(winners) > 1:
        raise AmbiguousMaterialError(name, [rec for _, rec in scored])
    return winners[0]


def _search_records(records, query, filters):
    predicates = _compile_filters(filters)
    return [rec for rec in records
            if _loose_name_match(rec, query) and _passes(rec, predicates)]


class RecordSet:
    """Shared query behavior over a records() sequence.

    Anything that yields MaterialRecords via records() gets lookup,
    ambiguity handling, the "namespace:name" split, and metadata search
    for free; Catalog/CatalogChain/registry only supply records().
    """

    def records(self):
        """The records in this set; subclasses implement."""
        raise NotImplementedError

    def search(self, query=None, **metadata_filters):
        """Search metadata without instantiating materials."""
        return _search_records(self.records(), query, metadata_filters)

    def material_for_name(self, name, **qualifiers):
        """Resolve one material by name; KeyError / AmbiguousMaterialError."""
        return _resolve_record(self.records(), name, qualifiers).load()

    def __getitem__(self, key):
        """Lookup by name or 'namespace:name'."""
        if isinstance(key, str) and ':' in key:
            namespace, _, name = key.partition(':')
            return self.material_for_name(name, catalog=namespace)
        return self.material_for_name(key)


class Catalog(RecordSet):
    """In-memory catalog over material records."""

    def __init__(self, records=(), *, namespace=None):
        self.namespace = namespace
        self._records = tuple(records)

    @classmethod
    def from_materials(cls, materials, *, namespace=None):
        """Build a catalog from material instances without mutating them.

        The namespace stamps records whose material has no catalog of
        its own; materials that already belong to a catalog keep it.
        """
        def stamped(material):
            unowned = namespace is not None and not material.catalog
            return material.record(catalog=namespace if unowned else None)

        return cls([stamped(m) for m in materials], namespace=namespace)

    def records(self):
        """All material records."""
        return self._records


class CatalogChain(RecordSet):
    """Several catalogs searched in order with shared ambiguity rules."""

    def __init__(self, catalogs):
        self.catalogs = tuple(catalogs)

    def records(self):
        """Records from every catalog in chain order."""
        out = []
        for catalog in self.catalogs:
            out.extend(catalog.records())
        return tuple(out)
