"""Glass-token resolution: MIRROR sentinel, air/vacuum, catalog names.

Counterpart of ``prysm_tpu/x/materials/lookup.py``.  Resolution is a
chain of small matchers tried in order; the first one that recognizes the
spec wins.
"""
from .core import ConstantMaterial

MIRROR = '__MIRROR__'

air, vacuum = (ConstantMaterial(1.0, name=label)
               for label in ('air', 'vacuum'))

_SHARED_DB = []


def _default_catalog():
    """Process-wide cached ri.info catalog (fetched once)."""
    if not _SHARED_DB:
        from .rii import RefractiveIndexCatalog
        _SHARED_DB.append(RefractiveIndexCatalog.from_database())
    return _SHARED_DB[0]


def glass(name, database=None, **qualifiers):
    """Resolve a glass name through a catalog (default: the ri.info db)."""
    db = database if database is not None else _default_catalog()
    resolver = getattr(db, 'material_for_name', None)
    if resolver is None:
        raise TypeError('database must expose material_for_name(name)')
    return resolver(name, **qualifiers)


def resolve_index(spec, name_resolver=None):
    """Turn any index spec into a callable n(wvl), MIRROR, air, or None.

    Strings 'MIRROR', 'AIR', 'VACUUM' are special tokens; other strings
    route through ``name_resolver``; numbers become constant callables;
    callables pass through unchanged.
    """
    if spec is None or spec is MIRROR:
        return spec
    if not isinstance(spec, str):
        # a bare number becomes a constant; an n(wvl) callable passes through
        return spec if callable(spec) else (lambda wvl, value=spec: value)
    token = spec.strip().upper()
    if token == 'MIRROR':
        return MIRROR
    if token in ('', 'AIR', 'VACUUM'):
        return air
    if name_resolver is None:
        raise TypeError(f'glass name {spec!r} needs a catalog to resolve')
    return name_resolver(spec)


def lookup(name, database=None, **qualifiers):
    """Map a glass token to a material, air, or the MIRROR sentinel."""
    found = resolve_index(
        name, name_resolver=lambda s: glass(s, database=database, **qualifiers))
    return air if found is None else found
