"""Searchable material registry with computed-property filters.

Counterpart of ``prysm_tpu/x/materials/registry.py``.
"""
from .catalog import (
    RecordSet,
    _compile_filters,
    _loose_name_match,
    _passes,
)
from .core import MissingKError

# banded computed criteria: criterion name -> (metric, leading wavelength args)
# each takes (wvl..., lo, hi[, temperature]) and keeps records whose metric
# lands inside [lo, hi] (either bound may be None for half-open bands)
_BAND_CRITERIA = {
    'n_at': ('n_at', 1),
    'dispersion': ('dispersion', 2),
    'partial_dispersion': ('partial_dispersion', 4),
    'abbe': ('abbe', 3),
}
_COMPUTED = set(_BAND_CRITERIA) | {'k_max'}


def _criterion_tuple(name, value, min_length, max_length, fill):
    try:
        values = tuple(value)
    except TypeError as exc:
        raise ValueError(f'{name} criterion must be a sequence') from exc
    if not (min_length <= len(values) <= max_length):
        raise ValueError(
            f'{name} criterion expects {min_length} to {max_length} values')
    return values + (fill,) * (max_length - len(values))


def _within(value, lo, hi):
    if lo is not None and value < lo:
        return False
    if hi is not None and value > hi:
        return False
    return True


class MaterialRegistry(RecordSet):
    """Index many catalogs; search metadata or computed optical metrics."""

    def __init__(self, records):
        self._records = tuple(records)
        self._metric_cache = {}

    @classmethod
    def from_catalogs(cls, catalogs):
        """Build from a catalog, a chain, or an iterable of catalogs."""
        if hasattr(catalogs, 'records'):  # a single catalog or a chain
            catalogs = (catalogs,)
        return cls(rec for cat in catalogs for rec in cat.records())

    def records(self):
        """Registry records."""
        return self._records

    def search(self, **criteria):
        """Records matching metadata and computed filters."""
        return list(self.iter_search(**criteria))

    def iter_search(self, **criteria):
        """Yield records matching metadata and computed filters."""
        keep = self._compile_predicates(criteria)
        return (rec for rec in self._records if all(p(rec) for p in keep))

    def _compile_predicates(self, criteria):
        """Turn a criteria dict into record -> bool closures, one per check."""
        query = criteria.get('query')
        meta = {k: v for k, v in criteria.items()
                if k != 'query' and k not in _COMPUTED}
        filters = _compile_filters(meta)
        preds = [
            lambda rec: _loose_name_match(rec, query),
            lambda rec: _passes(rec, filters),
        ]
        for name, (metric, nwvl) in _BAND_CRITERIA.items():
            if criteria.get(name) is None:
                continue
            vals = _criterion_tuple(name, criteria[name], nwvl + 2, nwvl + 3,
                                    None)
            margs = vals[:nwvl] + (vals[-1],)  # wavelengths + temperature
            lo, hi = vals[nwvl:nwvl + 2]
            preds.append(
                lambda rec, m=metric, a=margs, lo=lo, hi=hi:
                    _within(self._metric(rec, m, a), lo, hi))
        if criteria.get('k_max') is not None:
            wvl, cap, temp = _criterion_tuple('k_max', criteria['k_max'],
                                              2, 3, None)
            if cap is None:
                raise ValueError('k_max criterion requires a non-None threshold')
            preds.append(
                lambda rec: self._metric(rec, 'k_at', (wvl, temp)) <= cap)
        return preds

    def _metric(self, record, metric, args):
        key = (record.material_id, metric, args)
        try:
            if key in self._metric_cache:
                return self._metric_cache[key]
        except TypeError:
            key = None  # unhashable (array) criterion args: skip the cache
        material = record.load()
        if metric == 'n_at':
            wvl, temp = args
            value = material.n_at(wvl, temperature=temp)
        elif metric == 'k_at':
            wvl, temp = args
            try:
                value = material.k(wvl, temperature=temp)
            except MissingKError:
                value = 0.0  # transparent for the k_max filter
        elif metric == 'dispersion':
            w1, w2, temp = args
            value = material.dispersion(w1, w2, temperature=temp)
        elif metric == 'partial_dispersion':
            w1, w2, w3, w4, temp = args
            value = material.partial_dispersion(w1, w2, w3, w4,
                                                temperature=temp)
        elif metric == 'abbe':
            ws, wc, wl, temp = args
            value = material.abbe(ws, wc, wl, temperature=temp)
        else:
            raise ValueError(f'unknown metric {metric!r}')
        if key is not None:
            self._metric_cache[key] = value
        return value
