"""Caching of derived raytrace quantities keyed by argument structure.

Counterpart of ``prysm_tpu/x/raytracing/_cache.py``.  ``structural_key``
flattens nested public analysis arguments (Fields, Samplings, arrays,
containers) into hashable tuples via a chain of small converters tried in
order; ``StateCache`` is a dict with compute-on-miss that can cache None.
"""
import numbers

import numpy as np

_ABSENT = object()


class StateCache(dict):
    """dict with compute-on-miss semantics that can also cache None."""

    def get_or_compute(self, key, compute):
        """Value at key; on a miss, compute(), store, and return it."""
        found = self.get(key, _ABSENT)
        if found is _ABSENT:
            found = self[key] = compute()
        return found


_ATOMS = (str, bytes, bool, numbers.Number)


def _key_atom(value):
    if value is None or isinstance(value, _ATOMS):
        return value
    return _ABSENT


def _key_container(value):
    if isinstance(value, dict):
        items = ((k, structural_key(v)) for k, v in value.items())
        return tuple(sorted(items))
    if isinstance(value, (list, tuple)):
        return tuple(map(structural_key, value))
    return _ABSENT


def _key_sampling(value):
    kind, opts = getattr(value, 'kind', None), getattr(value, 'opts', None)
    if kind is None or opts is None:
        return _ABSENT
    return ('Sampling', kind, structural_key(opts))


def _key_field(value):
    if not all(hasattr(value, a) for a in ('hx', 'hy', 'kind', 'unit')):
        return _ABSENT
    return ('Field', value.hx, value.hy, value.kind, value.unit,
            getattr(value, 'object_z', None),
            structural_key(getattr(value, 'vignetting', None)),
            )


def _key_array(value):
    try:
        arr = np.asarray(value)
    except (TypeError, ValueError):
        return _ABSENT
    return ('array', tuple(arr.shape), str(arr.dtype),
            tuple(arr.ravel().tolist()))


_CONVERTERS = (_key_atom, _key_container, _key_sampling, _key_field,
               _key_array)


def structural_key(value):
    """Hashable, stable key for nested public analysis arguments."""
    for convert in _CONVERTERS:
        key = convert(value)
        if key is not _ABSENT:
            return key
    raise TypeError('cannot construct a structural cache key for '
                    f'{type(value).__name__}')


__all__ = ['StateCache', 'structural_key']
