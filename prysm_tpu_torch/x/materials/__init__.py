"""Optical materials: the material protocol, formula glasses, and tokens.

Counterpart of ``prysm_tpu/x/materials/__init__.py`` for the modules
ported so far: ``core`` (constant and formula materials, ``model_glass``),
``formulas`` (the dispersion equations) and ``lookup`` (MIRROR, air,
vacuum and token resolution).  The tabulated, CHARMS, catalog, registry,
transform, infrared, AGF, refractiveindex.info and fitted-material
modules are not ported yet.  All host-side float64 numpy: materials
evaluate at setup time.
"""
from .core import (  # NOQA
    BaseMaterial,
    ConstantMaterial,
    FormulaMaterial,
    MaterialProtocol,
    MaterialRecord,
    MaterialRangeError,
    MissingKError,
    model_glass,
)
from . import lookup as _lookup

MIRROR = _lookup.MIRROR
air = _lookup.air
vacuum = _lookup.vacuum
glass = _lookup.glass
lookup = _lookup.lookup
resolve_index = _lookup.resolve_index

__all__ = [
    'BaseMaterial', 'ConstantMaterial', 'FormulaMaterial', 'MIRROR',
    'MaterialProtocol', 'MaterialRecord', 'MaterialRangeError',
    'MissingKError', 'air', 'glass', 'lookup', 'model_glass',
    'resolve_index', 'vacuum',
]
