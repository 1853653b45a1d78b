"""Optical materials and glass catalogs.

Counterpart of ``prysm_tpu/x/materials/__init__.py``: the
MaterialProtocol duck type, formula / tabulated / temperature-grid /
CHARMS / fitted material models, catalog + registry machinery, AGF and
refractiveindex.info backends, and opt-in environment transforms.  All
host-side float64 numpy: materials evaluate at trace and film setup time,
before any tensor work.
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
from .tabulated import MaterialData, TabulatedMaterial, TemperatureGridMaterial  # NOQA
from .charms import (  # NOQA
    CHARMSCoefficientMaterial,
    CHARMSDataset,
    CHARMSTableMaterial,
    TemperatureSellmeierMaterial,
)
from .catalog import AmbiguousMaterialError, Catalog, CatalogChain  # NOQA
from .registry import MaterialRegistry  # NOQA
from .transforms import (  # NOQA
    IndexOffsetMaterial,
    IsothermalMaterial,
    MaterialTransform,
    ProcessVariantMaterial,
    StressOpticMaterial,
    TemperatureShiftedMaterial,
    ThicknessDependentMaterial,
)
from .infrared import (  # NOQA
    charms_germanium,
    charms_silicon,
    infrared_catalog,
    sapphire_ordinary,
)
from .agf import AGFCatalog, AGFMaterial, load_agf_catalog  # NOQA
from .rii import (  # NOQA
    RefractiveIndexCatalog,
    RefractiveIndexMaterial,
    default_db_path,
)
from .fitted import FitReport, FittedMaterial, fit_material, from_samples  # NOQA
from . import lookup as _lookup

MIRROR = _lookup.MIRROR
air = _lookup.air
vacuum = _lookup.vacuum
glass = _lookup.glass
lookup = _lookup.lookup
resolve_index = _lookup.resolve_index

__all__ = [
    'AGFCatalog', 'AGFMaterial', 'AmbiguousMaterialError', 'BaseMaterial',
    'Catalog', 'CatalogChain', 'CHARMSCoefficientMaterial', 'CHARMSDataset',
    'CHARMSTableMaterial', 'ConstantMaterial', 'FitReport', 'FittedMaterial',
    'FormulaMaterial', 'IndexOffsetMaterial', 'IsothermalMaterial', 'MIRROR',
    'MaterialData', 'MaterialProtocol', 'MaterialRecord',
    'MaterialRangeError', 'MaterialRegistry', 'MaterialTransform',
    'MissingKError', 'ProcessVariantMaterial', 'RefractiveIndexCatalog',
    'RefractiveIndexMaterial', 'StressOpticMaterial', 'TabulatedMaterial',
    'TemperatureGridMaterial', 'TemperatureSellmeierMaterial',
    'TemperatureShiftedMaterial', 'ThicknessDependentMaterial', 'air',
    'charms_germanium', 'charms_silicon', 'default_db_path', 'fit_material',
    'infrared_catalog', 'from_samples', 'glass', 'load_agf_catalog',
    'lookup', 'model_glass', 'resolve_index', 'sapphire_ordinary', 'vacuum',
]
