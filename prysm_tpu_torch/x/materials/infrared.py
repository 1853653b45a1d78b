"""Infrared material library: CHARMS Si/Ge and Malitson sapphire.

Counterpart of ``prysm_tpu/x/materials/infrared.py``.  Models are declared
in a small table (``_CRYO_SELLMEIER``) and instantiated by one generic
factory; the numeric coefficients are the published values from Frey,
Leviton & Madison (Proc. SPIE 6273, 62732J, 2006, Tables 5/10) and Malitson
& Dodge (JOSA 62, 1405, 1972) — they are fixed by the literature, not by
any implementation.
"""
from .catalog import Catalog
from .charms import TemperatureSellmeierMaterial
from .core import FormulaMaterial
from .formulas import sellmeier
from .transforms import IsothermalMaterial

_CHARMS_CITE = ('Frey, Leviton & Madison, '
                'Proc. SPIE 6273, 62732J (2006)')

# name -> (wavelength range um, temperature range K, strengths, resonances);
# coefficient rows are ascending powers of T(K), one row per Sellmeier term
_CRYO_SELLMEIER = {
    'silicon': (
        (1.1, 5.6), (20.0, 300.0),
        ((10.4907, -2.08020e-4, 4.21694e-6, -5.82298e-9, 3.44688e-12),
         (-1346.61, 29.1664, -0.278724, 1.05939e-03, -1.35089e-06),
         (4.42827e7, -1.76213e6, -7.61575e4, 678.414, 103.243)),
        ((0.299713, -1.14234e-5, 1.67134e-7, -2.51049e-10, 2.32484e-14),
         (-3.51710e+03, 42.3892, -0.357957, 1.17504e-03, -1.13212e-06),
         (1.71400e6, -1.44984e5, -6.90744e3, -39.3699, 23.5770)),
    ),
    'germanium': (
        (1.9, 5.5), (20.0, 300.0),
        ((13.9723, 2.52809e-3, -5.02195e-6, 2.22604e-8, -4.86238e-12),
         (0.452096, -3.09197e-03, 2.16895e-05, -6.02290e-08, 4.12038e-11),
         (751.447, -14.2843, -0.238093, 2.96047e-3, -7.73454e-6)),
        ((0.386367, 2.01871e-4, -5.93448e-7, -2.27923e-10, 5.37423e-12),
         (1.08843, 1.16510e-03, -4.97284e-06, 1.12357e-08, 9.40201e-12),
         (-2893.19, -0.967948, -0.527016, 6.49364e-3, -1.95162e-5)),
    ),
}


def _cryo_material(key, name):
    wrange, trange, strengths, resonances = _CRYO_SELLMEIER[key]
    return TemperatureSellmeierMaterial(
        name or key, strengths, resonances, wavelength_range=wrange,
        temperature_range=trange, catalog='CHARMS', citation=_CHARMS_CITE)


def charms_silicon(name='silicon'):
    """Cryogenic CHARMS silicon model, valid 1.1-5.6 um and 20-300 K."""
    return _cryo_material('silicon', name)


def charms_germanium(name='germanium'):
    """Cryogenic CHARMS germanium model, valid 1.9-5.5 um and 20-300 K."""
    return _cryo_material('germanium', name)


def sapphire_ordinary(name='sapphire', *, aliases=()):
    """Ordinary-ray sapphire at room temperature (Malitson, 0.2-5.5 um)."""
    strengths = (1.4313493, 0.65054713, 5.3414021)
    resonances_sq = tuple(r * r for r in (0.0726631, 0.1193242, 18.028251))
    return FormulaMaterial(
        name, sellmeier, (strengths, resonances_sq),
        wavelength_range=(0.2, 5.5), catalog='Malitson',
        citation=('Malitson & Dodge, '
                  'J. Opt. Soc. Am. 62, 1405 (1972)'),
        metadata={'aliases': tuple(aliases)})


def infrared_catalog(temperature=295.0):
    """MWIR catalog; the CHARMS models come bound to one temperature."""
    aliases = {'germanium': ('GE', 'GERMANIUM', 'GERMMW'),
               'silicon': ('SI', 'SILICON')}
    bound = [IsothermalMaterial(_cryo_material(key, key), temperature,
                                name=key, metadata={'aliases': names})
             for key, names in aliases.items()]
    bound.append(sapphire_ordinary(aliases=('SAPHIR', 'SAPPHIRE', 'AL2O3')))
    return Catalog.from_materials(bound, namespace='IR')
