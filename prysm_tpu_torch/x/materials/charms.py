"""CHARMS-style cryogenic dispersion models.

Counterpart of ``prysm_tpu/x/materials/charms.py``.  The model is the
temperature-dependent Sellmeier form

    n^2(w, T) = 1 + sum_i S_i(T) w^2 / (w^2 - L_i(T)^2)

with the strengths S_i and resonances L_i polynomial in temperature.  The
implementation here is fully vectorized: coefficients live in (terms, order)
matrices and all Sellmeier terms evaluate in one einsum over a shared
Vandermonde of the query temperatures.
"""
import numpy as np

from .catalog import Catalog
from .core import BaseMaterial
from .tabulated import TemperatureGridMaterial


def _coefficient_matrix(table, label):
    matrix = np.array(table, dtype=np.float64)
    if matrix.shape[0] != 3:
        raise ValueError(f'{label} needs exactly three Sellmeier terms')
    return np.atleast_2d(matrix)


def _poly_in_T(matrix, temperature):
    """Evaluate each row of ``matrix`` (ascending powers) at ``temperature``.

    Returns an array of shape (terms,) + shape(temperature).
    """
    t = np.asarray(temperature, dtype=np.float64)
    orders = np.arange(matrix.shape[1])
    vandermonde = t[..., None] ** orders          # (..., order)
    return np.einsum('io,...o->i...', matrix, vandermonde)


class TemperatureSellmeierMaterial(BaseMaterial):
    """Sellmeier material whose strengths and resonances are polynomial in T."""

    def __init__(self, name, strength_coefficients, resonance_coefficients, *,
                 residuals=None, measurement_uncertainty=None, **kwargs):
        metadata = dict(kwargs.pop('metadata', None) or {})
        for key, value in (('residuals', residuals),
                           ('measurement_uncertainty', measurement_uncertainty)):
            if value is not None:
                metadata[key] = value
        super().__init__(name, metadata=metadata,
                         missing_k=kwargs.pop('missing_k', 'zero'), **kwargs)
        self.strength_coefficients = _coefficient_matrix(
            strength_coefficients, 'strength_coefficients')
        self.resonance_coefficients = _coefficient_matrix(
            resonance_coefficients, 'resonance_coefficients')

    def n(self, wvl_um, temperature=None):
        """Evaluate the temperature-dependent Sellmeier equation."""
        if temperature is None:
            raise ValueError(
                f'{self.name} is temperature-dependent; pass temperature=')
        self._check_wavelength(wvl_um)
        self._check_temperature(temperature)
        w, t = np.broadcast_arrays(np.asarray(wvl_um, dtype=np.float64),
                                   temperature)
        S = _poly_in_T(self.strength_coefficients, t)       # (terms, ...)
        L = _poly_in_T(self.resonance_coefficients, t)
        w_sq = w * w
        n_sq = 1.0 + (S * w_sq / (w_sq - L * L)).sum(axis=0)
        return np.sqrt(n_sq)


class CHARMSCoefficientMaterial(TemperatureSellmeierMaterial):
    """CHARMS coefficient-table material.

    Accepts coefficients either as a (strengths, resonances) pair or a dict
    with 'S'/'strength' and 'lambda'/'resonance' keys.
    """

    def __init__(self, name, coefficients=None, **kwargs):
        if coefficients is not None:
            if hasattr(coefficients, 'get'):
                pair = (coefficients.get('S', coefficients.get('strength')),
                        coefficients.get('lambda', coefficients.get('resonance')))
            else:
                pair = tuple(coefficients)
            kwargs.setdefault('strength_coefficients', pair[0])
            kwargs.setdefault('resonance_coefficients', pair[1])
        super().__init__(name, **kwargs)


class CHARMSTableMaterial(TemperatureGridMaterial):
    """Absolute-index CHARMS measurement table."""


class CHARMSDataset(Catalog):
    """Catalog container holding CHARMS materials."""

    @classmethod
    def from_materials(cls, materials, *, namespace='CHARMS'):
        """Bundle material instances into a CHARMS dataset."""
        return super().from_materials(materials, namespace=namespace)
