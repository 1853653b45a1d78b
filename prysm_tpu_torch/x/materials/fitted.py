"""Dispersion-model fitting: coefficient-backed materials from samples.

Counterpart of ``prysm_tpu/x/materials/fitted.py``.  Design: each model is a
:class:`_ModelSpec` entry in a registry — parameter naming, term resolution,
evaluation, and the fitting strategy (linear design matrix vs nonlinear
residual) all hang off the spec, so :func:`fit_material` is one generic
driver rather than per-model branches.

Models: 'constant', 'cauchy' (inverse-even-power series), 'schott'
(polynomial in w^2 fit against n^2), 'sellmeier1' (nonlinear resonance fit).
"""
from dataclasses import dataclass

import numpy as np
from scipy import optimize

from .core import BaseMaterial, MaterialRangeError
from .formulas import schott, sellmeier
from .tabulated import MaterialData, TabulatedMaterial


def _require(cond, message):
    if not cond:
        raise ValueError(message)


@dataclass(frozen=True)
class FitReport:
    """Diagnostics from fitting a dispersion model to measured samples."""

    model: str
    coefficients: dict
    rms_error: float
    max_abs_error: float
    residuals: 'np.ndarray'
    wavelength_range: tuple
    sample_count: int
    parameter_count: int
    degrees_of_freedom: int
    condition_number: float
    warnings: tuple
    message: str = ''
    success: bool = True


# ---------------------------------------------------------------------------
# model registry
# ---------------------------------------------------------------------------


def _even_inverse_powers(wvl, coeffs):
    """c0 + c1/w^2 + c2/w^4 + ... (the Cauchy series)."""
    total = coeffs[0] + wvl * 0
    for i, c in enumerate(coeffs[1:], start=1):
        total = total + c * wvl ** (-2 * i)
    return total


@dataclass(frozen=True)
class _ModelSpec:
    key: str
    names_for: callable          # terms -> parameter name tuple
    resolve_terms: callable      # (terms, n_samples) -> int
    evaluate: callable           # (wvl, coeffs, terms) -> n
    design: callable = None      # (wvl, terms) -> matrix (linear models)
    target: callable = None      # (n,) -> fitted quantity (default n itself)
    sigma_map: callable = None   # (n, sigma) -> sigma of the fitted quantity


def _fixed(value):
    return lambda terms, n_samples: value


def _cauchy_terms(terms, n_samples):
    if n_samples == 1:
        raise ValueError('a single sample supports only the constant model')
    return 2 if terms is None else int(terms)


_REGISTRY = {
    'constant': _ModelSpec(
        key='constant',
        names_for=lambda terms: ('n0',),
        resolve_terms=_fixed(1),
        evaluate=lambda wvl, c, terms: c[0] + wvl * 0,
        design=lambda wvl, terms: np.ones((wvl.size, 1))),
    'cauchy': _ModelSpec(
        key='cauchy',
        names_for=lambda terms: tuple(f'A{i}' for i in range(terms)),
        resolve_terms=_cauchy_terms,
        evaluate=lambda wvl, c, terms: _even_inverse_powers(wvl, c[:terms]),
        design=lambda wvl, terms: np.stack(
            [wvl ** (-2 * i) for i in range(terms)], axis=1)),
    'schott': _ModelSpec(
        key='schott',
        names_for=lambda terms: tuple(f'c{i}' for i in range(6)),
        resolve_terms=_fixed(6),
        evaluate=lambda wvl, c, terms: schott(wvl, *c[:6]),
        design=lambda wvl, terms: np.stack(
            [wvl * 0 + 1, wvl ** 2, wvl ** -2.0, wvl ** -4.0,
             wvl ** -6.0, wvl ** -8.0], axis=1),
        target=lambda n: n * n,
        sigma_map=lambda n, s: 2 * n * s),
    'sellmeier1': _ModelSpec(
        key='sellmeier1',
        names_for=lambda terms: (tuple(f'B{i}' for i in range(terms))
                                 + tuple(f'C{i}' for i in range(terms))),
        resolve_terms=lambda terms, n_samples: 1 if terms is None else int(terms),
        evaluate=lambda wvl, c, terms: sellmeier(wvl, c[:terms], c[terms:])),
}


def _spec_for(model):
    spec = _REGISTRY.get(str(model).lower())
    if spec is None:
        raise ValueError(f'unknown fit model {model!r}; expected one of '
                         + ', '.join(sorted(_REGISTRY)))
    return spec


# ---------------------------------------------------------------------------
# fitting engines
# ---------------------------------------------------------------------------


def _bound_pair(bounds, n_params):
    if bounds is None:
        return None
    lo, hi = (np.broadcast_to(np.asarray(side, dtype=float), (n_params,)).copy()
              for side in bounds)
    if np.any(lo > hi):
        raise ValueError('a lower bound exceeds its upper bound')
    return lo, hi


def _solve_linear(spec, data, terms, bounds):
    """Weighted (optionally bounded) linear least squares for the model."""
    A = spec.design(data.wavelengths, terms)
    y = spec.target(data.n) if spec.target else data.n
    sigma = data.sigma_n
    if sigma is not None and spec.sigma_map:
        sigma = spec.sigma_map(data.n, sigma)
    if sigma is not None:
        A = A / sigma[:, None]
        y = y / sigma
    if bounds is None:
        coeffs, _, rank, svals = np.linalg.lstsq(A, y, rcond=None)
        return coeffs, rank, svals, 'unconstrained linear least squares'
    solved = optimize.lsq_linear(A, y, bounds=_bound_pair(bounds, A.shape[1]))
    if not solved.success:
        raise ValueError(f'bounded linear fit failed: {solved.message}')
    return (solved.x, int(np.linalg.matrix_rank(A)),
            np.linalg.svd(A, compute_uv=False), solved.message)


def _solve_sellmeier(spec, data, terms, bounds, initial):
    """Nonlinear resonance fit via scipy least_squares."""
    n_params = 2 * terms
    if initial is None:
        # strengths split a rough n^2-1 budget; resonances seeded small & apart
        budget = max(float(np.mean(data.n) ** 2 - 1), 0.1)
        initial = np.concatenate([np.full(terms, budget / terms),
                                  0.01 * np.arange(1, terms + 1, dtype=float)])
    else:
        initial = np.asarray(initial, dtype=float)
    if initial.shape != (n_params,):
        raise ValueError(f'initial guess needs exactly {n_params} parameters')
    box = _bound_pair(bounds, n_params) or (np.full(n_params, -np.inf),
                                            np.full(n_params, np.inf))

    def mismatch(p):
        delta = spec.evaluate(data.wavelengths, p, terms) - data.n
        if not np.all(np.isfinite(delta)):
            delta = np.full(data.n.shape, 1e12)
        return delta if data.sigma_n is None else delta / data.sigma_n

    solved = optimize.least_squares(mismatch, initial, bounds=box)
    if not solved.success:
        raise ValueError(f'sellmeier1 fit failed: {solved.message}')
    return (solved.x, int(np.linalg.matrix_rank(solved.jac)),
            np.linalg.svd(solved.jac, compute_uv=False), solved.message)


def _diagnose(spec, names, coeffs, data, terms, rank, svals, message,
              allow_exact):
    """Build the FitReport and its warning list."""
    residuals = spec.evaluate(data.wavelengths, coeffs, terms) - data.n
    if not np.all(np.isfinite(residuals)):
        raise ValueError(f'{spec.key} fit produced non-finite residuals')
    dof = int(data.wavelengths.size - len(coeffs))
    if svals is None or len(svals) == 0 or float(np.min(svals)) == 0:
        cond = np.inf
    else:
        cond = float(np.max(svals)) / float(np.min(svals))
    notes = []
    if dof < 0:
        notes.append('fit is underdetermined; coefficients are not unique')
    elif dof == 0:
        notes.append('fit has zero degrees of freedom')
    if rank < len(coeffs):
        notes.append('fit Jacobian or design matrix is rank deficient')
    if cond > 1e12:
        notes.append('fit Jacobian or design matrix is ill conditioned')
    if allow_exact:
        notes.append('allow_exact=True was used')
    return FitReport(
        model=spec.key,
        coefficients={k: float(v) for k, v in zip(names, coeffs)},
        residuals=residuals.copy(),
        max_abs_error=float(np.max(np.abs(residuals))),
        rms_error=float(np.sqrt(np.mean(residuals * residuals))),
        sample_count=int(data.wavelengths.size),
        parameter_count=int(len(coeffs)),
        degrees_of_freedom=dof,
        wavelength_range=data.wavelength_range,
        condition_number=float(cond),
        warnings=tuple(notes),
        success=True,
        message=str(message))


# ---------------------------------------------------------------------------
# material
# ---------------------------------------------------------------------------


def _terms_from_coefficients(spec, coefficients):
    """Infer the term count from an explicit coefficient container."""
    try:
        count = len(coefficients)
    except TypeError:
        count = None
    if spec.key == 'constant':
        return 1
    if spec.key == 'schott':
        return 6
    if count is None:
        return 1 if spec.key == 'sellmeier1' else 2
    if spec.key == 'sellmeier1':
        if count % 2:
            raise ValueError(
                'sellmeier1 coefficients must contain paired B and C values')
        return count // 2
    return count


class FittedMaterial(BaseMaterial):
    """Coefficient-backed material fitted from wavelength + n samples."""

    def __init__(self, name, model, coefficients, *, wavelength_range,
                 terms=None, fit_report=None, extrapolate=False, **kwargs):
        spec = _spec_for(model)
        if terms is None:
            terms = _terms_from_coefficients(spec, coefficients)
        terms = 6 if spec.key == 'schott' else int(terms)
        if terms < 1:
            raise ValueError(f'{spec.key} terms must be at least one')
        names = spec.names_for(terms)
        if isinstance(coefficients, dict):
            coefficients = [coefficients[k] for k in names]
        coeffs = np.asarray(coefficients, dtype=float)
        _require(coeffs.shape == (len(names),),
                 f'expected exactly {len(names)} coefficients')
        _require(np.all(np.isfinite(coeffs)), 'coefficients must all be finite')

        lo, hi = wavelength_range
        _require(not (lo is None or hi is None or lo <= 0 or hi <= 0 or lo > hi),
                 'wavelength_range must be positive and ordered')
        metadata = dict(kwargs.pop('metadata', {}) or {})
        if extrapolate:
            metadata['extrapolate_wavelength'] = True
        metadata.update(model=spec.key, terms=terms,
                        coefficients={k: float(v) for k, v in zip(names, coeffs)},
                        extrapolate=bool(extrapolate))
        super().__init__(name, wavelength_range=(float(lo), float(hi)),
                         metadata=metadata, **kwargs)
        self.model, self._spec, self.terms = spec.key, spec, terms
        self.parameter_names, self.coefficients = names, coeffs.copy()
        self.coefficient_table = metadata['coefficients']
        self.extrapolate, self.fit_report = bool(extrapolate), fit_report

    @classmethod
    def from_samples(cls, name, wavelengths, n, *, model='cauchy', terms=None,
                     sigma_n=None, max_abs_error=None, rms_error=None,
                     extrapolate=False, allow_exact=False, bounds=None,
                     initial=None, **kwargs):
        """Fit a model from measured wavelength + n samples."""
        as_f64 = lambda v: None if v is None else np.asarray(v, dtype=float)  # NOQA
        data = MaterialData(as_f64(wavelengths), as_f64(n),
                            sigma_n=as_f64(sigma_n),
                            metadata=kwargs.get('metadata'))
        wvls = data.wavelengths
        _require(wvls.ndim == 1 and wvls.size > 0,
                 'wavelengths must be a non-empty 1D array')
        _require(data.n.shape == wvls.shape,
                 'wavelengths and n must agree in length')
        _require(data.sigma_n is None or data.sigma_n.shape == wvls.shape,
                 'wavelengths and sigma_n must agree in length')
        for label, column in (('wavelengths', wvls), ('n', data.n),
                              ('sigma_n', data.sigma_n)):
            _require(column is None or np.all(np.isfinite(column)),
                     f'{label} must be entirely finite')
        _require(not np.any(wvls <= 0) and not np.any(np.diff(wvls) <= 0),
                 'wavelengths must be strictly increasing, without duplicates')

        spec = _spec_for(model)
        terms = spec.resolve_terms(terms, data.wavelengths.size)
        names = spec.names_for(terms)
        if data.wavelengths.size < len(names) and not allow_exact:
            raise ValueError(
                f'{spec.key} fit is underdetermined: {data.wavelengths.size} '
                f'samples for {len(names)} parameters; pass allow_exact=True '
                'to request an exact underdetermined fit')
        if spec.design is not None:
            coeffs, rank, svals, message = _solve_linear(spec, data, terms, bounds)
        else:
            coeffs, rank, svals, message = _solve_sellmeier(
                spec, data, terms, bounds, initial)
            resonances = coeffs[terms:]
            poles = np.sqrt(resonances[resonances > 0])
            lo, hi = data.wavelength_range
            if np.any((poles >= lo) & (poles <= hi)):
                raise ValueError(
                    f'sellmeier1 fit for {name} has a pole inside the fitted '
                    'wavelength range')
        report = _diagnose(spec, names, coeffs, data, terms, rank, svals,
                           message, bool(allow_exact))
        for bound_name, bound in (('max_abs_error', max_abs_error),
                                  ('rms_error', rms_error)):
            if bound is not None and getattr(report, bound_name) > bound:
                raise ValueError(
                    f'{spec.key} fit {bound_name} '
                    f'{getattr(report, bound_name):g} exceeds requested '
                    f'{float(bound):g}')
        return cls(name, spec.key, coeffs, wavelength_range=data.wavelength_range,
                   terms=terms, fit_report=report, extrapolate=extrapolate,
                   **kwargs)

    def _check_range(self, wvl):
        if self.extrapolate:
            return
        lo, hi = self.wavelength_range
        if np.any((wvl < lo) | (wvl > hi)):
            raise MaterialRangeError(
                f'wavelength for {self.name} outside material range '
                f'{lo:g} to {hi:g} um (fitted model)')

    def __call__(self, wvl_um):
        """Alias for n(wvl_um)."""
        return self.n(wvl_um)

    def n(self, wvl_um, temperature=None):
        """Real refractive index from the fitted model."""
        self._check_range(wvl_um)
        return self._spec.evaluate(wvl_um, self.coefficients, self.terms)

    def k(self, wvl_um, temperature=None):
        """Zero extinction (real-index fits)."""
        self._check_range(wvl_um)
        return self._missing_k(wvl_um)


def from_samples(name, wavelengths, n, *, k=None, model=None, method='linear',
                 **kwargs):
    """Tabulated material (model=None) or fitted model from samples."""
    if model is None:
        return TabulatedMaterial(name, wavelengths, n, k=k, method=method,
                                 **kwargs)
    _require(k is None, 'fitted materials do not yet accept k samples')
    return FittedMaterial.from_samples(name, wavelengths, n, model=model,
                                       **kwargs)


def fit_material(name, wavelengths, n, **kwargs):
    """Fit a material model from measured wavelength + n samples."""
    return FittedMaterial.from_samples(name, wavelengths, n, **kwargs)
