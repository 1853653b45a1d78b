"""Finite-difference tolerance sensitivity and Monte Carlo tools.

Counterpart of ``prysm_tpu/x/raytracing/tolerance.py``.  Perturbation
distributions live in a registry (:data:`_DISTRIBUTIONS`) mapping a name to
its sampler factory and variance rule; the public ``normal`` /
``uniform`` / ``triangular`` constructors are thin registry lookups.
Draws come from ``np.random.default_rng(seed)`` on the host, as in the JAX
package, so one seed gives the same draws in both; each merit evaluation
traces on ``config.device``.
"""
from dataclasses import dataclass, field

import numpy as np

from .design import _TraceCache
from .sensitivity import central_difference

_PREC = np.float64


def _as_lens(lensdata):
    """The LensData spine, unwrapping a containing OpticalSystem."""
    return getattr(lensdata, 'lens', lensdata)


def _resolve_slot(lensdata, category, surface, component=None):
    """Resolve a (category, surface) pair to one LensData DOF slot.

    component selects one axis of a tilt/decenter triple (0/1/2).
    """
    spine = _as_lens(lensdata)
    hits = spine._category_slots(category, surface)
    if component is not None:
        hits = [h for h in hits if h[2] == int(component)]
    if len(hits) != 1:
        suffix = '' if component is None else f' component {component}'
        raise ValueError(
            f'perturbation target {category!r} on surface {surface!r}'
            f'{suffix} resolved to {len(hits)} DOFs; tolerancing wants '
            'exactly one scalar DOF (for tilt/decenter pass '
            'component=0/1/2)')
    return hits[0]


# distribution name -> (sampler factory (nominal, width) -> rng sampler,
#                       variance rule width -> variance)
_DISTRIBUTIONS = {
    'normal': (lambda nom, w: (lambda rng: float(rng.normal(nom, w))),
               lambda w: w * w),
    'uniform': (lambda nom, w: (lambda rng: float(rng.uniform(nom - w,
                                                              nom + w))),
                lambda w: w * w / 3.0),
    'triangular': (lambda nom, w: (lambda rng: float(rng.triangular(
        nom - w, nom, nom + w))), lambda w: w * w / 6.0),
}


class Perturbation:
    """A LensData DOF slot plus a sampling distribution."""

    __slots__ = ('name', 'lensdata', 'slot', 'sampler', 'nominal', 'step',
                 'variance', 'distribution')

    def __init__(self, lensdata, slot, sampler, nominal, step, *, variance,
                 distribution, name=''):
        self.name, self.distribution = str(name), str(distribution)
        self.lensdata = _as_lens(lensdata)
        self.slot, self.sampler = slot, sampler
        self.nominal, self.step = float(nominal), float(step)
        self.variance = float(variance)
        if self.variance < 0.0 or not bool(np.isfinite(self.variance)):
            raise ValueError(
                'a perturbation variance must be finite and nonnegative')

    def set(self, value):
        """Write the targeted DOF and invalidate the compiled system."""
        self.lensdata._set_slot_value(self.slot, value)
        self.lensdata._invalidate()

    def sample(self, rng):
        """Draw one sample from this perturbation's distribution."""
        return float(self.sampler(rng))

    def reset(self):
        """Return the targeted DOF to its nominal value."""
        self.set(self.nominal)

    def __repr__(self):
        return (f'Perturbation(name={self.name!r}, '
                f'nominal={self.nominal:g}, step={self.step:g})')

    @classmethod
    def _from_registry(cls, kind, lensdata, category, surface, width,
                       name, component):
        spine = _as_lens(lensdata)
        slot = _resolve_slot(spine, category, surface, component)
        anchor = float(spine._slot_value(slot))
        make_sampler, variance_of = _DISTRIBUTIONS[kind]
        return cls(spine, slot, make_sampler(anchor, width), anchor, width,
                   variance=variance_of(width), distribution=kind, name=name)

    @classmethod
    def normal(cls, lensdata, category, surface, sigma, name='',
               component=None):
        """Normal(nominal, sigma); sigma is absolute."""
        return cls._from_registry('normal', lensdata, category, surface,
                                  float(sigma), name, component)

    @classmethod
    def normal_relative(cls, lensdata, category, surface, sigma_rel,
                        name='', component=None):
        """Normal with sigma = sigma_rel * abs(nominal)."""
        spine = _as_lens(lensdata)
        slot = _resolve_slot(spine, category, surface, component)
        sigma = abs(float(spine._slot_value(slot))) * float(sigma_rel)
        return cls._from_registry('normal', spine, category, surface,
                                  sigma, name, component)

    @classmethod
    def uniform(cls, lensdata, category, surface, half_width, name='',
                component=None):
        """Uniform over (nominal - hw, nominal + hw)."""
        return cls._from_registry('uniform', lensdata, category, surface,
                                  abs(float(half_width)), name, component)

    @classmethod
    def triangular(cls, lensdata, category, surface, half_width, name='',
                   component=None):
        """Triangular centered on nominal with half-width hw."""
        return cls._from_registry('triangular', lensdata, category, surface,
                                  abs(float(half_width)), name, component)


def operand_as_merit(operand):
    """Wrap a design operand as a one-argument merit(system) -> float."""
    return lambda system: float(operand(system, _TraceCache(system)))


@dataclass
class SensitivityTable:
    """Per-parameter centered-difference sensitivity report."""

    rows: list
    merit_nominal: float

    def __post_init__(self):
        self.rows = list(self.rows)
        self.merit_nominal = float(self.merit_nominal)

    def names(self):
        """Row names, in table order."""
        return [entry['name'] for entry in self.rows]

    def sensitivities(self):
        """Centered dM/dx per row."""
        return np.array([entry['sensitivity'] for entry in self.rows])

    def worst_delta_per_row(self):
        """max(abs(delta_plus), abs(delta_minus)) per row."""
        return np.array([max(abs(r['delta_plus']), abs(r['delta_minus']))
                         for r in self.rows])

    def __repr__(self):
        head = (f'{"name":<20} {"nominal":>14} {"step":>12} '
                f'{"d_plus":>12} {"d_minus":>12} {"dM/dx":>12}')
        body = [f'SensitivityTable(merit_nominal={self.merit_nominal:.6g}):',
                head]
        body += [
            f'{r["name"]:<20} {r["nominal"]:>14.6g} '
            f'{r["step"]:>12.6g} {r["delta_plus"]:>12.6g} '
            f'{r["delta_minus"]:>12.6g} {r["sensitivity"]:>12.6g}'
            for r in self.rows
        ]
        return '\n'.join(body)


def _sensitivity_row(system, perturbation, merit, m_nom, h):
    if h == 0.0:
        return {'name': perturbation.name, 'nominal': perturbation.nominal,
                'step': 0.0, 'merit_nominal': m_nom, 'merit_plus': m_nom,
                'merit_minus': m_nom, 'delta_plus': 0.0, 'delta_minus': 0.0,
                'sensitivity': 0.0}

    def probe(value):
        perturbation.set(value)
        return merit(system)

    try:
        m_plus, m_minus = central_difference(probe, perturbation.nominal, h)
    finally:
        perturbation.set(perturbation.nominal)
    return {'name': perturbation.name, 'nominal': perturbation.nominal,
            'step': h, 'merit_nominal': m_nom, 'merit_plus': m_plus,
            'merit_minus': m_minus, 'delta_plus': m_plus - m_nom,
            'delta_minus': m_minus - m_nom,
            'sensitivity': (m_plus - m_minus) / (2.0 * h)}


def sensitivity_table(system, perturbations, merit, *, step=None):
    """Centered-difference sensitivity of merit w.r.t. each perturbation.

    Default h is the perturbation's own step (one sigma / half-width);
    step= overrides globally.  Parameters are restored afterward.
    """
    baseline = float(merit(system))
    rows = [
        _sensitivity_row(system, p, merit, baseline,
                         float(step) if step is not None else p.step)
        for p in perturbations
    ]
    return SensitivityTable(rows, merit_nominal=baseline)


@dataclass
class MonteCarloResult:
    """Outcome of a tolerancing Monte Carlo trial run."""

    merits: np.ndarray
    sampled_x: np.ndarray
    nominals: np.ndarray
    names: list = field(default_factory=list)

    def __post_init__(self):
        self.merits = np.asarray(self.merits, dtype=_PREC)
        if self.sampled_x is not None:
            self.sampled_x = np.asarray(self.sampled_x, dtype=_PREC)
        self.nominals = np.asarray(self.nominals, dtype=_PREC)
        self.names = list(self.names)

    @property
    def n_trials(self):
        """Number of trials run."""
        return int(self.merits.shape[0])

    def summary(self):
        """n_trials/min/max/mean/std/median/p95/p99 over the merits."""
        m = self.merits
        stats = {'n_trials': self.n_trials,
                 'min': float(m.min()), 'max': float(m.max()),
                 'mean': float(m.mean()), 'std': float(m.std()),
                 'median': float(np.median(m))}
        stats['p95'], stats['p99'] = (float(np.percentile(m, q))
                                      for q in (95, 99))
        return stats

    def yield_at(self, threshold):
        """Fraction of trials with merit <= threshold."""
        return float((self.merits <= float(threshold)).mean())

    def __repr__(self):
        stats = self.summary()
        return (f'MonteCarloResult(n={stats["n_trials"]}, '
                f'mean={stats["mean"]:.6g}, std={stats["std"]:.6g}, '
                f'p95={stats["p95"]:.6g})')


def monte_carlo(system, perturbations, merit, n_trials, *,
                seed=None, record_samples=False):
    """Run a Monte Carlo tolerancing simulation; restores nominals."""
    perturbations = list(perturbations)
    rng = np.random.default_rng(seed)
    n_trials = int(n_trials)
    merits = np.empty(n_trials, dtype=_PREC)
    sampled = (np.empty((n_trials, len(perturbations)), dtype=_PREC)
               if record_samples else None)
    try:
        for trial in range(n_trials):
            for i, p in enumerate(perturbations):
                drawn = p.sample(rng)
                p.set(drawn)
                if record_samples:
                    sampled[trial, i] = drawn
            merits[trial] = float(merit(system))
    finally:
        for p in perturbations:
            p.reset()
    return MonteCarloResult(merits, sampled,
                            [p.nominal for p in perturbations],
                            [p.name for p in perturbations])


__all__ = [
    'Perturbation', 'SensitivityTable', 'sensitivity_table',
    'MonteCarloResult', 'monte_carlo', 'operand_as_merit',
]
