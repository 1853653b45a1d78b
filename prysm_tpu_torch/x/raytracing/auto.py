"""Automatic first-order design models (Ritchey-Chretien closure engine).

Counterpart of ``prysm_tpu/x/raytracing/auto.py`` (host numpy only): a
declarative **rule table** — each algebraic identity of the two-mirror
system is one ``_Rule`` row (inputs, output, evaluator, guard) — run to
fixpoint by a tiny propagation engine.  Quantities, branch handling
(two-root forms) and the mirror-figure formulas are the JAX package's.
"""
import math
from dataclasses import dataclass

import numpy as _np


# canonical quantity names; `unresolved` reports in this order
_NAMES = (
    'efl', 'bfl', 'separation', 'primary_focal_length',
    'primary_to_focus', 'secondary_magnification',
    'primary_radius', 'secondary_radius',
)

_SINGULAR = object()  # sentinel an evaluator returns to flag a singularity


@dataclass(frozen=True)
class _Rule:
    """One algebraic closure: out = fn(*inputs), with an optional
    freshness guard (fire only while `unless` is still unknown)."""

    out: str
    inputs: tuple
    fn: callable
    note: str
    singular: str = ''
    unless: str = ''


def _div(num, den):
    """Guarded division; the _SINGULAR sentinel marks a degenerate rule."""
    if abs(den) <= _div.atol:
        return _SINGULAR
    return num / den


_div.atol = 1e-12  # rebound per model instance before each closure pass


def _build_rules():
    """The two-mirror identity table.

    Symbols: F=efl, B=bfl, D=separation, f1=primary focal length,
    p=primary-to-focus (B-D), M=secondary magnification, R1/R2 mirror
    radii.
    """
    R = _Rule
    return (
        # primary mirror: R1 = 2 f1
        R('primary_focal_length', ('primary_radius',),
          lambda R1: R1 / 2.0, 'primary_radius = 2*primary_focal_length'),
        R('primary_radius', ('primary_focal_length',),
          lambda f1: 2.0 * f1, 'primary_radius = 2*primary_focal_length'),
        # back-focus bookkeeping: p = B - D
        R('primary_to_focus', ('bfl', 'separation'),
          lambda B, D: B - D, 'primary_to_focus = bfl - separation'),
        R('bfl', ('primary_to_focus', 'separation'),
          lambda p, D: p + D, 'bfl = primary_to_focus + separation'),
        R('separation', ('bfl', 'primary_to_focus'),
          lambda B, p: B - p, 'separation = bfl - primary_to_focus'),
        R('separation',
          ('efl', 'primary_to_focus', 'secondary_magnification'),
          lambda F, p, M: _div(F - p, M + 1.0),
          'separation = (efl-primary_to_focus)/(magnification+1)',
          singular='secondary magnification is negative one'),
        # magnification triangle: F = -f1 M
        R('primary_focal_length', ('efl', 'secondary_magnification'),
          lambda F, M: _div(-F, M),
          'primary_focal_length = -efl/secondary_magnification',
          singular='secondary magnification is zero'),
        R('efl', ('primary_focal_length', 'secondary_magnification'),
          lambda f1, M: -f1 * M,
          'efl = -primary_focal_length*secondary_magnification'),
        R('secondary_magnification', ('efl', 'primary_focal_length'),
          lambda F, f1: _div(-F, f1),
          'secondary_magnification = -efl/primary_focal_length',
          singular='primary focal length is zero'),
        # B = F - M D and F = -f1 M close M without F: M = -B/(D+f1)
        R('secondary_magnification',
          ('bfl', 'separation', 'primary_focal_length'),
          lambda B, D, f1: _div(-B, D + f1),
          'magnification = -bfl/(separation+primary_focal_length)',
          singular='separation + primary focal length is zero'),
        # secondary mirror: R2 = -2B/(M-1)
        R('secondary_radius', ('bfl', 'secondary_magnification'),
          lambda B, M: _div(-2.0 * B, M - 1.0),
          'secondary_radius = -2*bfl/(magnification-1)',
          singular='secondary magnification is one'),
        R('bfl', ('secondary_radius', 'secondary_magnification'),
          lambda R2, M: -0.5 * R2 * (M - 1.0),
          'bfl = -secondary_radius*(magnification-1)/2'),
        R('secondary_magnification', ('secondary_radius', 'bfl'),
          lambda R2, B: (_SINGULAR if (q := _div(-2.0 * B, R2)) is _SINGULAR
                         else 1.0 + q),
          'magnification = 1 - 2*bfl/secondary_radius',
          singular='secondary radius is zero'),
        # canonical triple closures: F = B + M D
        R('efl', ('bfl', 'separation', 'secondary_magnification'),
          lambda B, D, M: B + M * D,
          'efl = bfl + magnification*separation'),
        R('bfl', ('efl', 'separation', 'secondary_magnification'),
          lambda F, D, M: F - M * D,
          'bfl = efl - magnification*separation'),
        R('separation', ('efl', 'bfl', 'secondary_magnification'),
          lambda F, B, M: _div(F - B, M),
          'separation = (efl-bfl)/magnification',
          singular='secondary magnification is zero'),
        R('secondary_magnification', ('efl', 'bfl', 'separation'),
          lambda F, B, D: _div(F - B, D),
          'magnification = (efl-bfl)/separation',
          singular='separation is zero'),
        # R2 with two canonical values closes the third before B or M
        R('secondary_magnification',
          ('efl', 'separation', 'secondary_radius'),
          lambda F, D, R2: _div(R2 - 2.0 * F, R2 - 2.0 * D),
          'secondary radius with efl and separation',
          singular='secondary-radius closure is degenerate', unless='bfl'),
        R('separation', ('efl', 'bfl', 'secondary_radius'),
          lambda F, B, R2: _div(-R2 * (F - B), 2.0 * B - R2),
          'secondary radius with efl and bfl',
          singular='secondary-radius closure is degenerate',
          unless='separation'),
        R('efl', ('bfl', 'separation', 'secondary_radius'),
          lambda B, D, R2: B + D - 2.0 * D * B / R2,
          'secondary radius with bfl and separation', unless='efl'),
        # D, f1, R2 close F directly (both radii + spacing prescriptions)
        R('efl',
          ('separation', 'primary_focal_length', 'secondary_radius'),
          lambda D, f1, R2: _div(R2 * f1, 2.0 * (f1 + D) - R2),
          'efl from separation and both mirror radii',
          singular='mirror-radius closure is degenerate', unless='efl'),
    )


_RULES = _build_rules()


@dataclass(frozen=True)
class RCPrescription:
    """Complete Ritchey-Chretien mirror figure prescription."""

    primary_curvature: float
    secondary_curvature: float
    primary_conic: float
    secondary_conic: float


class RitcheyChretien:
    """Partially determined Ritchey-Chretien first-order constraint model.

    Supply any consistent subset of the supported quantities; the rule
    engine closes everything algebraically determined, reports unresolved
    values and remaining degrees of freedom, and emits mirror figures or
    a LensData prescription once the canonical (efl, bfl, separation)
    triple is complete.
    """

    def __init__(self, *, efl=None, bfl=None, separation=None,
                 primary_focal_length=None, primary_to_focus=None,
                 secondary_magnification=None,
                 primary_radius=None, secondary_radius=None,
                 rtol=1e-10, atol=1e-12):
        self.rtol, self.atol = float(rtol), float(atol)
        self._values = dict.fromkeys(_NAMES)
        self._origins = {}
        given = dict(
            efl=efl, bfl=bfl, separation=separation,
            primary_focal_length=primary_focal_length,
            primary_to_focus=primary_to_focus,
            secondary_magnification=secondary_magnification,
            primary_radius=primary_radius,
            secondary_radius=secondary_radius)
        self._supplied = {k: float(v) for k, v in given.items()
                         if v is not None}
        for name, value in self._supplied.items():
            if math.isfinite(value) is False:
                raise ValueError(f'{name} must be finite')
            self._record(name, value, f'input {name}')
        self._propagate()
        self._reject_singular_geometry()

    # -- the propagation engine --
    def _record(self, name, value, origin):
        """Store a quantity; a conflicting re-derivation is an error."""
        value = float(value)
        held = self._values[name]
        if held is None:
            self._values[name] = value
            self._origins[name] = origin
            return True
        agree = math.isclose(held, value, rel_tol=self.rtol,
                             abs_tol=self.atol)
        if not agree:
            raise ValueError(
                f'inconsistent Ritchey-Chretien constraints for {name}: '
                f'{held:g} from {self._origins[name]} conflicts with '
                f'{value:g} from {origin}')
        return False

    def _known(self, *names):
        return all(self._values[n] is not None for n in names)

    def _propagate(self):
        """Run the rule table to fixpoint."""
        _div.atol = self.atol
        progressed = True
        while progressed:
            progressed = False
            for rule in _RULES:
                if not self._known(*rule.inputs):
                    continue
                if rule.unless and self._known(rule.unless):
                    continue
                args = [self._values[n] for n in rule.inputs]
                result = rule.fn(*args)
                if result is _SINGULAR:
                    raise ValueError(
                        'singular Ritchey-Chretien constraint: '
                        f'{rule.singular or rule.note}')
                progressed |= self._record(rule.out, result, rule.note)

    def _reject_singular_geometry(self):
        if not self.complete:
            return
        F, B, D = self.efl, self.bfl, self.separation  # canonical triple
        checks = ((F, 'efl'), (D, 'separation'), (F - B, 'efl-bfl'),
                  (F - B - D, 'efl-bfl-separation'))
        for value, label in checks:
            if abs(value) <= self.atol:
                raise ValueError(
                    f'singular Ritchey-Chretien geometry: {label} is zero')

    # -- state inspection --
    @property
    def complete(self):
        return self._known(*_NAMES[:3])

    @property
    def unresolved(self):
        return tuple(n for n in _NAMES if self._values[n] is None)

    @property
    def degrees_of_freedom(self):
        """Remaining canonical degrees of freedom after supplied constraints.

        Each supplied quantity contributes one linearized row in the
        (F, B, D) tangent space; the rank of the stack is how many of the
        three canonical values it pins.
        """
        if not self._supplied:
            return 3
        F = self._values['efl'] or 100.0
        B = self._values['bfl'] or 20.0
        D = self._values['separation'] or 30.0
        # per-quantity tangent rows in (F, B, D) space
        tangent_row = {
            'efl': lambda q: (1.0, 0.0, 0.0),
            'bfl': lambda q: (0.0, 1.0, 0.0),
            'separation': lambda q: (0.0, 0.0, 1.0),
            'secondary_magnification': lambda q: (1.0, -1.0, -q),
            'primary_focal_length': lambda q: (D + q, -q, F),
            'primary_radius': lambda q: (D + q / 2.0, -q / 2.0, F),
            'primary_to_focus': lambda q: (0.0, 1.0, -1.0),
            'secondary_radius': lambda q: (q, 2.0 * D - q, 2.0 * B - q),
        }
        stack = _np.asarray(
            [tangent_row[name](value)
             for name, value in self._supplied.items()], dtype=float)
        rank = int(_np.linalg.matrix_rank(stack, tol=self.atol))
        return max(0, 3 - rank)  # never negative even if over-specified

    # -- discrete branches --
    def _branch_triples(self):
        """(F, B, D) candidates for the two-root three-constraint forms,
        or None when the model is continuously underdetermined."""
        v = self._values
        if self._known('efl', 'primary_to_focus', 'secondary_radius'):
            F = v['efl']
            p, R2 = v['primary_to_focus'], v['secondary_radius']
            # quadratic in B: B^2 - (p+R2) B + R2(F+p)/2 = 0
            roots = _np.roots((1.0, -(p + R2), 0.5 * R2 * (F + p)))
            return [(F, float(r.real), float(r.real) - p) for r in roots
                    if abs(float(r.imag)) <= self.atol]
        if self._known('primary_focal_length', 'primary_to_focus',
                       'secondary_radius'):
            f1 = v['primary_focal_length']
            p, R2 = v['primary_to_focus'], v['secondary_radius']
            # quadratic in D: 2D^2 + 2(p+f1-R2)D + 2pf1 - R2(p+f1) = 0
            roots = _np.roots(
                (2.0, 2.0 * (p + f1 - R2), 2.0 * p * f1 - R2 * (p + f1)))
            triples = []
            for r in roots:
                if abs(float(r.imag)) > self.atol:
                    continue
                D = float(r.real)
                B = p + D
                if abs(f1 + D) <= self.atol:
                    continue
                triples.append((f1 * B / (f1 + D), B, D))
            return triples
        return None

    def _branch_satisfies_inputs(self, candidate):
        """Does a branch reproduce every originally supplied constraint?"""
        return all(
            math.isclose(getattr(candidate, name), supplied,
                         rel_tol=self.rtol, abs_tol=self.atol)
            for name, supplied in self._supplied.items())

    @property
    def solutions(self):
        """All discrete complete solutions implied by the supplied inputs.

        A complete model returns itself; continuously underdetermined
        models return (); the two-branch three-constraint forms return
        every branch consistent with the inputs rather than silently
        choosing one.
        """
        if self.complete:
            return (self,)
        triples = self._branch_triples()
        if triples is None:
            return ()
        out = []
        for F, B, D in triples:
            try:
                candidate = type(self)(
                    efl=F, bfl=B, separation=D, rtol=self.rtol,
                    atol=self.atol)
            except ValueError:
                continue
            if self._branch_satisfies_inputs(candidate):
                out.append(candidate)
        out.sort(key=lambda m: (m.separation, m.bfl, m.efl))
        return tuple(out)

    # -- outputs --
    def prescription(self):
        """Complete mirror curvatures/conics; partial models are rejected."""
        if not self.complete:
            branches = self.solutions
            hint = (f'; {len(branches)} discrete solutions are available '
                    'from .solutions' if branches else '')
            raise ValueError(
                'Ritchey-Chretien model is partially determined; '
                'unresolved: ' + ', '.join(self.unresolved) + hint)
        B, D, M = self.bfl, self.separation, self.secondary_magnification
        # classical RC aplanatic conics (e.g. Schroeder, Astronomical Optics)
        ratio = B / D
        k1 = -1.0 - 2.0 / M ** 3 * ratio
        k2 = -1.0 - 2.0 / (M - 1.0) ** 3 * (M * (2.0 * M - 1.0) + ratio)
        return RCPrescription(1.0 / self.primary_radius,
                              1.0 / self.secondary_radius, k1, k2)

    def to_lensdata(self, *, primary_aperture=None, secondary_aperture=None):
        """A two-mirror LensData for a complete model."""
        from .lensdata import LensData
        from .surfaces import Conic

        figures = self.prescription()
        lens = LensData()
        lens.add(Conic(figures.primary_curvature, figures.primary_conic),
                 typ='refl', thickness=self.separation,
                 aperture=primary_aperture)
        lens.add(Conic(figures.secondary_curvature, figures.secondary_conic),
                 typ='refl', thickness=self.bfl,
                 aperture=secondary_aperture)
        return lens

    def __getattr__(self, name):
        if name in _NAMES:  # quantities read straight off the value table
            return self._values[name]
        raise AttributeError(name)

    def __repr__(self):
        known = ', '.join(
            f'{n}={v:g}' for n, v in self._values.items() if v is not None)
        return (f'RitcheyChretien({known}; '
                f'degrees_of_freedom={self.degrees_of_freedom})')


__all__ = ['RitcheyChretien', 'RCPrescription']
