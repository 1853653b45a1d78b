"""Stop-condition combinators for optimizer driver loops.

Counterpart of ``prysm_tpu/x/optym/governors.py``.  Architecture here is a
small functional core: every concrete governor is a predicate closure over
the stream of :class:`StepRecord` observations, installed into a shared
:class:`Governor` shell.  Governors compose with ``|`` (stop on first) and
``&`` (stop when all have fired), or the explicit ``AnyGovernor`` /
``AllGovernor`` wrappers.

This layer is host control flow by design: tensors inside records are
reduced to Python floats only at decision points (``to_host``), so nothing
here reads the card back inside an optimizer's step.
"""
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from .problem import to_host


@dataclass
class StepRecord:
    """Observation of one completed optimizer step.

    ``x``/``g`` may alias optimizer buffers; snapshot before constructing a
    record if the optimizer mutates in place.
    """

    optimizer: object
    iteration: int
    x: object
    f: float
    g: object
    x_next: object
    metadata: dict = None

    def __post_init__(self):
        self.iteration = int(self.iteration)
        self.f = float(self.f)
        self.metadata = dict(self.metadata) if self.metadata else {}


class GovernorDecision(NamedTuple):
    """Verdict from a governor: whether to stop, and why."""

    stop: bool = False
    success: bool = False
    message: str = ''

    def __bool__(self):
        """Truthiness is the stop flag."""
        return self.stop


CONTINUE = GovernorDecision()


def _halt(message, success=True):
    return GovernorDecision(True, success, message)


@dataclass
class OptimizationResult:
    """Terminal state of a governed optimizer run."""

    x: object
    decision: GovernorDecision
    records: list
    optimizer: object = None
    success: bool = field(init=False)
    message: str = field(init=False)
    nit: int = field(init=False)
    nfev: int = field(init=False)
    njev: int = field(init=False)

    def __post_init__(self):
        self.success = bool(self.decision.success)
        self.message = self.decision.message
        self.nit = len(self.records)
        self.nfev = getattr(self.optimizer, 'nfev', None)
        self.njev = getattr(self.optimizer, 'njev', None)

    def __repr__(self):
        """Compact representation."""
        return (f'OptimizationResult(success={self.success}, '
                f'message={self.message!r}, nit={self.nit})')


class Governor:
    """Base stop condition; subclasses install a predicate via _watch()."""

    _rule = None

    def _watch(self, rule):
        self._rule = rule
        return self

    def observe(self, record):
        """Feed one step record; returns a GovernorDecision."""
        if self._rule is None:
            return CONTINUE
        verdict = self._rule(record)
        return verdict if verdict is not None else CONTINUE

    def __or__(self, other):
        return AnyGovernor([self, other])

    def __and__(self, other):
        return AllGovernor([self, other])


class AnyGovernor(Governor):
    """Stop as soon as any member governor stops."""

    def __init__(self, governors):
        members = tuple(governors)

        def rule(record):
            verdicts = [member.observe(record) for member in members]
            return next((v for v in verdicts if v.stop), None)

        self.governors = members
        self._watch(rule)


class AllGovernor(Governor):
    """Stop once every member governor has stopped at least once."""

    def __init__(self, governors):
        members = tuple(governors)
        fired = {}

        def rule(record):
            for idx, member in enumerate(members):
                verdict = member.observe(record)
                if verdict.stop:
                    fired[idx] = verdict
            if len(fired) == len(members) and members:
                return GovernorDecision(
                    True,
                    all(v.success for v in fired.values()),
                    '; '.join(v.message for v in fired.values() if v.message))
            return None

        self.governors = members
        self._watch(rule)


def _require_nonnegative(value, label):
    if value < 0:
        raise ValueError(f'{label} must be nonnegative')
    return value


def _reduce_norm(vector, order):
    arr = to_host(vector)
    if arr.size == 0:
        return 0.0
    if order in (np.inf, 'inf'):
        return float(np.abs(arr).max())
    return float(np.linalg.norm(arr.ravel(), ord=order))


class MaxIterations(Governor):
    """Stop after ``n`` accepted optimizer steps (not a success condition)."""

    def __init__(self, n):
        self.n = _require_nonnegative(int(n), 'n')
        self._watch(lambda rec: _halt('maximum iterations reached', False)
                    if rec.iteration >= self.n else None)


class MaxEvaluations(Governor):
    """Stop once the optimizer reports ``nfev`` at or beyond ``n``."""

    def __init__(self, n):
        self.n = _require_nonnegative(int(n), 'n')

        def rule(record):
            evals = getattr(record.optimizer, 'nfev', None)
            if evals is not None and evals >= self.n:
                return _halt('maximum function evaluations reached', False)
            return None

        self._watch(rule)


class FunctionTolerance(Governor):
    """Stop when consecutive objective values agree to within ``ftol``.

    With ``relative=True`` the tolerance scales by max(1, |f|) of the pair.
    An optimizer that knows its post-step value can supply it as
    ``metadata['f_next']``, letting the governor fire on the very first
    record instead of needing two.
    """

    def __init__(self, ftol, relative=True):
        self.ftol = _require_nonnegative(float(ftol), 'ftol')
        self.relative = bool(relative)
        memory = []  # last seen objective value, if any

        def rule(record):
            f_now = float(record.metadata.get('f_next', record.f))
            if memory:
                f_before = memory[0]
            elif 'f_next' in record.metadata:
                f_before = record.f
            else:
                memory.append(f_now)
                return None
            memory[:] = [f_now]
            span = max(1.0, abs(f_before), abs(f_now)) if self.relative else 1.0
            if abs(f_before - f_now) <= self.ftol * span:
                return _halt('function tolerance reached')
            return None

        self._watch(rule)


class GradientTolerance(Governor):
    """Stop when the gradient norm falls to ``gtol`` or below."""

    def __init__(self, gtol, norm=np.inf):
        self.gtol = _require_nonnegative(float(gtol), 'gtol')
        self.norm = norm
        self._watch(lambda rec: _halt('gradient tolerance reached')
                    if _reduce_norm(rec.g, self.norm) <= self.gtol else None)


class StepTolerance(Governor):
    """Stop when the iterate displacement falls to ``xtol`` or below."""

    def __init__(self, xtol, relative=True, norm=np.inf):
        self.xtol = _require_nonnegative(float(xtol), 'xtol')
        self.relative = bool(relative)
        self.norm = norm

        def rule(record):
            moved = _reduce_norm(to_host(record.x_next) - to_host(record.x),
                                 self.norm)
            span = max(1.0, _reduce_norm(record.x, self.norm)) if self.relative else 1.0
            if moved <= self.xtol * span:
                return _halt('step tolerance reached')
            return None

        self._watch(rule)


class ConstraintTolerance(Governor):
    """Stop when the reported constraint violation falls to ``tol`` or below.

    Looks in ``metadata['constraint_violation']`` first, then for a
    ``constraint_violation`` attribute on the optimizer.
    """

    def __init__(self, tol):
        self.tol = _require_nonnegative(float(tol), 'tol')

        def rule(record):
            v = record.metadata.get('constraint_violation')
            if v is None:
                v = getattr(record.optimizer, 'constraint_violation', None)
            if v is not None and float(v) <= self.tol:
                return _halt('constraint tolerance reached')
            return None

        self._watch(rule)
