"""Gradient refinement of coating stacks.

Counterpart of ``prysm_tpu/x/coatings/refine.py``.  Two drivers over the
shared :class:`CoatingProblem`: bounded quasi-Newton (``PrysmLBFGSB``, whose
iterate and bounds stay on the stack's device) and constrained damped
least squares (host float64), selected by a driver table.
"""
from dataclasses import dataclass

import numpy as onp
import torch

from ...conf import numpy_dtype
from ..optym.optimizers import run_until
from ..optym.lbfgsb import PrysmLBFGSB
from ..optym.least_squares import damped_least_squares
from ..optym.governors import (AnyGovernor, MaxIterations,
                               FunctionTolerance, GradientTolerance)

from .merit import as_merit
from .problem import CoatingProblem

__all__ = ['CoatingResult', 'refine']


@dataclass
class CoatingResult:
    """Outcome of a coating refinement."""

    stack: object
    x: object
    merit: float
    success: bool
    nit: int
    optimizer_result: object

    def __repr__(self):
        """Compact representation."""
        return (f'CoatingResult(merit={self.merit:.3e}, nit={self.nit}, '
                f'success={self.success})')


def _thickness_box(n, bounds, min_thickness, max_thickness):
    """(lower, upper) per-variable host bounds from whichever spec was given."""
    if bounds is not None:
        lo, hi = bounds[0], bounds[1]
    else:
        lo = min_thickness
        hi = onp.inf if max_thickness is None else max_thickness
    return (onp.full(n, lo, dtype=numpy_dtype()),
            onp.full(n, hi, dtype=numpy_dtype()))


def _run_lbfgsb(problem, x0, lb, ub, maxiter, ftol, gtol, memory, kwargs):
    lb, ub = (torch.as_tensor(b, dtype=x0.dtype, device=x0.device) for b in (lb, ub))
    opt = PrysmLBFGSB(problem.fg, x0, lower_bounds=lb, upper_bounds=ub,
                      memory=memory, **kwargs)
    stop = AnyGovernor([MaxIterations(maxiter), FunctionTolerance(ftol),
                        GradientTolerance(gtol)])
    return run_until(opt, stop, maxiter=maxiter)


def _run_lm(problem, x0, lb, ub, maxiter, ftol, gtol, memory, kwargs):
    fences = kwargs.pop('inequality_constraints', None)
    fences = ([fences] if callable(fences) else list(fences or ()))
    # encode the box as linear inequality constraints g(x) >= 0
    if bool(onp.any(onp.isfinite(lb))):
        fences.append(lambda x, lb=lb: onp.asarray(x) - lb)
    if bool(onp.any(onp.isfinite(ub))):
        fences.append(lambda x, ub=ub: ub - onp.asarray(x))
    return damped_least_squares(problem, x0=x0, maxiter=maxiter,
                                inequality_constraints=fences or None,
                                **kwargs)


_DRIVERS = {'lbfgsb': _run_lbfgsb, 'lm': _run_lm}


def refine(stack, targets, *, method='lbfgsb', variable_layers=None,
           variables='thickness', bounds=None,
           min_thickness=0.0, max_thickness=None, maxiter=200,
           ftol=1e-12, gtol=1e-10, memory=10, **kwargs):
    """Refine a stack against a target merit.

    method 'lbfgsb' = bounded quasi-Newton; 'lm' = damped least squares.
    variables selects per-layer thickness or index as the design vector.
    """
    driver = _DRIVERS.get(method)
    if driver is None:
        raise ValueError("method must be either 'lbfgsb' or 'lm'")
    merit = as_merit(targets)
    problem = CoatingProblem(stack, merit, variables=variables,
                             variable_layers=variable_layers)
    x0 = problem.x0()
    lb, ub = _thickness_box(x0.numel(), bounds, min_thickness, max_thickness)
    outcome = driver(problem, x0, lb, ub, maxiter, ftol, gtol, memory, kwargs)
    refined = problem.stack_from_x(outcome.x)
    return CoatingResult(refined, outcome.x, float(merit.value(refined)),
                         bool(outcome.success), int(outcome.nit), outcome)
