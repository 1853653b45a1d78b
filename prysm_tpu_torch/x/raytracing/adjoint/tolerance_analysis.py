"""TOR-style tolerance analysis on the adjoint Jacobian.

Counterpart of ``prysm_tpu/x/raytracing/adjoint/tolerance_analysis.py``:
``multi_objective_sensitivity`` assembles the M x P Jacobian (M merit
heads, P seed parameters) as M reverse-mode passes through the trace
engine, and the remaining helpers are linear algebra on that
Jacobian: degradation tables, inverse sensitivity (budget -> tolerance),
RSS prediction, and compensator projection.
"""
import numpy as onp

from .engine import adjoint_gradient, adjoint_gradient_multi


class AdjointResult:
    """The M x P adjoint Jacobian plus labels and nominal merit values."""

    __slots__ = ('jacobian', 'head_names', 'param_names', 'nominals')

    def __init__(self, jacobian, head_names, param_names, nominals):
        self.jacobian = onp.asarray(jacobian, dtype=float)
        self.head_names = list(head_names)
        self.param_names = list(param_names)
        self.nominals = dict(nominals)

    def _row(self, head):
        if isinstance(head, int):
            return head
        return self.head_names.index(head)

    def sensitivity_for(self, head):
        """The (P,) gradient row for a named (or indexed) objective."""
        return self.jacobian[self._row(head)]

    def ranked_by(self, head):
        """Parameters sorted by |sensitivity| for one objective, descending."""
        row = self.sensitivity_for(head)
        order = onp.argsort(-onp.abs(row))
        return [(self.param_names[i], float(row[i])) for i in order]

    def to_dataframe(self):
        """The Jacobian as a labeled pandas DataFrame (pandas imported here)."""
        import pandas as pd
        return pd.DataFrame(self.jacobian, index=self.head_names,
                            columns=self.param_names)

    def __repr__(self):
        return (f'AdjointResult(M={len(self.head_names)}, '
                f'P={len(self.param_names)})')


def multi_objective_sensitivity(system, P, S, wvl, seeds, heads, *,
                                tol_sag=None, Pdot0=None, Sdot0=None):
    """The M x P adjoint Jacobian: one reverse-mode pass per head.

    system: OpticalSystem / LensData / compiled surface list; seeds:
    DiffSeed sequence (column order); heads: callables or seed-protocol
    merits (row order).  Pdot0/Sdot0 are optional launch-recipe
    tangents forwarded to the engine.  Returns an AdjointResult.
    """
    seeds = list(seeds)
    heads = list(heads)
    J = onp.zeros((len(heads), len(seeds)), dtype=float)
    nominals = {}
    head_names = [getattr(h, 'name', None) or f'head{m}'
                  for m, h in enumerate(heads)]

    # callable heads share one forward trace + linearization; one pullback
    # per head instead of one full re-trace per head
    callable_rows = [m for m, h in enumerate(heads)
                     if getattr(h, 'seed', None) is None]
    other_rows = [m for m in range(len(heads)) if m not in callable_rows]
    if callable_rows:
        grads, values = adjoint_gradient_multi(
            system, P, S, wvl, seeds, [heads[m] for m in callable_rows],
            tol_sag=tol_sag, Pdot0=Pdot0, Sdot0=Sdot0)
        for i, m in enumerate(callable_rows):
            J[m] = grads[i]
            nominals[head_names[m]] = values[i]
    for m in other_rows:
        grad, nominal = adjoint_gradient(system, P, S, wvl, seeds,
                                         heads[m], tol_sag=tol_sag,
                                         Pdot0=Pdot0, Sdot0=Sdot0)
        J[m] = grad
        if nominal is not None:
            nominals[head_names[m]] = nominal
    param_names = [getattr(s, 'name', '') or f'param{p}'
                   for p, s in enumerate(seeds)]
    return AdjointResult(J, head_names, param_names, nominals)


class ToleranceSensitivityTable:
    """Per-parameter sensitivities and per-step degradations.

    steps: (P,) tolerance step sizes, one per parameter in its own units.
    """

    __slots__ = ('result', 'steps')

    def __init__(self, adjoint_result, steps):
        self.result = adjoint_result
        self.steps = onp.asarray(steps, dtype=float)

    def sensitivity(self):
        """|dF_m / dtau_p| matrix, (M, P)."""
        return onp.abs(self.result.jacobian)

    def degradation_at_step(self):
        """dF_m/dtau_p * step_p matrix, (M, P)."""
        return self.result.jacobian * self.steps[None, :]

    def ranked_by(self, head):
        """Parameters ranked by |sensitivity| for one objective."""
        return self.result.ranked_by(head)


def inverse_sensitivity(J, budget, steps_min=None, steps_max=None):
    """Per-parameter tolerance producing exactly `budget` degradation.

    tol_p = min over objectives m of budget_m / |J[m, p]|; insensitive
    parameters are unconstrained (clipped by steps_max when given), and
    the result is clipped to [steps_min, steps_max].
    """
    J = onp.asarray(J, dtype=float)
    absJ = onp.abs(J)
    budget = onp.broadcast_to(onp.asarray(budget, dtype=float),
                              (J.shape[0],))
    with onp.errstate(divide='ignore', invalid='ignore'):
        per_obj = budget[:, None] / absJ
    per_obj = onp.where(absJ > 0, per_obj, onp.inf)
    tol = per_obj.min(axis=0)
    if steps_max is not None:
        tol = onp.minimum(tol, onp.asarray(steps_max, dtype=float))
    if steps_min is not None:
        tol = onp.maximum(tol, onp.asarray(steps_min, dtype=float))
    return tol


def multi_objective_budget(J, budgets):
    """Minimax tolerance satisfying every objective's budget at once."""
    return inverse_sensitivity(J, budgets)


def rss_prediction(J, sigmas):
    """Root-sum-square merit perturbation for independent tolerances.

    sigma_total_m = sqrt(sum_p (J[m, p] sigma_p)^2), shape (M,).
    """
    J = onp.asarray(J, dtype=float)
    sigmas = onp.asarray(sigmas, dtype=float)
    contrib = J * sigmas[None, :]
    return onp.sqrt((contrib * contrib).sum(axis=1))


def compensated_jacobian(J, J_comp):
    """Project compensator DOFs out of the tolerance Jacobian.

    With K compensators of Jacobian J_comp (M, K), the least-squares
    compensation is c = -pinv(J_comp) @ (J tau), so

        J_eff = (I - J_comp pinv(J_comp)) J

    is the post-compensation Jacobian; comp_motions = -pinv(J_comp) @ J
    gives dc/dtau, (K, P).
    """
    J = onp.asarray(J, dtype=float)
    J_comp = onp.asarray(J_comp, dtype=float)
    pinv = onp.linalg.pinv(J_comp)
    comp_motions = -pinv @ J
    J_eff = J + J_comp @ comp_motions
    return J_eff, comp_motions


__all__ = [
    'AdjointResult', 'multi_objective_sensitivity',
    'ToleranceSensitivityTable', 'inverse_sensitivity',
    'multi_objective_budget', 'rss_prediction', 'compensated_jacobian',
]
