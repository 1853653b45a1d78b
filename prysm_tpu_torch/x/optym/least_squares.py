"""Constrained damped least squares (Levenberg–Marquardt with active sets).

Counterpart of ``prysm_tpu/x/optym/least_squares.py``.  Architecture: an
immutable :class:`Evaluation` snapshot per candidate point, a pure
Gauss-Newton/KKT core (:func:`_equality_qp`, :func:`_active_set_qp`), and a
thin :class:`DampedLeastSquares` shell that owns configuration, counters,
and the accept/damp/stop policy.

The outer loop is host control flow in float64 numpy — lens-design problems
have tens of variables, so the KKT solves are small dense host solves.  The
residual, constraint and Jacobian callables may compute on the card: each
evaluation reads its residuals to the host once (``to_host``).  When the
problem exposes ``residual_jacobian`` (e.g. ``torch.func.jacfwd`` of the
residual) it is preferred over central finite differences.
"""
import math
from dataclasses import dataclass, field

import numpy as np

from .problem import to_host

__all__ = ['DampedLeastSquares', 'damped_least_squares', 'DampedLeastSquaresResult',
           'Evaluation']


# ---------------------------------------------------------------------------
# evaluation snapshots
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Evaluation:
    """One candidate point: parameters, residuals, constraint values."""

    x: np.ndarray
    r: np.ndarray
    eq: np.ndarray
    ineq: np.ndarray

    @property
    def cost(self):
        """Half sum of squared residuals."""
        return 0.5 * float(self.r @ self.r)

    @property
    def infeasibility(self):
        """Euclidean norm of constraint violations (ineq counted below 0)."""
        total = float(self.eq @ self.eq) if self.eq.size else 0.0
        if self.ineq.size:
            shortfall = np.minimum(self.ineq, 0.0)
            total += float(shortfall @ shortfall)
        return math.sqrt(total)


def _tuple_of_callables(spec):
    if spec is None:
        return ()
    return (spec,) if callable(spec) else tuple(spec)


def _stacked(funcs, x):
    if not funcs:
        return np.zeros(0)
    return np.concatenate([_host_float(f(x)).ravel() for f in funcs])


def _host_float(v):
    """v (a tensor on any device, an array or numbers) as a float64 host array."""
    return to_host(v).astype(float)


def _central_differences(fn, x, base, h_scale):
    """Columnwise central-difference Jacobian of ``fn`` at ``x``."""
    flat = np.asarray(x, dtype=float).ravel()
    steps = h_scale * np.maximum(1.0, np.abs(flat))
    columns = []
    for j, h in enumerate(steps):
        bump = np.zeros_like(flat)
        bump[j] = h
        hi = _host_float(fn((flat + bump).reshape(np.shape(x)))).ravel()
        lo = _host_float(fn((flat - bump).reshape(np.shape(x)))).ravel()
        columns.append((hi - lo) / (2 * h))
    if not columns:
        return np.zeros((np.asarray(base).size, 0))
    return np.stack(columns, axis=1)


# ---------------------------------------------------------------------------
# QP core: minimize 1/2 dx'H dx + g'dx  s.t.  A dx = b (then active sets)
# ---------------------------------------------------------------------------


def _dense_solve(A, rhs):
    try:
        return np.linalg.solve(A, rhs)
    except np.linalg.LinAlgError:
        return np.linalg.lstsq(A, rhs, rcond=None)[0]


def _equality_qp(H, g, A, b):
    """Solve the equality-constrained QP via the KKT system.

    Returns (dx, multipliers).  With no constraints this is the damped
    normal-equations solve.
    """
    n_var = H.shape[0]
    n_con = A.shape[0]
    if n_con == 0:
        return _dense_solve(H, -g), np.zeros(0)
    kkt = np.block([[H, A.T], [A, np.zeros((n_con, n_con))]])
    sol = _dense_solve(kkt, np.concatenate([-g, b]))
    return sol[:n_var], sol[n_var:]


def _active_set_qp(H, g, Aeq, beq, Aineq, cineq, working, tol, max_rounds):
    """Active-set loop over the inequality constraints.

    ``working`` is the initial working set (indices into the inequality
    rows); constraints violated by the linearized step are added, constraints
    whose multipliers say they pull the wrong way are dropped.  Returns
    (dx, eq multipliers, ineq multipliers (full-length), working set), where
    the working set is the one the returned step and multipliers were solved
    with.  When the rounds run out while the set still changes, that is the
    last one solved (the JAX package pairs the last multipliers with the
    changed set and raises on their mismatched lengths).
    """
    working = sorted(working)
    n_eq = beq.size
    dx = np.zeros(H.shape[0])
    mults = np.zeros(0)
    solved = working
    for _ in range(max_rounds):
        if working:
            A = np.vstack([Aeq, Aineq[working]]) if Aeq.size else Aineq[working]
            b = np.concatenate([beq, -cineq[working]]) if n_eq else -cineq[working]
        else:
            A, b = Aeq, beq
        dx, mults = _equality_qp(H, g, A, b)
        solved = working

        if cineq.size:
            predicted = cineq + Aineq @ dx
            joins = [i for i in np.flatnonzero(predicted < -tol) if i not in working]
            if joins:
                working = sorted(working + joins)
                continue
        leaving = [working[k] for k, lam in enumerate(mults[n_eq:])
                   if lam > tol and cineq[working[k]] >= -tol]
        if leaving:
            working = [i for i in working if i not in leaving]
            continue
        break

    lam_eq = mults[:n_eq] if n_eq else np.zeros(0)
    lam_ineq = np.zeros(cineq.size)
    if solved:
        lam_ineq[np.asarray(solved, dtype=int)] = mults[n_eq:]
    return dx, lam_eq, lam_ineq, np.asarray(solved, dtype=int)


# ---------------------------------------------------------------------------
# result object
# ---------------------------------------------------------------------------


@dataclass
class DampedLeastSquaresResult:
    """Terminal state of a damped least squares run."""

    x: np.ndarray
    residuals: np.ndarray
    cost: float
    success: bool
    message: str
    nit: int
    nfev: int
    njev: int
    ncev: int
    lambda_eq: np.ndarray
    lambda_ineq: np.ndarray
    active_inequalities: np.ndarray
    history: list = field(default_factory=list)

    def __repr__(self):
        """Compact representation."""
        return (f'DampedLeastSquaresResult(success={self.success}, '
                f'cost={self.cost:.6g}, nit={self.nit}, nfev={self.nfev})')


# ---------------------------------------------------------------------------
# the optimizer shell
# ---------------------------------------------------------------------------


def _broadcast(value, n, label):
    arr = np.asarray(value, dtype=float)
    if arr.ndim == 0:
        return np.full(n, float(arr))
    arr = arr.ravel()
    if arr.size != n:
        raise ValueError(f'{label} must be scalar or length {n}')
    return arr.copy()


class DampedLeastSquares:
    """Constrained damped least-squares optimizer with a ``step()`` API.

    Parameters follow the reference implementation
    (prysm/x/optym/least_squares.py:435-468): ``damping`` (scalar or
    per-variable), ``damping_mode`` 'identity' | 'sensitivity',
    ``trust_radii`` per-variable step caps, ``adaptive_damping`` with
    increase/decrease factors, tolerances ``xtol``/``ftol``/
    ``constraint_tol``, and equality/inequality constraint callables.
    """

    def __init__(self, problem, x0=None, *, equality_constraints=None,
                 inequality_constraints=None, damping=1e-6,
                 damping_mode='identity', damping_floor=1.0,
                 trust_radii=None, adaptive_damping=False,
                 damping_increase=10.0, damping_decrease=0.2,
                 damping_min=0.0, damping_max=float('inf'),
                 max_damping_attempts=6,
                 maxiter=25, xtol=1e-10, ftol=1e-12,
                 constraint_tol=1e-10, active_tol=1e-10,
                 fd_step=1e-6, max_active_iter=20, max_line_search=12):
        """Create the optimizer; evaluates the problem once at x0."""
        if damping_mode not in ('identity', 'sensitivity'):
            raise ValueError("damping_mode must be 'identity' or 'sensitivity'")
        if damping_floor < 0:
            raise ValueError('damping_floor must be nonnegative')
        if damping_increase <= 1:
            raise ValueError('damping_increase must be greater than 1')
        if not 0 < damping_decrease < 1:
            raise ValueError('damping_decrease must be between 0 and 1')

        self.problem = problem
        self._eq_fns = _tuple_of_callables(equality_constraints)
        self._ineq_fns = _tuple_of_callables(inequality_constraints)

        if x0 is None:
            if not hasattr(problem, 'x0'):
                raise TypeError('x0 is required when problem has no x0 method')
            x0 = problem.x0()
        start = _host_float(x0).copy()
        n = start.size

        self.damping = damping
        self.damping_mode = damping_mode
        self.damping_floor = float(damping_floor)
        self.adaptive_damping = bool(adaptive_damping)
        self.damping_increase = float(damping_increase)
        self.damping_decrease = float(damping_decrease)
        self.damping_min = _broadcast(damping_min, n, 'damping_min')
        self.damping_max = _broadcast(damping_max, n, 'damping_max')
        if np.any(self.damping_min < 0):
            raise ValueError('damping_min entries must be nonnegative')
        if np.any(self.damping_max < self.damping_min):
            raise ValueError('damping_max must be >= damping_min')
        self.max_damping_attempts = int(max_damping_attempts)
        if trust_radii is None:
            self.trust_radii = None
        else:
            self.trust_radii = _broadcast(trust_radii, n, 'trust_radii')
            if np.any(self.trust_radii <= 0):
                raise ValueError('trust_radii entries must be positive')

        self.maxiter = int(maxiter)
        self.xtol = float(xtol)
        self.ftol = float(ftol)
        self.constraint_tol = float(constraint_tol)
        self.active_tol = float(active_tol)
        self.fd_step = float(fd_step)
        self.max_active_iter = int(max_active_iter)
        self.max_line_search = int(max_line_search)

        self.nfev = self.njev = self.ncev = 0
        self.iter = 0
        self.done = False
        self.success = False
        self.message = ''
        self.history = []
        self.last_step_metadata = {}
        self._lam_eq = np.zeros(0)
        self._lam_ineq = np.zeros(0)
        self._working = np.zeros(0, dtype=int)

        self.current = self._evaluate(start)
        self.x0 = start.copy()

    # -- evaluation plumbing ------------------------------------------------

    def _evaluate(self, x):
        self.nfev += 1
        if self._eq_fns or self._ineq_fns:
            self.ncev += 1
        return Evaluation(
            x=np.asarray(x, dtype=float),
            r=_host_float(self.problem.residuals(x)).ravel(),
            eq=_stacked(self._eq_fns, x),
            ineq=_stacked(self._ineq_fns, x))

    def _residual_jacobian(self, at):
        maker = getattr(self.problem, 'residual_jacobian', None)
        if callable(maker):
            J = maker(at.x)
            if J is not None:
                self.njev += 1
                return _host_float(J)
        self.njev += 1
        self.nfev += 2 * at.x.size
        return _central_differences(
            lambda x: self.problem.residuals(x), at.x, at.r, self.fd_step)

    def _constraint_jacobians(self, at):
        n = at.x.size
        Aeq = (_central_differences(lambda x: _stacked(self._eq_fns, x), at.x,
                                    at.eq, self.fd_step)
               if at.eq.size else np.zeros((0, n)))
        Aineq = (_central_differences(lambda x: _stacked(self._ineq_fns, x), at.x,
                                      at.ineq, self.fd_step)
                 if at.ineq.size else np.zeros((0, n)))
        if at.eq.size or at.ineq.size:
            self.ncev += 2 * n
        return Aeq, Aineq

    # -- damping ------------------------------------------------------------

    def _damping_vector(self, J, Aeq, Aineq):
        lam = _broadcast(self.damping, J.shape[1], 'damping')
        if self.damping_mode == 'sensitivity':
            sens = np.zeros(J.shape[1])
            for M in (J, Aeq, Aineq):
                if M.size:
                    sens += np.einsum('ij,ij->j', M, M)
            lam = lam * np.maximum(sens, self.damping_floor)
        return lam

    def _scale_damping(self, factor):
        scaled = np.clip(_broadcast(self.damping, self.current.x.size, 'damping')
                         * factor, self.damping_min, self.damping_max)
        self.damping = float(scaled[0]) if np.ndim(self.damping) == 0 else scaled

    # -- the LM step --------------------------------------------------------

    def _propose(self, at):
        """Linearize at ``at`` and solve the damped, constrained subproblem."""
        J = self._residual_jacobian(at)
        Aeq, Aineq = self._constraint_jacobians(at)
        gradient = J.T @ at.r
        H = J.T @ J
        lam_diag = self._damping_vector(J, Aeq, Aineq)
        self._last_damping_diagonal = np.broadcast_to(
            lam_diag, (J.shape[1],)).copy()
        H[np.diag_indices_from(H)] += lam_diag

        seed = (np.flatnonzero(at.ineq <= self.active_tol).tolist()
                if at.ineq.size else [])
        dx, lam_eq, lam_ineq, working = _active_set_qp(
            H, gradient, Aeq, -at.eq, Aineq, at.ineq, seed,
            self.constraint_tol, self.max_active_iter)

        self._last_trust_scale = 1.0
        if self.trust_radii is not None and dx.size:
            over = np.isfinite(self.trust_radii) & (np.abs(dx) > self.trust_radii)
            if np.any(over):
                scale = float(np.min(self.trust_radii[over] / np.abs(dx[over])))
                dx = dx * scale
                self._last_trust_scale = scale
        return dx, gradient, lam_eq, lam_ineq, working

    def _backtrack(self, at, dx):
        """Halving line search; returns (alpha, accepted Evaluation) or None."""
        alpha = 1.0
        for _ in range(self.max_line_search + 1):
            trial = self._evaluate(at.x + alpha * dx)
            if self._acceptable(at, trial):
                return alpha, trial
            alpha *= 0.5
        return None

    def _acceptable(self, at, trial):
        if at.infeasibility > self.constraint_tol:
            return trial.infeasibility < at.infeasibility
        good_cost = trial.cost <= at.cost + self.ftol * max(1.0, at.cost)
        return trial.infeasibility <= self.constraint_tol and good_cost

    # -- convergence policy -------------------------------------------------

    def _stop(self, message, iteration, success=None):
        self.done = True
        self.message = message
        feasible = self.current.infeasibility <= self.constraint_tol
        self.success = feasible if success is None else bool(success)
        self._nit = iteration

    # -- public API ---------------------------------------------------------

    @property
    def x(self):
        """Current iterate."""
        return self.current.x

    @property
    def constraint_violation(self):
        """Current combined constraint violation."""
        return self.current.infeasibility

    def step(self):
        """One LM iteration; returns the pre-update (x, f, g)."""
        if self.done:
            raise StopIteration(self.result())

        at = self.current
        f_before = at.cost
        attempts = 0
        while True:
            dx, gradient, lam_eq, lam_ineq, working = self._propose(at)
            self._lam_eq, self._lam_ineq, self._working = lam_eq, lam_ineq, working
            dx_norm = float(np.linalg.norm(dx))

            # predicted step already negligible at a feasible point: converged
            if (dx_norm <= self.xtol * (self.xtol + float(np.linalg.norm(at.x)))
                    and at.infeasibility <= self.constraint_tol):
                self.last_step_metadata = self._describe(dx_norm, None, False)
                self._stop('step tolerance reached', self.iter)
                return at.x, f_before, gradient

            found = self._backtrack(at, dx)
            if found is not None:
                alpha, trial = found
                break
            if not self.adaptive_damping or attempts >= self.max_damping_attempts:
                self.last_step_metadata = self._describe(dx_norm, None, False)
                self._stop('line search failed', self.iter + 1, success=False)
                return at.x, f_before, gradient
            self._scale_damping(self.damping_increase)
            attempts += 1

        self.current = trial
        self.iter += 1
        self.history.append({
            'x': trial.x.copy(),
            'cost': trial.cost,
            'constraint_violation': trial.infeasibility,
            'step_norm': dx_norm,
            'alpha': alpha,
            'active_inequalities': working.copy(),
            'damping_attempts': attempts,
        })
        self.last_step_metadata = self._describe(dx_norm, alpha, True,
                                                 f_next=trial.cost)

        if self.adaptive_damping:
            self._scale_damping(self.damping_decrease if alpha == 1.0
                                else self.damping_increase)

        feasible = trial.infeasibility <= self.constraint_tol
        moved = float(np.max(np.abs(trial.x - at.x))) if trial.x.size else 0.0
        f_after = trial.cost
        if feasible and moved <= self.xtol * max(1.0, float(np.max(np.abs(at.x)))
                                                 if at.x.size else 1.0):
            self._stop('step tolerance reached', self.iter)
        elif (feasible and abs(f_before - f_after)
              <= self.ftol * max(1.0, abs(f_before), abs(f_after))):
            self._stop('cost tolerance reached', self.iter)
        elif self.iter >= self.maxiter:
            self._stop('maximum iterations reached', self.iter)
        return at.x, f_before, gradient

    def _describe(self, step_norm, alpha, accepted, f_next=None):
        return {
            'step_norm': step_norm,
            'alpha': alpha,
            'accepted': accepted,
            'constraint_violation': self.current.infeasibility,
            'active_inequalities': self._working.copy(),
            'damping': np.asarray(self.damping, dtype=float).copy(),
            'damping_mode': self.damping_mode,
            'damping_diagonal': getattr(self, '_last_damping_diagonal', None),
            'trust_scale': getattr(self, '_last_trust_scale', 1.0),
            'f_next': self.current.cost if f_next is None else f_next,
        }

    def run(self):
        """Iterate to a stopping condition; returns the result object."""
        if self.maxiter <= 0 and not self.done:
            self._stop('maximum iterations reached', 0)
        while not self.done:
            self.step()
        return self.result()

    def result(self):
        """Snapshot the current state as a result object."""
        return DampedLeastSquaresResult(
            x=self.current.x, residuals=self.current.r,
            cost=self.current.cost, success=self.success,
            message=self.message, nit=getattr(self, '_nit', self.iter),
            nfev=self.nfev, njev=self.njev, ncev=self.ncev,
            lambda_eq=self._lam_eq, lambda_ineq=self._lam_ineq,
            active_inequalities=self._working, history=self.history)


def damped_least_squares(problem, x0=None, **kwargs):
    """Run constrained damped least squares to completion."""
    return DampedLeastSquares(problem, x0=x0, **kwargs).run()
