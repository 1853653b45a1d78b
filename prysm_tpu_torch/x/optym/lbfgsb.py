"""L-BFGS-B optimizers.

Counterpart of ``prysm_tpu/x/optym/lbfgsb.py``:

* ``LBFGSB`` drives SciPy's reverse-communication ``setulb`` (the C port in
  SciPy >= 1.15) with the step() API.  The driver's state is host numpy in
  float64; when x0 is a tensor, fg is called on a tensor of x0's dtype on
  x0's device, and its (f, g) come back through ``to_host``.
* ``PrysmLBFGSB`` is the full Byrd-Lu-Nocedal-Zhu algorithm in torch:
  compact limited-memory form, generalized Cauchy point over the
  projected-gradient path, and Sherman-Morrison-Woodbury subspace
  minimization on the free set.  Its history, bounds and iterate stay on
  x0's device in x0's dtype.  The Cauchy point walks the breakpoints in a
  Python loop (the JAX package's ``lax.while_loop``), reading one scalar to
  the host per breakpoint; it visits the same breakpoints in the same
  order and computes the same updates.
"""
import warnings

import numpy as np
import torch

from scipy.optimize import _lbfgsb as _sp_lbfgsb

from ...conf import to_tensor
from .problem import as_problem, to_host

__all__ = ['LBFGSB', 'PrysmLBFGSB']

# task[0] codes of the SciPy >= 1.15 C driver
_TASK_NEW_X = 1
_TASK_FG = 3
_TASK_CONVERGENCE = 4
_TASK_STOP = 5
_TASK_WARNING = 6
_TASK_ERROR = 7
_TASK_ABNORMAL = 8


class _DriverStop:
    """StopIteration payload for non-error driver termination."""

    def __init__(self, success, message):
        self.success = success
        self.message = message


class LBFGSB:
    """L-BFGS-B via SciPy's compiled reverse-communication driver.

    Exposes the optym step() API: each step() advances the driver until it
    reports a completed iteration (NEW_X), returning the pre-step (x, f, g).
    Raises StopIteration with a _DriverStop payload on convergence.
    """

    def __init__(self, fg, x0, memory=10, lower_bounds=None, upper_bounds=None,
                 factr=0.0, pgtol=0.0, maxls=20):
        """fg(x) -> (f, g); x0 initial vector; memory = history pairs.

        factr/pgtol default to 0 (run until the caller's governor stops
        the loop) so step()/run_to() do not terminate behind the user's
        back; the driver may still signal CONVERGENCE at an exactly
        stationary point, surfaced as StopIteration (step) or a
        UserWarning (run_to).  A tensor x0 makes fg see tensors of its
        dtype on its device.
        """
        self.problem = as_problem(fg)
        self._like = (x0.dtype, x0.device) if torch.is_tensor(x0) else None
        x0 = to_host(x0).astype(np.float64).ravel()
        self.x0 = x0.copy()
        self.n = x0.size
        self.m = int(memory)
        n, m = self.n, self.m

        if lower_bounds is None:
            lower_bounds = np.full(n, -np.inf)
        if upper_bounds is None:
            upper_bounds = np.full(n, np.inf)
        self.l = to_host(lower_bounds).astype(np.float64).ravel()  # NOQA
        self.u = to_host(upper_bounds).astype(np.float64).ravel()
        nbd = np.zeros(n, dtype=np.int32)
        has_l = np.isfinite(self.l)
        has_u = np.isfinite(self.u)
        nbd[has_l & ~has_u] = 1
        nbd[has_l & has_u] = 2
        nbd[~has_l & has_u] = 3
        self._nbd = nbd
        # driver requires finite sentinels where nbd says unbounded
        self._lb = np.where(has_l, self.l, 0.0)
        self._ub = np.where(has_u, self.u, 0.0)

        self.factr = float(factr)
        self.pgtol = float(pgtol)
        self.maxls = int(maxls)

        self._x = x0.copy()
        self._f = np.array(0.0, dtype=np.float64)
        self._g = np.zeros(n, dtype=np.float64)
        self._wa = np.zeros(2 * m * n + 5 * n + 11 * m * m + 8 * m, np.float64)
        self._iwa = np.zeros(3 * n, dtype=np.int32)
        self._task = np.zeros(2, dtype=np.int32)
        self._ln_task = np.zeros(2, dtype=np.int32)
        self._lsave = np.zeros(4, dtype=np.int32)
        self._isave = np.zeros(44, dtype=np.int32)
        self._dsave = np.zeros(29, dtype=np.float64)
        self.nfev = 0
        self.iter = 0
        self.last_step_metadata = {}

    @property
    def x(self):
        """Current iterate (a copy — the driver's buffer stays private)."""
        return self._x.copy()

    @property
    def g(self):
        """Gradient at the last evaluated point (a copy)."""
        return self._g.copy()

    def _call_driver(self):
        _sp_lbfgsb.setulb(
            self.m, self._x, self._lb, self._ub, self._nbd, self._f, self._g,
            self.factr, self.pgtol, self._wa, self._iwa, self._task,
            self._lsave, self._isave, self._dsave, self.maxls, self._ln_task)

    def _fg_at_x(self):
        if self._like is None:
            return self.problem.fg(self._x)
        dtype, device = self._like
        return self.problem.fg(torch.as_tensor(self._x, dtype=dtype, device=device))

    def step(self):
        """Advance the driver to the next completed iteration."""
        x_prev = self._x.copy()
        f_prev = None
        g_prev = None
        while True:
            self._call_driver()
            code = int(self._task[0])
            if code == _TASK_FG:
                f, g = self._fg_at_x()
                self._f = np.array(float(f), dtype=np.float64)
                self._g = to_host(g).astype(np.float64).ravel()
                self.nfev += 1
                if f_prev is None:
                    f_prev = float(f)
                    g_prev = self._g.copy()
            elif code == _TASK_NEW_X:
                self.iter += 1
                self.last_step_metadata = {'task': 'NEW_X'}
                return (x_prev,
                        float(self._f) if f_prev is None else f_prev,
                        self._g.copy() if g_prev is None else g_prev)
            else:
                raise StopIteration(self._terminal(code))

    def _terminal(self, code):
        """Map a terminal driver status code to a StopIteration payload.

        The C driver's status 8 (ABNORMAL: line-search failure et al.)
        is a known failed termination, not an unknown code.
        """
        if code == _TASK_CONVERGENCE:
            self.last_step_metadata = {'task': 'CONVERGENCE'}
            return _DriverStop(True, 'converged')
        if code in (_TASK_STOP, _TASK_WARNING):
            self.last_step_metadata = {'task': 'STOP'}
            return _DriverStop(True, 'driver stop')
        if code == _TASK_ABNORMAL:
            self.last_step_metadata = {'task': 'ABNORMAL'}
            return _DriverStop(False, 'abnormal driver termination')
        self.last_step_metadata = {'task': f'ERROR({code})'}
        return _DriverStop(False, f'driver error code {code}')

    def run_to(self, N):
        """Yield (x, f, g) for up to N iterations.

        If the driver signals convergence before N iterations complete
        (possible only at an exactly stationary point with the factr=0 /
        pgtol=0 defaults), the StopIteration is swallowed and a
        UserWarning is emitted instead of propagating mid-iteration.
        """
        for _ in range(N):
            try:
                yield self.step()
            except StopIteration as e:
                payload = e.args[0] if e.args else None
                warnings.warn(
                    'L-BFGS-B driver signaled '
                    f'{getattr(payload, "message", "termination")} after '
                    f'{self.iter} iteration(s); stopping early', UserWarning)
                return


# ---------------------------------------------------------------------------
# L-BFGS-B in torch: compact limited-memory form, generalized Cauchy point,
# and subspace minimization (Byrd, Lu, Nocedal & Zhu 1995), on x0's device.
# ---------------------------------------------------------------------------

def _compact_form(S, Y, valid, theta):
    """W, M of the compact representation B = theta I - W M W^T.

    S, Y are (m, n) rolling histories ordered oldest -> newest with
    invalid rows zeroed; valid is the (m,) slot mask.  Invalid slots are
    decoupled by padding the middle-matrix diagonal, and contribute
    nothing because their W columns are zero.
    """
    SY = S @ Y.T
    SS = S @ S.T
    one = torch.ones((), dtype=S.dtype, device=S.device)
    pad = torch.where(valid, torch.zeros_like(one), one)
    D = torch.diag(torch.where(valid, torch.diagonal(SY), one))
    L = torch.tril(SY, -1)
    M_inv = torch.cat([torch.cat([-D, L.T], dim=1),
                       torch.cat([L, theta * SS + torch.diag(pad)], dim=1)], dim=0)
    W = torch.cat([Y.T, theta * S.T], dim=1)  # (n, 2m)
    M = torch.linalg.inv(M_inv)
    return W, M


def _cauchy_point(x, g, lower, upper, W, M, theta):
    """Generalized Cauchy point of the L-BFGS-B quadratic along P(x - t g).

    Walks the breakpoints of the projected-gradient path in sorted order,
    updating the directional derivative pair (f', f'') in the compact
    form (BLNZ Algorithm CP).  The sorted breakpoints are read to the host
    once; each trip then reads the 1-D minimizer's step to decide whether
    the walk stops inside the current interval.  Returns (x_cauchy, c)
    with c = W^T (x_cauchy - x).
    """
    eps = torch.finfo(x.dtype).eps
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    at_lower_out = (x <= lower) & (g > 0)
    at_upper_out = (x >= upper) & (g < 0)
    d = torch.where(at_lower_out | at_upper_out, zero, -g)

    # per-variable breakpoint along x - t g
    safe = torch.where(d == 0, torch.ones_like(d), d)
    t_break = torch.where(d > 0, (upper - x) / safe,
                          torch.where(d < 0, (lower - x) / safe, zero + torch.inf))
    t_break = torch.where(d == 0, zero + torch.inf, t_break)
    # a stable sort: equal breakpoints in index order, as the JAX package's argsort
    t_sorted, order = torch.sort(t_break, stable=True)
    t_host, order_host = to_host(t_sorted), to_host(order)

    p = W.T @ d                                     # (2m,)
    fp = -(d @ d)
    fpp = -theta * fp - p @ (M @ p)
    fpp = torch.clamp(fpp, min=eps)
    dt_min = -fp / fpp

    xc = torch.where(at_lower_out, lower, torch.where(at_upper_out, upper, x))
    c = torch.zeros(W.shape[1], dtype=x.dtype, device=x.device)
    t_old = zero
    for j in range(x.shape[0]):
        t_b = float(t_host[j])
        # stop when the remaining breakpoints are at infinity, or when the
        # 1-D minimizer lands inside this interval
        if not np.isfinite(t_b):
            break
        dt = t_b - t_old
        if bool(dt_min < dt):
            break
        b = int(order_host[j])
        g_b = g[b]
        d_b = d[b]
        bound_b = torch.where(d_b > 0, upper[b], lower[b])
        z_b = bound_b - x[b]
        c = c + dt * p
        w_b = W[b]
        Mw = M @ w_b
        fp2 = (fp + dt * fpp + g_b * g_b + theta * g_b * z_b
               - g_b * (w_b @ (M @ c)))
        fpp = (fpp - theta * g_b * g_b - 2.0 * g_b * (Mw @ p)
               - g_b * g_b * (Mw @ w_b))
        fpp = torch.clamp(fpp, min=eps)
        fp = fp2
        p = p + g_b * w_b
        d = torch.cat([d[:b], zero[None], d[b + 1:]])
        xc = torch.cat([xc[:b], bound_b[None], xc[b + 1:]])
        dt_min = -fp / fpp
        t_old = t_b + zero

    dt_min = torch.clamp(dt_min, min=0.0)
    t_cp = t_old + dt_min
    # free variables move to their path position; fixed ones already sit
    # at their bounds in xc
    moved = torch.clamp(x + t_cp * d, lower, upper)
    xc = torch.where(d != 0, moved, xc)
    c = c + dt_min * p
    return xc, c


def _subspace_step(x, g, xc, c, lower, upper, W, M, theta):
    """Subspace minimizer over the free variables at the Cauchy point.

    Direct primal method with Sherman-Morrison-Woodbury on the compact
    form; fixed variables are masked rather than gathered, so no shape
    depends on the data.  Returns the line-search target xbar.
    """
    free = (xc > lower) & (xc < upper)
    freef = free.to(x.dtype)

    # reduced gradient of the quadratic at the Cauchy point
    r = (g + theta * (xc - x) - W @ (M @ c)) * freef

    Wf = W * freef[:, None]                          # zero fixed rows
    k2 = W.shape[1]
    inner = torch.eye(k2, dtype=x.dtype, device=x.device) - (M @ (Wf.T @ Wf)) / theta
    v = torch.linalg.solve(inner, M @ (Wf.T @ r))
    du = -(r / theta + (Wf @ v) / (theta * theta))
    du = du * freef

    # longest feasible fraction of the full subspace step
    inf = torch.full_like(du, torch.inf)
    safe = torch.where(du == 0, torch.ones_like(du), du)
    to_upper = torch.where(du > 0, (upper - xc) / safe, inf)
    to_lower = torch.where(du < 0, (lower - xc) / safe, inf)
    alpha = torch.clamp(torch.min(torch.minimum(to_upper, to_lower)), 0.0, 1.0)
    return torch.clamp(xc + alpha * du, lower, upper)


def _lbfgsb_direction(x, g, S, Y, valid, theta, lower, upper):
    """Compact form -> Cauchy point -> subspace minimizer: the target xbar."""
    W, M = _compact_form(S, Y, valid, theta)
    xc, c = _cauchy_point(x, g, lower, upper, W, M, theta)
    return _subspace_step(x, g, xc, c, lower, upper, W, M, theta)


class PrysmLBFGSB:
    """L-BFGS-B in torch: the full BLNZ algorithm, on x0's device.

    Implements the same method as the compiled driver wrapped by LBFGSB
    (limited-memory compact form, generalized Cauchy point over the
    projected-gradient path, subspace minimization on the free set,
    strong-Wolfe-style line search).  The linear algebra runs on x0's
    device; fg evaluations and the line search's control flow run on the
    host, which reads f and the slopes back as floats.
    """

    def __init__(self, fg, x0, memory=10, lower_bounds=None, upper_bounds=None,
                 c1=1e-4, c2=0.9, max_ls=25):
        """fg(x) -> (f, g); x0 initial vector; memory = history pairs.

        The working dtype and device track x0: an f32 start keeps every
        history buffer, bound, and linear-algebra pass in f32 (integer x0
        promotes to ``config.precision``).  Python numbers and numpy arrays
        go to ``config.device``.
        """
        self.problem = as_problem(fg)
        x0 = to_tensor(x0)
        if not x0.is_floating_point():
            x0 = to_tensor(to_host(x0).astype(float), device=x0.device)
        self.x0 = x0.detach().ravel()
        dtype, dev = self.x0.dtype, self.x0.device
        n = self.x0.numel()
        self.m = int(memory)
        self.l = (torch.full((n,), -torch.inf, dtype=dtype, device=dev)  # NOQA
                  if lower_bounds is None else self._like_x(lower_bounds))
        self.u = (torch.full((n,), torch.inf, dtype=dtype, device=dev)
                  if upper_bounds is None else self._like_x(upper_bounds))
        self.x = torch.clamp(self.x0, self.l, self.u)
        self.c1 = float(c1)
        self.c2 = float(c2)
        self.max_ls = int(max_ls)

        self._S = torch.zeros((self.m, n), dtype=dtype, device=dev)
        self._Y = torch.zeros((self.m, n), dtype=dtype, device=dev)
        self._valid = torch.zeros(self.m, dtype=torch.bool, device=dev)
        self._theta = 1.0
        self._prev = None
        self._cached_fg = None
        self.nfev = 0
        self.iter = 0
        self.last_step_metadata = {}

    def _like_x(self, a):
        """a (tensor, array or numbers) as a flat tensor of x0's dtype on x0's device."""
        if torch.is_tensor(a):
            a = a.detach()
        else:
            a = np.asarray(a)
        return torch.as_tensor(a, dtype=self.x0.dtype, device=self.x0.device).ravel()

    # -- history ------------------------------------------------------------

    def _admit_pair(self, s, y):
        """Shift in a curvature pair when s.y passes the BLNZ test."""
        sy = float(s @ y)
        yy = float(y @ y)
        if sy <= 2.2e-16 * yy or not np.isfinite(sy):
            return
        self._S = torch.cat([self._S[1:], s[None]])
        self._Y = torch.cat([self._Y[1:], y[None]])
        self._valid = torch.cat([self._valid[1:], self._valid.new_ones(1)])
        self._theta = yy / sy

    def _projected_gradient_norm(self, x, g):
        pg = torch.clamp(x - g, self.l, self.u) - x
        return float(torch.max(torch.abs(pg)))

    # -- iteration ----------------------------------------------------------

    def step(self):
        """One full L-BFGS-B iteration; returns the pre-step (x, f, g)."""
        if self._cached_fg is not None:
            f, g = self._cached_fg
            self._cached_fg = None
        else:
            f, g = self.problem.fg(self.x)
            self.nfev += 1
        f0 = float(f)
        g = self._like_x(g)

        if self._projected_gradient_norm(self.x, g) == 0.0:
            raise StopIteration(_DriverStop(True, 'projected gradient is zero'))

        if self._prev is not None:
            x_prev, g_prev = self._prev
            self._admit_pair(self.x - x_prev, g - g_prev)

        xbar = _lbfgsb_direction(self.x, g, self._S, self._Y, self._valid,
                                 self._theta, self.l, self.u)
        d = xbar - self.x
        slope = float(d @ g)
        if slope >= 0 or not np.isfinite(slope):
            # quadratic model failed to produce descent: steepest-descent
            # restart on the projected gradient
            self._S = torch.zeros_like(self._S)
            self._Y = torch.zeros_like(self._Y)
            self._valid = torch.zeros_like(self._valid)
            self._theta = 1.0
            d = torch.clamp(self.x - g, self.l, self.u) - self.x
            slope = float(d @ g)
            if slope >= 0:
                raise StopIteration(_DriverStop(True, 'no descent direction'))

        x, accepted = self.x, False
        alpha, lo, hi = 1.0, 0.0, np.inf
        f_best, x_best, fg_best = np.inf, None, None
        for _ in range(self.max_ls):
            x_trial = torch.clamp(x + alpha * d, self.l, self.u)
            f_trial, g_trial = self.problem.fg(x_trial)
            f_trial = float(f_trial)
            g_trial = self._like_x(g_trial)
            self.nfev += 1
            if f_trial < f_best:
                f_best, x_best = f_trial, x_trial
                fg_best = (f_trial, g_trial)
            if f_trial > f0 + self.c1 * alpha * slope or not np.isfinite(f_trial):
                hi = alpha
                alpha = 0.5 * (lo + hi)
                continue
            dslope = float(g_trial @ d)
            if abs(dslope) <= self.c2 * abs(slope):
                accepted = True
                break
            if dslope < 0:
                lo = alpha
                alpha = 2 * alpha if np.isinf(hi) else 0.5 * (lo + hi)
            else:
                hi = alpha
                alpha = 0.5 * (lo + hi)
        if not accepted:
            if f_best < f0:
                x_trial, (f_trial, g_trial) = x_best, fg_best
            else:
                raise StopIteration(_DriverStop(False, 'line search failed'))

        self._prev = (x, g)
        self.x = x_trial
        self._cached_fg = (f_trial, g_trial)
        self.iter += 1
        self.last_step_metadata = {'alpha': alpha, 'f_next': float(f_trial)}
        return x, f0, g

    def run_to(self, N):
        """Run up to N iterations; returns (x, f, g) at the final point."""
        for _ in range(N):
            try:
                self.step()
            except StopIteration:
                break
        f, g = (self._cached_fg if self._cached_fg is not None
                else self.problem.fg(self.x))
        return self.x, float(f), self._like_x(g)
