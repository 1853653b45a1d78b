"""First-order optimization algorithms with a step() API.

Counterpart of ``prysm_tpu/x/optym/optimizers.py``.  Optimizer state lives
in tensors on x0's device; each update is a handful of elementwise ops, and
the user's fg is typically a forward + autograd backward of the optical
model.  Box bounds are enforced by projection with gradient masking at
active constraints.
"""
import numpy as np
import torch

from ...conf import to_tensor
from .governors import GovernorDecision, OptimizationResult, StepRecord
from .problem import as_problem
from .lbfgsb import LBFGSB, PrysmLBFGSB  # NOQA - re-exported

__all__ = ['runN', 'run_until', 'GradientDescent', 'AdaGrad', 'RMSProp', 'Adam', 'RAdam',
           'AdaMomentum', 'Yogi', 'LBFGSB', 'PrysmLBFGSB']


def runN(optimizer, N):
    """Yield (x, f, g) for N iterations of optimization."""
    for _ in range(N):
        yield optimizer.step()


def _stop_iteration_decision(exc):
    value = exc.value
    success = bool(getattr(value, 'success', True))
    message = getattr(value, 'message', 'optimizer stopped') or 'optimizer stopped'
    return GovernorDecision(True, success, message)


def run_until(optimizer, governor, *, maxiter=None):
    """Run an optimizer until a governor decides to stop.

    Returns an OptimizationResult with the final iterate and step records.
    """
    records = []
    if maxiter is not None:
        maxiter = int(maxiter)
        if maxiter <= 0:
            decision = GovernorDecision(True, False, 'maximum iterations reached')
            return OptimizationResult(getattr(optimizer, 'x', None), decision,
                                      records, optimizer)
    iteration = 0
    while maxiter is None or iteration < maxiter:
        iteration += 1
        try:
            x, f, g = optimizer.step()
        except StopIteration as exc:
            decision = _stop_iteration_decision(exc)
            return OptimizationResult(getattr(optimizer, 'x', None), decision,
                                      records, optimizer)
        record = StepRecord(
            optimizer=optimizer, iteration=iteration, x=x, f=f, g=g,
            x_next=optimizer.x,
            metadata=getattr(optimizer, 'last_step_metadata', {}) or {},
        )
        records.append(record)
        decision = governor.observe(record)
        if decision.stop:
            return OptimizationResult(optimizer.x, decision, records, optimizer)
    decision = GovernorDecision(True, False, 'maximum iterations reached')
    return OptimizationResult(optimizer.x, decision, records, optimizer)


def _as_bound_array(bound, x0, default):
    if bound is None:
        return torch.full(x0.shape, default, dtype=x0.dtype, device=x0.device)
    bound = _like(bound, x0)
    if bound.shape == x0.shape:
        return bound
    if bound.numel() == x0.numel():
        return bound.reshape(x0.shape)
    raise ValueError('bounds must have the same shape or size as x0')


def _like(a, x):
    """a (tensor, array or numbers) as a tensor of x's dtype on x's device."""
    if not torch.is_tensor(a):
        a = np.asarray(a)
    return torch.as_tensor(a, dtype=x.dtype, device=x.device)


def _start(x0):
    """x0 as a tensor: tensors keep their dtype and device, the rest go to config."""
    return to_tensor(x0).detach()


class _Bounded:
    """Mixin: box-bound projection and gradient masking."""

    def _init_bounds(self, x0, lower_bounds, upper_bounds):
        self.l = _as_bound_array(lower_bounds, x0, -torch.inf)  # NOQA
        self.u = _as_bound_array(upper_bounds, x0, torch.inf)
        if bool(torch.any(self.l > self.u)):
            raise ValueError('lower_bounds must be <= upper_bounds')
        self._has_bounds = bool(torch.any(torch.isfinite(self.l))
                                or bool(torch.any(torch.isfinite(self.u))))
        self.x = self._project(self.x)
        self.last_step_metadata = {}

    def _project(self, x):
        if not self._has_bounds:
            return x
        return torch.clamp(x, self.l, self.u)

    def _project_gradient(self, g):
        """Zero gradient components blocked by active box constraints."""
        g = _like(g, self.x)
        if not self._has_bounds:
            return g
        x = self.x
        at_lower = torch.isfinite(self.l) & (x <= self.l) & (g > 0)
        at_upper = torch.isfinite(self.u) & (x >= self.u) & (g < 0)
        return torch.where(at_lower | at_upper, torch.zeros_like(g), g)

    def _store_metadata(self, g_step):
        if not self._has_bounds:
            self.last_step_metadata = {}
            return
        x = self.x
        at_lower = torch.isfinite(self.l) & (x <= self.l)
        at_upper = torch.isfinite(self.u) & (x >= self.u)
        active = at_lower | at_upper
        self.last_step_metadata = {
            'projected_gradient': g_step,
            'active_bounds': active,
            'bounded_variables': int(active.sum()),
        }


class GradientDescent(_Bounded):
    """Constant-step gradient descent: x <- x - alpha g."""

    def __init__(self, fg, x0, alpha, lower_bounds=None, upper_bounds=None):
        """fg(x) -> (f, g); x0 initial vector; alpha step size."""
        self.problem = as_problem(fg)
        self.x0 = _start(x0)
        self.alpha = alpha
        self.x = self.x0
        self._init_bounds(self.x0, lower_bounds, upper_bounds)
        self.iter = 0

    def step(self):
        """Perform one iteration of optimization."""
        f, g = self.problem.fg(self.x)
        g_step = self._project_gradient(g)
        x = self.x
        self.x = self._project(x - self.alpha * g_step)
        self.iter += 1
        self._store_metadata(g_step)
        return x, f, g


class _Accumulator(_Bounded):
    """Shared state for accumulator-based optimizers."""

    def __init__(self, fg, x0, alpha, lower_bounds=None, upper_bounds=None):
        self.problem = as_problem(fg)
        self.x0 = _start(x0)
        self.alpha = alpha
        self.x = self.x0
        self._init_bounds(self.x0, lower_bounds, upper_bounds)
        self.accumulator = torch.zeros_like(self.x)
        self.eps = float(torch.finfo(self.x0.dtype).eps)
        self.iter = 0


class _MomentBased(_Bounded):
    """Shared state for moment-based optimizers."""

    def __init__(self, fg, x0, alpha, beta1=0.9, beta2=0.999,
                 lower_bounds=None, upper_bounds=None):
        self.problem = as_problem(fg)
        self.x0 = _start(x0)
        self.alpha = alpha
        self.beta1 = beta1
        self.beta2 = beta2
        self.x = self.x0
        self._init_bounds(self.x0, lower_bounds, upper_bounds)
        self.m = torch.zeros_like(self.x0)
        self.v = torch.zeros_like(self.x0)
        self.eps = float(torch.finfo(self.x0.dtype).eps)
        self.iter = 0


class AdaGrad(_Accumulator):
    """Diagonal AdaGrad: accumulate g^2, step alpha g / sqrt(sum g^2)."""

    def step(self):
        """Perform one iteration of optimization."""
        f, g = self.problem.fg(self.x)
        g_step = self._project_gradient(g)
        self.accumulator = self.accumulator + g_step * g_step
        x = self.x
        step = self.alpha * g_step / (torch.sqrt(self.accumulator) + self.eps)
        self.x = self._project(x - step)
        self.iter += 1
        self._store_metadata(g_step)
        return x, f, g


class RMSProp(_Accumulator):
    """RMSProp: decayed moving average of g^2 scales the step."""

    def __init__(self, fg, x0, alpha, gamma=0.9,
                 lower_bounds=None, upper_bounds=None):
        super().__init__(fg, x0, alpha, lower_bounds, upper_bounds)
        self.gamma = gamma

    def step(self):
        """Perform one iteration of optimization."""
        gamma = self.gamma
        f, g = self.problem.fg(self.x)
        g_step = self._project_gradient(g)
        self.accumulator = gamma * self.accumulator + (1 - gamma) * (g_step * g_step)
        x = self.x
        step = self.alpha * g_step / (torch.sqrt(self.accumulator) + self.eps)
        self.x = self._project(x - step)
        self.iter += 1
        self._store_metadata(g_step)
        return x, f, g


class Adam(_MomentBased):
    """ADAM: bias-corrected first/second moment adaptive steps."""

    def step(self):
        """Perform one iteration of optimization."""
        self.iter += 1
        beta1, beta2 = self.beta1, self.beta2
        f, g = self.problem.fg(self.x)
        g_step = self._project_gradient(g)
        self.m = beta1 * self.m + (1 - beta1) * g_step
        self.v = beta2 * self.v + (1 - beta2) * (g_step * g_step)
        mhat = self.m / (1 - beta1 ** self.iter)
        vhat = self.v / (1 - beta2 ** self.iter)
        x = self.x
        step = self.alpha * mhat / (torch.sqrt(vhat) + self.eps)
        self.x = self._project(x - step)
        self._store_metadata(g_step)
        return x, f, g


class RAdam(_MomentBased):
    """Rectified Adam (Liu et al.): variance rectification when rho >= 5."""

    def __init__(self, fg, x0, alpha, beta1=0.9, beta2=0.999,
                 lower_bounds=None, upper_bounds=None):
        super().__init__(fg, x0, alpha, beta1, beta2, lower_bounds, upper_bounds)
        self.rhoinf = 2 / (1 - beta2) - 1

    def step(self):
        """Perform one iteration of optimization."""
        self.iter += 1
        k = self.iter
        beta1, beta2 = self.beta1, self.beta2
        beta2k = beta2 ** k
        f, g = self.problem.fg(self.x)
        g_step = self._project_gradient(g)
        self.m = beta1 * self.m + (1 - beta1) * g_step
        self.v = beta2 * self.v + (1 - beta2) * (g_step * g_step)
        rhoinf = self.rhoinf
        rho = rhoinf - (2 * k * beta2k) / (1 - beta2k)
        x = self.x
        if rho >= 5:
            mhat = self.m / (1 - beta1 ** k)
            ell = np.sqrt(1 - beta2k) / (torch.sqrt(self.v) + self.eps)
            num = (rho - 4) * (rho - 2) * rhoinf
            den = (rhoinf - 4) * (rhoinf - 2) * rho
            r = np.sqrt(num / den)
            self.x = self._project(x - self.alpha * r * mhat * ell)
        else:
            self.x = self._project(x - self.alpha * g_step)
        self._store_metadata(g_step)
        return x, f, g


class AdaMomentum(_MomentBased):
    """AdaMomentum (Wang et al.): v is built from m^2 instead of g^2."""

    def step(self):
        """Perform one iteration of optimization."""
        self.iter += 1
        beta1, beta2 = self.beta1, self.beta2
        f, g = self.problem.fg(self.x)
        g_step = self._project_gradient(g)
        self.m = beta1 * self.m + (1 - beta1) * g_step
        self.v = beta2 * self.v + (1 - beta2) * (self.m * self.m) + self.eps
        mhat = self.m / (1 - beta1 ** self.iter)
        vhat = self.v / (1 - beta2 ** self.iter)
        x = self.x
        self.x = self._project(x - self.alpha * mhat / torch.sqrt(vhat))
        self._store_metadata(g_step)
        return x, f, g


class Yogi(_MomentBased):
    """YOGI (Zaheer et al.): additive, sign-controlled second moment."""

    def step(self):
        """Perform one iteration of optimization."""
        self.iter += 1
        beta1, beta2 = self.beta1, self.beta2
        f, g = self.problem.fg(self.x)
        g_step = self._project_gradient(g)
        gsq = g_step * g_step
        self.m = beta1 * self.m + (1 - beta1) * g_step
        self.v = self.v - (1 - beta2) * torch.sign(self.v - gsq) * gsq
        mhat = self.m
        vhat = torch.sqrt(self.v + self.eps)
        x = self.x
        step = self.alpha * mhat / (torch.sqrt(vhat) + self.eps)
        self.x = self._project(x - step)
        self._store_metadata(g_step)
        return x, f, g
