"""Optimization problem protocol and callable adapter.

Counterpart of ``prysm_tpu/x/optym/problem.py``.  Missing derivatives come
from torch's function transforms (``torch.func.grad``, ``torch.func.hessian``,
``torch.func.jvp`` of the gradient) when the objective is traceable, and
fall through to host finite differences when it is not.
"""
import numpy as np
import torch

from ...conf import config, resolve_device

__all__ = ['Problem', 'as_problem', 'to_host']

_FD_METHODS = ('forward', 'central')


def to_host(a):
    """A tensor as a detached host numpy array; anything else through numpy."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _as_float_tensor(x):
    """x as a floating tensor: floating tensors pass through; the rest take
    ``config.precision`` on ``config.device`` (numpy floats keep their dtype)."""
    if torch.is_tensor(x):
        return x if x.is_floating_point() else x.to(config.precision)
    a = np.asarray(x)
    dtype = None if a.dtype.kind == 'f' else config.precision
    return torch.as_tensor(a, dtype=dtype, device=resolve_device())


class Problem:
    """Base class for optimization problems.

    Subclasses set has_* flags for the hooks they implement (_f, _g, _fg,
    _h, _hvp).  Missing derivatives are derived by autodiff when possible,
    else finite differences.  f, g, fg, h, hvp are the public API.
    """

    has_f = False
    has_g = False
    has_fg = False
    has_h = False
    has_hvp = False

    fd_method = 'central'
    fd_step = None
    autodiff = True

    def __init__(self, fd_method=None, fd_step=None, autodiff=None):
        if fd_method is not None:
            self.fd_method = fd_method
        if fd_step is not None:
            self.fd_step = fd_step
        if autodiff is not None:
            self.autodiff = autodiff
        if self.fd_method not in _FD_METHODS:
            raise ValueError(f'fd_method must be one of {_FD_METHODS}; '
                             f'got {self.fd_method!r}')

    # -- public API ---------------------------------------------------------
    def f(self, x):
        """Evaluate the scalar objective."""
        if self.has_f:
            return self._f(x)
        if self.has_fg:
            return self._fg(x)[0]
        raise NotImplementedError('Problem needs _f(x) or _fg(x)')

    def g(self, x):
        """Evaluate the objective gradient."""
        if self.has_g:
            return self._g(x)
        if self.has_fg:
            return self._fg(x)[1]
        if self.has_f:
            if self.autodiff:
                try:
                    return torch.func.grad(self._f)(_as_float_tensor(x))
                except Exception:
                    pass
            return self._finite_difference_g(x)
        raise NotImplementedError('Problem needs _g(x), _fg(x), or _f(x)')

    def fg(self, x):
        """Evaluate objective and gradient."""
        if self.has_fg:
            return self._fg(x)
        return self.f(x), self.g(x)

    def h(self, x):
        """Evaluate the dense Hessian."""
        if self.has_h:
            return self._h(x)
        if self.autodiff and self.has_f:
            try:
                return torch.func.hessian(self._f)(_as_float_tensor(x))
            except Exception:
                pass
        return self._finite_difference_h(x)

    def hvp(self, x, v):
        """Evaluate the Hessian-vector product H(x) @ v."""
        if self.has_hvp:
            return self._hvp(x, v)
        if self.has_h:
            return self.h(x) @ v
        if self.autodiff and self.has_f:
            try:
                x = _as_float_tensor(x)
                v = _as_float_tensor(v).to(x)
                return torch.func.jvp(torch.func.grad(self._f), (x,), (v,))[1]
            except Exception:
                pass
        return self._finite_difference_hvp(x, v)

    # -- finite difference fallbacks ---------------------------------------
    def _as_float_array(self, x):
        x = to_host(x)
        if not np.issubdtype(x.dtype, np.floating):
            x = x.astype(float)
        return x

    def _fd_exponent(self):
        return 0.5 if self.fd_method == 'forward' else 1 / 3

    def _fd_steps(self, x):
        base = self.fd_step
        if base is None:
            base = np.finfo(x.dtype).eps ** self._fd_exponent()
        return base * np.maximum(1, np.abs(x))

    def _finite_difference_g(self, x):
        x = self._as_float_array(x)
        g = np.empty_like(x)
        steps = self._fd_steps(x)
        xf = x.ravel()
        gf = g.ravel()
        hf = steps.ravel()
        if self.fd_method == 'forward':
            f0 = float(self.f(x))
        for j in range(xf.size):
            h = hf[j]
            xp = x.copy()
            xp.ravel()[j] = xf[j] + h
            fp = float(self.f(xp))
            if self.fd_method == 'forward':
                gf[j] = (fp - f0) / h
            else:
                xm = x.copy()
                xm.ravel()[j] = xf[j] - h
                fm = float(self.f(xm))
                gf[j] = (fp - fm) / (2 * h)
        return g

    def _finite_difference_h(self, x):
        x = self._as_float_array(x)
        n = x.size
        H = np.empty((n, n), dtype=x.dtype)
        steps = self._fd_steps(x).ravel()
        g0 = to_host(self.g(x)).astype(float).ravel()
        for j in range(n):
            h = steps[j]
            xp = x.copy()
            xp.ravel()[j] += h
            gp = to_host(self.g(xp)).astype(float).ravel()
            H[:, j] = (gp - g0) / h
        return 0.5 * (H + H.T)

    def _finite_difference_hvp(self, x, v):
        x = self._as_float_array(x)
        v = to_host(v).astype(float)
        base = self.fd_step
        if base is None:
            base = np.finfo(x.dtype).eps ** self._fd_exponent()
        v_norm = np.linalg.norm(v)
        if v_norm == 0:
            return np.zeros_like(v)
        h = base * max(1, np.linalg.norm(x)) / v_norm
        gp = to_host(self.g(x + h * v)).astype(float)
        gm = to_host(self.g(x - h * v)).astype(float)
        return (gp - gm) / (2 * h)


class _CallableProblem(Problem):
    """Problem adapter over a callable fg(x) -> (f, g)."""

    has_fg = True

    def __init__(self, fg):
        super().__init__()
        self._fg_callable = fg

    def _fg(self, x):
        return self._fg_callable(x)


class _ScalarCallableProblem(Problem):
    """Problem adapter over a scalar callable f(x); gradient by torch.func."""

    has_f = True

    def __init__(self, f):
        super().__init__()
        self._f_callable = f
        self._gv = torch.func.grad_and_value(f)

    def _f(self, x):
        return self._f_callable(x)

    def fg(self, x):
        """Value and gradient in one traced pass."""
        try:
            g, f = self._gv(_as_float_tensor(x))
            return f, g
        except Exception:
            return self.f(x), self._finite_difference_g(x)


def as_problem(fg_or_problem, scalar=False):
    """Coerce a callable or Problem into a Problem.

    Callables are assumed to return (f, g); pass scalar=True for objectives
    returning only f (the gradient then comes from torch.func.grad).
    """
    if isinstance(fg_or_problem, Problem):
        return fg_or_problem
    if hasattr(fg_or_problem, 'fg') and callable(fg_or_problem.fg):
        return fg_or_problem
    if callable(fg_or_problem):
        if scalar:
            return _ScalarCallableProblem(fg_or_problem)
        return _CallableProblem(fg_or_problem)
    raise TypeError('fg must be callable or a Problem')
