"""Canonical optimization test problems.

Counterpart of ``prysm_tpu/x/optym/sample_problems.py``.  Objectives are
plain torch expressions; gradients, Hessians and Hessian-vector products
come from ``torch.func``, so every derivative order is consistent by
construction.
"""
import math

import torch

from .problem import Problem, _as_float_tensor

__all__ = ['SphereProblem', 'RosenbrockProblem', 'RastriginProblem', 'HimmelblauProblem',
           'sphere', 'rosenbrock', 'rastrigin', 'himmelblau']


class _AutodiffProblem(Problem):
    """Problem whose derivative hooks are exact torch.func transforms."""

    has_f = has_g = has_fg = has_h = has_hvp = True

    def _g(self, x):
        return torch.func.grad(self._f)(_as_float_tensor(x))

    def _fg(self, x):
        g, f = torch.func.grad_and_value(self._f)(_as_float_tensor(x))
        return f, g

    def _h(self, x):
        x = _as_float_tensor(x)
        shape = x.shape

        def flat_f(xf):
            return self._f(xf.reshape(shape))

        return torch.func.hessian(flat_f)(x.ravel())

    def _hvp(self, x, v):
        x = _as_float_tensor(x)
        v = _as_float_tensor(v).to(x)
        return torch.func.jvp(torch.func.grad(self._f), (x,), (v,))[1]


class SphereProblem(_AutodiffProblem):
    """Sphere function; global minimum f(0) = 0."""

    def _f(self, x):
        x = _as_float_tensor(x)
        return (x * x).sum()


class RosenbrockProblem(_AutodiffProblem):
    """Rosenbrock function; global minimum f([1, ..., 1]) = 0."""

    def _f(self, x):
        x = _as_float_tensor(x)
        if x.numel() < 2:
            raise ValueError('rosenbrock requires at least two variables')
        xf = x.ravel()
        diff = xf[1:] - xf[:-1] * xf[:-1]
        offset = 1 - xf[:-1]
        return (100 * diff * diff + offset * offset).sum()


class RastriginProblem(_AutodiffProblem):
    """Rastrigin function; global minimum f(0) = 0."""

    def _f(self, x):
        x = _as_float_tensor(x)
        arg = 2 * math.pi * x
        return 10 * x.numel() + (x * x - 10 * torch.cos(arg)).sum()


class HimmelblauProblem(_AutodiffProblem):
    """Himmelblau's function; one global minimum is f([3, 2]) = 0."""

    def _f(self, x):
        x = _as_float_tensor(x)
        if x.numel() != 2:
            raise ValueError('himmelblau requires exactly two variables')
        x0, x1 = x.ravel()
        a = x0 * x0 + x1 - 11
        b = x0 + x1 * x1 - 7
        return a * a + b * b


_SPHERE = SphereProblem()
_ROSENBROCK = RosenbrockProblem()
_RASTRIGIN = RastriginProblem()
_HIMMELBLAU = HimmelblauProblem()


def sphere(x):
    """Sphere function (f, g); global minimum f(0) = 0."""
    return _SPHERE.fg(x)


def rosenbrock(x):
    """Rosenbrock function (f, g); global minimum f([1, ..., 1]) = 0."""
    return _ROSENBROCK.fg(x)


def rastrigin(x):
    """Rastrigin function (f, g); global minimum f(0) = 0."""
    return _RASTRIGIN.fg(x)


def himmelblau(x):
    """Himmelblau's function (f, g); one global minimum is f([3, 2]) = 0."""
    return _HIMMELBLAU.fg(x)
