"""Math helpers (counterpart of ``prysm_tpu/mathops.py``).

The JAX package's user-facing backend shim (``BackendShim`` and the
``set_backend_to_*`` functions) is not ported: the port has one backend,
PyTorch.
"""
from numbers import Number

import numpy as np
import torch

from .conf import device_as, to_tensor

__all__ = ['cis', 'cexp', 'jinc', 'row_dot', 'is_odd', 'is_power_of_2', 'sign',
           'kronecker', 'gamma', 'host_planner', 'array_to_true_numpy']


def cis(theta):
    """exp(i theta) for real theta, as a native complex tensor (Python numbers too)."""
    theta = to_tensor(theta)
    return torch.polar(torch.ones_like(theta), theta)


def cexp(z):
    """exp(z) for complex z: exp(Re z) * (cos(Im z) + i sin(Im z)); real z gives exp(z)."""
    z = to_tensor(z)
    if not z.is_complex():
        return torch.exp(z)
    return torch.exp(z.real) * cis(z.imag)


def jinc(r):
    """Jinc: J1(r) / r for r != 0, 0.5 at r = 0 (first zero at r = pi).

    The singular point is substituted before the division, so the function
    is differentiable away from it.
    """
    r = to_tensor(r)
    near0 = torch.abs(r) < 1e-8
    safe = torch.where(near0, torch.ones_like(r), r)
    return torch.where(near0, torch.full_like(r, 0.5), _j1(safe) / safe)


def _j1(x):
    """Bessel J1 by the Abramowitz & Stegun rational approximations.

    The same rational forms and constants as the JAX package, so both
    packages evaluate the same function (not ``torch.special.bessel_j1``).
    """
    x = to_tensor(x)
    ax = torch.abs(x)

    # |x| < 8: polynomial in x^2
    y_small = x * x
    num_s = x * (72362614232.0 + y_small * (-7895059235.0 + y_small * (
        242396853.1 + y_small * (-2972611.439 + y_small * (
            15704.48260 + y_small * -30.16036606)))))
    den_s = 144725228442.0 + y_small * (2300535178.0 + y_small * (
        18583304.74 + y_small * (99447.43394 + y_small * (
            376.9991397 + y_small))))
    small = num_s / den_s

    # |x| >= 8: asymptotic form
    z = 8.0 / torch.clamp(ax, min=1e-30)
    y_big = z * z
    xx = ax - 2.356194491
    p0 = 1.0 + y_big * (0.183105e-2 + y_big * (-0.3516396496e-4 + y_big * (
        0.2457520174e-5 + y_big * -0.240337019e-6)))
    p1 = 0.04687499995 + y_big * (-0.2002690873e-3 + y_big * (
        0.8449199096e-5 + y_big * (-0.88228987e-6 + y_big * 0.105787412e-6)))
    big = torch.sqrt(0.636619772 / torch.clamp(ax, min=1e-30)) * (
        torch.cos(xx) * p0 - z * torch.sin(xx) * p1)
    big = big * torch.sign(x)

    return torch.where(ax < 8.0, small, big)


def row_dot(a, b):
    """Batched dot product over the trailing axis: sum(a * b, axis=-1)."""
    return torch.sum(a * b, dim=-1)


def is_odd(int_to_check):
    """Whether an integer is odd (host-side)."""
    return int_to_check & 0x1


def is_power_of_2(value):
    """Whether a value is a power of 2 (host-side); 1 is not."""
    if value == 1:
        return False
    return bool(value) and not value & (value - 1)


def sign(x):
    """Sign of a scalar with sign(0) = 1 (host-side, Zernike index math)."""
    return -1 if x < 0 else 1


def kronecker(i, j):
    """Kronecker delta (host-side)."""
    return 1 if i == j else 0


def gamma(n, m):
    """Recursive gamma coefficient (host-side scalar)."""
    if n == 1 and m == 2:
        return 3 / 8
    elif n == 1 and m > 2:
        mm1 = m - 1
        coef = (2 * mm1 + 1) / (2 * (mm1 - 1))
        return coef * gamma(1, mm1)
    else:
        nm1 = n - 1
        num = (nm1 + 1) * (2 * m + 2 * nm1 - 1)
        den = (m + nm1 - 2) * (2 * nm1 + 1)
        return (num / den) * gamma(nm1, m)



def host_planner():
    """Context manager running planner math on the CPU: ``config.device`` is the
    CPU inside it and is restored on exit.

    Library planners (composite apertures, DM setup, executor plans) then
    build host tensors, which a caller can move to the card once::

        with host_planner():
            ifn = build_influence_functions(...)
        ifn = ifn.to('cuda')
    """
    return device_as('cpu')


def array_to_true_numpy(*args):
    """Convert arrays from any backend to bona fide host numpy arrays.

    Tensors on any device are copied to the host (``Tensor.numpy(force=True)``);
    Python and numpy scalars and numpy arrays pass through.  Returns a single
    array for a single input, else a list; None for no input.
    """
    if len(args) == 0:
        return None
    out = []
    for arg in args:
        if isinstance(arg, (Number, np.generic, np.ndarray)):
            out.append(arg)
        elif torch.is_tensor(arg):
            out.append(arg.numpy(force=True))
        elif hasattr(arg, 'get'):  # cupy
            out.append(arg.get())
        else:  # other array-protocol libraries
            out.append(np.array(arg))
    if len(out) == 1:
        return out[0]
    return out
