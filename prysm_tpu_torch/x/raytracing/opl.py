"""Optical-path-length modifiers attached to raytracing surfaces.

Counterpart of ``prysm_tpu/x/raytracing/opl.py``.  Wavelength-aware OPL
functions (gratings, holograms) whose in-plane gradient drives the
tangential momentum kick in Surface.diffract.  Local coordinates mm,
wavelength um, OPL mm.  Coordinates are tensors; a host array becomes a
tensor on ``config.device``.

Numerical derivatives live in free functions (:func:`central_gradient`,
:func:`central_hessian`) so any OPL callable — not just subclasses — can be
differentiated the same way.
"""
import numpy as onp
import torch

from ...conf import to_tensor
from .sags import fd_step


def central_gradient(f, x, y, wavelength, h):
    """(f, df/dx, df/dy) by central differences with step ``h``."""
    value = f(x, y, wavelength)
    gx = (f(x + h, y, wavelength) - f(x - h, y, wavelength)) / (2.0 * h)
    gy = (f(x, y + h, wavelength) - f(x, y - h, wavelength)) / (2.0 * h)
    return value, gx, gy


def central_hessian(grad_f, x, y, wavelength, h):
    """(f_xx, f_xy, f_yy) by differencing a gradient function."""
    _, gx_e, _ = grad_f(x + h, y, wavelength)
    _, gx_w, _ = grad_f(x - h, y, wavelength)
    _, gx_n, gy_n = grad_f(x, y + h, wavelength)
    _, gx_s, gy_s = grad_f(x, y - h, wavelength)
    return ((gx_e - gx_w) / (2.0 * h),
            (gx_n - gx_s) / (2.0 * h),
            (gy_n - gy_s) / (2.0 * h))


class OPLFunc:
    """Base class for wavelength-aware optical-path modifiers."""

    finite_difference_step = None

    def opl(self, x, y, wavelength):
        """Optical path length in millimeters."""
        raise NotImplementedError('OPLFunc subclasses define opl()')

    def opl_and_gradient(self, x, y, wavelength):
        """(opl, gx, gy); central differences unless overridden."""
        x, y = to_tensor(x), to_tensor(y)
        h = fd_step(self.finite_difference_step, x, y)
        return central_gradient(self.opl, x, y, wavelength, h)

    def opl_hessian(self, x, y, wavelength):
        """(OPL_xx, OPL_xy, OPL_yy); central differences unless overridden."""
        x, y = to_tensor(x), to_tensor(y)
        h = fd_step(self.finite_difference_step, x, y)
        return central_hessian(self.opl_and_gradient, x, y, wavelength, h)


def _finite_scalar(value, label):
    value = float(value)
    if not onp.isfinite(value):
        raise ValueError(f'{label} must be finite')
    return value


class _CheckedAttr:
    """Data descriptor applying a coercion/validation on assignment."""

    def __init__(self, coerce):
        self.coerce = coerce

    def __set_name__(self, owner, name):
        self.slot = '_' + name

    def __get__(self, obj, objtype=None):
        return self if obj is None else getattr(obj, self.slot)

    def __set__(self, obj, value):
        setattr(obj, self.slot, self.coerce(value))


def _coerce_period(value):
    value = _finite_scalar(value, 'grating period')
    if value <= 0.0:
        raise ValueError('grating period must be finite and positive')
    return value


def _coerce_g_vec(value):
    components = onp.atleast_1d(onp.asarray(value, dtype=float)).ravel()
    if components.size == 0:
        raise ValueError('g_vec must contain at least one component')
    pair = (components[0], components[1] if components.size > 1 else 0.0)
    return tuple(_finite_scalar(c, 'g_vec component') for c in pair)


class LinearGrating(OPLFunc):
    """Ideal linear grating as a wavelength-dependent OPL ramp.

    period mm; g_vec the in-plane grating-vector direction; order the
    diffracted order.
    """

    period = _CheckedAttr(_coerce_period)
    order = _CheckedAttr(lambda v: _finite_scalar(v, 'grating order'))
    g_vec = _CheckedAttr(_coerce_g_vec)

    def __init__(self, period, g_vec=(1.0, 0.0), order=1):
        self.period, self.order, self.g_vec = period, order, g_vec

    def _ramp_slope(self, wavelength):
        """Constant in-plane OPL gradient at this wavelength (mm/mm)."""
        scale = self.order * (float(wavelength) * 1e-3) / self.period
        return scale * self.g_vec[0], scale * self.g_vec[1]

    def opl(self, x, y, wavelength):
        """Unwrapped grating OPL ramp in millimeters."""
        gx, gy = self._ramp_slope(wavelength)
        return gx * x + gy * y

    def opl_and_gradient(self, x, y, wavelength):
        """The OPL ramp and its constant spatial gradient."""
        x, y = to_tensor(x), to_tensor(y)
        gx, gy = self._ramp_slope(wavelength)
        return (gx * x + gy * y,
                torch.full(x.shape, gx, dtype=x.dtype, device=x.device),
                torch.full(x.shape, gy, dtype=x.dtype, device=x.device))

    def opl_hessian(self, x, y, wavelength):
        """The Hessian of a linear ramp is zero."""
        flat = torch.zeros_like(to_tensor(x))
        return flat, flat, flat

    def __repr__(self):
        shown = int(self.order) if self.order.is_integer() else self.order
        return (f'LinearGrating(period={self.period!r}, '
                f'g_vec={self.g_vec!r}, order={shown!r})')


class CallableOPL(OPLFunc):
    """OPLFunc wrapping wavelength-aware user callables."""

    def __init__(self, opl, opl_and_gradient=None, opl_hessian=None):
        if not callable(opl):
            raise TypeError('CallableOPL needs a callable for opl')
        self._hooks = {'opl': opl, 'grad': opl_and_gradient,
                       'hess': opl_hessian}

    def opl(self, x, y, wavelength):
        """User OPL."""
        return self._hooks['opl'](x, y, wavelength)

    def opl_and_gradient(self, x, y, wavelength):
        """User (opl, gx, gy), else finite differences."""
        hook = self._hooks['grad']
        if hook is None:
            return super().opl_and_gradient(x, y, wavelength)
        return hook(x, y, wavelength)

    def opl_hessian(self, x, y, wavelength):
        """User Hessian, else finite differences."""
        hook = self._hooks['hess']
        if hook is None:
            return super().opl_hessian(x, y, wavelength)
        return hook(x, y, wavelength)


__all__ = ['OPLFunc', 'CallableOPL', 'LinearGrating']
