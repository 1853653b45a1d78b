"""RichData container and Slices azimuthal-statistics views.

Counterpart of ``prysm_tpu/_richdata.py``.  RichData wraps a tensor with
its sample spacing and wavelength and builds its coordinate grids lazily,
in the data's real dtype and on its device.  Interpolation is the port's
bilinear lookup (``coordinates._bilinear_lookup``), on the device.  The
JAX package registers RichData as a pytree; torch has no counterpart, so
the port does not.

A numpy array given as data becomes a tensor of ``config.precision``
(``config.precision_complex`` when complex) on ``config.device``, as the
JAX package's ``jnp.asarray`` takes its working dtype; a tensor is kept
as it is.
"""
import copy
from collections.abc import Iterable

import numpy as np
import torch

from .conf import config, resolve_device
from .coordinates import (
    make_xy_grid,
    cart_to_polar,
    polar_to_cart,
    optimize_xy_separable,
    uniform_cart_to_polar,
    _bilinear_lookup,
)

__all__ = ['fix_interp_pair', 'RichData', 'Slices']


def fix_interp_pair(x, y):
    """Ensure x, y have the same shape; scalars broadcast against iterables."""
    if y is None:
        y = 0
    if x is None:
        x = 0
    if isinstance(x, Iterable) and not isinstance(y, Iterable):
        y = [y] * len(x)
    elif isinstance(y, Iterable) and not isinstance(x, Iterable):
        x = [x] * len(y)
    return x, y


def _as_data(d):
    """A tensor kept as it is; an array as a tensor of the working dtype on config.device."""
    if d is None or torch.is_tensor(d):
        return d
    a = np.asarray(d)
    if a.dtype.kind == 'c':
        dtype = config.precision_complex
    elif a.dtype.kind == 'f':
        dtype = config.precision
    else:
        dtype = None
    return torch.as_tensor(a, dtype=dtype, device=resolve_device())


def _real_dtype(t):
    """The real dtype of a floating or complex tensor; config.precision otherwise."""
    if t.is_complex():
        return t.real.dtype
    return t.dtype if t.is_floating_point() else config.precision


def _points(v, like):
    """Query coordinates as a tensor of like's dtype on like's device."""
    if torch.is_tensor(v):
        return v.to(device=like.device)
    return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=like.dtype, device=like.device)


class RichData:
    """2D data + sample spacing + wavelength with lazy coordinate grids."""

    _default_twosided = True

    def __init__(self, data, dx, wavelength):
        """data: 2D tensor; dx: sample spacing; wavelength: um (or None)."""
        self.data = data
        self.dx = dx
        self.wavelength = wavelength
        self._x = self._y = self._r = self._t = None

    @property
    def data(self):
        """The underlying tensor."""
        return self._data

    @data.setter
    def data(self, d):
        self._data = _as_data(d)
        self._x = self._y = self._r = self._t = None

    @property
    def shape(self):
        """Proxy to data shape."""
        return self.data.shape

    @property
    def size(self):
        """Proxy to data size."""
        return self.data.numel()

    def _make_grid(self):
        self._x, self._y = make_xy_grid(tuple(self.shape), dx=self.dx,
                                        dtype=_real_dtype(self.data), device=self.data.device)

    @property
    def x(self):
        """X coordinate grid, lazily built."""
        if self._x is None:
            self._make_grid()
        return self._x

    @x.setter
    def x(self, value):
        """Replace the X grid; the polar grids derived from it are dropped."""
        self._x = value
        self._r = self._t = None

    @property
    def y(self):
        """Y coordinate grid, lazily built."""
        if self._y is None:
            self._make_grid()
        return self._y

    @y.setter
    def y(self, value):
        """Replace the Y grid; the polar grids derived from it are dropped."""
        self._y = value
        self._r = self._t = None

    @property
    def r(self):
        """Radial coordinate grid, lazily built."""
        if self._r is None:
            self._r, self._t = cart_to_polar(self.x, self.y)
        return self._r

    @r.setter
    def r(self, value):
        self._r = value

    @property
    def t(self):
        """Azimuthal coordinate grid, lazily built."""
        if self._t is None:
            self._r, self._t = cart_to_polar(self.x, self.y)
        return self._t

    @t.setter
    def t(self, value):
        self._t = value

    @property
    def support_x(self):
        """Width of the domain along x."""
        return self.shape[1] * self.dx

    @property
    def support_y(self):
        """Width of the domain along y."""
        return self.shape[0] * self.dx

    @property
    def support(self):
        """Maximum width of the domain."""
        return max((self.support_x, self.support_y))

    def copy(self):
        """Return a (deep) copy of this instance."""
        return copy.deepcopy(self)

    def slices(self, twosided=None):
        """Create a Slices instance from this instance."""
        if twosided is None:
            twosided = self._default_twosided
        x, y = self.x, self.y
        return Slices(data=self.data, x=x[0], y=y[..., 0], twosided=twosided)

    def _lookup(self, x, y):
        xg, yg = optimize_xy_separable(self.x, self.y)
        xv = xg.ravel()
        yv = yg.ravel()
        cols = (_points(x, xv) - xv[0]) / self.dx
        rows = (_points(y, yv) - yv[0]) / self.dx
        return _bilinear_lookup(self.data, rows, cols)

    def exact_polar(self, rho, phi=None):
        """Data at the specified (rho, phi) coordinate pairs (bilinear)."""
        rho, phi = fix_interp_pair(rho, phi)
        like = self.x
        x, y = polar_to_cart(_points(rho, like), _points(phi, like))
        return self._lookup(x, y)

    def exact_xy(self, x, y=None):
        """Data at the specified (x, y) coordinate pairs (bilinear)."""
        x, y = fix_interp_pair(x, y)
        return self._lookup(x, y)

    def exact_x(self, x):
        """Data along the y=0 slice at exact x coordinates."""
        return self.exact_xy(x, 0)

    def exact_y(self, y):
        """Data along the x=0 slice at exact y coordinates."""
        return self.exact_xy(0, y)

    def astype(self, dtype):
        """Return a copy of self with data cast to dtype."""
        out = self.copy()
        out.data = self.data.to(dtype)
        return out

    def plot2d(self, xlim=None, ylim=None, clim=None, cmap=None,
               log=False, power=1, interpolation=None,
               show_colorbar=True, colorbar_label=None, extend='both',
               axis_labels=(None, None), zorder=3, fig=None, ax=None):
        """Plot the data as an image with its spatial extent (host-side)."""
        from numbers import Number
        from matplotlib import colors
        from .plotting import share_fig_ax
        if isinstance(xlim, Number):
            xlim = (-xlim, xlim)
        if isinstance(ylim, Number):
            ylim = (-ylim, ylim)
        fig, ax = share_fig_ax(fig, ax)
        data = self.data.detach().cpu().numpy()
        if log:
            norm = colors.LogNorm()
        elif power != 1:
            norm = colors.PowerNorm(power)
        else:
            norm = None
        extx = self.support_x / 2
        exty = self.support_y / 2
        im = ax.imshow(data, extent=[-extx, extx, -exty, exty], cmap=cmap,
                       norm=norm, clim=clim, origin='lower',
                       interpolation=interpolation, zorder=zorder)
        if show_colorbar:
            fig.colorbar(im, ax=ax, label=colorbar_label, fraction=0.046,
                         extend=extend)
        ax.set(xlabel=axis_labels[0], ylabel=axis_labels[1], xlim=xlim, ylim=ylim)
        return fig, ax


def _nan_count(a):
    """(a with NaNs zeroed, the count of the others along axis 0)."""
    keep = ~torch.isnan(a)
    return torch.where(keep, a, torch.zeros_like(a)), torch.sum(keep, dim=0)


def _nan_to_all_nan(value, count):
    """value where the column had a sample; NaN where it had none."""
    return torch.where(count > 0, value, torch.full_like(value, float('nan')))


def nanmedian(a):
    """Median along axis 0 ignoring NaNs; an even count averages the two middle values.

    ``torch.nanmedian`` returns the lower of the two, ``jnp.nanmedian``
    their mean: this is the latter.
    """
    s = torch.sort(a, dim=0).values          # NaNs sort last
    n = torch.sum(~torch.isnan(a), dim=0)
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    low = torch.gather(s, 0, lo[None])[0]
    high = torch.gather(s, 0, hi[None])[0]
    return _nan_to_all_nan(0.5 * low + 0.5 * high, n)


def nanmin(a):
    """Minimum along axis 0 ignoring NaNs (NaN where a column has none)."""
    n = torch.sum(~torch.isnan(a), dim=0)
    return _nan_to_all_nan(torch.amin(torch.where(torch.isnan(a), torch.inf, a), dim=0), n)


def nanmax(a):
    """Maximum along axis 0 ignoring NaNs (NaN where a column has none)."""
    n = torch.sum(~torch.isnan(a), dim=0)
    return _nan_to_all_nan(torch.amax(torch.where(torch.isnan(a), -torch.inf, a), dim=0), n)


def nanvar(a):
    """Variance (ddof 0) along axis 0 ignoring NaNs."""
    zeroed, n = _nan_count(a)
    mean = torch.sum(zeroed, dim=0) / n
    centered = torch.where(torch.isnan(a), torch.zeros_like(a), a - mean)
    return torch.sum(centered * centered, dim=0) / n


class Slices:
    """x/y cuts and azimuthal statistics of a 2D array."""

    def __init__(self, data, x, y, twosided=True):
        """data 2D; x, y 1D coordinate vectors; twosided controls extents."""
        self._source = data
        self._source_polar = None
        self._r = None
        self._p = None
        self._x = x
        self._y = y
        self.center_y = int(torch.argmin(torch.abs(y)))
        self.center_x = int(torch.argmin(torch.abs(x)))
        self.twosided = twosided

    def check_polar_calculated(self):
        """Ensure the polar representation of the source data is computed."""
        if self._source_polar is None:
            rho, phi, polar = uniform_cart_to_polar(self._x, self._y, self._source)
            self._r, self._p = rho, phi
            self._source_polar = polar

    @property
    def x(self):
        """(x coords, data) along the y=0 slice."""
        if self.twosided:
            return self._x, self._source[self.center_y, :]
        return (self._x[self.center_x:],
                self._source[self.center_y, self.center_x:])

    @property
    def y(self):
        """(y coords, data) along the x=0 slice."""
        if self.twosided:
            return self._y, self._source[:, self.center_x]
        return (self._y[self.center_y:],
                self._source[self.center_y:, self.center_x])

    @property
    def azavg(self):
        """(rho, azimuthal average)."""
        self.check_polar_calculated()
        return self._r, torch.nanmean(self._source_polar, dim=0)

    @property
    def azmedian(self):
        """(rho, azimuthal median)."""
        self.check_polar_calculated()
        return self._r, nanmedian(self._source_polar)

    @property
    def azmin(self):
        """(rho, azimuthal minimum)."""
        self.check_polar_calculated()
        return self._r, nanmin(self._source_polar)

    @property
    def azmax(self):
        """(rho, azimuthal maximum)."""
        self.check_polar_calculated()
        return self._r, nanmax(self._source_polar)

    @property
    def azpv(self):
        """(rho, azimuthal peak-to-valley)."""
        r, mx = self.azmax
        _, mn = self.azmin
        return r, mx - mn

    @property
    def azvar(self):
        """(rho, azimuthal variance)."""
        self.check_polar_calculated()
        return self._r, nanvar(self._source_polar)

    @property
    def azstd(self):
        """(rho, azimuthal standard deviation)."""
        self.check_polar_calculated()
        return self._r, torch.sqrt(nanvar(self._source_polar))

    def plot(self, slices, lw=None, alpha=None, zorder=None, invert_x=False,
             xlim=(None, None), xscale='linear',
             ylim=(None, None), yscale='log',
             show_legend=True, axis_labels=(None, None),
             fig=None, ax=None):
        """Plot named slices ('x', 'y', 'azavg', ...) on shared axes.

        lw/alpha/zorder may be scalars (applied to every slice) or
        sequences parallel to ``slices``; a scalar ``xlim`` means
        (-xlim, xlim) when the slices are two-sided.
        """
        from numbers import Number
        from .plotting import share_fig_ax

        if isinstance(slices, str):
            slices = [slices]
        if alpha is None or isinstance(alpha, Number):
            alpha = [alpha] * len(slices)
        if lw is None or isinstance(lw, Number):
            lw = [lw or 2] * len(slices)
        if zorder is None or isinstance(zorder, int):
            zorder = [zorder or 3] * len(slices)
        if not hasattr(xlim, '__iter__') and self.twosided:
            xlim = (-xlim, xlim)

        fig, ax = share_fig_ax(fig, ax)
        for slice_, alpha_, lw_, zorder_ in zip(slices, alpha, lw, zorder):
            u, v = getattr(self, slice_)
            u = u.detach().cpu().numpy().copy()
            v = v.detach().cpu().numpy().copy()
            if invert_x:
                # 1/u explodes at DC; blank those samples instead
                zeros = np.abs(u) < 1e-9
                u[zeros] = np.nan
                v[zeros] = np.nan
                u = 1 / u
            ax.plot(u, v, lw=lw_, alpha=alpha_, zorder=zorder_, label=slice_)
        if show_legend:
            ax.legend(title='Slice')
        ax.set(xscale=xscale, xlim=xlim, yscale=yscale, ylim=ylim,
               xlabel=axis_labels[0], ylabel=axis_labels[1])
        if invert_x:
            ax.invert_xaxis()
        return fig, ax
