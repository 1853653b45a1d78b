"""Plotting for coating designs.

Counterpart of ``prysm_tpu/x/coatings/plotting.py``: spectrum, index
profile, standing-wave intensity, admittance diagram, and monitoring
traces.  Matplotlib is imported when a figure is drawn.

The device math stays in :mod:`.stack` / :mod:`.monitoring`; this module
only pulls results to host numpy and styles axes.  Each plot is a thin
composition of a data-extraction helper and :func:`_styled`.
"""
import numpy as np

from ...plotting import share_fig_ax
from ..optym.problem import to_host as _host
from .stack import RTA, field_at_depth, internal_fields
from .monitoring import monitoring_trace


def _styled(fig, ax, xlabel, ylabel):
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    return fig, ax


def _layer_edges(stack):
    """Depth of every layer boundary, ambient side first (len(stack)+1,)."""
    depths = np.zeros(len(stack) + 1)
    np.cumsum(_host(stack.thicknesses), out=depths[1:])
    return depths


def _depth_axis(stack, n_points):
    edges = _layer_edges(stack)
    return edges, np.linspace(0.0, float(edges[-1]), n_points)


_SPECTRUM_LABELS = {'R': 'reflectance', 'T': 'transmittance',
                    'A': 'absorptance'}


def _spectrum_series(stack, wvls, theta, pol):
    """{'R','T','A'} -> host arrays, with 'avg' = unpolarized mean."""
    if pol == 'avg':
        per_pol = [_spectrum_series(stack, wvls, theta, p) for p in 'sp']
        return {key: 0.5 * (per_pol[0][key] + per_pol[1][key])
                for key in _SPECTRUM_LABELS}
    R, T, _ = (_host(v) for v in RTA(stack, wvls, theta, pol))
    return {'R': R, 'T': T, 'A': 1.0 - R - T}


def plot_spectrum(stack, wvls, theta=0.0, pol='avg', quantities=('R', 'T'),
                  fig=None, ax=None):
    """Reflectance / transmittance / absorptance vs wavelength."""
    wvls = _host(wvls)
    series = _spectrum_series(stack, wvls, theta, pol)
    unknown = set(quantities) - set(series)
    if unknown:
        raise ValueError(f'unknown spectrum quantities {sorted(unknown)}; '
                         f'choose from {sorted(series)}')
    fig, ax = share_fig_ax(fig, ax)
    for q in quantities:
        ax.plot(wvls, series[q], label=_SPECTRUM_LABELS[q])
    ax.legend()
    return _styled(fig, ax, 'wavelength [um]', 'fraction of incident power')


def plot_index_profile(stack, wvl=0.55, fig=None, ax=None):
    """Step plot of refractive index versus depth through the stack."""
    edges = _layer_edges(stack)
    ns = np.real(np.array([complex(_host(n).item())
                           for n in stack.resolved_indices(wvl)]))
    fig, ax = share_fig_ax(fig, ax)
    # post-step: each layer holds its index until the next boundary
    ax.step(edges, np.append(ns, ns[-1]), where='post', c='C0')
    return _styled(fig, ax, 'depth [um]', 'refractive index')


def plot_field_intensity(stack, wvl, theta=0.0, pol='s', n_points=1000,
                         fig=None, ax=None):
    """Standing-wave intensity abs(E(z))^2 through the stack."""
    edges, z = _depth_axis(stack, n_points)
    E, _ = field_at_depth(stack, z, wvl, theta, pol)
    fig, ax = share_fig_ax(fig, ax)
    ax.plot(z, np.square(np.abs(_host(E))), c='C3')
    for boundary in edges[1:-1]:
        ax.axvline(boundary, c='k', lw=0.5, alpha=0.3)
    return _styled(fig, ax, 'depth [um]', '|E|^2 (incident = 1)')


def plot_admittance(stack, wvl, theta=0.0, pol='s', n_points=2000,
                    fig=None, ax=None):
    """The admittance diagram: the H/E locus through the stack."""
    _, z = _depth_axis(stack, n_points)
    locus = np.divide(*(_host(v)
                        for v in reversed(field_at_depth(stack, z, wvl,
                                                         theta, pol))))
    marks = np.divide(*(_host(v)
                        for v in reversed(internal_fields(stack, wvl,
                                                          theta, pol))))
    fig, ax = share_fig_ax(fig, ax)
    ax.plot(locus.real, locus.imag, c='C2')
    ax.scatter(marks.real, marks.imag, c='k', s=12, zorder=4)
    ax.set_aspect('equal', adjustable='datalim')
    return _styled(fig, ax, 'Re(Y)  (admittance)', 'Im(Y)')


def plot_monitoring_trace(stack, layer, monitor_wvl, theta=0.0, pol='s',
                          mode='R', n_points=400, max_factor=1.0,
                          fig=None, ax=None):
    """In-situ monitoring signal while one layer is deposited."""
    deposited, signal = (_host(v) for v in monitoring_trace(
        stack, layer, monitor_wvl, theta=theta, pol=pol, mode=mode,
        n_points=n_points, max_factor=max_factor))
    fig, ax = share_fig_ax(fig, ax)
    ax.plot(deposited, signal, c='C4')
    return _styled(fig, ax, 'deposited thickness [um]',
                   f'monitor signal ({mode})')


__all__ = [
    'plot_spectrum',
    'plot_index_profile',
    'plot_field_intensity',
    'plot_admittance',
    'plot_monitoring_trace',
]
