"""Convergence plotting for governed optimizer runs.

Counterpart of ``prysm_tpu/x/optym/plotting.py``: one verb,
``plot_convergence``, drawing f / gradient-norm / active-bound-count series
against iteration from an OptimizationResult or a sequence of StepRecord
objects.  Tensors are read to the host; matplotlib is imported when a
figure is drawn.
"""
import numpy as np

from ...plotting import share_fig_ax
from .problem import to_host

_ALIASES = {
    'f': 'f', 'cost': 'f', 'objective': 'f',
    'g': 'g_norm', 'gnorm': 'g_norm', 'g_norm': 'g_norm',
    'gradient_norm': 'g_norm',
    'bounded': 'bounded', 'bounds': 'bounded', 'n_bounded': 'bounded',
    'bounded_variables': 'bounded',
}


class _DictRecord:
    """Attribute view over a plain-dict convergence record.

    Solver metadata dicts (DLS history entries) carry 'iteration',
    'cost'/'f', and constraint keys; this adapter lets them share the
    StepRecord plotting path (reference plotting tests feed both).
    """

    def __init__(self, data):
        self._data = dict(data)

    @property
    def iteration(self):
        return self._data['iteration']

    @property
    def f(self):
        return self._data.get('f', self._data.get('cost'))

    @property
    def g(self):
        return self._data.get('g', self._data.get('gradient'))

    @property
    def x(self):
        return self._data.get('x')

    x_next = None
    optimizer = None

    @property
    def metadata(self):
        return self._data


def _records_of(result_or_records):
    records = getattr(result_or_records, 'records', result_or_records)
    records = [_DictRecord(r) if isinstance(r, dict) else r
               for r in records]
    if not records:
        raise ValueError('at least one convergence record is required')
    return records


def _norm(g, order):
    g = np.abs(to_host(g).astype(float).ravel())
    if order in (np.inf, 'inf'):
        return g.max() if g.size else 0.0
    order = float(order)
    return float((g ** order).sum() ** (1.0 / order))


def _n_bounded(record, atol, rtol):
    meta = getattr(record, 'metadata', None) or {}
    if 'bounded_variables' in meta:
        return int(meta['bounded_variables'])
    if 'active_inequalities' in meta:
        return int(to_host(meta['active_inequalities']).size)
    opt = getattr(record, 'optimizer', None)
    lo = to_host(getattr(opt, 'l', np.nan)).astype(float)
    hi = to_host(getattr(opt, 'u', np.nan)).astype(float)
    x = to_host(record.x_next if record.x_next is not None else record.x).astype(float)
    if lo.shape != x.shape:
        return 0
    tol = atol + rtol * np.abs(x)
    on_lo = np.isfinite(lo) & (x - lo <= tol)
    on_hi = np.isfinite(hi) & (hi - x <= tol)
    return int((on_lo | on_hi).sum())


def _series(records, quantity, gradient_norm, atol, rtol):
    if quantity == 'f':
        return np.asarray([r.f for r in records], dtype=float)
    if quantity == 'g_norm':
        return np.asarray([_norm(r.g, gradient_norm) for r in records])
    return np.asarray([_n_bounded(r, atol, rtol) for r in records])


def _label(quantity, gradient_norm):
    if quantity == 'f':
        return 'f'
    if quantity == 'g_norm':
        order = ('inf' if gradient_norm in (np.inf, 'inf')
                 else f'{gradient_norm:g}')
        return f'||g|| {order}'
    return 'bounded variables'


def plot_convergence(result_or_records, quantities=('f', 'g_norm'), *,
                     gradient_norm=np.inf, bounded_atol=1e-12,
                     bounded_rtol=1e-9, fig=None, ax=None, yscale='linear',
                     lw=None, marker=None, colors=None):
    """Convergence series versus iteration, one axis per quantity.

    ``result_or_records`` is a run_until OptimizationResult or any
    sequence of StepRecord objects.  Quantities: 'f', 'g_norm',
    'bounded' (aliases: cost/objective, g/gnorm/gradient_norm,
    bounds/n_bounded/bounded_variables).
    """
    records = _records_of(result_or_records)
    if isinstance(quantities, str):
        quantities = (quantities,)
    try:
        quantities = tuple(_ALIASES[str(q).lower()] for q in quantities)
    except KeyError as e:
        raise ValueError(f'unknown convergence quantity {e.args[0]!r}; '
                         f"choose from {sorted(set(_ALIASES))}") from None

    fig, ax = share_fig_ax(fig, ax, numax=len(quantities), sharex=True)
    axes = np.atleast_1d(np.asarray(ax, dtype=object)).ravel()
    if len(axes) != len(quantities):
        raise ValueError('number of axes must match number of quantities')
    if colors is None:
        colors = (None,) * len(quantities)

    x = np.asarray([r.iteration for r in records], dtype=float)
    for axis, quantity, color in zip(axes, quantities, colors):
        y = _series(records, quantity, gradient_norm, bounded_atol,
                    bounded_rtol)
        label = _label(quantity, gradient_norm)
        axis.plot(x, y, lw=lw, marker=marker, color=color, label=label)
        axis.set_ylabel(label)
        axis.set_yscale(yscale)
        axis.grid(True, alpha=0.25)
        axis.legend()
    axes[-1].set_xlabel('iteration')
    return fig, ax


__all__ = ['plot_convergence']
