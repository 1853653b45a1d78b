"""Deposition monitoring: signal traces, cut strategies, as-built runs.

Counterpart of ``prysm_tpu/x/coatings/monitoring.py``.  Design: the fixed
per-run illumination quantities (ambient/substrate admittances at the
monitor wavelength) are precomputed once into a :class:`_MonitorSetup`;
growing-layer traces batch the partial characteristic matrix over the whole
deposited-thickness grid in one shot, then a mode-keyed finisher turns the
assembled ABCD quantities into R or T.  The cut strategies run on host
numpy; each trace is read back once.
"""
import math
from dataclasses import dataclass
from functools import reduce

import numpy as onp
import torch

from ...conf import numpy_dtype
from ...thinfilm import _cos_snell
from ..optym.problem import to_host

from .stack import (
    Stack, _resolve, _admittance, _char_matrix, _complex, _eye2, _mul, _real,
    stack_characteristic_matrices,
)

__all__ = [
    'monitoring_trace',
    'turning_points',
    'level_cut',
    'cutoff_levels',
    'simulate_run',
    'monitoring_error_sensitivity',
    'choose_monitor_wavelength',
]


@dataclass(frozen=True)
class _MonitorSetup:
    """Illumination constants shared by every trace of one monitoring run."""

    wvl: float
    theta: float
    pol: str
    mode: str
    n0: complex
    nsub: complex
    eta0: object
    eta_sub: object

    @classmethod
    def for_stack(cls, stack, monitor_wvl, theta, pol, mode):
        pol = pol.lower()
        n0 = _resolve(stack.ambient_index, monitor_wvl)
        nsub = _resolve(stack.substrate_index, monitor_wvl)
        theta_t = _real(theta, stack.thicknesses.device)
        cos0 = torch.cos(theta_t)
        return cls(monitor_wvl, theta, pol, mode, n0, nsub,
                   _admittance(n0, cos0, pol),
                   _admittance(nsub, _cos_snell(n0, nsub, theta_t), pol))

    def finish(self, A):
        """ABCD assembly (already includes substrate) -> R or T signal."""
        B = A[..., 0, 0] + A[..., 0, 1] * self.eta_sub
        C = A[..., 1, 0] + A[..., 1, 1] * self.eta_sub
        denom = self.eta0 * B + C
        if self.mode == 'R':
            return torch.abs((self.eta0 * B - C) / denom) ** 2
        amplitude_t = 2 * self.eta0 / denom
        return (torch.real(self.eta_sub) / torch.real(self.eta0)
                * torch.abs(amplitude_t) ** 2)

    def trace(self, buried_media, buried_depths, grow_medium, d_grid):
        """Monitor signal of ``grow_medium`` deposited over ``d_grid``.

        ``buried_*`` describe the layers already laid down beneath it
        (closer to the substrate).
        """
        if len(buried_media):
            beneath = Stack(list(buried_media), buried_depths,
                            self.nsub, self.n0)
            mats = stack_characteristic_matrices(beneath, self.wvl,
                                                 self.theta, self.pol)
            P_beneath = reduce(_mul, mats, _eye2(mats[0]))
        else:
            P_beneath = _eye2(_complex(self.eta_sub))

        dev = self.eta_sub.device
        n_grow = _resolve(grow_medium, self.wvl)
        cos_grow = _cos_snell(self.n0, n_grow, _real(self.theta, dev))
        eta_grow = _admittance(n_grow, cos_grow, self.pol)
        phase = ((2 * math.pi * n_grow * cos_grow) / self.wvl
                 * _real(d_grid, dev))
        growing = _char_matrix(phase, torch.broadcast_to(_complex(eta_grow),
                                                         phase.shape))
        return self.finish(_mul(growing, P_beneath[None]))


def monitoring_trace(stack, layer, monitor_wvl, *, theta=0.0, pol='s',
                     mode='R', n_points=400, max_factor=1.0):
    """(thickness grid, monitor signal) while growing one layer."""
    setup = _MonitorSetup.for_stack(stack, monitor_wvl, theta, pol, mode)
    depths = to_host(stack.thicknesses).astype(numpy_dtype())
    d_grid = onp.linspace(0.0, max_factor * float(depths[layer]), n_points)
    signal = setup.trace(stack.indices[layer + 1:], depths[layer + 1:],
                         stack.indices[layer], d_grid)
    return d_grid, signal


def turning_points(d, signal):
    """Deposited thicknesses at the extrema of a monitor trace."""
    d = to_host(d)
    slope_sign = onp.sign(onp.diff(to_host(signal)))
    flips = onp.flatnonzero(slope_sign[:-1] != slope_sign[1:]) + 1
    return d[flips]


def level_cut(d, signal, level, target=None):
    """Deposited thickness where the signal crosses ``level``.

    With several crossings, return the one nearest ``target`` (else the
    first); with none, the closest-approach thickness.
    """
    d = to_host(d)
    excess = to_host(signal) - level
    polarity = onp.sign(excess)
    flips = onp.flatnonzero(polarity[:-1] != polarity[1:])
    if flips.size == 0:
        return float(d[onp.argmin(onp.abs(excess))])
    lo, hi = excess[flips], excess[flips + 1]
    frac = onp.where(hi == lo, 0.0, -lo / onp.where(hi == lo, 1.0, hi - lo))
    crossings = d[flips] + frac * (d[flips + 1] - d[flips])
    if target is None:
        return float(crossings[0])
    return float(crossings[onp.argmin(onp.abs(crossings - target))])


def cutoff_levels(stack, monitor_wvl, *, theta=0.0, pol='s', mode='R',
                  n_points=400):
    """Nominal monitor level at the end of each layer's deposition."""
    setup = _MonitorSetup.for_stack(stack, monitor_wvl, theta, pol, mode)
    depths = to_host(stack.thicknesses).astype(numpy_dtype())
    levels = [
        float(setup.trace(stack.indices[k + 1:], depths[k + 1:],
                          stack.indices[k], onp.array([depths[k]]))[0])
        for k in range(len(stack))
    ]
    return onp.asarray(levels, dtype=numpy_dtype())


def _terminate_turning(d_grid, signal, nominal, k, turning_index,
                       thickness_errors, levels):
    cuts = turning_points(d_grid, signal)
    stop = float(cuts[turning_index - 1]) if cuts.size >= turning_index \
        else float(nominal)
    if thickness_errors is not None:
        stop += float(thickness_errors[k])
    return stop


def _terminate_level(d_grid, signal, nominal, k, signal_errors, levels):
    want = float(levels[k])
    if signal_errors is not None:
        want += float(signal_errors[k])
    return level_cut(d_grid, signal, want, target=float(nominal))


def simulate_run(stack, monitor_wvl, *, strategy='level', turning_index=1,
                 signal_errors=None, thickness_errors=None, theta=0.0,
                 pol='s', mode='R', n_points=600, max_factor=1.8,
                 levels=None):
    """Simulate a monitored deposition run; returns the as-built Stack.

    Layers deposit substrate-side first (index N-1 down to 0), each
    terminated by the level or turning-point strategy with optional
    per-layer monitor errors.
    """
    if strategy not in ('level', 'turning'):
        raise ValueError("strategy must be 'level' or 'turning'")
    setup = _MonitorSetup.for_stack(stack, monitor_wvl, theta, pol, mode)
    nominal = to_host(stack.thicknesses).astype(numpy_dtype())
    realized = nominal.copy()

    if strategy == 'level' and levels is None:
        levels = cutoff_levels(stack, monitor_wvl, theta=theta, pol=pol,
                               mode=mode, n_points=n_points)

    for k in reversed(range(len(stack))):
        d_grid = onp.linspace(1e-12, max_factor * nominal[k], n_points)
        signal = to_host(setup.trace(stack.indices[k + 1:],
                                         realized[k + 1:],
                                         stack.indices[k], d_grid))
        if strategy == 'turning':
            stop = _terminate_turning(d_grid, signal, nominal[k], k,
                                      turning_index, thickness_errors, levels)
        else:
            stop = _terminate_level(d_grid, signal, nominal[k], k,
                                    signal_errors, levels)
        realized[k] = max(stop, 0.0)

    return Stack(stack.indices, realized, stack.substrate_index,
                 stack.ambient_index)


def monitoring_error_sensitivity(stack, monitor_wvl, design_wvls, *,
                                 strategy='level', theta=0.0, pol='s',
                                 design_pol='s', mode='R', eps=1e-4,
                                 **kwargs):
    """Jacobian of realized reflectance w.r.t. per-layer termination error."""
    from .stack import RTA
    design_wvls = onp.atleast_1d(onp.asarray(design_wvls, dtype=numpy_dtype()))

    def realized_R(**error_kw):
        run = simulate_run(stack, monitor_wvl, strategy=strategy, theta=theta,
                           pol=pol, mode=mode, **error_kw, **kwargs)
        R, _, _ = RTA(run, design_wvls, theta, design_pol)
        return onp.atleast_1d(to_host(R))

    R0 = realized_R()
    error_key = ('thickness_errors' if strategy == 'turning'
                 else 'signal_errors')
    n = len(stack)
    J = onp.zeros((design_wvls.size, n), dtype=numpy_dtype())
    for k in range(n):
        bump = onp.zeros(n, dtype=numpy_dtype())
        bump[k] = eps
        J[:, k] = (realized_R(**{error_key: bump}) - R0) / eps
    return J


def choose_monitor_wavelength(stack, candidates, design_wvls, *,
                              strategy='level', **kwargs):
    """(best wavelength, per-candidate score) by lowest error sensitivity."""
    scores = onp.asarray([
        float(onp.sqrt(onp.sum(
            monitoring_error_sensitivity(stack, wm, design_wvls,
                                         strategy=strategy, **kwargs) ** 2)))
        for wm in candidates
    ], dtype=numpy_dtype())
    best = float(onp.asarray(candidates)[int(onp.argmin(scores))])
    return best, scores

