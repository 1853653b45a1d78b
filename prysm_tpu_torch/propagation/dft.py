"""Matrix-DFT / chirp-Z pupil <-> focal propagation with arbitrary sampling.

Counterpart of ``prysm_tpu/propagation/dft.py``: ``prepare_executor``
builds an MDFT, CZT or FFTDFT plan with the optical normalization
``pupil_dx * focal_dx / (wavelength * efl)`` baked in; the
multi-resolution stack carries per-level plans, partition-of-unity
windows and focal grids, the last three as tensors on the plans' device
in their real dtype.
"""
import math
from collections.abc import Iterable

import numpy as np
import torch

from ..conf import config, resolve_device
# MDFT, CZT, FFTDFT and fftrange are importable from here, as from the JAX
# package's propagation.dft
from ..fttools import (  # noqa: F401
    MDFT, CZT, FFTDFT, fftrange, _host_fftrange, plan_mdft, plan_czt, plan_fftdft)

__all__ = ['coordinates_for_focus', 'prepare_executor', 'unit_cell_focal_grid',
           'MultiResolutionExecutor', 'prepare_multiresolution',
           'focus_dft', 'focus_dft_adjoint', 'unfocus_dft', 'unfocus_dft_adjoint']

_PLANNERS = {'mdft': plan_mdft, 'czt': plan_czt, 'fftdft': plan_fftdft}


def _as_pair(n):
    """(ny, nx) from a scalar-or-pair sample count."""
    return tuple(n) if isinstance(n, Iterable) else (n, n)


def coordinates_for_focus(pupil_dx, pupil_samples, focal_dx, focal_samples,
                          wavelength, efl, focal_shift=(0, 0)):
    """Host-side (x, y, fx, fy) vectors for an MDFT pupil <-> focal propagation.

    Fraunhofer kernel exp(-2i pi x_pupil . x_focal / (lambda efl)), with
    fx = x_focal / (lambda * efl).  Units: pupil mm, focal um, wavelength
    um, efl mm.
    """
    pny, pnx = _as_pair(pupil_samples)
    fny, fnx = _as_pair(focal_samples)
    fsx, fsy = focal_shift
    x = _host_fftrange(pnx) * pupil_dx
    y = _host_fftrange(pny) * pupil_dx
    inv_lz = 1.0 / (wavelength * efl)
    fx = (_host_fftrange(fnx) * focal_dx + fsx) * inv_lz
    fy = (_host_fftrange(fny) * focal_dx + fsy) * inv_lz
    return x, y, fx, fy


def prepare_executor(pupil_dx, pupil_samples, focal_dx, focal_samples,
                     wavelength, efl, focal_shift=(0, 0), kind='mdft',
                     dtype=None, matmul_precision=None, device=None):
    """Build a reusable MDFT/CZT/FFTDFT pupil <-> focal plan.

    The plan is in the focus orientation: plan(pupil) -> focal data,
    plan.adjoint(focal) -> pupil data.  ``matmul_precision='high'`` allows
    TF32 in an MDFT plan's matmuls; the other kinds run no matmul and
    ignore it, as the JAX package does.
    """
    x, y, fx, fy = coordinates_for_focus(
        pupil_dx, pupil_samples, focal_dx, focal_samples,
        wavelength, efl, focal_shift)
    norm = (pupil_dx * focal_dx) / (wavelength * efl)
    try:
        planner = _PLANNERS[kind]
    except KeyError:
        raise ValueError(f"kind must be 'mdft', 'czt', or 'fftdft', got {kind!r}") from None
    kwargs = {'matmul_precision': matmul_precision} if kind == 'mdft' else {}
    return planner(x, y, fx, fy, sign=-1, norm=norm, dtype=dtype, pupil_dx=pupil_dx,
                   focal_dx=focal_dx, device=device, **kwargs)


def unit_cell_focal_grid(pupil_dx, pupil_diameter, wavelength, efl, Q=2):
    """(focal_dx, focal_samples) spanning the full DFT unit cell."""
    nsamp = math.ceil(Q * pupil_diameter / pupil_dx)
    return wavelength * efl / (pupil_dx * nsamp), nsamp


def _smootherstep(t):
    """C2 smoothstep 6t^5 - 15t^4 + 10t^3, clipped to [0, 1] (host-side)."""
    t = np.clip(t, 0, 1)
    return t ** 3 * (10 + t * (6 * t - 15))


def _cumulative_window(r, a, b):
    """Radial taper: 1 for r < a, 0 for r > b, C2 transition between (host-side)."""
    return 1 - _smootherstep((r - a) / (b - a))


class MultiResolutionExecutor:
    """A stack of arbitrary-sampling plans plus partition-of-unity windows.

    Per-level pupil -> focal plans (coarsest first), real hand-off windows
    that sum to one over the focal plane, and the focal-plane coordinate
    grids on which mask callables are evaluated.  The windows and grids
    are tensors on the plans' device in their real dtype.
    """

    def __init__(self, executors, windows, xf, yf):
        self.executors = tuple(executors)
        self.windows = tuple(windows)
        self.xf = tuple(xf)
        self.yf = tuple(yf)

    def __len__(self):
        """Number of resolution levels."""
        return len(self.executors)


def prepare_multiresolution(pupil_dx, pupil_samples, focal_dx, focal_samples,
                            wavelength, efl, num_levels, scaling=4.0,
                            fine_samples=None, window=(0.2, 0.7), kind='mdft',
                            dtype=None, device=None):
    """Build a MultiResolutionExecutor for focal-plane-mask propagation.

    Every level's focal grid is shifted by half a sample in x and y so a
    mask singularity at the origin is never sampled; the windows are
    computed on the host in float64 and moved once to the device.
    """
    if fine_samples is None:
        fine_samples = focal_samples
    if dtype is None:
        dtype = config.precision_complex
    coarse_ny_nx = _as_pair(focal_samples)
    fine_ny_nx = _as_pair(fine_samples)

    def _level(k):
        """Plan + host-side focal geometry for pyramid level k (0=coarsest)."""
        ny, nx = coarse_ny_nx if k == 0 else fine_ny_nx
        step = focal_dx / scaling ** k
        off = 0.5 * step
        plan = prepare_executor(pupil_dx, pupil_samples, step, (ny, nx),
                                wavelength, efl, focal_shift=(off, off),
                                kind=kind, dtype=dtype, device=device)
        gx, gy = np.meshgrid(_host_fftrange(nx) * step + off,
                             _host_fftrange(ny) * step + off)
        # the half-extent of this level's grid sets where its hand-off
        # taper to the next-coarser level lives
        return plan, gx, gy, 0.5 * step * min(ny, nx)

    plans, gxs, gys, extents = zip(*(_level(k) for k in range(num_levels)))
    inner, outer = window

    def _taper(k, j):
        """Hand-off taper owned by level j, sampled on level k's grid."""
        r = np.hypot(gxs[k], gys[k])
        return _cumulative_window(r, inner * extents[j], outer * extents[j])

    # level k keeps the annulus between its own taper and the next-finer
    # level's; the coarsest reaches outward and the finest covers the
    # origin, so the stack sums to one everywhere
    wins = []
    for k in range(num_levels):
        w = np.ones_like(gxs[k]) if k == 0 else _taper(k, k)
        if k + 1 < num_levels:
            w = w - _taper(k, k + 1)
        wins.append(w)

    real = dtype.to_real()
    dev = resolve_device(device)
    host = lambda arrs: tuple(torch.from_numpy(a).to(dev, real) for a in arrs)  # noqa: E731
    return MultiResolutionExecutor(plans, host(wins), host(gxs), host(gys))


def focus_dft(wavefunction, executor):
    """Pupil -> focal propagation via a precomputed plan."""
    return executor(wavefunction)


def focus_dft_adjoint(wavefunction, executor):
    """Adjoint of focus_dft."""
    return executor.adjoint(wavefunction)


def unfocus_dft(wavefunction, executor):
    """Focal -> pupil propagation via a precomputed plan (its adjoint)."""
    return executor.adjoint(wavefunction)


def unfocus_dft_adjoint(wavefunction, executor):
    """Adjoint of unfocus_dft."""
    return executor(wavefunction)
