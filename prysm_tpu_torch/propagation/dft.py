"""Matrix-DFT pupil <-> focal propagation with arbitrary sampling.

Counterpart of ``prysm_tpu/propagation/dft.py`` (the ``kind='mdft'``
part): ``prepare_executor`` builds an MDFT plan with the optical
normalization ``pupil_dx * focal_dx / (wavelength * efl)`` baked in.
"""
import math
from collections.abc import Iterable

from ..fttools import plan_mdft, _host_fftrange

__all__ = ['coordinates_for_focus', 'prepare_executor', 'unit_cell_focal_grid',
           'focus_dft', 'focus_dft_adjoint', 'unfocus_dft', 'unfocus_dft_adjoint']


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
    """Build a reusable MDFT pupil <-> focal plan.

    The plan is in the focus orientation: plan(pupil) -> focal data,
    plan.adjoint(focal) -> pupil data.  Only ``kind='mdft'`` is ported so
    far.  ``matmul_precision='high'`` allows TF32 in the plan's matmuls.
    """
    if kind != 'mdft':
        raise ValueError(f"kind must be 'mdft' (the only executor ported so far), got {kind!r}")
    x, y, fx, fy = coordinates_for_focus(
        pupil_dx, pupil_samples, focal_dx, focal_samples,
        wavelength, efl, focal_shift)
    norm = (pupil_dx * focal_dx) / (wavelength * efl)
    return plan_mdft(x, y, fx, fy, sign=-1, norm=norm, dtype=dtype,
                     pupil_dx=pupil_dx, focal_dx=focal_dx,
                     matmul_precision=matmul_precision, device=device)


def unit_cell_focal_grid(pupil_dx, pupil_diameter, wavelength, efl, Q=2):
    """(focal_dx, focal_samples) spanning the full DFT unit cell."""
    nsamp = math.ceil(Q * pupil_diameter / pupil_dx)
    return wavelength * efl / (pupil_dx * nsamp), nsamp


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
