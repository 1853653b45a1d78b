"""Broadband (polychromatic) propagation: wavelength-stacked MDFT plans.

Counterpart of ``prysm_tpu/parallel/broadband.py``.  The wavelength axis is
a leading tensor axis: the matrix-DFT bases of all wavelengths are stacked
into (W, M, N) complex tensors built on the host in float64, and applying
the plan is one batched complex matmul pair.  The matmuls run in the
plan's full precision (torch's default; TF32 is never turned on here).
"""
from dataclasses import dataclass

import numpy as np
import torch

from ..conf import config, resolve_device
from ..fttools import _host_fftrange

__all__ = ['SpectralMDFT', 'plan_mdft_spectral', 'spectral_focus', 'spectral_unfocus',
           'spectral_babinet']


@dataclass(frozen=True)
class SpectralMDFT:
    """Wavelength-stacked matrix-DFT plan.

    Ex: (W, Mx, Nx), Ey: (W, My, Ny) complex; norm: (W, 1, 1) real.
    Applying maps (..., W, Ny, Nx) fields -> (..., W, My, Mx) fields, one
    wavelength per leading index.
    """

    Ex: torch.Tensor
    Ey: torch.Tensor
    norm: torch.Tensor
    pupil_dx: float = None
    focal_dx: float = None

    def __call__(self, fields):
        """(..., W, Ny, Nx) -> (..., W, My, Mx)."""
        fields = fields.to(self.Ex.dtype)
        out = torch.matmul(self.Ey, fields)
        out = torch.matmul(out, self.Ex.transpose(-1, -2))
        return out * self.norm

    def adjoint(self, grads):
        """Adjoint (conjugate transpose per wavelength)."""
        grads = grads.to(self.Ex.dtype)
        out = torch.matmul(self.Ey.transpose(-1, -2).conj(), grads)
        out = torch.matmul(out, self.Ex.conj())
        return out * self.norm

    def nbytes(self):
        """Total size of the stacked basis matrices, bytes."""
        return (self.Ex.numel() + self.Ey.numel()) * self.Ex.element_size()


def plan_mdft_spectral(pupil_dx, pupil_samples, focal_dx, focal_samples,
                       wavelengths, efl, focal_shift=(0, 0), dtype=None, device=None):
    """Build a SpectralMDFT for a set of wavelengths sharing one focal grid.

    Each wavelength's spatial frequencies differ by the 1/(wavelength *
    efl) factor; the optical norm pupil_dx * focal_dx / (wavelength * efl)
    is baked in per wavelength.  ``dtype`` is the complex dtype of the
    bases (default ``config.precision_complex``), ``device`` their device.
    """
    if dtype is None:
        dtype = config.precision_complex
    dev = resolve_device(device)
    if not hasattr(pupil_samples, '__len__'):
        pupil_samples = (pupil_samples, pupil_samples)
    if not hasattr(focal_samples, '__len__'):
        focal_samples = (focal_samples, focal_samples)
    pny, pnx = pupil_samples
    fny, fnx = focal_samples
    fsx, fsy = focal_shift
    wavelengths = np.asarray(wavelengths, dtype=np.float64)

    x = _host_fftrange(pnx) * pupil_dx
    y = _host_fftrange(pny) * pupil_dx
    xf = _host_fftrange(fnx) * focal_dx + fsx
    yf = _host_fftrange(fny) * focal_dx + fsy

    Exs, Eys, norms = [], [], []
    for wvl in wavelengths:
        inv_lz = 1.0 / (wvl * efl)
        prefix = -2j * np.pi
        Exs.append(np.exp(prefix * np.outer(xf * inv_lz, x)))
        Eys.append(np.exp(prefix * np.outer(yf * inv_lz, y)))
        norms.append(pupil_dx * focal_dx * inv_lz)
    real = torch.empty(0, dtype=dtype).real.dtype
    return SpectralMDFT(
        Ex=torch.from_numpy(np.stack(Exs)).to(device=dev, dtype=dtype),
        Ey=torch.from_numpy(np.stack(Eys)).to(device=dev, dtype=dtype),
        norm=torch.tensor(norms, dtype=torch.float64).reshape(-1, 1, 1)
                  .to(device=dev, dtype=real),
        pupil_dx=pupil_dx, focal_dx=focal_dx)


def spectral_focus(fields, plan):
    """Pupil -> focal for a (W, Ny, Nx) stack of per-wavelength fields."""
    return plan(fields)


def spectral_unfocus(fields, plan):
    """Focal -> pupil for a (W, My, Mx) stack (per-wavelength adjoint)."""
    return plan.adjoint(fields)


def spectral_babinet(fields, lyot, fpm, plan):
    """Babinet Lyot coronagraph for a (W, Ny, Nx) stack in two batched MDFTs.

    fpm (broadcast (My, Mx) or per-wavelength (W, My, Mx)) is complemented
    to 1 - fpm, the round trip is subtracted from the incident field, and
    the lyot stop multiplies last.
    """
    at_fpm = plan(fields)
    removed = plan.adjoint(at_fpm * (1 - fpm))
    field_at_lyot = fields - removed
    return field_at_lyot if lyot is None else lyot * field_at_lyot
