"""Wavefront class: the fluent object API over the propagation functions.

Counterpart of ``prysm_tpu/propagation/wavefront.py`` (the main path's
part).  ``data`` is a native complex tensor; torch autograd flows through
it, and the explicit ``*_adjoint`` methods give the same gradients by hand.

Units: field dx in mm for pupil space and um for psf space, OPD in nm,
wavelength in um, efl in mm.
"""
import math

import torch

from .._richdata import RichData
from ..mathops import cis
from .fft import (focus, focus_adjoint, pupil_sample_to_psf_sample,
                  psf_sample_to_pupil_sample)
from .dft import focus_dft, focus_dft_adjoint

__all__ = ['Wavefront', 'phase_prefix']


def phase_prefix(wavelength):
    """Scale factor such that multiplication with OPD in nm produces radians (times i)."""
    return 1j * 2 * math.pi / wavelength / 1e3


def _phase_scale(wavelength):
    """Real radians-per-nm scale (the magnitude of phase_prefix)."""
    return 2 * math.pi / wavelength / 1e3


class Wavefront:
    """(Complex) representation of a wavefront.

    data: complex field, possibly with leading batch axes.
    wavelength: um.  dx: mm (space='pupil') or um (space='psf').
    """

    def __init__(self, data, wavelength=None, dx=None, space='pupil'):
        self.data = data
        self.wavelength = wavelength
        self.dx = dx
        self.space = space

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_amp_and_phase(cls, amplitude, phase, wavelength, dx):
        """Wavefront from amplitude and OPD (nm); phase=None means zero OPD."""
        if phase is None:
            return cls(amplitude, wavelength, dx)
        amplitude = amplitude.to(phase.dtype)
        return cls(torch.polar(amplitude, _phase_scale(wavelength) * phase),
                   wavelength, dx)

    @classmethod
    def phase_screen(cls, phase, wavelength, dx):
        """Unit-amplitude complex screen from OPD in nm."""
        return cls(cis(_phase_scale(wavelength) * phase), wavelength, dx)

    # -- views --------------------------------------------------------------
    @property
    def intensity(self):
        """Intensity, |E|^2, as RichData."""
        d = self.data
        return RichData(d.real * d.real + d.imag * d.imag, self.dx, self.wavelength)

    @property
    def phase(self):
        """Phase, angle(E); possibly wrapped for large OPD."""
        return RichData(torch.angle(self.data), self.dx, self.wavelength)

    # -- explicit adjoints --------------------------------------------------
    def from_amp_and_phase_adjoint_phase(self, wf_bar):
        """Gradient w.r.t. phase: k * Im(conj(E) * Ebar), k = phase_prefix."""
        k = phase_prefix(self.wavelength)
        return k * torch.imag(wf_bar.data * torch.conj(self.data))

    def intensity_adjoint(self, intensity_bar):
        """Gradient w.r.t. the complex field before intensity: 2 Ibar E."""
        return Wavefront(2 * intensity_bar * self.data, self.wavelength, self.dx,
                         self.space)

    # -- propagation verbs --------------------------------------------------
    def focus(self, efl, Q=2):
        """Pupil -> psf propagation via unitary FFT."""
        if self.space != 'pupil':
            raise ValueError('can only propagate from a pupil to psf plane')
        data = focus(self.data, Q=Q)
        dx = pupil_sample_to_psf_sample(self.dx, data.shape[-1], self.wavelength, efl)
        return Wavefront(data, self.wavelength, dx, 'psf')

    def focus_adjoint(self, efl, Q=2):
        """Adjoint of focus."""
        if self.space != 'psf':
            raise ValueError('can only apply adjoint from a psf to pupil plane')
        samples = self.data.shape[-1]
        data = focus_adjoint(self.data, Q=Q)
        dx = psf_sample_to_pupil_sample(self.dx, samples, self.wavelength, efl)
        return Wavefront(data, self.wavelength, dx, 'pupil')

    def focus_dft(self, executor):
        """Pupil -> psf via a precomputed plan."""
        if self.space != 'pupil':
            raise ValueError('can only propagate from a pupil to psf plane')
        return Wavefront(focus_dft(self.data, executor), self.wavelength,
                         executor.focal_dx, 'psf')

    def focus_dft_adjoint(self, executor):
        """Adjoint of focus_dft."""
        if self.space != 'psf':
            raise ValueError('can only apply adjoint from a psf to pupil plane')
        return Wavefront(focus_dft_adjoint(self.data, executor), self.wavelength,
                         executor.pupil_dx, 'pupil')
