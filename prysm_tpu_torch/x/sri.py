"""Self-Referenced Interferometer (photonic-fiber filtered reference arm).

Counterpart of ``prysm_tpu/x/sri.py``.  The fiber's mode field is solved on
the host (``fibers.smf_mode_field``) and lives on the pupil grid's device;
the reference arm's matrix-DFT plan is built in the wavefront's dtype and on
its device.
"""
import warnings

import torch

from ..conf import to_tensor
from ..propagation import Wavefront, unfocus_dft, prepare_executor
from ..coordinates import make_xy_grid, cart_to_polar
from ..mathops import cis

from .fibers import smf_mode_field

__all__ = ['overlap_integral', 'to_photonic_fiber_and_back', 'SelfReferencedInterferometer']

WF = Wavefront


def overlap_integral(E1, E2, sumI1, sumI2):
    """|<E1, E2>|^2 / (sum I1 sum I2)."""
    num = torch.abs(torch.sum(torch.conj(E1) * E2)) ** 2
    return num / (sumI1 * sumI2)


def to_photonic_fiber_and_back(self, efl, Efib, fib_dx, Ifibsum, executor=None,
                               shift=(0, 0), phase_shift=0, return_more=False):
    """Focus onto a single-mode fiber and return the emitted mode to the pupil.

    ``self`` is the input Wavefront (a function, not a method).
    """
    fib_samples = Efib.shape
    input_samples = self.data.shape
    if executor is None:
        data = self.data
        executor = prepare_executor(
            pupil_dx=self.dx, pupil_samples=input_samples,
            focal_dx=fib_dx, focal_samples=fib_samples,
            wavelength=self.wavelength, efl=efl, focal_shift=shift,
            dtype=data.dtype if data.is_complex() else data.dtype.to_complex(),
            device=data.device)

    at_fpm = self.focus_dft(executor)
    input_power = at_fpm.intensity.data.sum()
    coupling_loss = overlap_integral(at_fpm.data, Efib, input_power, Ifibsum)
    c = (input_power * coupling_loss) ** 0.5
    Eout = Efib * c
    if phase_shift != 0:
        Eout = Eout * cis(torch.as_tensor(phase_shift, dtype=c.dtype, device=c.device))
    field_at_next_pupil = unfocus_dft(Eout.to(executor.Ex.dtype), executor)

    if input_samples[0] != input_samples[1]:
        warnings.warn(f'Forward propagation had input shape {input_samples} '
                      'which was not uniform between axes, scaling is off')
    if fib_samples[0] != fib_samples[1]:
        warnings.warn(f'Forward propagation had fiber shape {fib_samples} '
                      'which was not uniform between axes, scaling is off')

    out = Wavefront(field_at_next_pupil, self.wavelength, self.dx, self.space)
    if return_more:
        return out, at_fpm, Wavefront(Eout, self.wavelength, fib_dx, 'psf'), coupling_loss
    return out


class SelfReferencedInterferometer:
    """Self-Referenced Interferometer with a fiber-filtered reference arm.

    x, y (mm) the pupil grids, efl (mm), epd (mm), wavelength (um); the
    fiber's V number, normalized propagation constant b and core radius a
    (um), the fiber plane's samples, and the beamsplitter's (R, T).
    """

    def __init__(self, x, y, efl, epd, wavelength,
                 fiber_V=2.3, fiber_b=0.5, fiber_a=1.95 / 2,
                 fiber_samples=256,
                 beamsplitter_RT=(0.8, 0.2)):
        """The fiber's mode field, normalized, on a fiber_samples^2 grid 25 core radii across."""
        self.x = x = to_tensor(x)
        self.y = to_tensor(y)
        self.dx = float(x[0, 1] - x[0, 0])
        self.efl = efl
        self.epd = epd
        self.wavelength = wavelength
        self.fno = efl / epd
        self.flambd = self.fno * self.wavelength

        fiber_fov_radius = 10 * 1.25 * fiber_a
        self.dx_pinhole = (2 * fiber_fov_radius) / fiber_samples
        xfib, yfib = make_xy_grid(fiber_samples, diameter=2 * fiber_fov_radius,
                                  dtype=x.dtype, device=x.device)
        rfib, tfib = cart_to_polar(xfib, yfib)
        Efib = smf_mode_field(fiber_V, fiber_a, fiber_b, rfib)
        self.Efib = Efib / (Efib ** 2).sum() ** 0.5
        self.Ifib = torch.abs(self.Efib) ** 2
        self.Ifibsum = self.Ifib.sum()
        self.dxfib = float(xfib[0, 1] - xfib[0, 0])

        self.ref_r = beamsplitter_RT[0] ** 0.5
        self.test_t = beamsplitter_RT[1] ** 0.5

    def forward_model(self, wave_in, phase_shift=0, debug=False):
        """Intensity at the detector for an input wave and phase shift."""
        if not isinstance(wave_in, WF):
            wave_in = WF(wave_in, self.wavelength, self.dx)
        test_beam = wave_in
        ref_beam = to_photonic_fiber_and_back(wave_in, self.efl, self.Efib,
                                              self.dxfib, self.Ifibsum,
                                              phase_shift=phase_shift)
        ref_beam = ref_beam * self.ref_r
        test_beam = test_beam * self.test_t
        total_field = ref_beam + test_beam
        if debug:
            return {'at_camera': {'ref': ref_beam, 'test': test_beam}}
        return total_field.intensity
