"""Point Diffraction Interferometry (PS/PDI, Medecki).

Counterpart of ``prysm_tpu/x/pdi.py``.  Each interferometer arm is an
:class:`_Arm`: a focal-plane mask plus a precomputed matrix-DFT plan, both
built once in the pupil grid's dtype and on its device; the forward model
multiplies the input wave by the (phase-shifted) grating and sums the arms'
FPM round trips, all tensor operations that autograd differentiates.
"""
from dataclasses import dataclass
from functools import partial
from math import pi

import torch

from ..conf import complex_for, to_tensor
from ..coordinates import make_xy_grid
from ..propagation import Wavefront as WF, prepare_executor
from ..geometry import circle

__all__ = ['rectangle_pulse', 'PSPDI', 'evaluate_test_ref_arm_matching']


def rectangle_pulse(x, duty=0.5, amplitude=0.5, offset=0.5, period=2 * pi):
    """Rectangular pulse in [0, 1]; generalized square wave."""
    x = to_tensor(x)
    phase = torch.remainder(x, period)
    high = phase < (duty * period)
    on_edge = torch.abs(phase) < torch.finfo(x.dtype).eps
    signal = torch.where(high, x.new_tensor(offset + amplitude), x.new_tensor(offset - amplitude))
    return torch.where(on_edge, x.new_tensor(offset), signal)


def _sinusoidal_amplitude_grating(rulings, half_aperture):
    """90%-transmission sinusoidal amplitude grating profile."""
    spatial_rate = rulings * pi / half_aperture

    def profile(x):
        unit = (torch.sin(spatial_rate * x) + 1) / 2
        return 1 - 0.1 * unit

    return profile


@dataclass(frozen=True)
class _Arm:
    """One interferometer arm: focal mask + its matrix-DFT plan."""

    mask: object
    plan: object
    gain: float = 1.0

    def round_trip(self, wave, return_more=False):
        out = wave.to_fpm_and_back(self.mask, self.plan,
                                   return_more=return_more)
        if self.gain == 1:
            return out
        if return_more:
            beam, at_fpm, after_fpm = out
            return beam * self.gain, at_fpm, after_fpm
        return out * self.gain


class PSPDI:
    """Phase Shifting Point Diffraction Interferometer.

    x, y (mm) the pupil grids, efl (mm), epd (mm), wavelength (um); the
    test arm's window offset, field of view (both in lambda/D) and samples,
    its transmissivity; the pinhole's diameter (lambda/D) and samples; the
    grating's rulings across the pupil, its type ('sin_amp' or 'ronchi')
    and axis ('x' or 'y').  The mask geometry and transform plans are the
    JAX package's.
    """

    def __init__(self, x, y, efl, epd, wavelength,
                 test_arm_offset=64,
                 test_arm_fov=64,
                 test_arm_samples=256,
                 test_arm_transmissivity=1,
                 pinhole_diameter=0.25,
                 pinhole_samples=128,
                 grating_rulings=64,
                 grating_type='sin_amp',
                 grating_axis='x'):
        """Build gratings, masks, and the per-arm transform plans."""
        self.x, self.y = x, y = to_tensor(x), to_tensor(y)
        self.dx = float(x[0, 1] - x[0, 0])
        self.efl, self.epd, self.wavelength = efl, epd, wavelength
        self.fno = efl / epd
        self.flambd = self.fno * self.wavelength

        self.grating_rulings = grating_rulings
        self.grating_period = epd / grating_rulings
        self.grating_type = grating_type = grating_type.lower()
        self.grating_axis = grating_axis = grating_axis.lower()
        if grating_type == 'ronchi':
            self.grating_func = partial(rectangle_pulse, duty=0.5,
                                        amplitude=0.5, offset=0.5,
                                        period=self.grating_period)
        elif grating_type == 'sin_amp':
            self.grating_func = _sinusoidal_amplitude_grating(grating_rulings,
                                                              epd / 2)
        else:
            raise ValueError('unsupported grating type')

        # -- test arm: offset window of test_arm_fov lambda/D ----------------
        self.test_arm_offset = test_arm_offset
        self.test_arm_fov = test_arm_fov
        self.test_arm_samples = test_arm_samples
        self.test_arm_eps = test_arm_fov / test_arm_samples
        self.test_arm_fov_compute = (test_arm_fov + self.test_arm_eps) * self.flambd
        self.test_arm_mask_rsq = (test_arm_fov * self.flambd / 2) ** 2
        self.test_arm_transmissivity = test_arm_transmissivity
        carrier = grating_rulings * self.flambd
        self.test_arm_shift = ((carrier, 0) if grating_axis == 'x'
                               else (0, carrier))

        # -- pinhole (reference) arm -----------------------------------------
        self.pinhole_diameter = pinhole_diameter * self.flambd
        self.pinhole_samples = pinhole_samples
        self.dx_pinhole = pinhole_diameter / (pinhole_samples - 1)
        self.pinhole_fov_radius = pinhole_samples / 2 * self.dx_pinhole

        def window_mask(n_samples, window_diameter, radius_sq):
            wx, wy = make_xy_grid(n_samples, diameter=window_diameter, dtype=x.dtype,
                                  device=x.device)
            return circle(radius_sq, wx * wx + wy * wy), float(wx[0, 1] - wx[0, 0])

        self.pinhole, _ = window_mask(pinhole_samples,
                                      2 * self.pinhole_fov_radius,
                                      (pinhole_diameter / 2) ** 2)
        self.test_mask, self.dx_test_arm = window_mask(
            test_arm_samples, self.test_arm_fov_compute, self.test_arm_mask_rsq)

        plan = partial(prepare_executor, pupil_dx=self.dx,
                       pupil_samples=self.x.shape, wavelength=wavelength,
                       efl=efl, dtype=complex_for(x.dtype), device=x.device)
        self.pinhole_executor = plan(focal_dx=self.dx_pinhole,
                                     focal_samples=self.pinhole.shape)
        self.test_executor = plan(focal_dx=self.dx_test_arm,
                                  focal_samples=self.test_mask.shape,
                                  focal_shift=self.test_arm_shift)
        self._arms = {
            'ref': _Arm(self.pinhole, self.pinhole_executor),
            'test': _Arm(self.test_mask, self.test_executor,
                         gain=test_arm_transmissivity),
        }

    def _shifted_grating(self, phase_shift):
        if phase_shift == 0:
            return self.grating_func(self.x)
        motion = phase_shift / (2 * pi) * self.grating_period
        return self.grating_func(self.x + motion)

    def forward_model(self, wave_in, phase_shift=0, debug=False):
        """Intensity at the detector for an input wave and PSI phase shift."""
        modulated = wave_in * self._shifted_grating(phase_shift)
        if not isinstance(modulated, WF):
            modulated = WF(modulated, self.wavelength, self.dx)

        if debug:
            detail = {label: arm.round_trip(modulated, return_more=True)
                      for label, arm in self._arms.items()}
            self.ref_beam = detail['ref'][0]
            self.test_beam = detail['test'][0]
            return {
                'total_field': self.ref_beam + self.test_beam,
                'at_camera': {k: v[0] for k, v in detail.items()},
                'at_fpm': {k: (v[1], v[2]) for k, v in detail.items()},
            }
        self.ref_beam = self._arms['ref'].round_trip(modulated)
        self.test_beam = self._arms['test'].round_trip(modulated)
        return (self.ref_beam + self.test_beam).intensity


def evaluate_test_ref_arm_matching(debug_dict):
    """Ratio of mean ref to mean test intensity (fringe-visibility tuning)."""
    beams = debug_dict['at_camera']
    I_ref, I_test = beams['ref'].intensity, beams['test'].intensity
    return I_ref.data.mean() / I_test.data.mean(), I_ref, I_test
