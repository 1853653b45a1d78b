"""Wavefront class: the fluent object API over the propagation functions.

Counterpart of ``prysm_tpu/propagation/wavefront.py``.  ``data`` is a
native complex tensor; torch autograd flows through it, and the explicit
``*_adjoint`` methods give the same gradients by hand.

Units: field dx in mm for pupil space and um for psf space, OPD in nm,
wavelength in um, efl and z in mm.
"""
import math
import numbers
import operator

import torch

from .._richdata import RichData
from ..fttools import pad2d, crop_center
from ..mathops import cis
from .fft import (focus, focus_adjoint, unfocus, unfocus_adjoint,
                  pupil_sample_to_psf_sample, psf_sample_to_pupil_sample)
from .dft import (prepare_executor, prepare_multiresolution, focus_dft, focus_dft_adjoint,
                  unfocus_dft, unfocus_dft_adjoint)
from .angular_spectrum import angular_spectrum, angular_spectrum_adjoint
from .coronagraph import (to_fpm_and_back, to_fpm_and_back_adjoint,
                          to_fpm_and_back_multiresolution,
                          to_fpm_and_back_multiresolution_adjoint, babinet, babinet_adjoint)

__all__ = ['Wavefront', 'phase_prefix']


def phase_prefix(wavelength):
    """Scale factor such that multiplication with OPD in nm produces radians (times i)."""
    return 1j * 2 * math.pi / wavelength / 1e3


def _phase_scale(wavelength):
    """Real radians-per-nm scale (the magnitude of phase_prefix)."""
    return 2 * math.pi / wavelength / 1e3


def _field_data(field):
    """Tensor data from a Wavefront-like field (pass through otherwise)."""
    if isinstance(field, Wavefront):
        return field.data
    return field


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
        if not torch.is_tensor(amplitude):  # a scalar amplitude multiplies in
            return cls(amplitude * cis(_phase_scale(wavelength) * phase), wavelength, dx)
        amplitude = amplitude.to(phase.dtype)
        return cls(torch.polar(amplitude, _phase_scale(wavelength) * phase),
                   wavelength, dx)

    @classmethod
    def phase_screen(cls, phase, wavelength, dx):
        """Unit-amplitude complex screen from OPD in nm."""
        return cls(cis(_phase_scale(wavelength) * phase), wavelength, dx)

    @classmethod
    def thin_lens(cls, f, wavelength, x, y, dx=None):
        """Quadratic-phase thin-lens screen of focal length f (mm) on the grids x, y."""
        w = wavelength / 1e3  # um -> mm
        rsq = x * x + y * y
        screen = cis((-2 * math.pi / w) * (rsq / (2 * f)))
        if dx is None:
            dx = float(x[0, 1] - x[0, 0])
        return cls(screen, wavelength, dx, 'pupil')

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

    @property
    def real(self):
        """Re(E)."""
        return RichData(torch.real(self.data), self.dx, self.wavelength)

    @property
    def imag(self):
        """Im(E)."""
        return RichData(torch.imag(self.data), self.dx, self.wavelength)

    def copy(self):
        """A copy of this wavefront, its data cloned."""
        return self._like(self.data.clone())

    def _like(self, data):
        """A wavefront sharing this one's wavelength/dx/space."""
        return Wavefront(data, self.wavelength, self.dx, self.space)

    def _at_focus(self, data, executor):
        """A focal-plane wavefront on the executor's output grid."""
        return Wavefront(data, self.wavelength, executor.focal_dx, 'psf')

    def _focal_stack(self, fields, executor):
        """Focal-plane views of the per-level fields of a multiresolution stack."""
        return [Wavefront(f, self.wavelength, ex.focal_dx, 'psf')
                for f, ex in zip(fields, executor.executors)]

    # -- explicit adjoints --------------------------------------------------
    def from_amp_and_phase_adjoint_phase(self, wf_bar):
        """Gradient w.r.t. phase: k * Im(conj(E) * Ebar), k = phase_prefix."""
        k = phase_prefix(self.wavelength)
        return k * torch.imag(wf_bar.data * torch.conj(self.data))

    def from_amp_and_phase_adjoint_amp(self, wf_bar, phase=None):
        """Gradient w.r.t. amplitude: Re(conj(S) * Ebar) with S the phasor."""
        if phase is not None:
            S = cis(_phase_scale(self.wavelength) * phase)
            return torch.real(wf_bar.data * torch.conj(S))
        absP = torch.abs(self.data)
        nonzero = absP > 0
        grad = torch.real(wf_bar.data * torch.conj(self.data))
        return torch.where(nonzero, grad / torch.where(nonzero, absP, torch.ones_like(absP)),
                           torch.zeros_like(grad))

    def phase_screen_adjoint_phase(self, wf_bar):
        """Gradient w.r.t. the phase of a phase_screen."""
        return self.from_amp_and_phase_adjoint_phase(wf_bar)

    @classmethod
    def thin_lens_adjoint(cls, f, wavelength, x, y, wf_bar):
        """Scalar gradient w.r.t. the thin-lens focal length f."""
        L_bar = _field_data(wf_bar)
        L = cls.thin_lens(f, wavelength, x, y).data
        w = wavelength / 1e3
        rsq = x * x + y * y
        coeff = math.pi / (w * f * f)
        return coeff * torch.sum(rsq * torch.imag(L_bar * torch.conj(L)))

    def intensity_adjoint(self, intensity_bar):
        """Gradient w.r.t. the complex field before intensity: 2 Ibar E."""
        return Wavefront(2 * intensity_bar * self.data, self.wavelength, self.dx,
                         self.space)

    # -- shaping ------------------------------------------------------------
    def pad2d(self, Q, value=0, mode='constant', out_shape=None, inplace=True):
        """Wavefront with FFT-aligned padded data.

        inplace=True rebinds this object's data and returns self; False
        returns a new Wavefront.
        """
        padded = pad2d(self.data, Q=Q, value=value, mode=mode, out_shape=out_shape)
        if inplace:
            self.data = padded
            return self
        return self._like(padded)

    def crop(self, out_shape, inplace=True):
        """Wavefront cropped to the centermost out_shape.

        inplace=True rebinds this object's data and returns self; False
        returns a new Wavefront.
        """
        cropped = crop_center(self.data, out_shape)
        if inplace:
            self.data = cropped
            return self
        return self._like(cropped)

    # -- arithmetic ---------------------------------------------------------
    def _numerical_operation(self, other, op, reverse=False):
        func = getattr(operator, op)
        if isinstance(other, Wavefront):
            criteria = [
                abs(self.dx - other.dx) / self.dx * 100 < 0.1,
                self.data.shape == other.data.shape,
                self.wavelength == other.wavelength,
                self.space == other.space,
            ]
            if not all(criteria):
                raise ValueError('all physicality criteria not met: sample '
                                 'spacing, shape, wavelength, or space different.')
            other = other.data
        elif not isinstance(other, (torch.Tensor, numbers.Number)):
            raise TypeError(f"unsupported operand type(s) for {op}: 'Wavefront' and "
                            f'{type(other)}')
        data = func(other, self.data) if reverse else func(self.data, other)
        return self._like(data)

    def __mul__(self, other):
        """E * other."""
        return self._numerical_operation(other, 'mul')

    def __rmul__(self, other):
        """other * E."""
        return self._numerical_operation(other, 'mul', reverse=True)

    def __truediv__(self, other):
        """E / other."""
        return self._numerical_operation(other, 'truediv')

    def __rtruediv__(self, other):
        """other / E."""
        return self._numerical_operation(other, 'truediv', reverse=True)

    def __add__(self, other):
        """E + other."""
        return self._numerical_operation(other, 'add')

    def __radd__(self, other):
        """other + E."""
        return self._numerical_operation(other, 'add', reverse=True)

    def __sub__(self, other):
        """E - other."""
        return self._numerical_operation(other, 'sub')

    def __rsub__(self, other):
        """other - E."""
        return self._numerical_operation(other, 'sub', reverse=True)

    # -- propagation verbs --------------------------------------------------
    def free_space(self, dz=None, Q=1, tf=None):
        """Plane-to-plane angular-spectrum propagation over dz mm (or by a transfer function)."""
        if dz is None and tf is None:
            raise ValueError('dz must be provided if tf is None')
        return self._like(angular_spectrum(self.data, wvl=self.wavelength, dx=self.dx,
                                           z=dz, Q=Q, tf=tf))

    def free_space_adjoint(self, dz=None, Q=1, tf=None):
        """Adjoint of free_space."""
        if dz is None and tf is None:
            raise ValueError('dz must be provided if tf is None')
        return self._like(angular_spectrum_adjoint(self.data, wvl=self.wavelength,
                                                   dx=self.dx, z=dz, Q=Q, tf=tf))

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

    def unfocus(self, efl, Q=2):
        """Psf -> pupil propagation via unitary inverse FFT."""
        if self.space != 'psf':
            raise ValueError('can only propagate from a psf to pupil plane')
        data = unfocus(self.data, Q=Q)
        dx = psf_sample_to_pupil_sample(self.dx, data.shape[-1], self.wavelength, efl)
        return Wavefront(data, self.wavelength, dx, 'pupil')

    def unfocus_adjoint(self, efl, Q=2):
        """Adjoint of unfocus."""
        if self.space != 'pupil':
            raise ValueError('can only apply adjoint from a pupil to psf plane')
        samples = self.data.shape[-1]
        data = unfocus_adjoint(self.data, Q=Q)
        dx = pupil_sample_to_psf_sample(self.dx, samples, self.wavelength, efl)
        return Wavefront(data, self.wavelength, dx, 'psf')

    def prepare_executor(self, efl, dx, samples, shift=(0, 0), kind='mdft'):
        """Build a reusable transform plan for this wavefront's geometry.

        (dx, samples) describe the *other* plane: focal um when self is a
        pupil, pupil mm when self is a psf.  The plan is made in the
        data's complex dtype on its device.
        """
        if isinstance(samples, int):
            samples = (samples, samples)
        like = dict(dtype=self._complex_dtype(), device=self.data.device)
        if self.space == 'pupil':
            return prepare_executor(
                pupil_dx=self.dx, pupil_samples=tuple(self.data.shape[-2:]),
                focal_dx=dx, focal_samples=samples, wavelength=self.wavelength,
                efl=efl, focal_shift=shift, kind=kind, **like)
        elif self.space == 'psf':
            return prepare_executor(
                pupil_dx=dx, pupil_samples=samples, focal_dx=self.dx,
                focal_samples=tuple(self.data.shape[-2:]), wavelength=self.wavelength,
                efl=efl, focal_shift=shift, kind=kind, **like)
        raise ValueError(f'unknown space {self.space!r}')

    def prepare_multiresolution(self, efl, focal_dx, focal_samples, num_levels,
                                scaling=4.0, fine_samples=None, window=(0.2, 0.7),
                                kind='mdft'):
        """Build a MultiResolutionExecutor for this wavefront (in its dtype, on its device)."""
        if self.space != 'pupil':
            raise ValueError('multiresolution propagation begins at a pupil plane')
        return prepare_multiresolution(
            pupil_dx=self.dx, pupil_samples=tuple(self.data.shape[-2:]),
            focal_dx=focal_dx, focal_samples=focal_samples,
            wavelength=self.wavelength, efl=efl, num_levels=num_levels,
            scaling=scaling, fine_samples=fine_samples, window=window, kind=kind,
            dtype=self._complex_dtype(), device=self.data.device)

    def _complex_dtype(self):
        d = self.data.dtype
        return d if d.is_complex else d.to_complex()

    def focus_dft(self, executor):
        """Pupil -> psf via a precomputed plan."""
        if self.space != 'pupil':
            raise ValueError('can only propagate from a pupil to psf plane')
        return self._at_focus(focus_dft(self.data, executor), executor)

    def focus_dft_adjoint(self, executor):
        """Adjoint of focus_dft."""
        if self.space != 'psf':
            raise ValueError('can only apply adjoint from a psf to pupil plane')
        return Wavefront(focus_dft_adjoint(self.data, executor), self.wavelength,
                         executor.pupil_dx, 'pupil')

    def unfocus_dft(self, executor):
        """Psf -> pupil via a precomputed plan."""
        if self.space != 'psf':
            raise ValueError('can only propagate from a psf to pupil plane')
        return Wavefront(unfocus_dft(self.data, executor), self.wavelength,
                         executor.pupil_dx, 'pupil')

    def unfocus_dft_adjoint(self, executor):
        """Adjoint of unfocus_dft."""
        if self.space != 'pupil':
            raise ValueError('can only apply adjoint from a pupil to psf plane')
        return self._at_focus(unfocus_dft_adjoint(self.data, executor), executor)

    def to_fpm_and_back(self, fpm, executor, return_more=False):
        """Propagate to a focal plane mask, apply it, and return."""
        pak = to_fpm_and_back(self.data, fpm=_field_data(fpm), executor=executor,
                              return_more=return_more)
        if not return_more:
            return self._like(pak)
        at_next_pupil, at_fpm, after_fpm = pak
        return (self._like(at_next_pupil), self._at_focus(at_fpm, executor),
                self._at_focus(after_fpm, executor))

    def to_fpm_and_back_adjoint(self, fpm, executor, return_more=False,
                                return_fpm_grad=False, field_at_fpm=None):
        """Adjoint of to_fpm_and_back."""
        pak = to_fpm_and_back_adjoint(self.data, fpm=_field_data(fpm), executor=executor,
                                      return_more=return_more,
                                      return_fpm_grad=return_fpm_grad,
                                      field_at_fpm=_field_data(field_at_fpm))
        if not (return_more or return_fpm_grad):
            return self._like(pak)
        # the pupil gradient first; the rest live at focus
        head, *tail = pak
        return (self._like(head), *(self._at_focus(t, executor) for t in tail))

    def to_fpm_and_back_multiresolution(self, fpm, executor, return_more=False):
        """Multi-resolution focal-plane-mask round trip."""
        if self.space != 'pupil':
            raise ValueError('can only propagate from a pupil to psf plane')
        pak = to_fpm_and_back_multiresolution(self.data, fpm, executor,
                                              return_more=return_more)
        if not return_more:
            return self._like(pak)
        out, at_fpm, after_fpm = pak
        return (self._like(out), self._focal_stack(at_fpm, executor),
                self._focal_stack(after_fpm, executor))

    def to_fpm_and_back_multiresolution_adjoint(self, fpm, executor, return_more=False,
                                                return_fpm_grad=False, field_at_fpm=None):
        """Adjoint of to_fpm_and_back_multiresolution."""
        if field_at_fpm is not None:
            field_at_fpm = [_field_data(f) for f in field_at_fpm]
        pak = to_fpm_and_back_multiresolution_adjoint(
            self.data, fpm, executor, return_more=return_more,
            return_fpm_grad=return_fpm_grad, field_at_fpm=field_at_fpm)
        if not (return_more or return_fpm_grad):
            return self._like(pak)
        # the pupil gradient first, then per-level focal stacks
        head, *stacks = pak
        return (self._like(head), *(self._focal_stack(fields, executor) for fields in stacks))

    def babinet(self, lyot, fpm, executor, return_more=False):
        """Lyot coronagraph via Babinet's principle."""
        pak = babinet(self.data, lyot=_field_data(lyot), fpm=_field_data(fpm),
                      executor=executor, return_more=return_more)
        if not return_more:
            return self._like(pak)
        after_lyot, at_fpm, after_fpm, at_lyot = pak
        return (self._like(after_lyot), self._at_focus(at_fpm, executor),
                self._at_focus(after_fpm, executor), self._like(at_lyot))

    def babinet_adjoint(self, lyot, fpm, executor, field_at_fpm=None, field_at_lyot=None,
                        return_fpm_grad=False, return_lyot_grad=False):
        """Adjoint of babinet."""
        pak = babinet_adjoint(self.data, lyot=_field_data(lyot), fpm=_field_data(fpm),
                              executor=executor, field_at_fpm=_field_data(field_at_fpm),
                              field_at_lyot=_field_data(field_at_lyot),
                              return_fpm_grad=return_fpm_grad,
                              return_lyot_grad=return_lyot_grad)
        if not (return_fpm_grad or return_lyot_grad):
            return self._like(pak)
        remaining = iter(pak)
        out = [self._like(next(remaining))]
        if return_fpm_grad:
            out.append(self._at_focus(next(remaining), executor))
        if return_lyot_grad:
            out.append(self._like(next(remaining)))
        return tuple(out)
