"""Lyot-family coronagraph propagation: FPM round trips, Babinet, vortex.

Counterpart of ``prysm_tpu/propagation/coronagraph.py`` (its single-plan
part).  The forward paths are plain torch compositions that autograd
differentiates; the explicit ``*_adjoint`` twins mirror the reference API
for hand-chained gradient pipelines.  ``executor`` is any plan with
``__call__`` (focus) and ``adjoint`` (unfocus): ``fttools.MDFT`` or the
wavelength-stacked ``parallel.SpectralMDFT``.
"""
import numbers

import numpy as np
import torch

from .dft import focus_dft, focus_dft_adjoint, unfocus_dft, unfocus_dft_adjoint
from ..mathops import cis

__all__ = ['to_fpm_and_back', 'to_fpm_and_back_adjoint', 'vortex_phase_mask',
           'babinet', 'babinet_adjoint']


def _is_complex(x):
    """Whether x (a tensor or a Python number) is complex."""
    return x.is_complex() if torch.is_tensor(x) else isinstance(x, complex)


def _adjoint_multiply(grad, factor, real=False):
    """Adjoint with respect to x for y = x * factor."""
    if _is_complex(factor):
        out = grad * (factor.conj() if torch.is_tensor(factor) else factor.conjugate())
    else:
        out = grad * factor
    if real:
        return out.real
    return out


def to_fpm_and_back(wavefunction, fpm, executor, return_more=False):
    """focus_dft -> multiply by fpm -> unfocus_dft, one executor both legs."""
    field_at_fpm = focus_dft(wavefunction, executor)
    field_after_fpm = field_at_fpm * fpm
    field_at_next_pupil = unfocus_dft(field_after_fpm, executor)
    if return_more:
        return field_at_next_pupil, field_at_fpm, field_after_fpm
    return field_at_next_pupil


def to_fpm_and_back_adjoint(wavefunction, fpm, executor, return_more=False,
                            return_fpm_grad=False, field_at_fpm=None):
    """Adjoint of to_fpm_and_back; optionally also the FPM gradient."""
    if return_fpm_grad and field_at_fpm is None:
        raise ValueError('return_fpm_grad=True requires field_at_fpm from the forward '
                         'propagation')
    fpm_is_complex = _is_complex(fpm)
    Ebbar = unfocus_dft_adjoint(wavefunction, executor)
    intermediate = _adjoint_multiply(Ebbar, fpm)
    Eabar = focus_dft_adjoint(intermediate, executor)
    if return_fpm_grad:
        fpm_bar = _adjoint_multiply(Ebbar, field_at_fpm, real=not fpm_is_complex)
    if return_more:
        if return_fpm_grad:
            return Eabar, Ebbar, intermediate, fpm_bar
        return Eabar, Ebbar, intermediate
    elif return_fpm_grad:
        return Eabar, fpm_bar
    return Eabar


def vortex_phase_mask(charge):
    """Focal-plane-mask callable exp(i * charge * theta) for an optical vortex.

    The callable takes numpy arrays (and returns numpy) or tensors.
    """
    if not isinstance(charge, numbers.Integral):
        raise TypeError(f'charge must be an integer, got {charge!r}; '
                        'non-integer charge has a branch cut at theta=pi')

    def fpm(xf, yf):
        if isinstance(xf, np.ndarray):
            return np.exp(1j * (charge * np.arctan2(yf, xf)))
        return cis(charge * torch.atan2(yf, xf))

    return fpm


def babinet(wavefunction, lyot, fpm, executor, return_more=False):
    """Lyot coronagraph via Babinet's principle.

    fpm must approach 1 at the edge of the focal window so the complement
    1 - fpm is compactly supported.
    """
    round_trip = to_fpm_and_back(wavefunction, fpm=1 - fpm, executor=executor,
                                 return_more=return_more)
    removed, *focal_fields = round_trip if return_more else (round_trip,)
    field_at_lyot = wavefunction - removed
    field_after_lyot = field_at_lyot if lyot is None else lyot * field_at_lyot
    if return_more:
        return (field_after_lyot, *focal_fields, field_at_lyot)
    return field_after_lyot


def babinet_adjoint(wavefunction, lyot, fpm, executor, field_at_fpm=None,
                    field_at_lyot=None, return_fpm_grad=False, return_lyot_grad=False):
    """Adjoint of babinet; optionally recovers lyot and fpm gradients."""
    if return_lyot_grad and field_at_lyot is None:
        raise ValueError('return_lyot_grad=True requires field_at_lyot from the forward '
                         'propagation')
    lyot_is_complex = True if lyot is None else _is_complex(lyot)
    fpm = 1 - fpm
    dbar = wavefunction
    cbar = dbar if lyot is None else _adjoint_multiply(dbar, lyot)
    if return_fpm_grad:
        abar, fpm_bar = to_fpm_and_back_adjoint(cbar, fpm=fpm, executor=executor,
                                                return_fpm_grad=True,
                                                field_at_fpm=field_at_fpm)
    else:
        abar = to_fpm_and_back_adjoint(cbar, fpm=fpm, executor=executor)
    abar = cbar - abar
    if not (return_fpm_grad or return_lyot_grad):
        return abar
    out = [abar]
    if return_fpm_grad:
        out.append(fpm_bar)
    if return_lyot_grad:
        out.append(_adjoint_multiply(dbar, field_at_lyot, real=not lyot_is_complex))
    return tuple(out)
