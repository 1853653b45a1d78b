"""Lyot-family coronagraph propagation: FPM round trips, Babinet, vortex.

Counterpart of ``prysm_tpu/propagation/coronagraph.py``.  The forward
paths are plain torch compositions that autograd differentiates; the
explicit ``*_adjoint`` twins mirror the reference API for hand-chained
gradient pipelines.  ``executor`` is any plan with ``__call__`` (focus)
and ``adjoint`` (unfocus): ``fttools.MDFT``/``CZT``/``FFTDFT`` or the
wavelength-stacked ``parallel.SpectralMDFT``; the multi-resolution
functions take a ``dft.MultiResolutionExecutor`` and a mask callable of
the focal grids (xf, yf).
"""
import functools
import numbers
import operator

import numpy as np
import torch

from .dft import focus_dft, focus_dft_adjoint, unfocus_dft, unfocus_dft_adjoint
from ..coordinates import _bilinear_lookup
from ..mathops import cis

__all__ = ['to_fpm_and_back', 'to_fpm_and_back_adjoint', 'vortex_phase_mask',
           'prepare_measured_fpm', 'to_fpm_and_back_multiresolution',
           'to_fpm_and_back_multiresolution_adjoint', 'babinet', 'babinet_adjoint']


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


def prepare_measured_fpm(measurement, dx, center=(0, 0), charge=None, fill=None):
    """Wrap a measured complex focal-plane-mask map as an fpm callable.

    Bilinearly interpolates the measured complex transmission at the
    requested focal coordinates; outside the measured extent the mask is
    an ideal vortex (if ``charge`` is given), a scalar, or a callable
    ``fill``.  Array index n // 2 of the measurement maps to ``center``.
    The callable takes numpy grids (and returns numpy) or tensors.
    """
    meas = np.asarray(measurement)
    ny, nx = meas.shape
    cx, cy = center
    re = np.ascontiguousarray(meas.real)
    im = np.ascontiguousarray(meas.imag)
    tables = {}
    if fill is None:
        fill = vortex_phase_mask(charge) if charge is not None else 1.0
    fill_is_callable = callable(fill)

    def _np_bilinear(img, rows, cols):
        r0 = np.floor(rows).astype(np.int64)
        c0 = np.floor(cols).astype(np.int64)
        fr = rows - r0
        fc = cols - c0

        def gather(ri, ci):
            return img[np.clip(ri, 0, ny - 1), np.clip(ci, 0, nx - 1)]

        top = gather(r0, c0) * (1 - fc) + gather(r0, c0 + 1) * fc
        bot = gather(r0 + 1, c0) * (1 - fc) + gather(r0 + 1, c0 + 1) * fc
        return top * (1 - fr) + bot * fr

    def _table(img, like):
        """The measured map as a tensor in the grid's dtype on its device, made once."""
        key = (id(img), like.dtype, like.device)
        if key not in tables:
            tables[key] = torch.from_numpy(img).to(like.device, like.dtype)
        return tables[key]

    def fpm(xf, yf):
        host = isinstance(xf, np.ndarray)
        col = (xf - cx) / dx + nx // 2
        row = (yf - cy) / dx + ny // 2
        # clamp to the border (mode='nearest'); the inside test gates fill
        if host:
            rowc, colc = np.clip(row, 0, ny - 1), np.clip(col, 0, nx - 1)
            interp = _np_bilinear(re, rowc, colc) + 1j * _np_bilinear(im, rowc, colc)
        else:
            rowc, colc = torch.clamp(row, 0, ny - 1), torch.clamp(col, 0, nx - 1)
            interp = torch.complex(_bilinear_lookup(_table(re, xf), rowc, colc),
                                   _bilinear_lookup(_table(im, xf), rowc, colc))
        inside = (row >= 0) & (row <= ny - 1) & (col >= 0) & (col <= nx - 1)
        fillv = fill(xf, yf) if fill_is_callable else fill
        if host:
            return np.where(inside, interp, fillv)
        return torch.where(inside, interp, torch.as_tensor(fillv, dtype=interp.dtype,
                                                           device=interp.device))

    return fpm


def _mr_levels(executor):
    """Per-level (executor, window, xf, yf) tuples of a multiresolution stack."""
    return zip(executor.executors, executor.windows, executor.xf, executor.yf)


def to_fpm_and_back_multiresolution(wavefunction, fpm, executor, return_more=False):
    """Multi-resolution to_fpm_and_back: the sum of per-level windowed round trips.

    Each level propagates to its focal grid, applies mask x window and
    propagates back; the level sums rebuild the full-bandwidth round trip.
    """
    at_fpm, after_fpm, contributions = [], [], []
    for ex, win, xf, yf in _mr_levels(executor):
        E_focus = focus_dft(wavefunction, ex)
        E_masked = E_focus * fpm(xf, yf) * win
        contributions.append(unfocus_dft(E_masked, ex))
        at_fpm.append(E_focus)
        after_fpm.append(E_masked)
    total = functools.reduce(operator.add, contributions)
    return (total, at_fpm, after_fpm) if return_more else total


def to_fpm_and_back_multiresolution_adjoint(wavefunction, fpm, executor, return_more=False,
                                            return_fpm_grad=False, field_at_fpm=None):
    """Adjoint of to_fpm_and_back_multiresolution; optionally the per-level FPM gradients."""
    if return_fpm_grad and field_at_fpm is None:
        raise ValueError('return_fpm_grad=True requires field_at_fpm from '
                         'the forward propagation')
    Ebbars, intermediates, fpm_bars, contributions = [], [], [], []
    for k, (ex, win, xf, yf) in enumerate(_mr_levels(executor)):
        mask = fpm(xf, yf)
        Ebbar = unfocus_dft_adjoint(wavefunction, ex)
        intermediate = _adjoint_multiply(Ebbar, mask * win)
        contributions.append(focus_dft_adjoint(intermediate, ex))
        Ebbars.append(Ebbar)
        intermediates.append(intermediate)
        if return_fpm_grad:
            fpm_bars.append(_adjoint_multiply(Ebbar, field_at_fpm[k] * win,
                                              real=not _is_complex(mask)))
    total = functools.reduce(operator.add, contributions)
    extras = ((Ebbars, intermediates) if return_more else ()) + \
        ((fpm_bars,) if return_fpm_grad else ())
    return (total, *extras) if extras else total


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
