"""FFT-based pupil <-> focal propagation and sample-spacing conversions.

Counterpart of ``prysm_tpu/propagation/fft.py``: focus is the unitary
shift-sandwich ``fftshift(fft2(ifftshift(x)))`` after FFT-aligned padding,
on the trailing two axes.  For even sizes with a symmetric even pad (the
flagship Q=2 case) the zero rows of the pad are pruned from the first FFT
pass and both shifts fold into checkerboard signs; other sizes take the
dense paths.
"""
import math

import torch

from ..fttools import pad2d, crop_center

__all__ = ['focus', 'focus_adjoint', 'unfocus', 'unfocus_adjoint',
           'Q_for_sampling', 'pupil_sample_to_psf_sample',
           'psf_sample_to_pupil_sample']

_AX = (-2, -1)


def _fft2_ortho(x):
    return torch.fft.fft2(x, dim=_AX, norm='ortho')


def _ifft2_ortho(x):
    return torch.fft.ifft2(x, dim=_AX, norm='ortho')


def _shift_sandwich(x, transform2d):
    """fftshift(transform2d(ifftshift(x))) with explicit shifts (any size)."""
    return torch.fft.fftshift(transform2d(torch.fft.ifftshift(x, dim=_AX)), dim=_AX)


def _shape_before_pad(padded_shape, Q):
    if Q == 1:
        return tuple(padded_shape)
    return tuple(int(s // Q) for s in padded_shape)


def _adjoint_pad2d(array, Q):
    out_shape = _shape_before_pad(array.shape[-2:], Q)
    if out_shape != tuple(array.shape[-2:]):
        return crop_center(array, out_shape)
    return array


def _pruned_geometry(in_shape, Q):
    """Padded shape when the pruned transform applies, else None.

    Pruning needs even input dims and a symmetric even pad on both axes.
    """
    if Q == 1:
        return None
    out = tuple(math.ceil(s * Q) for s in in_shape)
    ok = all(s % 2 == 0 and o > s and (o - s) % 2 == 0
             for s, o in zip(in_shape, out))
    return out if ok else None


def _cb(n, x):
    """(-1)^k checkerboard sign vector of length n, in x's real dtype, on x's device."""
    signs = torch.ones(n, dtype=x.real.dtype, device=x.device)
    signs[1::2] = -1
    return signs


def _pruned_pad_shift_transform(E, M_y, M_x, transform):
    """fftshift(transform2d(ifftshift(pad_center(E)))) with the pad's zero
    rows pruned from the row pass and both shifts folded into signs.

    After ifftshift the centred pad is a middle band of zero rows and
    columns, so the first (row) pass runs only over the N nonzero rows.
    The output fftshift is F(w * cb) with cb = (-1)^n for even sizes, so
    the signs multiply the smaller pre-transform operands.  Exact (sign
    flips only); callers must NOT fftshift the result.
    """
    N_y, N_x = E.shape[-2:]
    h_y, h_x = N_y // 2, N_x // 2
    iv = torch.fft.ifftshift(E, dim=_AX)
    lead = E.shape[:-2]
    cbx = _cb(M_x, E)
    z_cols = iv.new_zeros((*lead, N_y, M_x - N_x))
    rows = torch.cat([iv[..., :, :h_x] * cbx[:h_x],
                      z_cols,
                      iv[..., :, h_x:] * cbx[M_x - (N_x - h_x):]], dim=-1)
    Y = transform(rows, dim=-1)
    cby = _cb(M_y, E)
    z_mid = Y.new_zeros((*lead, M_y - N_y, M_x))
    Y = torch.cat([Y[..., :h_y, :] * cby[:h_y, None],
                   z_mid,
                   Y[..., h_y:, :] * cby[M_y - (N_y - h_y):, None]], dim=-2)
    return transform(Y, dim=-2)


def _pruned_shift_transform_crop(X, N_y, N_x, transform):
    """crop_center(fftshift(transform2d(ifftshift(X)))) with pruned rows
    and the input ifftshift folded into output signs.

    The adjoint-side twin: only the N rows that survive the final crop
    enter the second (row-direction) pass.  For even sizes
    F(ifftshift(x)) = cb * F(x) per axis, so the full-size shift becomes
    a sign multiply on the cropped output.  Exact, sign flips only.
    """
    M_y, M_x = X.shape[-2:]
    h_y, h_x = N_y // 2, N_x // 2
    Z = transform(X, dim=-2)
    rows = torch.cat([Z[..., M_y - h_y:, :], Z[..., :h_y, :]], dim=-2)
    W = transform(rows, dim=-1)
    out = torch.cat([W[..., :, M_x - h_x:], W[..., :, :h_x]], dim=-1)
    cby, cbx = _cb(M_y, X), _cb(M_x, X)
    sr = torch.cat([cby[M_y - h_y:], cby[:h_y]])
    sc = torch.cat([cbx[M_x - h_x:], cbx[:h_x]])
    return out * (sr[:, None] * sc[None, :])


def _dense_cb_sandwich(x, transform2d):
    """fftshift(transform2d(ifftshift(x))) via checkerboard signs (even dims).

    The shift sandwich collapses to cb2 * T(cb2 * x) * (-1)^(Ny/2 + Nx/2):
    two sign multiplies instead of two full-size copies.  Exact.
    """
    Ny, Nx = x.shape[-2:]
    cb2 = _cb(Ny, x)[:, None] * _cb(Nx, x)[None, :]
    s0 = (-1.0) ** ((Ny // 2) + (Nx // 2))
    return cb2 * transform2d(cb2 * x) * s0


def _transforms(inverse):
    """(1-D transform, unitary 2-D transform, pruned-path scale for M samples)."""
    if inverse:
        # the two ifft passes already carry 1/(My*Mx)
        return torch.fft.ifft, _ifft2_ortho, math.sqrt
    return torch.fft.fft, _fft2_ortho, lambda m: 1.0 / math.sqrt(m)


def _padded_transform(wavefunction, Q, inverse):
    """Unitary shift-sandwiched transform of the Q-padded field."""
    transform, transform2d, scale = _transforms(inverse)
    geom = _pruned_geometry(wavefunction.shape[-2:], Q)
    if geom is not None:
        # the output fftshift is folded into the pruned transform's signs
        return (_pruned_pad_shift_transform(wavefunction, *geom, transform)
                * scale(geom[0] * geom[1]))
    padded = pad2d(wavefunction, Q) if Q != 1 else wavefunction
    if all(s % 2 == 0 for s in padded.shape[-2:]):
        return _dense_cb_sandwich(padded, transform2d)
    return _shift_sandwich(padded, transform2d)


def _transform_crop(wavefunction, Q, inverse):
    """Adjoint side: unitary shift-sandwiched transform, then centre crop."""
    transform, transform2d, scale = _transforms(inverse)
    shape = tuple(wavefunction.shape[-2:])
    out_shape = _shape_before_pad(shape, Q)
    if out_shape != shape and _pruned_geometry(out_shape, Q) == shape:
        return (_pruned_shift_transform_crop(wavefunction, *out_shape, transform)
                * scale(shape[0] * shape[1]))
    return _adjoint_pad2d(_shift_sandwich(wavefunction, transform2d), Q)


def focus(wavefunction, Q):
    """Propagate a pupil plane to a PSF plane (unitary FFT)."""
    return _padded_transform(wavefunction, Q, inverse=False)


def focus_adjoint(wavefunction, Q):
    """Adjoint of focus: inverse unitary FFT then centre crop."""
    return _transform_crop(wavefunction, Q, inverse=True)


def unfocus(wavefunction, Q):
    """Propagate a PSF plane to a pupil plane (unitary inverse FFT)."""
    return _padded_transform(wavefunction, Q, inverse=True)


def unfocus_adjoint(wavefunction, Q):
    """Adjoint of unfocus: forward unitary FFT then centre crop."""
    return _transform_crop(wavefunction, Q, inverse=False)


def Q_for_sampling(input_diameter, prop_dist, wavelength, output_dx):
    """Q for a given output sampling: (wvl * z / D) / output_dx.

    input_diameter and prop_dist in mm, wavelength in um, output_dx in um.
    """
    resolution_element = (wavelength * prop_dist) / input_diameter
    return resolution_element / output_dx


def pupil_sample_to_psf_sample(pupil_sample, samples, wavelength, efl):
    """Pupil (mm) -> PSF (um) sample spacing: efl * wvl / (dx * N)."""
    return (efl * wavelength) / (pupil_sample * samples)


def psf_sample_to_pupil_sample(psf_sample, samples, wavelength, efl):
    """PSF (um) -> pupil (mm) sample spacing: efl * wvl / (dx * N)."""
    return (efl * wavelength) / (psf_sample * samples)
