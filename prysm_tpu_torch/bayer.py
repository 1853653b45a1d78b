"""Bayer color-filter-array operations: composite, white balance, demosaic.

Counterpart of ``prysm_tpu/bayer.py``.  Every op is pure: checkerboard
selection is a parity-mask ``where``, and the Malvar convolutions are
symmetric padding followed by shifted adds over each kernel's nonzero taps.
``F.conv2d`` is not used: cuDNN runs float32 convolutions in TF32 by
default, which would change the numbers.
"""
import numpy as np
import torch

from .conf import config
from .mathops import cis

__all__ = ['top_left', 'top_right', 'bottom_left', 'bottom_right', 'wb_prescale',
           'wb_postscale', 'composite_bayer', 'decomposite_bayer', 'recomposite_bayer',
           'demosaic_deinterlace', 'assemble_superresolved', 'demosaic_malvar']

top_left = (Ellipsis, slice(0, None, 2), slice(0, None, 2))
top_right = (Ellipsis, slice(0, None, 2), slice(1, None, 2))
bottom_left = (Ellipsis, slice(1, None, 2), slice(0, None, 2))
bottom_right = (Ellipsis, slice(1, None, 2), slice(1, None, 2))

ErrBadCFA = NotImplementedError('only rggb, bggr bayer patterns currently implemented')


def _parity_masks(shape, device):
    """(tl, tr, bl, br) boolean masks of the 2x2 CFA tiling for a 2D shape."""
    rows = torch.arange(shape[-2], device=device) % 2
    cols = torch.arange(shape[-1], device=device) % 2
    re = rows[:, None] == 0
    ce = cols[None, :] == 0
    return re & ce, re & ~ce, ~re & ce, ~re & ~ce


def _as(value, like):
    """A Python number or tensor as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def _safe_ratio(peaks, gains, saturation, count):
    """max(1, peak * gain / saturation) over the planes, as a 0-d tensor."""
    if not hasattr(saturation, '__iter__'):
        saturation = [saturation] * count
    else:
        saturation = list(saturation)
        if len(saturation) != count:
            word = {3: 'three', 4: 'four'}[count]
            raise ValueError(f'saturation must be scalar or contain {word} values')
    if any(s <= 0 for s in saturation):
        raise ValueError('saturation must be positive')
    ratio = None
    for peak, gain, sat in zip(peaks, gains, saturation):
        rat = peak * gain / sat
        ratio = torch.clamp(rat, min=1.0) if ratio is None else torch.maximum(ratio, rat)
    return ratio


def wb_prescale(mosaic, wr, wg1, wg2, wb, cfa='rggb', safe=False, saturation=None):
    """White-balance prescaling of a mosaic; returns the scaled mosaic."""
    cfa = cfa.lower()
    if safe:
        if saturation is None:
            raise ValueError('When doing safe WB prescaling, saturation must be not-none')
        peaks = [plane.max() for plane in decomposite_bayer(mosaic, cfa)]
        ratio = _safe_ratio(peaks, (wr, wg1, wg2, wb), saturation, 4)
        wr, wg1, wg2, wb = (w / ratio for w in (wr, wg1, wg2, wb))

    tl, tr, bl, br = _parity_masks(mosaic.shape, mosaic.device)
    wr, wg1, wg2, wb = (_as(w, mosaic) for w in (wr, wg1, wg2, wb))
    if cfa == 'rggb':
        g = torch.where(tl, wr, torch.where(tr, wg1, torch.where(bl, wg2, wb)))
    elif cfa == 'bggr':
        g = torch.where(tl, wb, torch.where(tr, wg1, torch.where(bl, wg2, wr)))
    else:
        raise ErrBadCFA
    return mosaic * g


def wb_postscale(rgb, wr, wg, wb, safe=False, saturation=None):
    """White-balance gains on a trichromatic (m, n, 3) image; returns new array."""
    if safe:
        if saturation is None:
            raise ValueError('When doing safe WB prescaling, saturation must be not-none')
        peaks = [rgb[..., i].max() for i in range(3)]
        ratio = _safe_ratio(peaks, (wr, wg, wb), saturation, 3)
        wr, wg, wb = (w / ratio for w in (wr, wg, wb))
    return torch.stack([rgb[..., 0] * wr, rgb[..., 1] * wg, rgb[..., 2] * wb], dim=-1)


def composite_bayer(r, g1, g2, b, cfa='rggb'):
    """Interleave densely sampled color planes into a mosaic."""
    cfa = cfa.lower()
    tl, tr, bl, br = _parity_masks(r.shape, r.device)
    if cfa == 'rggb':
        return torch.where(tl, r, torch.where(tr, g1, torch.where(bl, g2, b)))
    elif cfa == 'bggr':
        return torch.where(tl, b, torch.where(tr, g1, torch.where(bl, g2, r)))
    raise ErrBadCFA


def decomposite_bayer(img, cfa='rggb'):
    """Split a mosaic into (r, g1, g2, b) quarter-resolution planes."""
    cfa = cfa.lower()
    if cfa == 'rggb':
        return (img[top_left], img[top_right], img[bottom_left], img[bottom_right])
    elif cfa == 'bggr':
        return (img[bottom_right], img[top_right], img[bottom_left], img[top_left])
    raise ErrBadCFA


def recomposite_bayer(r, g1, g2, b, cfa='rggb'):
    """Reassemble quarter-resolution planes into a mosaic (inverse of decomposite)."""
    cfa = cfa.lower()
    if cfa == 'rggb':
        order = (r, g1, g2, b)
    elif cfa == 'bggr':
        order = (b, g1, g2, r)
    else:
        raise ErrBadCFA
    m, n = r.shape[-2:]
    out = r.new_zeros((*r.shape[:-2], 2 * m, 2 * n))
    for where, plane in zip((top_left, top_right, bottom_left, bottom_right), order):
        out[where] = plane
    return out


def demosaic_deinterlace(img, cfa='rggb'):
    """Demosaic by de-interlacing: (m//2, n//2, 3), greens averaged."""
    r, g1, g2, b = decomposite_bayer(img, cfa)
    g = (g1 + g2) / 2
    return torch.stack([r, g, b], dim=-1)


def _fourier_shift(plane, shift_rows, shift_cols):
    """Subpixel shift via linear phase in the Fourier domain."""
    m, n = plane.shape[-2:]
    F = torch.fft.fft2(plane, dim=(-2, -1))
    real = plane.real.dtype if plane.is_complex() else plane.dtype
    ky = torch.fft.fftfreq(m, dtype=real, device=plane.device)
    kx = torch.fft.fftfreq(n, dtype=real, device=plane.device)
    phase = cis(-2 * np.pi * (ky[:, None] * shift_rows + kx[None, :] * shift_cols))
    return torch.fft.ifft2(F * phase, dim=(-2, -1)).real


def assemble_superresolved(r, g1, g2, b, zoomfactor, cfa='rggb'):
    """Assemble a trichromatic image from super-resolved color planes.

    Each plane is Fourier-shifted onto the G1 grid before stacking.
    """
    if cfa != 'rggb':
        raise NotImplementedError('assemble_superresolved: only rggb patterns '
                                  'supported at this time')
    rp = _fourier_shift(r, -zoomfactor, 0)
    bp = _fourier_shift(b, 0, zoomfactor)
    g2p = _fourier_shift(g2, -zoomfactor, zoomfactor)
    gp = (g2p + g1) / 2
    return torch.stack([rp, gp, bp], dim=-1)


# Kernels from Malvar et al, fig 2.
kernel_G_at_R_or_B = [
    [0, 0, -1, 0, 0],
    [0, 0, 2, 0, 0],
    [-1, 2, 4, 2, -1],
    [0, 0, 2, 0, 0],
    [0, 0, -1, 0, 0],
]

kernel_R_at_G_in_RB = [
    [0, 0, .5, 0, 0],
    [0, -1, 0, -1, 0],
    [-1, 4, 5, 4, -1],
    [0, -1, 0, -1, 0],
    [0, 0, .5, 0, 0],
]

kernel_R_at_G_in_BR = [
    [0, 0, -1, 0, 0],
    [0, -1, 4, -1, 0],
    [.5, 0, 5, 0, .5],
    [0, -1, 4, -1, 0],
    [0, 0, -1, 0, 0],
]

kernel_R_at_B_in_BB = [
    [0, 0, -3 / 2, 0, 0],
    [0, 2, 0, 2, 0],
    [-3 / 2, 0, 6, 0, -3 / 2],
    [0, 2, 0, 2, 0],
    [0, 0, -3 / 2, 0, 0],
]


def _pad_symmetric(img, pad):
    """Pad the trailing two axes by mirroring, the edge sample included.

    numpy's 'symmetric' mode, which is scipy.ndimage's 'reflect'; torch's
    own 'reflect' leaves the edge sample out.
    """
    for dim in (-2, -1):
        n = img.shape[dim]
        idx = torch.cat([torch.arange(pad - 1, -1, -1), torch.arange(n),
                         torch.arange(n - 1, n - 1 - pad, -1)]).to(img.device)
        img = img.index_select(dim, idx)
    return img


def _convolve_reflect(img, kernel, scale=1.0):
    """2D convolution with reflect boundary (scipy ndimage.convolve semantics).

    Shifted adds over the kernel's nonzero taps (the Malvar kernels have
    at most 9 of 25), in the JAX package's order, so float64 results agree
    with it to the last bit.
    """
    k = np.asarray(kernel, dtype=np.float64)
    pad = k.shape[0] // 2
    # ndimage.convolve flips the kernel; all Malvar kernels are symmetric
    # but flip anyway for exactness
    k = k[::-1, ::-1] * scale
    padded = _pad_symmetric(img, pad)
    H, W = img.shape[-2:]
    out = None
    for i, j in zip(*np.nonzero(k)):
        term = padded[..., i:i + H, j:j + W] * float(k[i, j])
        out = term if out is None else out + term
    return out


def demosaic_malvar(img, cfa='rggb'):
    """Malvar et al. 5x5 gradient-corrected linear demosaic -> (m, n, 3)."""
    cfa = cfa.lower()
    if not (img.is_floating_point() or img.is_complex()):
        img = img.to(config.precision)
    Gest = _convolve_reflect(img, kernel_G_at_R_or_B, scale=1 / 8.)
    c1 = _convolve_reflect(img, kernel_R_at_G_in_RB, scale=1 / 8.)
    c2 = _convolve_reflect(img, kernel_R_at_G_in_BR, scale=1 / 8.)
    c3 = _convolve_reflect(img, kernel_R_at_B_in_BB, scale=1 / 8.)

    tl, tr, bl, br = _parity_masks(img.shape, img.device)
    green = torch.where(tr | bl, img, Gest)
    if cfa == 'rggb':
        red = torch.where(tl, img, torch.where(tr, c1, torch.where(bl, c2, c3)))
        blue = torch.where(tl, c3, torch.where(tr, c2, torch.where(bl, c1, img)))
    elif cfa == 'bggr':
        blue = torch.where(tl, img, torch.where(tr, c1, torch.where(bl, c2, c3)))
        red = torch.where(tl, c3, torch.where(tr, c2, torch.where(bl, c1, img)))
    else:
        raise ErrBadCFA
    return torch.stack((red, green, blue), dim=-1)
