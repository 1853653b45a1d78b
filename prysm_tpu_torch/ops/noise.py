"""Fused detector exposure: a CUDA kernel and its plain version.

Counterpart of ``prysm_tpu/ops/noise.py``.  ``expose_pallas`` turns a 2-D
mean-electron map into ``frames`` exposures in float32 DN after the ADC
clip, in one pass per (frame, pixel): Philox4x32-10 bits -> Box-Muller
Gaussians -> Gaussian approximation of Poisson shot noise
``max(0, round(lam + sqrt(lam) z))`` (sound for lam of ~20 electrons and
more) -> read noise, bias, full-well clip, gain, ADC clip.  Quantising and
the lookup table happen outside, in ``Detector._quantize``.

``csrc/noise.cu`` expose_kernel replaces ``_expose_kernel``.  The TPU's
hardware generator has no counterpart on the card, so both the kernel and
the plain version below run Philox4x32-10 keyed by ``(seed, STREAM)`` on
the counter ``(pixel index, frame, 0, 0)``: the two give the same uniforms,
and the same seed gives the same frames.  CUDA tensors launch the kernel,
CPU tensors take the plain version; there is no fallback.
"""
import ctypes
from functools import lru_cache

import torch

from . import _cuda

__all__ = ['expose_pallas', 'expose_plain', 'philox4x32_10', 'uniform01',
           'box_muller', 'LAUNCHES', 'reset_launches']

# launches of the kernel wrapper; the plain version does not count
LAUNCHES = {'noise_expose': 0}

# Philox4x32-10 multipliers and Weyl key increments (Random123)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
# the second key word, the ASCII of "prys"; csrc/noise.cu kStream
STREAM = 0x70727973


def reset_launches():
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain version (CPU tensors; the reference the kernel is held against)
# ---------------------------------------------------------------------------

def _mulhilo(m, x):
    """(hi, lo) 32-bit words of the 64-bit product of the constant m and x.

    x holds uint32 values in int64.  The full product does not fit a
    signed int64, so x is split into 16-bit halves: each partial product
    has at most 48 bits, and the carry out of the low word is added back.
    """
    p_lo = x & 0xFFFF
    p_hi = x >> 16
    a = m * p_lo                      # < 2^48
    b = m * p_hi                      # < 2^48, weight 2^16
    low = (a & _MASK) + ((b & 0xFFFF) << 16)
    return (a >> 32) + (b >> 16) + (low >> 32), low & _MASK


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors of uint32 values (broadcasting); four words out.

    Counter words may be Python ints; they go to the device of the first
    tensor among them.
    """
    dev = next(c.device for c in (c0, c1, c2, c3) if torch.is_tensor(c))
    c0, c1, c2, c3 = torch.broadcast_tensors(*(torch.as_tensor(c, dtype=torch.int64, device=dev)
                                               for c in (c0, c1, c2, c3)))
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform01(bits):
    """Uniform in (0, 1] from 32 random bits: (bits >> 8) 2^-24 + 2^-25, in float32."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))


def box_muller(u1, u2):
    """Two independent standard Gaussians, r cos(theta) and r sin(theta)."""
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = (2.0 * torch.pi) * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def _gaussians(npix, frames, seed, device):
    """(z_shot, z_read), each (frames, npix) float32, from the kernel's counters."""
    pix = torch.arange(npix, dtype=torch.int64, device=device)
    frame = torch.arange(frames, dtype=torch.int64, device=device)[:, None]
    w0, w1, _, _ = philox4x32_10(pix, frame, 0, 0, int(seed) & _MASK, STREAM)
    return box_muller(uniform01(w0), uniform01(w1))


def _dn_chain(lam, z_shot, z_read, read_noise, bias, fwc, inv_gain, adc_cap):
    """Shot -> DN chain: Gaussian-approximated Poisson, read, bias, full well, gain, ADC clip.

    The kernel computes the same operations in the same order.
    """
    shot = torch.clamp(torch.round(lam + torch.sqrt(lam) * z_shot), min=0.0)
    val = shot + read_noise * z_read + bias
    val = torch.clamp(val, max=fwc) * inv_gain
    return torch.clamp(val, 0.0, adc_cap)


def _chain_args(read_noise, bias, fwc, conversion_gain, bits):
    return (float(read_noise), float(bias), float(fwc), float(1.0 / conversion_gain),
            float(2 ** bits - 1))


def expose_plain(mean_electrons, frames, seed, read_noise, bias, fwc, conversion_gain,
                 bits):
    """Plain version of expose_kernel: (frames, H, W) float32 DN, on any device."""
    lam = mean_electrons.to(torch.float32)
    z_shot, z_read = _gaussians(lam.numel(), frames, seed, lam.device)
    out = _dn_chain(lam.reshape(1, -1), z_shot, z_read,
                    *_chain_args(read_noise, bias, fwc, conversion_gain, bits))
    return out.reshape(frames, *lam.shape)


# ---------------------------------------------------------------------------
# kernel wrapper (CUDA tensors)
# ---------------------------------------------------------------------------

_P, _I, _LL, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint,
                       ctypes.c_float)


@lru_cache(None)
def _lib():
    lib = _cuda.load('noise')
    lib.prysm_noise_expose.argtypes = [_P, _P, _LL, _I, _U, _F, _F, _F, _F, _F, _P]
    lib.prysm_noise_expose.restype = _I
    return lib


def _launch(mean_electrons, frames, seed, read_noise, bias, fwc, conversion_gain, bits):
    lam = mean_electrons
    if lam.device.type != 'cuda' or lam.dtype != torch.float32 or lam.ndim != 2 \
            or not lam.is_contiguous():
        raise ValueError('the noise kernel takes a contiguous 2-D float32 CUDA tensor, '
                         f'got {tuple(lam.shape)} {lam.dtype} on {lam.device}')
    frames = int(frames)
    if not 0 < frames <= 65535:
        raise ValueError(f'frames must be in 1..65535, got {frames}')
    if lam.numel() >= 2 ** 32:
        raise ValueError('the noise kernel counts pixels in 32 bits; the map is too large')
    out = torch.empty((frames, *lam.shape), dtype=torch.float32, device=lam.device)
    with torch.cuda.device(lam.device):
        rc = _lib().prysm_noise_expose(
            lam.data_ptr(), out.data_ptr(), lam.numel(), frames, int(seed) & _MASK,
            *_chain_args(read_noise, bias, fwc, conversion_gain, bits),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f'noise_expose launch failed with cudaError_t {rc}')
    LAUNCHES['noise_expose'] += 1
    return out


def expose_pallas(mean_electrons, frames, seed, read_noise, bias, fwc, conversion_gain,
                  bits):
    """Fused exposure: mean electron map -> (frames, H, W) float32 DN.

    mean_electrons: 2-D mean electron count per pixel (signal*t + dark,
    fixed-pattern scalings already applied), cast to float32.  seed: int
    (same seed, same frames).  Returns float32 DN after the ADC clip;
    quantise outside.  A CUDA tensor launches ``csrc/noise.cu``; a CPU
    tensor takes the plain version.
    """
    if mean_electrons.ndim != 2:
        raise ValueError('expose_pallas requires a 2D mean electron map')
    lam = mean_electrons.to(torch.float32)
    if lam.device.type == 'cpu':
        return expose_plain(lam, frames, seed, read_noise, bias, fwc, conversion_gain, bits)
    if lam.device.type != 'cuda':
        raise ValueError(f'expose_pallas takes CUDA or CPU tensors, got {lam.device}')
    return _launch(lam.contiguous(), frames, seed, read_noise, bias, fwc, conversion_gain,
                   bits)
