"""Detector simulation: noise model, pixel transfer functions, bin/tile.

Counterpart of ``prysm_tpu/detector.py``.  Where the JAX package takes a
``jax.random`` key, the port takes a ``torch.Generator`` (or an integer
seed).  ``expose`` samples through one of two paths:

* ``'random'``: exact Poisson shot noise and Gaussian read noise from
  ``torch.poisson`` and ``torch.randn`` on the generator;
* ``'fused'``: ``ops.noise.expose_pallas``, the hand-written CUDA kernel
  on a CUDA tensor (its plain version on a CPU tensor), with shot noise by
  the Gaussian approximation of Poisson.

PyTorch runs eagerly, so ``'auto'`` always sees a concrete scene: it takes
the fused path only for a photon-rich (min mean >= 20 e-) 2-D float32 map
on CUDA.  A caller that wants the kernel regardless, as the JAX package's
traced benchmark gets it, asks for ``method='fused'``.
"""
import functools
import itertools
import numbers

import torch

from .ops.noise import expose_pallas

__all__ = ['PHOTON_RICH_ELECTRONS', 'apply_lut', 'Detector', 'olpf_ft', 'pixel_ft',
           'pixel', 'bindown', 'tile']

# mean electron count above which the Gaussian approximation of Poisson
# shot noise holds to < 1% moment error: the fused kernel's regime
PHOTON_RICH_ELECTRONS = 20.0


def apply_lut(img, lut):
    """Apply a lookup table: lut[img] with integer img (a gather).

    torch indexes with int64 and int32 tensors only (it reads a uint8 or
    bool index as a mask and refuses uint16), so other images are cast to
    int64 first.
    """
    if img.dtype not in (torch.int64, torch.int32):
        img = img.to(torch.int64)
    return lut.reshape(-1)[img]


class Detector:
    """Model of a detector (focal plane array + ADC).

    dark_current e-/s, read_noise e-, bias e-, fwc e-, conversion_gain
    e-/DN, bits, exposure_time s, optional prnu/dcnu fixed maps and a
    nonlinearity lut (tensors on the scene's device).
    """

    def __init__(self, dark_current, read_noise, bias, fwc, conversion_gain,
                 bits, exposure_time, prnu=None, dcnu=None, lut=None):
        """Store detector parameters."""
        self.dark_current = dark_current
        self.read_noise = read_noise
        self.bias = bias
        self.fwc = fwc
        self.conversion_gain = conversion_gain
        self.bits = bits
        self.exposure_time = exposure_time
        self.prnu = prnu
        self.dcnu = dcnu
        self.lut = lut
        # which sampler the most recent expose() used: 'fused' or 'random'
        self.last_expose_path = None

    def _mean_electrons(self, aerial_img):
        """Mean electron map: signal*t with PRNU, plus dark with DCNU."""
        electrons = aerial_img * self.exposure_time
        if self.prnu is not None:
            electrons = electrons * self.prnu
        dark = self.dark_current * self.exposure_time
        if self.dcnu is not None:
            dark = dark * self.dcnu
        return electrons + dark

    def _quantize(self, output):
        """ADC integer cast + optional nonlinearity LUT."""
        if self.bits <= 8:
            output = output.to(torch.uint8)
        elif self.bits <= 16:
            output = output.to(torch.uint16)
        elif self.bits <= 32:
            output = output.to(torch.uint32)
        else:
            raise ValueError('> 32 unsigned bits not supported')
        if self.lut is not None:
            output = apply_lut(output, self.lut)
        return output

    def _choose_path(self, mean, method):
        """Dispatch policy for the noise sampler.

        'auto' takes the fused kernel when its Gaussian-shot approximation
        is sound and the card runs it: a CUDA tensor, float32, 2-D, and a
        photon-rich scene (min mean >= PHOTON_RICH_ELECTRONS).  Exact
        Poisson everywhere else.
        """
        if method in ('fused', 'random'):
            return method
        if method != 'auto':
            raise ValueError(f"method must be 'auto', 'fused', or 'random'; got {method!r}")
        if mean.device.type != 'cuda':
            return 'random'
        if mean.ndim != 2 or mean.dtype != torch.float32:
            return 'random'
        if float(mean.min()) < PHOTON_RICH_ELECTRONS:
            return 'random'
        return 'fused'

    def expose(self, aerial_img, frames=1, generator=None, seed=None, method='auto'):
        """Form exposure(s) of an aerial image (e-/s) -> DN.

        Noise chain: dark + PRNU/DCNU -> Poisson shot -> Gaussian read ->
        bias -> FWC clip -> gain -> ADC clip/quantize -> optional LUT.
        Either a ``torch.Generator`` on the scene's device or an integer
        ``seed`` is required for reproducible noise.  Force a path with
        method='fused'/'random'; the path taken is recorded on
        ``self.last_expose_path``.
        """
        if generator is None and seed is None:
            raise ValueError('expose requires an explicit torch.Generator or integer seed')
        mean = self._mean_electrons(aerial_img)
        path = self._choose_path(mean, method)
        self.last_expose_path = path
        if path == 'fused':
            if seed is None:
                # any 32-bit word of the generator's stream is a valid kernel seed
                seed = int(torch.randint(2 ** 31, (), generator=generator,
                                         device=generator.device))
            output = self._sample_fused(mean, frames, seed)
        else:
            if generator is None:
                generator = torch.Generator(device=mean.device).manual_seed(int(seed))
            output = self._sample_random(mean, frames, generator)
        output = output.reshape((frames, *aerial_img.shape))
        if frames == 1:
            output = output[0]
        return self._quantize(output)

    def _sample_random(self, mean, frames, generator):
        """Exact-Poisson shot + Gaussian read chain on the generator."""
        mean = mean.reshape(1, -1).expand(frames, -1).contiguous()
        shot = torch.poisson(mean, generator=generator)
        read = self.read_noise * torch.randn(shot.shape, generator=generator,
                                             dtype=mean.dtype, device=mean.device)
        input_to_adc = torch.clamp(shot + read + self.bias, max=self.fwc)
        output = input_to_adc * (1 / self.conversion_gain)
        return torch.clamp(output, 0, 2 ** self.bits - 1)

    def _sample_fused(self, mean, frames, seed):
        """The fused chain: ops/noise.py (Philox, Gaussian shot approximation)."""
        return expose_pallas(mean, frames, seed, self.read_noise, self.bias,
                             self.fwc, self.conversion_gain, self.bits)

    def expose_fused(self, aerial_img, frames=1, seed=0):
        """Exposure forced through the fused noise kernel.

        Equivalent to ``expose(..., seed=seed, method='fused')``: one pass
        per (frame, pixel), Box-Muller Gaussians from Philox4x32-10, shot
        noise by the Gaussian approximation of Poisson (valid for >= ~20
        mean electrons; use method='random' for photon-starved scenes),
        then the identical read/bias/FWC/gain/ADC chain.  See
        prysm_tpu_torch/ops/noise.py.
        """
        return self.expose(aerial_img, frames=frames, seed=seed, method='fused')


def olpf_ft(fx, fy, width_x, width_y):
    """Analytic FT of an optical low-pass filter (birefringent 2/4-pole)."""
    return torch.cos(2 * width_x * fx) * torch.cos(2 * width_y * fy)


def pixel_ft(fx, fy, width_x, width_y):
    """Analytic FT of a rectangular pixel aperture: separable sinc."""
    return torch.sinc(fx * width_x) * torch.sinc(fy * width_y)


def pixel(x, y, width_x, width_y):
    """Spatial representation of a rectangular pixel."""
    width_x = width_x / 2
    width_y = width_y / 2
    return (x <= width_x) & (x >= -width_x) & (y <= width_y) & (y >= -width_y)


def bindown(array, factor, mode='avg'):
    """Bin an array by integer factor(s) via reshape + reduce.

    Shapes must be integer multiples of factor on each axis.
    """
    if isinstance(factor, numbers.Number):
        factor = tuple([factor] * array.ndim)
    output_shape = tuple(s // n for s, n in zip(array.shape, factor))
    inter_shape = tuple(itertools.chain(*zip(output_shape, factor)))
    view = array.reshape(inter_shape)
    reduction_axes = tuple(range(1, 2 * array.ndim, 2))
    if mode.lower() in ('avg', 'average', 'mean'):
        return view.mean(dim=reduction_axes)
    elif mode.lower() == 'sum':
        return view.sum(dim=reduction_axes)
    raise ValueError('mode must be average or sum.')


def tile(array, factor, scaling='sum'):
    """Tile (repeat) an array by factor; the adjoint of bindown."""
    if isinstance(factor, numbers.Number):
        factor = tuple([factor] * array.ndim)
    shape1 = tuple(itertools.chain(*zip(array.shape, [1] * len(factor))))
    shape2 = tuple(itertools.chain(*zip(array.shape, factor)))
    output_shape = tuple(s * n for s, n in zip(array.shape, factor))
    view = array.reshape(shape1).expand(shape2).reshape(output_shape)
    if scaling == 'sum':
        sf = functools.reduce(lambda x, y: x * y, factor)
        view = view * (1 / sf)
    elif scaling in ('avg', 'average', 'mean'):
        pass
    else:
        raise ValueError('scaling must be average or sum')
    return view
