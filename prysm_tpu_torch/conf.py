"""Precision and device configuration.

Counterpart of ``prysm_tpu/conf.py``.  ``config.precision`` /
``config.precision_complex`` are the working real/complex dtype pair, as
torch dtypes; ``config.device`` is where constructors put their tensors.

The default device is CUDA.  When no card is present, a constructor that
was not asked for another device raises: the port never drops to the CPU
on its own.  Functions that take tensors follow the device of their inputs.

Matmul precision: torch's default full-fp32 matmul matches the JAX
package's pinned ``'highest'``.  TF32 is never turned on globally; the
MDFT plan scopes it around its own matmuls when asked for ``'high'``
(``fttools.MDFT``).
"""
import numbers

import torch

__all__ = ['config', 'Config', 'resolve_device']

_COMPLEX_FOR_REAL = {
    torch.float16: torch.complex64,
    torch.bfloat16: torch.complex64,
    torch.float32: torch.complex64,
    torch.float64: torch.complex128,
}

_BY_DEPTH = {16: torch.float16, 32: torch.float32, 64: torch.float64}


class Config:
    """Global configuration of precision and device.

    Reading ``config.precision`` / ``config.precision_complex`` yields the
    working real/complex dtypes (float32 / complex64 unless set);
    ``config.device`` is the default device of constructors ('cuda'
    unless set).
    """

    def __init__(self, precision=None):
        self._precision = torch.float32
        self._device = 'cuda'
        if precision is not None:
            self.precision = precision

    @property
    def precision(self):
        """Real-valued working dtype."""
        return self._precision

    @precision.setter
    def precision(self, prec):
        """Accept a bit depth (16/32/64), a real torch dtype, or None to reset."""
        if prec is None:
            self._precision = torch.float32
            return
        if isinstance(prec, numbers.Integral) and not isinstance(prec, bool):
            if int(prec) not in _BY_DEPTH:
                raise ValueError('precision bit depth must be one of 16, 32, 64; '
                                 f'got {prec!r}')
            self._precision = _BY_DEPTH[int(prec)]
            return
        if prec not in _COMPLEX_FOR_REAL:
            raise ValueError(f'precision must be a real floating torch dtype, got {prec!r}')
        self._precision = prec

    @property
    def precision_complex(self):
        """Complex-valued working dtype, paired with precision."""
        return _COMPLEX_FOR_REAL[self._precision]

    @property
    def device(self):
        """Default device of constructors ('cuda' unless set)."""
        return self._device

    @device.setter
    def device(self, dev):
        self._device = 'cuda' if dev is None else str(torch.device(dev))


config = Config()


def resolve_device(device=None):
    """The torch.device a constructor builds on: ``device`` or ``config.device``.

    Raises RuntimeError when that is a CUDA device and no card is present;
    the message says how to ask for the CPU instead.
    """
    dev = torch.device(config.device if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'prysm_tpu_torch builds on CUDA by default and no CUDA device is '
            "available; pass device='cpu' or set "
            "prysm_tpu_torch.config.device = 'cpu' to run on the CPU")
    return dev


def complex_for(dtype):
    """The complex dtype paired with a real dtype (complex dtypes pass through)."""
    if dtype.is_complex:
        return dtype
    return _COMPLEX_FOR_REAL[dtype]
