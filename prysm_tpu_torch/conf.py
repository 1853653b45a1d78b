"""Precision and device configuration.

Counterpart of ``prysm_tpu/conf.py``.  ``config.precision`` /
``config.precision_complex`` are the working real/complex dtype pair, as
torch dtypes; ``config.device`` is where constructors put their tensors.

The default device is CUDA.  When no card is present, a constructor that
was not asked for another device raises: the port never drops to the CPU
on its own.  Functions that take tensors follow the device of their inputs.

Matmul precision: torch's default full-fp32 matmul matches the JAX
package's pinned ``'highest'``.  ``set_matmul_precision`` changes it for
the process; the MDFT plan scopes TF32 around its own matmuls when asked
for ``'high'`` (``fttools.MDFT``) and restores the setting after.
"""
import numbers
from contextlib import contextmanager

import numpy as np
import torch

__all__ = ['config', 'Config', 'resolve_device', 'set_matmul_precision', 'to_tensor',
           'numpy_dtype', 'precision_as', 'device_as']

# the JAX package's matmul modes, as torch's TF32 switch for float32 matmuls
_TF32_FOR_MODE = {'highest': False, 'high': True, 'default': True}


def set_matmul_precision(mode):
    """Set the process-wide float32 matmul precision: 'highest' | 'high' | 'default'.

    The JAX package's modes map onto ``torch.backends.cuda.matmul.allow_tf32``:

    * 'highest' (the port's default): TF32 off, full float32 products;
    * 'high': TF32 on, products of 10-bit mantissas summed in float32;
    * 'default': TF32 on as well.  It is not bf16 on the H100: torch has no
      switch that sends float32 matmuls to bf16 products, so the fastest
      float32 path cuBLAS offers is TF32, which is what 'default' selects.

    It touches float32 (and complex64) matmuls on CUDA tensors only; float64
    and CPU matmuls are exact whatever the mode.
    """
    if mode not in _TF32_FOR_MODE:
        raise ValueError(f"mode must be one of {tuple(_TF32_FOR_MODE)}, got {mode!r}")
    torch.backends.cuda.matmul.allow_tf32 = _TF32_FOR_MODE[mode]

_COMPLEX_FOR_REAL = {
    torch.float16: torch.complex64,
    torch.bfloat16: torch.complex64,
    torch.float32: torch.complex64,
    torch.float64: torch.complex128,
}

_BY_DEPTH = {16: torch.float16, 32: torch.float32, 64: torch.float64}

# host numpy dtype of each working dtype (numpy has no bfloat16: float32 holds it)
_NUMPY_FOR = {
    torch.float16: np.float16,
    torch.bfloat16: np.float32,
    torch.float32: np.float32,
    torch.float64: np.float64,
}


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


def numpy_dtype(dtype=None):
    """The host numpy dtype of a real torch dtype (default ``config.precision``).

    A table, not a round trip through a tensor: host planners call it
    inside ``torch.func`` transforms, where building a tensor fails.
    """
    return np.dtype(_NUMPY_FOR[config.precision if dtype is None else dtype])


@contextmanager
def precision_as(dtype):
    """Run a block with ``config.precision`` set to ``dtype``, restored after."""
    saved = config._precision
    config.precision = dtype
    try:
        yield
    finally:
        config._precision = saved


@contextmanager
def device_as(device):
    """Run a block with ``config.device`` set to ``device``, restored after."""
    saved = config._device
    config.device = device
    try:
        yield
    finally:
        config._device = saved


def complex_for(dtype):
    """The complex dtype paired with a real dtype (complex dtypes pass through)."""
    if dtype.is_complex:
        return dtype
    return _COMPLEX_FOR_REAL[dtype]


def to_tensor(x, device=None):
    """``x`` as a tensor: tensors pass through unchanged (graph and device kept).

    numpy arrays keep a floating or complex dtype; Python numbers and lists
    (and integer or boolean arrays) take ``config.precision``, or
    ``config.precision_complex`` when complex, as the JAX package's
    ``jnp.asarray`` takes its working dtype.  New tensors go to ``device``
    (default ``config.device``, which raises without a card unless it is
    the CPU).
    """
    if torch.is_tensor(x):
        return x
    a = np.asarray(x)
    if a.dtype.kind == 'c':
        dtype = None if isinstance(x, np.ndarray) else config.precision_complex
    elif a.dtype.kind == 'f' and isinstance(x, np.ndarray):
        dtype = None
    else:
        dtype = config.precision
    return torch.as_tensor(a, dtype=dtype, device=resolve_device(device))
