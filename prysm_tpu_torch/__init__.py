"""prysm_tpu_torch: the PyTorch/CUDA port of prysm_tpu.

Module paths and public names mirror ``prysm_tpu``:
``prysm_tpu_torch/propagation/fft.py`` answers to
``prysm_tpu/propagation/fft.py``.  Constructors build on
``config.device`` (CUDA unless set) and raise when no card is present and
the CPU was not asked for; functions on tensors follow their inputs'
device.  The hand-written CUDA kernels live in ``ops/`` and ``csrc/``.
"""
from .conf import config  # NOQA
