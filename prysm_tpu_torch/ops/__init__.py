"""Hand-written CUDA kernels for the hot operations, with their plain PyTorch versions.

* :mod:`~prysm_tpu_torch.ops.zernike` — fused Zernike mode synthesis and
  its two backwards (``csrc/zernike.cu``), wired into
  ``polynomials.zernike_sum``;
* :mod:`~prysm_tpu_torch.ops.noise` — the fused detector exposure
  (``csrc/noise.cu``), reached through ``Detector.expose(method='fused')``.

CUDA tensors launch the kernels; CPU tensors take the plain versions.
Kernels are built from ``csrc/`` at first use (``ops._cuda``).
"""
from .zernike import zernike_sum_pallas  # NOQA
from .noise import expose_pallas  # NOQA
