"""gemm_ms.broadband: device ms per step of the matrix-product kernels on rank 0
(torch.profiler; the kernel names that hold one of PATTERNS, lower-cased): the
spectral MDFT's complex GEMMs and their gradients."""
from benchmark.harness.readers import device_ms_per_call

PATTERNS = ('gemm', 'gemv', 'cutlass', 'xmma')


def read(run):
    return device_ms_per_call(run, PATTERNS)
