"""nccl_ms: device ms per step of NCCL's kernels on rank 0 (torch.profiler; names that
hold 'nccl'), waiting for the slowest rank included."""
from benchmark.harness.readers import device_ms_per_call


def read(run):
    return device_ms_per_call(run, ('nccl',))
