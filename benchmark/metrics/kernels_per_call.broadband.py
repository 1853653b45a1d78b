"""kernels_per_call.broadband: device operations (kernels, copies, sets) in the traced slice
over the calls in it (torch.profiler; rank 0 in a distributed cell)."""
from benchmark.harness.readers import ops_per_call


def read(run):
    return ops_per_call(run)
