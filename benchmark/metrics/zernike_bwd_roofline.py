"""zernike_bwd_roofline: the least time the card needs for the coefficient gradient of
the cell's Zernike synthesis (harness.roofline) over the device time of one
backward of ``zernike_sum_pallas(..., grads='coefs')`` for a fixed cotangent,
percent.  Device time: the median of 50 backward passes through one retained
graph, each between its own CUDA events, L2 flushed before each."""
import torch

from benchmark.harness.readers import time_each
from benchmark.harness.roofline import roofline_percent, zernike_work


def read(run):
    probe = run.get('probes', {}).get('zernike')
    if probe is None or run['device'].type != 'cuda':
        return None
    from prysm_tpu_torch.ops.zernike import zernike_sum_pallas
    coefs, nms, r, t = probe
    c = coefs.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        out = zernike_sum_pallas(c, nms, r, t, grads='coefs')
    cot = torch.ones_like(out)

    def backward():
        torch.autograd.grad(out, c, cot, retain_graph=True)

    flops, nbytes = zernike_work(nms, r.numel())
    return roofline_percent(flops, nbytes, time_each(backward, run['device']))
