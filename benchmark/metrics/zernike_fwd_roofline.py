"""zernike_fwd_roofline: the least time the card needs for the cell's Zernike synthesis
(36 modes over the pupil's grid; harness.roofline) over the device time of one
``zernike_sum_pallas`` forward at those inputs, percent.  Device time: the median
of 50 launches, each between its own CUDA events, L2 flushed before each."""
import torch

from benchmark.harness.readers import time_each
from benchmark.harness.roofline import roofline_percent, zernike_work


def read(run):
    probe = run.get('probes', {}).get('zernike')
    if probe is None or run['device'].type != 'cuda':
        return None
    from prysm_tpu_torch.ops.zernike import zernike_sum_pallas
    coefs, nms, r, t = probe

    def forward():
        with torch.no_grad():
            zernike_sum_pallas(coefs, nms, r, t, grads='coefs')

    flops, nbytes = zernike_work(nms, r.numel())
    return roofline_percent(flops, nbytes, time_each(forward, run['device']))
