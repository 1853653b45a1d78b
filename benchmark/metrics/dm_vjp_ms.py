"""dm_vjp_ms: device ms of the cell's DM render (``render_fn(wfe=True)``) and its VJP
for one fixed cotangent, through the public API: 10 calls between two CUDA
events, queued while the card is held back.  Whatever the program puts behind
the fold's gather, this times the same work."""
import torch

from benchmark.harness.readers import time_batch


def read(run):
    probe = run.get('probes', {}).get('dm')
    if probe is None or run['device'].type != 'cuda':
        return None
    dm, actuators = probe
    render = dm.render_fn(wfe=True)
    a = actuators.detach().clone().requires_grad_(True)
    with torch.no_grad():
        cot = torch.ones_like(render(a))

    def vjp():
        with torch.enable_grad():
            torch.autograd.grad(render(a), a, cot)

    return 1e3 * time_batch(vjp, run['device'])
