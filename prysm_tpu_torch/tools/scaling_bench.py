"""Weak-scaling efficiency of the sharded broadband step over a mesh.

Counterpart of ``tools/scaling_bench.py``: ``parallel.shard_broadband_step``
on 1, 2, 4 and 8 ranks, up to the ranks available, with the problem grown
with the ranks (weak scaling: ``W_per_device`` wavelengths a rank, 0.50 to
0.60 um, on the 'wl' axis of the mesh).  Each world size spawns its own
ranks: NCCL over one card a rank, or gloo on the CPU with ``--cpu`` (where
the ranks share one host's cores and the numbers say little).  ``--ranks R``
caps the world sizes at R.

    python -m prysm_tpu_torch.tools.scaling_bench [N] [W_per_device] [fN] [--cpu] [--ranks R]

A step is timed as the JAX tool times it: 3 rounds of 20 calls after one
warm-up call, each round closed by a synchronisation of the card, the median
round's mean.  Rank 0 prints one JSON row a world size with the JAX tool's
keys (unrounded), then a summary line, which names the card and its power
limit as ``nvidia-smi`` gives them (the JAX tool prints its platform there).
"""
import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..conf import config
from ..coordinates import cart_to_polar, make_xy_grid
from ..examples import card_name
from ..geometry import antialias, circle_sdf
from ..parallel import make_mesh, plan_mdft_spectral, shard_broadband_step
from ..parallel.sharding import broadband_psf
from ..polynomials import zernike_nm_seq
from ._ranks import available, run_ranks

__all__ = ['build_step', 'measure', 'main']

WORLDS = (1, 2, 4, 8)
NMS = ((2, 0), (2, 2), (3, 1), (4, 0))
COEFS = (5.0, -3.0, 2.0, 1.0)
ITERS, ROUNDS = 20, 3


def build_step(mesh, N, W, fN, device=None):
    """(step, coefs): the JAX tool's problem at W wavelengths, sharded over the
    mesh's 'wl' axis: a ``circle_sdf`` pupil of diameter 2.2 on N^2 samples,
    the four modes of ``NMS``, I_meas at half of ``COEFS``."""
    x, y = make_xy_grid(N, diameter=2.2, device=device)
    dx = float(x[0, 1] - x[0, 0])
    r, t = cart_to_polar(x, y)
    amp = antialias(circle_sdf(1.0, r), dx)
    modes = zernike_nm_seq(NMS, r, t)
    coefs = torch.tensor(COEFS, dtype=amp.dtype, device=amp.device)
    wavelengths = np.linspace(0.5, 0.6, W)
    wl = torch.as_tensor(wavelengths, dtype=amp.dtype, device=amp.device)
    weights = torch.ones(W, dtype=amp.dtype, device=amp.device) / W
    plan = plan_mdft_spectral(dx, (N, N), 0.4, fN, wavelengths, 10.0, device=amp.device)
    with torch.no_grad():
        I_meas = broadband_psf(coefs * 0.5, amp, modes, wl, weights, plan)
    return shard_broadband_step(mesh, plan, amp, modes, wl, weights, I_meas), coefs


def _synchronize(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def measure(world, N, w_per_device, fN, device):
    """One world size's row, less its efficiency, in the process group of the caller."""
    W = w_per_device * world
    step, coefs = build_step(make_mesh({'wl': world, 'ty': 1}), N, W, fN, device)
    step(coefs)
    _synchronize(device)
    samples = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            step(coefs)
        _synchronize(device)
        samples.append((time.perf_counter() - t0) / ITERS)
    sec = statistics.median(samples)
    return {'devices': world, 'wavelengths': W, 'step_ms': sec * 1e3, 'wl_per_s': W / sec}


def _rank(rank, world, device, N, w_per_device, fN):
    return measure(world, N, w_per_device, fN, device)


def main(N=256, w_per_device=2, fN=128, cpu=False, ranks=None):
    """Print a row for each world size and the summary; returns the rows."""
    most = available(cpu) if ranks is None else ranks
    sizes = [d for d in WORLDS if d <= most]
    if not sizes:
        raise RuntimeError('no rank to run: no card is visible (use --cpu for gloo ranks)')
    rows, per_device_1 = [], None
    for d in sizes:
        row = run_ranks(_rank, d, cpu, (N, w_per_device, fN))[0]
        per_device = row['wl_per_s'] / d
        per_device_1 = per_device if per_device_1 is None else per_device_1
        row['weak_scaling_efficiency'] = per_device / per_device_1
        rows.append(row)
        print(json.dumps(row), flush=True)
    where = ({'platform': 'cpu', 'backend': 'gloo',
              'note': 'gloo ranks share one host; the numbers say little'} if cpu
             else {'card': card_name('cuda:0'), 'backend': 'nccl'})
    print(json.dumps({**where, 'N': N, 'fN': fN, 'w_per_device': w_per_device,
                      'dtype': str(config.precision).replace('torch.', ''), 'rows': rows}),
          flush=True)
    return rows


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description='Weak scaling of the sharded broadband step.')
    parser.add_argument('N', type=int, nargs='?', default=256, help='pupil samples a side')
    parser.add_argument('w_per_device', type=int, nargs='?', default=2,
                        help='wavelengths a rank')
    parser.add_argument('fN', type=int, nargs='?', default=128, help='focal samples a side')
    parser.add_argument('--cpu', action='store_true', help='gloo ranks on the CPU')
    parser.add_argument('--ranks', type=int, help='the most ranks (default: every card, or 8)')
    args = parser.parse_args()
    main(args.N, args.w_per_device, args.fN, args.cpu, args.ranks)
