"""Times of the DM fold's planned warp (``ops.warp``) at the benchmark cell's size.

Run from the repository root on the card's machine:

    env PYTHONPATH=. python3 probes/warp_probe.py [--N 1024]

At N^2 with the cell's 10-degree fold (``steps.WFC_ROT``), in float32 and
float64: ``warp_bwd_kernel`` cold (a 128 MB buffer written before each
launch, so its inputs come from HBM) and warm, each the median of 25
launches between CUDA events, queued while the card is held back; the
plain version (``warp_bwd_plain``, on the card); autograd's backward of ``coordinates.warp`` at the same cotangent,
the sorted ``index_put`` the kernel took the place of (cold and warm); the
two forwards (``warp_planned`` and ``coordinates.warp``); the plan's build;
the kernel's bytes bound at 3.35 TB/s (each real tap's 4-byte entry, the
cotangent and both fractions of each output sample, one write a source
sample); the plan's size.  One JSON line a dtype, the card's name and power
limit beside it.
"""
import argparse
import json
import statistics
import subprocess
import time

import torch

from prysm_tpu_torch import steps
from prysm_tpu_torch.coordinates import warp
from prysm_tpu_torch.ops import warp as warp_op
from prysm_tpu_torch.x.dm import prepare_fwd_reverse_projection_coordinates

HBM_BYTES_PER_S = 3.35e12
FLUSH_BYTES = 128 << 20
RUNS = 25
# the card is held back this long before each timed call, so that the host has queued
# it whole and the events time the device alone
HOLD_CYCLES = 10_000_000


def _card():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=False).stdout.strip()
    return {'device': torch.cuda.get_device_name(0), 'nvidia_smi': out.splitlines()[0]}


def _ms(fn, cold, flush, runs=RUNS):
    """Median ms of ``fn`` between two CUDA events, after a warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda._sleep(HOLD_CYCLES)
        if cold:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--N', type=int, default=1024)
    n = ap.parse_args().N
    dev = torch.device('cuda', 0)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for dtype in (torch.float32, torch.float64):
        (cols, rows), _ = prepare_fwd_reverse_projection_coordinates((n, n), steps.WFC_ROT,
                                                                     dtype=dtype, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = warp_op.WarpPlan(rows, cols, (n, n))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        gen = torch.Generator(device=dev).manual_seed(0)
        g = torch.randn(plan.out_shape, generator=gen, dtype=dtype, device=dev)
        img = torch.randn(plan.src_shape, generator=gen, dtype=dtype, device=dev)
        leaf = img.clone().requires_grad_(True)
        pulled = warp(leaf, cols, rows)

        def autograd_bwd():
            torch.autograd.grad(pulled, leaf, g, retain_graph=True)

        taps = int((plan.table >= 0).sum())
        item = g.element_size()
        nbytes = 4 * taps + 3 * item * g.numel() + item * img.numel()
        plan_bytes = sum(t.numel() * t.element_size() for t in (
            plan.taps, plan.inside, plan.fr, plan.fc, plan.fr1, plan.fc1, plan.table))
        row = {
            'N': n, 'dtype': str(dtype).removeprefix('torch.'), 'depth': plan.depth,
            'taps': taps, 'plan_MB': plan_bytes / 1e6, 'plan_build_s': build_s,
            'bound_ms': 1e3 * nbytes / HBM_BYTES_PER_S,
            'kernel_cold_ms': _ms(lambda: warp_op.warp_bwd(plan, g), True, flush),
            'kernel_warm_ms': _ms(lambda: warp_op.warp_bwd(plan, g), False, flush),
            'plain_ms': _ms(lambda: warp_op.warp_bwd_plain(plan, g), False, flush, runs=5),
            'autograd_cold_ms': _ms(autograd_bwd, True, flush, runs=10),
            'autograd_warm_ms': _ms(autograd_bwd, False, flush, runs=10),
            'fwd_planned_warm_ms': _ms(lambda: warp_op.warp_fwd(plan, img), False, flush),
            'fwd_lookup_warm_ms': _ms(lambda: warp(img, cols, rows), False, flush),
            **_card(),
        }
        print(json.dumps(row), flush=True)


if __name__ == '__main__':
    main()
