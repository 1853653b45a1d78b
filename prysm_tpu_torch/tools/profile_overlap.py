"""A runtime trace of the per-chunk all-reduces of ``parallel.overlap``, and their overlap.

Counterpart of ``tools/profile_overlap.py``.  Each rank runs
``parallel.overlap.overlapped_spectral_grad`` at the JAX tool's sizes (a
128^2 pupil, 2 wavelengths a rank over 0.50-0.60 um, a 64^2 focal grid,
2 chunks, the modes (2, 0), (2, 2), (3, 1)) for 20 steps under
``torch.profiler`` (CPU and CUDA activities) after one warm-up step, and
writes its Chrome trace as ``overlap_rank<r>.json`` in ``trace_dir``.  The
JAX tool's HLO accounting (``overlap_evidence``) has no counterpart: the
trace is the runtime evidence that its docstring points to.

    python -m prysm_tpu_torch.tools.profile_overlap [trace_dir] [ranks] [--cpu]

From the device events of rank 0's trace it counts the NCCL all-reduce
kernels, how many of them overlap in time a compute kernel of the backward
(a kernel launched from inside autograd's ``evaluate_function``) on another
stream, and the milliseconds of all-reduce time so overlapped, and prints
them as one JSON line beside the ranks, the chunks, the streams and the
card's name and power limit.  Gloo ranks on the CPU make no device events;
the line then says so and its counts are null.  A trace that comes back with
no device records (the card's profiler does so at times) is taken again, by
every rank together, up to 3 times.
"""
import argparse
import bisect
import json
import math
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..coordinates import cart_to_polar, make_xy_grid
from ..examples import card_name
from ..geometry import antialias, circle_sdf
from ..mathops import cis
from ..parallel import make_mesh, plan_mdft_spectral
from ..parallel.overlap import overlapped_spectral_grad
from ..polynomials import zernike_nm_seq
from ._ranks import available, run_ranks

__all__ = ['overlap_counts', 'main']

N, W_PER_RANK, FN, N_CHUNKS, STEPS, TRIES = 128, 2, 64, 2, 20, 3
NMS = ((2, 0), (2, 2), (3, 1))
COEFS = (5.0, -3.0, 2.0)
BACKWARD = 'autograd::engine::evaluate_function'


def _backward_spans(events):
    """{thread: (starts, ends)}: the disjoint time spans in which a thread runs
    backward nodes (the CPU ops of ``BACKWARD``, nested ones merged)."""
    spans = {}
    for e in events:
        if e.get('cat') == 'cpu_op' and e.get('name', '').startswith(BACKWARD):
            spans.setdefault((e['pid'], e['tid']), []).append((e['ts'], e['ts'] + e['dur']))
    merged = {}
    for thread, pairs in spans.items():
        starts, ends = merged[thread] = [], []
        for a, b in sorted(pairs):
            if ends and a <= ends[-1]:
                ends[-1] = max(ends[-1], b)
            else:
                starts.append(a)
                ends.append(b)
    return merged


def _inside(spans, launch):
    """Whether a launch (a runtime event) lies inside a backward node on its thread."""
    starts, ends = spans.get((launch['pid'], launch['tid']), ((), ()))
    i = bisect.bisect_right(starts, launch['ts']) - 1
    return i >= 0 and launch['ts'] <= ends[i]


def _stream(e):
    return e.get('args', {}).get('stream', e.get('tid'))


def _union_ms(intervals):
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def overlap_counts(events):
    """The all-reduce overlap counts of a Chrome trace's event list (see the module)."""
    kernels = [e for e in events if e.get('cat') == 'kernel']
    if not kernels:
        return {'device_events': 0, 'all_reduce_kernels': None, 'overlapping_backward': None,
                'overlapped_ms': None, 'all_reduce_ms': None}
    launches = {e['args']['correlation']: e for e in events
                if e.get('cat') == 'cuda_runtime' and 'correlation' in e.get('args', {})}
    spans = _backward_spans(events)

    def is_all_reduce(k):
        name = k['name'].lower().replace('_', '')
        return 'nccl' in name and 'allreduce' in name

    reduces = [k for k in kernels if is_all_reduce(k)]
    backward = [k for k in kernels if 'nccl' not in k['name'].lower()
                and k.get('args', {}).get('correlation') in launches
                and _inside(spans, launches[k['args']['correlation']])]
    overlapping, overlapped = 0, []
    for ar in reduces:
        a0, a1 = ar['ts'], ar['ts'] + ar['dur']
        hits = [(max(a0, k['ts']), min(a1, k['ts'] + k['dur'])) for k in backward
                if _stream(k) != _stream(ar) and k['ts'] < a1 and k['ts'] + k['dur'] > a0]
        overlapping += bool(hits)
        overlapped += hits
    return {'device_events': len(kernels), 'all_reduce_kernels': len(reduces),
            'overlapping_backward': overlapping, 'overlapped_ms': _union_ms(overlapped),
            'all_reduce_ms': sum(k['dur'] for k in reduces) / 1e3,
            'backward_kernels': len(backward),
            'all_reduce_streams': sorted({_stream(k) for k in reduces}),
            'backward_streams': sorted({_stream(k) for k in backward})}


def _inputs(world, device):
    x, y = make_xy_grid(N, diameter=2.2, device=device)
    dx = float(x[0, 1] - x[0, 0])
    r, t = cart_to_polar(x, y)
    amp = antialias(circle_sdf(1.0, r), dx)
    modes = zernike_nm_seq(NMS, r, t)
    W = W_PER_RANK * world
    wavelengths = np.linspace(0.5, 0.6, W)
    wl = torch.as_tensor(wavelengths, dtype=amp.dtype, device=amp.device)
    weights = torch.ones(W, dtype=amp.dtype, device=amp.device) / W
    plan = plan_mdft_spectral(dx, (N, N), 0.4, FN, wavelengths, 10.0, device=amp.device)
    coefs = torch.tensor(COEFS, dtype=amp.dtype, device=amp.device)
    opd = torch.tensordot(coefs * 0.5, modes, dims=([0], [0]))
    E = plan(amp[None] * cis((2 * math.pi / (wl * 1e3))[:, None, None] * opd[None]))
    I_meas = E.real ** 2 + E.imag ** 2
    return plan, amp, modes, wl, weights, I_meas, coefs


def _rank(rank, world, device, trace_dir):
    plan, amp, modes, wl, weights, I_meas, coefs = _inputs(world, device)
    step = overlapped_spectral_grad(make_mesh({'wl': world}), plan, amp, modes, wl, weights,
                                    I_meas, n_chunks=N_CHUNKS)
    cuda = device.type == 'cuda'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    step(coefs)
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(trace_dir, f'overlap_rank{rank}.json')
    for attempt in range(TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(STEPS):
                step(coefs)
            sync()
        prof.export_chrome_trace(path)
        with open(path) as f:
            counts = overlap_counts(json.load(f)['traceEvents'])
        if not cuda:
            break
        # every rank takes the trace again if any rank's came back empty
        found = torch.tensor(int(counts['device_events'] > 0), device=device)
        dist.all_reduce(found, op=dist.ReduceOp.MIN)
        if int(found):
            break
        time.sleep(0.25 * (attempt + 1))
    return {'trace': path, 'tries': attempt + 1, **counts}


def main(trace_dir=None, ranks=None, cpu=False):
    """Trace the overlap step on ``ranks`` ranks; print and return rank 0's line."""
    if trace_dir is None:
        trace_dir = os.path.join(tempfile.gettempdir(), 'prysm_tpu_torch_overlap_trace')
    os.makedirs(trace_dir, exist_ok=True)
    world = available(cpu) if ranks is None else ranks
    if world < 1:
        raise RuntimeError('no rank to run: no card is visible (use --cpu for gloo ranks)')
    out = run_ranks(_rank, world, cpu, (os.path.abspath(trace_dir),))
    line = {'trace_dir': trace_dir, 'devices': world, 'n_chunks': N_CHUNKS, 'steps': STEPS,
            **out[0], 'traces': [o['trace'] for o in out]}
    if cpu:
        line.update(platform='cpu', backend='gloo',
                    note='gloo ranks on the CPU: the trace holds no device events to count')
    else:
        line.update(card=card_name('cuda:0'), backend='nccl')
    print(json.dumps(line), flush=True)
    return line


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description='Trace the per-chunk all-reduces of '
                                                 'parallel.overlap and count their overlap.')
    parser.add_argument('trace_dir', nargs='?', help='where each rank writes its trace')
    parser.add_argument('ranks', type=int, nargs='?', help='ranks (default: every card, or 8)')
    parser.add_argument('--cpu', action='store_true', help='gloo ranks on the CPU')
    args = parser.parse_args()
    main(args.trace_dir, args.ranks, args.cpu)
