"""The mesh patterns of ``parallel`` across several ranks: NCCL over cards, or gloo on the CPU.

Run from the repository root:

    env PYTHONPATH=. python3 probes/mesh_cards_probe.py [RANKS]         # one rank per card
    env PYTHONPATH=. python3 probes/mesh_cards_probe.py [RANKS] --cpu   # gloo, small sizes

RANKS (default 4) processes are spawned, one per card (NCCL over
``tcp://localhost`` at a free port), or on the CPU with gloo over a file
rendezvous.  Each rank builds every pattern of
``steps.build_parallel_patterns`` in float32 and float64: on the cards at
the sizes of ``chip_smoke.py`` phase 3p, but with the Babinet stack's level
count rounded up to a multiple of RANKS (4 at 4 ranks) so that the levels
divide; on the CPU at N=128, fN=32, hex(4) and hex(6) bundles.  Every rank
holds each sharded output against the serial counterpart it computes alone
(a row-sharded output as its block) and rank 0 prints the largest
``max |a - b| / max |b|`` over the ranks with its bar: float32 at the JAX
package's dry-run bars (``__graft_entry__.py``: outputs and losses 1e-4,
gradients 1e-3; several ranks sum in other orders), but the wavefront fit's
at phase 3n's bars for the float32 fit against float64 (coefficients 3.3e-2
of max |c|; the residual RMS, whose float32 value is rounding, 3.1e-5 mm
absolute): reordering the fit's float32 ray sums moves it within its own
float32 floor; float64 at 1e-10 (the residual RMS absolute, 1e-12 mm).
Then each pattern's wall time on rank 0 in float32, sharded and serial in
turns (host clock around a synchronised call, median of 20 after 3
warm-ups, the better of two turns; the raytrace patterns 4), after the
cards' names and power limits.  Exits nonzero if a check fails or a rank
raises.
"""
import datetime
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

BARS32 = {'grad': 1e-3, 'coefs': 3.3e-2, 'rms': 3.1e-5}
BAR32, BAR64 = 1e-4, 1e-10
BARS64 = {'rms': 1e-12}
ABSOLUTE = ('rms',)
RUNS = {'raytrace_fit': 4, 'merged_trace': 4}


def error(key, a, b):
    """max |a - b| / max |b|, or max |a - b| for the outputs held absolutely."""
    wide = torch.complex128 if a.is_complex() or b.is_complex() else torch.float64
    a, b = a.detach().to(wide), b.detach().to(wide)
    diff = float((a - b).abs().max())
    return diff if key in ABSOLUTE else diff / float(b.abs().max())


def bar(key, dtype):
    bars, default = (BARS64, BAR64) if dtype == torch.float64 else (BARS32, BAR32)
    return next((v for word, v in bars.items() if word in key), default)


def build(dev, dtype, ranks, cpu):
    from prysm_tpu_torch import steps
    N, samples, levels = steps.PARALLEL_MR
    steps.PARALLEL_MR = (N, samples, ranks * math.ceil(levels / ranks))
    if cpu:
        steps.CFG6_RINGS, steps.PARALLEL_TRACE_RINGS = 4, 6
        steps.PARALLEL_MR = (64, 24, steps.PARALLEL_MR[2])
        return steps.build_parallel_patterns(dev, dtype, N=128, fN=32)
    return steps.build_parallel_patterns(dev, dtype)


def sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def wall_ms(fn, dev, runs):
    for _ in range(min(runs, 3)):
        fn()
    sync(dev)
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def rank_main(rank, ranks, init, cpu, failures):
    try:
        if cpu:
            torch.set_num_threads(1)
            dev = torch.device('cpu')
        else:
            dev = torch.device('cuda', rank)
            torch.cuda.set_device(dev)
        dist.init_process_group('gloo' if cpu else 'nccl', init_method=init, rank=rank,
                                world_size=ranks, timeout=datetime.timedelta(seconds=600))
        from prysm_tpu_torch import config
        config.device = str(dev)
        lines, ok, built = [], True, {}
        for dtype in (torch.float32, torch.float64):
            built[dtype] = patterns = build(dev, dtype, ranks, cpu)
            for name, pattern in patterns.items():
                got, want = pattern.sharded(), pattern.serial()
                sync(dev)
                for key in want:
                    err = torch.tensor(error(key, got[key], want[key]), dtype=torch.float64,
                                       device=dev)
                    dist.all_reduce(err, op=dist.ReduceOp.MAX)
                    limit = bar(key, dtype)
                    ok &= bool(err <= limit)
                    lines.append(f'  {name} {pattern.axes} {key} {str(dtype)[6:]}: '
                                 f'{float(err):.3e} (bar {limit:g})')
        if rank == 0:
            print('\n'.join(lines), flush=True)
        for name, pattern in built[torch.float32].items():
            runs = RUNS.get(name, 20)
            times = {}
            for _ in range(2):  # in turns: sharded, serial, sharded, serial
                for kind in ('sharded', 'serial'):
                    times.setdefault(kind, []).append(wall_ms(getattr(pattern, kind), dev, runs))
            if rank == 0:
                print(f'  {name} {pattern.axes} f32 wall ms: sharded '
                      f'{min(times["sharded"]):.4f}, serial {min(times["serial"]):.4f}',
                      flush=True)
        if not ok:
            raise AssertionError('a sharded output exceeds its bar (see above)')
    except BaseException:
        failures.put((rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def main():
    args = [a for a in sys.argv[1:] if not a.startswith('--')]
    cpu = '--cpu' in sys.argv
    ranks = int(args[0]) if args else 4
    if not cpu:
        if torch.cuda.device_count() < ranks:
            print(f'needs {ranks} cards, sees {torch.cuda.device_count()}', file=sys.stderr)
            return 1
        smi = subprocess.run(['nvidia-smi', '--query-gpu=index,name,power.limit',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip()
        print(f'cards:\n{smi}\ntorch {torch.__version__}, CUDA {torch.version.cuda}', flush=True)
    ctx = torch.multiprocessing.get_context('spawn')
    failures = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = (f'file://{os.path.join(tmp, "rendezvous")}' if cpu
                else f'tcp://localhost:{free_port()}')
        t0 = time.perf_counter()
        procs = [ctx.Process(target=rank_main, args=(r, ranks, init, cpu, failures))
                 for r in range(ranks)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=1500)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    errors = []
    while not failures.empty():
        errors.append(failures.get())
    for rank, tb in errors:
        print(f'rank {rank} failed:\n{tb}', file=sys.stderr)
    codes = [p.exitcode for p in procs]
    print(f'{ranks} ranks ({"gloo, CPU" if cpu else "NCCL, one card each"}): exit codes {codes}, '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    return 0 if not errors and all(c == 0 for c in codes) else 1


if __name__ == '__main__':
    sys.exit(main())
