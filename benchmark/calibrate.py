"""Read the compared numbers of a cell over many seeds, for the program or for its
control, to set the cell's limits (``configs/<config>.json``, ``limits``).

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 [--control tf32|bf16]
                                   [--fault <function of benchmark/tests/faults.py>]
                                   [--seconds 2] [--mix key=value ...]

Each seed runs the cell as a run does (set-up, a window at the cell's load,
the judge) and prints one JSON line: the seed, the calls, the compared
numbers (the worst of each over the judged calls) and the cell's notes on
its window.  ``--control`` puts the plain reference, computed in that
precision, in the program's place, in one process (a distributed cell's
control computes every wavelength on one card); ``--fault`` plants one of
the fault tests' faults in the program; ``--mix`` overrides numbers of the
traffic mix (``keep_every``, so that a short window keeps enough calls).
The program's seeds of a distributed cell run on its ranks, in one process
group.  A limit lies above the program's largest reading and below the
control's smallest (PERF.md gives both for each limit).
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark.harness.result import worst  # noqa: E402


def _line(seed, record, args):
    rows = record['judged']
    names = list(rows[0]) if rows else []
    return {'seed': seed, 'control': args.control, 'fault': args.fault, 'mix': args.mix,
            'calls': record['calls'], 'judged': len(rows),
            'readings': {n: worst(r[n] for r in rows) for n in names},
            'notes': record['notes']}


def _mix(pairs):
    out = {}
    for pair in pairs:
        key, value = pair.split('=', 1)
        out[key] = json.loads(value)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description='Read a cell\'s compared numbers over seeds.')
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True, help='comma-separated seeds')
    p.add_argument('--control', choices=('tf32', 'bf16'))
    p.add_argument('--fault', help='a function of benchmark/tests/faults.py')
    p.add_argument('--seconds', type=float, default=2.0)
    p.add_argument('--mix', nargs='*', default=[], help='traffic numbers, key=value')
    args = p.parse_args(argv)
    import torch
    from benchmark.harness import spec
    from benchmark.harness.execute import execute
    bench = spec.load_spec(ROOT)
    w = spec.workload(bench, args.workload)
    seeds = [int(s) for s in args.seeds.split(',')]
    job = {'config': w['config'], 'traffic': w['traffic'], 'seconds': args.seconds,
           'trace': False, 't0': time.perf_counter(), 'metrics': [], 'control': args.control,
           'mix': _mix(args.mix)}
    _, mod = spec.config(w['config'])
    if args.fault:  # planted once, in this process, before anything is built
        if getattr(mod, 'DISTRIBUTED', False):
            raise SystemExit('--fault plants in this process; a distributed cell runs in others')
        from benchmark.tests import faults
        getattr(faults, args.fault)()
    if getattr(mod, 'DISTRIBUTED', False) and not args.control:
        from benchmark.harness.ranks import run_ranks
        records = run_ranks({**job, 'seeds': seeds}, w['chips'])[0]
    else:
        torch.cuda.set_device(0)
        records = [execute({**job, 'seed': s}, 'cuda:0') for s in seeds]
    for seed, record in zip(seeds, records):
        print(json.dumps(_line(seed, record, args)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
