"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; the harness builds the cell from
its files, times the window, and judges the kept outputs against the plain
reference.  With ``--trace 0`` the result carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics and the device's busy
time.  The last line of standard output is the result (one JSON object);
the compared numbers and their limits are the last lines of standard error.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / 'benchmark' / '.cache'
# every cache a library could write stays at a fixed path inside the checkout
for var, sub in (('CUDA_CACHE_PATH', 'nv'), ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('TRITON_CACHE_DIR', 'triton')):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(ROOT))

from benchmark.harness.guard import forbidden_modules  # noqa: E402
from benchmark.harness.result import result_line  # noqa: E402

AT_START = forbidden_modules(sys.modules)


def _fail(message, code):
    print(message, file=sys.stderr, flush=True)
    return code


def main(argv=None):
    p = argparse.ArgumentParser(description='Run one benchmark cell once.')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if AT_START:
        print(f'loaded before the harness started (site start-up): {AT_START}',
              file=sys.stderr)

    import torch
    from benchmark.harness import spec
    bench = spec.load_spec(ROOT)
    w = spec.workload(bench, args.workload)
    chips = w['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return _fail(f'{args.workload} needs {chips} CUDA card(s); '
                     f'{torch.cuda.device_count() if torch.cuda.is_available() else 0} seen', 2)
    kind = 'per_layer' if args.trace else 'end_to_end'
    job = {'config': w['config'], 'traffic': w['traffic'], 'seed': args.seed,
           'seconds': args.seconds, 'trace': bool(args.trace), 't0': T0,
           'metrics': [(m['name'], m['unit']) for m in spec.metrics_for(bench, w['name'], kind)]}
    torch.set_num_threads(1)
    _, mod = spec.config(w['config'])
    if getattr(mod, 'DISTRIBUTED', False):
        from benchmark.harness.ranks import run_ranks
        records = run_ranks(job, chips)
    else:
        from benchmark.harness.execute import execute
        torch.cuda.set_device(0)
        records = [execute(job, 'cuda:0')]
        records[0]['forbidden'] = []
    found = sorted(set(forbidden_modules(sys.modules)).union(*(r['forbidden'] for r in records)))
    if found:
        return _fail(f'forbidden modules loaded: {found} (top-level names; at start: '
                     f'{AT_START})', 3)
    out = result_line(records, args.trace, chips)
    print(f'judged {len(records[0]["judged"])} calls in {records[0]["judge_s"]:.3f} s; '
          f'setup {records[0]["setup_s"]:.3f} s; window {records[0]["window_s"]:.3f} s, '
          f'{records[0]["calls"]} calls', file=sys.stderr)
    for name, value in records[0]['notes'].items():
        print(f'note {name} = {value!r}', file=sys.stderr)
    for name, c in out['checks'].items():
        print(f'check {name} = {c["value"]!r} (limit {c["limit"]!r})', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
