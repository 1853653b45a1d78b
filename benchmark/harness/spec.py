"""Where the benchmark's pieces live, found by the names ``BENCHMARK.json`` gives them.

* a cell (``workloads`` entry) names a configuration and a traffic mix;
* a configuration ``<config>`` is ``configs/<config>.json`` (its numbers, as run),
  ``configs/<config>.py`` (its build module, through the program's API) and
  ``reference/<config>.py`` (its plain reference);
* a traffic mix ``<traffic>`` is ``workloads/<traffic>.json``, parameters that the
  general generator (``harness.traffic``) reads and the entry they drive;
* a metric ``<name>`` is ``metrics/<name>.py``, a reader with ``read(run)``.

A cell reports an end-to-end metric whose ``workloads`` list names it, or
that has no such list; the same for a per-layer metric in a traced run.
"""
import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_json(path):
    """A JSON file as a dict."""
    with open(path) as f:
        return json.load(f)


def load_spec(root=ROOT):
    """``BENCHMARK.json`` of the checkout."""
    return load_json(Path(root) / 'BENCHMARK.json')


def _module(path):
    if not path.is_file():
        raise FileNotFoundError(f'no file {path.relative_to(ROOT)}')
    name = 'benchmark_' + re.sub(r'\W', '_', str(path.relative_to(BENCH).with_suffix('')))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(spec, name):
    """The cell's entry of ``BENCHMARK.json``."""
    for w in spec['workloads']:
        if w['name'] == name:
            return w
    raise KeyError(f'no workload named {name!r} in BENCHMARK.json')


def config(name):
    """(numbers, build module) of a configuration."""
    return load_json(BENCH / 'configs' / f'{name}.json'), _module(BENCH / 'configs' / f'{name}.py')


def traffic(name):
    """A traffic mix's parameters."""
    return load_json(BENCH / 'workloads' / f'{name}.json')


def metric_reader(name):
    """The ``read(run)`` function of a metric."""
    return _module(BENCH / 'metrics' / f'{name}.py').read


def metrics_for(spec, cell, kind):
    """The ``kind`` ('end_to_end' or 'per_layer') metrics that ``cell`` reports."""
    return [m for m in spec[kind] if cell in m.get('workloads', [cell])]
