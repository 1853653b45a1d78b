"""The harness finds every cell's configuration, traffic and metrics by name, and
BENCHMARK.json keeps to the contract's shape."""
import json
import re

import pytest

from benchmark.harness import spec

BENCH = spec.load_spec()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['benchmark']
    assert BENCH['command'] == ['python3', 'benchmark/run.py']
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize('w', BENCH['workloads'], ids=lambda w: w['name'])
def test_cell_files_found(w):
    cfg, mod = spec.config(w['config'])
    traffic = spec.traffic(w['traffic'])
    assert traffic['entry'] in cfg['limits']
    assert callable(mod.build) and callable(mod.judge) and callable(mod.control)
    assert NAME.match(w['name']) and len(w['why']) <= 200
    assert w['chips'] in (1, 4)
    kinds = {k: spec.metrics_for(BENCH, w['name'], k) for k in ('end_to_end', 'per_layer')}
    assert any(m['name'] == 'setup_s' for m in kinds['end_to_end'])
    assert len(kinds['end_to_end']) >= 2 and kinds['per_layer']


@pytest.mark.parametrize('m', BENCH['end_to_end'] + BENCH['per_layer'], ids=lambda m: m['name'])
def test_metric_readers_found(m):
    assert callable(spec.metric_reader(m['name']))
    assert NAME.match(m['name']) and UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    names = {w['name'] for w in BENCH['workloads']}
    assert set(m.get('workloads', names)) <= names


def test_configs_used_and_files_distinct():
    used = {w['config'] for w in BENCH['workloads']}
    assert {c['name'] for c in BENCH['configs']} == used
    files = [c['file'] for c in BENCH['configs']]
    assert len(set(files)) == len(files)
    for c in BENCH['configs']:
        assert spec.load_json(spec.ROOT / c['file'])['reduced'] == c['reduced']


def test_per_layer_moves_and_layers():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e
        moved = e2e[m['moves']].get('workloads')
        assert moved is None or set(m['workloads']) <= set(moved)


def test_four_chip_share():
    four = sum(w['chips'] == 4 for w in BENCH['workloads'])
    assert four <= max(1, len(BENCH['workloads']) // 4)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.workload(BENCH, 'no_such.cell')
    with pytest.raises(FileNotFoundError):
        spec.metric_reader('no_such_metric')
