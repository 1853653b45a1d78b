"""The port's multi-device tools (``prysm_tpu_torch/tools/``) on gloo ranks of the CPU.

``python -m prysm_tpu_torch.tools.scaling_bench`` and ``... profile_overlap``
run as a user runs them, each in a subprocess of its own session, killed
with its ranks when it outlives its timeout (a hung rank fails the test and
does not stall the suite).  The scaling harness at 1 and 2 ranks prints a
row a world size with the JAX tool's keys, efficiency 1.0 at 1 rank; the
overlap tool at 2 ranks writes each rank's trace and prints its line with
the count keys (null on gloo, which makes no device events).  No timing is
held.  The overlap counting itself is held on a trace written by hand.
"""
import json
import os
import signal
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
ROW_KEYS = {'devices', 'wavelengths', 'step_ms', 'wl_per_s', 'weak_scaling_efficiency'}
COUNT_KEYS = {'device_events', 'all_reduce_kernels', 'overlapping_backward', 'overlapped_ms',
              'all_reduce_ms'}


def _run(*args):
    """The JSON lines a tool prints, run as ``python -m`` from the repository root."""
    env = {**os.environ, 'PYTHONPATH': ROOT}
    proc = subprocess.Popen([sys.executable, '-m', *args], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f'{args[0]} did not end within {TIMEOUT} s')
    assert proc.returncode == 0, err[-4000:]
    return [json.loads(line) for line in out.splitlines() if line.startswith('{')]


def test_scaling_bench_prints_a_row_a_world_size():
    lines = _run('prysm_tpu_torch.tools.scaling_bench', '64', '2', '32', '--cpu',
                 '--ranks', '2')
    rows, summary = lines[:-1], lines[-1]
    assert [set(r) for r in rows] == [ROW_KEYS, ROW_KEYS]
    assert [(r['devices'], r['wavelengths']) for r in rows] == [(1, 2), (2, 4)]
    assert rows[0]['weak_scaling_efficiency'] == 1.0
    assert all(r['step_ms'] > 0 and r['wl_per_s'] > 0 for r in rows)
    assert summary['platform'] == 'cpu' and summary['rows'] == rows
    assert (summary['N'], summary['fN'], summary['w_per_device']) == (64, 32, 2)


def test_profile_overlap_writes_a_trace_a_rank(tmp_path):
    line, = _run('prysm_tpu_torch.tools.profile_overlap', str(tmp_path), '2', '--cpu')
    assert COUNT_KEYS <= set(line)
    assert (line['devices'], line['n_chunks'], line['steps']) == (2, 2, 20)
    assert line['traces'] == [str(tmp_path / f'overlap_rank{r}.json') for r in (0, 1)]
    for path in line['traces']:
        with open(path) as f:
            events = json.load(f)['traceEvents']
        assert any(e.get('name', '').startswith('autograd::engine::evaluate_function')
                   for e in events)
    # gloo makes no device events: the line says so, and counts nothing
    assert line['device_events'] == 0 and line['all_reduce_kernels'] is None
    assert 'no device events' in line['note']


def _event(cat, name, ts, dur, tid=1, **args):
    return {'ph': 'X', 'cat': cat, 'name': name, 'pid': 0, 'tid': tid, 'ts': ts, 'dur': dur,
            'args': args}


def test_overlap_counts_read_streams_and_backward_launches():
    """Two all-reduce kernels on stream 20: the first overlaps a backward kernel
    on stream 7 for 3 us, and a forward kernel besides; the second overlaps
    only a kernel on its own stream."""
    from prysm_tpu_torch.tools.profile_overlap import overlap_counts
    node = 'autograd::engine::evaluate_function: MmBackward0'
    events = [
        _event('cpu_op', node, 100, 50, tid=2),
        _event('cpu_op', node + ' (nested)', 110, 10, tid=2),
        _event('cuda_runtime', 'cudaLaunchKernel', 112, 1, tid=2, correlation=1),  # backward
        _event('cuda_runtime', 'cudaLaunchKernel', 130, 1, tid=2, correlation=2),  # backward
        _event('cuda_runtime', 'cudaLaunchKernel', 90, 1, tid=1, correlation=3),   # forward
        _event('cuda_runtime', 'cudaLaunchKernel', 95, 1, tid=1, correlation=4),   # the reduce
        _event('cuda_runtime', 'cudaLaunchKernel', 96, 1, tid=1, correlation=5),   # the reduce
        _event('cuda_runtime', 'cudaLaunchKernel', 97, 1, tid=1, correlation=6),   # forward
        _event('kernel', 'gemm', 200, 5, stream=7, correlation=1),
        _event('kernel', 'gemm', 300, 5, stream=7, correlation=2),
        _event('kernel', 'elementwise', 198, 20, stream=7, correlation=3),
        _event('kernel', 'ncclDevKernel_AllReduce_Sum_f32_RING_LL', 202, 10, stream=20,
               correlation=4),
        _event('kernel', 'ncclDevKernel_AllReduce_Sum_f32_RING_LL', 400, 10, stream=20,
               correlation=5),
        _event('kernel', 'elementwise', 402, 5, stream=20, correlation=6),
    ]
    counts = overlap_counts(events)
    assert counts['device_events'] == 6
    assert (counts['all_reduce_kernels'], counts['backward_kernels']) == (2, 2)
    assert counts['overlapping_backward'] == 1
    assert counts['overlapped_ms'] == pytest.approx(3e-3)
    assert counts['all_reduce_ms'] == pytest.approx(20e-3)
    assert (counts['all_reduce_streams'], counts['backward_streams']) == ([20], [7])
    assert overlap_counts(events[:8])['all_reduce_kernels'] is None
