"""The roofline and the traced slice's reduction, on numbers worked out by hand and on
synthetic profiler events, and the result's judgement of the compared numbers."""
import json
import math

import pytest

from benchmark.harness import readers, result, roofline, trace, traffic

NMS36 = [(n, m) for n in range(8) for m in range(-n, n + 1, 2)]


def test_zernike_flops_36_modes():
    # x 3, sin/cos 2, harmonics 7 x 7, Jacobi steps 5 x 12, angular factors 14,
    # modes 4 x 2 + 32 x 3
    assert roofline.zernike_flops_per_pixel(NMS36) == 3 + 2 + 49 + 60 + 14 + 104


def test_zernike_flops_piston_only():
    assert roofline.zernike_flops_per_pixel([(0, 0)]) == 3 + 2 + 0 + 0 + 0 + 2


def test_forward_work_and_bound_at_1024():
    flops, nbytes = roofline.zernike_work(NMS36, 1024 * 1024)
    assert nbytes == 12 * 1024 * 1024 + 4 * 36
    t, by = roofline.least_seconds(flops, nbytes)
    assert by == 'bytes'
    assert t == pytest.approx(nbytes / 3.35e12)
    assert roofline.roofline_percent(flops, nbytes, 2 * t) == pytest.approx(50.0)


def test_flops_bound_when_compute_dominates():
    t, by = roofline.least_seconds(67e12, 1.0)
    assert by == 'flops' and t == pytest.approx(1.0)


def test_union_merges_overlaps():
    total, merged = trace.union([(0, 2), (1, 3), (5, 6), (6, 7)])
    assert total == 5 and merged == [[0, 3], [5, 7]]


def test_summarize_idle_and_gaps():
    # slice 0..100 us; device busy 10..30 and 50..60 (two overlapping ops), 90..110
    device = [(10, 30, 'gemm_a'), (50, 55, 'k1'), (52, 60, 'k2'), (90, 110, 'nccl_x')]
    host = [(0, 100, 'benchmark.slice'), (30, 50, 'aten::mm'), (32, 40, 'cudaLaunchKernel'),
            (60, 90, 'aten::item')]
    s = trace.summarize(device, host, (0, 100), calls=2)
    assert s['window_s'] == pytest.approx(100e-6)
    assert s['busy_s'] == pytest.approx((20 + 10 + 10) * 1e-6)
    assert s['device_ops'] == 4
    assert s['by_name']['nccl_x'] == pytest.approx(10e-6)
    # gaps: 0-10 (no host op: python), 30-50 (middle 40: inside aten::mm only, the
    # launch ended at 40 exactly and is innermost), 60-90 (aten::item)
    assert s['gaps']['aten::item'] == pytest.approx(30e-6)
    assert sum(s['gaps'].values()) == pytest.approx(60e-6)
    run = {'trace': s}
    assert readers.idle_percent(run) == pytest.approx(60.0)
    assert readers.ops_per_call(run) == 2
    assert readers.device_ms_per_call(run, ('gemm',)) == pytest.approx(1e3 * 20e-6 / 2)
    assert readers.device_ms_per_call(run, ('absent',)) is None


def test_readers_untraced_read_nothing():
    assert readers.idle_percent({}) is None
    assert readers.ops_per_call({}) is None


def test_top_keeps_ten_largest():
    d = {str(i): float(i) for i in range(20)}
    t = trace.top(d)
    assert len(t) == 10 and t[0] == ['19', 19.0]


def test_drift_is_seeded_bounded_and_stationary():
    a = traffic.drift(2**40 + 3, traffic.DRIFT, 20000, 3, 1.0, 50, 3.0)
    b = traffic.drift(2**40 + 3, traffic.DRIFT, 20000, 3, 1.0, 50, 3.0)
    c = traffic.drift(2**40 + 4, traffic.DRIFT, 20000, 3, 1.0, 50, 3.0)
    assert (a == b).all() and not (a == c).all()
    assert abs(a).max() <= 3.0
    assert 0.8 < a.std() < 1.2


def test_judge_sample_keeps_ends():
    kept = list(range(0, 1000, 10))
    s = traffic.judge_sample(7, kept, 8)
    assert len(s) == 8 and s[0] == 0 and s[-1] == 990
    assert traffic.judge_sample(7, kept[:3], 8) == kept[:3]


def _record(rows, limits):
    return {'limits': limits, 'judged': rows, 'kind': 'cpu', 'calls': len(rows),
            'memory_peak_bytes': 0, 'metrics': {}}


@pytest.mark.parametrize('bad', [float('nan'), float('inf'), 2e-3])
def test_result_fails_a_row_unless_finite_and_within(bad):
    rows = [{'a': 1e-4, 'b': 0.0}, {'a': bad, 'b': 0.0}, {'a': 2e-4, 'b': 0.0}]
    out = result.result_line([_record(rows, {'a': 1e-3, 'b': 0.0})], False, 1)
    assert out['correct'] is False and out['failed'] == 1
    assert out['checks']['a']['value'] == (bad if math.isfinite(bad) else str(bad))
    json.loads(json.dumps(out, allow_nan=False))


def test_result_passes_finite_rows_within():
    rows = [{'a': 1e-4, 'b': 0.0}, {'a': 1e-3, 'b': 0.0}]
    out = result.result_line([_record(rows, {'a': 1e-3, 'b': 0.0})], False, 1)
    assert out['correct'] is True and out['failed'] == 0
    assert out['checks'] == {'a': {'value': 1e-3, 'limit': 1e-3}, 'b': {'value': 0.0, 'limit': 0.0}}
