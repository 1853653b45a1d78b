"""The port's profiling and sample_data modules.

profiling: ``time_fn`` (warm-up, samples, and a synchronise of each call's
CUDA outputs, seen through a stand-in), ``report``'s JSON line against the
JAX package's on the same samples, ``trace`` writing a Chrome trace into
``tmp_path``, ``annotate``, ``compiled_stats`` (FLOPs of a matmul) and
``device_memory_stats`` without a card.  sample_data: the environment
override and a local file, with ``urlopen`` made to raise so that no test
reaches the network.
"""
import importlib
import io
import json

import numpy as np
import pytest
import torch

from prysm_tpu import profiling as jprof

from prysm_tpu_torch import profiling


def test_time_fn_counts_calls_and_returns_samples():
    calls = []
    res = profiling.time_fn(lambda a, b=1: calls.append((a, b)) or torch.ones(2), 3, b=4,
                            iters=5, warmup=2)
    assert len(calls) == 7 and calls[0] == (3, 4)
    assert res.samples.shape == (5,) and (res.samples >= 0).all()
    assert res.best <= res.median and res.per_second == 1 / res.median
    assert repr(res).startswith('TimingResult(median=')


def test_time_fn_synchronises_the_outputs_cuda_devices(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda dev=None: synced.append(dev))
    fake = torch.ones(1)
    # the call's result says it lives on card 0
    monkeypatch.setattr(profiling, '_cuda_devices',
                        lambda out, found: {torch.device('cuda', 0)} if out is fake else set())
    profiling.time_fn(lambda: fake, iters=3, warmup=1)
    assert synced == [torch.device('cuda', 0)] * 4


def test_cuda_device_walk_over_nested_results():
    out = {'a': (torch.ones(1), [torch.zeros(2)]), 'b': 3}
    assert profiling._cuda_devices(out, set()) == set()


def test_report_line_matches_the_jax_package():
    samples = np.array([0.0021, 0.0019, 0.0020, 0.0025])
    ours, ref = io.StringIO(), io.StringIO()
    rec = profiling.report('step', profiling.TimingResult(samples), flops=4e9, stream=ours)
    jrec = jprof.report('step', jprof.TimingResult(samples), flops=4e9, stream=ref)
    assert rec == jrec
    assert ours.getvalue() == ref.getvalue()
    assert json.loads(ours.getvalue())['median_ms'] == 2.05
    t = profiling.TimingResult(samples)
    j = jprof.TimingResult(samples)
    assert (t.mean, t.median, t.best, t.std, t.per_second) == \
        (j.mean, j.median, j.best, j.std, j.per_second)


def test_trace_writes_into_logdir(tmp_path):
    with profiling.trace(tmp_path / 'logs'):
        with profiling.annotate('metrology'):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / 'logs').glob('trace_*.json'))
    assert len(files) == 1
    assert 'metrology' in files[0].read_text()


def test_compiled_stats_counts_flops():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    assert profiling.compiled_stats(torch.matmul, a, b) == {'flops': 2.0 * 8 * 16 * 4}


def test_device_memory_stats_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    assert profiling.device_memory_stats() == {}
    assert profiling.device_memory_stats('cpu') == {}


@pytest.fixture
def sample_data(monkeypatch, tmp_path):
    """The port's sample_data, reloaded with its root under tmp_path and urlopen made to raise."""
    monkeypatch.setenv('PRYSM_TPU_SAMPLE_DATA_DIR', str(tmp_path / 'samples'))
    import prysm_tpu_torch.sample_data as sd
    sd = importlib.reload(sd)

    def no_network(*args, **kwargs):
        raise AssertionError('the test reached urlopen')

    monkeypatch.setattr(sd, 'urlopen', no_network)
    yield sd
    monkeypatch.undo()
    importlib.reload(sd)


def test_sample_data_override_and_local_file(sample_data, tmp_path):
    bundled = sample_data.Path(sample_data.__file__).resolve().parent.parent / 'prysm-sampledata'
    if bundled.is_dir():
        pytest.skip('a bundled sample directory takes precedence over the override')
    assert sample_data.root == tmp_path / 'samples'
    local = tmp_path / 'samples' / 'valid_zygo_dat_file.dat'
    local.parent.mkdir()
    local.write_bytes(b'zygo')
    assert sample_data.sample_files('dat') == local.absolute()
    other = tmp_path / 'samples' / 'mine.txt'
    other.write_text('x')
    assert sample_data.sample_files('MINE.TXT') == other
    with pytest.raises(AssertionError, match='urlopen'):
        sample_data.sample_files('absent.bin')
    assert sample_data.fetch_if_not_present(other, 'unused') == other


def test_sample_data_second_variable_and_cache_fallback(monkeypatch, tmp_path):
    import prysm_tpu_torch.sample_data as sd
    monkeypatch.delenv('PRYSM_TPU_SAMPLE_DATA_DIR', raising=False)
    monkeypatch.setenv('PRYSM_SAMPLE_DATA_DIR', str(tmp_path / 'other'))
    if (sd.Path(sd.__file__).resolve().parent.parent / 'prysm-sampledata').is_dir():
        pytest.skip('a bundled sample directory takes precedence over the override')
    assert sd._storage_root() == tmp_path / 'other'
    monkeypatch.delenv('PRYSM_SAMPLE_DATA_DIR')
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))
    assert sd._storage_root() == tmp_path / 'home' / '.cache' / 'prysm' / 'sample-data'
