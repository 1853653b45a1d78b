"""Runs driven on the CPU at small sizes, past the harness's look for a card, with the
timed path broken underneath: each fault must come out as not correct.  A sound run
beside them reads below every fault on the numbers the fault breaks."""
import time

import pytest

from benchmark.harness.ranks import run_ranks
from benchmark.harness.result import result_line
from benchmark.tests.cells import CELLS

FAULTS = 'benchmark.tests.faults'
SMALL = {
    'lowfs_example.loop': ({'N': 64, 'fN': 16}, {'keep_every': 8, 'warm_calls': 2}),
    'wfc1024.control': ({'N': 128, 'nact': 6, 'fN': 32}, {'keep_every': 2, 'warm_calls': 1}),
    'wfc1024.sense': ({'N': 128, 'nact': 6, 'fN': 32}, {'keep_every': 2, 'warm_calls': 1}),
    'broadband1024.step4': ({'N': 64, 'fN': 16, 'wvl_per_chip': 2, 'mesh': {'wl': 2, 'ty': 1}},
                            {'keep_every': 4, 'pace_calls': 5, 'warm_calls': 1}),
}


def _job(cell, fault=None):
    config, traffic = CELLS[cell]
    sizes, mix = SMALL[cell]
    return {'config': config, 'traffic': traffic, 'seed': 2**35 + 11,
            'seconds': 0.3, 'trace': False, 't0': time.perf_counter(), 'metrics': [],
            'sizes': sizes, 'mix': mix, 'fault': fault and f'{FAULTS}:{fault}'}


def _run(cell, fault=None):
    """The result of one run in fresh processes (a planted fault stays in them)."""
    ranks = SMALL[cell][0].get('mesh', {}).get('wl', 1)
    records = run_ranks(_job(cell, fault), ranks, cpu=True)
    return result_line(records, False, ranks)


CASES = [
    ('lowfs_example.loop', 'lowfs_estimate_altered', 'est_err'),
    ('lowfs_example.loop', 'lowfs_frame_altered', 'frame_err'),
    ('wfc1024.control', 'wfc_state_unchanged', 'act_grad_err'),
    ('wfc1024.control', 'wfc_act_grad_altered', 'act_grad_err'),
    ('wfc1024.control', 'wfc_coef_grad_altered', 'coef_grad_err'),
    ('wfc1024.sense', 'sense_frame_altered', 'frame_err'),
    ('broadband1024.step4', 'broadband_half_batch', 'loss_err'),
    ('broadband1024.step4', 'broadband_no_exchange', 'replica_diff'),
    ('broadband1024.step4', 'broadband_grad_altered', 'grad_err'),
]


@pytest.fixture(scope='module')
def sound():
    return {}


@pytest.mark.parametrize('cell,fault,number', CASES, ids=[c[1] for c in CASES])
def test_fault_is_not_correct(cell, fault, number, sound):
    if cell not in sound:
        sound[cell] = _run(cell)
    out = _run(cell, fault)
    assert out['correct'] is False
    check = out['checks'][number]
    assert check['value'] > check['limit']
    assert check['value'] > 10 * sound[cell]['checks'][number]['value']


NAN_CASES = [('wfc1024.control', 'wfc_coef_grad_nan', 'coef_grad_err'),
             ('wfc1024.sense', 'sense_frame_nan', 'frame_err')]


@pytest.mark.parametrize('cell,fault,number', NAN_CASES, ids=[c[1] for c in NAN_CASES])
def test_nan_is_not_correct(cell, fault, number):
    """A NaN where the program produces its answer fails the check; it never passes."""
    out = _run(cell, fault)
    assert out['correct'] is False and out['failed'] >= 1
    assert out['checks'][number]['value'] == 'nan'
