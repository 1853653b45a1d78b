"""The controls on the card: the plain reference, computed one precision below the
configuration's, put in the program's place at the cell's own size, must come out as
not correct; the program beside it must not.  Card tests: they skip without a card.
(``calibrate.py`` reads the same over a dozen seeds to set the limits.)"""
import time

import pytest

from benchmark.harness.execute import execute
from benchmark.harness.result import result_line
from benchmark.tests.cells import CELLS

#: the control's precision of each cell, and the kept calls' spacing that gives a
#: two-second window calls to judge
CONTROLS = {'lowfs_example.loop': ('tf32', 64), 'wfc1024.control': ('bf16', 16),
            'wfc1024.sense': ('bf16', 32), 'broadband1024.step4': ('tf32', 8)}


def _result(cell, device, control=None):
    config, traffic = CELLS[cell]
    prec, every = CONTROLS[cell]
    job = {'config': config, 'traffic': traffic, 'seed': 2**34 + 21, 'seconds': 2.0,
           'trace': False, 't0': time.perf_counter(), 'metrics': [],
           'mix': {'keep_every': every}, 'control': control and prec}
    return result_line([execute(job, device)], False, 1)


@pytest.mark.card
@pytest.mark.parametrize('cell', sorted(CONTROLS))
def test_control_is_not_correct(cell, card):
    out = _result(cell, card, control=True)
    assert out['correct'] is False
    assert any(c['value'] > c['limit'] for c in out['checks'].values())


@pytest.mark.card
@pytest.mark.parametrize('cell', sorted(c for c in CONTROLS if not c.startswith('broadband')))
def test_program_is_correct(cell, card):
    assert _result(cell, card)['correct'] is True
