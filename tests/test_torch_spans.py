"""The port's spans (``prysm_tpu_torch.profiling.span``), the sync counter and the
benchmark's readers of them.

CPU tests: a span off opens no ``record_function`` and records nothing; the
wavefront-control step under ``torch.profiler`` (float64, N = 128, 6 x 6
actuators, fN = 32, the sizes of ``test_torch_wavefront_control.py``)
records its span tree under one root, with autograd's own operations of
the DM's backward inside ``x.dm.render.bwd``; the step's loss and gradients
are bit-identical with spans on and off; on CPU tensors the step stays eager
(no ``steps.wfc.capture`` or ``steps.wfc.replay`` span, the eager body's
results); ``torch.func.grad`` runs through
the render with spans on; a span on another thread takes the caller's open
span as parent, and threads opening spans at once lose none; the
collector's bound, its drop count, ``reset()`` and ``summary()``'s self
times; a backward that misses the stretch's input closes its span; the sync
counter's plumbing, a planted warning standing in for the card; the readers
under ``benchmark/metrics/`` on a synthetic collector.
A card test (marked ``card``; skips without a card): a planted ``.item()``
counts one sync, and the real step's count is what ``syncs_per_step.wfc``
reads.  It imports no JAX, so on the card it runs with
``python -m pytest --noconftest -q tests/test_torch_spans.py``.
"""
import sys
import threading
import warnings
from pathlib import Path

import pytest
import torch

from prysm_tpu_torch import profiling, steps

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import spec  # noqa: E402

N, NACT, FN = 128, 6, 32
STEP = 'steps.wfc.step'
SITES = {STEP, 'steps.wfc.backward', 'ops.zernike.fwd', 'ops.zernike.bwd_coefs',
         'ops.zernike.bwd_all', 'fttools.mdft', 'fttools.mdft.adjoint', 'x.dm.render',
         'x.dm.render.bwd'}
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def empty_collector():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope='module')
def step():
    w = steps.build_wavefront_control(N, nact=NACT, fN=FN, dtype=torch.float64, device='cpu')
    return w, w.dm.actuators, w.pupil.coefs


@pytest.fixture
def card():
    """The card's device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


def _records():
    return list(profiling._COLLECTOR.records)


def _root(rec):
    while rec.parent is not None:
        rec = rec.parent
    return rec


def test_off_span_opens_nothing_and_records_nothing(step, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('a span off opened a profiler range')

    monkeypatch.setattr(profiling, '_record_range', refuse)
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    with profiling.span('off') as s:
        assert s is profiling.span('other')  # the one shared context
    x = torch.ones(3, requires_grad=True)
    y, close = profiling.backward_span('off.bwd', x)
    assert y is x and close(x) is x
    w, a, c = step
    w(a, c)
    assert _records() == [] and profiling.summary() == {'spans': {}, 'roots': {},
                                                        'dropped': 0}


def test_profiled_step_records_its_span_tree(step):
    w, a, c = step
    with torch.profiler.profile(activities=CPU) as prof:
        w(a, c)
    recs = _records()
    by = {r.name: r for r in recs}
    assert len(recs) == len(by) == 8 and set(by) == SITES - {'ops.zernike.bwd_all'}
    root, back = by[STEP], by['steps.wfc.backward']
    assert root.parent is None and back.parent is root
    assert {_root(r) for r in recs} == {root}
    for name in ('ops.zernike.fwd', 'x.dm.render', 'fttools.mdft'):
        assert by[name].parent is root
    for name in ('x.dm.render.bwd', 'ops.zernike.bwd_coefs', 'fttools.mdft.adjoint'):
        assert by[name].parent is back
    events = prof.events()

    def one(name):
        found = [e for e in events if e.name == name]
        assert len(found) == 1, name
        return found[0].time_range

    def inside(r, outer):
        return outer.start <= r.start and r.end <= outer.end

    bwd, backward = one('x.dm.render.bwd'), one('steps.wfc.backward')
    assert inside(bwd, backward) and inside(one('fttools.mdft.adjoint'), backward)
    # the backward of the fold's planned warp (its node and the transpose it calls), and
    # no sorted index_put left in the step's backward
    planned = [e.time_range for e in events if e.name in ('_WarpBackward', '_WarpVJP')]
    puts = [e.time_range for e in events
            if e.name == 'aten::_index_put_impl_' and inside(e.time_range, backward)]
    assert len(planned) == 2 and not puts
    assert all(inside(r, bwd) for r in planned)


def test_spans_leave_the_step_bit_identical(step):
    w, a, c = step
    off = w(a, c)
    with torch.profiler.profile(activities=CPU):
        profiled = w(a, c)
    with profiling.collect():
        collected = w(a, c)
    for on in (profiled, collected):
        assert all(torch.equal(x, y) for x, y in zip(off, on))
    assert profiling.summary()['roots'] == {STEP: 2}


def test_cpu_step_stays_eager_and_opens_no_graph_span(step):
    """On CPU tensors the step never captures or replays a CUDA graph: the calls that on
    the card would warm up, capture and replay open neither graph span and give the
    eager body's results bit for bit."""
    w, a, c = step
    eager = w._step(a, c)
    with profiling.collect():
        calls = [w(a, c) for _ in range(3)]
    s = profiling.summary()
    assert s['roots'] == {STEP: 3} and w._graphs == {}
    assert not {'steps.wfc.capture', 'steps.wfc.replay'} & set(s['spans'])
    assert all(equal for out in calls for equal in map(torch.equal, out, eager))


def test_func_grad_through_the_render_with_spans_on(step):
    w, a, _ = step
    render = w.dm.render_fn(wfe=True)

    def loss(x):
        return (render(x) ** 2).sum()

    off = torch.func.grad(loss)(a)
    with profiling.collect():
        on = torch.func.grad(loss)(a)
    assert torch.equal(on, off)
    spans = profiling.summary()['spans']
    assert spans['x.dm.render']['count'] == 1 and spans['x.dm.render.bwd']['count'] == 1


def test_a_span_on_another_thread_takes_the_callers_open_span():
    seen = []

    def work():
        with profiling.span('worker') as s:
            seen.append(s.record)

    with profiling.collect():
        with profiling.span('caller') as caller:
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=10)
        assert not t.is_alive()
        with profiling.span('alone') as alone:
            pass
    worker, = seen
    assert worker.parent is caller.record and worker.thread != caller.record.thread
    assert alone.record.parent is None


def test_threads_opening_spans_at_once_lose_no_record():
    """Threads open and close nested spans with the interpreter switching threads often:
    every record is kept and closed, each inner span's parent is its own thread's outer
    span, and no stack is left open."""
    threads, loops = 4, 50
    shown = warnings.showwarning
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)

    def work():
        for _ in range(loops):
            with profiling.span('outer'):
                with profiling.span('inner'):
                    pass

    try:
        with profiling.collect():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in pool)
    recs = _records()
    assert len(recs) == 2 * threads * loops and profiling._COLLECTOR.stacks == {}
    inner = [r for r in recs if r.name == 'inner']
    assert all(r.parent.name == 'outer' and r.parent.thread == r.thread for r in inner)
    assert all(r.end_ns >= r.start_ns for r in recs)
    assert profiling._COLLECTOR.counting is None and warnings.showwarning is shown


def test_a_backward_that_misses_the_stretchs_input_closes_its_span():
    """A gradient taken through the stretch's output but not back to its input opens the
    backward span and never reaches the edge that closes it: the span closes at the end
    of that backward, inside its root, and the next span is a root again."""
    a, c = torch.ones(3, requires_grad=True), torch.ones(3, requires_grad=True)
    with profiling.collect():
        with profiling.span('root') as root:
            x, wrap = profiling.backward_span('stretch.bwd', a)
            torch.autograd.grad(wrap(x * c).sum(), c)
        assert profiling._COLLECTOR.stacks == {}
        with profiling.span('next') as nxt:
            pass
    assert nxt.record.parent is None
    stretch, = [r for r in _records() if r.name == 'stretch.bwd']
    assert stretch.parent is root.record and stretch.end_ns <= root.record.end_ns
    s = profiling.summary()
    assert s['roots'] == {'root': 1, 'next': 1} and s['spans']['stretch.bwd']['count'] == 1


def test_reset_forgets_open_spans():
    with profiling.collect():
        opened = profiling.span('open')
        opened.__enter__()
        profiling.reset()
        assert profiling._COLLECTOR.stacks == {}
        opened.__exit__(None, None, None)
        with profiling.span('after') as after:
            pass
    assert after.record.parent is None and profiling._COLLECTOR.counting is None
    assert profiling.summary()['roots'] == {'after': 1}


def test_collector_bound_and_drop_count(monkeypatch):
    monkeypatch.setattr(profiling._COLLECTOR, 'capacity', 3)
    with profiling.collect():
        for _ in range(5):
            with profiling.span('s'):
                pass
    s = profiling.summary()
    assert s['dropped'] == 2 and s['spans']['s']['count'] == 3 and s['roots'] == {'s': 3}
    profiling.reset()
    assert profiling.summary() == {'spans': {}, 'roots': {}, 'dropped': 0}


def test_self_times_add_up_to_the_root(step):
    w, a, c = step
    with profiling.collect():
        w(a, c)
        w(a, c)
    s = profiling.summary()
    spans = s['spans']
    assert s['roots'] == {STEP: 2} and spans[STEP]['count'] == 2
    total_self = sum(v['self_ms'] for v in spans.values())
    assert total_self == pytest.approx(spans[STEP]['host_ms'], rel=1e-9)
    assert all(0 < v['self_ms'] <= v['host_ms'] for v in spans.values())


def test_sync_counter_counts_a_planted_warning():
    with profiling.collect():
        with profiling.span('root'):
            warnings.warn(profiling.SYNC_MESSAGE)
            with profiling.span('inner'):
                warnings.warn(profiling.SYNC_MESSAGE)
                warnings.warn(profiling.SYNC_MESSAGE)
                with pytest.warns(UserWarning, match='something else'):
                    warnings.warn('something else')
        with pytest.warns(UserWarning, match=profiling.SYNC_MESSAGE):
            warnings.warn(profiling.SYNC_MESSAGE)  # outside any root: shown, not counted
    spans = profiling.summary()['spans']
    assert spans['root']['syncs'] == 1 and spans['inner']['syncs'] == 2
    assert profiling._COLLECTOR.counting is None


READERS = ['program_host_ms.wfc', 'autograd_host_ms.wfc', 'dm_host_ms.wfc',
           'zernike_host_us.wfc', 'mdft_host_us.wfc', 'syncs_per_step.wfc',
           'graph_replay_share.wfc']


@pytest.mark.parametrize('name', READERS)
def test_reader_is_none_without_root_spans(name, monkeypatch):
    read = spec.metric_reader(name)
    assert read({}) is None
    with profiling.collect():
        with profiling.span('another.root'):
            pass
    assert read({}) is None
    # a program without spans (the parent of this change) reads nothing, and raises not
    monkeypatch.delattr(profiling, 'summary')
    assert read({}) is None


def _synthetic(collector):
    """Two steps of the control step's tree, host ms chosen by hand; one sync in the first
    step's render; a ``steps.wfc.replay`` span in the second."""
    ms = 1_000_000
    for k in range(2):
        t0 = 100 * k * ms

        def rec(name, parent, a, b, syncs=0):
            r = profiling._Record(name, parent, 1)
            r.start_ns, r.end_ns = t0 + int(a * ms), t0 + int(b * ms)
            r.syncs = syncs
            collector.records.append(r)
            return r

        root = rec(STEP, None, 0, 10)
        rec('ops.zernike.fwd', root, 1, 1.5)
        rec('x.dm.render', root, 1.5, 3, syncs=1 - k)
        rec('fttools.mdft', root, 3, 3.5)
        back = rec('steps.wfc.backward', root, 5, 9)
        rec('x.dm.render.bwd', back, 5, 6)
        rec('ops.zernike.bwd_coefs', back, 6, 6.5)
        rec('fttools.mdft.adjoint', back, 6.5, 7)
        if k:
            rec('steps.wfc.replay', root, 9, 9.5)


EXPECTED = {'program_host_ms.wfc': 10.0, 'autograd_host_ms.wfc': 2.0, 'dm_host_ms.wfc': 2.5,
            'zernike_host_us.wfc': 1000.0, 'mdft_host_us.wfc': 1000.0,
            'syncs_per_step.wfc': 0.5, 'graph_replay_share.wfc': 0.5}


@pytest.mark.parametrize('name', READERS)
def test_reader_per_step_from_a_synthetic_collector(name, monkeypatch):
    collector = profiling._Collector()
    _synthetic(collector)
    monkeypatch.setattr(profiling, '_COLLECTOR', collector)
    read = spec.metric_reader(name)
    assert read({}) == pytest.approx(EXPECTED[name], rel=1e-12)
    collector.dropped = 1  # a dropped record: the per-step numbers would be short
    assert read({}) is None


@pytest.mark.card
def test_card_counts_a_planted_item_and_the_steps_syncs(card):
    from benchmark.harness.spans import syncs_per_step
    x = torch.ones(4, device=card)
    with profiling.collect():
        with profiling.span('root'):
            with profiling.span('inner'):
                x.sum().item()
    s = profiling.summary()['spans']
    assert s['inner']['syncs'] == 1 and s['root']['syncs'] == 0
    w = steps.build_wavefront_control(N, nact=NACT, fN=FN, device=card)
    a, c = w.dm.actuators, w.pupil.coefs
    w(a, c)
    torch.cuda.synchronize(card)
    profiling.reset()
    with profiling.collect():
        for _ in range(3):
            w(a, c)
    torch.cuda.synchronize(card)
    s = profiling.summary()
    assert s['roots'] == {STEP: 3} and not s['dropped']
    counted = sum(v['syncs'] for v in s['spans'].values())
    assert syncs_per_step(STEP) == counted / 3
