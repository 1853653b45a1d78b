"""The wavefront-control step as a CUDA graph (``steps._WavefrontControl``), on the card.

Every test is marked ``card`` and skips without a card.  Sizes: the small
step of ``test_torch_spans.py`` (N = 128, 6 x 6 actuators, fN = 32) in
float32 on the fused kernels and in float64 through the mode stack
(``fused=False``), and the benchmark cell's (N = 1024, 50 x 50, fN = 256).
The first call with an input signature runs eager, the second captures and
replays, later ones replay; the tests hold the replays to the eager step:

* over 8 control steps driven as the benchmark's control cell drives them
  (a new actuator tensor each step, ``a - gain * ga``; the coefficient
  tensor rewritten in place), each step's loss and gradients equal bit for
  bit what a fresh instance's first (eager) call gives at the same inputs;
* a step's returned gradients stay as they were through three later
  replays, and the caller's input tensors are left as they came in;
* a second signature on the same step (float64 coefficients into the
  float32 step) warms up, captures and replays on its own, each call equal
  to the eager step, and the first signature's graph still replays equal;
* under ``profiling.collect()`` a replayed step records its root span and
  one ``steps.wfc.replay`` span and nothing else, ``steps.wfc.capture`` is
  recorded once per signature, and no span counts a sync.

It imports no JAX, so on the card it runs with
``python -m pytest --noconftest -q tests/test_torch_wfc_graph.py``.
"""
import pytest
import torch

from prysm_tpu_torch import profiling, steps

pytestmark = pytest.mark.card

STEP, REPLAY, CAPTURE = 'steps.wfc.step', 'steps.wfc.replay', 'steps.wfc.capture'
# (N, nact, fN, dtype, fused)
SIZES = {'small_f32': (128, 6, 32, torch.float32, True),
         'small_f64_modes': (128, 6, 32, torch.float64, False),
         'cell_f32': (1024, 50, 256, torch.float32, True)}
STEPS = 8


@pytest.fixture
def card():
    """The card's device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


@pytest.fixture(autouse=True)
def empty_collector():
    profiling.reset()
    yield
    profiling.reset()


def build(size, device, like=None):
    """The step at ``size``; ``like`` shares its pupil and DM (a fresh instance, whose
    first call is eager, at the cost of its plan and screens)."""
    N, nact, fN, dtype, fused = SIZES[size]
    kw = {} if like is None else {'pupil': like.pupil, 'dm': like.dm}
    return steps.build_wavefront_control(N, nact=nact, fN=fN, fused=fused, dtype=dtype,
                                         device=device, **kw)


def equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


def drive(w, calls):
    """Control steps of ``w`` as the benchmark's control cell takes them: yields (inputs
    of the call, outputs) for each step."""
    a, c0 = w.dm.actuators.clone(), w.pupil.coefs
    c = c0.clone()
    gain = None
    for k in range(calls):
        c.copy_(c0 * (1 + 0.01 * k))  # rewritten in place, as from pinned memory
        out = w(a, c)
        yield (a, c.clone()), out
        ga = out[1]
        if gain is None:
            gain = 0.02 / torch.sqrt(torch.mean(ga * ga))
        a = a - gain * ga  # a new tensor each step


@pytest.mark.parametrize('size', list(SIZES))
def test_replays_equal_the_eager_step(card, size):
    w = build(size, card)
    for k, ((a, c), out) in enumerate(drive(w, STEPS)):
        fresh = build(size, card, like=w)
        want = fresh(a, c)  # a first call: eager
        assert equal(out, want), f'step {k}'
        assert all(torch.isfinite(x).all() for x in out)
    assert [type(g) for g in w._graphs.values()] == [steps._StepGraph]  # graphed


@pytest.mark.parametrize('size', ['small_f32', 'cell_f32'])
def test_returned_gradients_and_inputs_are_left_alone(card, size):
    w = build(size, card)
    a, c = w.dm.actuators.clone(), w.pupil.coefs.clone()
    a_in, c_in = a.clone(), c.clone()
    for _ in range(3):  # warm-up, capture, a replay
        w(a, c)
    kept = w(a, c)
    held = [x.clone() for x in kept]
    for k in range(1, 4):
        w(a * (1 + 0.1 * k), c * (1 - 0.1 * k))
    torch.cuda.synchronize(card)
    assert equal(kept, held)
    assert torch.equal(a, a_in) and torch.equal(c, c_in)


def test_a_second_signature_is_graphed_on_its_own(card):
    w = build('small_f32', card)
    a, c32 = w.dm.actuators.clone(), w.pupil.coefs.clone()
    c64 = c32.double()
    for _ in range(3):
        out32 = w(a, c32)
    for k in range(4):  # float64 coefficients: warm-up, capture, two replays
        out64 = w(a, c64)
        assert out64[2].dtype == torch.float64
        assert equal(out64, build('small_f32', card, like=w)(a, c64)), f'call {k}'
    assert len([g for g in w._graphs.values() if g is not None]) == 2
    assert equal(w(a, c32), out32)


def test_spans_of_a_replayed_step(card):
    w = build('small_f32', card)
    a, c = w.dm.actuators, w.pupil.coefs
    w(a, c)  # the warm-up, eager
    torch.cuda.synchronize(card)
    with profiling.collect():
        for _ in range(3):  # capture and replay, then two replays
            w(a, c)
    torch.cuda.synchronize(card)
    s = profiling.summary()
    assert s['roots'] == {STEP: 3} and not s['dropped']
    assert s['spans'][CAPTURE]['count'] == 1 and s['spans'][REPLAY]['count'] == 3
    assert sum(v['syncs'] for v in s['spans'].values()) == 0
    profiling.reset()
    with profiling.collect():
        w(a, c)
    s = profiling.summary()
    assert s['roots'] == {STEP: 1}
    assert {k: v['count'] for k, v in s['spans'].items()} == {STEP: 1, REPLAY: 1}
    assert sum(v['syncs'] for v in s['spans'].values()) == 0
    profiling.reset()
    with profiling.collect():  # another signature: one capture more
        for _ in range(3):
            w(a, c.double())
    s = profiling.summary()
    assert s['spans'][CAPTURE]['count'] == 1 and s['spans'][REPLAY]['count'] == 2
