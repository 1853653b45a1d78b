"""The DM fold's planned warp backward (``ops.warp``, ``csrc/warp.cu``) on the card.

Every test is marked ``card`` and skips without a card.  Sizes are the
benchmark cell's: a 1024^2 grid folded 10 degrees (``steps.WFC_ROT``), and
the control step at N = 1024, 50 x 50 actuators, fN = 256 in float32.

* warp_bwd_kernel equals its plain version bit for bit, in float32 and
  float64, and autograd's backward through ``coordinates.warp`` to the
  rounding of a reordered sum; a NaN in the cotangent reaches the same
  source samples as there;
* two runs of the backward, alone and through the DM's render, give the
  same bits;
* the control step launches the kernel once eager and twice at its capture
  (``LAUNCHES['warp_bwd']``), none on a replay, and the replays equal the
  eager step bit for bit;
* a profiled replayed step holds one ``warp_bwd`` kernel and no
  ``indexing_backward_kernel`` or ``DeviceRadixSortOnesweep``.

It imports no JAX, so on the card it runs with
``python -m pytest --noconftest -q tests/test_torch_warp_card.py``.
"""
import pytest
import torch

from prysm_tpu_torch import steps
from prysm_tpu_torch.coordinates import warp
from prysm_tpu_torch.ops import warp as warp_op
from prysm_tpu_torch.x.dm import prepare_fwd_reverse_projection_coordinates

pytestmark = pytest.mark.card

N = 1024
# a reordered sum of at most six products, against its largest term
ROUNDING = {torch.float32: 1e-6, torch.float64: 1e-14}


@pytest.fixture
def card():
    """The card's device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


def fold(device, dtype):
    """(rows, cols, plan) of the cell's 10-degree fold at N^2."""
    (cols, rows), _ = prepare_fwd_reverse_projection_coordinates((N, N), steps.WFC_ROT,
                                                                 dtype=dtype, device=device)
    return rows, cols, warp_op.WarpPlan(rows, cols, (N, N))


def randn(shape, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_kernel_equals_plain_and_autograd(card, dtype):
    rows, cols, plan = fold(card, dtype)
    g = randn(plan.out_shape, dtype, card, 1)
    kernel = warp_op.warp_bwd(plan, g)
    assert torch.equal(kernel, warp_op.warp_bwd_plain(plan, g))
    img = randn(plan.src_shape, dtype, card, 2).requires_grad_(True)
    want, = torch.autograd.grad(warp(img, cols, rows), img, g)
    assert rel(kernel, want) <= ROUNDING[dtype]
    g.view(-1)[[N * N // 2 + N // 2, 3 * N + 7]] = float('nan')
    want, = torch.autograd.grad(warp(img, cols, rows), img, g)
    assert torch.equal(torch.isnan(warp_op.warp_bwd(plan, g)), torch.isnan(want))


def test_two_backward_runs_are_bit_equal(card):
    _, _, plan = fold(card, torch.float32)
    g = randn(plan.out_shape, torch.float32, card, 3)
    assert torch.equal(warp_op.warp_bwd(plan, g), warp_op.warp_bwd(plan, g))
    w = steps.build_wavefront_control(N, device=card)
    a = w.dm.actuators.clone().requires_grad_(True)
    cot = randn((N, N), torch.float32, card, 4)
    first, = torch.autograd.grad(w.render(a), a, cot)
    second, = torch.autograd.grad(w.render(a), a, cot)
    assert torch.equal(first, second)


def test_the_step_launches_once_and_replays_equal_the_eager_step(card):
    w = steps.build_wavefront_control(N, device=card)
    a, c = w.dm.actuators.clone(), w.pupil.coefs.clone()
    launches = []
    for k in range(4):  # eager, capture, two replays
        before = warp_op.LAUNCHES['warp_bwd']
        out = w(a * (1 + 0.1 * k), c)
        launches.append(warp_op.LAUNCHES['warp_bwd'] - before)
        fresh = steps.build_wavefront_control(N, pupil=w.pupil, dm=w.dm, device=card)
        want = fresh(a * (1 + 0.1 * k), c)  # a first call: eager
        assert all(torch.equal(x, y) for x, y in zip(out, want)), f'call {k}'
    assert launches == [1, 2, 0, 0]
    assert [type(g) for g in w._graphs.values()] == [steps._StepGraph]


def test_a_replayed_step_runs_one_warp_kernel_and_no_sort(card):
    w = steps.build_wavefront_control(N, device=card)
    a, c = w.dm.actuators.clone(), w.pupil.coefs.clone()
    for _ in range(3):  # eager, capture, a replay
        w(a, c)
    torch.cuda.synchronize(card)
    names = []
    for _ in range(3):  # the profiler has come back without device records
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            w(a, c)
            torch.cuda.synchronize(card)
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if any('zernike_kernel' in n for n in names):
            break
    assert any('zernike_kernel' in n for n in names), 'no device records in three tries'
    assert sum('warp_bwd_kernel' in n for n in names) == 1
    assert not [n for n in names if 'indexing_backward_kernel' in n
                or 'DeviceRadixSortOnesweep' in n]
