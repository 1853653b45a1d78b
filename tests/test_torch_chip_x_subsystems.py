"""x/ subsystem oracles in float32 on the tier's device.

The port's counterpart of ``tests_tpu/test_tpu_x_subsystems.py``, test for
test: the same names, sizes and bars.  Coatings (energy conservation, the
analytic quarter wave, the thickness gradient against finite differences),
the deformable mirror (the render / autograd-transpose inner product), and
polarization (unitarity of rotations and retarders, the half-wave plate).

It runs on the device ``PRYSM_TORCH_TIER_DEVICE`` names ('cpu' unless set);
naming 'cuda' where no card is present fails the module at import.
"""
import math
import os

import numpy as np
import pytest
import torch

from prysm_tpu_torch.conf import config

DEVICE = torch.device(os.environ.get('PRYSM_TORCH_TIER_DEVICE', 'cpu'))
if DEVICE.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('PRYSM_TORCH_TIER_DEVICE names a CUDA device and none is available')


@pytest.fixture(autouse=True)
def tier_config(monkeypatch):
    monkeypatch.setattr(config, '_device', str(DEVICE))
    monkeypatch.setattr(config, '_precision', torch.float32)


def _f32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=DEVICE)


def test_coating_energy_conservation_on_chip():
    """Lossless stack: R + T == 1 across the band, both polarizations."""
    import prysm_tpu_torch.x.coatings as coat
    stack = coat.Stack([1.38, 2.05, 1.38], [0.1, 0.05, 0.1], 1.52)
    wvls = torch.linspace(0.45, 0.65, 9, dtype=torch.float32, device=DEVICE)
    for pol in ('s', 'p'):
        R, T, A = (a.double().cpu().numpy() for a in coat.RTA(stack, wvls, 0.25, pol))
        np.testing.assert_allclose(R + T, 1.0, atol=2e-5)
        assert np.abs(A).max() < 2e-5


def test_coating_quarter_wave_reflectance_on_chip():
    """The x/coatings engine reproduces the single-QW closed form."""
    import prysm_tpu_torch.x.coatings as coat
    n1, ns, wvl = 1.38, 1.52, 0.55
    stack = coat.Stack([n1], [wvl / (4 * n1)], ns)
    r, _ = coat.stack_rt(stack, _f32([wvl]), 0.0, 's')
    R_exact = ((1.0 * ns - n1 ** 2) / (1.0 * ns + n1 ** 2)) ** 2
    assert float(torch.abs(r[0]) ** 2) == pytest.approx(R_exact, abs=1e-5)


def test_coating_thickness_gradient_vs_fd_on_chip():
    """d(R)/d(thickness) by autograd matches central differences at f32."""
    import prysm_tpu_torch.x.coatings as coat
    ns, wvl = 1.52, 0.55

    def R(th):
        stack = coat.Stack([1.38, 2.05], th, ns)
        r, _ = coat.stack_rt(stack, _f32([wvl]), 0.0, 's')
        return torch.abs(r[0]) ** 2

    th0 = _f32([0.10, 0.06]).requires_grad_(True)
    g, = torch.autograd.grad(R(th0), th0)
    g = g.double().cpu().numpy()
    h = 1e-3
    with torch.no_grad():
        for i in range(2):
            tp = th0.detach().double().cpu().numpy()
            tp[i] += h
            tm = th0.detach().double().cpu().numpy()
            tm[i] -= h
            fd = (float(R(_f32(tp))) - float(R(_f32(tm)))) / (2 * h)
            assert fd == pytest.approx(g[i], rel=2e-2), i


def test_dm_render_adjoint_vdot_on_chip():
    """<render(a), y> == <a, render_adjoint(y)> for the DM chain, the adjoint
    being autograd's transpose of the render."""
    from prysm_tpu_torch.x.dm import DM
    rng = np.random.default_rng(4)
    # smooth gaussian influence function on a 16x16 poke grid
    xx, yy = np.meshgrid(*[np.arange(-48, 48)] * 2)
    ifn = np.exp(-(xx ** 2 + yy ** 2) / (2 * 3.0 ** 2)).astype(np.float32)
    dm = DM(_f32(ifn), Nout=96, Nact=8, sep=8)
    a = _f32(rng.normal(size=(8, 8)).astype(np.float32)).requires_grad_(True)
    y = _f32(rng.normal(size=(96, 96)).astype(np.float32))
    render = dm.render_fn(wfe=True)
    lhs = torch.sum(render(a) * y)
    abar, = torch.autograd.grad(lhs, a)
    rhs = torch.sum(a.detach() * abar)
    assert float(lhs.detach()) == pytest.approx(float(rhs), rel=1e-4)


def test_jones_rotation_and_retarder_unitarity_on_chip():
    """Rotations and lossless retarders preserve the Jones norm."""
    from prysm_tpu_torch.x.polarization import (
        jones_rotation_matrix, linear_retarder, linear_pol_vector)
    v = linear_pol_vector(30.0)
    R = jones_rotation_matrix(0.7)
    W = linear_retarder(math.pi / 2, theta=0.4)
    n0 = float(torch.sum(torch.abs(v) ** 2))
    n1 = float(torch.sum(torch.abs(R.to(v.dtype) @ v) ** 2))
    n2 = float(torch.sum(torch.abs(W @ v) ** 2))
    assert n1 == pytest.approx(n0, rel=1e-5)
    assert n2 == pytest.approx(n0, rel=1e-5)


def test_half_wave_plate_flips_polarization_on_chip():
    """HWP at 45 deg maps horizontal to vertical polarization."""
    from prysm_tpu_torch.x.polarization import half_wave_plate, linear_pol_vector
    v = linear_pol_vector(0.0)              # horizontal
    W = half_wave_plate(math.pi / 4)        # fast axis at 45 deg
    o = W @ v
    assert float(torch.abs(o[0])) < 1e-5
    assert float(torch.abs(o[1])) == pytest.approx(1.0, rel=1e-5)
