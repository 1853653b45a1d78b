"""Closed-form oracles for the remaining subsystems in float32 on the tier's device.

The port's counterpart of ``tests_tpu/test_tpu_misc.py``, test for test: the
same names, sizes and bars.  Thin films (quarter-wave AR, Brewster), Zernike
orthonormality, the detector's bindown / tile adjoint inner product,
interferogram statistics against host numpy in float64, the coordinate
transforms, Jacobi polynomials against SciPy and the degradation transfer
functions: each against an oracle that owes nothing to the library's math.

It runs on the device ``PRYSM_TORCH_TIER_DEVICE`` names ('cpu' unless set);
naming 'cuda' where no card is present fails the module at import.
"""
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


def test_quarter_wave_ar_coating_reflectance_on_chip():
    """Single quarter-wave layer: R = ((n0 ns - n1^2)/(n0 ns + n1^2))^2."""
    from prysm_tpu_torch.thinfilm import multilayer_stack_rt
    n0, n1, ns, wvl = 1.0, 1.38, 1.52, 0.55
    t_qw = wvl / (4 * n1)
    r, _ = multilayer_stack_rt(_f32([n1]), _f32([t_qw]), wvl, 's', ns, aoi=0.0)
    got = float(torch.abs(r) ** 2)
    R_exact = ((n0 * ns - n1 ** 2) / (n0 * ns + n1 ** 2)) ** 2
    assert got == pytest.approx(R_exact, abs=1e-5)


def test_brewster_angle_kills_rp_on_chip():
    """p-pol reflectance vanishes at arctan(n1/n0) for a bare interface.

    Modeled as a vanishing film on the substrate (the characteristic matrix
    of a zero-thickness layer is the identity).
    """
    from prysm_tpu_torch.thinfilm import multilayer_stack_rt, brewsters_angle
    n0, ns = 1.0, 1.5
    theta_b = float(np.degrees(np.arctan2(ns, n0)))
    idx, th = _f32([1.3]), _f32([0.0])
    r_p, _ = multilayer_stack_rt(idx, th, 0.55, 'p', ns, aoi=theta_b)
    r_s, _ = multilayer_stack_rt(idx, th, 0.55, 's', ns, aoi=theta_b)
    assert float(torch.abs(r_p)) < 1e-5
    assert float(torch.abs(r_s)) > 0.1
    # and the library's own brewsters_angle agrees with arctan(ns/n0)
    assert float(brewsters_angle(n0, ns)) == pytest.approx(theta_b, abs=1e-4)


def test_zernike_orthonormality_on_chip():
    """Unit-rms Zernikes: <Zi Zj> over the disk == delta_ij to O(1/N)."""
    from prysm_tpu_torch.coordinates import make_xy_grid, cart_to_polar
    from prysm_tpu_torch.polynomials import zernike_nm_seq

    N = 512
    x, y = make_xy_grid(N, diameter=2.0, dtype=torch.float32, device=DEVICE)
    nms = [(1, 1), (2, 0), (2, 2), (3, -1), (4, 0)]
    r, t = cart_to_polar(x, y)
    modes = zernike_nm_seq(nms, r, t)
    inside = (r <= 1.0).to(modes.dtype)
    npx = torch.sum(inside)
    flat = (modes * inside).reshape(len(nms), -1)
    G = (flat @ flat.T / npx).double().cpu().numpy()
    # pixel-quadrature error at 512^2 over the disk is ~1e-2 on the diagonal
    # (edge pixels), much smaller off-diagonal
    np.testing.assert_allclose(G, np.eye(len(nms)), atol=2e-2)


def test_bindown_tile_adjoint_vdot_on_chip():
    """<bindown_sum(x), y> == <x, tile_avg(y)> (plain repetition) at f32."""
    from prysm_tpu_torch.detector import bindown, tile
    rng = np.random.default_rng(0)
    x = _f32(rng.random((256, 256)).astype(np.float32))
    y = _f32(rng.random((64, 64)).astype(np.float32))
    lhs = torch.sum(bindown(x, 4, mode='sum') * y)
    rhs = torch.sum(x * tile(y, 4, scaling='avg'))
    assert float(lhs) == pytest.approx(float(rhs), rel=1e-5)


def test_interferogram_stats_match_host_numpy_on_chip():
    """pv/rms/Sa computed on the device agree with host f64 numpy."""
    from prysm_tpu_torch.util import pv, rms, Sa
    rng = np.random.default_rng(11)
    z = rng.normal(scale=30.0, size=(128, 128))
    zd = _f32(z)
    assert float(pv(zd)) == pytest.approx(z.max() - z.min(), rel=1e-5)
    assert float(rms(zd)) == pytest.approx(np.sqrt(np.mean(z * z)), rel=1e-4)
    zc = z - z.mean()
    assert float(Sa(zd)) == pytest.approx(np.mean(np.abs(zc)), rel=1e-4)


def test_cart_polar_roundtrip_on_chip():
    from prysm_tpu_torch.coordinates import make_xy_grid, cart_to_polar, polar_to_cart
    x, y = make_xy_grid(128, diameter=2.0, dtype=torch.float32, device=DEVICE)
    r, t = cart_to_polar(x, y)
    x2, y2 = polar_to_cart(r, t)
    assert float(torch.max(torch.abs(x2 - x))) < 1e-5
    assert float(torch.max(torch.abs(y2 - y))) < 1e-5


def test_jacobi_values_match_scipy_on_chip():
    """jacobi(n, a, b) at f32 against SciPy's f64 evaluation (host oracle)."""
    import scipy.special as sps
    from prysm_tpu_torch.polynomials import jacobi

    xs = np.linspace(-1, 1, 257)
    xd = _f32(xs)
    for n, (a, b) in [(3, (0.0, 0.0)), (5, (1.0, 2.0)), (8, (0.0, 4.0))]:
        mine = jacobi(n, a, b, xd).double().cpu().numpy()
        oracle = sps.eval_jacobi(n, a, b, xs)
        scale = np.abs(oracle).max()
        assert np.abs(mine - oracle).max() / scale < 1e-5, (n, a, b)


def test_smear_jitter_transfer_functions_on_chip():
    """Degradation TFs at DC are exactly 1; jitter follows the Gaussian."""
    from prysm_tpu_torch.degradations import smear_ft, jitter_ft
    fx = np.linspace(-0.5, 0.5, 65).astype(np.float32)
    fxx, fyy = np.meshgrid(fx, fx)
    fxd, fyd = _f32(fxx), _f32(fyy)
    fr = torch.hypot(fxd, fyd)
    sm = smear_ft(fxd, fyd, 1.0, 0.0).double().cpu().numpy()
    jt = jitter_ft(fr, 2.0).double().cpu().numpy()
    c = 32
    assert sm[c, c] == pytest.approx(1.0, abs=1e-6)
    assert jt[c, c] == pytest.approx(1.0, abs=1e-6)
    f = float(fx[-1])
    expect = np.exp(-2 * (np.pi * 2.0 * f) ** 2)
    assert jt[c, -1] == pytest.approx(expect, rel=1e-3)
