"""The hand-written kernels against their plain twins, in float32 on the tier's device.

The port's counterpart of ``tests_tpu/test_tpu_kernels.py``, test for test:
the same names, sizes and bars.  On CUDA the wrappers launch the CUDA kernels
of ``csrc/zernike.cu`` and ``csrc/noise.cu``, and each test asserts that the
kernel's launch count grew, so a card run proves that the kernel, not its
plain version, met the twin's bar.  On the CPU the wrappers run their plain
versions (and launch nothing), which these tests hold to the mode stack and
to the physical noise statistics.

It runs on the device ``PRYSM_TORCH_TIER_DEVICE`` names ('cpu' unless set);
naming 'cuda' where no card is present fails the module at import.
"""
import json
import os
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from prysm_tpu_torch.conf import config
from prysm_tpu_torch.coordinates import make_xy_grid, cart_to_polar
from prysm_tpu_torch.detector import Detector
from prysm_tpu_torch.ops import noise
from prysm_tpu_torch.ops import zernike as zk
from prysm_tpu_torch.polynomials import zernike_nm_seq, sum_of_2d_modes

DEVICE = torch.device(os.environ.get('PRYSM_TORCH_TIER_DEVICE', 'cpu'))
if DEVICE.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('PRYSM_TORCH_TIER_DEVICE names a CUDA device and none is available')

NMS = [(2, 0), (2, 2), (2, -2), (3, 1), (3, -1), (4, 0)]


@pytest.fixture(autouse=True)
def tier_config(monkeypatch):
    monkeypatch.setattr(config, '_device', str(DEVICE))
    monkeypatch.setattr(config, '_precision', torch.float32)


@pytest.fixture(scope='module', autouse=True)
def launch_log():
    """Where PRYSM_TORCH_TIER_LAUNCHES names a file, append the hand-written kernels'
    launch counts to it after the module's tests: the process's since its start, so a run
    of the whole tier (this file after test_torch_chip_grad.py) counts both files'."""
    yield
    path = os.environ.get('PRYSM_TORCH_TIER_LAUNCHES')
    if path:
        with open(path, 'a') as f:
            f.write(json.dumps({**zk.LAUNCHES, **noise.LAUNCHES}) + '\n')


@contextmanager
def launched(counts, names):
    """Assert that the block launched each named kernel of ``counts`` (a wrapper's
    LAUNCHES) on CUDA, and launched nothing on the CPU (the plain versions)."""
    before = dict(counts)
    yield
    for name in names:
        grew = counts[name] - before[name]
        assert grew > 0 if DEVICE.type == 'cuda' else grew == 0, (name, grew)


@pytest.fixture(scope='module')
def polar_grid():
    x, y = make_xy_grid(256, diameter=2.0, dtype=torch.float32, device=DEVICE)
    return cart_to_polar(x, y)


def _coefs():
    return torch.tensor([20.0, -10.0, 8.0, 5.0, -4.0, 3.0], dtype=torch.float32,
                        device=DEVICE)


def test_zernike_sum_pallas_matches_jnp_on_chip(polar_grid):
    r, t = polar_grid
    coefs = _coefs()
    with launched(zk.LAUNCHES, ['zernike_fwd']):
        zp = zk.zernike_sum_pallas(coefs, NMS, r, t)
    zj = sum_of_2d_modes(zernike_nm_seq(NMS, r, t), coefs)
    d = torch.max(torch.abs(zp - zj))
    assert float(d) / float(torch.max(torch.abs(zj))) < 1e-5


def test_zernike_sum_pallas_coef_grad_on_chip(polar_grid):
    r, t = polar_grid
    c = _coefs().requires_grad_(True)
    with launched(zk.LAUNCHES, ['zernike_fwd', 'zernike_bwd_all']):
        gp, = torch.autograd.grad(torch.sum(zk.zernike_sum_pallas(c, NMS, r, t) ** 2), c)
    modes = zernike_nm_seq(NMS, r, t)
    gj, = torch.autograd.grad(torch.sum(sum_of_2d_modes(modes, c) ** 2), c)
    d = torch.max(torch.abs(gp - gj))
    assert float(d) / float(torch.max(torch.abs(gj))) < 1e-4


def test_detector_auto_dispatch_uses_fused_kernel_on_chip():
    """Photon-rich scenes route expose() to the fused noise kernel on the card.

    'auto' takes the kernel for a photon-rich float32 scene on a CUDA tensor;
    a CPU scene takes exact Poisson ('random'), since the kernel runs on the
    card only.
    """
    det = Detector(dark_current=2.0, read_noise=5.0, bias=100.0,
                   fwc=6e4, conversion_gain=0.5, bits=14,
                   exposure_time=1e-2)
    aerial = torch.full((256, 256), 3e5, dtype=torch.float32, device=DEVICE)
    with launched(noise.LAUNCHES, ['noise_expose']):
        out = det.expose(aerial, seed=7)
    assert det.last_expose_path == ('fused' if DEVICE.type == 'cuda' else 'random')
    a = out.double().cpu().numpy()
    assert np.isfinite(a).all()


def test_detector_fused_noise_statistics_on_chip():
    """Fused exposure has the physical mean and variance.

    mean DN ~ (photons + dark)/gain + bias; var of electrons ~ Poisson
    (lambda) + read^2, scaled by 1/gain^2 in DN.
    """
    det = Detector(dark_current=0.0, read_noise=5.0, bias=100.0,
                   fwc=1e9, conversion_gain=1.0, bits=24,
                   exposure_time=1.0)
    lam = 1e4
    aerial = torch.full((512, 512), lam, dtype=torch.float32, device=DEVICE)
    with launched(noise.LAUNCHES, ['noise_expose']):
        out = det.expose_fused(aerial, seed=3)
    a = out.double().cpu().numpy()
    mean, var = a.mean(), a.var()
    expect_mean = lam + 100.0
    expect_var = lam + 5.0 ** 2
    assert mean == pytest.approx(expect_mean, rel=2e-3)
    assert var == pytest.approx(expect_var, rel=5e-2)


def test_detector_fused_matches_random_path_statistics_on_chip():
    """The fused Philox path and torch's random path draw the same distribution."""
    det = Detector(dark_current=1.0, read_noise=3.0, bias=50.0,
                   fwc=1e9, conversion_gain=2.0, bits=24,
                   exposure_time=1.0)
    aerial = torch.full((512, 512), 2e3, dtype=torch.float32, device=DEVICE)
    with launched(noise.LAUNCHES, ['noise_expose']):
        f = det.expose(aerial, seed=5, method='fused').double().cpu().numpy()
    r = det.expose(aerial, seed=5, method='random').double().cpu().numpy()
    assert f.mean() == pytest.approx(r.mean(), rel=1e-3)
    assert f.std() == pytest.approx(r.std(), rel=2e-2)
