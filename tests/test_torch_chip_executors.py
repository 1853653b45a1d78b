"""Executor equivalence and adjoint inner products in float32 on the tier's device.

The port's counterpart of ``tests_tpu/test_tpu_executors.py``, test for test:
the same names, parameters, sizes and bars.  The CPU suite proves FFT ==
MDFT == CZT == FFTDFT and <Ax, y> == <x, A*y> in float64; this module
re-proves both in the float32 the card runs, with the tier bounds of
``tests/test_f32_tier.py``.  Inputs are drawn in numpy from fixed seeds.

It runs on the device ``PRYSM_TORCH_TIER_DEVICE`` names ('cpu' unless set);
naming 'cuda' where no card is present fails the module at import.
"""
import os

import numpy as np
import pytest
import torch

from prysm_tpu_torch.conf import config
from prysm_tpu_torch.coordinates import make_xy_grid, cart_to_polar
from prysm_tpu_torch.fttools import crop_center
from prysm_tpu_torch.geometry import circle_sdf, antialias
from prysm_tpu_torch.propagation import prepare_executor
from prysm_tpu_torch.propagation.fft import focus, focus_adjoint, unfocus, unfocus_adjoint
from prysm_tpu_torch.propagation.angular_spectrum import (
    angular_spectrum, angular_spectrum_adjoint)

DEVICE = torch.device(os.environ.get('PRYSM_TORCH_TIER_DEVICE', 'cpu'))
if DEVICE.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('PRYSM_TORCH_TIER_DEVICE names a CUDA device and none is available')

N = 128
DX = 0.015625      # binary-exact so FFTDFT's 1/integer check is exact
WVL, EFL = 0.5, 10.0
FDX = 0.5          # alpha = DX*FDX/(WVL*EFL) = 1/640, exactly


@pytest.fixture(autouse=True)
def tier_config(monkeypatch):
    monkeypatch.setattr(config, '_device', str(DEVICE))
    monkeypatch.setattr(config, '_precision', torch.float32)


@pytest.fixture(scope='module')
def pupil256():
    """(x, y, r, t, amp, dx) for a 256^2 anti-aliased circular pupil."""
    x, y = make_xy_grid(256, diameter=2.2, dtype=torch.float32, device=DEVICE)
    dx = 2.2 / 256
    r, t = cart_to_polar(x, y)
    return x, y, r, t, antialias(circle_sdf(1.0, r), dx), dx


def _rand_complex(shape, seed):
    rng = np.random.default_rng(seed)
    re = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=DEVICE)
    im = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=DEVICE)
    return torch.complex(re, im)


def _vdot_rel(Ax, y, x, Aty):
    """|<Ax, y> - <x, A*y>| / |<Ax, y>|."""
    lhs = torch.sum(Ax * y.conj())
    rhs = torch.sum(x * Aty.conj())
    return float(torch.abs(lhs - rhs) / torch.abs(lhs))


def _plan(*args, **kwargs):
    return prepare_executor(*args, dtype=torch.complex64, device=DEVICE, **kwargs)


@pytest.mark.parametrize('kind', ['mdft', 'czt', 'fftdft'])
def test_executor_matches_fft_on_compatible_grid(kind):
    """Each plan reproduces |FFT focus| on the matched Q=2 grid, up to the
    ortho-vs-optical normalization, at the f32 tier."""
    Q = 2
    fN = N * Q
    fdx = EFL * WVL / (DX * fN)
    plan = _plan(DX, (N, N), fdx, fN, WVL, EFL, kind=kind)
    a = _rand_complex((N, N), 7)
    m1 = torch.abs(focus(a, Q=Q))
    m2 = torch.abs(plan(a))
    scale = torch.max(m1) / torch.max(m2)
    d = torch.max(torch.abs(m1 - m2 * scale))
    # f32 DFT over 128^2 terms: 1e-4 relative tier
    assert float(d) / float(torch.max(m1)) < 1e-4


@pytest.mark.parametrize('kind', ['mdft', 'czt', 'fftdft'])
def test_executor_adjoint_vdot_on_chip(kind):
    """<Ax, y> == <x, A*y> at f32 for each arbitrary-sampling plan."""
    plan = _plan(DX, (N, N), FDX, 96, WVL, EFL, kind=kind)
    x = _rand_complex((N, N), 1)
    y = _rand_complex((96, 96), 2)
    assert _vdot_rel(plan(x), y, x, plan.adjoint(y)) < 1e-4


@pytest.mark.parametrize('op, op_adj, Q', [
    (focus, focus_adjoint, 2),
    (focus, focus_adjoint, 3),
    (unfocus, unfocus_adjoint, 2),
])
def test_fft_focus_adjoint_vdot_on_chip(op, op_adj, Q):
    x = _rand_complex((N, N), 3)
    y = _rand_complex((N * Q, N * Q), 4)
    assert _vdot_rel(op(x, Q), y, x, op_adj(y, Q)) < 1e-4


def test_angular_spectrum_adjoint_vdot_on_chip():
    # Q=2 pads: the operator maps N^2 -> (2N)^2, so y lives on the padded grid
    # and the adjoint carries it back to N^2
    x = _rand_complex((N, N), 5)
    y = _rand_complex((2 * N, 2 * N), 6)
    z = 50.0  # mm
    Ax = angular_spectrum(x, WVL, DX, z, Q=2)
    Aty = angular_spectrum_adjoint(y, WVL, DX, z, Q=2)
    assert _vdot_rel(Ax, y, x, Aty) < 1e-4


def test_angular_spectrum_roundtrip_on_chip(pupil256):
    """Propagating +z then -z recovers the field (unitary TF) at f32."""
    *_, amp, dx = pupil256
    n = amp.shape[0]
    E = torch.complex(amp, torch.zeros_like(amp))
    # Q pads without cropping on the way out: crop the center back
    E2 = angular_spectrum(E, WVL, dx, 25.0, Q=2)
    E3 = crop_center(angular_spectrum(E2, WVL, dx, -25.0, Q=1), (n, n))
    assert float(torch.max(torch.abs(E3 - E))) / float(torch.max(torch.abs(E))) < 1e-3


def test_focus_unfocus_roundtrip_on_chip(pupil256):
    *_, amp, dx = pupil256
    n = amp.shape[0]
    E = torch.complex(amp, torch.zeros_like(amp))
    back = crop_center(unfocus(focus(E, Q=2), Q=1), (n, n))
    assert float(torch.max(torch.abs(back - E))) / float(torch.max(torch.abs(E))) < 1e-5


def test_mdft_matches_czt_and_fftdft_off_unit_cell():
    """The arbitrary-sampling algorithms agree on one (shifted) grid."""
    plans = {k: _plan(DX, (N, N), FDX, 96, WVL, EFL, kind=k, focal_shift=(0.2, 0.2))
             for k in ('mdft', 'czt')}
    a = _rand_complex((N, N), 8)
    F1 = plans['mdft'](a)
    F2 = plans['czt'](a)
    assert float(torch.max(torch.abs(F1 - F2))) / float(torch.max(torch.abs(F1))) < 1e-4
