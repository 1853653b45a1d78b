"""Physics oracles in float32 on the tier's device.

The port's counterpart of ``tests_tpu/test_tpu_physics.py``, test for test:
the same names, parameters, sizes and bars.  The CPU suite proves these
chains match the JAX package in float64; this module proves the float32
execution still meets the 0.1% analytic-oracle tier of the reference's own
physics tests and the float32 bounds of ``tests/test_f32_tier.py``: the Airy
disk, the analytic MTF and its cutoff, the tilt direction, energy
conservation, the defocus sign symmetry, the encircled energy and the Strehl
ratio.

It runs on the device ``PRYSM_TORCH_TIER_DEVICE`` names ('cpu' unless set);
naming 'cuda' where no card is present fails the module at import.
"""
import os

import numpy as np
import pytest
import torch

from prysm_tpu_torch.conf import config
from prysm_tpu_torch.coordinates import make_xy_grid, cart_to_polar
from prysm_tpu_torch.geometry import circle, circle_sdf, antialias
from prysm_tpu_torch.polynomials import zernike_nm, zernike_nm_seq, sum_of_2d_modes
from prysm_tpu_torch.propagation import Wavefront
from prysm_tpu_torch.propagation.fft import pupil_sample_to_psf_sample
from prysm_tpu_torch.psf import airydisk
from prysm_tpu_torch.otf import (
    mtf_from_psf,
    diffraction_limited_mtf,
    encircled_energy,
    analytical_encircled_energy_circular_aperture,
)
from prysm_tpu_torch._richdata import RichData

DEVICE = torch.device(os.environ.get('PRYSM_TORCH_TIER_DEVICE', 'cpu'))
if DEVICE.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('PRYSM_TORCH_TIER_DEVICE names a CUDA device and none is available')

PRECISION = 1e-3  # the reference's ~0.1% analytic-oracle tier

TEST_PARAMETERS = [
    (10.0, 1.000, 0.5),
    (10.0, 1.000, 1.0),
    (3.00, 1.125, 3.0)]


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


def _grid(N, diameter):
    x, y = make_xy_grid(N, diameter=diameter, dtype=torch.float32, device=DEVICE)
    r, t = cart_to_polar(x, y)
    return x, y, r, t


def _host(a):
    return a.double().cpu().numpy() if torch.is_tensor(a) else np.asarray(a, np.float64)


@pytest.mark.parametrize('efl, epd, wvl', TEST_PARAMETERS)
def test_diffprop_matches_airydisk_on_chip(efl, epd, wvl):
    fno = efl / epd
    N, Q = 128, 3
    x, y, r, t = _grid(N, epd)
    dx = float(x[0, 1] - x[0, 0])
    amp = circle(epd / 2, r).to(torch.float32)
    scale = float(3 * np.sqrt(amp.numel()) / float(amp.sum()))
    wf = Wavefront.from_amp_and_phase(amp, None, wvl, dx).pad2d(Q=Q)
    wf = wf * scale
    data = wf.focus(efl, Q=1).intensity.data
    psf_dx = pupil_sample_to_psf_sample(dx, N * Q, wvl, efl)
    s = RichData(data, psf_dx, wvl).slices()
    u_, sx = s.x
    _, sy = s.y
    analytic = _host(airydisk(u_.to(torch.float32), fno, wvl))
    assert np.allclose(_host(sx), analytic, atol=PRECISION)
    assert np.allclose(_host(sy), analytic, atol=PRECISION)


@pytest.mark.parametrize('efl, epd, wvl', TEST_PARAMETERS)
def test_diffprop_matches_analytic_mtf_on_chip(efl, epd, wvl):
    fno = efl / epd
    N, Q = 128, 3
    x, y, r, t = _grid(N, epd)
    dx = float(x[0, 1] - x[0, 0])
    amp = circle(epd / 2, r).to(torch.float32)
    psf = Wavefront.from_amp_and_phase(amp, None, wvl, dx).focus(efl, Q=Q).intensity
    data = mtf_from_psf(psf.data, psf.dx).data
    psf_dx = pupil_sample_to_psf_sample(dx, N * Q, wvl, efl)
    df = 1000 / (N * Q * psf_dx)
    s = RichData(data, df, None).slices()
    u_, sx = s.x
    _, sy = s.y
    analytic = _host(diffraction_limited_mtf(fno, wvl, frequencies=u_))
    assert np.allclose(analytic, _host(sx), atol=PRECISION)
    assert np.allclose(analytic, _host(sy), atol=PRECISION)


def test_tilt_moves_psf_plus_y_on_chip():
    N, Q = 128, 3
    x, y, r, t = _grid(N, 2.1)
    dx = float(x[0, 1] - x[0, 0])
    amp = circle(1, r).to(torch.float32)
    wf = Wavefront.from_amp_and_phase(amp, 1000 * y, 0.5, dx)
    data = _host(wf.focus(1, Q=Q).intensity.data)
    idx_y, idx_x = np.unravel_index(data.argmax(), data.shape)
    assert idx_x == (N * Q) // 2
    assert idx_y > (N * Q) // 2


@pytest.mark.parametrize('Q', [2, 3, 4])
def test_focus_energy_conservation_on_chip(Q, pupil256):
    *_, amp, dx = pupil256
    wf = Wavefront.from_amp_and_phase(amp, None, 0.55, dx)
    E_pupil = torch.sum(torch.abs(wf.data) ** 2)
    E_psf = torch.sum(wf.focus(10.0, Q=Q).intensity.data)
    # f32 Parseval over 256^2*Q^2 terms: 1e-4 relative
    assert float(E_psf) == pytest.approx(float(E_pupil), rel=1e-4)


def test_defocus_sign_symmetry_on_chip(pupil256):
    _, _, r, t, amp, dx = pupil256
    z20 = zernike_nm(2, 0, r, t)

    def psf(opd):
        wf = Wavefront.from_amp_and_phase(amp, opd, 0.55, dx)
        return _host(wf.focus(10.0, Q=2).intensity.data)

    I_plus = psf(50.0 * z20)
    I_minus = psf(-50.0 * z20)
    assert np.abs(I_plus - I_minus).max() / I_plus.max() < 1e-5


def test_mtf_cutoff_frequency_on_chip():
    N, efl, epd, wvl = 256, 100.0, 25.0, 0.55
    Q = 2
    x, y, r, t = _grid(N, epd * 1.1)
    dx = epd * 1.1 / N
    amp = antialias(circle_sdf(epd / 2, r), dx)
    psf = Wavefront.from_amp_and_phase(amp, None, wvl, dx).focus(efl, Q=Q).intensity
    vals2d = _host(mtf_from_psf(psf.data, psf.dx).data)
    psf_dx = pupil_sample_to_psf_sample(dx, N * Q, wvl, efl)
    df = 1000 / (N * Q * psf_dx)            # cy/mm per sample
    fno = efl / epd
    cutoff_cy_um = 1.0 / (wvl * fno)
    c = vals2d.shape[0] // 2
    freqs = (np.arange(vals2d.shape[1]) - c) * df / 1000.0  # cy/um
    vals = vals2d[c]
    beyond = vals[freqs > cutoff_cy_um * 1.05]
    assert beyond.size and np.abs(beyond).max() < 1e-3


def test_encircled_energy_matches_analytic_on_chip():
    N, efl, epd, wvl = 256, 10.0, 1.0, 0.5
    Q = 3
    fno = efl / epd
    x, y, r, t = _grid(N, epd * 1.1)
    dx = epd * 1.1 / N
    amp = antialias(circle_sdf(epd / 2, r), dx)
    I_dev = Wavefront.from_amp_and_phase(amp, None, wvl, dx).focus(efl, Q=Q).intensity.data
    pdx = pupil_sample_to_psf_sample(dx, N * Q, wvl, efl)
    pts = np.asarray([4.0, 8.0])

    def ee(radius):
        return float(encircled_energy(I_dev, pdx, radius))

    numeric = np.asarray([ee(p) for p in pts])
    total = ee(60.0)
    analytic = _host(analytical_encircled_energy_circular_aperture(fno, wvl, pts))
    np.testing.assert_allclose(numeric / total, analytic, rtol=2e-2)


def test_psf_peak_strehl_with_aberration_on_chip(pupil256):
    """50 nm rms of balanced spherical drops the peak by the Marechal
    estimate exp(-(2 pi W / wvl)^2) within 10% relative, at f32."""
    _, _, r, t, amp, dx = pupil256
    wvl = 0.55
    rms_nm = 50.0
    modes = zernike_nm_seq([(4, 0)], r, t)
    opd = sum_of_2d_modes(modes, torch.tensor([rms_nm], dtype=torch.float32, device=DEVICE))
    wf0 = Wavefront.from_amp_and_phase(amp, None, wvl, dx)
    wf1 = Wavefront.from_amp_and_phase(amp, opd, wvl, dx)
    I0 = torch.max(wf0.focus(10.0, Q=2).intensity.data)
    I1 = torch.max(wf1.focus(10.0, Q=2).intensity.data)
    strehl = float(I1) / float(I0)
    marechal = float(np.exp(-(2 * np.pi * rms_nm * 1e-3 / wvl) ** 2))
    assert strehl == pytest.approx(marechal, rel=0.1)
