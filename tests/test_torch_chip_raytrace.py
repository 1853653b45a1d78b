"""Raytracer closed-form oracles in float32 on the tier's device.

The port's counterpart of ``tests_tpu/test_tpu_raytrace.py``, test for test:
the same names, sizes and bars.  Independent oracles with exact analytic
answers: a parabolic mirror focuses collimated light perfectly (and Fermat
makes every OPL equal), a spherical mirror's exact marginal-ray axis crossing
lies R/(2 cos theta) from the center of curvature, and a plane-parallel slab
shifts an oblique ray laterally by the textbook displacement while keeping
it parallel.  Tier bounds follow ``tests/test_f32_tier.py`` (landing
coordinates ~1e-4 mm at f32).

It runs on the device ``PRYSM_TORCH_TIER_DEVICE`` names ('cpu' unless set);
naming 'cuda' where no card is present fails the module at import.
"""
import os

import numpy as np
import pytest
import torch

from prysm_tpu_torch.conf import config
from prysm_tpu_torch.x import raytracing as rt
from prysm_tpu_torch.x import materials as mat
from prysm_tpu_torch.x.raytracing.spencer_and_murty import raytrace

DEVICE = torch.device(os.environ.get('PRYSM_TORCH_TIER_DEVICE', 'cpu'))
if DEVICE.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('PRYSM_TORCH_TIER_DEVICE names a CUDA device and none is available')


@pytest.fixture(autouse=True)
def tier_config(monkeypatch):
    monkeypatch.setattr(config, '_device', str(DEVICE))
    monkeypatch.setattr(config, '_precision', torch.float32)


class NK:
    """Constant-index material."""

    def __init__(self, n):
        self._n = float(n)

    def n(self, wvl, temperature=None):
        return self._n

    def nk(self, wvl, temperature=None):
        return complex(self._n, 0.0)


def _f32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=DEVICE)


def _collimated_bundle(heights, z=0.0):
    n = len(heights)
    P = np.zeros((n, 3))
    P[:, 1] = heights
    P[:, 2] = z
    S = np.tile([0.0, 0.0, 1.0], (n, 1))
    return _f32(P), _f32(S)


def _trace(surfaces, P, S, wvl=0.55):
    """The trace's histories and the status's imaginary part (the failure codes) on the host."""
    res = raytrace(surfaces, P, S, wvl)
    host = [a.double().cpu().numpy() for a in (res.P, res.S, res.OPL)]
    return (*host, torch.imag(res.status).double().cpu().numpy())


def test_parabolic_mirror_focuses_perfectly_on_chip():
    """Collimated rays at every height cross the axis at f = R/2."""
    R = 100.0  # mm of radius; f = 50
    surfaces = [
        rt.Surface(shape=rt.Conic(-1.0 / R, -1.0), interaction='reflect',
                   P=[0, 0, 50.0]),
        rt.Surface(shape=rt.Plane(), interaction='eval', P=[0, 0, 0.0]),
    ]
    heights = np.linspace(-20.0, 20.0, 20)
    P, S = _collimated_bundle(heights)
    P_h, S_h, OPL, st_im = _trace(surfaces, P, S)
    assert (st_im == 0).all(), 'rays died'
    P_img = P_h[-1]
    # the eval plane passes through the focus: all rays land on axis
    assert np.abs(P_img[:, 0]).max() < 1e-4
    assert np.abs(P_img[:, 1]).max() < 1e-4
    # Fermat: the perfect imager gives every ray the same optical path
    opl = OPL.sum(axis=0)
    assert (opl.max() - opl.min()) < 1e-3  # mm


def test_spherical_mirror_exact_aberration_on_chip():
    """Marginal-ray axis crossing matches R/(2 cos th) from the center."""
    R = 100.0
    Z0 = 50.0  # mirror vertex; center of curvature at Z0 - R
    surfaces = [
        rt.Surface(shape=rt.Sphere(-1.0 / R), interaction='reflect',
                   P=[0, 0, Z0]),
        rt.Surface(shape=rt.Plane(), interaction='eval', P=[0, 0, 0.0]),
    ]
    heights = np.asarray([5.0, 10.0, 15.0])
    P, S = _collimated_bundle(heights)
    P_h, S_h, OPL, st_im = _trace(surfaces, P, S)
    assert (st_im == 0).all()
    # extend the reflected ray (point on mirror, outgoing direction) to the
    # axis in f64 on the host
    P_m = P_h[1]
    S_m = S_h[1]
    s_to_axis = -P_m[:, 1] / S_m[:, 1]
    z_cross = P_m[:, 2] + s_to_axis * S_m[:, 2]
    sin_t = heights / R
    cos_t = np.sqrt(1 - sin_t ** 2)
    z_exact = (Z0 - R) + R / (2 * cos_t)
    np.testing.assert_allclose(z_cross, z_exact, atol=5e-4)


def test_plane_parallel_slab_lateral_shift_on_chip():
    """Oblique ray through a glass slab: exit parallel, textbook shift."""
    n_glass, t_slab = 1.5, 10.0
    surfaces = [
        rt.Surface(shape=rt.Plane(), interaction='refract',
                   P=[0, 0, 0.0], material=NK(n_glass)),
        rt.Surface(shape=rt.Plane(), interaction='refract',
                   P=[0, 0, t_slab], material=NK(1.0)),
        rt.Surface(shape=rt.Plane(), interaction='eval', P=[0, 0, 20.0]),
    ]
    theta = np.radians(30.0)
    P = _f32([[0.0, 0.0, -5.0]])
    S = _f32([[0.0, np.sin(theta), np.cos(theta)]])
    P_h, S_h, OPL, st_im = _trace(surfaces, P, S)
    assert (st_im == 0).all()
    S_out = S_h[-1][0]
    np.testing.assert_allclose(S_out, [0.0, np.sin(theta), np.cos(theta)],
                               atol=2e-6)
    sin_tt = np.sin(theta) / n_glass
    cos_tt = np.sqrt(1 - sin_tt ** 2)
    d_exact = t_slab * np.sin(theta) * (1 - np.cos(theta)
                                        / (n_glass * cos_tt))
    P_img = P_h[-1][0]
    y_unshifted = (P_img[2] - (-5.0)) * np.tan(theta)
    # d_exact is perpendicular to the ray; measured along y at fixed z it is
    # d/cos(theta), toward the normal (negative y here)
    shift = P_img[1] - y_unshifted
    assert shift == pytest.approx(-d_exact / np.cos(theta), abs=2e-4)
    # total optical path: 5 mm of air to the slab, t*n/cos(tt) inside the
    # glass, 10 mm of air to the eval plane (convention-free sum)
    total = OPL.sum(axis=0)[0]
    expect = (5.0 / np.cos(theta)
              + t_slab * n_glass / cos_tt
              + 10.0 / np.cos(theta))
    assert total == pytest.approx(expect, abs=5e-4)


def test_doublet_trace_statuses_and_finiteness_on_chip():
    """The bench doublet traces clean at f32."""
    bk7 = mat.model_glass(1.5168, 64.17, name='BK7ish')
    lens = rt.LensData()
    lens.add(rt.Sphere(1 / 62.0), thickness=6.0, material=bk7)
    lens.add(rt.Sphere(-1 / 45.0), thickness=95.0, material=mat.air)
    sys_ = rt.OpticalSystem(lens, aperture=rt.ApertureSpec.epd(18.0),
                            fields=[0.0], wavelengths=[0.55], stop_index=1)
    surfaces = sys_.to_surfaces()
    P, S = rt.launch(sys_, sys_.field(), 0.55, rt.Sampling.hex(6))
    P_h, S_h, OPL, st_im = _trace(surfaces, _f32(P), _f32(S))
    assert (st_im == 0).all()
    P_img = P_h[-1]
    assert np.isfinite(P_img).all()
    # the image plane sits ~45 mm past the ~50 mm focus, so the defocused
    # bundle is centimeters wide; box it at the geometric prediction
    assert np.abs(P_img[:, :2]).max() < 20.0
