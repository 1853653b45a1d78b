"""The port's host raytracing layers against the JAX package, bit for bit.

The lens-data editor, OpticalSystem, the paraxial walk, ray generation and
the launch are host numpy on both sides, so their outputs must be equal to
the last bit: cfg6's first-order quantities, its compiled surfaces (poses,
types, indices), and its merged launch bundles at ``hex(8)`` and
``hex(16)``.  JAX runs under x64, the port with ``config.precision = 64``
on the CPU.
"""
import numpy as np
import pytest
import torch

import prysm_tpu.x.materials as jmat
import prysm_tpu.x.raytracing as jrt
from prysm_tpu.x.raytracing.batch import _host_launches as j_host_launches
import prysm_tpu_torch.x.materials as tmat
import prysm_tpu_torch.x.raytracing as trt
from prysm_tpu_torch import steps
from prysm_tpu_torch.conf import config
from prysm_tpu_torch.x.raytracing.batch import _host_launches as t_host_launches

torch.set_num_threads(2)
WVL = 0.55


@pytest.fixture(autouse=True)
def f64_on_cpu(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def cfg6(rt, mat):
    """bench.py's cfg6 system, built by the same calls in either package."""
    bk7 = mat.model_glass(1.5168, 64.17, name='BK7ish')
    sf5 = mat.model_glass(1.6727, 32.2, name='SF5ish')
    lens = rt.LensData()
    lens.add(rt.Sphere(1 / 62.0), thickness=6.0, material=bk7)
    lens.add(rt.Sphere(-1 / 45.0), thickness=3.0, material=sf5)
    lens.add(rt.Sphere(-1 / 128.0), thickness=95.0, material=mat.air)
    return rt.OpticalSystem(lens, aperture=rt.ApertureSpec.epd(20.0),
                            fields=[0.0, 1.0, 2.0], wavelengths=[WVL], stop_index=1)


@pytest.fixture
def systems():
    return cfg6(jrt, jmat), cfg6(trt, tmat)


def test_steps_cfg6_system_is_the_bench_system(systems):
    j, _ = systems
    t = steps.cfg6_system()
    for a, b in zip(j.to_surfaces(), t.to_surfaces()):
        assert a.shape.params == b.shape.params and a.typ == b.typ
        np.testing.assert_array_equal(a.P, b.P)
    assert steps.WVL == WVL


def test_to_surfaces_poses_types_indices(systems):
    j, t = systems
    js, ts = j.to_surfaces(), t.to_surfaces()
    assert len(js) == len(ts) == 5
    for a, b in zip(js, ts):
        assert b.shape.kind == a.shape.kind and b.typ == a.typ
        assert b.shape.params == a.shape.params
        assert isinstance(b.P, np.ndarray) and b.P.dtype == np.asarray(a.P).dtype
        np.testing.assert_array_equal(b.P, np.asarray(a.P))
        assert (a.R is None) == (b.R is None)
        ja, tb = getattr(a, 'material', None), getattr(b, 'material', None)
        assert (ja is None) == (tb is None)
        if ja is not None:
            assert tb.n(WVL) == ja.n(WVL)
    assert [s.shape.kind for s in ts] == ['plane', 'sphere', 'sphere', 'sphere', 'plane']


@pytest.mark.parametrize('what', ['efl', 'bfl', 'ffl', 'ep_z', 'image_distance', 'matrix'])
def test_cfg6_first_order_bit_equal(systems, what):
    j, t = systems
    js, ts = j.to_surfaces(), t.to_surfaces()
    fn = {'efl': lambda m, s: m.effective_focal_length(s, wvl=WVL),
          'bfl': lambda m, s: m.back_focal_length(s, wvl=WVL),
          'ffl': lambda m, s: m.front_focal_length(s, wvl=WVL),
          'ep_z': lambda m, s: m.entrance_pupil_z(s, wvl=WVL, stop_index=1),
          'image_distance': lambda m, s: m.paraxial_image_distance(s, wvl=WVL),
          'matrix': lambda m, s: m.system_matrix(s, wvl=WVL)[0]}[what]
    np.testing.assert_array_equal(fn(trt, ts), fn(jrt, js))


def test_cfg6_system_quantities_bit_equal(systems):
    j, t = systems
    assert t.entrance_pupil_diameter() == j.entrance_pupil_diameter() == 20.0
    assert t.entrance_pupil_z() == j.entrance_pupil_z()
    jf, tf = j._ynu_first_order(), t._ynu_first_order()
    for name in ('efl', 'bfl', 'ffl', 'ep_z', 'xp_z', 'fno', 'na_image', 'xp_diameter',
                 'stop_diameter', 'paraxial_image_z', 'total_track', 'n_image'):
        assert getattr(tf, name) == getattr(jf, name), name
    assert repr(tf) == repr(jf)
    assert [repr(f) for f in t.fields] == [repr(f) for f in j.fields]
    assert t.object_at_infinity == j.object_at_infinity


@pytest.mark.parametrize('nrings', [8, 16])
def test_cfg6_host_launches_bit_equal(systems, nrings):
    j, t = systems
    PJ, SJ = j_host_launches(j, list(j.fields), WVL, jrt.Sampling.hex(nrings), None)
    PT, ST = t_host_launches(t, list(t.fields), WVL, trt.Sampling.hex(nrings), None)
    assert PT.shape == (3, 1 + 3 * nrings * (nrings + 1), 3)
    np.testing.assert_array_equal(PT, PJ)
    np.testing.assert_array_equal(ST, SJ)


@pytest.mark.parametrize('sampling', [
    ('chief', ()), ('fan', (9,)), ('cross', (7,)), ('rect', (5,)), ('spiral', (3,)),
    ('hex', (4,)), ('points', ([[0.0, 0.0], [0.5, -0.25], [-1.0, 0.3]],))])
def test_launch_patterns_bit_equal(systems, sampling):
    j, t = systems
    kind, args = sampling
    for field in (0, 2):
        PJ, SJ = jrt.launch(j, j.field(field), WVL, getattr(jrt.Sampling, kind)(*args))
        PT, ST = trt.launch(t, t.field(field), WVL, getattr(trt.Sampling, kind)(*args))
        np.testing.assert_array_equal(PT, PJ)
        np.testing.assert_array_equal(ST, SJ)


@pytest.mark.parametrize('gen, args', [
    ('generate_collimated_ray_fan', (9, 5.0)),
    ('generate_collimated_rect_ray_grid', (4, 3.0)),
    ('generate_finite_ray_fan', (7, 0.2)),
    ('generate_collimated_hex_ray_grid', (3, 1.0)),
    ('generate_collimated_radial_spiral_ray_grid', (3, 2.0)),
])
def test_raygen_bit_equal(gen, args):
    PJ, SJ = getattr(jrt, gen)(*args)
    PT, ST = getattr(trt, gen)(*args)
    np.testing.assert_array_equal(PT, np.asarray(PJ))
    np.testing.assert_array_equal(ST, np.asarray(SJ))


def test_raygen_random_takes_a_generator():
    gen = torch.Generator().manual_seed(3)
    P, S = trt.generate_collimated_ray_fan(5, 2.0, distribution='random', key=gen)
    assert P.shape == (5, 3) and np.all(np.abs(P[:, 1]) <= 2.0)
    with pytest.raises(ValueError, match='Generator'):
        trt.generate_collimated_ray_fan(5, 2.0, distribution='random')


def test_folded_lens_poses_bit_equal():
    """A coordinate break and a fold mirror compile to the same poses."""
    def build(rt, mat):
        lens = rt.LensData()
        lens.add(rt.Sphere(1 / 80.0), thickness=5.0, material=mat.model_glass(1.5, 60.0))
        lens.add(rt.Plane(), thickness=20.0, material=mat.air)
        lens.add_coordbreak(decenter=(0.0, 0.5, 0.0), tilt=(0.0, 0.0, 12.0))
        lens.add(rt.Sphere(-1 / 200.0), thickness=-30.0, material=mat.MIRROR)
        return lens.to_surfaces()

    for a, b in zip(build(jrt, jmat), build(trt, tmat)):
        assert b.typ == a.typ
        np.testing.assert_array_equal(b.P, np.asarray(a.P))
        if a.R is None:
            assert b.R is None
        else:
            np.testing.assert_array_equal(b.R, np.asarray(a.R))


def test_lensdata_rotation_keeps_tensor_angles_on_the_tape():
    from prysm_tpu.x.raytracing.lensdata import R_rh as j_R
    from prysm_tpu_torch.x.raytracing.lensdata import R_rh as t_R
    np.testing.assert_array_equal(t_R(3.0, -7.0, 11.0), j_R(3.0, -7.0, 11.0))
    a = torch.tensor(11.0, dtype=torch.float64, requires_grad=True)
    R = t_R(3.0, -7.0, a)
    np.testing.assert_allclose(R.detach().numpy(), j_R(3.0, -7.0, 11.0), rtol=0, atol=1e-15)
    R[1, 2].backward()
    assert a.grad is not None and float(a.grad) != 0.0


def test_design_state_and_cache_keys(systems):
    j, t = systems
    for s in (j, t):
        s.opt.vary('curvature')
    np.testing.assert_array_equal(t.opt.pack(), j.opt.pack())
    lo_t, hi_t = t.opt.bounds()
    lo_j, hi_j = j.opt.bounds()
    np.testing.assert_array_equal(lo_t, lo_j)
    np.testing.assert_array_equal(hi_t, hi_j)
    x = np.asarray(j.opt.pack()) * 1.01
    j.opt.update(x)
    t.opt.update(x)
    for a, b in zip(j.to_surfaces(), t.to_surfaces()):
        assert a.shape.params == b.shape.params
    from prysm_tpu.x.raytracing._cache import structural_key as jk
    from prysm_tpu_torch.x.raytracing._cache import structural_key as tk
    arg = {'f': t.field(1), 's': trt.Sampling.hex(3), 'w': [0.5, np.arange(3.0)]}
    jarg = {'f': j.field(1), 's': jrt.Sampling.hex(3), 'w': [0.5, np.arange(3.0)]}
    assert tk(arg) == jk(jarg)


def test_spot_statistics_bit_equal():
    rng = np.random.default_rng(5)
    P = rng.normal(size=(64, 3))
    status = np.where(rng.random(64) < 0.1, 3 + 1j, 3 + 0j)
    for name in ('spot_centroid', 'rms_spot_radius'):
        np.testing.assert_array_equal(getattr(trt, name)(P, status),
                                      np.asarray(getattr(jrt, name)(P, status)))
    np.testing.assert_array_equal(trt.rms_spot_radius(torch.as_tensor(P), torch.as_tensor(status)),
                                  jrt.rms_spot_radius(P, status))
    for a, b in zip(trt.geometric_psf_histogram(P, status, bins=8),
                    jrt.geometric_psf_histogram(P, status, bins=8)):
        np.testing.assert_array_equal(a, b)


def test_cfg6_builds_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    """With the default device and no card, the cfg6 entry points raise."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device builds there')
    monkeypatch.setattr(config, '_device', 'cuda')
    for build in (steps.build_cfg6_trace, steps.build_cfg6_grad):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(trt.Sampling.hex(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trt.raytrace(steps.cfg6_system().to_surfaces(), np.zeros((1, 3)),
                     np.asarray([[0.0, 0.0, 1.0]]), WVL)
    trace = steps.build_cfg6_trace(trt.Sampling.hex(2), device='cpu')
    assert trace.P.device.type == 'cpu' and trace().P.shape == (6, 3 * 19, 3)
