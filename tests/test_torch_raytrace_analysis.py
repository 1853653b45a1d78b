"""The port's raytracing analysis cluster against the JAX package's, in float64.

``listings``, ``sample_rx``, ``auto``, ``sensitivity``, ``aberrations``,
``parabasal`` and ``analysis`` (with ``system.analysis.*``,
``system.first_order``, ``system.exit_pupil``, ``batch.device_wavefront_fit``
on an OpticalSystem and the real-aiming continuation ladder), on the same
prescriptions from both packages' ``sample_rx``.  JAX runs under x64, the
port with ``config.precision = 64`` on the CPU.  Host numpy modules
(listings, auto, sensitivity, Seidel sums) are equal or within 1e-13;
traced quantities within 1e-10 of each quantity's largest magnitude
(the chief-ray probes, the parabasal tangents, the fits); the lens-analysis
step (``steps.build_lens_analysis``) at ``Sampling.hex(6)`` and a 128^2
pupil against the same composition of JAX functions within 1e-9.  The JAX
package's side of the slow comparisons is read from its record
(``_jax_refs``) where it is current.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _jax_refs import jax_ref
import prysm_tpu.x.materials as jmat
import prysm_tpu.x.raytracing as jrt
from prysm_tpu.x.raytracing import adjoint as ja
from prysm_tpu.x.raytracing import auto as jauto
from prysm_tpu.x.raytracing import sample_rx as jsr
from prysm_tpu.x.raytracing import sensitivity as jsens
from prysm_tpu.x.raytracing.batch import device_wavefront_fit as j_device_fit

import prysm_tpu_torch.x.materials as tmat
import prysm_tpu_torch.x.raytracing as trt
from prysm_tpu_torch import steps
from prysm_tpu_torch.conf import config
from prysm_tpu_torch.x.raytracing import auto as tauto
from prysm_tpu_torch.x.raytracing import sample_rx as tsr
from prysm_tpu_torch.x.raytracing import sensitivity as tsens

torch.set_num_threads(2)
WVL = 0.55
BAR = 1e-10
PRESCRIPTIONS = ('doublet', 'doublet_conic', 'fold_mirror', 'decentered_singlet', 'fisheye')


@pytest.fixture(autouse=True)
def f64_on_cpu(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _host(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a, dtype=float)


def _rel(a, b):
    a, b = _host(a), np.asarray(b, dtype=float)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.nanmax(np.abs(b)) if b.size else 1.0
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    return float(np.nanmax(np.abs(a - b)) / (scale if scale > 0 else 1.0)) if b.size else 0.0


def doublet(rt, sr, fields=(0.0, 3.0), wavelengths=(WVL,)):
    return rt.OpticalSystem(sr.doublet(), aperture=rt.ApertureSpec.epd(10.0),
                            fields=list(fields), wavelengths=list(wavelengths), stop_index=2)


def decentered(rt, sr):
    return rt.OpticalSystem(sr.decentered_singlet(), aperture=rt.ApertureSpec.epd(8.0),
                            fields=[0.0, 2.0], wavelengths=[WVL], stop_index=1)


# ---------- sample_rx and listings ------------------------------------------

@pytest.mark.parametrize('name', PRESCRIPTIONS)
def test_sample_prescriptions_compile_alike(name):
    js, ts = getattr(jsr, name)().to_surfaces(), getattr(tsr, name)().to_surfaces()
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        assert (a.shape.kind, a.typ, a.shape.params) == (b.shape.kind, b.typ, b.shape.params)
        np.testing.assert_array_equal(np.asarray(b.P), np.asarray(a.P))
        assert (a.R is None) == (b.R is None)
        if a.R is not None:
            np.testing.assert_array_equal(np.asarray(b.R), np.asarray(a.R))
        if a.material is not None and hasattr(a.material, 'n'):
            assert b.material.n(WVL) == a.material.n(WVL)


def test_fisheye_system_solves_alike():
    j, t = jsr.fisheye_system(), tsr.fisheye_system()
    assert t.stop_index == j.stop_index == tsr.FISHEYE_STOP_INDEX
    np.testing.assert_array_equal(np.asarray(t.to_surfaces()[-1].P),
                                  np.asarray(j.to_surfaces()[-1].P))
    assert t.entrance_pupil_diameter(t.wavelength()) == j.entrance_pupil_diameter(j.wavelength())


@pytest.mark.parametrize('table', ['list_surfaces', 'list_apertures', 'list_decenters'])
@pytest.mark.parametrize('name', ('doublet', 'fold_mirror', 'decentered_singlet'))
def test_listings_text_is_the_jax_packages(name, table):
    j, t = getattr(jsr, name)(), getattr(tsr, name)()
    assert repr(getattr(t, table)()) == repr(getattr(j, table)())


def test_surface_table_with_stop_and_unit():
    j, t = jsr.doublet(), tsr.doublet()
    assert (repr(trt.surface_table(t, stop_index=2, unit='mm'))
            == repr(jrt.surface_table(j, stop_index=2, unit='mm')))
    from prysm_tpu.x.raytracing.listings import material_str as jm
    from prysm_tpu_torch.x.raytracing.listings import material_str as tm
    assert tm(tmat.MIRROR, 'refr') == jm(jmat.MIRROR, 'refr') == 'MIRROR'
    assert tm(tsr.N_BK7, 'refr') == jm(jsr.N_BK7, 'refr') == 'N-BK7'


# ---------- auto and sensitivity (host numpy) --------------------------------

RC_CASES = (dict(efl=1000.0, bfl=200.0, separation=300.0),
            dict(efl=2000.0, primary_focal_length=-500.0, bfl=300.0),
            dict(efl=1500.0, primary_to_focus=100.0, secondary_radius=-800.0))


@pytest.mark.parametrize('case', range(len(RC_CASES)))
def test_ritchey_chretien_matches_jax(case):
    kw = RC_CASES[case]
    j, t = jauto.RitcheyChretien(**kw), tauto.RitcheyChretien(**kw)
    assert repr(t) == repr(j)
    assert t.unresolved == j.unresolved and t.degrees_of_freedom == j.degrees_of_freedom
    js, ts = j.solutions, t.solutions
    assert len(ts) == len(js) > 0
    for a, b in zip(ts, js):
        assert dataclasses.astuple(a.prescription()) == dataclasses.astuple(b.prescription())
    lens_j, lens_t = js[0].to_lensdata(), ts[0].to_lensdata()
    assert repr(lens_t.list_surfaces()) == repr(lens_j.list_surfaces())


def test_ritchey_chretien_rejects_alike():
    for m in (jauto, tauto):
        with pytest.raises(ValueError, match='inconsistent'):
            m.RitcheyChretien(efl=1000.0, bfl=200.0, separation=300.0,
                              secondary_magnification=2.0)


def test_fd_jacobian_matches_jax():
    def f(x):
        return float(np.sin(x[0]) * x[1] ** 2 + np.exp(0.1 * x[2]))

    x = np.array([0.3, -1.2, 2.0])
    np.testing.assert_array_equal(tsens.fd_jacobian(f, x, mask=[True, False, True]),
                                  jsens.fd_jacobian(f, x, mask=[True, False, True]))

    class Dofs:
        def __init__(self):
            self.x = x.copy()

        def pack(self):
            return self.x.copy()

        def update(self, v):
            self.x = np.asarray(v, dtype=float).copy()

    dj, dt = Dofs(), Dofs()
    np.testing.assert_array_equal(tsens.merit_jacobian_free(dt, lambda: f(dt.x)),
                                  jsens.merit_jacobian_free(dj, lambda: f(dj.x)))
    np.testing.assert_array_equal(dt.x, x)


# ---------- Seidel sums ------------------------------------------------------

@pytest.fixture(scope='module')
def jax_seidel():
    return jrt.seidel_aberrations(doublet(jrt, jsr, wavelengths=(0.4861327, WVL, 0.6562725)))


def test_seidel_sums_match_jax(jax_seidel):
    t = trt.seidel_aberrations(doublet(trt, tsr, wavelengths=(0.4861327, WVL, 0.6562725)))
    j = jax_seidel
    for name in ('SI', 'SII', 'SIII', 'SIV', 'SV', 'CI', 'CII'):
        assert _rel(getattr(t, name), getattr(j, name)) <= 1e-13
    assert t.sums.keys() == j.sums.keys()
    for k in j.sums:
        assert t.sums[k] == pytest.approx(j.sums[k], rel=1e-13, abs=1e-18)
    for a, b in ((t.wavefront_coefficients(), j.wavefront_coefficients()),
                 (t.transverse_aberrations(image_slope=-0.07),
                  j.transverse_aberrations(image_slope=-0.07))):
        for k in b:
            assert a[k] == pytest.approx(b[k], rel=1e-12, abs=1e-18)
    assert repr(t) == repr(j)


def test_paraxial_trace_matches_jax():
    j = jrt.paraxial_trace(doublet(jrt, jsr).to_surfaces(), 2.0, 0.01, WVL, 1.0)
    t = trt.paraxial_trace(doublet(trt, tsr).to_surfaces(), 2.0, 0.01, WVL, 1.0)
    for name in ('y', 'u_in', 'u_out', 'n_in', 'n_out', 'c'):
        assert _rel(getattr(t, name), getattr(j, name)) <= 1e-14


# ---------- parabasal first order --------------------------------------------

_PAIRS = ('efl', 'bfl', 'ffl', 'paraxial_image_distance', 'paraxial_image_z', 'fno',
          'na_image', 'ep_z', 'xp_z', 'ep_distance', 'xp_distance', 'stop_diameter',
          'ep_diameter', 'xp_diameter')


def _same_report(t, j):
    assert t.backend == j.backend
    for name in _PAIRS:
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if b is not None:
            assert _rel(np.asarray(a, dtype=float), np.asarray(b, dtype=float)) <= BAR, name
    if j.abcd is not None:
        assert _rel(t.abcd, j.abcd) <= BAR


@pytest.mark.parametrize('field', [0, 1])
@pytest.mark.parametrize('force_sym', [False, True])
def test_first_order_doublet_matches_jax(field, force_sym):
    j = doublet(jrt, jsr).first_order(field=field, force_sym=force_sym)
    t = doublet(trt, tsr).first_order(field=field, force_sym=force_sym)
    _same_report(t, j)
    assert t.backend == 'parabasal'
    assert repr(t) == repr(j) or force_sym is False


@pytest.mark.parametrize('field', [1, (0.0, 1.5)])
def test_first_order_decentered_singlet_matches_jax(field):
    j = jrt.first_order(decentered(jrt, jsr), field=field)
    t = trt.first_order(decentered(trt, tsr), field=field)
    _same_report(t, j)
    assert t.efl[0] != t.efl[1]


def test_first_order_on_axis_is_the_paraxial_walk():
    system = doublet(trt, tsr)
    fo, ynu = system.first_order(field=0), system._ynu_first_order()
    for name in ('efl', 'bfl', 'ep_z', 'xp_z'):
        assert np.asarray(getattr(fo, name)) == pytest.approx(getattr(ynu, name), rel=1e-9)


def test_parabasal_foci_match_jax():
    for field in (0, 1):
        j = jrt.parabasal_foci(doublet(jrt, jsr), field, WVL)
        t = trt.parabasal_foci(doublet(trt, tsr), field, WVL)
        assert _rel(np.asarray(t), np.asarray(j)) <= BAR


# ---------- exit pupil and wavefront -------------------------------------------

def test_resolve_exit_pupil_paraxial_route():
    j, jm = jrt.resolve_exit_pupil(doublet(jrt, jsr), WVL, return_mode=True)
    t, tm = trt.resolve_exit_pupil(doublet(trt, tsr), WVL, return_mode=True)
    assert tm == jm == 'paraxial'
    np.testing.assert_array_equal(t, np.asarray(j))
    np.testing.assert_array_equal(doublet(trt, tsr).exit_pupil(WVL), np.asarray(j))


def test_resolve_exit_pupil_geometric_route():
    """No stop: the chief's closest approach to the axis, traced."""
    def system(rt, sr):
        return rt.OpticalSystem(sr.doublet(), aperture=rt.ApertureSpec.epd(10.0),
                                fields=[0.0, 3.0], wavelengths=[WVL])

    j, jm = jrt.resolve_exit_pupil(system(jrt, jsr), WVL, field=jrt.Field(0.0, 3.0),
                                   return_mode=True)
    t, tm = trt.resolve_exit_pupil(system(trt, tsr), WVL, field=trt.Field(0.0, 3.0),
                                   return_mode=True)
    assert tm == jm == 'geometric'
    assert _rel(t, np.asarray(j)) <= BAR


def _jax_launched():
    system = doublet(jrt, jsr)
    P, S = jrt.launch(system, system.field(1), WVL, jrt.Sampling.hex(4))
    return np.asarray(P), np.asarray(S)


@pytest.fixture(scope='module')
def launched():
    return jax_ref('launched', _jax_launched, bar=BAR)


def _jax_wavefront(P, S, output, nms):
    jsys = doublet(jrt, jsr)
    j = jrt.wavefront(jsys, P, S, WVL, field=jsys.field(1), output=output)
    return j, jrt.wavefront_zernike_fit(*j, nms)


@pytest.mark.parametrize('output', ['length', 'waves'])
def test_wavefront_and_fit_match_jax(launched, output):
    P, S = launched
    tsys = doublet(trt, tsr)
    nms = [(n, m) for n in range(6) for m in range(-n, n + 1, 2)]
    j, (jc, jr) = jax_ref('wavefront', _jax_wavefront, P, S, output, nms, bar=BAR)
    t = tsys.analysis.wavefront(P, S, WVL, field=tsys.field(1), output=output)
    for a, b in zip(t, j):
        assert _rel(a, np.asarray(b)) <= BAR
    tc, tr = trt.wavefront_zernike_fit(*t, nms)
    assert _rel(tc, jc) <= 1e-9 and tr == pytest.approx(jr, rel=1e-8)


def test_transverse_aberration_and_spot_positions_match_jax(launched):
    P, S = launched
    jr = jrt.raytrace(doublet(jrt, jsr).to_surfaces(), P, S, WVL)
    tr = trt.raytrace(doublet(trt, tsr).to_surfaces(), P, S, WVL)
    for axis in ('x', 'y'):
        for ref in ('chief', 'centroid'):
            j = jrt.transverse_ray_aberration(jr.P, axis, status=jr.status, reference=ref)
            t = trt.transverse_ray_aberration(tr.P, axis, status=tr.status, reference=ref)
            for a, b in zip(t, j):
                assert _rel(a, np.asarray(b)) <= BAR
    for origin in (None, 'centroid', (0.1, 0.2)):
        j = jrt.spot_positions(jr.P[-1], jr.status, origin=origin)
        t = trt.spot_positions(tr.P[-1], tr.status, origin=origin)
        for a, b in zip(t, j):
            assert _rel(a, np.asarray(b)) <= BAR


# ---------- analysis verbs ---------------------------------------------------------

def _verbs():
    return {
        'distortion': lambda s: s.analysis.distortion(samples=4).percent,
        'distortion-linear': lambda s: s.analysis.distortion(
            samples=3, distortion_type='linear-angle').paraxial_xy,
        'field_curvature': lambda s: np.stack(
            [(r := s.analysis.field_curvature(samples=3)).x_fan_z, r.y_fan_z]),
        'chromatic_best': lambda s: s.analysis.chromatic_focal_shift(
            [0.5, 0.6], sampling=s_hex(s, 3))[1],
        'chromatic_paraxial': lambda s: s.analysis.chromatic_focal_shift(
            [0.5, 0.6], focus='paraxial')[1],
        'lateral_color': lambda s: s.analysis.lateral_color(wavelengths=[0.5, 0.6], samples=3),
        'ray_fans': lambda s: np.stack([(g := s.analysis.ray_aberration_fans(nrays=7)).x, g.y]),
        'opd_fans': lambda s: np.stack([(g := s.analysis.opd_fans(nrays=7)).x, g.y]),
        'spot_diagrams': lambda s: np.stack([(g := s.analysis.spot_diagrams(
            sampling=s_hex(s, 3))).x, g.y]),
        'spot_radii': lambda s: np.stack([
            (m := importlib.import_module(type(s).__module__.rsplit('.', 1)[0] + '.analysis'))
            .spot_rms_radius(g := s.analysis.spot_diagrams(sampling=s_hex(s, 3))),
            m.spot_geometric_radius(g)]),
        'full_field_rms_spot': lambda s: s.analysis.full_field(
            'rms spot', samples=3, sampling=s_hex(s, 2)).data,
        'full_field_rms_wfe': lambda s: s.analysis.full_field(
            'rms wfe', samples=3, sampling=s_hex(s, 2)).data,
        'full_field_distortion': lambda s: s.analysis.full_field('distortion', samples=3).data,
        'full_field_lateral_color': lambda s: s.analysis.full_field(
            'lateral color', samples=3, wavelengths=[0.5, 0.6]).data,
    }


def s_hex(system, n):
    rt = importlib.import_module(type(system).__module__.rsplit('.', 1)[0])
    return rt.Sampling.hex(n)


@pytest.mark.parametrize('verb', sorted(_verbs()))
def test_analysis_verbs_match_jax(verb):
    fn = _verbs()[verb]
    j = jax_ref('verb', lambda verb: np.asarray(_verbs()[verb](doublet(jrt, jsr)), dtype=float),
                verb, bar=BAR)
    t = np.asarray(fn(doublet(trt, tsr)), dtype=float)
    assert np.isfinite(j).any()
    assert _rel(t, j) <= BAR


def test_device_wavefront_fit_on_an_optical_system_matches_jax():
    nms = [(n, m) for n in range(5) for m in range(-n, n + 1, 2)]
    jc, jr = jax_ref('device-fit', lambda nms: j_device_fit(
        doublet(jrt, jsr), nms, sampling=jrt.Sampling.hex(4)), nms, bar=1e-9)
    tc, tr = trt.device_wavefront_fit(doublet(trt, tsr), nms, sampling=trt.Sampling.hex(4),
                                      device='cpu')
    assert tc.shape == (1, 2, len(nms))
    assert _rel(tc, np.asarray(jc)) <= 1e-9 and _rel(tr, np.asarray(jr)) <= 1e-6


# ---------- real aiming through the continuation ladder -----------------------------

def _jax_fisheye_launch():
    j = jsr.fisheye_system()
    j.ray_aiming = 'real'
    return jrt.launch(j, j.field(2), j.wavelength(), jrt.Sampling.hex(3))


def test_fisheye_real_aiming_matches_jax_at_50_degrees():
    """The fish-eye's 50 degree field: real aiming lands every ray in the
    first pass in both packages (the ladder is not needed there)."""
    t = tsr.fisheye_system()
    t.ray_aiming = 'real'
    jP, jS = jax_ref('fisheye-50', _jax_fisheye_launch, bar=1e-9)
    tP, tS = trt.launch(t, t.field(2), t.wavelength(), trt.Sampling.hex(3))
    assert np.isfinite(tS).all()
    assert _rel(tP, np.asarray(jP)) <= 1e-9 and _rel(tS, np.asarray(jS)) <= 1e-9


def test_fisheye_ladder_places_its_rungs_by_parabasal(monkeypatch):
    """At 70 degrees the first aiming pass loses rays, and the continuation
    ladder walks the field up, each rung's pupil placed by
    ``parabasal.first_order`` (``launch._parabasal_ep_z``); the first rung's
    pupil is the JAX package's, and the aimed chief crosses the stop at its
    centre (as the JAX package's ladder test holds its own fish-eye)."""
    tlaunch = importlib.import_module('prysm_tpu_torch.x.raytracing.launch')
    jlaunch = importlib.import_module('prysm_tpu.x.raytracing.launch')
    calls = []
    inner = tlaunch._parabasal_ep_z

    def counted(system, field, wvl):
        calls.append((field, inner(system, field, wvl)))
        return calls[-1][1]

    monkeypatch.setattr(tlaunch, '_parabasal_ep_z', counted)
    t = tsr.fisheye_system()
    t.ray_aiming = 'real'
    P, S = trt.launch(t, trt.Field(0.0, 70.0, unit='deg'), t.wavelength(), trt.Sampling.hex(1))
    assert len(calls) > 1, 'the 70 degree launch did not reach the ladder'
    assert np.isfinite(S).all()
    field, z = calls[0]

    def first_rung(hx, hy):
        j = jsr.fisheye_system()
        j.ray_aiming = 'real'
        return jlaunch._parabasal_ep_z(j, jrt.Field(hx, hy, unit='deg'), j.wavelength())

    zj = jax_ref('ladder-rung', first_rung, field.hx, field.hy, bar=1e-12)
    assert z == pytest.approx(zj, rel=1e-12)
    at_stop = _host(trt.raytrace(t.to_surfaces(), P, S, t.wavelength()).P)[
        tsr.FISHEYE_STOP_INDEX + 1]
    assert np.abs(at_stop[0, :2]).max() < 1e-9


def test_parabasal_pupil_falls_back_as_the_jax_package_does():
    """A field the chief cannot reach: first_order's ValueError gives the
    paraxial entrance pupil in both packages."""
    tlaunch = importlib.import_module('prysm_tpu_torch.x.raytracing.launch')
    jlaunch = importlib.import_module('prysm_tpu.x.raytracing.launch')
    j, t = doublet(jrt, jsr), doublet(trt, tsr)
    far_j, far_t = jrt.Field(0.0, 89.0), trt.Field(0.0, 89.0)
    zj, zt = jlaunch._parabasal_ep_z(j, far_j, WVL), tlaunch._parabasal_ep_z(t, far_t, WVL)
    assert zt == pytest.approx(zj, rel=1e-12)
    assert tlaunch._parabasal_ep_z(t, t.field(1), WVL) == pytest.approx(
        jlaunch._parabasal_ep_z(j, j.field(1), WVL), rel=1e-12)


# ---------- the lens-analysis step ---------------------------------------------------

N, FN, RINGS = 128, 32, 6


class _JaxLensAnalysis:
    """``steps.build_lens_analysis`` composed from the JAX package's functions."""

    def __init__(self):
        from prysm_tpu.coordinates import make_xy_grid, cart_to_polar
        from prysm_tpu.geometry import circle_sdf, antialias
        from prysm_tpu.polynomials import zernike_nm_seq
        from prysm_tpu.propagation import prepare_executor
        from prysm_tpu.x.raytracing.batch import _host_launches
        bk7 = jmat.model_glass(*steps.CFG6_GLASSES[0][:2], name='BK7ish')
        sf5 = jmat.model_glass(*steps.CFG6_GLASSES[1][:2], name='SF5ish')
        lens = jrt.LensData()
        for c, t, m in zip(steps.CFG6_CURVATURES, steps.CFG6_THICKNESSES, (bk7, sf5, jmat.air)):
            lens.add(jrt.Sphere(c), thickness=t, material=m)
        self.system = jrt.OpticalSystem(lens, aperture=jrt.ApertureSpec.epd(steps.CFG6_EPD),
                                        fields=list(steps.CFG6_FIELDS), wavelengths=[WVL],
                                        stop_index=steps.CFG6_STOP, ray_aiming='real')
        self.sampling = jrt.Sampling.hex(RINGS)
        x, y = make_xy_grid(N, diameter=steps.DIAMETER)
        self.dx = steps.DIAMETER / N
        r, t = cart_to_polar(x, y)
        self.amp = antialias(circle_sdf(1.0, r), self.dx)
        self.modes = zernike_nm_seq(steps.LENS_NMS, r, t)
        self.plan = prepare_executor(self.dx, (N, N), 0.25, FN, WVL, steps.EFL)
        P, S = _host_launches(self.system, list(self.system.fields), WVL, self.sampling, None)
        self.P, self.S = P.reshape(-1, 3), S.reshape(-1, 3)
        self.seeds = ([ja.seed_curvature(j) for j in steps.LENS_SPHERES]
                      + [ja.seed_despace(m) for m in steps.LENS_THICKNESSES])

    def __call__(self):
        from prysm_tpu.polynomials import sum_of_2d_modes
        from prysm_tpu.propagation import Wavefront
        coefs, rms = j_device_fit(self.system, steps.LENS_NMS, sampling=self.sampling)
        psfs = jnp.stack([Wavefront.from_amp_and_phase(
            self.amp, sum_of_2d_modes(self.modes, c * 1e6), WVL, self.dx)
            .focus_dft(self.plan).intensity.data for c in coefs[0]])
        grads, values = ja.adjoint_gradient_multi(self.system, self.P, self.S, WVL, self.seeds,
                                                  [ja.RmsSpotHead(), ja.OplSpreadHead()])
        return coefs, rms, psfs, grads, values


@pytest.fixture(scope='module')
def jax_lens_analysis():
    return jax_ref('lens-analysis', lambda: _JaxLensAnalysis()(),
                   bar=(1e-9, 1e-6, 1e-9, 1e-9, 1e-12))


@pytest.mark.parametrize('fused', [True, False])
def test_lens_analysis_step_matches_jax(jax_lens_analysis, fused):
    """The port's step (fused: the Zernike wrapper's plain version on the
    CPU; else the mode stack) against the JAX composition."""
    la = steps.build_lens_analysis(trt.Sampling.hex(RINGS), N=N, fN=FN, fused=fused,
                                   dtype=torch.float64, device='cpu')
    assert la.system.ray_aiming == 'real' and la.P.shape == (3 * 127, 3)
    coefs, rms, psfs, grads, values = la()
    jc, jr, jp, jg, jv = jax_lens_analysis
    assert coefs.shape == (1, 3, 36) and psfs.shape == (3, FN, FN) and grads.shape == (2, 5)
    assert _rel(coefs, np.asarray(jc)) <= 1e-9
    assert _rel(rms, np.asarray(jr)) <= 1e-6
    assert _rel(psfs, np.asarray(jp)) <= 1e-9
    assert _rel(grads, np.asarray(jg)) <= 1e-9
    np.testing.assert_allclose(values, jv, rtol=1e-12)
