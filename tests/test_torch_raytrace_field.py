"""The port's ``x/raytracing/field`` against the JAX package's, in float64 on the CPU.

Pupil fields of the designer's lens (``steps.cfg6_design_system``) at its three
fields on ``npupil`` 16-32 entrance grids: the sine-space coordinates, OPD and
amplitude within 1e-10 of their largest magnitude, and their PSFs at ``npix`` 64, Q=2
(scalar and polarized, through the port's ``Wavefront`` on the CPU): from the same
pupil samples within 1e-10 of the peak, and end to end off axis within 1e-10 plus
twice the phase that the two packages' OPD difference makes (1e-13 mm on 100 mm paths
is 1.1e-9 rad, and the PSF follows the phase); on axis the samples' symmetric grid
makes SciPy's Delaunay triangulation break ties by rounding (a 1e-15 relative change
of the samples moves the JAX package's own PSF by 2.1e-2 of its peak at ``npupil``
16), so there only from the same samples; polarization ray tracing (3x3 P matrices; Jones) within 1e-12, bare and
coated (the coatings through the port's ``coatings.stack_rt``); the per-interface
amplitude rules, incidence data, sine-space coordinates and apodization within 1e-12.
"""
import numpy as np
import pytest
import torch

import prysm_tpu.x.coatings as jct
import prysm_tpu.x.materials as jmat
import prysm_tpu.x.raytracing as jrt
from prysm_tpu.x.raytracing import lensdata as jlensdata

import prysm_tpu_torch.x.coatings as tct
import prysm_tpu_torch.x.materials as tmat
import prysm_tpu_torch.x.raytracing as trt
from prysm_tpu_torch import steps
from prysm_tpu_torch.conf import config
from prysm_tpu_torch.x.raytracing import lensdata as tlensdata

torch.set_num_threads(2)
WVL = steps.WVL
BAR, JONES_BAR = 1e-10, 1e-12
PACKAGES = {'jax': (jrt, jmat, jlensdata, jct), 'torch': (trt, tmat, tlensdata, tct)}


@pytest.fixture(autouse=True)
def f64_on_cpu(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _host(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b):
    a, b = _host(a), _host(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    scale = np.nanmax(np.abs(b)) if b.size else 0.0
    return float(np.nanmax(np.abs(a - b)) / (scale if scale > 0 else 1.0)) if b.size else 0.0


def design_system(pkg, coated=False):
    """steps.cfg6_design_system through either package; with a quarter-wave MgF2 AR
    coating on the front surface, if asked."""
    rt, mat, lensdata, ct = PACKAGES[pkg]
    lens = rt.LensData()
    media = [mat.model_glass(nd, vd, name=name) for nd, vd, name in steps.CFG6_GLASSES]
    for k, (c, t, m) in enumerate(zip(steps.CFG6_CURVATURES, steps.CFG6_THICKNESSES,
                                      media + [mat.air])):
        coating = (ct.Stack([1.38], [WVL / (4 * 1.38)], substrate_index=1.5168)
                   if coated and k == 0 else None)
        lens.add(rt.Sphere(c), thickness=t, material=m, coating=coating)
    system = rt.OpticalSystem(lens, aperture=rt.ApertureSpec.epd(steps.CFG6_EPD),
                              fields=list(steps.CFG6_FIELDS), wavelengths=[WVL],
                              stop_index=steps.CFG6_STOP)
    system.lens.rows.insert(steps.DESIGN_DECENTRE_ROW, lensdata.CoordBreak())
    return system


def mirror(pkg, coated):
    """A tilted-beam fold: one (aluminium-coated, if asked) plane mirror."""
    rt, mat, _, ct = PACKAGES[pkg]
    coating = (ct.Stack([], [], substrate_index=0.96 + 6.7j, ambient_index=1.0) if coated
               else None)
    lens = rt.LensData()
    lens.add(rt.Conic(-1 / 200.0, -1.0), typ='refl', thickness=50.0, material=mat.MIRROR,
             coating=coating)
    return rt.OpticalSystem(lens, aperture=rt.ApertureSpec.epd(10.0), fields=[0.0, 3.0],
                            wavelengths=[WVL], stop_index=1)


def bundle(system, field, rings=4):
    return tuple(np.asarray(a) for a in jrt.launch(system, system.field(field), WVL,
                                                   jrt.Sampling.hex(rings)))


@pytest.mark.parametrize('npupil', (16, 32))
@pytest.mark.parametrize('field', range(3))
def test_pupil_fields_match(field, npupil):
    pf = {}
    for pkg in PACKAGES:
        rt = PACKAGES[pkg][0]
        system = design_system(pkg)
        pf[pkg] = rt.pupil_field(system, system.field(field), WVL, npupil=npupil)
    t, j = pf['torch'], pf['jax']
    for name in ('X', 'Y', 'amplitude', 'opd'):
        assert _rel(getattr(t, name), getattr(j, name)) <= BAR, name
    for name in ('efl', 'n_image', 'wavelength'):
        assert abs(getattr(t, name) - getattr(j, name)) <= BAR * abs(getattr(j, name))
    assert _rel(t.P_xp, j.P_xp) <= BAR and _rel(t.P_img, j.P_img) <= BAR
    assert not t.polarized and _rel(t.waves(), j.waves()) <= BAR


def _phase_bar(tpf, jpf):
    """1e-10 plus twice the phase (rad) of the packages' largest OPD difference."""
    return BAR + 2 * (2 * np.pi / WVL) * float(np.abs(tpf.opd - jpf.opd).max())


@pytest.mark.parametrize('field', range(3))
def test_pupil_field_psfs_match(field):
    """pupil_field_psf at npix 64, Q=2: the port resamples on the host and focuses
    through its Wavefront; from the JAX package's own samples, and end to end."""
    pf, out = {}, {}
    for pkg in PACKAGES:
        rt = PACKAGES[pkg][0]
        system = design_system(pkg)
        pf[pkg] = rt.pupil_field(system, system.field(field), WVL, npupil=24)
        out[pkg] = rt.pupil_field_psf(pf[pkg], npix=64, Q=2)
    (t, tdx), (j, jdx) = out['torch'], out['jax']
    same, _ = trt.pupil_field_psf(pf['jax'], npix=64, Q=2)
    assert isinstance(t, np.ndarray) and t.shape == (128, 128)
    assert _rel(same, j) <= BAR and abs(tdx - jdx) <= BAR * jdx
    if field:
        assert _rel(t, j) <= _phase_bar(pf['torch'], pf['jax'])


def test_pupil_field_to_wavefront_matches():
    out = {}
    for pkg in PACKAGES:
        rt = PACKAGES[pkg][0]
        system = design_system(pkg)
        pf = rt.pupil_field(system, system.field(2), WVL, npupil=16)
        out[pkg] = rt.pupil_field_to_wavefront(pf, npix=48, margin=1.1), pf
    (t, tpf), (j, jpf) = out['torch'], out['jax']
    assert torch.is_tensor(t.data) and t.data.dtype == torch.complex128
    assert _rel(np.abs(_host(t.data)), np.abs(_host(j.data))) <= BAR
    assert _rel(_host(t.data), _host(j.data)) <= _phase_bar(tpf, jpf)
    assert abs(t.dx - j.dx) <= BAR * j.dx


@pytest.mark.parametrize('illumination', ('unpolarized', (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)))
def test_polarized_pupil_field_psfs_match(illumination):
    out = {}
    for pkg in PACKAGES:
        rt = PACKAGES[pkg][0]
        system = design_system(pkg, coated=True)
        pf = rt.pupil_field(system, system.field(1), WVL, npupil=16, polarized=True)
        out[pkg] = (pf, rt.pupil_field_psf(pf, npix=64, Q=2, input_polarization=illumination))
    (tpf, (t, _)), (jpf, (j, _)) = out['torch'], out['jax']
    assert tpf.polarized and _rel(tpf.P_matrix, jpf.P_matrix) <= JONES_BAR
    assert _rel(t, j) <= _phase_bar(tpf, jpf)


def test_polarized_wavefront_needs_an_input_state():
    system = design_system('torch')
    pf = trt.pupil_field(system, system.field(0), WVL, npupil=8, polarized=True)
    with pytest.raises(TypeError, match='input_polarization'):
        trt.pupil_field_to_wavefront(pf)


PRT_CASES = {
    'design-axis': (lambda pkg: design_system(pkg), 0),
    'design-edge': (lambda pkg: design_system(pkg), 2),
    'design-coated-edge': (lambda pkg: design_system(pkg, coated=True), 2),
    'mirror-bare': (lambda pkg: mirror(pkg, False), 1),
    'mirror-aluminium': (lambda pkg: mirror(pkg, True), 1),
}


@pytest.mark.parametrize('case', PRT_CASES)
def test_prt_jones_matrices_match(case):
    make, field = PRT_CASES[case]
    P, S = bundle(make('jax'), field)
    out = {pkg: PACKAGES[pkg][0].raytrace_prt(make(pkg), P, S, WVL) for pkg in PACKAGES}
    t, j = out['torch'], out['jax']
    assert t.P_matrix.dtype == np.complex128
    assert float(np.abs(t.P_matrix - np.asarray(j.P_matrix)).max()) <= JONES_BAR
    assert _rel(t.P, j.P) <= 1e-12 and _rel(t.S, j.S) <= 1e-12


@pytest.mark.parametrize('case', ('design-edge', 'design-coated-edge', 'mirror-aluminium'))
def test_field_amplitudes_and_incidence_match(case):
    make, field = PRT_CASES[case]
    P, S = bundle(make('jax'), field)
    out = {}
    for pkg in PACKAGES:
        rt = PACKAGES[pkg][0]
        system = make(pkg)
        ft = rt.raytrace_field(system, P, S, WVL)
        out[pkg] = (ft.amplitude, rt.surface_normals_from_trace(
            system.to_surfaces(), ft.trace, WVL, complex_indices=True))
    (ta, tinc), (ja, jinc) = out['torch'], out['jax']
    assert _rel(ta, ja) <= JONES_BAR
    for a, b in zip(tinc, jinc):
        assert float(np.max(np.abs(np.asarray(a) - np.asarray(b)))) <= JONES_BAR


COEFFICIENT_CASES = {
    'refract-in': (1.0, 1.5, 'refract', None),
    'refract-out-tir': (1.5, 1.0, 'refract', None),
    'reflect': (1.0, 1.0, 'reflect', None),
    'eval': (1.0, 1.0, 'eval', None),
    'ar-refract': (1.0, 1.5168, 'refract', ([1.38], [WVL / (4 * 1.38)], 1.5168)),
    'empty-stack-refract': (1.0, 1.5, 'refract', ([], [], 1.5)),
    'aluminium-reflect': (1.0, 1.0, 'reflect', ([], [], 0.96 + 6.7j)),
    'two-layer-reflect': (1.0, 1.0, 'reflect', ([1.38, 2.3], [0.1, 0.06], 0.2 + 3.4j)),
}
STYPES = {'refract': 'STYPE_REFRACT', 'reflect': 'STYPE_REFLECT', 'eval': 'STYPE_EVAL'}


@pytest.mark.parametrize('case', COEFFICIENT_CASES)
def test_interface_coefficients_match(case):
    n0, n1, kind, stack = COEFFICIENT_CASES[case]
    cosI = np.cos(np.linspace(0.0, 1.3, 17))
    out = {}
    for pkg in PACKAGES:
        rt, ct = PACKAGES[pkg][0], PACKAGES[pkg][3]
        coating = None if stack is None else ct.Stack(stack[0], stack[1],
                                                      substrate_index=stack[2])
        out[pkg] = rt.interface_coefficients(n0, n1, cosI, getattr(rt, STYPES[kind]),
                                             coating=coating, wavelength=WVL)
    for a, b in zip(out['torch'], out['jax']):
        assert np.asarray(a).dtype == np.complex128
        assert float(np.max(np.abs(np.asarray(a) - np.asarray(b)))) <= JONES_BAR


def test_unpolarized_amplitude_matches():
    P, S = bundle(design_system('jax', coated=True), 1)
    out = {}
    for pkg in PACKAGES:
        rt = PACKAGES[pkg][0]
        surfaces = design_system(pkg, coated=True).to_surfaces()
        out[pkg] = rt.unpolarized_amplitude(surfaces, rt.raytrace(surfaces, P, S, WVL), WVL)
    assert _rel(out['torch'], out['jax']) <= JONES_BAR


def test_sine_space_and_apodization_match():
    rng = np.random.default_rng(5)
    S_last = rng.normal(size=(40, 3)) * 0.05 + np.array([0.0, 0.0, 1.0])
    S_last /= np.linalg.norm(S_last, axis=1, keepdims=True)
    a, b = np.meshgrid(np.linspace(-1, 1, 9), np.linspace(-1, 1, 9))
    entrance = np.stack([a, b], axis=-1)
    sphere = entrance * (1.0 + 0.1 * (a * a + b * b))[..., None]
    sphere[4, 4] = np.nan
    valid = np.ones((9, 9), dtype=bool)
    valid[0, 0] = False
    for axis_dir in (None, (0.0, 0.1, 1.0)):
        t = trt.sine_space_coords(torch.as_tensor(S_last), S_last[3], 12.0, axis_dir)
        j = jrt.sine_space_coords(S_last, S_last[3], 12.0, axis_dir)
        for x, y in zip(t, j):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-13)
    t = trt.amplitude_apodization(entrance, sphere, valid=valid)
    j = jrt.amplitude_apodization(entrance, sphere, valid=valid)
    np.testing.assert_array_equal(t, j)
