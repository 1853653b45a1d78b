"""The port's differential raytracing against the JAX package's, in float64.

``_diff_raytrace`` (forward mode: ``torch.func.jvp`` against ``jax.jvp``)
and ``adjoint`` (reverse mode: autograd against ``jax.vjp``) on the same
prescriptions from both packages' ``sample_rx``: the doublet behind a stop
plane, launched at 3 degrees on ``Sampling.hex(3)`` (37 rays), with five
seeds (curvature, thickness, index, decentre and a Zernike irregularity,
whose sag term sends the intersection through the Newton solve), and the
conic doublet for the Newton path of a conic.  JAX runs under x64, the
port with ``config.precision = 64`` on the CPU.  Bars: tangents, OPD
tangents, sensitivities and primitive differentials within 1e-10 of each
quantity's largest magnitude; host linear algebra within 1e-13.

One deliberate difference: a tensor curvature is never static, so the
port keeps a plane on its conic path, where d(sag)/dc = r^2 / 2 at c = 0;
the JAX package takes its plane branch there, whose curvature tangent is
0 (ROADMAP Queue 3).  ``test_curvature_seed_on_a_plane`` pins both.  The
JAX package's side of the slow comparisons is read from its record
(``_jax_refs``) where it is current.
"""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _jax_refs import jax_ref
import prysm_tpu.x.raytracing as jrt
from prysm_tpu.x.raytracing import _diff_raytrace as jd
from prysm_tpu.x.raytracing import adjoint as ja
from prysm_tpu.x.raytracing import sample_rx as jsr
from prysm_tpu.x.raytracing.tolerance import Perturbation

import prysm_tpu_torch.x.raytracing as trt
from prysm_tpu_torch.conf import config, device_as, precision_as
from prysm_tpu_torch.x.raytracing import _diff_raytrace as td
from prysm_tpu_torch.x.raytracing import adjoint as ta
from prysm_tpu_torch.x.raytracing import sample_rx as tsr

torch.set_num_threads(2)
WVL = 0.55
BAR = 1e-10
SEED_NAMES = ('curvature', 'thickness', 'index', 'decenter', 'irregularity')
HEADS = ('rms_spot', 'opl_spread', 'boresight', 'height_s3')


@pytest.fixture(autouse=True)
def f64_on_cpu(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _host(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b):
    a, b = _host(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / (scale if scale > 0 else 1.0))


def doublet(rt, sr, conic=False):
    lens = sr.doublet_conic() if conic else sr.doublet()
    return rt.OpticalSystem(lens, aperture=rt.ApertureSpec.epd(10.0), fields=[0.0, 3.0],
                            wavelengths=[WVL], stop_index=2)


def seeds(m):
    """The five seeds, in order, from either package's seed vocabulary."""
    return [m.seed_curvature(3), m.seed_despace([(4, 1), (5, 1)], name='t'),
            m.seed_index(3), m.seed_decenter(3, 'y'), m.seed_irregularity(4, 2, 2, 10.0)]


def heads(m):
    return [m.RmsSpotHead(), m.OplSpreadHead(), m.BoresightHead(), m.RayHeightHead(3)]


def _port():
    return precision_as(torch.float64), device_as('cpu')


TANGENTS = ('P', 'OPL', 'status', 'Pdot', 'Sdot', 'Ldot')


def _jax_launch():
    system = doublet(jrt, jsr)
    P, S = jrt.launch(system, system.field(1), WVL, jrt.Sampling.hex(3))
    return dict(P=np.asarray(P), S=np.asarray(S), xp=system.exit_pupil(WVL))


def _jax_side(P, S, xp):
    system = doublet(jrt, jsr)
    surfaces = system.to_surfaces()
    tangents = jd.raytrace_with_tangents(surfaces, P, S, WVL, seeds(jd))
    return dict(seed_names=[s.name for s in tangents.seeds],
                tangents={k: getattr(tangents, k) for k in TANGENTS},
                wavefront=jd.wavefront_with_tangents(surfaces, P, S, WVL, seeds(jd), P_xp=xp,
                                                     field=system.field(1)),
                multi=ja.adjoint_gradient_multi(system, P, S, WVL, seeds(ja), heads(ja)))


@pytest.fixture(scope='module')
def jax_side():
    """The JAX package's tangents and sensitivities, computed once."""
    launch = jax_ref('launch', _jax_launch)
    bars = dict(seed_names=0.0, tangents=dict(P=1e-13, OPL=1e-13, status=0.0, Pdot=BAR,
                                              Sdot=BAR, Ldot=BAR),
                wavefront=(1e-12, 1e-12, 1e-12, BAR), multi=(BAR, 1e-13))
    out = types.SimpleNamespace(**launch, **jax_ref('jax-side', _jax_side, *launch.values(),
                                                    bar=bars))
    out.tangents = types.SimpleNamespace(**out.tangents)
    return out


@pytest.fixture(scope='module')
def port_side(jax_side):
    """The port's, from the JAX package's launch bundle."""
    p, d = _port()
    with p, d:
        system = doublet(trt, tsr)
        surfaces = system.to_surfaces()
        out = types.SimpleNamespace(system=system)
        out.tangents = td.raytrace_with_tangents(surfaces, jax_side.P, jax_side.S, WVL,
                                                 seeds(td))
        out.wavefront = td.wavefront_with_tangents(surfaces, jax_side.P, jax_side.S, WVL,
                                                   seeds(td), P_xp=system.exit_pupil(WVL),
                                                   field=system.field(1))
        out.multi = ta.adjoint_gradient_multi(system, jax_side.P, jax_side.S, WVL, seeds(ta),
                                              heads(ta))
    return out


def test_launch_and_exit_pupil_are_the_jax_packages(jax_side):
    system = doublet(trt, tsr)
    P, S = trt.launch(system, system.field(1), WVL, trt.Sampling.hex(3))
    np.testing.assert_array_equal(P, jax_side.P)
    np.testing.assert_array_equal(S, jax_side.S)
    np.testing.assert_array_equal(system.exit_pupil(WVL), np.asarray(jax_side.xp))


def test_nominal_trace_matches(jax_side, port_side):
    j, t = jax_side.tangents, port_side.tangents
    assert _rel(t.P, j.P) <= 1e-13 and _rel(t.OPL, j.OPL) <= 1e-13
    np.testing.assert_array_equal(_host(t.status), np.asarray(j.status))
    assert t.n_params == 5 and [s.name for s in t.seeds] == jax_side.seed_names


@pytest.mark.parametrize('k', range(5), ids=SEED_NAMES)
@pytest.mark.parametrize('what', ['Pdot', 'Sdot', 'Ldot'])
def test_raytrace_tangents_match_jax(jax_side, port_side, what, k):
    j = getattr(jax_side.tangents, what)[..., k]
    t = getattr(port_side.tangents, what)[..., k]
    assert np.abs(j).max() > 0
    assert _rel(t, j) <= BAR


@pytest.mark.parametrize('k', range(5), ids=SEED_NAMES)
def test_wavefront_tangents_match_jax(jax_side, port_side, k):
    j, t = jax_side.wavefront, port_side.wavefront
    for a, b in zip(t[:3], j[:3]):
        assert _rel(a, b) <= 1e-12
    assert _rel(t[3][:, k], j[3][:, k]) <= BAR


def test_wavefront_tangents_geometric_pupil_in_waves(jax_side):
    """No P_xp: the closing's sphere passes through the chief's closest
    approach to the axis, its tangent carried through the same jvp."""
    tsys = doublet(trt, tsr)
    j = jax_ref('geometric-pupil', lambda P, S: jd.wavefront_with_tangents(
        doublet(jrt, jsr).to_surfaces(), P, S, WVL, seeds(jd)[:2], output='waves'),
        jax_side.P, jax_side.S, bar=(1e-10, 1e-10, 1e-10, BAR))
    t = td.wavefront_with_tangents(tsys.to_surfaces(), jax_side.P, jax_side.S, WVL,
                                   seeds(td)[:2], output='waves')
    assert _rel(t[0], j[0]) <= 1e-10 and _rel(t[3], j[3]) <= BAR


@pytest.mark.parametrize('m', range(4), ids=HEADS)
def test_adjoint_gradient_multi_matches_jax(jax_side, port_side, m):
    (jg, jv), (tg, tv) = jax_side.multi, port_side.multi
    assert tg.shape == (4, 5)
    assert _rel(tg[m], jg[m]) <= BAR
    assert tv[m] == pytest.approx(jv[m], rel=1e-13, abs=1e-15)


def test_adjoint_agrees_with_forward_tangents(jax_side, port_side):
    """Reverse mode against forward mode in the port: the RMS spot head's
    gradient equals the jvp of the head along each seed's tangents."""
    t = port_side.tangents
    head = ta.RmsSpotHead()
    fwd = [float(torch.func.jvp(head, (t.P, t.S, t.OPL),
                                tuple(torch.as_tensor(d[..., k])
                                      for d in (t.Pdot, t.Sdot, t.Ldot)))[1])
           for k in range(5)]
    assert _rel(port_side.multi[0][0], np.asarray(fwd)) <= 1e-10


class _XYSumHead:
    """A seed-protocol head: the sum of the landing points' x + y."""

    name = 'xy_sum'

    def __init__(self, np_mod):
        self.np = np_mod

    def seed(self, trace, system, wavelength):
        P = np.asarray(_host(trace.P))
        P_bar = np.zeros_like(P)
        P_bar[-1, :, :2] = 1.0
        return P_bar, np.zeros_like(P), np.zeros(P.shape[:2])

    def value(self, trace, system, wavelength):
        return float(np.asarray(_host(trace.P))[-1, :, :2].sum())


@pytest.mark.parametrize('kind', ['callable', 'seed-protocol'])
def test_adjoint_gradient_matches_jax(jax_side, kind):
    jsys, tsys = doublet(jrt, jsr), doublet(trt, tsr)
    jh, th = ((ja.RmsSpotHead('chief', chief_index=18), ta.RmsSpotHead('chief', chief_index=18))
              if kind == 'callable' else (_XYSumHead(jnp), _XYSumHead(torch)))
    jg, jv = ja.adjoint_gradient(jsys, jax_side.P, jax_side.S, WVL, seeds(ja)[:3], jh)
    tg, tv = ta.adjoint_gradient(tsys, jax_side.P, jax_side.S, WVL, seeds(ta)[:3], th)
    assert _rel(tg, jg) <= BAR
    assert tv == pytest.approx(jv, rel=1e-13)


def test_conic_newton_tangents_match_jax(jax_side):
    """The conic doublet: the curvature and conic seeds through the conic's
    intersection, and the irregularity's Newton solve on a conic base."""
    tsys = doublet(trt, tsr, conic=True)
    ts = [td.seed_curvature(3), td.seed_conic(4), td.seed_irregularity(4, 3, 1, 10.0)]

    def conic_tangents(P, S):
        js = [jd.seed_curvature(3), jd.seed_conic(4), jd.seed_irregularity(4, 3, 1, 10.0)]
        j = jd.raytrace_with_tangents(doublet(jrt, jsr, conic=True).to_surfaces(), P, S, WVL, js)
        return {what: getattr(j, what) for what in ('Pdot', 'Sdot', 'Ldot')}

    j = jax_ref('conic-newton', conic_tangents, jax_side.P, jax_side.S, bar=BAR)
    t = td.raytrace_with_tangents(tsys.to_surfaces(), jax_side.P, jax_side.S, WVL, ts)
    for what in ('Pdot', 'Sdot', 'Ldot'):
        assert _rel(getattr(t, what), j[what]) <= BAR
    # against central differences of the perturbed trace (h = 1e-6)
    f = ta.engine._trace_fn(tsys.to_surfaces(), ts, jax_side.P, jax_side.S, WVL, None)
    h = 1e-6
    for k in range(3):
        e = torch.zeros(3, dtype=torch.float64)
        e[k] = h
        fd = (f(e)[0] - f(-e)[0]) / (2 * h)
        assert _rel(t.Pdot[..., k], fd) <= 1e-6


def _flat_stop(rt, sr, mat):
    """The doublet with its stop on a sphere of curvature 0."""
    lens = rt.LensData()
    lens.add(rt.Plane(), typ='eval', thickness=10)
    lens.add(rt.Sphere(0.0), typ='eval', thickness=0)
    lens.add(rt.Sphere(1 / 46.44), thickness=7, material=sr.N_BK7, aperture=12)
    lens.add(rt.Sphere(-1 / 33.77), thickness=2.5, material=sr.N_SF5, aperture=12)
    lens.add(rt.Sphere(-1 / 95.94), thickness=0, material=mat.air, aperture=12)
    return rt.OpticalSystem(lens, aperture=rt.ApertureSpec.epd(10.0), fields=[0.0, 3.0],
                            wavelengths=[WVL], stop_index=2)


def test_curvature_seed_on_a_plane(jax_side):
    """The stop at curvature 0 (compiled surface 2): the port's conic path
    moves each intersection by r^2 / 2 in z, the JAX package's plane branch
    not at all; the stop is an evaluation surface, so the landing points
    agree."""
    import prysm_tpu.x.materials as jmat
    import prysm_tpu_torch.x.materials as tmat
    jsys, tsys = _flat_stop(jrt, jsr, jmat), _flat_stop(trt, tsr, tmat)
    j = jd.raytrace_with_tangents(jsys.to_surfaces(), jax_side.P, jax_side.S, WVL,
                                  [jd.seed_curvature(2)])
    t = td.raytrace_with_tangents(tsys.to_surfaces(), jax_side.P, jax_side.S, WVL,
                                  [td.seed_curvature(2)])
    at_stop = np.asarray(j.P)[3]
    assert np.abs(j.Pdot[3]).max() == 0.0
    r2 = at_stop[:, 0] ** 2 + at_stop[:, 1] ** 2
    assert np.abs(t.Pdot[3, :, 2, 0] - r2 / 2).max() <= 1e-12 * r2.max()
    assert _rel(t.Pdot[-1], j.Pdot[-1]) <= BAR


def test_multi_objective_sensitivity_and_namespace(jax_side):
    """``system.tol.adjoint_sensitivity`` on duck-typed perturbations (slot,
    lensdata, name), the JAX package's ``Perturbation`` slots."""
    jsys, tsys = doublet(jrt, jsr), doublet(trt, tsr)
    jp = [Perturbation.normal(jsys, 'curvature', 3, 1e-6, name='c3'),
          Perturbation.normal(jsys, 'thickness', 3, 1e-5, name='t3')]
    tp = [types.SimpleNamespace(slot=p.slot, lensdata=tsys.lens, name=p.name) for p in jp]
    j = jsys.tol.adjoint_sensitivity(jp, heads(ja)[:2], jax_side.P, jax_side.S, WVL)
    t = tsys.tol.adjoint_sensitivity(tp, heads(ta)[:2], jax_side.P, jax_side.S, WVL)
    assert t.head_names == j.head_names and t.param_names == j.param_names == ['c3', 't3']
    assert _rel(t.jacobian, j.jacobian) <= BAR
    assert t.ranked_by('rms_spot')[0][0] == j.ranked_by('rms_spot')[0][0]
    np.testing.assert_allclose(t.sensitivity_for(1), j.sensitivity_for(1), rtol=1e-10)
    for name in j.nominals:
        assert t.nominals[name] == pytest.approx(j.nominals[name], rel=1e-13)
    budget = [1e-3, 2e-4]
    np.testing.assert_allclose(tsys.tol.inverse_sensitivity(t.jacobian, budget),
                               ja.inverse_sensitivity(j.jacobian, budget), rtol=1e-10)
    seed_t, seed_j = ta.seed_from_perturbation(tp[1]), ja.seed_from_perturbation(jp[1])
    assert sorted(seed_t.pose) == sorted(seed_j.pose)
    for k in seed_j.pose:
        np.testing.assert_allclose(seed_t.pose[k][0], seed_j.pose[k][0], atol=1e-9)


J = np.array([[2.0, 0.0, 1.0, -3.0], [0.0, 4.0, 0.5, 1e-3]])


@pytest.mark.parametrize('fn', [
    lambda m: m.inverse_sensitivity(J, 1e-2),
    lambda m: m.inverse_sensitivity(J, [1e-2, 3e-2], steps_min=[1e-3] * 4, steps_max=[5e-3] * 4),
    lambda m: m.multi_objective_budget(J, [1e-2, 4e-2]),
    lambda m: m.rss_prediction(J, [1.0, 0.5, 0.2, 0.1]),
    lambda m: m.compensated_jacobian(J, J[:, :1])[0],
    lambda m: m.compensated_jacobian(J, J[:, :1])[1],
    lambda m: m.ToleranceSensitivityTable(
        m.AdjointResult(J, ['a', 'b'], list('wxyz'), {}), [1, 2, 3, 4]).degradation_at_step(),
    lambda m: m.ToleranceSensitivityTable(
        m.AdjointResult(J, ['a', 'b'], list('wxyz'), {}), [1, 2, 3, 4]).sensitivity(),
], ids=['inverse', 'inverse-clipped', 'budget', 'rss', 'compensated', 'motions', 'degradation',
        'sensitivity'])
def test_tolerance_linear_algebra_matches_jax(fn):
    np.testing.assert_allclose(fn(ta), fn(ja), rtol=1e-13, atol=1e-16)


# ---------- per-primitive differentials -------------------------------------

def _primitive_inputs():
    rng = np.random.default_rng(11)
    S = rng.normal(size=(6, 3)) * 0.1 + [0, 0, 1]
    S /= np.linalg.norm(S, axis=1, keepdims=True)
    n_hat = rng.normal(size=(6, 3)) * 0.1 + [0, 0, 1]
    n_hat /= np.linalg.norm(n_hat, axis=1, keepdims=True)
    P = rng.normal(size=(6, 3))
    return rng, P, S, n_hat


def _forward(m):
    rng, P, S, n_hat = _primitive_inputs()
    Pd, Sd, Nd = (rng.normal(size=(6, 3, 2)) for _ in range(3))
    C, Cd = np.array([0.1, -0.2, 30.0]), rng.normal(size=(3, 2))
    R = np.eye(3) + 0.01 * rng.normal(size=(3, 3))
    return {
        'refract': lambda: m.d_refract(1.0, 1.5, S, n_hat, Sd, Nd, np.array([0.0, 1.0]),
                                       np.array([1.0, 0.0])),
        'reflect': lambda: m.d_reflect(S, n_hat, Sd, Nd),
        'transform_local': lambda: m.d_transform_local(P, S, C, R, Pd, Sd, Cd,
                                                       rng.normal(size=(3, 3, 2))),
        'transform_global': lambda: m.d_transform_global(P, S, C, None, Pd, Sd, Cd, None),
        'opl_segment': lambda: m.d_opl_segment(1.5, np.array([0.1, 0.0]), P, Pd, S=S),
        'closest_point': lambda: m.d_closest_point_on_axis(P[0], S[0], Pd[0], Sd[0],
                                                           np.zeros(3), np.array([0., 0., 1.])),
        'eic_closing': lambda: m.d_eic_closing(P, S, Pd, Sd, C, Cd, 0.02, np.array([1e-3, 0.0])),
    }


def _reverse(m):
    rng, P, S, n_hat = _primitive_inputs()
    bar = rng.normal(size=(6, 3))
    C = np.array([0.1, -0.2, 30.0])
    return {
        'refract': lambda: m.adj_refract(1.0, 1.5, S, n_hat, bar),
        'reflect': lambda: m.adj_reflect(S, n_hat, bar),
        'transform_local': lambda: m.adj_transform_local(P, S, C, np.eye(3), bar, bar[::-1]),
        'transform_global': lambda: m.adj_transform_global(P, S, C, None, bar, bar[::-1]),
        'opl_segment': lambda: m.adj_opl_segment(1.5, P, bar[:, 0]),
        'closest_point': lambda: m.adj_closest_point_on_axis(P[0], S[0], np.zeros(3),
                                                             np.array([0., 0., 1.]), bar[0]),
        'eic_closing': lambda: m.adj_eic_closing(P, S, C, 0.02, bar[:, 0]),
        'eic_closing_full': lambda: m.adj_eic_closing_full(P, S, C, 0.02, bar[:, 0],
                                                           n_image=1.2, OPL_bar=bar[:, 1]),
    }


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flat(o)]
    return [] if out is None else [np.asarray(out, dtype=float)]


@pytest.mark.parametrize('name', sorted(_forward(jd)))
def test_forward_primitives_match_jax(name):
    j, t = _flat(_forward(jd)[name]()), _flat(_forward(td)[name]())
    assert len(j) == len(t)
    for a, b in zip(t, j):
        assert _rel(a, b) <= 1e-12


@pytest.mark.parametrize('name', sorted(_reverse(ja)))
def test_reverse_primitives_match_jax(name):
    j, t = _flat(_reverse(ja)[name]()), _flat(_reverse(ta)[name]())
    assert len(j) == len(t)
    for a, b in zip(t, j):
        assert _rel(a, b) <= 1e-12


# ---------- paraxial tangents -------------------------------------------------

def _paraxial_seeds(m):
    return [m.seed_curvature(3), m.seed_despace([(4, 1), (5, 1)], name='t'), m.seed_index(3),
            m.seed_curvature(5)]


@pytest.mark.parametrize('which', ['matrix', 'ep_z', 'xp_z'])
def test_paraxial_tangents_match_jax(which):
    jsys, tsys = doublet(jrt, jsr), doublet(trt, tsr)

    def run(m, system):
        surfaces = system.to_surfaces()
        if which == 'matrix':
            M, n, Md, nd = m.paraxial_system_matrix_tangents(surfaces, WVL, _paraxial_seeds(m))
            return [M, np.asarray(n), Md, nd]
        fn = {'ep_z': m.paraxial_entrance_pupil_z_tangents,
              'xp_z': m.paraxial_exit_pupil_z_tangents}[which]
        return [fn(surfaces, WVL, _paraxial_seeds(m), stop_index=2)]

    for a, b in zip(run(td, tsys), run(jd, jsys)):
        assert _rel(a, b) <= 1e-12


@pytest.mark.parametrize('aperture', ['epd', 'fno'])
def test_paraxial_launch_tangents_match_jax(aperture):
    def system(rt, sr):
        spec = rt.ApertureSpec.epd(10.0) if aperture == 'epd' else rt.ApertureSpec.fno(8.0)
        return rt.OpticalSystem(sr.doublet(), aperture=spec, fields=[0.0, 3.0],
                                wavelengths=[WVL], stop_index=2)

    jsys, tsys = system(jrt, jsr), system(trt, tsr)
    j = jd.paraxial_launch_tangents(jsys, jsys.field(1), WVL, jrt.Sampling.hex(2),
                                    _paraxial_seeds(jd))
    t = td.paraxial_launch_tangents(tsys, tsys.field(1), WVL, trt.Sampling.hex(2),
                                    _paraxial_seeds(td))
    # an F/# pupil scales with the focal length, which every seed moves
    assert (np.abs(j[0]).max() > 0) == (aperture == 'fno')
    for a, b in zip(t, j):
        assert np.abs(a - b).max() <= 1e-12 * max(np.abs(b).max(), 1.0)
