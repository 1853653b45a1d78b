"""The port's trace kernel against the JAX package, in float64 on the CPU.

The same numpy rays go through ``raytrace`` in both packages: cfg6's
merged trace at ``hex(16)``, one single-surface trace for every shape kind
of ``surfaces.py``'s table, bundles built to reach each failure code (TIR,
miss, clip, Newton, evanescent), a mirror and a ``LinearGrating``, and a
prescription carried over by ``interop.surfaces_from_numpy``.  Bars:
positions and OPL within 1e-11 mm, direction cosines within 1e-12, and
equal status; ``fit_from_trace`` within 1e-10.  The JAX package's traces of
``both`` are read from their records (``_jax_refs``) where they are current.
"""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _jax_refs import jax_ref
import prysm_tpu.x.materials as jmat
import prysm_tpu.x.raytracing as jrt
from prysm_tpu.x.raytracing import batch as jbatch
import prysm_tpu_torch.x.materials as tmat
import prysm_tpu_torch.x.raytracing as trt
from prysm_tpu_torch import interop
from prysm_tpu_torch.conf import config
from prysm_tpu_torch.x.raytracing import batch as tbatch

torch.set_num_threads(2)
WVL = 0.55
POS_TOL, DIR_TOL = 1e-11, 1e-12


@pytest.fixture(autouse=True)
def f64_on_cpu(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def assert_same_trace(t, j, pos_tol=POS_TOL, dir_tol=DIR_TOL):
    """Equal status; P and OPL within pos_tol, S within dir_tol (NaN where NaN)."""
    np.testing.assert_array_equal(_np(t.status), np.asarray(j.status))
    for name, tol in (('P', pos_tol), ('S', dir_tol), ('OPL', pos_tol)):
        got, want = _np(getattr(t, name)), np.asarray(getattr(j, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


def codes(result):
    return set(np.imag(_np(result.status)).astype(int).tolist())


def ray_grid(half=4.0, n=9, z=-5.0, tilt=(0.02, -0.03)):
    """(P, S) numpy: an n x n grid of rays over [-half, half]^2, slightly tilted."""
    u = np.linspace(-half, half, n)
    X, Y = np.meshgrid(u, u)
    P = np.stack([X.ravel(), Y.ravel(), np.full(X.size, z)], axis=1)
    S = np.tile([tilt[0], tilt[1], 1.0], (X.size, 1))
    return P, S / np.linalg.norm(S, axis=1, keepdims=True)


def _jax_trace(build, P, S, kw):
    j = jrt.raytrace(build(jrt, jmat), jnp.asarray(P), jnp.asarray(S), WVL, **kw)
    out = {k: getattr(j, k) for k in ('P', 'S', 'OPL', 'status')}
    if kw.get('keep_intermediates'):
        out['intermediates'] = [{'Q_loc': i.Q_loc, 'n_hat': i.n_hat} for i in j.intermediates]
    return out


def both(build, P, S, **kw):
    """(port result, JAX result) of the surfaces build(rt, mat) on the same rays."""
    t = trt.raytrace(build(trt, tmat), P, S, WVL, **kw)
    j = types.SimpleNamespace(**jax_ref('trace', _jax_trace, build, P, S, kw, bar=1e-13))
    if kw.get('keep_intermediates'):
        j.intermediates = [types.SimpleNamespace(**i) for i in j.intermediates]
    return t, j


SHAPES = {
    'plane': lambda rt: rt.Plane(),
    'sphere': lambda rt: rt.Sphere(1 / 50.0),
    'conic': lambda rt: rt.Conic(1 / 50.0, -0.5),
    'off_axis_conic': lambda rt: rt.OffAxisConic(1 / 50.0, -0.5, dx=10.0, dy=5.0),
    'even_asphere': lambda rt: rt.EvenAsphere(1 / 50.0, -0.5, (1e-4, 1e-6)),
    'q2d': lambda rt: rt.Q2D(1 / 50.0, -0.5, 10.0, (0.0, 1e-3), ((1e-4,),), ((0.0,),),
                             dx=0.0, dy=0.0),
    'zernike': lambda rt: rt.Zernike(1 / 50.0, -0.5, 10.0, [(2, 0), (4, 0), (3, 1)],
                                     (1e-3, 2e-4, 3e-4), norm=True),
    'xy': lambda rt: rt.XY(1 / 50.0, -0.5, 10.0, [(2, 0), (0, 2)], (1e-4, 2e-4)),
    'chebyshev': lambda rt: rt.Chebyshev(1 / 50.0, -0.5, 10.0, 10.0, [(2, 0), (0, 2)],
                                         (1e-4, 2e-4)),
    'jacobi': lambda rt: rt.Jacobi(1 / 50.0, -0.5, 10.0, 0.0, 0.0, [2, 4], (1e-3, 2e-4)),
    'toroid': lambda rt: rt.Toroid(1 / 50.0, 1 / 40.0, -0.3, (1e-4,)),
    'biconic': lambda rt: rt.Biconic(1 / 50.0, 1 / 40.0, -0.2, -0.3),
}


def test_every_shape_kind_is_covered():
    from prysm_tpu.x.raytracing.surfaces import SHAPE_MODELS as j_kinds
    from prysm_tpu_torch.x.raytracing.surfaces import SHAPE_MODELS as t_kinds
    assert set(SHAPES) == set(j_kinds) == set(t_kinds)


@pytest.mark.parametrize('kind', sorted(SHAPES))
@pytest.mark.parametrize('clip', [None, 5.0], ids=['open', 'clip5'])
def test_single_surface_trace(kind, clip):
    """Refraction into n = 1.5 through one surface of each kind, then an eval plane."""
    def build(rt, mat):
        return [rt.Surface(shape=SHAPES[kind](rt), interaction='refract', P=[0.0, 0.0, 0.0],
                           material=mat.ConstantMaterial(1.5), aperture=clip),
                rt.Surface(shape=rt.Plane(), interaction='eval', P=[0.0, 0.0, 30.0])]

    P, S = ray_grid(half=6.0)
    t, j = both(build, P, S)
    assert_same_trace(t, j)
    assert (STATUS_CLIP in codes(t)) == (clip is not None)


STATUS_TIR, STATUS_MISS, STATUS_CLIP, STATUS_NEWTON, STATUS_EVANESCENT = -2, -1, 2, 1, -3


def _tir(rt, mat):
    # into n = 1.5 through a plane, out through a strongly curved sphere:
    # rays above ~4 mm meet it past the critical angle
    return [rt.Surface(shape=rt.Plane(), interaction='refract', P=[0.0, 0.0, 0.0],
                       material=mat.ConstantMaterial(1.5)),
            rt.Surface(shape=rt.Sphere(-1 / 6.0), interaction='refract', P=[0.0, 0.0, 10.0],
                       material=mat.air),
            rt.Surface(shape=rt.Plane(), interaction='eval', P=[0.0, 0.0, 30.0])]


def _miss(rt, mat):
    # a sphere of radius 3 under rays out to 5.6 mm
    return [rt.Surface(shape=rt.Sphere(1 / 3.0), interaction='refract', P=[0.0, 0.0, 0.0],
                       material=mat.ConstantMaterial(1.5)),
            rt.Surface(shape=rt.Plane(), interaction='eval', P=[0.0, 0.0, 30.0])]


def _clip(rt, mat):
    return [rt.Surface(shape=rt.Sphere(1 / 40.0), interaction='refract', P=[0.0, 0.0, 0.0],
                       material=mat.ConstantMaterial(1.5), aperture=2.5),
            rt.Surface(shape=rt.Plane(), interaction='eval', P=[0.0, 0.0, 30.0])]


def _newton(rt, mat):
    # an asphere on a radius-3 base: outside the base's domain the sag is not
    # real, Newton does not converge, and the departure band's rescue marches
    return [rt.Surface(shape=rt.EvenAsphere(1 / 3.0, 0.0, (1e-3,)), interaction='refract',
                       P=[0.0, 0.0, 0.0], material=mat.ConstantMaterial(1.5)),
            rt.Surface(shape=rt.Plane(), interaction='eval', P=[0.0, 0.0, 30.0])]


def _evanescent(rt, mat):
    # a grating whose first order is evanescent for part of the fan
    grating = rt.LinearGrating(period=4e-4, g_vec=(0.0, 1.0), order=1)
    return [rt.Surface(shape=rt.Plane(), interaction='refract', P=[0.0, 0.0, 0.0],
                       material=mat.ConstantMaterial(1.5), grating=grating),
            rt.Surface(shape=rt.Plane(), interaction='eval', P=[0.0, 0.0, 30.0])]


@pytest.mark.parametrize('build, code', [
    (_tir, STATUS_TIR), (_miss, STATUS_MISS), (_clip, STATUS_CLIP),
    (_newton, STATUS_NEWTON), (_evanescent, STATUS_EVANESCENT)],
    ids=['tir', 'miss', 'clip', 'newton', 'evanescent'])
def test_failure_codes(build, code):
    P, S = ray_grid(half=5.6, n=15)
    if code == STATUS_EVANESCENT:
        # a fan of directions, -0.6 to 0.6 rad in y: the kicked order turns
        # evanescent on one side of it only
        theta = np.linspace(-0.6, 0.6, P.shape[0])
        S = np.stack([np.zeros_like(theta), np.sin(theta), np.cos(theta)], axis=1)
    t, j = both(build, P, S)
    assert_same_trace(t, j)
    assert code in codes(t) and 0 in codes(t)
    decoded = trt.decode_status(t.status)
    np.testing.assert_array_equal(decoded, jrt.decode_status(np.asarray(j.status)))
    assert int(trt.valid_mask(t.status).sum()) == int(np.asarray(jrt.valid_mask(j.status)).sum())


def test_mirror_and_grating():
    """A concave mirror folds the bundle back; a grating on a refracting plane kicks it."""
    def mirror(rt, mat):
        return [rt.Surface(shape=rt.Sphere(-1 / 100.0), interaction='reflect',
                           P=[0.0, 0.0, 0.0]),
                rt.Surface(shape=rt.Plane(), interaction='eval', P=[0.0, 0.0, -40.0])]

    def grating(rt, mat):
        g = rt.LinearGrating(period=2e-3, g_vec=(0.3, 1.0), order=-2)
        return [rt.Surface(shape=rt.Sphere(1 / 80.0), interaction='refract',
                           P=[0.0, 0.0, 0.0], material=mat.ConstantMaterial(1.5), grating=g),
                rt.Surface(shape=rt.Plane(), interaction='eval', P=[0.0, 0.0, 30.0])]

    P, S = ray_grid()
    for build in (mirror, grating):
        t, j = both(build, P, S)
        assert_same_trace(t, j)
        assert codes(t) == {0}
    assert float(_np(both(mirror, P, S)[0].S)[-1, :, 2].max()) < 0


def test_tilted_decentered_surfaces():
    """Host poses with tilt and decenter, and a keep_intermediates trace."""
    def build(rt, mat):
        return [rt.Surface(shape=rt.Conic(1 / 60.0, -1.0), interaction='refract',
                           P=[0.0, 0.0, 0.0], tilt=(0.0, 3.0, -2.0), decenter=(0.1, -0.2, 0.0),
                           material=mat.ConstantMaterial(1.6)),
                rt.Surface(shape=rt.Sphere(-1 / 70.0), interaction='refract',
                           P=[0.0, 0.0, 5.0], R=[5.0, 0.0, 1.0],
                           material=mat.air),
                rt.Surface(shape=rt.Plane(), interaction='eval', P=[0.0, 0.0, 60.0])]

    P, S = ray_grid()
    t, j = both(build, P, S, keep_intermediates=True)
    assert_same_trace(t, j)
    assert len(t.intermediates) == len(j.intermediates) == 3
    for a, b in zip(t.intermediates, j.intermediates):
        np.testing.assert_allclose(_np(a.Q_loc), np.asarray(b.Q_loc), rtol=0, atol=POS_TOL)
        np.testing.assert_allclose(_np(a.n_hat), np.asarray(b.n_hat), rtol=0, atol=DIR_TOL)


def cfg6(rt, mat):
    bk7 = mat.model_glass(1.5168, 64.17, name='BK7ish')
    sf5 = mat.model_glass(1.6727, 32.2, name='SF5ish')
    lens = rt.LensData()
    lens.add(rt.Sphere(1 / 62.0), thickness=6.0, material=bk7)
    lens.add(rt.Sphere(-1 / 45.0), thickness=3.0, material=sf5)
    lens.add(rt.Sphere(-1 / 128.0), thickness=95.0, material=mat.air)
    return rt.OpticalSystem(lens, aperture=rt.ApertureSpec.epd(20.0),
                            fields=[0.0, 1.0, 2.0], wavelengths=[WVL], stop_index=1)


def test_cfg6_merged_trace_hex16():
    jw, (jres,) = jbatch.merged_trace(cfg6(jrt, jmat), sampling=jrt.Sampling.hex(16))
    tw, (tres,) = tbatch.merged_trace(cfg6(trt, tmat), sampling=trt.Sampling.hex(16))
    assert tw == jw == [WVL]
    assert tuple(tres.P.shape) == (6, 3 * 817, 3) and tres.status.dtype == torch.complex128
    assert_same_trace(tres, jres)
    assert codes(tres) == {0} and set(np.real(_np(tres.status)).tolist()) == {5.0}
    np.testing.assert_allclose(_np(tbatch.unmerge(tres.P, 3)), np.asarray(jbatch.unmerge(jres.P, 3)),
                               rtol=0, atol=POS_TOL)


def test_steps_cfg6_trace_is_the_merged_trace():
    from prysm_tpu_torch import steps
    tres = steps.build_cfg6_trace(trt.Sampling.hex(16), device='cpu')()
    _, (jres,) = jbatch.merged_trace(cfg6(jrt, jmat), sampling=jrt.Sampling.hex(16))
    assert_same_trace(tres, jres)


def test_fit_from_trace():
    rng = np.random.default_rng(2)
    F, N, K = 3, 40, 6
    P_end = rng.normal(size=(F, N, 3)) + [0.0, 0.0, 100.0]
    S_end = rng.normal(scale=0.05, size=(F, N, 3)) + [0.0, 0.0, 1.0]
    S_end /= np.linalg.norm(S_end, axis=-1, keepdims=True)
    OPL = rng.normal(scale=1e-3, size=(F, N)) + 150.0
    alive = rng.random((F, N)) > 0.1
    alive[:, 0] = True
    A = rng.normal(size=(F, N, K))
    ramps = rng.normal(scale=1e-2, size=(F, N))
    onehot = np.zeros((F, N))
    onehot[:, 0] = 1.0
    P_xp = np.asarray([0.0, 0.0, 40.0])
    for xp in (P_xp, None):
        jc, jr = jbatch.fit_from_trace(*(jnp.asarray(a) for a in (P_end, S_end, OPL, alive, A,
                                                                   ramps, onehot)),
                                       None if xp is None else jnp.asarray(xp), 1.0)
        tc, tr = tbatch.fit_from_trace(*(torch.as_tensor(a) for a in (P_end, S_end, OPL, alive, A,
                                                                       ramps, onehot)),
                                       None if xp is None else torch.as_tensor(xp), 1.0)
        np.testing.assert_allclose(_np(tc), np.asarray(jc), rtol=0,
                                   atol=1e-10 * np.abs(np.asarray(jc)).max())
        np.testing.assert_allclose(_np(tr), np.asarray(jr), rtol=1e-10, atol=0)


def _rows(surfaces):
    """The JAX package's compiled surfaces flattened to numpy rows."""
    rows = []
    for s in surfaces:
        mat = getattr(s, 'material', None)
        if mat is None:
            material = None
        elif hasattr(mat, 'coefficients'):
            material = (mat.formula.__name__, np.asarray(mat.coefficients))
        else:
            material = float(mat.n(WVL))
        clip = s.aperture.clip
        rows.append({
            'kind': s.shape.kind,
            'params': {k: (np.asarray(v) if isinstance(v, (tuple, list, float)) else v)
                       for k, v in s.shape.params.items()},
            'P': np.asarray(s.P), 'R': None if s.R is None else np.asarray(s.R),
            'interaction': s.typ, 'material': material,
            'clip': None if clip is None else ('circular', clip.radius, clip.x0, clip.y0)})
    return rows


def test_surfaces_from_numpy_carries_a_jax_prescription():
    """cfg6 plus a clipped Zernike freeform, flattened from the JAX package, trace alike."""
    js = cfg6(jrt, jmat).to_surfaces()
    js = js[:4] + [jrt.Surface(shape=SHAPES['zernike'](jrt), interaction='refract',
                               P=[0.0, 0.0, 60.0], material=jmat.model_glass(1.6, 40.0),
                               aperture=8.0),
                   jrt.Surface(shape=jrt.Plane(), interaction='eval', P=[0.0, 0.0, 104.0])]
    ts = interop.surfaces_from_numpy(_rows(js), device='cpu', dtype=torch.float64)
    assert [s.shape.kind for s in ts] == [s.shape.kind for s in js]
    for a, b in zip(ts, js):
        assert a.shape.params == b.shape.params
        key = (torch.device('cpu'), torch.float64)
        assert key in a._pose_tensors
    P, S = ray_grid(half=6.0, z=-2.0)
    t = trt.raytrace(ts, P, S, WVL)
    j = jrt.raytrace(js, jnp.asarray(P), jnp.asarray(S), WVL)
    assert_same_trace(t, j)
    assert 0 in codes(t)


def test_host_pose_is_copied_once_per_device_and_dtype():
    s = trt.Surface(shape=trt.Sphere(0.01), interaction='refract', P=[0.0, 0.0, 5.0],
                    material=tmat.ConstantMaterial(1.5))
    ref64 = torch.zeros(1, 3, dtype=torch.float64)
    P1, _ = s.pose_like(ref64)
    P2, _ = s.pose_like(ref64)
    assert P1 is P2 and P1.dtype == torch.float64
    P3, _ = s.pose_like(ref64.float())
    assert P3.dtype == torch.float32 and P3 is not P1
    s.P = np.asarray([0.0, 0.0, 6.0])
    assert float(s.pose_like(ref64)[0][2]) == 6.0


def test_tensor_pose_keeps_its_graph():
    z = torch.tensor(4.0, dtype=torch.float64, requires_grad=True)
    surfs = [trt.Surface(shape=trt.Sphere(1 / 30.0), interaction='refract', P=[0.0, 0.0, z],
                         material=tmat.ConstantMaterial(1.5)),
             trt.Surface(shape=trt.Plane(), interaction='eval', P=[0.0, 0.0, 40.0])]
    P, S = ray_grid(n=3)
    res = trt.raytrace(surfs, P, S, WVL)
    res.OPL.sum().backward()
    assert z.grad is not None and torch.isfinite(z.grad)


def test_newton_loop_leaves_early_with_the_same_result(monkeypatch):
    """Checking for frozen rays every iteration or never gives one result."""
    from prysm_tpu_torch.x.raytracing import spencer_and_murty as sm

    def build(rt, mat):
        return [rt.Surface(shape=SHAPES['even_asphere'](rt), interaction='refract',
                           P=[0.0, 0.0, 0.0], material=mat.ConstantMaterial(1.5)),
                rt.Surface(shape=rt.Plane(), interaction='eval', P=[0.0, 0.0, 30.0])]

    P, S = ray_grid()
    out = []
    for every in (1, 10 ** 9):
        monkeypatch.setattr(sm, 'NEWTON_CHECK_EVERY', every)
        out.append(trt.raytrace(build(trt, tmat), P, S, WVL))
    for name in ('P', 'S', 'OPL', 'status'):
        assert torch.equal(torch.nan_to_num(getattr(out[0], name)),
                           torch.nan_to_num(getattr(out[1], name)))
