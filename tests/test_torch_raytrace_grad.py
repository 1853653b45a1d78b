"""Gradients through the port's trace (autograd) against ``jax.grad``.

Mirrors ``tests/test_raytracing.py``'s capability tests (d(spot)/d(c)
through the closed-form trace and d(image y)/d(a4) through the Newton
intersect) and cfg6's curvature gradient (``steps.build_cfg6_grad``), each
within 1e-9 relative of ``jax.grad`` in float64 on the CPU.  A tensor
curvature is never static: at c = 0 it keeps the conic code paths and its
gradient (the JAX package's eager ``jax.grad`` sees a concrete 0 there and
takes the plane branch, which loses d/dc for the closed-form sphere).
The JAX package's side is read from its record (``_jax_refs``) where it is
current.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _jax_refs import jax_ref
import prysm_tpu.x.materials as jmat
import prysm_tpu.x.raytracing as jrt
import prysm_tpu_torch.x.materials as tmat
import prysm_tpu_torch.x.raytracing as trt
from prysm_tpu_torch import steps
from prysm_tpu_torch.conf import config

torch.set_num_threads(2)
WVL = 0.5876
NBK7 = 1.5168
REL = 1e-9


@pytest.fixture(autouse=True)
def f64_on_cpu(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _fan(n=5, maxr=8.0):
    y = np.linspace(-maxr, maxr, n)
    P = np.stack([np.zeros(n), y, np.full(n, -5.0)], axis=1)
    S = np.tile([0.0, 0.0, 1.0], (n, 1))
    return P, S


def port_grad(f, x0):
    x = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
    value = f(x)
    g, = torch.autograd.grad(value, x)
    return float(value.detach()), g.numpy()


def close(got, want, rel=REL):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert np.all(np.isfinite(got))
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (got, want)


def singlet(rt, mat, c):
    return [rt.Surface(shape=rt.Sphere(c), interaction='refract', P=[0, 0, 0.0],
                       material=mat.ConstantMaterial(NBK7)),
            rt.Surface(shape=rt.Sphere(-c), interaction='refract', P=[0, 0, 4.0],
                       material=mat.ConstantMaterial(1.0)),
            rt.Surface(shape=rt.Plane(), interaction='eval', P=[0, 0, 50.0])]


def test_grad_through_trace():
    """d(RMS image height)/d(curvature) through the closed-form spheres."""
    P, S = _fan()

    def spot(rt, mat, xp, Pa, Sa):
        def f(c):
            y = rt.raytrace(singlet(rt, mat, c), Pa, Sa, WVL).P[-1][:, 1]
            return xp.sqrt(xp.mean(y * y))
        return f

    c0 = 1 / 50.0
    jv, jg = jax_ref('trace', lambda P, S, c0: jax.value_and_grad(
        spot(jrt, jmat, jnp, jnp.asarray(P), jnp.asarray(S)))(c0), P, S, c0, bar=(1e-12, REL))
    tv, tg = port_grad(spot(trt, tmat, torch, P, S), c0)
    assert tv == pytest.approx(float(jv), rel=1e-12)
    close(tg, jg)


def asphere(rt, mat, a4, c=1 / 60.0):
    return [rt.Surface(shape=rt.EvenAsphere(c, -0.5, [a4]), interaction='refract',
                       P=[0, 0, 0.0], material=mat.ConstantMaterial(NBK7)),
            rt.Surface(shape=rt.Plane(), interaction='refract', P=[0, 0, 6.0],
                       material=mat.ConstantMaterial(1.0)),
            rt.Surface(shape=rt.Plane(), interaction='eval', P=[0, 0, 80.0])]


def test_grad_through_newton_intersect():
    """d(image y)/d(a4) through the seeded Newton solve and its polish step."""
    P = np.asarray([[0.0, 6.0, -5.0]])
    S = np.asarray([[0.0, 0.0, 1.0]])
    a0 = 1e-6
    jg = jax_ref('newton', lambda P, S, a0: jax.grad(lambda a: jrt.raytrace(
        asphere(jrt, jmat, a), jnp.asarray(P), jnp.asarray(S), WVL).P[-1][0, 1])(a0),
        P, S, a0, bar=REL)
    _, tg = port_grad(lambda a: trt.raytrace(asphere(trt, tmat, a), P, S, WVL).P[-1][0, 1], a0)
    close(tg, jg)


def _cfg6_loss_jax(sampling):
    """The JAX package's cfg6 spot loss as a function of the three curvatures.

    The same composition as ``steps.build_cfg6_grad``: spheres rebuilt with
    traced curvatures on ``to_surfaces()``'s poses and materials, the mean
    over fields of the RMS spot radius about each field's chief ray.
    """
    from prysm_tpu.x.raytracing.batch import _chief_indices, _host_launches
    bk7 = jmat.model_glass(1.5168, 64.17, name='BK7ish')
    sf5 = jmat.model_glass(1.6727, 32.2, name='SF5ish')
    lens = jrt.LensData()
    lens.add(jrt.Sphere(1 / 62.0), thickness=6.0, material=bk7)
    lens.add(jrt.Sphere(-1 / 45.0), thickness=3.0, material=sf5)
    lens.add(jrt.Sphere(-1 / 128.0), thickness=95.0, material=jmat.air)
    system = jrt.OpticalSystem(lens, aperture=jrt.ApertureSpec.epd(20.0),
                               fields=[0.0, 1.0, 2.0], wavelengths=[0.55], stop_index=1)
    base = system.to_surfaces()
    P, S = _host_launches(system, list(system.fields), 0.55, sampling, None)
    F, N = P.shape[:2]
    chiefs = _chief_indices(P)
    Pj, Sj = jnp.asarray(P.reshape(-1, 3)), jnp.asarray(S.reshape(-1, 3))

    def loss(c):
        surfs, k = [], 0
        for s in base:
            if s.shape.kind == 'sphere':
                s = jrt.Surface(shape=jrt.Sphere(c[k]), interaction=s.typ, P=s.P, R=s.R,
                                material=s.material, aperture=s.aperture)
                k += 1
            surfs.append(s)
        res = jrt.raytrace(surfs, Pj, Sj, 0.55)
        xy = res.P[-1][:, :2].reshape(F, N, 2)
        chief = xy[jnp.arange(F), chiefs]
        r2 = ((xy - chief[:, None]) ** 2).sum(-1)
        return jnp.sqrt(r2.mean(-1)).mean()

    return loss


def _jax_cfg6(nrings, c0):
    """The loss and gradient at ``c0``, and the gradient at another point of the design
    space, as an optimizer's next step takes it."""
    loss_j = _cfg6_loss_jax(jrt.Sampling.hex(nrings))
    c0 = jnp.asarray(c0)
    jv, jg = jax.value_and_grad(loss_j)(c0)
    c1 = c0 * jnp.asarray([1.01, 0.98, 1.05])
    return float(jv), jg, c1, jax.grad(loss_j)(c1)


@pytest.mark.parametrize('nrings', [8, 16])
def test_cfg6_curvature_gradient(nrings):
    jv, jg, c1, jg1 = jax_ref('cfg6', _jax_cfg6, nrings, steps.CFG6_CURVATURES,
                              bar=(1e-12, REL, REL, REL))
    step = steps.build_cfg6_grad(trt.Sampling.hex(nrings), device='cpu')
    tv, tg, rms = step()
    assert float(tv) == pytest.approx(float(jv), rel=1e-12)
    assert rms.shape == (3,)
    close(tg.numpy(), jg)
    close(step(torch.tensor(np.asarray(c1)))[1].numpy(), jg1)


def test_tensor_zero_is_never_static():
    from prysm_tpu_torch.x.raytracing.intersections import _statically_zero
    from prysm_tpu_torch.x.raytracing.sagjets import is_concrete_zero
    from prysm_tpu_torch.x.raytracing.surfaces import _concrete_float
    zero = torch.tensor(0.0, dtype=torch.float64)
    assert not _statically_zero(zero) and not is_concrete_zero(zero)
    assert _statically_zero(0.0) and _statically_zero(np.float64(0.0))
    assert _concrete_float(zero) is None and _concrete_float(np.float32(2.5)) == 2.5


def test_sphere_gradient_at_zero_curvature():
    """A tensor c = 0 traces as the plane and keeps d/dc (the closed-form conic
    root is taken multiplied through by c).  jax.grad there takes the plane
    branch and gives 0; the bar is the JAX package's own central difference."""
    P, S = _fan(n=7, maxr=6.0)

    def jspot(c):
        y = jrt.raytrace(singlet(jrt, jmat, c), jnp.asarray(P), jnp.asarray(S), WVL).P[-1][:, 1]
        return float(jnp.sqrt(jnp.mean(y * y)))

    def tspot(c):
        y = trt.raytrace(singlet(trt, tmat, c), P, S, WVL).P[-1][:, 1]
        return torch.sqrt(torch.mean(y * y))

    h = 1e-6
    g0, up, down, at0 = jax_ref('sphere-zero', lambda P, S, h: (float(jax.grad(
        lambda c: jnp.sqrt(jnp.mean(jrt.raytrace(singlet(jrt, jmat, c), jnp.asarray(P),
                                                 jnp.asarray(S), WVL).P[-1][:, 1] ** 2)))(0.0)),
        jspot(h), jspot(-h), jspot(0.0)), P, S, h, bar=1e-13)
    assert g0 == 0.0
    fd = (up - down) / (2 * h)
    tv, tg = port_grad(tspot, 0.0)
    assert tv == pytest.approx(at0, rel=1e-13)
    assert abs(fd) > 1.0
    assert float(tg) == pytest.approx(fd, rel=1e-6)
    # the plane's trace, value for value
    plane = trt.raytrace(singlet(trt, tmat, torch.tensor(0.0, dtype=torch.float64)), P, S, WVL)
    flat = trt.raytrace(singlet(trt, tmat, 0.0), P, S, WVL)
    np.testing.assert_allclose(plane.P.detach().numpy(), flat.P.numpy(), rtol=0, atol=1e-13)


@pytest.mark.parametrize('kind', ['even_asphere', 'zernike'])
def test_freeform_gradient_at_zero_curvature(kind):
    """Seeded Newton kinds at a tensor c = 0.  The Zernike surface's
    normalization radius puts its departure band (and the closest-approach
    rescue band) on the path.  The even asphere's sag carries c in its jet,
    so jax.grad keeps d/dc and is the bar (1e-9); the Zernike sag adds its
    conic base only for a c that is not concretely 0, so jax.grad gives 0
    there and the bar is the JAX package's central difference."""
    P = np.asarray([[0.0, 3.0, -5.0], [0.5, -2.0, -5.0], [1.0, 0.5, -5.0]])
    S = np.tile([0.0, 0.0, 1.0], (3, 1))

    def build(rt, mat, c):
        shape = (rt.EvenAsphere(c, 0.0, [1e-6]) if kind == 'even_asphere'
                 else rt.Zernike(c, 0.0, 10.0, [(2, 0), (3, 1)], (1e-3, 2e-4)))
        return [rt.Surface(shape=shape, interaction='refract', P=[0, 0, 0.0],
                           material=mat.ConstantMaterial(1.5)),
                rt.Surface(shape=rt.Plane(), interaction='eval', P=[0, 0, 50.0])]

    def jloss(c):
        return jnp.sum(jrt.raytrace(build(jrt, jmat, c), jnp.asarray(P), jnp.asarray(S),
                                    WVL).P[-1][:, 1] ** 2)

    h = 1e-6
    jg, up, down = jax_ref('freeform-zero', lambda P, S, h: (
        float(jax.grad(jloss)(0.0)), float(jloss(h)), float(jloss(-h))), P, S, h,
        bar=(REL, 1e-13, 1e-13))
    fd = (up - down) / (2 * h)
    _, tg = port_grad(lambda c: torch.sum(trt.raytrace(build(trt, tmat, c), P, S,
                                                       WVL).P[-1][:, 1] ** 2), 0.0)
    assert abs(fd) > 1.0
    assert float(tg) == pytest.approx(fd, rel=1e-6)
    if kind == 'even_asphere':
        close(tg, jg)
    else:
        assert jg == 0.0
