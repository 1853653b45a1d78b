"""The port's propagation (``prysm_tpu_torch.propagation``, ``fttools``) against the JAX package.

Same numpy inputs through both packages on the CPU in float64.  Bars:
1e-12 relative for the FFT paths and 1e-11 for the MDFT (float64
rounding of differently ordered FFT passes and matmuls; the results are
O(1) after unitary scaling), and 1e-10 relative for adjoint identities
<Ax, y> = <x, A^H y>, which sum N^2 products.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prysm_tpu import fttools as jfttools
from prysm_tpu.coordinates import make_xy_grid as jax_make_xy_grid
from prysm_tpu.geometry import antialias as jax_antialias, circle_sdf as jax_circle_sdf
from prysm_tpu.propagation import fft as jfft
from prysm_tpu.propagation import prepare_executor as jax_prepare_executor

from prysm_tpu_torch import fttools
from prysm_tpu_torch.coordinates import make_xy_grid, cart_to_polar, polar_to_cart
from prysm_tpu_torch.geometry import antialias, circle_sdf, circle
from prysm_tpu_torch.interop import mdft_from_numpy
from prysm_tpu_torch.propagation import fft as tfft
from prysm_tpu_torch.propagation import prepare_executor, unit_cell_focal_grid

torch.set_num_threads(2)

# (shape, Q): pruned even/symmetric, rectangular pruned, dense even
# (odd input, even pad), odd shift-sandwich (Q=1), odd pad
SHAPES = [((32, 32), 2), ((12, 20), 2), ((31, 31), 2), ((15, 15), 1), ((15, 17), 1.5)]
IDS = ['pruned', 'pruned-rect', 'dense-cb', 'odd-q1', 'odd-pad']


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _vdot(a, b):
    return torch.sum(torch.conj(a) * b)


@pytest.mark.parametrize('shape,Q', SHAPES, ids=IDS)
@pytest.mark.parametrize('name', ['focus', 'unfocus'])
def test_forward_matches_jax(shape, Q, name):
    E = _field(shape, 1)
    out = getattr(tfft, name)(torch.from_numpy(E), Q)
    ref = getattr(jfft, name)(jnp.asarray(E), Q)
    assert tuple(out.shape) == ref.shape
    assert _rel(out, ref) < 1e-12


@pytest.mark.parametrize('shape,Q', SHAPES, ids=IDS)
@pytest.mark.parametrize('name', ['focus', 'unfocus'])
def test_adjoint_matches_jax(shape, Q, name):
    padded = getattr(jfft, name)(jnp.zeros(shape, jnp.complex128), Q).shape
    G = _field(padded, 2)
    out = getattr(tfft, name + '_adjoint')(torch.from_numpy(G), Q)
    ref = getattr(jfft, name + '_adjoint')(jnp.asarray(G), Q)
    assert tuple(out.shape) == ref.shape == shape
    assert _rel(out, ref) < 1e-12


@pytest.mark.parametrize('shape,Q', SHAPES, ids=IDS)
@pytest.mark.parametrize('name', ['focus', 'unfocus'])
def test_adjoint_identity(shape, Q, name):
    x = torch.from_numpy(_field(shape, 3))
    Ax = getattr(tfft, name)(x, Q)
    y = torch.from_numpy(_field(tuple(Ax.shape), 4))
    lhs = _vdot(Ax, y)
    rhs = _vdot(x, getattr(tfft, name + '_adjoint')(y, Q))
    assert abs(lhs - rhs) / abs(lhs) < 1e-10


def test_focus_batched_leading_axes():
    E = _field((3, 16, 16), 5)
    out = tfft.focus(torch.from_numpy(E), 2)
    ref = jfft.focus(jnp.asarray(E), 2)
    assert _rel(out, ref) < 1e-12


@pytest.mark.parametrize('prec', [None, 'high'])
def test_mdft_plan_carried_by_interop(prec):
    jplan = jax_prepare_executor(2.2 / 48, (48, 48), 0.4, (20, 24), 0.55, 10.0,
                                 matmul_precision=prec)
    plan = mdft_from_numpy(np.asarray(jplan.Ex_re), np.asarray(jplan.Ex_im),
                           np.asarray(jplan.Ey_re), np.asarray(jplan.Ey_im),
                           jplan.norm, jplan.forward_left_first, jplan.adjoint_left_first,
                           jplan.pupil_dx, jplan.focal_dx, prec, device='cpu')
    a = _field((48, 48), 6)
    assert _rel(plan(torch.from_numpy(a)), jplan(jnp.asarray(a))) < 1e-11
    g = _field((20, 24), 7)
    assert _rel(plan.adjoint(torch.from_numpy(g)), jplan.adjoint(jnp.asarray(g))) < 1e-11


@pytest.mark.parametrize('prec', [None, 'high'])
def test_prepare_executor_matches_jax_plan(prec):
    args = (2.2 / 40, (40, 40), 0.3, 16, 0.55, 10.0)
    jplan = jax_prepare_executor(*args)
    plan = prepare_executor(*args, dtype=torch.complex128, matmul_precision=prec,
                            device='cpu')
    assert plan.forward_left_first == jplan.forward_left_first
    assert plan.adjoint_left_first == jplan.adjoint_left_first
    assert plan.norm == pytest.approx(jplan.norm, rel=1e-15)
    np.testing.assert_allclose(plan.Ex.numpy(), np.asarray(jplan.Ex), rtol=0, atol=1e-15)
    a = torch.from_numpy(_field((40, 40), 8))
    y = torch.from_numpy(_field((16, 16), 9))
    lhs, rhs = _vdot(plan(a), y), _vdot(a, plan.adjoint(y))
    assert abs(lhs - rhs) / abs(lhs) < 1e-10


def test_mdft_high_precision_gradient_is_the_adjoint():
    plan = prepare_executor(2.2 / 24, (24, 24), 0.5, 12, 0.55, 10.0,
                            dtype=torch.complex128, matmul_precision='high', device='cpu')
    a = torch.from_numpy(_field((24, 24), 10)).requires_grad_(True)
    g = torch.from_numpy(_field((12, 12), 11))
    torch.sum(torch.real(torch.conj(g) * plan(a))).backward()
    assert _rel(a.grad, plan.adjoint(g).detach()) < 1e-12


@pytest.mark.parametrize('n', [16, 17])
def test_grid_and_pupil_match_jax(n):
    x, y = make_xy_grid(n, diameter=2.2, dtype=torch.float64, device='cpu')
    jx, jy = jax_make_xy_grid(n, diameter=2.2)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert float(x[0, n // 2]) == 0.0 and float(y[n // 2, 0]) == 0.0
    r, t = cart_to_polar(x, y)
    amp = antialias(circle_sdf(1.0, r), 2.2 / n)
    jamp = jax_antialias(jax_circle_sdf(1.0, jnp.hypot(jx, jy)), 2.2 / n)
    np.testing.assert_allclose(amp.numpy(), np.asarray(jamp), rtol=0, atol=1e-15)
    xb, yb = polar_to_cart(r, t)
    np.testing.assert_allclose(xb.numpy(), x.numpy(), atol=1e-15)
    np.testing.assert_allclose(yb.numpy(), y.numpy(), atol=1e-15)
    assert bool(circle(1.0, r)[n // 2, n // 2])


@pytest.mark.parametrize('shape,out', [((5, 6), (9, 11)), ((4, 4), (8, 8)), ((7, 3), (7, 4))])
def test_pad_crop_match_jax(shape, out):
    a = _field(shape, 12)
    p = fttools.pad2d(torch.from_numpy(a), out_shape=out)
    jp = jfttools.pad2d(jnp.asarray(a), out_shape=out)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(fttools.crop_center(p, shape).numpy(),
                                  np.asarray(jfttools.crop_center(jp, shape)))


def test_fft_units_match_jax():
    np.testing.assert_array_equal(fttools.fftrange(9, dtype=torch.float64, device='cpu').numpy(),
                                  np.asarray(jfttools.fftrange(9)))
    np.testing.assert_allclose(
        fttools.forward_ft_unit(0.1, 10, dtype=torch.float64, device='cpu').numpy(),
        np.asarray(jfttools.forward_ft_unit(0.1, 10)), rtol=1e-15)
    from prysm_tpu.propagation import unit_cell_focal_grid as jax_unit_cell
    assert unit_cell_focal_grid(0.01, 2.0, 0.55, 10.0) == jax_unit_cell(0.01, 2.0, 0.55, 10.0)
