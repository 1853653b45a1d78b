"""The port's fused Zernike synthesis (``prysm_tpu_torch.ops.zernike``) against the JAX package.

On the CPU the port's wrapper runs the plain versions of its three CUDA
kernels; the JAX side runs its Pallas kernels in interpret mode, as
``tests/test_ops_pallas.py`` does.  The same numpy inputs go to both.
Bars: 1e-5 relative for the f32 forward and 1e-4 for the f32 cotangents
(the bars of ``tests/test_ops_pallas.py``, set by f32 rounding in the
recurrences and sums); 1e-12 relative in f64 against the mode stack,
where only float64 rounding separates the two evaluation orders.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prysm_tpu.coordinates import make_xy_grid, cart_to_polar
from prysm_tpu.ops import dispatch
from prysm_tpu.ops.zernike import zernike_sum_pallas as jax_zernike_sum_pallas
from prysm_tpu.polynomials import (zernike_nm, zernike_nm_seq, sum_of_2d_modes,
                                   zernike_sum as jax_zernike_sum)

from prysm_tpu_torch.ops import zernike as zk
from prysm_tpu_torch.ops.zernike import zernike_sum_pallas
from prysm_tpu_torch.polynomials import zernike_sum

torch.set_num_threads(2)

NMS9 = [(0, 0), (2, 0), (2, 2), (2, -2), (3, 1), (3, -1), (4, 0), (5, 5), (6, -4)]
NMS3 = [(2, 0), (3, 3), (4, -2)]


@pytest.fixture(autouse=True)
def interpret_mode():
    dispatch.set_pallas_mode('interpret')
    yield
    dispatch.set_pallas_mode('auto')


def _grid(N, dtype=np.float32):
    x, y = make_xy_grid(N, diameter=2.0)
    r, t = cart_to_polar(x, y)
    return np.asarray(r, dtype), np.asarray(t, dtype)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize('norm', [True, False])
@pytest.mark.parametrize('nms', [NMS9, NMS3], ids=['nms9', 'nms3'])
def test_forward_matches_pallas(nms, norm):
    r, t = _grid(96)
    c = np.random.default_rng(9).standard_normal(len(nms)).astype(np.float32)
    zj = jax_zernike_sum_pallas(jnp.asarray(c), nms, jnp.asarray(r), jnp.asarray(t), norm=norm)
    zt = zernike_sum_pallas(_t(c), nms, _t(r), _t(t), norm=norm)
    assert zt.dtype == torch.float32
    assert _rel(zt, zj) < 1e-5


@pytest.mark.parametrize('nms', [NMS9, NMS3], ids=['nms9', 'nms3'])
def test_full_vjp_matches_pallas(nms):
    r, t = _grid(64)
    rng = np.random.default_rng(10)
    c = rng.standard_normal(len(nms)).astype(np.float32)

    def lj(c, r, t):
        return jnp.sum(jax_zernike_sum_pallas(c, nms, r, t) ** 2)

    gj = jax.grad(lj, argnums=(0, 1, 2))(jnp.asarray(c), jnp.asarray(r), jnp.asarray(t))
    ct, rt, tt = (_t(a).requires_grad_(True) for a in (c, r, t))
    torch.sum(zernike_sum_pallas(ct, nms, rt, tt) ** 2).backward()
    for a, b in zip((ct.grad, rt.grad, tt.grad), gj):
        assert _rel(a, b) < 1e-4


def test_plain_vjp_functions_match_pallas_vjp():
    r, t = _grid(64)
    rng = np.random.default_rng(12)
    c = rng.standard_normal(len(NMS9)).astype(np.float32)
    g = rng.standard_normal(r.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda c, r, t: jax_zernike_sum_pallas(c, NMS9, r, t),
                     jnp.asarray(c), jnp.asarray(r), jnp.asarray(t))
    gj = vjp(jnp.asarray(g))
    plan = zk._plan(tuple(NMS9), True)
    cg, gr, gt = zk.zernike_bwd_all_plain(plan, _t(c), _t(r), _t(t), _t(g))
    for a, b in zip((cg, gr, gt), gj):
        assert _rel(a, b) < 1e-4
    assert _rel(zk.zernike_bwd_coefs_plain(plan, _t(r), _t(t), _t(g)), gj[0]) < 1e-4


def test_grads_coefs_mode():
    r, t = _grid(64)
    c = np.random.default_rng(11).standard_normal(len(NMS3)).astype(np.float32)
    gj = jax.grad(lambda c: jnp.sum(jax_zernike_sum_pallas(
        c, NMS3, jnp.asarray(r), jnp.asarray(t), grads='coefs') ** 2))(jnp.asarray(c))
    ct, rt, tt = (_t(a).requires_grad_(True) for a in (c, r, t))
    torch.sum(zernike_sum_pallas(ct, NMS3, rt, tt, grads='coefs') ** 2).backward()
    assert _rel(ct.grad, gj) < 1e-4
    # the grid cotangents are declared zero in this mode, as in JAX
    assert torch.all(rt.grad == 0) and torch.all(tt.grad == 0)


def test_grads_coefs_mode_makes_no_grid_cotangent_unless_asked():
    # cfg2's call: the grids take no gradient, so the backward returns None for them
    r, t = _grid(32)
    c = np.random.default_rng(13).standard_normal(len(NMS3)).astype(np.float32)
    g = _t(np.random.default_rng(14).standard_normal(r.shape).astype(np.float32))
    ct = _t(c).requires_grad_(True)
    out = zernike_sum_pallas(ct, NMS3, _t(r), _t(t), grads='coefs')
    cg, gr, gt, *_ = out.grad_fn.apply(g)
    assert gr is None and gt is None
    rt = _t(r).requires_grad_(True)
    out_r = zernike_sum_pallas(ct, NMS3, rt, _t(t), grads='coefs')
    cg_r, gr_r, gt_r, *_ = out_r.grad_fn.apply(g)
    assert torch.equal(cg, cg_r)
    assert gr_r.shape == r.shape and torch.all(gr_r == 0) and gt_r is None
    plan = zk._plan(tuple(NMS3), True)
    assert torch.equal(cg, zk.zernike_bwd_coefs_plain(plan, _t(r), _t(t), g))


def test_bad_grads_value_raises():
    r, t = _grid(16)
    with pytest.raises(ValueError):
        zernike_sum_pallas(torch.ones(3), NMS3, _t(r), _t(t), grads='bogus')


def test_norm_off_and_empty():
    r, t = _grid(32)
    z = zernike_sum_pallas(torch.tensor([2.0]), [(3, -1)], _t(r), _t(t), norm=False)
    ref = 2.0 * np.asarray(zernike_nm(3, -1, jnp.asarray(r), jnp.asarray(t), norm=False))
    assert np.abs(z.numpy() - ref).max() < 1e-5
    empty = zernike_sum_pallas(torch.zeros(0), [], _t(r), _t(t))
    assert empty.shape == r.shape and torch.all(empty == 0)


@pytest.mark.parametrize('norm', [True, False])
def test_f64_plain_matches_mode_stack(norm):
    nms = [(n, m) for n in range(7) for m in range(-n, n + 1, 2)]
    r, t = _grid(48, np.float64)
    c = np.random.default_rng(3).standard_normal(len(nms))
    zj = np.asarray(sum_of_2d_modes(zernike_nm_seq(nms, jnp.asarray(r), jnp.asarray(t),
                                                   norm=norm), jnp.asarray(c)))
    zt = zernike_sum_pallas(_t(c), nms, _t(r), _t(t), norm=norm)
    assert zt.dtype == torch.float64
    assert _rel(zt, zj) < 1e-12


def test_public_zernike_sum_f64_value_and_grid_gradient():
    # off-origin grid: hypot/atan2 have no derivative at r = 0
    x, y = np.meshgrid(np.linspace(-0.93, 0.97, 24), np.linspace(-0.95, 0.91, 20))
    c = np.random.default_rng(5).standard_normal(len(NMS9))

    def lj(c, x, y):
        return jnp.sum(jax_zernike_sum(c, NMS9, x, y) ** 2)

    dispatch.set_pallas_mode('off')  # the JAX mode stack, in f64
    vj = np.asarray(jax_zernike_sum(jnp.asarray(c), NMS9, jnp.asarray(x), jnp.asarray(y)))
    gj = jax.grad(lj, argnums=(0, 1, 2))(jnp.asarray(c), jnp.asarray(x), jnp.asarray(y))
    ct, xt, yt = (_t(a).requires_grad_(True) for a in (c, x, y))
    vt = zernike_sum(ct, NMS9, xt, yt)
    assert _rel(vt.detach(), vj) < 1e-12
    torch.sum(vt ** 2).backward()
    for a, b in zip((ct.grad, xt.grad, yt.grad), gj):
        assert _rel(a, b) < 1e-10


def test_plan_table_layout():
    plan = zk._plan(((4, 0), (2, 2), (2, 0), (3, -1), (0, 0)), False)
    # groups sorted by |m|: |m|=0 holds n_j 0, 1, 2; |m|=1 n_j 1; |m|=2 n_j 0
    assert plan.groups == ((0, 2, 0, 3, 0), (1, 1, 3, 4, 2), (2, 0, 4, 5, 3))
    assert plan.modes == ((4, 0, 1), (2, 1, 1), (0, 2, 1), (3, 1, -1), (1, 0, 1))
    assert plan.weights == (1.0,) * 5
    assert len(plan.abc) == 3


def test_kernel_dispatch_refuses_other_devices():
    r = torch.zeros(4, 4, device='meta')
    with pytest.raises(ValueError, match='CUDA or CPU'):
        zernike_sum_pallas(torch.ones(3, device='meta'), NMS3, r, r)


def test_cpu_path_counts_no_launches():
    zk.reset_launches()
    r, t = _grid(16)
    zernike_sum_pallas(torch.ones(3), NMS3, _t(r), _t(t))
    assert all(v == 0 for v in zk.LAUNCHES.values())
