"""The port's Forbes Q polynomials (Qbfs, Qcon, Q2d) against the JAX package.

The same numpy inputs (even and odd 2-D grids, 1-D vectors and Python
scalars) go through the JAX function in x64 and the port on the CPU in
float64, with ``config.precision = 64``.  Bars: 1e-12 of the reference's
max |value| to order 10, 1e-10 above it; the host coefficient tables and
``Q2d_nm_c_to_a_b`` equal exactly.
"""
from importlib import import_module

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import prysm_tpu.polynomials as jpoly
import prysm_tpu_torch.polynomials as tpoly
from prysm_tpu_torch.conf import config

torch.set_num_threads(2)

jq = import_module('prysm_tpu.polynomials.qpoly')
tq = import_module('prysm_tpu_torch.polynomials.qpoly')


@pytest.fixture(autouse=True)
def f64_on_cpu(monkeypatch):
    """Python numbers become float64 CPU tensors in the port, as x64 arrays in JAX."""
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _tol(order):
    return 1e-12 if order <= 10 else 1e-10


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(got, want, tol):
    """max |got - want| <= tol * max |want| (elementwise over tuples and lists)."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-300)
    assert err <= tol, f'{err:.3e} > {tol:g}'


def _inputs(kind, lo, hi, seed):
    """(port input, JAX input): even and odd 2-D grids, a 1-D vector, or a scalar.

    The port takes a Python float where the JAX package needs a 0-d array.
    """
    rng = np.random.default_rng(seed)
    if kind == 'scalar':
        v = float(rng.uniform(lo, hi))
        return v, jnp.asarray(v)
    a = rng.uniform(lo, hi, {'even': (6, 8), 'odd': (7, 5), '1d': (11,)}[kind])
    return torch.from_numpy(a), jnp.asarray(a)


KINDS = ['even', 'odd', '1d', 'scalar']
NS = [0, 1, 2, 3, 5, 8, 12]


def test_host_tables_equal():
    for n in range(16):
        for fn in ('g_qbfs', 'h_qbfs', 'f_qbfs', '_qcon_abc'):
            assert getattr(tq, fn)(n) == getattr(jq, fn)(n)
        for m in range(1, 10):
            for fn in ('G_q2d', 'F_q2d', 'g_q2d', 'f_q2d', 'abc_q2d_clenshaw'):
                assert getattr(tq, fn)(n, m) == getattr(jq, fn)(n, m)
            if n >= 1 and (m + n) != 2 and (m + 2 * n) != 3:
                assert tq.abc_q2d(n, m) == jq.abc_q2d(n, m)
    cs = list(np.random.default_rng(0).normal(size=9))
    assert tq.change_basis_Qbfs_to_Pn(cs) == jq.change_basis_Qbfs_to_Pn(cs)
    for m in (1, -2, 5):
        assert tq.change_of_basis_Q2d_to_Pnm(cs, m) == jq.change_of_basis_Q2d_to_Pnm(cs, m)


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('family', ['Qbfs', 'Qcon'])
def test_radial_families_match_jax(family, kind):
    xt, xj = _inputs(kind, 0.0, 1.0, 1)
    for form in ('', '_der'):
        tf, jf = getattr(tpoly, family + form), getattr(jpoly, family + form)
        for n in NS:
            _close(tf(n, xt), jf(n, xj), _tol(n))
    for form in ('_seq', '_der_seq'):
        _close(getattr(tpoly, family + form)(NS, xt), getattr(jpoly, family + form)(NS, xj),
               _tol(max(NS)))


NMS_Q2D = [(0, 0), (3, 0), (1, 1), (4, 1), (2, -1), (0, 2), (3, -2), (1, 3), (5, -3), (2, 5),
           (11, 2), (12, -1)]


@pytest.mark.parametrize('kind', KINDS)
def test_q2d_matches_jax(kind):
    rt, rj = _inputs(kind, 0.0, 1.0, 2)
    tt, tj = _inputs(kind, -np.pi, np.pi, 3)
    xt, xj = _inputs(kind, -0.7, 0.7, 4)
    yt, yj = _inputs(kind, -0.7, 0.7, 5)
    for n, m in NMS_Q2D:
        _close(tpoly.Q2d(n, m, rt, tt), jpoly.Q2d(n, m, rj, tj), _tol(n))
        _close(tpoly.Q2d_der(n, m, rt, tt), jpoly.Q2d_der(n, m, rj, tj), _tol(n))
        _close(tpoly.Q2d_der_xy(n, m, xt, yt), jpoly.Q2d_der_xy(n, m, xj, yj), _tol(n))
    _close(tpoly.Q2d_seq(NMS_Q2D, rt, tt), jpoly.Q2d_seq(NMS_Q2D, rj, tj), 1e-10)
    _close(tpoly.Q2d_der_seq(NMS_Q2D, rt, tt), jpoly.Q2d_der_seq(NMS_Q2D, rj, tj), 1e-10)
    _close(tpoly.Q2d_der_xy_seq(NMS_Q2D, xt, yt), jpoly.Q2d_der_xy_seq(NMS_Q2D, xj, yj), 1e-10)


@pytest.mark.parametrize('kind', ['even', 'odd', '1d'])
@pytest.mark.parametrize('ncoef', [1, 3, 9, 14])
def test_qbfs_and_qcon_sums_match_jax(ncoef, kind):
    ut, uj = _inputs(kind, 0.0, 1.0, 6)
    cs = list(np.random.default_rng(ncoef).normal(size=ncoef))
    tol = _tol(ncoef - 1)
    _close(tpoly.compute_z_zprime_Qbfs(cs, ut, ut * ut), jpoly.compute_z_zprime_Qbfs(cs, uj, uj * uj),
           tol)
    _close(tpoly.compute_z_Qbfs(cs, ut, ut * ut), jpoly.compute_z_Qbfs(cs, uj, uj * uj), tol)
    _close(tpoly.compute_z_zprime_Qcon(cs, ut, ut * ut), jpoly.compute_z_zprime_Qcon(cs, uj, uj * uj),
           tol)
    _close(tpoly.clenshaw_qbfs(cs, ut * ut), jpoly.clenshaw_qbfs(cs, uj * uj), tol)
    _close(tpoly.clenshaw_qbfs_der(cs, ut * ut, j=2), jpoly.clenshaw_qbfs_der(cs, uj * uj, j=2),
           tol)
    for m in (1, 2, 3, 6):
        _close(tpoly.clenshaw_q2d(cs, m, ut * ut), jpoly.clenshaw_q2d(cs, m, uj * uj), tol)
        _close(tpoly.clenshaw_q2d_der(cs, m, ut * ut), jpoly.clenshaw_q2d_der(cs, m, uj * uj), tol)


def test_qbfs_sum_equals_its_stack():
    """compute_z_Qbfs (Clenshaw) against the sum of the Qbfs stack in the port."""
    u = torch.linspace(0, 1, 33, dtype=torch.float64)
    cs = list(np.random.default_rng(7).normal(size=7))
    stack = tpoly.Qbfs_seq(range(7), u)
    _close(tpoly.compute_z_Qbfs(cs, u, u * u),
           torch.tensordot(torch.tensor(cs, dtype=torch.float64), stack, dims=1), 1e-11)


def _q2d_coefs(nmax, mmax, seed, scale=1e-4):
    nms = [(n, m) for n in range(nmax + 1) for m in range(-mmax, mmax + 1)]
    return nms, list(np.random.default_rng(seed).normal(scale=scale, size=len(nms)))


def test_q2d_nm_c_to_a_b_matches_jax():
    nms, c = _q2d_coefs(8, 8, 11)
    assert tpoly.Q2d_nm_c_to_a_b(nms, c) == jpoly.Q2d_nm_c_to_a_b(nms, c)
    sparse = [(0, 0), (4, 0), (2, 3), (1, -5), (0, 2)]
    vals = [1.0, 0.0, -2.0, 0.5, 0.0]
    assert tpoly.Q2d_nm_c_to_a_b(sparse, vals) == jpoly.Q2d_nm_c_to_a_b(sparse, vals)
    assert tpoly.Q2d_nm_c_to_a_b(sparse, [0] * 5) == jpoly.Q2d_nm_c_to_a_b(sparse, [0] * 5)


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('nmax,mmax', [(8, 8), (3, 2), (12, 3)])
def test_compute_z_q2d_matches_jax(nmax, mmax, kind):
    """Sag, radial and azimuthal slopes of a Q2d surface, freeform path's coefficients included."""
    nms, c = _q2d_coefs(nmax, mmax, 11 + nmax)
    cm0, ams, bms = tpoly.Q2d_nm_c_to_a_b(nms, c)
    ut, uj = _inputs(kind, 0.0, 1.0, 8)
    tt, tj = _inputs(kind, -np.pi, np.pi, 9)
    tol = _tol(nmax)
    _close(tpoly.compute_z_zprime_Q2d(cm0, ams, bms, ut, tt),
           jpoly.compute_z_zprime_Q2d(cm0, ams, bms, uj, tj), tol)
    _close(tpoly.compute_z_Q2d(cm0, ams, bms, ut, tt), jpoly.compute_z_Q2d(cm0, ams, bms, uj, tj),
           tol)


def test_compute_z_q2d_equals_its_stack():
    """The Clenshaw sag against the weighted Q2d stack, and its slopes against autograd."""
    nms, c = _q2d_coefs(5, 4, 12, scale=1.0)
    cm0, ams, bms = tpoly.Q2d_nm_c_to_a_b(nms, c)
    rng = np.random.default_rng(13)
    u = torch.from_numpy(rng.uniform(0.05, 1, (5, 6))).requires_grad_(True)
    t = torch.from_numpy(rng.uniform(-np.pi, np.pi, (5, 6))).requires_grad_(True)
    z, dr, dt = tpoly.compute_z_zprime_Q2d(cm0, ams, bms, u, t)
    stack = tpoly.Q2d_seq(nms, u, t)
    _close(z, torch.tensordot(torch.tensor(c, dtype=torch.float64), stack, dims=1), 1e-11)
    gu, gt = torch.autograd.grad(z.sum(), (u, t))
    _close(dr, gu, 1e-10)
    _close(dt, gt, 1e-10)


def test_empty_and_zero_coefficients():
    u = torch.linspace(0, 1, 5, dtype=torch.float64)
    for fn in (tpoly.compute_z_zprime_Qbfs, tpoly.compute_z_zprime_Qcon):
        assert all(float(v.abs().max()) == 0 for v in fn([0, 0], u, u * u))
    z = tpoly.compute_z_zprime_Q2d([0, 0], [[0, 0]], [[0, 0]], u, u)
    assert all(float(v.abs().max()) == 0 for v in z)


JAX_POLY_NAMES = sorted(n for n in dir(jpoly) if not n.startswith('_') and 'barplot' not in n)


@pytest.mark.parametrize('name', JAX_POLY_NAMES)
def test_port_exports_every_polynomials_name(name):
    assert hasattr(tpoly, name), f'prysm_tpu_torch.polynomials lacks {name}'
