"""The port's classical polynomial families against the JAX package.

The recurrences (``_recurrence``), Clenshaw (``_clenshaw``), Jacobi,
Chebyshev (four kinds), Legendre, Hermite (He, H), Laguerre, Dickson
(two kinds), XY and the Zernike derivative and naming tools, each with its
``_seq``, ``_der`` and ``_der_seq`` forms.  The same numpy inputs (even
and odd 2-D grids, 1-D vectors and Python scalars) go through the JAX
function in x64 and the port on the CPU in float64, with
``config.precision = 64``.  Bar: 1e-12 of the reference's max |value|.  The JAX
package's families and Zernike derivatives are read from their records
(``_jax_refs``) where they are current.
"""
from importlib import import_module

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _jax_refs import jax_ref
import prysm_tpu.polynomials as jpoly
import prysm_tpu_torch.polynomials as tpoly
from prysm_tpu_torch.conf import config

torch.set_num_threads(2)

TOL = 1e-12
jrec = import_module('prysm_tpu.polynomials._recurrence')
trec = import_module('prysm_tpu_torch.polynomials._recurrence')
jclen = import_module('prysm_tpu.polynomials._clenshaw')
tclen = import_module('prysm_tpu_torch.polynomials._clenshaw')
jjac = import_module('prysm_tpu.polynomials.jacobi')
tjac = import_module('prysm_tpu_torch.polynomials.jacobi')
jzern = import_module('prysm_tpu.polynomials.zernike')
tzern = import_module('prysm_tpu_torch.polynomials.zernike')


@pytest.fixture(autouse=True)
def f64_on_cpu(monkeypatch):
    """Python numbers become float64 CPU tensors in the port, as x64 arrays in JAX."""
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(got, want, tol=TOL):
    """max |got - want| <= tol * max |want| (elementwise over tuples)."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(np.abs(w).max(), 1e-300)
    err = np.abs(g - w).max() / scale
    assert err <= tol, f'{err:.3e} > {tol:g}'


def _inputs(kind, lo=-1.0, hi=1.0, seed=0):
    """(port input, JAX input) of one kind: even and odd 2-D grids, a 1-D vector, a scalar.

    The port takes a Python float where the JAX package needs a 0-d array.
    """
    rng = np.random.default_rng(seed)
    if kind == 'scalar':
        v = float(rng.uniform(lo, hi))
        return v, jnp.asarray(v)
    shape = {'even': (6, 8), 'odd': (7, 5), '1d': (11,)}[kind]
    a = rng.uniform(lo, hi, shape)
    return torch.from_numpy(a), jnp.asarray(a)


KINDS = ['even', 'odd', '1d', 'scalar']
NS = [0, 1, 2, 5, 9]
# family: parameters between the order and x
FAMILIES = {
    'cheby1': (), 'cheby2': (), 'cheby3': (), 'cheby4': (), 'legendre': (),
    'hermite_He': (), 'hermite_H': (), 'laguerre': (0.5,), 'dickson1': (0.7,),
    'dickson2': (-0.3,), 'jacobi': (0.5, 1.5),
}


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('form', ['', '_seq', '_der', '_der_seq'])
@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_family_matches_jax(family, form, kind):
    xt, _ = _inputs(kind)
    params = FAMILIES[family]
    name = family + form
    tf = getattr(tpoly, name)

    def jax_side(name, params, kind):
        _, xj = _inputs(kind)
        jf = getattr(jpoly, name)
        return jf(NS, *params, xj) if name.endswith('_seq') else [jf(n, *params, xj) for n in NS]

    want = jax_ref('family', jax_side, name, params, kind, bar=TOL)
    if form.endswith('_seq'):
        _close(tf(NS, *params, xt), want)
    else:
        for n, w in zip(NS, want):
            _close(tf(n, *params, xt), w)


@pytest.mark.parametrize('alpha,beta', [(0, 0), (0, 3), (-0.5, -0.5), (2, 1), (0.5, 1.5)])
def test_jacobi_with_der_and_weight(alpha, beta):
    xt, xj = _inputs('odd')
    _close(tpoly.jacobi_with_der(7, alpha, beta, xt), jpoly.jacobi_with_der(7, alpha, beta, xj))
    _close(tpoly.jacobi_seq_with_der([0, 2, 3, 7], alpha, beta, xt),
           jpoly.jacobi_seq_with_der([0, 2, 3, 7], alpha, beta, xj))
    _close(tjac.weight(alpha, beta, xt), jjac.weight(alpha, beta, xj))


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('alpha,beta', [(0, 0), (0, 4), (-0.5, -0.5), (1.5, 0.5)])
def test_jacobi_sum_clenshaw_matches_jax_and_the_stack(alpha, beta, kind):
    s = list(np.random.default_rng(3).normal(size=9))
    xt, xj = _inputs(kind)
    got = tpoly.jacobi_sum_clenshaw(s, alpha, beta, xt)
    _close(got, jpoly.jacobi_sum_clenshaw(s, alpha, beta, xj))
    stack = tpoly.jacobi_seq(range(9), alpha, beta, xt)
    _close(got, torch.tensordot(torch.tensor(s, dtype=torch.float64), stack, dims=1), 1e-11)
    for short in ([], [0.7], [0.7, -0.2]):
        _close(tpoly.jacobi_sum_clenshaw(short, alpha, beta, xt),
               jpoly.jacobi_sum_clenshaw(short, alpha, beta, xj))


@pytest.mark.parametrize('kind', ['even', '1d', 'scalar'])
@pytest.mark.parametrize('j', [1, 2, 3])
def test_jacobi_sum_clenshaw_der_nested_forward_mode(j, kind):
    """The j-th derivative by j nested jvps: against jax.jvp and central differences."""
    alpha, beta = 0.5, 1.0
    s = list(np.random.default_rng(4).normal(size=8))
    xt, xj = _inputs(kind, -0.9, 0.9)
    got = tpoly.jacobi_sum_clenshaw_der(s, alpha, beta, xt, j=j)
    _close(got, jpoly.jacobi_sum_clenshaw_der(s, alpha, beta, xj, j=j), 1e-11)
    # central differences of the (j-1)-th derivative
    h = 1e-5
    x = torch.as_tensor(xt, dtype=torch.float64)
    lower = (lambda v: tpoly.jacobi_sum_clenshaw(s, alpha, beta, v)) if j == 1 else \
        (lambda v: tpoly.jacobi_sum_clenshaw_der(s, alpha, beta, v, j=j - 1))
    fd = (lower(x + h) - lower(x - h)) / (2 * h)
    _close(got, fd, 1e-6)


@pytest.mark.parametrize('kind', KINDS)
def test_jacobi_radial_sums_match_jax(kind):
    xt, xj = _inputs(kind, -0.7, 0.7, seed=1)
    yt, yj = _inputs(kind, -0.7, 0.7, seed=2)
    ns, c = (0, 1, 2, 4, 6), [0.3, -1.0, 0.5, 0.25, -0.1]
    for a, b in ((0, 0), (1, 2)):
        _close(tpoly.jacobi_radial_sum(c, ns, a, b, xt, yt, 1.2),
               jpoly.jacobi_radial_sum(c, ns, a, b, xj, yj, 1.2))
        _close(tpoly.jacobi_radial_sum_der_xy(c, ns, a, b, xt, yt, 1.2),
               jpoly.jacobi_radial_sum_der_xy(c, ns, a, b, xj, yj, 1.2))
    z = tpoly.jacobi_radial_sum_der_xy([], (), 0, 0, xt, yt, 1.0)
    assert all(float(torch.abs(v).max()) == 0 for v in z)


@pytest.mark.parametrize('with_der', [False, True])
@pytest.mark.parametrize('kind', KINDS)
def test_recurrence_helpers_match_jax(kind, with_der):
    xt, xj = _inputs(kind)
    abc = lambda k: ((k - 1) / k, (2 * k - 1) / k, 0.5)  # noqa: E731
    for nmax in (0, 1, 2, 7):
        if with_der:
            _close(trec.recurrence_all(nmax, xt, xt * 1.5, abc, dseed1=1.5),
                   jrec.recurrence_all(nmax, xj, xj * 1.5, abc, dseed1=1.5))
        else:
            _close(trec.recurrence_all(nmax, xt, xt * 1.5, abc),
                   jrec.recurrence_all(nmax, xj, xj * 1.5, abc))
    _close(trec.seq_by_recurrence([0, 3, 5], xt, xt, abc, seed0=2),
           jrec.seq_by_recurrence([0, 3, 5], xj, xj, abc, seed0=2))
    _close(trec.seq_by_recurrence_with_der([1, 4], xt, xt, 1, abc),
           jrec.seq_by_recurrence_with_der([1, 4], xj, xj, 1, abc))


@pytest.mark.parametrize('j', [0, 1, 2])
@pytest.mark.parametrize('kind', ['even', 'odd', '1d'])
def test_clenshaw_alphas_match_jax(kind, j):
    """The (j+1, 2, *x.shape) alpha table, with scalar and with array coefficients."""
    xt, xj = _inputs(kind)
    rng = np.random.default_rng(5)
    p, q, c = rng.normal(size=12), rng.normal(size=12), rng.normal(size=12)
    coefs = list(rng.normal(size=10))
    got = tclen.clenshaw_alphas_scan(coefs, p, q, c, xt, j=j)
    assert got.shape == (j + 1, 2) + tuple(xt.shape)
    _close(got, jclen.clenshaw_alphas_scan(coefs, p, q, c, xj, j=j))
    arr = [rng.normal(size=xt.shape) for _ in range(4)]
    _close(tclen.clenshaw_alphas_scan([torch.from_numpy(a) for a in arr], p, q, c, xt, j=j),
           jclen.clenshaw_alphas_scan([jnp.asarray(a) for a in arr], p, q, c, xj, j=j))
    for short in ([], [1.5]):
        _close(tclen.clenshaw_alphas_scan(short, p, q, c, xt, j=j),
               jclen.clenshaw_alphas_scan(short, p, q, c, xj, j=j))
    _close(tclen.clenshaw_sum(coefs, p, q, c, xt), jclen.clenshaw_sum(coefs, p, q, c, xj))


@pytest.mark.parametrize('kind', KINDS)
def test_cheby1_2d_sums_match_jax(kind):
    xt, xj = _inputs(kind, seed=1)
    yt, yj = _inputs(kind, seed=2)
    mns = [(m, n) for m in range(4) for n in range(3)]
    c = list(np.random.default_rng(6).normal(size=len(mns)))
    _close(tpoly.cheby1_2d_sum(c, mns, xt, yt), jpoly.cheby1_2d_sum(c, mns, xj, yj))
    _close(tpoly.cheby1_2d_sum_der_xy(c, mns, xt, yt, 1.5, 0.5),
           jpoly.cheby1_2d_sum_der_xy(c, mns, xj, yj, 1.5, 0.5))


MNS_XY = [(m, n) for m in range(5) for n in range(5) if m + n <= 5]


@pytest.mark.parametrize('cartesian', [True, False])
@pytest.mark.parametrize('shape', [(6, 8), (7, 5)])
def test_xy_matches_jax(shape, cartesian):
    """Monomials, their derivatives and sums; the separable (matmul) and the stack paths."""
    ny, nx = shape
    x, y = np.meshgrid(np.linspace(-1, 0.9, nx), np.linspace(-0.8, 1, ny))
    xt, yt, xj, yj = torch.from_numpy(x), torch.from_numpy(y), jnp.asarray(x), jnp.asarray(y)
    for name in ('xy', 'xy_der_x', 'xy_der_y', 'xy_der_xy'):
        for m, n in ((0, 0), (3, 0), (0, 2), (2, 3)):
            _close(getattr(tpoly, name)(m, n, xt, yt, cartesian),
                   getattr(jpoly, name)(m, n, xj, yj, cartesian))
        _close(getattr(tpoly, name + '_seq')(MNS_XY, xt, yt, cartesian),
               getattr(jpoly, name + '_seq')(MNS_XY, xj, yj, cartesian))
    c = list(np.random.default_rng(7).normal(size=len(MNS_XY)))
    _close(tpoly.xy_sum(c, MNS_XY, xt, yt, cartesian), jpoly.xy_sum(c, MNS_XY, xj, yj, cartesian))
    _close(tpoly.xy_sum_der_xy(c, MNS_XY, xt, yt, cartesian),
           jpoly.xy_sum_der_xy(c, MNS_XY, xj, yj, cartesian))


@pytest.mark.parametrize('kind', ['1d', 'scalar'])
def test_xy_on_points_matches_jax(kind):
    xt, xj = _inputs(kind, seed=1)
    yt, yj = _inputs(kind, seed=2)
    c = list(np.random.default_rng(8).normal(size=len(MNS_XY)))
    _close(tpoly.xy_sum(c, MNS_XY, xt, yt, False), jpoly.xy_sum(c, MNS_XY, xj, yj, False))
    _close(tpoly.xy_sum_der_xy(c, MNS_XY, xt, yt, False),
           jpoly.xy_sum_der_xy(c, MNS_XY, xj, yj, False))
    _close(tpoly.xy(3, 2, xt, yt, False), jpoly.xy(3, 2, xj, yj, False))


def test_xy_j_to_mn_matches_jax():
    for j in range(1, 80):
        assert tpoly.xy_j_to_mn(j) == jpoly.xy_j_to_mn(j)
    with pytest.raises(ValueError):
        tpoly.xy_j_to_mn(0)


NMS_DER = [(n, m) for n in range(7) for m in range(-n, n + 1, 2)]


POLAR_DER = ((0, 0), (2, 0), (3, -1), (4, 2), (5, 5), (6, -4))
XY_DER = ((0, 0), (1, 1), (3, -1), (4, 2), (5, -5))


def _jax_zernike_derivatives(kind, norm, c):
    """The JAX package's polar and cartesian Zernike derivatives, their sequences and the
    cartesian sum's, on the inputs of ``kind``."""
    _, rj = _inputs(kind, 0.0, 1.0, seed=1)
    _, tj = _inputs(kind, -np.pi, np.pi, seed=2)
    _, xj = _inputs(kind, -0.7, 0.7, seed=3)
    _, yj = _inputs(kind, -0.7, 0.7, seed=4)
    return ([jpoly.zernike_nm_der(n, m, rj, tj, norm) for n, m in POLAR_DER],
            jpoly.zernike_nm_der_seq(NMS_DER, rj, tj, norm),
            [jpoly.zernike_nm_der_xy(n, m, xj, yj, norm) for n, m in XY_DER],
            jpoly.zernike_nm_der_xy_seq(NMS_DER, xj, yj, norm),
            jpoly.zernike_sum_der_xy(c, NMS_DER, xj, yj, norm))


@pytest.mark.parametrize('norm', [True, False])
@pytest.mark.parametrize('kind', KINDS)
def test_zernike_derivatives_match_jax(kind, norm):
    rt, _ = _inputs(kind, 0.0, 1.0, seed=1)
    tt, _ = _inputs(kind, -np.pi, np.pi, seed=2)
    c = list(np.random.default_rng(9).normal(size=len(NMS_DER)))
    polar, polar_seq, xy, xy_seq, xy_sum = jax_ref(
        'zernike-derivatives', _jax_zernike_derivatives, kind, norm, c, bar=TOL)
    for (n, m), want in zip(POLAR_DER, polar):
        _close(tpoly.zernike_nm_der(n, m, rt, tt, norm), want)
    _close(tpoly.zernike_nm_der_seq(NMS_DER, rt, tt, norm), polar_seq)
    xt, _ = _inputs(kind, -0.7, 0.7, seed=3)
    yt, _ = _inputs(kind, -0.7, 0.7, seed=4)
    for (n, m), want in zip(XY_DER, xy):
        _close(tpoly.zernike_nm_der_xy(n, m, xt, yt, norm), want)
    _close(tpoly.zernike_nm_der_xy_seq(NMS_DER, xt, yt, norm), xy_seq)
    _close(tpoly.zernike_sum_der_xy(c, NMS_DER, xt, yt, norm), xy_sum)


def test_zernike_sum_der_xy_is_the_stack_and_its_gradient():
    """W from Clenshaw equals the mode-stack sum; (dW/dx, dW/dy) equal autograd's."""
    x, y = np.meshgrid(np.linspace(-0.7, 0.7, 9), np.linspace(-0.6, 0.7, 8))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    c = list(np.random.default_rng(10).normal(size=len(NMS_DER)))
    W, dx, dy = tpoly.zernike_sum_der_xy(c, NMS_DER, xt, yt)
    stack = tpoly.zernike_nm_seq(NMS_DER, torch.hypot(xt, yt), torch.atan2(yt, xt))
    ref = torch.tensordot(torch.tensor(c, dtype=torch.float64), stack, dims=1)
    _close(W, ref, 1e-11)
    gx, gy = torch.autograd.grad(ref.sum(), (xt, yt))
    _close(dx, gx, 1e-10)
    _close(dy, gy, 1e-10)


def test_zernike_naming_matches_jax():
    for n in range(11):
        for m in range(-n, n + 1, 2):
            assert tpoly.nm_to_name(n, m) == jpoly.nm_to_name(n, m)
    for n in (1, 2, 5, 10):
        assert tpoly.zero_separation(n) == jpoly.zero_separation(n)
        assert tpoly.zernike_zero_separation(n) == jpoly.zernike_zero_separation(n)
    rng = np.random.default_rng(11)
    coefs = {(n, m): float(rng.normal()) for n in range(6) for m in range(-n, n + 1, 2)}
    got, want = tpoly.top_n(coefs, 7), jpoly.top_n(coefs, 7)
    assert [(float(a), int(b), str(c)) for a, b, c in got] == \
        [(float(a), int(b), str(c)) for a, b, c in want]
    triples = [(n, m, c) for (n, m), c in coefs.items()]
    assert tpoly.zernikes_to_magnitude_angle_nmkey(triples) == \
        jpoly.zernikes_to_magnitude_angle_nmkey(triples)
    assert tpoly.zernikes_to_magnitude_angle(triples) == jpoly.zernikes_to_magnitude_angle(triples)


def test_python_scalars_take_config_precision():
    """A Python number becomes a config.precision tensor, as jnp.asarray takes x64."""
    out = tpoly.cheby1(3, 0.25)
    assert torch.is_tensor(out) and out.dtype == torch.float64
    assert float(out) == float(jpoly.cheby1(3, jnp.asarray(0.25)))


JAX_POLY_NAMES = sorted(n for n in dir(jpoly) if not n.startswith('_') and 'barplot' not in n)


@pytest.mark.parametrize('name', JAX_POLY_NAMES)
def test_port_exports_every_polynomials_name(name):
    assert hasattr(tpoly, name), f'prysm_tpu_torch.polynomials lacks {name}'
