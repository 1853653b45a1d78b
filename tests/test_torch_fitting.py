"""The port's fitting tools against the JAX package: hopkins, lstsq, normalize, orthogonalize.

The same numpy inputs go through the JAX function in x64 and the port on
the CPU in float64, with ``config.precision = 64``.  Bars: 1e-12 of the
reference's max |value| for ``hopkins``, ``sum_of_2d_modes`` and
``normalize_modes``; 1e-10 for ``lstsq`` and ``orthogonalize_modes``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import prysm_tpu.polynomials as jpoly
import prysm_tpu_torch.polynomials as tpoly
from prysm_tpu_torch.conf import config, set_matmul_precision

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def f64_on_cpu(monkeypatch):
    """Python numbers become float64 CPU tensors in the port, as x64 arrays in JAX."""
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(got, want, tol):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    err = np.abs(g - w).max() / np.abs(w).max()
    assert err <= tol, f'{err:.3e} > {tol:g}'


def _disk(shape):
    """(r, t, mask) on an FFT-aligned grid over the unit disk."""
    ny, nx = shape
    x, y = np.meshgrid((np.arange(nx) - nx // 2) / (nx / 2), (np.arange(ny) - ny // 2) / (ny / 2))
    r, t = np.hypot(x, y), np.arctan2(y, x)
    return r, t, r <= 1


NMS = [jpoly.noll_to_nm(j) for j in range(1, 16)]


def _modes(shape):
    r, t, mask = _disk(shape)
    return np.asarray(jpoly.zernike_nm_seq(NMS, jnp.asarray(r), jnp.asarray(t))), mask


@pytest.mark.parametrize('a,b,c', [(0, 4, 0), (1, 3, 1), (-2, 2, 2), (3, 3, 1)])
def test_hopkins_matches_jax(a, b, c):
    r, t, _ = _disk((9, 12))
    _close(tpoly.hopkins(a, b, c, torch.from_numpy(r), torch.from_numpy(t), 0.7),
           jpoly.hopkins(a, b, c, jnp.asarray(r), jnp.asarray(t), 0.7), 1e-12)
    _close(tpoly.hopkins(a, b, c, torch.from_numpy(r), 0.4, 0.7),
           jpoly.hopkins(a, b, c, jnp.asarray(r), jnp.asarray(0.4), 0.7), 1e-12)


@pytest.mark.parametrize('shape', [(16, 16), (15, 17)])
def test_lstsq_with_nans_matches_jax(shape):
    """NaN points are zeroed out of the normal equations; the fit recovers the coefficients."""
    modes, mask = _modes(shape)
    truth = np.random.default_rng(1).normal(size=len(NMS))
    data = np.tensordot(truth, modes, axes=1)
    data[~mask] = np.nan
    got = tpoly.lstsq(torch.from_numpy(modes), torch.from_numpy(data))
    _close(got, jpoly.lstsq(jnp.asarray(modes), jnp.asarray(data)), 1e-10)
    _close(got, truth, 1e-10)
    # a list of mode arrays and numpy data work too
    _close(tpoly.lstsq([torch.from_numpy(m) for m in modes], data), truth, 1e-10)


def test_lstsq_noisy_fit_matches_jax():
    modes, mask = _modes((20, 18))
    rng = np.random.default_rng(2)
    data = rng.normal(size=mask.shape)
    data[~mask] = np.nan
    data[3, 4] = np.nan
    _close(tpoly.lstsq(torch.from_numpy(modes), torch.from_numpy(data)),
           jpoly.lstsq(jnp.asarray(modes), jnp.asarray(data)), 1e-10)


@pytest.mark.parametrize('to', ['std', 'ptp'])
@pytest.mark.parametrize('shape', [(16, 16), (15, 17)])
def test_normalize_modes_matches_jax(shape, to):
    modes, mask = _modes(shape)
    _close(tpoly.normalize_modes(torch.from_numpy(modes), mask, to),
           jpoly.normalize_modes(jnp.asarray(modes), jnp.asarray(mask), to), 1e-12)
    # one 2-D mode, and a float mask
    _close(tpoly.normalize_modes(torch.from_numpy(modes[4]), torch.from_numpy(mask * 1.0), to),
           jpoly.normalize_modes(jnp.asarray(modes[4]), jnp.asarray(mask), to), 1e-12)
    with pytest.raises(ValueError):
        tpoly.normalize_modes(torch.from_numpy(modes), mask, 'rms')


@pytest.mark.parametrize('shape', [(16, 16), (15, 17)])
def test_orthogonalize_modes_matches_jax(shape):
    modes, mask = _modes(shape)
    got = tpoly.orthogonalize_modes(torch.from_numpy(modes), torch.from_numpy(mask))
    _close(got, jpoly.orthogonalize_modes(jnp.asarray(modes), jnp.asarray(mask)), 1e-10)
    flat = got.reshape(len(NMS), -1)
    _close(flat @ flat.T, np.eye(len(NMS)), 1e-12)
    assert float(got[:, ~torch.from_numpy(mask)].abs().max()) < 1e-12


def test_sum_of_2d_modes_takes_a_list():
    modes, _ = _modes((8, 9))
    w = np.random.default_rng(3).normal(size=len(NMS))
    listed = [torch.from_numpy(m) for m in modes]
    _close(tpoly.sum_of_2d_modes(listed, torch.from_numpy(w)),
           jpoly.sum_of_2d_modes(list(jnp.asarray(modes)), jnp.asarray(w)), 1e-12)
    bar = np.random.default_rng(4).normal(size=modes.shape[1:])
    _close(tpoly.sum_of_2d_modes_adjoint(listed, torch.from_numpy(bar)),
           jpoly.sum_of_2d_modes_adjoint(list(jnp.asarray(modes)), jnp.asarray(bar)), 1e-12)


def test_lstsq_leaves_the_matmul_precision_alone():
    """lstsq does not switch TF32 on; it runs under whatever set_matmul_precision set."""
    modes, mask = _modes((8, 8))
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        for mode, flag in (('highest', False), ('high', True)):
            set_matmul_precision(mode)
            tpoly.lstsq(torch.from_numpy(modes), torch.from_numpy(np.where(mask, 1.0, np.nan)))
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


JAX_POLY_NAMES = sorted(n for n in dir(jpoly) if not n.startswith('_') and 'barplot' not in n)


@pytest.mark.parametrize('name', JAX_POLY_NAMES)
def test_port_exports_every_polynomials_name(name):
    assert hasattr(tpoly, name), f'prysm_tpu_torch.polynomials lacks {name}'
