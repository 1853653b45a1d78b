"""The port's configuration and scalar/polynomial helpers against the JAX package.

Same inputs through both packages on the CPU in float64.  Bars: exact for
host-side integer and scalar helpers; 1e-12 relative for polynomial
values (float64 rounding of the same recurrences).
"""
from importlib import import_module

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prysm_tpu import mathops as jmathops
from prysm_tpu import util as jutil
from prysm_tpu.polynomials import zernike as jzernike
from prysm_tpu.polynomials import sum_of_2d_modes_adjoint as jax_modes_adjoint

import prysm_tpu_torch
from prysm_tpu_torch import mathops, util
from prysm_tpu_torch._richdata import RichData
from prysm_tpu_torch.conf import Config, config
from prysm_tpu_torch.coordinates import make_xy_grid
from prysm_tpu_torch.polynomials import zernike as tzernike
from prysm_tpu_torch.polynomials import sum_of_2d_modes_adjoint
from prysm_tpu_torch.steps import COEFS6, build_cfg1_step, build_cfg2_step, make_pupil
from prysm_tpu_torch.propagation import prepare_executor

torch.set_num_threads(2)

# the packages' __init__ rebinds `jacobi` to the function; take the modules
jjacobi = import_module('prysm_tpu.polynomials.jacobi')
tjacobi = import_module('prysm_tpu_torch.polynomials.jacobi')


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_precision_pair_and_setter():
    c = Config()
    assert (c.precision, c.precision_complex) == (torch.float32, torch.complex64)
    c.precision = 64
    assert (c.precision, c.precision_complex) == (torch.float64, torch.complex128)
    c.precision = torch.float32
    assert c.precision_complex == torch.complex64
    for bad in (8, torch.complex64, 'f32'):
        with pytest.raises(ValueError):
            c.precision = bad
    c.precision = None
    assert c.precision == torch.float32


def test_default_device_is_cuda_and_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert Config().device == 'cuda'
    for build in (lambda: make_xy_grid(8),
                  lambda: make_pupil(8),
                  lambda: prepare_executor(0.1, 8, 0.5, 4, 0.55, 10.0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_config_device_cpu_is_honoured(monkeypatch):
    monkeypatch.setattr(config, '_device', 'cpu')
    x, _ = make_xy_grid(4)
    assert x.device.type == 'cpu' and x.dtype == torch.float32
    assert prysm_tpu_torch.config is config


def test_mathops_match_jax():
    theta = np.linspace(-4, 4, 17)
    np.testing.assert_allclose(mathops.cis(torch.from_numpy(theta)).numpy(),
                               np.asarray(jmathops.cis(jnp.asarray(theta))), atol=1e-15)
    for v in (-3, 0, 2, 7):
        assert mathops.sign(v) == jmathops.sign(v)
        assert mathops.is_odd(v) == jmathops.is_odd(v)
        assert mathops.kronecker(v, 2) == jmathops.kronecker(v, 2)


_HOST_ARGS = {
    'float': (2.5,),
    'int and numpy scalar': (3, np.float32(1.5)),
    'numpy arrays': (np.arange(6.0).reshape(2, 3), np.linspace(0, 1, 5) + 1j),
    'array and scalar': (np.eye(3, dtype=np.float32), 7.0),
}


@pytest.mark.parametrize('args', list(_HOST_ARGS.values()), ids=list(_HOST_ARGS))
def test_array_to_true_numpy_matches_jax(args):
    """numpy and scalars pass through as in the JAX package: one input gives one
    value, several a list; no input gives None."""
    got, want = mathops.array_to_true_numpy(*args), jmathops.array_to_true_numpy(*args)
    if len(args) == 1:
        got, want = [got], [want]
    assert isinstance(got, list) and len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g) is type(w)
        np.testing.assert_array_equal(g, w)
    assert mathops.array_to_true_numpy() is jmathops.array_to_true_numpy() is None


def test_array_to_true_numpy_takes_tensors_to_host():
    """A tensor, also one that needs a gradient or holds a lazy conjugate, comes back
    as a host numpy array equal to the JAX package's conversion of the same values."""
    a = np.linspace(-1, 1, 12).reshape(3, 4) + 0.5j
    t = torch.from_numpy(a).conj()
    w = torch.ones(4, dtype=torch.float64, requires_grad=True)
    got_t, got_w = mathops.array_to_true_numpy(t, w)
    assert isinstance(got_t, np.ndarray) and isinstance(got_w, np.ndarray)
    np.testing.assert_array_equal(got_t, jmathops.array_to_true_numpy(jnp.asarray(a.conj())))
    np.testing.assert_array_equal(got_w, np.ones(4))


def test_host_planner_points_config_at_the_cpu(monkeypatch):
    """Inside ``host_planner`` constructors build on the CPU; on exit, and after an
    exception, ``config.device`` is what it was."""
    monkeypatch.setattr(config, '_device', 'cuda')
    with mathops.host_planner():
        assert config.device == 'cpu'
        x, _ = make_xy_grid(4)
        assert x.device.type == 'cpu'
    assert config.device == 'cuda'
    with pytest.raises(ValueError), mathops.host_planner():
        raise ValueError
    assert config.device == 'cuda'


@pytest.mark.parametrize('alpha,beta', [(0, 0), (0, 3), (1, -1), (2, 1)])
def test_jacobi_matches_jax(alpha, beta):
    for n in range(6):
        assert tjacobi.recurrence_abc(n, alpha, beta) == jjacobi.recurrence_abc(n, alpha, beta)
    x = np.linspace(-1, 1, 41)
    seq = tjacobi.jacobi_seq(range(7), alpha, beta, torch.from_numpy(x))
    jseq = jjacobi.jacobi_seq(range(7), alpha, beta, jnp.asarray(x))
    assert _rel(seq.numpy(), jseq) < 1e-12
    assert _rel(tjacobi.jacobi(5, alpha, beta, torch.from_numpy(x)).numpy(),
                jjacobi.jacobi(5, alpha, beta, jnp.asarray(x))) < 1e-12


@pytest.mark.parametrize('norm', [True, False])
def test_zernike_nm_and_seq_match_jax(norm):
    nms = [(n, m) for n in range(8) for m in range(-n, n + 1, 2)]
    rng = np.random.default_rng(0)
    r, t = rng.random((12, 14)), rng.uniform(-np.pi, np.pi, (12, 14))
    seq = tzernike.zernike_nm_seq(nms, torch.from_numpy(r), torch.from_numpy(t), norm=norm)
    jseq = jzernike.zernike_nm_seq(nms, jnp.asarray(r), jnp.asarray(t), norm=norm)
    assert _rel(seq.numpy(), jseq) < 1e-12
    for n, m in ((4, -2), (5, 3), (0, 0)):
        one = tzernike.zernike_nm(n, m, torch.from_numpy(r), torch.from_numpy(t), norm=norm)
        jone = jzernike.zernike_nm(n, m, jnp.asarray(r), jnp.asarray(t), norm=norm)
        assert _rel(one.numpy(), jone) < 1e-12
        assert tzernike.zernike_norm(n, m) == jzernike.zernike_norm(n, m)


def test_zernike_index_converters_match_jax():
    for n in range(9):
        for m in range(-n, n + 1, 2):
            assert tzernike.nm_to_fringe(n, m) == jzernike.nm_to_fringe(n, m)
            assert tzernike.nm_to_ansi_j(n, m) == jzernike.nm_to_ansi_j(n, m)
    for idx in range(1, 40):
        assert tzernike.ansi_j_to_nm(idx) == jzernike.ansi_j_to_nm(idx)
        assert tzernike.noll_to_nm(idx) == jzernike.noll_to_nm(idx)
        assert tzernike.fringe_to_nm(idx) == jzernike.fringe_to_nm(idx)


def test_zernike_sum_non_2d_uses_the_mode_stack():
    nms = [(2, 0), (3, -1)]
    x, y = np.linspace(-0.9, 0.8, 9), np.linspace(0.7, -0.6, 9)
    c = np.asarray([0.5, -2.0])
    out = tzernike.zernike_sum(torch.from_numpy(c), nms, torch.from_numpy(x), torch.from_numpy(y))
    ref = jzernike.zernike_sum(jnp.asarray(c), nms, jnp.asarray(x), jnp.asarray(y))
    assert _rel(out.numpy(), ref) < 1e-12
    assert torch.all(tzernike.zernike_sum([], [], torch.ones(3), torch.ones(3)) == 0)


def test_modes_adjoint_matches_jax():
    rng = np.random.default_rng(1)
    modes, bar = rng.standard_normal((4, 6, 5)), rng.standard_normal((6, 5))
    np.testing.assert_allclose(
        sum_of_2d_modes_adjoint(torch.from_numpy(modes), torch.from_numpy(bar)).numpy(),
        np.asarray(jax_modes_adjoint(jnp.asarray(modes), jnp.asarray(bar))), rtol=1e-13)


def test_step_builders_take_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_cfg2_step(N=16, fN=8)
    loss, grad = build_cfg2_step(N=16, fN=8, dtype=torch.float64, device='cpu')(
        torch.tensor(COEFS6, dtype=torch.float64))
    assert grad.shape == (6,) and torch.isfinite(loss)
    loss, grad, mtf = build_cfg1_step(N=16, device='cpu')(torch.tensor(COEFS6))
    assert mtf.shape == (32, 32) and grad.dtype == torch.float32


def test_wavefront_phase_screen_and_phase_match_jax():
    from prysm_tpu.propagation import Wavefront as JaxWavefront
    from prysm_tpu_torch.propagation import Wavefront
    opd = np.random.default_rng(3).normal(scale=40.0, size=(8, 9))
    wf = Wavefront.phase_screen(torch.from_numpy(opd), 0.55, 0.1)
    jwf = JaxWavefront.phase_screen(jnp.asarray(opd), 0.55, 0.1)
    np.testing.assert_allclose(wf.data.numpy(), np.asarray(jwf.data), atol=1e-14)
    np.testing.assert_allclose(wf.phase.data.numpy(), np.asarray(jwf.phase.data), atol=1e-13)


def test_richdata_pv_rms_match_jax():
    z = np.random.default_rng(2).normal(scale=30.0, size=(16, 16))
    z[3, 4] = np.nan
    rd = RichData(torch.from_numpy(z), 0.1, 0.6328)
    # RichData has no pv / rms, as in the JAX package: the statistics are util's
    assert not hasattr(rd, 'pv') and not hasattr(rd, 'rms')
    assert float(util.pv(rd.data)) == pytest.approx(float(jutil.pv(jnp.asarray(z))), rel=1e-14)
    assert float(util.rms(rd.data)) == pytest.approx(float(jutil.rms(jnp.asarray(z))), rel=1e-14)
    assert rd.shape == (16, 16)
