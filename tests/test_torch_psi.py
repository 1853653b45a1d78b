"""The port's phase-shifting interferometry (x/psi.py) against the JAX package's.

The orthonormal 2-D DCT-II and its inverse, which the port builds from
``torch.fft``, are held against ``scipy.fft.dctn``/``idctn`` for even and
odd sizes (1e-12 of the peak); the PSI functions against the JAX package's
on the same numpy frames under ``jax_enable_x64`` with
``config.precision = 64`` and the CPU asked for (1e-12).
"""
import numpy as np
import pytest
import scipy.fft
import torch

import jax.numpy as jnp

from prysm_tpu._richdata import RichData as JRichData
from prysm_tpu.x import psi as jpsi

from prysm_tpu_torch._richdata import RichData
from prysm_tpu_torch.conf import config
from prysm_tpu_torch.interop import scheme_from_numpy
from prysm_tpu_torch.x import psi

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_f64(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _close(a, b, rtol=1e-12):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= rtol * np.abs(b).max(), (err, np.abs(b).max())


@pytest.mark.parametrize('shape', [(8, 8), (7, 9), (16, 5), (1, 6), (13, 1)])
def test_dct_helpers_against_scipy(shape):
    x = np.random.default_rng(sum(shape)).normal(size=shape)
    _close(psi.dctn2(torch.from_numpy(x)), scipy.fft.dctn(x, type=2, norm='ortho'))
    _close(psi.idctn2(torch.from_numpy(x)), scipy.fft.idctn(x, type=2, norm='ortho'))
    _close(psi.idctn2(psi.dctn2(torch.from_numpy(x))), x)


def test_dct_helpers_batch_over_leading_axes():
    x = np.random.default_rng(0).normal(size=(3, 6, 7))
    _close(psi.dctn2(torch.from_numpy(x)), scipy.fft.dctn(x, type=2, norm='ortho', axes=(-2, -1)))


def test_schemes_match():
    for name in ('ZYGO_THIRTEEN_FRAME', 'SCHWIDER'):
        ours, ref = getattr(psi, name), getattr(jpsi, name)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _frames(scheme, shape=(20, 24), seed=0):
    y, x = np.mgrid[:shape[0], :shape[1]]
    phi = 0.3 * x - 0.2 * y + np.random.default_rng(seed).normal(scale=0.1, size=shape)
    shifts = np.asarray(scheme.shifts)
    return 1 + 0.7 * np.cos(phi[None] + shifts[:, None, None])


@pytest.mark.parametrize('name', ['ZYGO_THIRTEEN_FRAME', 'SCHWIDER'])
def test_degroot_both_schemes(name):
    scheme = getattr(jpsi, name)
    frames = _frames(scheme)
    ours = scheme_from_numpy(*(np.asarray(v) for v in scheme))
    for a, b in zip(psi.psi_accumulate(torch.from_numpy(frames), ours),
                    jpsi.psi_accumulate(jnp.asarray(frames), scheme)):
        _close(a, b)
    _close(psi.degroot_formalism_psi(torch.from_numpy(frames), ours),
           jpsi.degroot_formalism_psi(jnp.asarray(frames), scheme))
    # a list of RichData frames gives RichData
    rd = psi.degroot_formalism_psi([RichData(torch.from_numpy(f), 0.1, 0.6) for f in frames], ours)
    jrd = jpsi.degroot_formalism_psi([JRichData(jnp.asarray(f), 0.1, 0.6) for f in frames], scheme)
    assert isinstance(rd, RichData) and (rd.dx, rd.wavelength) == (0.1, 0.6)
    _close(rd.data, jrd.data)


@pytest.mark.parametrize('window', [None, 'hann', 'array'])
def test_design_scheme(window):
    if window == 'array':
        window = np.linspace(0.5, 1.0, 7)
    ours, ref = psi.design_scheme(7, window=window), jpsi.design_scheme(7, window=window)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-15)
    for a, b in zip(psi.design_scheme(5, stepsize=0.4), jpsi.design_scheme(5, stepsize=0.4)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-15)
    frames = _frames(ours, (9, 10), seed=2)
    _close(psi.degroot_formalism_psi(torch.from_numpy(frames), ours),
           jpsi.degroot_formalism_psi(jnp.asarray(frames), ref))


@pytest.mark.parametrize('shape', [(32, 32), (27, 34)])
@pytest.mark.parametrize('masked', [False, True])
def test_unwrap_phase(shape, masked):
    y, x = np.mgrid[:shape[0], :shape[1]]
    truth = 0.02 * (x - 12.0) ** 2 + 0.5 * y + 3.0
    wrapped = np.angle(np.exp(1j * truth))
    mask = None
    if masked:
        mask = np.hypot(x - shape[1] / 2, y - shape[0] / 2) < min(shape) / 2 - 2
    got = psi.unwrap_phase(torch.from_numpy(wrapped), mask)
    ref = jpsi.unwrap_phase(jnp.asarray(wrapped), None if mask is None else jnp.asarray(mask))
    _close(got, ref)
    if not masked:
        # residue-free phase: exact up to 2 pi k
        d = got.numpy() - truth
        assert np.ptp(d) < 1e-9
    rd = psi.unwrap_phase(RichData(torch.from_numpy(wrapped), 0.2, 0.6))
    assert isinstance(rd, RichData) and rd.dx == 0.2
    _close(rd.data, jpsi.unwrap_phase(JRichData(jnp.asarray(wrapped), 0.2, 0.6)).data)


def test_unwrap_phase_differentiates():
    wrapped = torch.from_numpy(np.angle(np.exp(1j * np.linspace(0, 9, 63).reshape(7, 9))))
    wrapped.requires_grad_(True)
    psi.unwrap_phase(wrapped).square().sum().backward()
    assert torch.isfinite(wrapped.grad).all()
