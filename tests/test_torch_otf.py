"""The port's OTF family (``prysm_tpu_torch.otf``) against the JAX package.

Same numpy PSFs through both packages on the CPU in float64.  Bars: 1e-12
(absolute on the centre-normalized MTF, which is at most 1, and relative
elsewhere): float64 rounding of differently ordered FFT passes.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prysm_tpu import otf as jotf

from prysm_tpu_torch import otf
from prysm_tpu_torch._richdata import RichData

torch.set_num_threads(2)


def _psf(shape, seed):
    """A smooth positive PSF-like array: a bright core on a noisy floor."""
    rng = np.random.default_rng(seed)
    ny, nx = shape[-2:]
    y, x = np.meshgrid(np.arange(ny) - ny // 2, np.arange(nx) - nx // 2, indexing='ij')
    core = np.exp(-(x ** 2 + y ** 2) / 6.0)
    return core + 0.05 * rng.random(shape)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize('shape', [(32, 32), (24, 40), (2, 16, 16)],
                         ids=['square', 'rect', 'batched'])
def test_mtf_rfft_path_matches_jax(shape):
    p = _psf(shape, 1)
    m = otf.mtf_from_psf(torch.from_numpy(p), 1.5)
    jm = jotf.mtf_from_psf(jnp.asarray(p), 1.5)
    assert np.abs(m.data.numpy() - np.asarray(jm.data)).max() < 1e-12
    assert m.dx == pytest.approx(jm.dx, rel=1e-15)
    cy, cx = shape[-2] // 2, shape[-1] // 2
    assert np.all(m.data.numpy()[..., cy, cx] == 1.0)


@pytest.mark.parametrize('shape,return_more', [((31, 33), False), ((32, 32), True)],
                         ids=['odd', 'return-more'])
def test_mtf_complex_path_matches_jax(shape, return_more):
    p = _psf(shape, 2)
    out = otf.mtf_from_psf(torch.from_numpy(p), 0.7, return_more=return_more)
    jout = jotf.mtf_from_psf(jnp.asarray(p), 0.7, return_more=return_more)
    if return_more:
        (out, data), (jout, jdata) = out, jout
        assert _rel(data.numpy(), jdata) < 1e-12
    assert np.abs(out.data.numpy() - np.asarray(jout.data)).max() < 1e-12


def test_rfft_and_complex_paths_agree():
    p = torch.from_numpy(_psf((40, 24), 3))
    fast = otf.mtf_from_psf(p, 1.0).data
    full, _ = otf.mtf_from_psf(p, 1.0, return_more=True)
    assert (fast - full.data).abs().max() < 1e-12


@pytest.mark.parametrize('name', ['otf_from_psf', 'ptf_from_psf'])
def test_otf_ptf_match_jax(name):
    p = _psf((20, 28), 4)
    out = getattr(otf, name)(RichData(torch.from_numpy(p), 2.0, 0.55))
    jout = getattr(jotf, name)(jnp.asarray(p), 2.0)
    assert np.abs(out.data.numpy() - np.asarray(jout.data)).max() < 1e-12
    assert out.dx == pytest.approx(jout.dx, rel=1e-15)


def test_transform_psf_and_adjoint_match_jax():
    p = _psf((18, 22), 5)
    data, df = otf.transform_psf(torch.from_numpy(p), 0.5)
    jdata, jdf = jotf.transform_psf(jnp.asarray(p), 0.5)
    assert _rel(data.numpy(), jdata) < 1e-12 and df == pytest.approx(jdf, rel=1e-15)
    g = np.random.default_rng(6).standard_normal((18, 22)) + 0j
    assert _rel(otf.transform_psf_adjoint(torch.from_numpy(g)).numpy(),
                jotf.transform_psf_adjoint(jnp.asarray(g))) < 1e-12


def test_mtf_gradient_matches_jax():
    p = _psf((16, 16), 7)
    w = np.random.default_rng(8).standard_normal((16, 16))
    gj = jax.grad(lambda q: jnp.sum(jnp.asarray(w) * jotf.mtf_from_psf(q, 1.0).data))(
        jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_(True)
    torch.sum(torch.from_numpy(w) * otf.mtf_from_psf(pt, 1.0).data).backward()
    assert _rel(pt.grad.numpy(), gj) < 1e-10


def test_mtf_requires_dx():
    with pytest.raises(ValueError):
        otf.mtf_from_psf(torch.ones(4, 4))
