"""The port's Bayer module (``prysm_tpu_torch.bayer``) against the JAX package's.

Same numpy inputs into both, float64 on the CPU, both colour-filter
arrays.  Mosaic shuffles are exact; the demosaics agree to 1e-12 (the
shifted adds run in the same order); white balance to 1e-14; the
Fourier-shift assembly to 1e-10.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prysm_tpu import bayer as jb

from prysm_tpu_torch import bayer

torch.set_num_threads(2)

CFAS = ['rggb', 'bggr']


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1000, shape) for _ in range(4)]


@pytest.mark.parametrize('cfa', CFAS)
def test_composite_decomposite_recomposite_match_jax(cfa):
    planes = _planes((24, 30), 0)
    mosaic = bayer.composite_bayer(*(torch.from_numpy(p) for p in planes), cfa=cfa)
    want = np.asarray(jb.composite_bayer(*(jnp.asarray(p) for p in planes), cfa=cfa))
    assert np.array_equal(mosaic.numpy(), want)
    quarter = bayer.decomposite_bayer(mosaic, cfa)
    for got, ref in zip(quarter, jb.decomposite_bayer(jnp.asarray(want), cfa)):
        assert np.array_equal(got.numpy(), np.asarray(ref))
    back = bayer.recomposite_bayer(*quarter, cfa=cfa)
    ref = jb.recomposite_bayer(*(jnp.asarray(q.numpy()) for q in quarter), cfa=cfa)
    assert np.array_equal(back.numpy(), np.asarray(ref))
    assert np.array_equal(back.numpy(), want)


def test_recomposite_of_a_stack_matches_jax():
    quarter = [p.reshape(2, 6, 5) for p in _planes((12, 5), 1)]
    got = bayer.recomposite_bayer(*(torch.from_numpy(q) for q in quarter))
    want = jb.recomposite_bayer(*(jnp.asarray(q) for q in quarter))
    assert got.shape == (2, 12, 10) and np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('cfa', CFAS)
@pytest.mark.parametrize('shape', [(32, 48), (33, 47)], ids=['even', 'odd'])
def test_demosaic_malvar_matches_jax(cfa, shape):
    img = np.random.default_rng(2).uniform(0, 16383, shape)
    got = bayer.demosaic_malvar(torch.from_numpy(img), cfa).numpy()
    want = np.asarray(jb.demosaic_malvar(jnp.asarray(img), cfa))
    assert got.shape == (*shape, 3) and _rel(got, want) < 1e-12


def test_demosaic_malvar_casts_integer_frames_to_the_working_precision():
    dn = np.random.default_rng(3).integers(0, 2 ** 14, (16, 20)).astype(np.uint16)
    got = bayer.demosaic_malvar(torch.from_numpy(dn))
    assert got.dtype == torch.float32
    assert torch.equal(got, bayer.demosaic_malvar(torch.from_numpy(dn).to(torch.float32)))
    want = np.asarray(jb.demosaic_malvar(jnp.asarray(dn.astype(np.float64))))
    assert _rel(got.numpy(), want) < 1e-6


def test_demosaic_malvar_reproduces_a_flat_field():
    flat = torch.full((20, 24), 37.0, dtype=torch.float64)
    assert torch.equal(bayer.demosaic_malvar(flat), torch.full((20, 24, 3), 37.0,
                                                               dtype=torch.float64))


def test_symmetric_pad_matches_numpy():
    a = np.arange(30.0).reshape(5, 6)
    got = bayer._pad_symmetric(torch.from_numpy(a), 2).numpy()
    assert np.array_equal(got, np.pad(a, 2, mode='symmetric'))


@pytest.mark.parametrize('cfa', CFAS)
def test_demosaic_deinterlace_matches_jax(cfa):
    img = np.random.default_rng(4).uniform(0, 100, (18, 22))
    got = bayer.demosaic_deinterlace(torch.from_numpy(img), cfa).numpy()
    want = np.asarray(jb.demosaic_deinterlace(jnp.asarray(img), cfa))
    assert got.shape == (9, 11, 3) and _rel(got, want) < 1e-15


@pytest.mark.parametrize('cfa', CFAS)
@pytest.mark.parametrize('safe', [False, True], ids=['plain', 'safe'])
def test_wb_prescale_matches_jax(cfa, safe):
    img = np.random.default_rng(5).uniform(0, 1000, (16, 18))
    kw = dict(cfa=cfa, safe=safe, saturation=[900.0, 1100.0, 1000.0, 800.0] if safe else None)
    got = bayer.wb_prescale(torch.from_numpy(img), 1.8, 1.0, 1.1, 2.2, **kw).numpy()
    want = np.asarray(jb.wb_prescale(jnp.asarray(img), 1.8, 1.0, 1.1, 2.2, **kw))
    assert _rel(got, want) < 1e-14


@pytest.mark.parametrize('safe', [False, True], ids=['plain', 'safe'])
def test_wb_postscale_matches_jax(safe):
    rgb = np.random.default_rng(6).uniform(0, 1000, (10, 12, 3))
    kw = dict(safe=safe, saturation=950.0 if safe else None)
    got = bayer.wb_postscale(torch.from_numpy(rgb), 1.9, 1.0, 2.1, **kw).numpy()
    want = np.asarray(jb.wb_postscale(jnp.asarray(rgb), 1.9, 1.0, 2.1, **kw))
    assert _rel(got, want) < 1e-14


def test_white_balance_refuses_bad_saturation():
    img = torch.ones(8, 8, dtype=torch.float64)
    with pytest.raises(ValueError):
        bayer.wb_prescale(img, 1, 1, 1, 1, safe=True)
    with pytest.raises(ValueError):
        bayer.wb_prescale(img, 1, 1, 1, 1, safe=True, saturation=[1, 2, 3])
    with pytest.raises(ValueError):
        bayer.wb_postscale(torch.ones(4, 4, 3), 1, 1, 1, safe=True, saturation=[1, 0, 1])


def test_unknown_cfa_raises():
    img = torch.ones(8, 8)
    for fn in (lambda: bayer.composite_bayer(img, img, img, img, cfa='grbg'),
               lambda: bayer.decomposite_bayer(img, 'grbg'),
               lambda: bayer.recomposite_bayer(img, img, img, img, cfa='grbg'),
               lambda: bayer.demosaic_malvar(img, 'grbg'),
               lambda: bayer.wb_prescale(img, 1, 1, 1, 1, cfa='grbg'),
               lambda: bayer.assemble_superresolved(img, img, img, img, 0.5, cfa='bggr')):
        with pytest.raises(NotImplementedError):
            fn()


@pytest.mark.parametrize('zoom', [0.5, 0.25])
def test_assemble_superresolved_matches_jax(zoom):
    planes = _planes((16, 20), 7)
    got = bayer.assemble_superresolved(*(torch.from_numpy(p) for p in planes), zoom).numpy()
    want = np.asarray(jb.assemble_superresolved(*(jnp.asarray(p) for p in planes), zoom))
    assert got.shape == (16, 20, 3) and _rel(got, want) < 1e-10
