"""The port's detector and noise kernel (``prysm_tpu_torch.detector``, ``ops.noise``)
against the JAX package's.

On the CPU the noise wrapper runs its plain version: Philox4x32-10 on
int64 tensors, Box-Muller, then the shot -> DN chain.  Its generator is
held to Random123's known answers; its chain to the JAX ``_dn_chain``
exactly, on the same numpy inputs; its exposures to the bars of
``tests/test_ops_pallas.py`` and to the JAX off-TPU exposure's moments.
Deterministic parts of ``Detector`` (mean electrons, quantising, LUT,
bin/tile, pixel transfer functions) agree with JAX exactly or to 1e-12.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prysm_tpu import detector as jdet
from prysm_tpu.ops.noise import _dn_chain as jax_dn_chain
from prysm_tpu.ops.noise import expose_pallas as jax_expose_pallas

from prysm_tpu_torch import detector, interop
from prysm_tpu_torch.ops import noise

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

KNOWN_ANSWERS = [
    # (counter, key, output), from Random123's kat_vectors for philox4x32-10
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2, (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize('counter, key, want', KNOWN_ANSWERS, ids=['zeros', 'ones', 'pi'])
def test_philox_known_answers(counter, key, want):
    got = noise.philox4x32_10(*(torch.tensor(c) for c in counter), *key)
    assert tuple(int(w) for w in got) == want


def _philox_int(counter, key):
    """Philox4x32-10 in Python integers: the definition, independent of the port."""
    c, (k0, k1) = list(counter), key
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + 0x9E3779B9) & 0xFFFFFFFF, (k1 + 0xBB67AE85) & 0xFFFFFFFF
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) & 0xFFFFFFFF, p1 & 0xFFFFFFFF,
             ((p0 >> 32) ^ c[3] ^ k1) & 0xFFFFFFFF, p0 & 0xFFFFFFFF]
    return c


def _cell_gaussians(words):
    """(z_shot, z_read) of a cell from its two words of Philox output, in Python floats."""
    u1, u2 = ((np.float32(x >> 8) * np.float32(2 ** -24)) + np.float32(2 ** -25) for x in words)
    r = math.sqrt(-2 * math.log(u1))
    return r * math.cos(2 * math.pi * u2), r * math.sin(2 * math.pi * u2)


@pytest.mark.parametrize('npix, frames', [(40 * 52, 3), (41 * 53, 2), (7, 5), (1, 4)],
                         ids=['even', 'odd', 'odd_small', 'one_pixel'])
def test_gaussians_follow_the_counter_layout(npix, frames):
    """Cell (frame f, pixel p) draws Philox((p // 2, f, 0, 0), (seed, STREAM)) words
    (0, 1) for an even p and (2, 3) for an odd p."""
    rng = np.random.default_rng(3)
    seed = 2 ** 32 + 77    # the seed is taken mod 2^32
    z_shot, z_read = noise._gaussians(npix, frames, seed, 'cpu')
    assert z_shot.shape == z_read.shape == (frames, npix)
    # random cells, and the last pixel of the last frame (an odd count's lone cell)
    cells = list(zip(rng.integers(0, frames, 16), rng.integers(0, npix, 16)))
    for f, p in cells + [(frames - 1, npix - 1)]:
        w = _philox_int((int(p) // 2, int(f), 0, 0), (seed & 0xFFFFFFFF, noise.STREAM))
        want_shot, want_read = _cell_gaussians(w[2:] if p % 2 else w[:2])
        assert abs(float(z_shot[f, p]) - want_shot) < 1e-5
        assert abs(float(z_read[f, p]) - want_read) < 1e-5


def test_a_pixel_pair_shares_one_philox_call():
    """Pixels 2q and 2q + 1 take words (0, 1) and (2, 3) of the call on counter (q, f, 0, 0)."""
    npix, frames, seed = 10, 2, 5
    z_shot, z_read = noise._gaussians(npix, frames, seed, 'cpu')
    q = torch.arange(npix // 2)
    for f in range(frames):
        w = noise.philox4x32_10(q, f, 0, 0, seed, noise.STREAM)
        for (a, b), cells in (((0, 1), slice(0, None, 2)), ((2, 3), slice(1, None, 2))):
            shot, read = noise.box_muller(noise.uniform01(w[a]), noise.uniform01(w[b]))
            assert torch.equal(z_shot[f, cells], shot) and torch.equal(z_read[f, cells], read)
    # the pair's two cells draw different numbers, and so do two frames
    assert not torch.equal(z_shot[0, 0::2], z_shot[0, 1::2])
    assert not torch.equal(z_shot[0], z_shot[1])


def test_uniforms_are_in_the_open_closed_unit_interval():
    bits = torch.tensor([0, 255, 256, 0xFFFFFFFF])
    u = noise.uniform01(bits)
    assert u.dtype == torch.float32
    assert float(u[0]) == 2.0 ** -25 == float(u[1])
    assert float(u[2]) == 1.5 * 2.0 ** -24
    assert float(u[3]) == 1.0     # 1 - 2^-25 rounds half to even, up to 1


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_dn_chain_matches_jax(dtype):
    rng = np.random.default_rng(0)
    lam = np.concatenate([rng.uniform(0, 5e4, 500), [4.0, 9.0, 16.0, 0.0, 1e11, 2.25]])
    z_shot = np.concatenate([rng.standard_normal(500), [0.25, 0.5, -0.125, 3.0, 8.0, 1 / 3]])
    z_read = rng.standard_normal(lam.size)
    # lam + sqrt(lam) z_shot is a half-integer tie for the first three fixed entries
    lam, z_shot, z_read = (a.astype(dtype) for a in (lam, z_shot, z_read))
    args = (5.0, 100.0, 60e3, 2.0, 16383.0)
    got = noise._dn_chain(*(torch.from_numpy(a) for a in (lam, z_shot, z_read)), *args)
    want = np.asarray(jax_dn_chain(*(jnp.asarray(a) for a in (lam, z_shot, z_read)), *args))
    assert got.dtype == torch.from_numpy(lam).dtype
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# exposures
# ---------------------------------------------------------------------------

def test_expose_fused_zero_signal_gives_240():
    det = detector.Detector(dark_current=0.0, read_noise=0.0, bias=150.0, fwc=120.0,
                            conversion_gain=0.5, bits=8, exposure_time=1.0)
    out = det.expose_fused(torch.zeros(40, 52), frames=1, seed=3)
    assert out.shape == (40, 52) and out.dtype == torch.uint8
    assert bool((out == 240).all())
    assert det.last_expose_path == 'fused'


def _moment_detector():
    return detector.Detector(dark_current=10.0, read_noise=5.0, bias=200.0, fwc=90000.0,
                             conversion_gain=1.0, bits=16, exposure_time=1.0)


def test_expose_fused_moments_and_reproducibility():
    det, lam, frames = _moment_detector(), 2000.0, 24
    img = torch.full((64, 64), lam)
    out = det.expose_fused(img, frames=frames, seed=7).to(torch.float64)
    assert out.shape == (frames, 64, 64)
    expect_mean, expect_var = lam + 10.0 + 200.0, (lam + 10.0) + 5.0 ** 2
    assert abs(float(out.mean()) - expect_mean) / expect_mean < 0.01
    assert abs(float(out.var(correction=0)) - expect_var) / expect_var < 0.05
    again = det.expose_fused(img, frames=frames, seed=7).to(torch.float64)
    assert torch.equal(out, again)
    other = det.expose_fused(img, frames=frames, seed=8).to(torch.float64)
    assert not torch.equal(out, other)


def test_expose_pallas_moments_match_jax_off_tpu():
    """The port's plain chain and the JAX off-TPU chain agree in moments (their bits differ)."""
    lam, frames = 2000.0, 24
    args = (frames, 7, 5.0, 200.0, 90000.0, 1.0, 16)
    port = noise.expose_pallas(torch.full((64, 64), lam), *args).double().numpy()
    ref = np.asarray(jax_expose_pallas(jnp.full((64, 64), lam, jnp.float32), *args),
                     dtype=np.float64)
    assert port.shape == ref.shape == (frames, 64, 64)
    assert abs(port.mean() - ref.mean()) / ref.mean() < 0.01
    assert abs(port.var() - ref.var()) / ref.var() < 0.05


def test_expose_pallas_moments_at_bench_bars():
    """bench.py's check: 256^2 at 1000 e-, 4 frames, mean within 2%, std within 10%."""
    out = noise.expose_pallas(torch.full((256, 256), 1000.0), 4, 123, 5.0, 100.0, 60e3,
                              0.5, 14).double()
    want_mean, want_std = (1000.0 + 100.0) / 0.5, math.sqrt(1000.0 + 25.0) / 0.5
    assert abs(float(out.mean()) - want_mean) < 0.02 * want_mean
    assert abs(float(out.std(correction=0)) - want_std) < 0.1 * want_std


def test_expose_pallas_frames_differ_and_keep_the_map():
    lam = torch.linspace(50.0, 5000.0, 40 * 52).reshape(40, 52)
    out = noise.expose_pallas(lam, 3, 11, 5.0, 100.0, 60e3, 0.5, 14)
    assert out.shape == (3, 40, 52) and out.dtype == torch.float32
    assert not torch.equal(out[0], out[1]) and not torch.equal(out[1], out[2])
    # each frame follows the map: DN * gain - bias tracks lam
    resid = (out.double() * 0.5 - 100.0 - lam.double()) / torch.sqrt(lam.double() + 25.0)
    assert abs(float(resid.mean())) < 0.1 and abs(float(resid.var()) - 1) < 0.1


def test_expose_pallas_takes_float64_and_rejects_non_2d():
    lam = torch.full((8, 8), 300.0, dtype=torch.float64)
    out = noise.expose_pallas(lam, 1, 0, 5.0, 100.0, 60e3, 0.5, 14)
    assert torch.equal(out, noise.expose_pallas(lam.float(), 1, 0, 5.0, 100.0, 60e3, 0.5, 14))
    with pytest.raises(ValueError):
        noise.expose_pallas(torch.ones(2, 8, 8), 1, 0, 5.0, 100.0, 60e3, 0.5, 14)


def test_launch_counter_stays_zero_on_the_cpu():
    noise.reset_launches()
    noise.expose_pallas(torch.full((8, 8), 300.0), 2, 0, 5.0, 100.0, 60e3, 0.5, 14)
    assert noise.LAUNCHES == {'noise_expose': 0}


# ---------------------------------------------------------------------------
# Detector against JAX
# ---------------------------------------------------------------------------

def _pair(**kw):
    """The same detector in both packages (port through interop)."""
    arrays = {k: kw.pop(k) for k in ('prnu', 'dcnu', 'lut') if k in kw}
    port = interop.detector_from_numpy(**kw, **arrays, device='cpu')
    ref = jdet.Detector(**kw, **{k: jnp.asarray(v) for k, v in arrays.items()})
    return port, ref


BASE = dict(dark_current=2.0, read_noise=5.0, bias=100.0, fwc=60e3, conversion_gain=0.5,
            bits=14, exposure_time=1e-2)


def test_mean_electrons_with_prnu_and_dcnu_match_jax():
    rng = np.random.default_rng(1)
    prnu, dcnu = rng.uniform(0.9, 1.1, (24, 20)), rng.uniform(0.5, 1.5, (24, 20))
    scene = rng.uniform(0, 1e6, (24, 20))
    for maps in ({}, {'prnu': prnu}, {'dcnu': dcnu}, {'prnu': prnu, 'dcnu': dcnu}):
        port, ref = _pair(**BASE, **maps)
        got = port._mean_electrons(torch.from_numpy(scene)).numpy()
        assert _rel(got, ref._mean_electrons(jnp.asarray(scene))) < 1e-15


@pytest.mark.parametrize('bits, dtype', [(8, np.uint8), (14, np.uint16), (16, np.uint16),
                                         (32, np.uint32)])
def test_quantize_dtypes_and_adc_cap_match_jax(bits, dtype):
    rng = np.random.default_rng(bits)
    dn = np.concatenate([rng.uniform(0, 2.0 ** bits - 1, 300), [0.0, 2.0 ** bits - 1, 0.5]])
    port, ref = _pair(**{**BASE, 'bits': bits})
    got = port._quantize(torch.from_numpy(dn)).numpy()
    want = np.asarray(ref._quantize(jnp.asarray(dn)))
    assert got.dtype == want.dtype == dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize('bits', [8, 14, 16])
def test_expose_saturates_at_the_adc_cap(bits):
    """A scene far past full well, with fwc / gain above the cap, reads the cap in both."""
    kw = dict(BASE, bits=bits, fwc=2.0 ** 17, conversion_gain=1.0)
    port, ref = _pair(**kw)
    scene = np.full((6, 10), 1e12)
    got = port.expose(torch.from_numpy(scene), seed=0).numpy()
    want = np.asarray(ref.expose(jnp.asarray(scene), seed=0))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want) and int(got.max()) == 2 ** bits - 1


def test_quantize_rejects_more_than_32_bits():
    port, _ = _pair(**{**BASE, 'bits': 40})
    with pytest.raises(ValueError):
        port._quantize(torch.zeros(3))


def test_lut_matches_jax():
    rng = np.random.default_rng(2)
    lut = np.sqrt(np.arange(2 ** 14, dtype=np.float64)) * 3.0
    port, ref = _pair(**BASE, lut=lut)
    dn = rng.uniform(0, 2 ** 14 - 1, (16, 12))
    got = port._quantize(torch.from_numpy(dn)).numpy()
    want = np.asarray(ref._quantize(jnp.asarray(dn)))
    assert np.array_equal(got, want)
    img16 = rng.integers(0, 2 ** 14, (9, 7)).astype(np.uint16)
    assert np.array_equal(detector.apply_lut(torch.from_numpy(img16), torch.from_numpy(lut)),
                          np.asarray(jdet.apply_lut(jnp.asarray(img16), jnp.asarray(lut))))
    img8 = rng.integers(0, 256, (9, 7)).astype(np.uint8)
    assert np.array_equal(detector.apply_lut(torch.from_numpy(img8), torch.from_numpy(lut)),
                          lut[img8])


def test_zero_signal_exposure_matches_jax_on_both_paths():
    kw = dict(dark_current=0.0, read_noise=0.0, bias=150.0, fwc=120.0, conversion_gain=0.5,
              bits=8, exposure_time=1.0)
    port, ref = _pair(**kw)
    want = np.asarray(ref.expose(jnp.zeros((40, 52)), frames=2, seed=3))
    for method in ('random', 'fused'):
        got = port.expose(torch.zeros(40, 52), frames=2, seed=3, method=method).numpy()
        assert np.array_equal(got, want)


def test_choose_path_on_cpu_tensors():
    port, _ = _pair(**BASE)
    bright = torch.full((8, 8), 1e6)
    assert port._choose_path(bright, 'auto') == 'random'
    port.expose(bright, seed=1)
    assert port.last_expose_path == 'random'
    port.expose(bright, seed=1, method='fused')
    assert port.last_expose_path == 'fused'
    with pytest.raises(ValueError):
        port._choose_path(bright, 'nope')
    with pytest.raises(ValueError):
        port.expose(bright)


def test_random_path_is_exact_poisson_and_reproducible():
    det = detector.Detector(dark_current=0.0, read_noise=0.0, bias=0.0, fwc=1e9,
                            conversion_gain=1.0, bits=16, exposure_time=1.0)
    lam = 7.5   # photon-starved: the fused kernel's approximation would not hold
    out = det.expose(torch.full((64, 64), lam), frames=8, seed=4).double()
    # bars of 5 standard errors: 0.015 for the mean, 0.06 for the variance
    assert abs(float(out.mean()) - lam) < 0.08 and abs(float(out.var()) - lam) < 0.3
    assert torch.equal(out, det.expose(torch.full((64, 64), lam), frames=8, seed=4).double())
    gen = torch.Generator().manual_seed(4)
    assert torch.equal(out, det.expose(torch.full((64, 64), lam), frames=8,
                                       generator=gen).double())


def test_fused_path_takes_its_seed_from_a_generator():
    det = _moment_detector()
    img = torch.full((16, 16), 500.0)
    a = det.expose(img, generator=torch.Generator().manual_seed(9), method='fused')
    b = det.expose(img, generator=torch.Generator().manual_seed(9), method='fused')
    assert torch.equal(a, b) and det.last_expose_path == 'fused'


@pytest.mark.parametrize('factor, mode', [(2, 'avg'), (2, 'sum'), ((3, 2), 'mean'),
                                          ((1, 4), 'sum')])
def test_bindown_matches_jax(factor, mode):
    a = np.random.default_rng(5).standard_normal((12, 16))
    got = detector.bindown(torch.from_numpy(a), factor, mode).numpy()
    want = np.asarray(jdet.bindown(jnp.asarray(a), factor, mode))
    assert got.shape == want.shape and _rel(got, want) < 1e-14


def test_bindown_of_a_frame_stack_matches_jax():
    a = np.random.default_rng(6).standard_normal((2, 8, 12))
    got = detector.bindown(torch.from_numpy(a), (1, 2, 4), 'sum').numpy()
    assert _rel(got, np.asarray(jdet.bindown(jnp.asarray(a), (1, 2, 4), 'sum'))) < 1e-14
    with pytest.raises(ValueError):
        detector.bindown(torch.from_numpy(a), 2, 'max')


@pytest.mark.parametrize('factor, scaling', [(2, 'sum'), ((3, 2), 'avg'), (4, 'mean')])
def test_tile_matches_jax(factor, scaling):
    a = np.random.default_rng(7).standard_normal((5, 6))
    got = detector.tile(torch.from_numpy(a), factor, scaling).numpy()
    want = np.asarray(jdet.tile(jnp.asarray(a), factor, scaling))
    assert got.shape == want.shape and np.array_equal(got, want)
    with pytest.raises(ValueError):
        detector.tile(torch.from_numpy(a), 2, 'max')


def test_pixel_transfer_functions_match_jax():
    f = np.linspace(-0.3, 0.3, 41)
    fx, fy = np.meshgrid(f, f * 0.7)
    tx, ty = torch.from_numpy(fx), torch.from_numpy(fy)
    assert _rel(detector.pixel_ft(tx, ty, 4.5, 3.0).numpy(),
                jdet.pixel_ft(jnp.asarray(fx), jnp.asarray(fy), 4.5, 3.0)) < 1e-13
    assert _rel(detector.olpf_ft(tx, ty, 2.0, 1.5).numpy(),
                jdet.olpf_ft(jnp.asarray(fx), jnp.asarray(fy), 2.0, 1.5)) < 1e-13
    x = np.linspace(-5, 5, 33)
    xx, yy = np.meshgrid(x, x)
    assert np.array_equal(detector.pixel(torch.from_numpy(xx), torch.from_numpy(yy), 4.0, 6.0),
                          np.asarray(jdet.pixel(jnp.asarray(xx), jnp.asarray(yy), 4.0, 6.0)))
