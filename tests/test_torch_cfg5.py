"""The port's cfg5 frame (``steps.build_cfg5_frame``) against the JAX cfg5 chain.

The body of ``bench.py`` cfg5 (6-wavelength Babinet Lyot coronagraph ->
Q=1 focus -> RGGB mosaic -> detector -> Malvar demosaic) runs in the JAX
package at N=128 with the benchmark's 32^2 focal window, in float64 on
the CPU, beside the port's frame built at the same size.  The
deterministic part agrees to 1e-9 of peak (focal intensities, mosaic);
the demosaic of one fixed numpy DN frame to 1e-12.  The exposures run the
noise kernel's plain version here; their normalised residuals are held to
the chip check's bars (mean within 0.02, variance within 3% of 1), pooled
over enough seeds that each bar is at least five standard errors wide.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prysm_tpu.bayer import composite_bayer as jax_composite_bayer
from prysm_tpu.bayer import demosaic_malvar as jax_demosaic_malvar
from prysm_tpu.coordinates import make_xy_grid
from prysm_tpu.detector import Detector as JaxDetector
from prysm_tpu.geometry import circle_sdf, antialias
from prysm_tpu.parallel import plan_mdft_spectral as jax_plan_mdft_spectral
from prysm_tpu.propagation.coronagraph import babinet as jax_babinet
from prysm_tpu.propagation.fft import focus as jax_focus

from prysm_tpu_torch import steps
from prysm_tpu_torch.bayer import demosaic_malvar
from prysm_tpu_torch.ops import noise

torch.set_num_threads(2)

N, WN = 128, 32
DET = steps.CFG5_DETECTOR


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope='module')
def jax_chain():
    """bench.py cfg5's run() up to the mosaic, at size N, in float64."""
    dx = 2.2 / N
    wvls = np.linspace(0.50, 0.60, 6)
    fw = (np.arange(WN) - WN // 2) * 0.25
    fxw, fyw = np.meshgrid(fw, fw, indexing='xy')
    fpm = jnp.asarray((np.hypot(fxw, fyw) > 2.5).astype(np.float32))
    splan = jax_plan_mdft_spectral(dx, (N, N), 0.25, WN, wvls, 10.0, dtype=jnp.complex128)
    x, y = make_xy_grid(N, diameter=2.2)
    r = jnp.hypot(x, y)
    amp, lyot = antialias(circle_sdf(1.0, r), dx), antialias(circle_sdf(0.9, r), dx)
    E = jnp.broadcast_to(amp, (len(wvls), N, N)) + 0j
    at_focus = jax_focus(jax_babinet(E, lyot=lyot, fpm=fpm, executor=splan), Q=1)
    planes = at_focus.real ** 2 + at_focus.imag ** 2
    red = planes[4:].sum(axis=0) * 3e9
    grn = planes[2:4].sum(axis=0) * 3e9
    blu = planes[:2].sum(axis=0) * 3e9
    return np.asarray(planes), np.asarray(jax_composite_bayer(red, grn, grn, blu))


@pytest.fixture(scope='module')
def frame64():
    return steps.build_cfg5_frame(N, dtype=torch.float64, device='cpu')


def test_focal_planes_and_mosaic_match_jax(jax_chain, frame64):
    planes, mosaic = jax_chain
    got_planes = frame64.focal_planes()
    assert got_planes.shape == (6, N, N) and got_planes.dtype == torch.float64
    assert _rel(got_planes.numpy(), planes) < 1e-9
    got = frame64.mosaic(got_planes)
    assert _rel(got.numpy(), mosaic) < 1e-9
    assert torch.equal(got, frame64.mosaic())


def test_mean_electrons_match_jax(jax_chain, frame64):
    _, mosaic = jax_chain
    want = JaxDetector(**DET)._mean_electrons(jnp.asarray(mosaic))
    got = frame64.detector._mean_electrons(frame64.mosaic())
    assert _rel(got.numpy(), want) < 1e-9


def test_demosaic_of_a_fixed_dn_frame_matches_jax():
    dn = np.random.default_rng(5).integers(0, 2 ** 14, (N, N)).astype(np.uint16)
    got = demosaic_malvar(torch.from_numpy(dn.astype(np.float64)))
    want = jax_demosaic_malvar(jnp.asarray(dn.astype(np.float64)))
    assert got.shape == (N, N, 3) and _rel(got.numpy(), want) < 1e-12


def test_frame_goes_through_the_fused_path_and_repeats():
    frame = steps.build_cfg5_frame(N, device='cpu')
    noise.reset_launches()
    a = frame(0)
    assert a.shape == (N, N, 3) and a.dtype == torch.float32 and bool(torch.isfinite(a).all())
    assert frame.detector.last_expose_path == 'fused'
    assert noise.LAUNCHES['noise_expose'] == 0      # the plain version ran: CPU tensors
    assert torch.equal(a, frame(0))
    assert not torch.equal(a, frame(1))
    # the frame is the demosaic of the quantised plain exposure of the mean map
    lam = frame.detector._mean_electrons(frame.mosaic())
    dn = noise.expose_plain(lam, 1, 0, DET['read_noise'], DET['bias'], DET['fwc'],
                            DET['conversion_gain'], DET['bits'])[0]
    assert torch.equal(a, demosaic_malvar(dn.to(torch.uint16).to(torch.float32)))


def test_the_auto_policy_would_not_take_the_kernel_on_this_scene(frame64):
    """Why the frame asks for method='fused': the occulted core is photon-starved."""
    lam = frame64.detector._mean_electrons(frame64.mosaic())
    assert float(lam.min()) < 20.0
    assert float((lam > DET['fwc']).double().mean()) > 0.01


def _residuals(lam, dn):
    """(DN gain - bias - lam) / sqrt(lam + read_noise^2) where neither clip can be reached."""
    lam, dn = lam.double(), dn.double()
    top = DET['bias'] + lam + 5 * torch.sqrt(lam)
    ok = (lam >= 100) & (top < DET['fwc']) & (top / DET['conversion_gain'] < 2 ** DET['bits'] - 1)
    resid = (dn * DET['conversion_gain'] - DET['bias'] - lam) / torch.sqrt(
        lam + DET['read_noise'] ** 2)
    return resid[..., ok]


def test_frame_noise_statistics():
    frame = steps.build_cfg5_frame(N, device='cpu')
    lam = frame.detector._mean_electrons(frame.mosaic())
    pooled = torch.cat([_residuals(lam, noise.expose_plain(
        lam, 1, seed, DET['read_noise'], DET['bias'], DET['fwc'], DET['conversion_gain'],
        DET['bits'])[0]) for seed in range(12)])
    n = pooled.numel()
    # standard errors: 1/sqrt(n) for the mean, sqrt(2/n) for the variance
    assert 0.02 >= 5 / np.sqrt(n) and 0.03 >= 5 * np.sqrt(2 / n)
    assert abs(float(pooled.mean())) < 0.02
    assert abs(float(pooled.var()) - 1) < 0.03
