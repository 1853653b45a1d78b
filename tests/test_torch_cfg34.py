"""The port's cfg3 step and cfg4 chain against the JAX package running bench.py's bodies.

Both run in float64 on the CPU at 128^2 (cfg3 keeps its 2 rings of 19
segments, and also runs at an odd 127^2, where the focus takes the dense
path) with bench.py's inputs: cfg3's segment coefficients from
``np.random.default_rng(7)`` at 20 nm, cfg4's aperture, lens and transfer
functions.  Bars: the aperture equal exactly; plan tensors to 1e-12
relative; the PSF, the encircled energy, its gradient with respect to the
(19, 3) coefficients (autograd against ``jax.grad``) and the cfg4
intensity to 1e-9 relative.  The JAX package's cfg3 run is read from its record
(``_jax_refs``) where it is current: the aperture and coefficients, compared
exactly, in a record of their own.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _jax_refs import jax_ref
from prysm_tpu.coordinates import make_xy_grid, cart_to_polar
from prysm_tpu.geometry import circle_sdf, antialias
from prysm_tpu.otf import encircled_energy
from prysm_tpu.polynomials import zernike_nm_seq
from prysm_tpu.propagation import Wavefront
from prysm_tpu.propagation.angular_spectrum import angular_spectrum_transfer_function
from prysm_tpu.segmented import CompositeHexagonalAperture

from prysm_tpu_torch import steps

torch.set_num_threads(2)

WVL, EFL = 0.55, 10.0   # bench.py


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _jax_cfg3(N):
    """bench.py cfg3's run() in the JAX package: (EE, PSF, dEE/dc, amp, coefs)."""
    x, y = make_xy_grid(N, diameter=2.4, host=True)
    dx = 2.4 / N
    cha = CompositeHexagonalAperture(x, y, 2, 0.4, 0.007)
    cha.prepare_opd_bases(zernike_nm_seq, [(0, 0), (1, -1), (1, 1)])
    coefs = np.random.default_rng(7).normal(scale=20.0, size=(len(cha.segment_ids), 3))
    coefs = jnp.asarray(coefs.astype(np.float32), dtype=jnp.float64)
    amp = jnp.asarray(cha.amp)

    def run(c):
        opd = cha.compose_opd(c)
        I = Wavefront.from_amp_and_phase(amp, opd, WVL, dx).focus(EFL, Q=2).intensity
        return encircled_energy(I.data, I.dx, 10.0), I.data

    ee, psf = run(coefs)
    grad = jax.grad(lambda c: run(c)[0])(coefs)
    return ee, psf, grad, np.asarray(cha.amp), coefs


@pytest.mark.parametrize('N', [128, 127])
def test_cfg3_step_matches_jax(N):
    step = steps.build_cfg3_step(N, dtype=torch.float64, device='cpu')
    jamp, jcoefs = jax_ref('cfg3-aperture', lambda N: _jax_cfg3(N)[3:], N)
    jee, jpsf, jgrad = jax_ref('cfg3', lambda N: _jax_cfg3(N)[:3], N, bar=1e-9)
    assert len(step.aperture.segment_ids) == 19
    np.testing.assert_array_equal(step.amp.numpy(), jamp)
    np.testing.assert_array_equal(step.coefs.numpy(), np.asarray(jcoefs))
    ee, psf, grad = step(step.coefs)
    assert psf.shape == (2 * N, 2 * N) and grad.shape == (19, 3)
    assert _rel(psf.numpy(), jpsf) < 1e-9
    assert _rel(ee.numpy(), jee) < 1e-9
    assert _rel(grad.numpy(), jgrad) < 1e-9
    fee, fpsf = step.forward(step.coefs)
    assert float(fee) == float(ee) and torch.equal(fpsf, psf)


def test_cfg3_step_reuses_its_encircled_energy_weights():
    from prysm_tpu_torch import otf
    otf._encircled_energy_rfft_weights.cache_clear()
    step = steps.build_cfg3_step(64, dtype=torch.float64, device='cpu')
    step(step.coefs)
    step(step.coefs * 0.5)
    info = otf._encircled_energy_rfft_weights.cache_info()
    assert (info.misses, info.hits) == (1, 2)


def _jax_cfg4(N):
    """bench.py cfg4's plan pieces and run() in the JAX package."""
    dx = 10.0 / N
    x, y = make_xy_grid(N, diameter=10.0)
    r, _ = cart_to_polar(x, y)
    amp0 = antialias(circle_sdf(4.0, r), dx)
    lens0 = Wavefront.thin_lens(150.0, WVL, x, y, dx=dx).data
    tf1 = angular_spectrum_transfer_function((N, N), WVL, dx, 50.0)
    tf2 = angular_spectrum_transfer_function((N, N), WVL, dx, 100.0)
    wf = Wavefront.from_amp_and_phase(amp0, None, WVL, dx)
    a = wf.free_space(tf=tf1)
    b = Wavefront(a.data * lens0, WVL, dx, a.space)
    return amp0, lens0, tf1, tf2, b.free_space(tf=tf2).intensity.data


@pytest.mark.parametrize('N', [128, 96])
def test_cfg4_chain_matches_jax(N):
    chain = steps.build_cfg4_chain(N, dtype=torch.float64, device='cpu')
    amp, lens, tf1, tf2, intensity = _jax_cfg4(N)
    assert np.abs(chain.amp.numpy() - np.asarray(amp)).max() < 1e-12
    for mine, theirs in ((chain.lens, lens), (chain.tf1, tf1), (chain.tf2, tf2)):
        assert _rel(mine.numpy(), theirs) < 1e-12
    out = chain()
    assert out.shape == (N, N) and out.dtype == torch.float64
    assert _rel(out.numpy(), intensity) < 1e-9
    # the chain is linear in the aperture's field: twice the amplitude, four times the intensity
    assert _rel(chain(2 * chain.amp).numpy(), 4 * out.numpy()) < 1e-12
