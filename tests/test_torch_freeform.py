"""The freeform-fit and image-chain paths against the same composition of JAX functions.

``steps.build_freeform_fit`` and ``steps.build_image_chain`` run at 64^2
and 128^2 on the CPU in float64; the JAX package composes the same
functions on the same inputs in x64.  Bar: 1e-10 of the reference's peak
for every output (sag, slopes, fit coefficients, reconstruction, residual
RMS, the four sag families; both images).  Without a card, both constructors
raise unless asked for the CPU.  The JAX package's side is read from its
record (``_jax_refs``) where it is current.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _jax_refs import jax_ref
from prysm_tpu.convolution import conv as jconv, apply_transfer_functions as japply
from prysm_tpu.coordinates import make_xy_grid, cart_to_polar
from prysm_tpu.degradations import smear_ft as jsmear, jitter_ft as jjitter
from prysm_tpu.geometry import antialias, circle_sdf
from prysm_tpu.objects import siemensstar as jstar
from prysm_tpu.polynomials import fitting as jfit
import prysm_tpu.polynomials as jpoly
from prysm_tpu.propagation import Wavefront

from prysm_tpu_torch import steps

torch.set_num_threads(2)


def _rel(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _jax_freeform(N):
    """The freeform path composed of the JAX package's functions."""
    x, y = make_xy_grid(N, diameter=2.0)
    u, t = cart_to_polar(x, y)
    mask = u <= 1
    c = steps.freeform_coefficients()
    cm0, ams, bms = jpoly.Q2d_nm_c_to_a_b(steps.FREEFORM_Q2D_NMS, c['q2d'])
    z, dr, dt = jpoly.compute_z_zprime_Q2d(cm0, ams, bms, u, t)
    raw = jpoly.zernike_nm_seq(steps.FREEFORM_FIT_NMS, u, t)
    modes = jpoly.normalize_modes(raw, mask)
    scale = jfit._masked_norm(raw.reshape(len(raw), -1), mask.ravel(), 'std')
    scale = jnp.where(scale < 1e-9, 1.0, scale)
    coefs = jpoly.lstsq(modes, jnp.where(mask, z, jnp.nan))
    recon = jpoly.zernike_sum(coefs / scale, steps.FREEFORM_FIT_NMS, x, y)
    resid = jnp.where(mask, z - recon, 0)
    terms = steps.FREEFORM_FAMILIES
    out = {'z': z, 'dr': dr, 'dt': dt, 'coefs': coefs, 'recon': recon,
           'residual_rms': jnp.sqrt(jnp.sum(resid ** 2) / jnp.sum(mask)),
           'cheby1_2d_sum_der_xy': jpoly.cheby1_2d_sum_der_xy(
               c['cheby1_2d_sum_der_xy'], terms['cheby1_2d_sum_der_xy'], x, y),
           'xy_sum_der_xy': jpoly.xy_sum_der_xy(c['xy_sum_der_xy'], terms['xy_sum_der_xy'], x, y),
           'jacobi_radial_sum_der_xy': jpoly.jacobi_radial_sum_der_xy(
               c['jacobi_radial_sum_der_xy'], terms['jacobi_radial_sum_der_xy'], 0, 0, x, y, 1.0),
           'zernike_sum_der_xy': jpoly.zernike_sum_der_xy(
               c['zernike_sum_der_xy'], terms['zernike_sum_der_xy'], x, y)}
    return out, np.asarray(mask)


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'mode-stack'])
@pytest.mark.parametrize('N', [64, 128])
def test_freeform_fit_matches_jax(N, fused):
    want, mask = jax_ref('freeform', _jax_freeform, N, bar=1e-10)
    fit = steps.build_freeform_fit(N, dtype=torch.float64, device='cpu', fused=fused)
    assert np.array_equal(fit.mask.numpy(), mask)
    got = fit()
    assert set(got) == set(want)
    for key, w in want.items():
        for g, ww in zip(*((got[key], w) if isinstance(w, tuple) else ((got[key],), (w,)))):
            assert _rel(g, ww) <= 1e-10, key
    # the fit leaves a residual: the Q2d surface reaches past the Zernikes to n = 7
    assert 0 < float(got['residual_rms']) < float(np.abs(np.asarray(want['z'])[mask]).max())


def _jax_target(N):
    x, y = make_xy_grid(N, diameter=2.0)
    return jstar(*cart_to_polar(x, y), steps.IMAGE_SPOKES)


def _jax_image_chain(N, target):
    """The image chain composed of the JAX package's functions, and the flagship PSF."""
    xp, yp = make_xy_grid(N, diameter=2.2)
    dx = float(xp[0, 1] - xp[0, 0])
    r, t = cart_to_polar(xp, yp)
    amp = antialias(circle_sdf(1.0, r), dx)
    opd = jpoly.sum_of_2d_modes(jpoly.zernike_nm_seq(steps.NMS6, r, t), jnp.asarray(steps.COEFS6))
    psf = Wavefront.from_amp_and_phase(amp, opd, steps.WVL, dx).focus(steps.EFL, Q=2).intensity.data
    psf = psf[N // 2:N // 2 + N, N // 2:N // 2 + N]
    psf = psf / psf.sum()
    otf = jnp.fft.fft2(jnp.fft.ifftshift(psf))
    tfs = [otf, lambda fx, fy: jsmear(fx, fy, *steps.IMAGE_SMEAR),
           lambda fr: jjitter(fr, steps.IMAGE_JITTER)]
    return psf, (jconv(target, psf), japply(target, 1.0, tfs))


@pytest.mark.parametrize('N', [64, 128])
def test_image_chain_matches_jax(N):
    target = jax_ref('target', _jax_target, N)
    psf, want = jax_ref('image-chain', _jax_image_chain, N, target, bar=1e-10)
    chain = steps.build_image_chain(N, dtype=torch.float64, device='cpu')
    assert np.array_equal(chain.target.numpy(), np.asarray(target))
    assert _rel(chain.psf, psf) <= 1e-10
    got = chain()
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert _rel(g, w) <= 1e-10
    # a target passed in is the one imaged
    carried = steps.build_image_chain(N, dtype=torch.float64, device='cpu',
                                      target=torch.from_numpy(np.array(target)))()
    for g, w in zip(carried, want):
        assert _rel(g, w) <= 1e-10


def test_paths_raise_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for build in (steps.build_freeform_fit, steps.build_image_chain):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(16)
        assert build(16, device='cpu') is not None
