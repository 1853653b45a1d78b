"""The port's coronagraph and wavelength-stacked MDFT against the JAX package's.

``parallel.SpectralMDFT`` is built two ways, from the JAX plan's leaves
through ``interop`` and natively by ``plan_mdft_spectral``, and both are
held to the JAX plan at 1e-12 relative.  ``to_fpm_and_back``, ``babinet``
and their adjoints, on a wavelength stack and on a single MDFT plan,
agree with JAX to 1e-10 of peak in float64, and each adjoint satisfies
<Ax, y> = <x, A*y> to 1e-10.  The batched Q=1 ``focus`` of a (6, N, N)
stack, which the cfg5 frame runs, is covered for even and odd N.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prysm_tpu.parallel import plan_mdft_spectral as jax_plan_mdft_spectral
from prysm_tpu.parallel import spectral_babinet as jax_spectral_babinet
from prysm_tpu.propagation import coronagraph as jcor
from prysm_tpu.propagation import fft as jfft
from prysm_tpu.propagation import prepare_executor as jax_prepare_executor

from prysm_tpu_torch import interop
from prysm_tpu_torch.parallel import (plan_mdft_spectral, spectral_babinet, spectral_focus,
                                      spectral_unfocus)
from prysm_tpu_torch.propagation import coronagraph as cor
from prysm_tpu_torch.propagation import fft

torch.set_num_threads(2)

WVLS = np.linspace(0.50, 0.60, 6)
EFL = 10.0
N, WN, FOCAL_DX = 48, 16, 0.25


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _jax_splan():
    return jax_plan_mdft_spectral(2.2 / N, (N, N), FOCAL_DX, WN, WVLS, EFL,
                                  dtype=jnp.complex128)


def _carried(jplan):
    return interop.spectral_mdft_from_numpy(
        np.asarray(jplan.Ex_re), np.asarray(jplan.Ex_im), np.asarray(jplan.Ey_re),
        np.asarray(jplan.Ey_im), np.asarray(jplan.norm), jplan.pupil_dx, jplan.focal_dx,
        device='cpu')


def _native():
    return plan_mdft_spectral(2.2 / N, (N, N), FOCAL_DX, WN, WVLS, EFL,
                              dtype=torch.complex128, device='cpu')


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _fpm():
    f = (np.arange(WN) - WN // 2) * FOCAL_DX
    fx, fy = np.meshgrid(f, f)
    return (np.hypot(fx, fy) > 1.2).astype(np.float64)


def _lyot():
    x = (np.arange(N) - N // 2) * (2.2 / N)
    return (np.hypot(*np.meshgrid(x, x)) < 0.9).astype(np.float64)


PLANS = {'interop': lambda: _carried(_jax_splan()), 'native': _native}


def test_native_plan_has_the_jax_leaves():
    jplan, plan = _jax_splan(), _native()
    assert _rel(plan.Ex.real.numpy(), jplan.Ex_re) < 1e-12
    assert _rel(plan.Ex.imag.numpy(), jplan.Ex_im) < 1e-12
    assert _rel(plan.Ey.real.numpy(), jplan.Ey_re) < 1e-12
    assert _rel(plan.Ey.imag.numpy(), jplan.Ey_im) < 1e-12
    assert _rel(plan.norm.numpy(), jplan.norm) < 1e-15
    assert plan.norm.shape == (len(WVLS), 1, 1)
    assert plan.nbytes() == jplan.nbytes()
    assert (plan.pupil_dx, plan.focal_dx) == (jplan.pupil_dx, jplan.focal_dx)


@pytest.mark.parametrize('build', PLANS.values(), ids=PLANS.keys())
def test_spectral_mdft_matches_jax(build):
    jplan, plan = _jax_splan(), build()
    E = _field((len(WVLS), N, N), 0)
    G = _field((len(WVLS), WN, WN), 1)
    assert _rel(spectral_focus(torch.from_numpy(E), plan).numpy(), jplan(jnp.asarray(E))) < 1e-12
    assert _rel(spectral_unfocus(torch.from_numpy(G), plan).numpy(),
                jplan.adjoint(jnp.asarray(G))) < 1e-12


def test_spectral_mdft_plan_defaults_and_rectangular_grids():
    plan = plan_mdft_spectral(0.05, (20, 30), 0.3, (8, 12), [0.5, 0.6], EFL, device='cpu',
                              focal_shift=(0.1, -0.2))
    jplan = jax_plan_mdft_spectral(0.05, (20, 30), 0.3, (8, 12), [0.5, 0.6], EFL,
                                   focal_shift=(0.1, -0.2), dtype=jnp.complex64)
    assert plan.Ex.dtype == torch.complex64 and plan.norm.dtype == torch.float32
    assert plan.Ex.shape == (2, 12, 30) and plan.Ey.shape == (2, 8, 20)
    assert _rel(plan.Ex.real.numpy(), jplan.Ex_re) < 1e-6
    E = _field((2, 20, 30), 2).astype(np.complex64)
    assert _rel(plan(torch.from_numpy(E)).numpy(), jplan(jnp.asarray(E))) < 1e-5


@pytest.mark.parametrize('build', PLANS.values(), ids=PLANS.keys())
def test_to_fpm_and_back_and_adjoint_match_jax(build):
    jplan, plan = _jax_splan(), build()
    E, fpm = _field((len(WVLS), N, N), 3), _fpm()
    got = cor.to_fpm_and_back(torch.from_numpy(E), torch.from_numpy(fpm), plan,
                              return_more=True)
    want = jcor.to_fpm_and_back(jnp.asarray(E), jnp.asarray(fpm), jplan, return_more=True)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < 1e-10
    Y = _field((len(WVLS), N, N), 4)
    got = cor.to_fpm_and_back_adjoint(torch.from_numpy(Y), torch.from_numpy(fpm), plan,
                                      return_more=True, return_fpm_grad=True,
                                      field_at_fpm=got[1])
    want = jcor.to_fpm_and_back_adjoint(jnp.asarray(Y), jnp.asarray(fpm), jplan,
                                        return_more=True, return_fpm_grad=True,
                                        field_at_fpm=want[1])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < 1e-10


def test_to_fpm_and_back_on_a_single_mdft_plan_matches_jax():
    jplan = jax_prepare_executor(2.2 / N, (N, N), FOCAL_DX, WN, 0.55, EFL)
    plan = interop.mdft_from_numpy(
        np.asarray(jplan.Ex_re), np.asarray(jplan.Ex_im), np.asarray(jplan.Ey_re),
        np.asarray(jplan.Ey_im), jplan.norm, jplan.forward_left_first,
        jplan.adjoint_left_first, device='cpu')
    E, fpm = _field((N, N), 5), np.exp(1j * _field((WN, WN), 6).real)
    got = cor.to_fpm_and_back(torch.from_numpy(E), torch.from_numpy(fpm), plan)
    assert _rel(got.numpy(), jcor.to_fpm_and_back(jnp.asarray(E), jnp.asarray(fpm), jplan)) < 1e-10
    # a complex mask: its gradient stays complex
    Y = _field((N, N), 7)
    at_fpm = plan(torch.from_numpy(E))
    got = cor.to_fpm_and_back_adjoint(torch.from_numpy(Y), torch.from_numpy(fpm), plan,
                                      return_fpm_grad=True, field_at_fpm=at_fpm)
    want = jcor.to_fpm_and_back_adjoint(jnp.asarray(Y), jnp.asarray(fpm), jplan,
                                        return_fpm_grad=True,
                                        field_at_fpm=jplan(jnp.asarray(E)))
    for g, w in zip(got, want):
        assert g.is_complex() and _rel(g.numpy(), w) < 1e-10


@pytest.mark.parametrize('build', PLANS.values(), ids=PLANS.keys())
@pytest.mark.parametrize('with_lyot', [True, False], ids=['lyot', 'no-lyot'])
def test_babinet_and_adjoint_match_jax(build, with_lyot):
    jplan, plan = _jax_splan(), build()
    E, fpm = _field((len(WVLS), N, N), 8), _fpm()
    lyot = _lyot() if with_lyot else None
    tl = None if lyot is None else torch.from_numpy(lyot)
    jl = None if lyot is None else jnp.asarray(lyot)
    got = cor.babinet(torch.from_numpy(E), tl, torch.from_numpy(fpm), plan, return_more=True)
    want = jcor.babinet(jnp.asarray(E), jl, jnp.asarray(fpm), jplan, return_more=True)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < 1e-10
    plain = cor.babinet(torch.from_numpy(E), tl, torch.from_numpy(fpm), plan)
    assert _rel(plain.numpy(), want[0]) < 1e-10
    assert _rel(spectral_babinet(torch.from_numpy(E), tl, torch.from_numpy(fpm), plan).numpy(),
                jax_spectral_babinet(jnp.asarray(E), jl, jnp.asarray(fpm), jplan)) < 1e-10

    Y = _field((len(WVLS), N, N), 9)
    kw = dict(return_fpm_grad=True, return_lyot_grad=with_lyot)
    got_adj = cor.babinet_adjoint(torch.from_numpy(Y), tl, torch.from_numpy(fpm), plan,
                                  field_at_fpm=got[1], field_at_lyot=got[3], **kw)
    want_adj = jcor.babinet_adjoint(jnp.asarray(Y), jl, jnp.asarray(fpm), jplan,
                                    field_at_fpm=want[1], field_at_lyot=want[3], **kw)
    assert len(got_adj) == len(want_adj)
    for g, w in zip(got_adj, want_adj):
        assert _rel(g.numpy(), w) < 1e-10
    abar = cor.babinet_adjoint(torch.from_numpy(Y), tl, torch.from_numpy(fpm), plan)
    assert _rel(abar.numpy(), want_adj[0]) < 1e-10


def test_adjoints_refuse_missing_forward_fields():
    plan, fpm = _native(), torch.from_numpy(_fpm())
    Y = torch.from_numpy(_field((len(WVLS), N, N), 10))
    with pytest.raises(ValueError):
        cor.to_fpm_and_back_adjoint(Y, fpm, plan, return_fpm_grad=True)
    with pytest.raises(ValueError):
        cor.babinet_adjoint(Y, None, fpm, plan, return_lyot_grad=True)


def _vdot(a, b):
    return complex(torch.sum(a.conj() * b))


@pytest.mark.parametrize('op', ['to_fpm_and_back', 'babinet'])
def test_adjoint_dot_product_identity(op):
    """<A x, y> = <x, A* y> for the linear map x -> op(x)."""
    plan, fpm, lyot = _native(), torch.from_numpy(_fpm()), torch.from_numpy(_lyot())
    x = torch.from_numpy(_field((len(WVLS), N, N), 11))
    y = torch.from_numpy(_field((len(WVLS), N, N), 12))
    if op == 'to_fpm_and_back':
        Ax, Aty = cor.to_fpm_and_back(x, fpm, plan), cor.to_fpm_and_back_adjoint(y, fpm, plan)
    else:
        Ax, Aty = cor.babinet(x, lyot, fpm, plan), cor.babinet_adjoint(y, lyot, fpm, plan)
    lhs, rhs = _vdot(Ax, y), _vdot(x, Aty)
    assert abs(lhs - rhs) / abs(lhs) < 1e-10


@pytest.mark.parametrize('n', [48, 49], ids=['even', 'odd'])
def test_batched_q1_focus_matches_jax(n):
    E = _field((6, n, n), 13)
    got = fft.focus(torch.from_numpy(E), Q=1)
    want = jfft.focus(jnp.asarray(E), Q=1)
    assert got.shape == (6, n, n) and _rel(got.numpy(), want) < 1e-12
    for k in (0, 5):   # each slice of the stack is the 2-D focus of that slice
        assert _rel(got[k].numpy(), jfft.focus(jnp.asarray(E[k]), Q=1)) < 1e-12
    back = fft.unfocus(got, Q=1)
    assert _rel(back.numpy(), E) < 1e-12


def test_vortex_phase_mask_matches_jax():
    f = np.linspace(-2, 2, 17)
    xf, yf = np.meshgrid(f, f)
    want = np.asarray(jcor.vortex_phase_mask(2)(jnp.asarray(xf), jnp.asarray(yf)))
    mask = cor.vortex_phase_mask(2)
    assert _rel(mask(torch.from_numpy(xf), torch.from_numpy(yf)).numpy(), want) < 1e-14
    host = mask(xf, yf)
    assert isinstance(host, np.ndarray) and _rel(host, want) < 1e-14
    with pytest.raises(TypeError):
        cor.vortex_phase_mask(1.5)
