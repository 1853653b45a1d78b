"""The port's angular spectrum, thin lens and Wavefront verbs against the JAX package's.

Same numpy fields through both packages on the CPU in float64, on even
and odd, square and non-square grids.  Bars: 1e-12 relative on the
transfer function and the lens screen (the same quadratic phase through
cos and sin), 1e-9 relative on propagated fields, adjoints and gradients
(float64 rounding of differently ordered FFT passes); the adjoint
identity <Ax, y> = <x, A^H y> and autograd against the explicit adjoints
to 1e-12.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prysm_tpu.coordinates import make_xy_grid as jax_make_xy_grid
from prysm_tpu.propagation import Wavefront as JWavefront

from prysm_tpu_torch.coordinates import make_xy_grid
from prysm_tpu_torch.propagation import Wavefront

# the packages export a function of the module's name
jas = importlib.import_module('prysm_tpu.propagation.angular_spectrum')
tas = importlib.import_module('prysm_tpu_torch.propagation.angular_spectrum')

torch.set_num_threads(2)

WVL, DX = 0.55, 10.0 / 64
SHAPES = {'even': (32, 32), 'odd-rect': (31, 36)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize('shape', SHAPES.values(), ids=SHAPES.keys())
def test_transfer_function_matches_jax(shape):
    tf = tas.angular_spectrum_transfer_function(shape, WVL, DX, 50.0, dtype=torch.float64,
                                                device='cpu')
    assert _rel(tf.numpy(), jas.angular_spectrum_transfer_function(shape, WVL, DX, 50.0)) < 1e-12


@pytest.mark.parametrize('Q', [1, 2])
@pytest.mark.parametrize('shape', SHAPES.values(), ids=SHAPES.keys())
def test_propagation_and_adjoint_match_jax(shape, Q):
    a = _field(shape, 1)
    out = tas.angular_spectrum(torch.from_numpy(a), WVL, DX, 40.0, Q=Q)
    want = np.asarray(jas.angular_spectrum(jnp.asarray(a), WVL, DX, 40.0, Q=Q))
    assert out.shape == want.shape and _rel(out.numpy(), want) < 1e-9
    g = _field(want.shape, 2)
    adj = tas.angular_spectrum_adjoint(torch.from_numpy(g), WVL, DX, 40.0, Q=Q)
    jadj = np.asarray(jas.angular_spectrum_adjoint(jnp.asarray(g), WVL, DX, 40.0, Q=Q))
    assert adj.shape == jadj.shape == shape and _rel(adj.numpy(), jadj) < 1e-9
    lhs = torch.vdot(out.ravel(), torch.from_numpy(g).ravel())
    rhs = torch.vdot(torch.from_numpy(a).ravel(), adj.ravel())
    assert abs(complex(lhs - rhs)) / abs(complex(lhs)) < 1e-12
    x = torch.from_numpy(a).requires_grad_(True)
    vjp, = torch.autograd.grad(tas.angular_spectrum(x, WVL, DX, 40.0, Q=Q), x,
                               torch.from_numpy(g))
    assert _rel(vjp.numpy(), adj.numpy()) < 1e-12


def test_given_transfer_function_clobbers_the_rest():
    a = _field((32, 32), 3)
    tf = tas.angular_spectrum_transfer_function(32, WVL, DX, 25.0, dtype=torch.float64,
                                                device='cpu')
    jtf = jas.angular_spectrum_transfer_function(32, WVL, DX, 25.0)
    out = tas.angular_spectrum(torch.from_numpy(a), None, None, None, tf=tf)
    assert _rel(out.numpy(), jas.angular_spectrum(jnp.asarray(a), None, None, None, tf=jtf)) < 1e-9
    adj = tas.angular_spectrum_adjoint(out, None, None, None, tf=tf)
    assert _rel(adj.numpy(), a) < 1e-12


def test_plus_and_minus_z_round_trip():
    a = _field((32, 32), 4)
    there = tas.angular_spectrum(torch.from_numpy(a), WVL, DX, 60.0, Q=1)
    back = tas.angular_spectrum(there, WVL, DX, -60.0, Q=1)
    assert _rel(back.numpy(), a) < 1e-12


@pytest.mark.parametrize('shape', SHAPES.values(), ids=SHAPES.keys())
def test_thin_lens_and_its_adjoint_match_jax(shape):
    x, y = make_xy_grid(shape, dx=DX, dtype=torch.float64, device='cpu')
    jx, jy = jax_make_xy_grid(shape, dx=DX)
    lens = Wavefront.thin_lens(150.0, WVL, x, y)
    jlens = JWavefront.thin_lens(150.0, WVL, jx, jy)
    assert lens.dx == pytest.approx(jlens.dx, rel=1e-15) and lens.space == 'pupil'
    assert _rel(lens.data.numpy(), jlens.data) < 1e-12
    bar = _field(shape, 5)
    adj = Wavefront.thin_lens_adjoint(150.0, WVL, x, y, torch.from_numpy(bar))
    jadj = JWavefront.thin_lens_adjoint(150.0, WVL, jx, jy, jnp.asarray(bar))
    assert _rel(float(adj), float(jadj)) < 1e-9
    f = torch.tensor(150.0, dtype=torch.float64, requires_grad=True)
    # d/df of Re<bar, L(f)>, the real pairing the adjoint folds
    loss = torch.sum(torch.real(torch.conj(torch.from_numpy(bar))
                                * Wavefront.thin_lens(f, WVL, x, y, dx=DX).data))
    grad, = torch.autograd.grad(loss, f)
    assert _rel(float(grad), float(adj)) < 1e-9


def _wavefronts(shape, seed):
    a = _field(shape, seed)
    return Wavefront(torch.from_numpy(a), WVL, DX), JWavefront(jnp.asarray(a), WVL, DX)


@pytest.mark.parametrize('Q', [1, 2])
def test_wavefront_free_space_and_adjoint_match_jax(Q):
    wf, jwf = _wavefronts((31, 36), 6)
    out, jout = wf.free_space(35.0, Q=Q), jwf.free_space(35.0, Q=Q)
    assert _rel(out.data.numpy(), jout.data) < 1e-9 and out.dx == jout.dx
    back, jback = out.free_space_adjoint(35.0, Q=Q), jout.free_space_adjoint(35.0, Q=Q)
    assert _rel(back.data.numpy(), jback.data) < 1e-9
    with pytest.raises(ValueError, match='dz'):
        wf.free_space()


def test_wavefront_views_arithmetic_and_shaping_match_jax():
    wf, jwf = _wavefronts((16, 16), 7)
    other, jother = _wavefronts((16, 16), 8)
    for name in ('real', 'imag', 'phase', 'intensity'):
        assert _rel(getattr(wf, name).data.numpy(), getattr(jwf, name).data) < 1e-14
    for op in ('__mul__', '__truediv__', '__add__', '__sub__'):
        for rhs, jrhs in ((other, jother), (2.5, 2.5)):
            mine, theirs = getattr(wf, op)(rhs), getattr(jwf, op)(jrhs)
            assert _rel(mine.data.numpy(), theirs.data) < 1e-14
    for op in ('__rmul__', '__rtruediv__', '__radd__', '__rsub__'):
        assert _rel(getattr(wf, op)(1.5).data.numpy(), getattr(jwf, op)(1.5).data) < 1e-14
    with pytest.raises(ValueError, match='physicality'):
        wf + Wavefront(wf.data, 0.6, DX)
    with pytest.raises(TypeError):
        wf * 'two'
    copy = wf.copy()
    assert copy.data is not wf.data and torch.equal(copy.data, wf.data)
    padded = wf.pad2d(2, mode='edge', inplace=False)
    assert _rel(padded.data.numpy(), jwf.pad2d(2, mode='edge', inplace=False).data) < 1e-15
    cropped = padded.crop(10, inplace=False)
    assert _rel(cropped.data.numpy(), jwf.pad2d(2, mode='edge', inplace=False).crop(
        10, inplace=False).data) < 1e-15
    assert padded.crop(16) is padded and padded.data.shape == (16, 16)


def test_wavefront_amplitude_and_phase_adjoints_match_jax_and_autograd():
    rng = np.random.default_rng(9)
    amp, opd = rng.random((12, 14)), 50 * rng.standard_normal((12, 14))
    bar = _field((12, 14), 10)
    wf = Wavefront.from_amp_and_phase(torch.from_numpy(amp), torch.from_numpy(opd), WVL, DX)
    jwf = JWavefront.from_amp_and_phase(jnp.asarray(amp), jnp.asarray(opd), WVL, DX)
    wbar, jwbar = Wavefront(torch.from_numpy(bar), WVL, DX), JWavefront(jnp.asarray(bar), WVL, DX)
    for kw, jkw in (({}, {}), ({'phase': torch.from_numpy(opd)}, {'phase': jnp.asarray(opd)})):
        assert _rel(wf.from_amp_and_phase_adjoint_amp(wbar, **kw).numpy(),
                    jwf.from_amp_and_phase_adjoint_amp(jwbar, **jkw)) < 1e-12
    a = torch.from_numpy(amp).requires_grad_(True)
    loss = torch.sum(torch.real(torch.conj(torch.from_numpy(bar)) * Wavefront.from_amp_and_phase(
        a, torch.from_numpy(opd), WVL, DX).data))
    grad, = torch.autograd.grad(loss, a)
    assert _rel(grad.numpy(), wf.from_amp_and_phase_adjoint_amp(wbar).numpy()) < 1e-12
    screen = Wavefront.phase_screen(torch.from_numpy(opd), WVL, DX)
    jscreen = JWavefront.phase_screen(jnp.asarray(opd), WVL, DX)
    assert _rel(screen.phase_screen_adjoint_phase(wbar).numpy(),
                jscreen.phase_screen_adjoint_phase(jwbar)) < 1e-12


def test_wavefront_unfocus_verbs_match_jax():
    wf, jwf = _wavefronts((16, 16), 11)
    psf, jpsf = wf.focus(10.0, Q=2), jwf.focus(10.0, Q=2)
    back, jback = psf.unfocus(10.0, Q=1), jpsf.unfocus(10.0, Q=1)
    assert _rel(back.data.numpy(), jback.data) < 1e-12 and back.dx == pytest.approx(jback.dx)
    adj, jadj = wf.unfocus_adjoint(10.0, Q=2), jwf.unfocus_adjoint(10.0, Q=2)
    assert _rel(adj.data.numpy(), jadj.data) < 1e-12 and adj.space == jadj.space == 'psf'
    with pytest.raises(ValueError):
        wf.unfocus(10.0)


def test_fresnel_number_and_talbot_distance_match_jax():
    assert tas.fresnel_number(2.0, 100.0, 0.5) == jas.fresnel_number(2.0, 100.0, 0.5)
    assert tas.talbot_distance(3.0, 0.55) == pytest.approx(
        float(jas.talbot_distance(3.0, 0.55)), rel=1e-15)
