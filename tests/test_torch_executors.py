"""The port's CZT, FFTDFT and multi-resolution executors against the JAX package's.

The same numpy inputs go through both packages in float64 on the CPU.
Plans are built two ways, natively by the port and from the JAX plan's
fields through ``interop``, on square and non-square, even and odd and
shifted grids.  Bars: 1e-12 relative on plan leaves and windows (both are
numpy float64 on the host), 1e-9 relative on transforms (float64
rounding of differently ordered FFT passes); ``next_fast_len`` and the
static geometry are equal.  Autograd through each plan is held to the
plan's ``adjoint`` and to ``jax.grad`` (jax.vjp) of the JAX plan.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prysm_tpu import fttools as jft
from prysm_tpu.propagation import dft as jdft
from prysm_tpu.propagation import coronagraph as jcor

from prysm_tpu_torch import fttools, interop
from prysm_tpu_torch.propagation import (dft, coronagraph as cor, prepare_executor,
                                         Wavefront)

torch.set_num_threads(2)

DX, FDX, WVL, EFL = 0.015625, 0.5, 0.5, 10.0   # alpha = 1/640 exactly: FFTDFT-compatible
# (pupil samples, focal samples, focal shift): square even, non-square odd, shifted
GEOMETRIES = {
    'even': ((32, 32), (24, 24), (0, 0)),
    'odd-rect': ((33, 40), (25, 30), (0, 0)),
    'shifted': ((32, 28), (21, 24), (0.3, -0.7)),
}
KINDS = ('mdft', 'czt', 'fftdft')


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _cfield(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _fields(jplan):
    """The JAX plan's dataclass fields, arrays as numpy."""
    return {f.name: (np.asarray(v) if hasattr(v, 'shape') else v)
            for f in dataclasses.fields(jplan) for v in (getattr(jplan, f.name),)}


def _plans(kind, geometry):
    pupil, focal, shift = GEOMETRIES[geometry]
    args = (DX, pupil, FDX, focal, WVL, EFL)
    jplan = jdft.prepare_executor(*args, focal_shift=shift, kind=kind, dtype=jnp.complex128)
    native = prepare_executor(*args, focal_shift=shift, kind=kind, dtype=torch.complex128,
                              device='cpu')
    return jplan, native, interop.plan_from_numpy(_fields(jplan), device='cpu')


def test_next_fast_len_matches_jax():
    assert [fttools.next_fast_len(n) for n in range(1, 400)] == \
           [jft.next_fast_len(n) for n in range(1, 400)]


@pytest.mark.parametrize('geometry', GEOMETRIES)
@pytest.mark.parametrize('kind', ('czt', 'fftdft'))
def test_native_plan_has_the_jax_leaves_and_geometry(kind, geometry):
    jplan, native, _ = _plans(kind, geometry)
    fields = _fields(jplan)
    for name, value in vars(native).items():
        if torch.is_tensor(value):
            assert _rel(value.real.numpy(), fields[name + '_re']) < 1e-12, name
            assert np.abs(value.imag.numpy() - fields[name + '_im']).max() < 1e-12, name
        else:
            assert value == fields[name], name


@pytest.mark.parametrize('geometry', GEOMETRIES)
@pytest.mark.parametrize('kind', ('czt', 'fftdft'))
def test_forward_and_adjoint_match_jax(kind, geometry):
    jplan, native, carried = _plans(kind, geometry)
    pupil, focal, _ = GEOMETRIES[geometry]
    a, g = _cfield(pupil, 1), _cfield(focal, 2)
    want, want_adj = np.asarray(jplan(jnp.asarray(a))), np.asarray(jplan.adjoint(jnp.asarray(g)))
    for plan in (native, carried):
        assert _rel(plan(torch.from_numpy(a)).numpy(), want) < 1e-9
        assert _rel(plan.adjoint(torch.from_numpy(g)).numpy(), want_adj) < 1e-9


@pytest.mark.parametrize('geometry', GEOMETRIES)
@pytest.mark.parametrize('kind', KINDS)
def test_autograd_gives_the_adjoint_and_jax_vjp(kind, geometry):
    jplan, plan, _ = _plans(kind, geometry)
    pupil, focal, _ = GEOMETRIES[geometry]
    a, g = _cfield(pupil, 3), _cfield(focal, 4)
    x = torch.from_numpy(a).requires_grad_(True)
    vjp, = torch.autograd.grad(plan(x), x, torch.from_numpy(g))
    assert _rel(vjp.numpy(), plan.adjoint(torch.from_numpy(g)).numpy()) < 1e-12
    # torch's complex cotangent is the conjugate of jax's
    _, jvjp = jax.vjp(jplan, jnp.asarray(a))
    assert _rel(vjp.numpy(), np.conj(np.asarray(jvjp(jnp.asarray(np.conj(g)))[0]))) < 1e-9


@pytest.mark.parametrize('kind', KINDS)
def test_adjoint_inner_product(kind):
    _, plan, _ = _plans(kind, 'odd-rect')
    x = torch.from_numpy(_cfield(GEOMETRIES['odd-rect'][0], 5))
    y = torch.from_numpy(_cfield(GEOMETRIES['odd-rect'][1], 6))
    lhs = torch.vdot(plan(x).ravel(), y.ravel())
    rhs = torch.vdot(x.ravel(), plan.adjoint(y).ravel())
    assert abs(complex(lhs - rhs)) / abs(complex(lhs)) < 1e-12


def test_czt_and_fftdft_equal_the_mdft():
    _, mdft, _ = _plans('mdft', 'shifted')
    a = torch.from_numpy(_cfield(GEOMETRIES['shifted'][0], 7))
    for kind in ('czt', 'fftdft'):
        assert _rel(_plans(kind, 'shifted')[1](a).numpy(), mdft(a).numpy()) < 1e-9


def test_negative_spacing_flips_the_fftdft_direction():
    x = (np.arange(16) - 8) * DX
    fx = -(np.arange(12) - 6) * (1 / (40 * DX))       # K = 40, descending
    jplan = jft.plan_fftdft(x, x, fx, fx, dtype=jnp.complex128)
    plan = fttools.plan_fftdft(x, x, fx, fx, dtype=torch.complex128, device='cpu')
    assert (plan.x_direction, plan.y_direction) == (jplan.x_direction, jplan.y_direction) == (1, 1)
    a, g = _cfield((16, 16), 8), _cfield((12, 12), 9)
    assert _rel(plan(torch.from_numpy(a)).numpy(), jplan(jnp.asarray(a))) < 1e-9
    assert _rel(plan.adjoint(torch.from_numpy(g)).numpy(), jplan.adjoint(jnp.asarray(g))) < 1e-9


def test_stacked_czt_matches_jax():
    args = [(DX, (24, 24), FDX, 16, w, EFL) for w in (0.5, 0.55, 0.6)]
    jstack = jft.stack_czt_plans([jdft.prepare_executor(*a, kind='czt', dtype=jnp.complex128)
                                  for a in args])
    stack = fttools.stack_czt_plans([prepare_executor(*a, kind='czt', dtype=torch.complex128,
                                                      device='cpu') for a in args])
    a, g = _cfield((3, 24, 24), 10), _cfield((3, 16, 16), 11)
    assert _rel(stack(torch.from_numpy(a)).numpy(), jstack(jnp.asarray(a))) < 1e-9
    assert _rel(stack.adjoint(torch.from_numpy(g)).numpy(), jstack.adjoint(jnp.asarray(g))) < 1e-9
    with pytest.raises(ValueError):
        fttools.stack_czt_plans([])


@pytest.mark.parametrize('zoom', [2, 0.5, (1.5, 0.75)], ids=['2', '0.5', 'rect'])
@pytest.mark.parametrize('shape', [(16, 16), (15, 18)], ids=['even', 'odd-rect'])
@pytest.mark.parametrize('complex_', [False, True], ids=['real', 'complex'])
def test_fourier_resample_matches_jax(zoom, shape, complex_):
    f = _cfield(shape, 12) if complex_ else np.random.default_rng(12).random(shape)
    out = fttools.fourier_resample(torch.from_numpy(f), zoom)
    want = np.asarray(jft.fourier_resample(jnp.asarray(f), zoom))
    assert out.is_complex() == complex_ and out.shape == want.shape
    assert _rel(out.numpy(), want) < 1e-9


@pytest.mark.parametrize('mode', ['constant', 'edge', 'reflect', 'symmetric', 'wrap'])
@pytest.mark.parametrize('shape,Q,out_shape', [((6, 6), 2, None), ((5, 7), 1, (12, 9)),
                                               ((2, 4, 5), 3, None)],
                         ids=['even-Q2', 'odd-out-shape', 'batched-Q3'])
def test_pad2d_modes_match_jax(mode, shape, Q, out_shape):
    a = np.random.default_rng(13).random(shape)
    kw = dict(Q=Q, mode=mode, out_shape=out_shape)
    if mode == 'constant':
        kw['value'] = 0.25
    out = fttools.pad2d(torch.from_numpy(a), **kw).numpy()
    np.testing.assert_array_equal(out, np.asarray(jft.pad2d(jnp.asarray(a), **kw)))


def test_pad2d_refuses_a_value_mode():
    with pytest.raises(ValueError, match='mode'):
        fttools.pad2d(torch.zeros(4, 4), mode='mean')


def test_prepare_executor_drops_matmul_precision_for_fft_kinds():
    for kind in ('czt', 'fftdft'):
        plan = prepare_executor(DX, 16, FDX, 12, WVL, EFL, kind=kind, matmul_precision='high',
                                dtype=torch.complex128, device='cpu')
        assert not hasattr(plan, 'matmul_precision')
    with pytest.raises(ValueError, match='kind'):
        prepare_executor(DX, 16, FDX, 12, WVL, EFL, kind='fft', device='cpu')


# ---------------------------------------------------------------------------
# multi-resolution stacks
# ---------------------------------------------------------------------------

MR = dict(pupil_dx=2.0 / 32, pupil_samples=(32, 32), focal_dx=0.55 * 10.0 / 2.0 / 2,
          focal_samples=64, wavelength=0.55, efl=10.0, num_levels=3, fine_samples=(24, 28))


def _mr(kind):
    jex = jdft.prepare_multiresolution(**MR, kind=kind, dtype=jnp.complex128)
    native = dft.prepare_multiresolution(**MR, kind=kind, dtype=torch.complex128,
                                         device='cpu')
    carried = interop.multiresolution_from_numpy(
        [_fields(e) for e in jex.executors], jex.windows, jex.xf, jex.yf, device='cpu')
    return jex, native, carried


@pytest.mark.parametrize('kind', KINDS)
def test_multiresolution_geometry_matches_jax(kind):
    jex, native, carried = _mr(kind)
    assert len(native) == len(jex) == 3
    for ex in (native, carried):
        for name in ('windows', 'xf', 'yf'):
            for mine, theirs in zip(getattr(ex, name), getattr(jex, name)):
                assert mine.dtype == torch.float64
                assert np.abs(mine.numpy() - theirs).max() < 1e-12
    total = sum(np.asarray(w).sum() for w in jex.windows)
    assert total > 0


@pytest.mark.parametrize('kind', KINDS)
def test_multiresolution_round_trip_and_adjoint_match_jax(kind):
    jex, native, carried = _mr(kind)
    a = _cfield((32, 32), 14)
    g = _cfield((32, 32), 15)
    jfpm = jcor.vortex_phase_mask(2)
    fpm = cor.vortex_phase_mask(2)
    want = np.asarray(jcor.to_fpm_and_back_multiresolution(jnp.asarray(a), jfpm, jex))
    want_adj = np.asarray(jcor.to_fpm_and_back_multiresolution_adjoint(jnp.asarray(g), jfpm,
                                                                       jex))
    for ex in (native, carried):
        out = cor.to_fpm_and_back_multiresolution(torch.from_numpy(a), fpm, ex)
        assert _rel(out.numpy(), want) < 1e-9
        adj = cor.to_fpm_and_back_multiresolution_adjoint(torch.from_numpy(g), fpm, ex)
        assert _rel(adj.numpy(), want_adj) < 1e-9
    x = torch.from_numpy(a).requires_grad_(True)
    vjp, = torch.autograd.grad(cor.to_fpm_and_back_multiresolution(x, fpm, native), x,
                               torch.from_numpy(g))
    assert _rel(vjp.numpy(), cor.to_fpm_and_back_multiresolution_adjoint(
        torch.from_numpy(g), fpm, native).numpy()) < 1e-12


def test_multiresolution_fpm_gradients_match_jax():
    jex, ex, _ = _mr('mdft')
    a, g = _cfield((32, 32), 16), _cfield((32, 32), 17)

    def occulter(xf, yf):
        xp = np if isinstance(xf, np.ndarray) else (jnp if not torch.is_tensor(xf) else torch)
        return 1.0 * (xp.hypot(xf, yf) > 1.5)

    _, at, _ = cor.to_fpm_and_back_multiresolution(torch.from_numpy(a), occulter, ex,
                                                   return_more=True)
    _, jat, _ = jcor.to_fpm_and_back_multiresolution(jnp.asarray(a), occulter, jex,
                                                     return_more=True)
    out = cor.to_fpm_and_back_multiresolution_adjoint(
        torch.from_numpy(g), occulter, ex, return_more=True, return_fpm_grad=True,
        field_at_fpm=at)
    want = jcor.to_fpm_and_back_multiresolution_adjoint(
        jnp.asarray(g), occulter, jex, return_more=True, return_fpm_grad=True,
        field_at_fpm=jat)
    assert len(out) == len(want) == 4
    for mine, theirs in zip(out[1:], want[1:]):
        # the finest level lies inside the occulter: its terms are 0 in both
        scale = max(np.abs(np.asarray(t)).max() for t in theirs)
        for m, t in zip(mine, theirs):
            assert np.abs(m.numpy() - np.asarray(t)).max() <= 1e-9 * scale


def test_wavefront_prepare_methods_use_its_dtype_and_device():
    wf = Wavefront(torch.from_numpy(_cfield((32, 32), 18)), WVL, DX)
    plan = wf.prepare_executor(EFL, FDX, 24, kind='czt')
    assert isinstance(plan, fttools.CZT) and plan.bcol.dtype == torch.complex128
    assert _rel(wf.focus_dft(plan).data.numpy(),
                _plans('czt', 'even')[1](wf.data).numpy()) < 1e-12
    mr = wf.prepare_multiresolution(EFL, FDX, 24, num_levels=2)
    assert len(mr) == 2 and mr.windows[0].dtype == torch.float64


def _measured_map():
    rng = np.random.default_rng(19)
    return np.exp(1j * rng.uniform(-1, 1, (15, 17))) * rng.uniform(0.5, 1.0, (15, 17))


@pytest.mark.parametrize('fill', [dict(), dict(charge=2), dict(fill=0.25)],
                         ids=['unit', 'vortex', 'scalar'])
def test_measured_fpm_matches_jax_on_host_grids_and_tensors(fill):
    meas = _measured_map()
    fpm = cor.prepare_measured_fpm(meas, 0.3, center=(0.1, -0.2), **fill)
    jfpm = jcor.prepare_measured_fpm(meas, 0.3, center=(0.1, -0.2), **fill)
    xf, yf = np.meshgrid(np.linspace(-4, 4, 23), np.linspace(-3.5, 3, 19))
    want = np.asarray(jfpm(xf, yf))
    host = fpm(xf, yf)
    assert isinstance(host, np.ndarray) and _rel(host, want) < 1e-12
    dev = fpm(torch.from_numpy(xf), torch.from_numpy(yf))
    assert dev.dtype == torch.complex128 and _rel(dev.numpy(), want) < 1e-12


def test_wavefront_coronagraph_verbs_match_jax():
    from prysm_tpu.propagation import Wavefront as JWavefront
    jex, ex, _ = _mr('czt')
    a = _cfield((32, 32), 20)
    wf, jwf = Wavefront(torch.from_numpy(a), 0.55, MR['pupil_dx']), \
        JWavefront(jnp.asarray(a), 0.55, MR['pupil_dx'])
    fpm, jfpm = cor.vortex_phase_mask(2), jcor.vortex_phase_mask(2)
    out, at, after = wf.to_fpm_and_back_multiresolution(fpm, ex, return_more=True)
    jout, jat, jafter = jwf.to_fpm_and_back_multiresolution(jfpm, jex, return_more=True)
    assert _rel(out.data.numpy(), jout.data) < 1e-9
    assert [w.dx for w in at] == [w.dx for w in jat] and at[0].space == 'psf'
    back = out.to_fpm_and_back_multiresolution_adjoint(fpm, ex, return_fpm_grad=True,
                                                       field_at_fpm=at)
    jback = jout.to_fpm_and_back_multiresolution_adjoint(jfpm, jex, return_fpm_grad=True,
                                                         field_at_fpm=jat)
    assert _rel(back[0].data.numpy(), jback[0].data) < 1e-9
    plan, jplan = ex.executors[1], jex.executors[1]
    occ = (np.hypot(*np.meshgrid(np.arange(28) - 14, np.arange(24) - 12)) > 4).astype(float)
    lyot = np.asarray(_cfield((32, 32), 21).real > -0.5, dtype=float)
    for name, args, jargs in (
            ('to_fpm_and_back', (torch.from_numpy(occ), plan), (jnp.asarray(occ), jplan)),
            ('babinet', (torch.from_numpy(lyot), torch.from_numpy(occ), plan),
             (jnp.asarray(lyot), jnp.asarray(occ), jplan))):
        mine, theirs = getattr(wf, name)(*args), getattr(jwf, name)(*jargs)
        assert _rel(mine.data.numpy(), theirs.data) < 1e-9
        mine_adj = getattr(mine, name + '_adjoint')(*args)
        theirs_adj = getattr(theirs, name + '_adjoint')(*jargs)
        assert _rel(mine_adj.data.numpy(), theirs_adj.data) < 1e-9
    psf = wf.focus_dft(plan)
    assert _rel(psf.unfocus_dft(plan).data.numpy(), jwf.focus_dft(jplan).unfocus_dft(jplan).data) \
        < 1e-9
    # from a focal plane, (dx, samples) describe the pupil
    pplan = psf.prepare_executor(10.0, MR['pupil_dx'], 32)
    assert pplan.Ex.shape == (psf.data.shape[-1], 32)
