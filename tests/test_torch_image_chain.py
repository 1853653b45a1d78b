"""The port's image-simulation modules against the JAX package.

``objects`` (slit, pinhole and their transforms, siemensstar, tiltedsquare,
slantededge), ``degradations`` (and ``degredations``, its old spelling) and
``convolution`` (``conv``, ``apply_transfer_functions`` with array and
callable transfer functions).  The same numpy inputs, on even and odd
grids, go through the JAX function in x64 and the port on the CPU in
float64, with ``config.precision = 64``.  Bars: masks and thresholded
targets equal exactly; closed forms to 1e-12 of the reference's max
|value|; the FFT chains to 1e-12.
"""
import inspect
from importlib import import_module

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import prysm_tpu.polynomials as jpoly
import prysm_tpu_torch.polynomials as tpoly
from prysm_tpu_torch.conf import config

torch.set_num_threads(2)

MODULES = ('objects', 'degradations', 'degredations', 'convolution')
J = {m: import_module(f'prysm_tpu.{m}') for m in MODULES}
T = {m: import_module(f'prysm_tpu_torch.{m}') for m in MODULES}


@pytest.fixture(autouse=True)
def f64_on_cpu(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(got, want, tol=1e-12):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-300)
    assert err <= tol, f'{err:.3e} > {tol:g}'


SHAPES = [(16, 16), (15, 17)]


def _grid(shape, diameter=2.0):
    """FFT-aligned (x, y) numpy grids of the given shape."""
    ny, nx = shape
    dx = diameter / max(shape)
    return np.meshgrid((np.arange(nx) - nx // 2) * dx, (np.arange(ny) - ny // 2) * dx)


def _both(*arrays):
    return [torch.from_numpy(a) for a in arrays], [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize('shape', SHAPES)
def test_masks_and_targets_equal_jax(shape):
    (xt, yt), (xj, yj) = _both(*_grid(shape))
    to, jo = T['objects'], J['objects']
    for wx, wy in ((0.3, None), (0.2, 0.5), (None, 0.4)):
        assert np.array_equal(_np(to.slit(xt, yt, wx, wy)), _np(jo.slit(xj, yj, wx, wy)))
    rt, tt = torch.hypot(xt, yt), torch.atan2(yt, xt)
    rj, tj = jnp.hypot(xj, yj), jnp.arctan2(yj, xj)
    assert np.array_equal(_np(to.pinhole(0.4, rt)), _np(jo.pinhole(0.4, rj)))
    for kw in ({}, {'background': 'white', 'contrast': 0.5},
               {'iradius': 0.2, 'oradius': 0.8, 'background': 'b'}):
        _close(to.siemensstar(rt, tt, 12, **kw), jo.siemensstar(rj, tj, 12, **kw), 0.0)
    # the sinusoidal star is a cosine, equal to rounding
    _close(to.siemensstar(rt, tt, 12, sinusoidal=True), jo.siemensstar(rj, tj, 12, sinusoidal=True))
    for kw in ({}, {'angle': 10, 'radius': 0.3, 'background': 'black'}, {'contrast': 0.6}):
        _close(to.tiltedsquare(xt, yt, **kw), jo.tiltedsquare(xj, yj, **kw), 0.0)
    # a crossed edge rotates its mask by 90 degrees: square grids only, in both packages
    crossed = [{'angle': -7, 'crossed': True}] if shape[0] == shape[1] else []
    for kw in [{}, {'contrast': 0.3}] + crossed:
        _close(to.slantededge(xt, yt, **kw), jo.slantededge(xj, yj, **kw), 0.0)
    with pytest.raises(ValueError):
        to.siemensstar(rt, tt, 12, background='grey')


@pytest.mark.parametrize('shape', SHAPES)
def test_object_transforms_match_jax(shape):
    fx, fy = _grid(shape, diameter=4.0)
    (fxt, fyt, frt), (fxj, fyj, frj) = _both(fx, fy, np.hypot(fx, fy))
    to, jo = T['objects'], J['objects']
    for wx, wy in ((0.3, 0), (0, 0.5)):
        _close(to.slit_ft(wx, wy, fxt, fyt), jo.slit_ft(wx, wy, fxj, fyj))
    # crossed slits read the grid spacing from (1, N) and (M, 1) vectors, so
    # both packages take them as 1-D frequency vectors
    (vxt, vyt), (vxj, vyj) = _both(fx[0], fy[:, 0])
    _close(to.slit_ft(0.2, 0.5, vxt, vyt), jo.slit_ft(0.2, 0.5, vxj, vyj))
    with pytest.raises(ValueError):
        to.slit_ft(0, 0, fxt, fyt)
    _close(to.pinhole_ft(0.35, frt), jo.pinhole_ft(0.35, frj))
    _close(to.pinhole_ft(0.35, 1.7), jo.pinhole_ft(0.35, jnp.asarray(1.7)))


@pytest.mark.parametrize('module', ['degradations', 'degredations'])
@pytest.mark.parametrize('shape', SHAPES)
def test_degradations_match_jax(shape, module):
    fx, fy = _grid(shape, diameter=3.0)
    (fxt, fyt, frt), (fxj, fyj, frj) = _both(fx[:1], fy[:, :1], np.hypot(fx, fy))
    td, jd = T[module], J[module]
    for w, h in ((2.0, 0), (0, 1.5), (0.7, 1.2)):
        _close(td.smear_ft(fxt, fyt, w, h), jd.smear_ft(fxj, fyj, w, h))
    with pytest.raises(ValueError):
        td.smear_ft(fxt, fyt, 0, 0)
    _close(td.jitter_ft(frt, 0.8), jd.jitter_ft(frj, 0.8))
    _close(td.jitter_ft(0.3, 1.1), jd.jitter_ft(jnp.asarray(0.3), 1.1))
    # torch.sinc is the normalized sinc, as jnp.sinc is
    _close(torch.sinc(frt), jnp.sinc(frj))


def _scene(shape, seed=0):
    rng = np.random.default_rng(seed)
    obj = rng.random(shape)
    psf = np.exp(-sum(g ** 2 for g in _grid(shape, 6.0)))
    return obj, psf / psf.sum()


@pytest.mark.parametrize('shape', SHAPES)
def test_conv_matches_jax(shape):
    obj, psf = _scene(shape)
    (ot, pt), (oj, pj) = _both(obj, psf)
    _close(T['convolution'].conv(ot, pt), J['convolution'].conv(oj, pj))
    cobj = obj * np.exp(1j * obj)
    (ct,), (cj,) = _both(cobj)
    got = T['convolution'].conv(ct, pt)
    assert got.is_complex()
    _close(got, J['convolution'].conv(cj, pj))
    # batched leading axes
    (bt,), (bj,) = _both(np.stack([obj, 2 * obj]))
    _close(T['convolution'].conv(bt, pt), J['convolution'].conv(bj, pj))


@pytest.mark.parametrize('shift', [False, True])
@pytest.mark.parametrize('shape', SHAPES)
def test_apply_transfer_functions_matches_jax(shape, shift):
    """Array and callable transfer functions; callables get only the grids they name."""
    obj, psf = _scene(shape, 1)
    (ot, pt), (oj, pj) = _both(obj, psf)
    tc, jc = T['convolution'], J['convolution']
    otf_t = torch.fft.fft2(torch.fft.ifftshift(pt))
    otf_j = jnp.fft.fft2(jnp.fft.ifftshift(pj))
    if shift:
        otf_t, otf_j = torch.fft.fftshift(otf_t), jnp.fft.fftshift(otf_j)
    td, jd = T['degradations'], J['degradations']
    tfs_t = [otf_t, lambda fx, fy: td.smear_ft(fx, fy, 1.5, 0.5), lambda fr: td.jitter_ft(fr, 0.7),
             lambda ft, fr: 1 + 0.1 * torch.cos(ft) * fr]
    tfs_j = [otf_j, lambda fx, fy: jd.smear_ft(fx, fy, 1.5, 0.5), lambda fr: jd.jitter_ft(fr, 0.7),
             lambda ft, fr: 1 + 0.1 * jnp.cos(ft) * fr]
    got = tc.apply_transfer_functions(ot, 0.5, tfs_t, shift=shift)
    assert not got.is_complex()
    _close(got, jc.apply_transfer_functions(oj, 0.5, tfs_j, shift=shift))
    # arrays only: no grids are made; complex objects stay complex
    (ct,), (cj,) = _both(obj + 0.5j * obj[::-1])
    _close(tc.apply_transfer_functions(ct, 0.5, [otf_t], shift=shift),
           jc.apply_transfer_functions(cj, 0.5, [otf_j], shift=shift))
    with pytest.raises(ValueError):
        tc.apply_transfer_functions(ot, 0.5, [lambda q: q])


def test_apply_transfer_functions_takes_given_grids():
    obj, _ = _scene((16, 16), 2)
    fx = np.fft.fftfreq(16, 0.5)
    (ot, fxt), (oj, fxj) = _both(obj, fx)
    tf_t = [lambda fx: torch.exp(-fx ** 2)]
    tf_j = [lambda fx: jnp.exp(-fx ** 2)]
    _close(T['convolution'].apply_transfer_functions(ot, 0.5, tf_t, fx=fxt),
           J['convolution'].apply_transfer_functions(oj, 0.5, tf_j, fx=fxj))


@pytest.mark.parametrize('module', MODULES)
def test_port_exports_every_public_name(module):
    public = {n for n, v in vars(J[module]).items()
              if not n.startswith('_') and callable(v) and not inspect.ismodule(v)
              and getattr(v, '__module__', '').startswith('prysm_tpu.')}
    assert public and all(hasattr(T[module], n) for n in public), \
        sorted(n for n in public if not hasattr(T[module], n))


JAX_POLY_NAMES = sorted(n for n in dir(jpoly) if not n.startswith('_') and 'barplot' not in n)


@pytest.mark.parametrize('name', JAX_POLY_NAMES)
def test_port_exports_every_polynomials_name(name):
    assert hasattr(tpoly, name), f'prysm_tpu_torch.polynomials lacks {name}'
