"""The port's interferogram module against the JAX package's, function by function.

Both packages take the same numpy inputs, made from a seed, under
``jax_enable_x64`` with ``config.precision = 64`` and the CPU asked for;
the port's Interferograms are built from the JAX ones' state through
``interop.interferogram_from_numpy``.  Bar: 1e-12 of the reference's peak,
NaN where it has NaN, but where a test says why it is wider: ``pvr``
solves the normal equations of 37 unnormalized Fringe Zernikes (to n = 12),
whose conditioning takes the two summation orders 1e-11 apart; ``fit_psd``'s
500 Adam steps carry the two autodiffs' last-bit differences, 1e-8.
Random synthesis is fed the same uniform draws in both packages.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prysm_tpu import interferogram as jifg
from prysm_tpu.coordinates import make_xy_grid as jgrid

from prysm_tpu_torch import interferogram as tifg
from prysm_tpu_torch.conf import config
from prysm_tpu_torch.interop import interferogram_from_numpy

torch.set_num_threads(2)

DX, N = 0.4, 48


@pytest.fixture(autouse=True)
def _cpu_f64(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _close(a, b, rtol=1e-12):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    scale = np.nanmax(np.abs(b))
    err = np.nanmax(np.abs(a - b))
    assert err <= rtol * scale, (err, scale)


def _surface(n=N, seed=0, circle=True):
    """A smooth map with a rough part, NaN outside the inscribed circle."""
    x, y = np.meshgrid(*(np.arange(-(n // 2), n - n // 2) * DX,) * 2)
    rng = np.random.default_rng(seed)
    z = 30 * (x / x.max()) ** 2 - 12 * y / y.max() + 8 * x * y / x.max() ** 2 + 20
    z = z + rng.normal(scale=2.0, size=z.shape)
    z[5, 30] = 60.0  # a spike
    if circle:
        z[np.hypot(x, y) > (n // 2 - 1) * DX] = np.nan
    return z


def _pair(z=None, dx=DX, wvl=0.6328):
    z = _surface() if z is None else z
    j = jifg.Interferogram(jnp.asarray(z), dx=dx, wavelength=wvl)
    t = interferogram_from_numpy(np.asarray(j.data), j.dx, j.wavelength, j.intensity, j.meta,
                                 j._latcaled)
    return t, j


def test_fit_plane_and_sphere():
    z = _surface()
    x, y = jgrid(N, dx=DX)
    tx, ty = torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(y))
    _close(tifg.fit_plane(tx, ty, torch.from_numpy(z)), jifg.fit_plane(x, y, jnp.asarray(z)))
    (tm, ts), (jm, js) = tifg.fit_sphere(torch.from_numpy(z)), jifg.fit_sphere(jnp.asarray(z))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _close(ts, js)


@pytest.mark.parametrize('which', [None, 'welch', 'hann', 'hanning', 'array'])
@pytest.mark.parametrize('circle', [True, False])
def test_make_window_both_automatic_branches(which, circle):
    z = np.nan_to_num(_surface(circle=circle), nan=0.0)
    if which == 'array':
        which = np.random.default_rng(1).uniform(size=z.shape)
        got = tifg.make_window(torch.from_numpy(z), DX, which)
        np.testing.assert_array_equal(got, which)
        return
    _close(tifg.make_window(torch.from_numpy(z), DX, which, alpha=6),
           jifg.make_window(jnp.asarray(z), DX, which, alpha=6))
    with pytest.raises(ValueError, match='window'):
        tifg.make_window(torch.from_numpy(z), DX, 'kaiser')


def test_make_window_auto_picks_welch_for_zero_corners_and_hann_otherwise():
    ring = torch.from_numpy(np.nan_to_num(_surface(), nan=0.0))
    full = torch.from_numpy(_surface(circle=False))
    _close(tifg.make_window(ring, DX), tifg.make_window(ring, DX, 'welch'))
    _close(tifg.make_window(full, DX), tifg.make_window(full, DX, 'hann'))


@pytest.mark.parametrize('shape', [(20, 30), (30, 20), (24, 24), (120, 80)])
def test_make_window_corner_slices_of_odd_shapes(shape):
    """2% of an axis rounds to 0 samples on one axis and not the other: a -0
    start slices the whole axis, in torch as in numpy."""
    rng = np.random.default_rng(sum(shape))
    for z in (rng.normal(size=shape), np.zeros(shape)):
        if z.any():
            z[:3, :3] = z[-3:, :3] = z[:3, -3:] = z[-3:, -3:] = 0
        _close(tifg.make_window(torch.from_numpy(z), DX) + 1,
               jifg.make_window(jnp.asarray(z), DX) + 1)


@pytest.mark.parametrize('window', [None, 'hann'])
def test_psd_matches(window):
    z = np.nan_to_num(_surface(), nan=0.0)
    for a, b in zip(tifg.psd(torch.from_numpy(z), DX, window),
                    jifg.psd(jnp.asarray(z), DX, window)):
        _close(a, b)


BAND_CASES = [dict(wllow=2.0), dict(wlhigh=8.0), dict(wllow=1.5, wlhigh=9.0), dict(flow=0.05),
              dict(fhigh=0.4), dict(flow=0.1, fhigh=0.5)]


@pytest.mark.parametrize('kw', BAND_CASES, ids=lambda kw: '-'.join(kw))
@pytest.mark.parametrize('ndim', [1, 2])
def test_bandlimited_rms_truth_table(kw, ndim):
    z = np.nan_to_num(_surface(), nan=0.0)
    ux, uy, p = jifg.psd(jnp.asarray(z), DX)
    r = jnp.hypot(ux, uy)
    if ndim == 1:
        r, p = r[N // 2], p[N // 2]
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter('always')
        ref = jifg.bandlimited_rms(r, p, **kw)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter('always')
        got = tifg.bandlimited_rms(torch.from_numpy(np.asarray(r)), torch.from_numpy(np.asarray(p)),
                                   **kw)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    _close(got, ref)


def test_bandlimited_rms_needs_a_band():
    with pytest.raises(ValueError, match='period'):
        tifg.bandlimited_rms(torch.ones(4, 4), torch.ones(4, 4))


def test_psd_models():
    nu = np.logspace(-2, 1, 25)
    _close(tifg.abc_psd(torch.from_numpy(nu), 10.0, 0.2, 2.5),
           jifg.abc_psd(jnp.asarray(nu), 10.0, 0.2, 2.5))
    _close(tifg.ab_psd(torch.from_numpy(nu), 3.0, 1.7), jifg.ab_psd(jnp.asarray(nu), 3.0, 1.7))


def _draws(shape, seed=2):
    return np.random.default_rng(seed).uniform(size=shape)


def test_synthesis_from_the_same_draws(monkeypatch):
    nu = np.asarray(jnp.fft.fftshift(jnp.fft.fftfreq(32, 0.5)))
    nuxx, nuyy = np.meshgrid(nu, nu)
    p = np.asarray(jifg.abc_psd(np.hypot(nuxx, nuyy) + 0.01, 1.0, 0.3, 2.0))
    draws = _draws(p.shape)
    monkeypatch.setattr(jax.random, 'uniform', lambda key, shape: jnp.asarray(draws))
    ref = jifg.synthesize_surface_from_psd(jnp.asarray(p), nu, nu, key=jax.random.PRNGKey(0))
    got = tifg.synthesize_surface_from_draws(torch.from_numpy(p), nu, nu, torch.from_numpy(draws))
    for a, b in zip(got, ref):
        _close(a, b)
    # the generator's draws feed the same synthesis
    gen = torch.Generator().manual_seed(3)
    drawn = torch.rand(p.shape, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    for a, b in zip(tifg.synthesize_surface_from_psd(torch.from_numpy(p), nu, nu, generator=gen),
                    tifg.synthesize_surface_from_draws(torch.from_numpy(p), nu, nu, drawn)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match='Generator'):
        tifg.synthesize_surface_from_psd(torch.from_numpy(p), nu, nu)


@pytest.mark.parametrize('mask', [None, 'circle', 'array'])
def test_render_synthetic_surface_from_the_same_draws(monkeypatch, mask):
    size, samples = 20.0, 40
    draws = _draws((samples, samples), seed=4)
    monkeypatch.setattr(jax.random, 'uniform', lambda key, shape: jnp.asarray(draws))
    monkeypatch.setattr(tifg, 'synthesize_surface_from_psd',
                        lambda p, nx, ny, generator=None: tifg.synthesize_surface_from_draws(
                            p, nx, ny, torch.from_numpy(draws)))
    if mask == 'array':
        mask = np.zeros((samples, samples), bool)
        mask[5:30, 8:33] = True
    kw = dict(rms=7.0, mask=mask, a=1.0, b=0.2, c=2.0)
    ref = jifg.render_synthetic_surface(size, samples, key=jax.random.PRNGKey(1), **kw)
    got = tifg.render_synthetic_surface(size, samples, generator=torch.Generator(), **kw)
    for a, b in zip(got, ref):
        _close(a, b)
    jr = jifg.Interferogram.render_from_psd(size, samples, rms=3.0, key=jax.random.PRNGKey(1),
                                            a=1.0, b=0.2, c=2.0)
    tr = tifg.Interferogram.render_from_psd(size, samples, rms=3.0, generator=torch.Generator(),
                                            a=1.0, b=0.2, c=2.0)
    _close(tr.data, jr.data)
    assert tr.dx == pytest.approx(jr.dx, rel=1e-15) and tr.wavelength == jr.wavelength
    with pytest.raises(ValueError, match='circle'):
        tifg.render_synthetic_surface(size, samples, mask='square', generator=torch.Generator(),
                                      a=1.0, b=0.2, c=2.0)


def _psd_curve(seed=5):
    f = np.logspace(-2, 0.5, 60)
    noise = np.exp(np.random.default_rng(seed).normal(scale=0.05, size=f.size))
    return f, np.asarray(jifg.abc_psd(f, 40.0, 0.15, 2.2)) * noise


def test_fit_psd_ab_closed_form():
    f, p = _psd_curve()
    p = 3.0 * f ** -1.8
    _close(tifg.fit_psd(f, p, tifg.ab_psd), jifg.fit_psd(f, p, jifg.ab_psd))


def test_fit_psd_abc_adam():
    f, p = _psd_curve()
    got = tifg.fit_psd(torch.from_numpy(f), torch.from_numpy(p))
    ref = jifg.fit_psd(jnp.asarray(f), jnp.asarray(p))
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, ref, rtol=1e-8)


def test_abc_guess_matches():
    f, p = _psd_curve(6)
    np.testing.assert_allclose(tifg._abc_psd_guess(torch.from_numpy(f), torch.from_numpy(p)),
                               jifg._abc_psd_guess(jnp.asarray(f), jnp.asarray(p)), rtol=1e-13)


def test_hann2d_and_lowpass_kernel():
    for shape in ((16, 16), (15, 20)):
        _close(tifg.hann2d(*shape), jifg.hann2d(*shape))
    r = np.hypot(*jgrid(17, dx=0.3))
    _close(tifg.ideal_lpf_iir2d(torch.from_numpy(np.asarray(r)), 0.3, 0.4),
           jifg.ideal_lpf_iir2d(r, 0.3, 0.4))


@pytest.mark.parametrize('typ,fc', [('lowpass', 0.3), ('hp', 0.3), ('bandpass', (0.2, 0.6)),
                                    ('br', (0.2, 0.6))])
def test_designfilt2d_all_four_types(typ, fc):
    r = np.asarray(jnp.hypot(*jgrid((24, 24), dx=DX)))
    _close(tifg.designfilt2d(torch.from_numpy(r), DX, fc, typ), jifg.designfilt2d(r, DX, fc, typ))
    with pytest.raises(ValueError, match='filter'):
        tifg.designfilt2d(torch.from_numpy(r), DX, fc, 'notch')


def test_random_subaperture_mask_placement():
    sub = np.zeros((5, 7), bool)
    sub[1:4, 2:6] = True
    ref = np.asarray(jifg.make_random_subaperture_mask((20, 24), jnp.asarray(sub),
                                                       key=jax.random.PRNGKey(7)))
    rows, cols = np.nonzero(ref)
    dy, dx = rows.min() - 1, cols.min() - 2
    placed = tifg._place_subaperture((20, 24), torch.from_numpy(sub), int(dy), int(dx))
    np.testing.assert_array_equal(placed.numpy(), ref)
    drawn = tifg.make_random_subaperture_mask((20, 24), torch.from_numpy(sub),
                                              generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (20, 24) and int(drawn.sum()) == int(sub.sum())
    with pytest.raises(ValueError, match='Generator'):
        tifg.make_random_subaperture_mask((20, 24), torch.from_numpy(sub))
    with pytest.raises(ValueError, match='fit'):
        tifg.make_random_subaperture_mask((4, 4), torch.from_numpy(sub),
                                          generator=torch.Generator())


@pytest.mark.parametrize('name', ['pv', 'rms', 'Sa', 'std', 'strehl', 'dropout_percentage'])
def test_interferogram_statistics(name):
    t, j = _pair()
    _close(getattr(t, name), getattr(j, name))


def test_pvr():
    t, j = _pair()
    # the normal equations of 37 unnormalized Fringe Zernikes (module docstring)
    _close(t.pvr(), j.pvr(), rtol=1e-10)
    _close(t.pvr(normalization_radius=5.0), j.pvr(normalization_radius=5.0), rtol=1e-10)
    with pytest.raises(ValueError, match='square'):
        _pair(_surface()[:, :40])[0].pvr()


def test_processing_chain_matches():
    t, j = _pair()
    for ifg in (t, j):
        ifg.remove_piston().remove_tiptilt().remove_power().spike_clip(2.5)
    _close(t.data, j.data)
    t.mask(np.abs(np.asarray(j.x)) < 7), j.mask(jnp.abs(j.x) < 7)
    _close(t.data, j.data)
    t.fill(1.5), j.fill(1.5)
    _close(t.data, j.data)


def test_crop_recenter_pad_latcal():
    z = np.full((40, 44), np.nan)
    z[6:30, 9:35] = _surface(40, circle=False)[6:30, 9:35]
    t, j = _pair(z)
    _ = t.r, j.r  # crop carries grids that were built
    t.crop(), j.crop()
    _close(t.data, j.data)
    _close(t.x, j.x)
    _close(t.r, j.r)
    t.recenter(), j.recenter()
    _close(t.x, j.x)
    _close(t.t, j.t)
    t.pad(samples=4), j.pad(samples=4)
    _close(t.data, j.data)
    t.pad(0.0, shape=(40, 42)), j.pad(0.0, shape=(40, 42))
    _close(t.data, j.data)
    with pytest.raises(ValueError, match='Neither'):
        t.pad()
    with pytest.raises(ValueError, match='Both'):
        t.pad(samples=1, shape=(2, 2))
    t.latcal(0.25), j.latcal(0.25)
    assert (t.dx, t._latcaled) == (j.dx, j._latcaled)
    _close(t.x, j.x)
    t.strip_latcal(), j.strip_latcal()
    assert (t.dx, t._latcaled) == (j.dx, j._latcaled) == (1.0, False)
    empty = tifg.Interferogram(torch.full((4, 4), float('nan')), dx=1.0)
    assert empty.crop().shape == (4, 4)


def test_psd_filter_slope_tis():
    t, j = _pair()
    t.fill(0), j.fill(0)
    tp, jp = t.psd(), j.psd()
    _close(tp.data, jp.data)
    _close(tp.r, jp.r)
    assert tp.dx == pytest.approx(jp.dx, rel=1e-15)
    _close(tp.slices().azavg[1], jp.slices().azavg[1])
    _close(t.bandlimited_rms(wllow=1.0, wlhigh=8.0), j.bandlimited_rms(wllow=1.0, wlhigh=8.0))
    # a map of 1e-4 nm keeps the scatter below saturation
    st, sj = _pair(_surface() * 1e-4)
    st.fill(0), sj.fill(0)
    _close(st.total_integrated_scatter(0.6328, 10.0), sj.total_integrated_scatter(0.6328, 10.0))
    for a, b in zip(t.slope(), j.slope()):
        _close(a.data, b.data)
    t.filter(0.3, 'lp'), j.filter(0.3, 'lp')
    _close(t.data, j.data)


def test_slope_edges_with_nans():
    t, j = _pair()
    for a, b in zip(t.slope(), j.slope()):
        _close(a.data, b.data)
        assert a.dx == b.dx and a.wavelength is None


def test_zygo_dat_save_and_load(tmp_path):
    t, j = _pair()
    t.save_zygo_dat(tmp_path / 'port.dat')
    j.save_zygo_dat(tmp_path / 'jax.dat')
    tl = tifg.Interferogram.from_zygo_dat(tmp_path / 'jax.dat')
    jl = jifg.Interferogram.from_zygo_dat(tmp_path / 'port.dat')
    _close(tl.data, jl.data)
    assert tl.dx == pytest.approx(jl.dx, rel=1e-15)
    assert tl.wavelength == pytest.approx(jl.wavelength, rel=1e-15)
    assert tl.meta['cn_width'] == N and tl.data.dtype == torch.float64
    np.testing.assert_array_equal(tl.intensity, jl.intensity)
    t.save_zygo_ascii(tmp_path / 'port.asc')
    text = (tmp_path / 'port.asc').read_text()
    assert text.startswith('Zygo ASCII Data File') and text.endswith('#\n')


def test_wavelength_from_meta_and_str():
    meta = {'wavelength': 6.328e-7}
    t = tifg.Interferogram(torch.from_numpy(_surface()), dx=DX, wavelength=None, meta=meta)
    j = jifg.Interferogram(jnp.asarray(_surface()), dx=DX, wavelength=None, meta=dict(meta))
    assert t.wavelength == j.wavelength
    assert str(t) == str(j)
    px = tifg.Interferogram(torch.from_numpy(_surface()))
    assert not px._latcaled and 'px' in str(px)


def test_interferogram_plot_runs_headless():
    pytest.importorskip('matplotlib')
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from prysm_tpu_torch.plotting import add_psd_model
    t, _ = _pair()
    fig, ax = t.interferogram(tilt_waves=(1, 2))
    assert len(ax.images) == 1
    fig2, ax2 = plt.subplots()
    ax2.set_xlim(0.01, 1.0)
    add_psd_model({'a': 1.0, 'b': 0.2, 'c': 2.0}, fig2, ax2)
    add_psd_model({'a': 1.0, 'b': 1.5}, fig2, ax2, invert_x=True)
    assert len(ax2.lines) == 2
    plt.close(fig)
    plt.close(fig2)
