"""util, wavelengths, refractive and the whole RichData / Slices against the JAX package.

Both packages take the same numpy inputs, made from a seed, under
``jax_enable_x64`` with ``config.precision = 64`` and the CPU asked for.
Bar: 1e-12 of the reference's peak, with NaN where the reference has NaN.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prysm_tpu import _richdata as jrd, refractive as jref, util as jutil, wavelengths as jwl

from prysm_tpu_torch import _richdata as trd, refractive, util, wavelengths
from prysm_tpu_torch.conf import config

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_f64(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _close(a, b, rtol=1e-12):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    scale = np.nanmax(np.abs(b)) if np.isfinite(b).any() else 1.0
    err = np.nanmax(np.abs(a - b)) if np.isfinite(b).any() else 0.0
    assert err <= rtol * max(scale, 1e-300), (err, scale)


def _map(shape=(24, 28), seed=0, holes=True):
    z = np.random.default_rng(seed).normal(scale=20.0, size=shape)
    if holes:
        z[3, 4] = np.nan
        z[10:13, 7] = np.nan
        z[-1, -2] = np.inf
    return z


@pytest.mark.parametrize('name', ['mean', 'pv', 'rms', 'Sa', 'std'])
def test_util_statistics_skip_non_finite_values(name):
    z = _map()
    _close(getattr(util, name)(torch.from_numpy(z)), getattr(jutil, name)(jnp.asarray(z)))


def test_util_ecdf_and_sort_xy():
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=37), rng.normal(size=37)
    x[5] = x[9]  # a tie: both sorts are stable
    for a, b in zip(util.ecdf(torch.from_numpy(x)), jutil.ecdf(jnp.asarray(x))):
        _close(a, b)
    for a, b in zip(util.sort_xy(x.tolist(), y.tolist()), jutil.sort_xy(x, y)):
        _close(a, b)


@pytest.mark.parametrize('name', ['CO2', 'NdYAP', 'NdYAG', 'InGaAs', 'Ruby', 'HeNe', 'Cu', 'XeF',
                                  'XeCl', 'KrF', 'KrCl', 'ArF'])
def test_wavelengths_match(name):
    assert getattr(wavelengths, name) == getattr(jwl, name)


def test_refractive_models_match():
    wvl = np.linspace(0.4, 1.1, 17)
    A, B = (1.0396, 0.2318, 1.0105), (0.0060, 0.0200, 103.56)
    _close(refractive.cauchy(wvl, 1.5, 0.004, 1e-4),
           jref.cauchy(jnp.asarray(wvl), 1.5, 0.004, 1e-4))
    _close(refractive.sellmeier(wvl.tolist(), A, B), jref.sellmeier(jnp.asarray(wvl), A, B))
    _close(refractive.internal_transmission(10.0, 1e-7, wvl * 1e3),
           jref.internal_transmission(10.0, 1e-7, jnp.asarray(wvl * 1e3)))


def _pair(z, dx=0.37, wvl=0.6328):
    return trd.RichData(torch.from_numpy(z), dx, wvl), jrd.RichData(jnp.asarray(z), dx, wvl)


def test_richdata_lazy_grids_and_setters():
    t, j = _pair(_map((15, 18), holes=False))
    for name in ('x', 'y', 'r', 't'):
        _close(getattr(t, name), getattr(j, name))
    assert (t.support_x, t.support_y, t.support) == (j.support_x, j.support_y, j.support)
    assert t.size == j.size and tuple(t.shape) == j.shape
    # replacing x drops the polar grids derived from it
    t.x, j.x = t.x * 2, j.x * 2
    _close(t.r, j.r)
    _close(t.t, j.t)
    t.y, j.y = t.y + 1.5, j.y + 1.5
    _close(t.r, j.r)
    t.r, j.r = t.r * 0 + 3, j.r * 0 + 3
    _close(t.r, j.r)
    # a new array drops every grid
    t.data = torch.from_numpy(_map((9, 11), holes=False))
    j.data = jnp.asarray(_map((9, 11), holes=False))
    _close(t.x, j.x)
    _close(t.r, j.r)


def test_richdata_copy_astype_and_data_setter_dtype():
    z = _map((8, 8), holes=False)
    t, j = _pair(z)
    c = t.copy()
    c.data = c.data * 2
    _close(t.data, z)
    f32 = t.astype(torch.float32)
    assert f32.data.dtype == torch.float32 and t.data.dtype == torch.float64
    assert j.astype(jnp.float32).data.dtype == jnp.float32
    # a numpy array becomes config.precision on config.device; a tensor is kept
    assert trd.RichData(z.astype(np.float32), 1.0, None).data.dtype == torch.float64
    assert trd.RichData(torch.from_numpy(z).float(), 1.0, None).data.dtype == torch.float32
    assert trd.RichData(z + 1j, 1.0, None).data.dtype == torch.complex128


def test_fix_interp_pair_matches():
    for x, y in ((1.0, None), ([1, 2, 3], 0.5), (0.5, [1, 2]), ([1, 2], [3, 4]), (None, None)):
        assert trd.fix_interp_pair(x, y) == jrd.fix_interp_pair(x, y)


def test_exact_lookups_match():
    z = _map((20, 22), seed=3, holes=False)
    t, j = _pair(z, dx=0.5)
    rng = np.random.default_rng(4)
    xs, ys = rng.uniform(-6, 6, 13), rng.uniform(-6, 6, 13)
    xs[0] = 40.0  # outside the grid: 0, as map_coordinates' constant mode
    _close(t.exact_xy(xs, ys), j.exact_xy(xs, ys))
    _close(t.exact_xy(xs.tolist(), 1.25), j.exact_xy(xs.tolist(), 1.25))
    _close(t.exact_x(xs), j.exact_x(xs))
    _close(t.exact_y(ys), j.exact_y(ys))
    rho, phi = rng.uniform(0, 5, 11), rng.uniform(-np.pi, np.pi, 11)
    _close(t.exact_polar(rho, phi), j.exact_polar(rho, phi))
    _close(t.exact_polar(rho.tolist()), j.exact_polar(rho.tolist()))


def _slices_pair(twosided):
    z = _map((32, 32), seed=5)
    z[16:19, 20:23] = np.nan
    t, j = _pair(z, dx=0.25)
    return t.slices(twosided), j.slices(twosided)


@pytest.mark.parametrize('twosided', [True, False])
@pytest.mark.parametrize('name', ['x', 'y', 'azavg', 'azmedian', 'azmin', 'azmax', 'azpv', 'azvar',
                                  'azstd'])
def test_slices_statistics_match(name, twosided):
    ts, js = _slices_pair(twosided)
    assert (ts.center_x, ts.center_y) == (js.center_x, js.center_y)
    for a, b in zip(getattr(ts, name), getattr(js, name)):
        _close(a, b)


def test_azmedian_averages_the_two_middle_values():
    """Some azimuthal bins hold an even count of finite samples: there
    ``torch.nanmedian`` takes the lower middle value, ``jnp.nanmedian`` (and
    the port) their mean."""
    ts, js = _slices_pair(True)
    ts.check_polar_calculated()
    polar = ts._source_polar
    counts = (~torch.isnan(polar)).sum(0)
    even = (counts % 2 == 0) & (counts > 0)
    assert int(even.sum()) > 0
    lower = torch.nanmedian(polar, dim=0).values
    _, ours = ts.azmedian
    assert not torch.allclose(lower[even], ours[even])
    _close(ours, js.azmedian[1])


def test_nan_reductions_on_all_nan_and_mixed_columns():
    a = np.array([[1.0, np.nan, np.nan, 4.0],
                  [3.0, np.nan, 2.0, -np.inf],
                  [np.nan, np.nan, 5.0, 1.0],
                  [7.0, np.nan, 1.0, 0.5]])
    t = torch.from_numpy(a)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')  # all-NaN column
        _close(trd.nanmedian(t), jnp.nanmedian(jnp.asarray(a), axis=0))
        _close(trd.nanmin(t), jnp.nanmin(jnp.asarray(a), axis=0))
        _close(trd.nanmax(t), jnp.nanmax(jnp.asarray(a), axis=0))
        _close(trd.nanvar(t[:, :3]), jnp.nanvar(jnp.asarray(a[:, :3]), axis=0))


def test_plot2d_and_slices_plot_run_headless():
    pytest.importorskip('matplotlib')
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    t, _ = _pair(np.abs(_map((16, 16), holes=False)) + 1)
    fig, ax = t.plot2d(xlim=2, ylim=2, log=True)
    assert ax.get_xlim() == (-2, 2)
    fig2, ax2 = t.slices().plot(['x', 'azavg'], invert_x=True, xlim=3)
    assert len(ax2.lines) == 2
    plt.close(fig)
    plt.close(fig2)
