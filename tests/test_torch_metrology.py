"""The interferometer-analysis path against the same sequence of JAX calls.

``steps.build_metrology`` runs at 128^2 on the CPU in float64; the JAX
package composes the same functions (de Groot, the DCT unwrap,
``Interferogram``: mask, piston / tilt / power / piston, ``spike_clip(3)``, the
statistics and PVr, fill, PSD, band-limited RMS, azimuthal average,
lowpass, slopes; then ``fit_psd``) on the same numpy frames under
``jax_enable_x64``.  Bar: 1e-12 of the reference's peak, NaN where it has
NaN, but PVr at 1e-10 (the normal equations of 37 unnormalized Fringe
Zernikes; see tests/test_torch_interferogram.py) and the fitted PSD
coefficients at 1e-8 (500 Adam steps).  The Zernike barplots run under
matplotlib's Agg backend.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prysm_tpu import polynomials as jpoly
from prysm_tpu.coordinates import make_xy_grid
from prysm_tpu.interferogram import Interferogram, abc_psd, bandlimited_rms, fit_psd
from prysm_tpu.wavelengths import HeNe
from prysm_tpu.x.psi import ZYGO_THIRTEEN_FRAME, degroot_formalism_psi, unwrap_phase

from prysm_tpu_torch import polynomials as tpoly, steps
from prysm_tpu_torch.ops import noise, zernike as zk

torch.set_num_threads(2)

N = 128


@pytest.fixture(scope='module')
def measured():
    """(port path, its results, the JAX results, the measurement) at N^2."""
    measurement = steps.metrology_measurement(N)
    path = steps.build_metrology(N, dtype=torch.float64, device='cpu', measurement=measurement)
    zk.reset_launches()
    noise.reset_launches()
    out = path()
    assert not any({**zk.LAUNCHES, **noise.LAUNCHES}.values())
    return path, out, _jax_metrology(measurement), measurement


def _jax_metrology(measurement):
    frames, _, dx = measurement
    wrapped = degroot_formalism_psi(jnp.asarray(frames), ZYGO_THIRTEEN_FRAME)
    nm = unwrap_phase(wrapped) * (HeNe * 1e3 / (4 * np.pi))
    x, y = make_xy_grid(N, dx=dx)
    ifg = Interferogram(nm, dx=dx, wavelength=HeNe)
    ifg.mask(jnp.hypot(x, y) <= steps.METROLOGY_DIAMETER / 2)
    ifg.remove_piston().remove_tiptilt().remove_power().remove_piston()
    ifg.spike_clip(steps.METROLOGY_CLIP)
    out = {'wrapped': wrapped, 'map': ifg.data, 'pv': ifg.pv, 'rms': ifg.rms, 'Sa': ifg.Sa,
           'std': ifg.std, 'strehl': ifg.strehl, 'pvr': ifg.pvr()}
    p = ifg.fill(0).psd()
    out['psd'] = p.data
    out['bandlimited_rms'] = bandlimited_rms(p.r, p.data, *steps.METROLOGY_BAND)
    out['azavg_rho'], out['azavg'] = p.slices().azavg
    out['filtered'] = ifg.filter(steps.METROLOGY_LOWPASS, 'lowpass').data
    out['slope_x'], out['slope_y'], out['slope'] = (s.data for s in ifg.slope())
    return out


KEYS = ['wrapped', 'map', 'pv', 'rms', 'Sa', 'std', 'strehl', 'psd', 'bandlimited_rms',
        'azavg_rho', 'azavg', 'filtered', 'slope_x', 'slope_y', 'slope']


@pytest.mark.parametrize('key', KEYS)
def test_metrology_path_matches_jax(measured, key):
    _, out, ref, _ = measured
    a, b = out[key].numpy(), np.asarray(ref[key])
    assert a.shape == b.shape and out[key].dtype == torch.float64
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    err = np.nanmax(np.abs(a - b))
    assert err <= 1e-12 * np.nanmax(np.abs(b)), err


def test_metrology_pvr_matches_jax(measured):
    _, out, ref, _ = measured
    assert float(out['pvr']) == pytest.approx(float(ref['pvr']), rel=1e-10)


def test_metrology_psd_fit_matches_jax(measured):
    path, out, ref, _ = measured
    rho, az = np.asarray(ref['azavg_rho']), np.asarray(ref['azavg'])
    keep = (rho > 0) & np.isfinite(az) & (az > 0)
    np.testing.assert_allclose(path.fit_psd(out), fit_psd(rho[keep], az[keep], abc_psd),
                               rtol=1e-8)


def test_measurement_is_recovered_and_the_clip_is_real(measured):
    path, out, _, (frames, truth, dx) = measured
    assert frames.shape == (13, N, N) and frames.dtype == np.float64
    assert dx == steps.METROLOGY_DIAMETER / N
    from prysm_tpu_torch.interferogram import Interferogram as TIfg
    true = TIfg(torch.from_numpy(truth), dx=dx).mask(path.aperture)
    true.remove_piston().remove_tiptilt().remove_power().remove_piston()
    got = path.surface(path.wrapped())
    assert float((got.data - true.data).abs().nan_to_num().max()) < 1e-9
    # the clip removes some pixels of the aperture, and only of it
    clipped = torch.isnan(out['map']) & path.aperture
    assert 0 < int(clipped.sum()) < 0.05 * int(path.aperture.sum())


def test_zernike_barplots_match_names_under_agg():
    pytest.importorskip('matplotlib')
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    nms = [jpoly.fringe_to_nm(j) for j in range(1, 10)]
    coefs = np.linspace(-3, 5, len(nms))
    errs = np.full(len(nms), 0.2)
    assert tpoly.zernike_barplot is tpoly.barplot
    assert tpoly.zernike_barplot_magnitudes is tpoly.barplot_magnitudes
    for orientation in ('h', 'v'):
        fig, ax = tpoly.barplot(torch.from_numpy(coefs), orientation=orientation)
        jfig, jax_ = jpoly.barplot(coefs, orientation=orientation)
        assert len(ax.patches) == len(jax_.patches) == len(coefs)
        assert [t.get_text() for t in ax.texts] == [t.get_text() for t in jax_.texts]
        fig2, ax2 = tpoly.barplot_magnitudes(coefs, nms, errorbars=errs, orientation=orientation,
                                             sort=True)
        jfig2, jax2 = jpoly.barplot_magnitudes(coefs, nms, errorbars=errs, orientation=orientation,
                                               sort=True)
        ticks = ax2.get_xticklabels() if orientation == 'h' else ax2.get_yticklabels()
        jticks = jax2.get_xticklabels() if orientation == 'h' else jax2.get_yticklabels()
        assert [t.get_text() for t in ticks] == [t.get_text() for t in jticks]
        assert [p.get_height() for p in ax2.patches] == [p.get_height() for p in jax2.patches]
        for f in (fig, jfig, fig2, jfig2):
            plt.close(f)
