"""Rehearse the metrology path's float32 errors on the CPU, and the JAX package's own.

Run from the repository root (no card needed):

    env PYTHONPATH=. JAX_PLATFORMS=cpu python3 probes/metrology_cpu_probe.py [N ...]

For each N (default 256, 512 and 1024) it builds ``steps.build_metrology``
on one ``metrology_measurement`` and prints, against the port's float64
path (which matches the JAX package's float64 path to 1e-12,
tests/test_torch_metrology.py):

* the unwrapped map's error, over the aperture against its PV, of the
  port's float32 path and of the JAX package's float32 path (x64 off) on
  the same frames: the least-squares unwrap's own float32 floor;
* each analysis output's error when the float64 map, clipped by the
  float64 clip, is cast to float32 and analysed in float32 (the analysis's
  own float32 error), by the port and by the JAX package;
* each analysis output's error end to end, float32 from the frames, over
  the float64 clip, of the port and of the JAX package.

These are CPU numbers: they say how float32 rounding propagates through
the algorithm, not what the card does.
"""
import math
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from prysm_tpu.coordinates import make_xy_grid
from prysm_tpu.interferogram import Interferogram, bandlimited_rms
from prysm_tpu.x.psi import ZYGO_THIRTEEN_FRAME, degroot_formalism_psi, unwrap_phase

from prysm_tpu_torch import steps

KEYS = ('pv', 'rms', 'Sa', 'std', 'strehl', 'pvr', 'bandlimited_rms', 'psd', 'azavg',
        'filtered', 'slope_x', 'slope_y', 'slope')


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.nanmax(np.abs(a - b)) / np.nanmax(np.abs(b)))


def jax_f32_map(measurement, N):
    """The JAX package's float32 map: de Groot, unwrap, mask, piston / tilt / power / piston."""
    frames, _, dx = measurement
    wrapped = degroot_formalism_psi(jnp.asarray(frames, jnp.float32), ZYGO_THIRTEEN_FRAME)
    x, y = make_xy_grid(N, dx=dx)
    ifg = Interferogram(unwrap_phase(wrapped) * (632.8 / (4 * math.pi)), dx=dx)
    ifg.mask(jnp.hypot(x, y) <= steps.METROLOGY_DIAMETER / 2)
    ifg.remove_piston().remove_tiptilt().remove_power().remove_piston()
    return np.asarray(ifg.data)


def jax_analyze(z, dx):
    """The JAX package's analysis of a clipped map, as steps' _Metrology.analyze runs it."""
    ifg = Interferogram(jnp.asarray(z), dx=dx)
    out = {'pv': ifg.pv, 'rms': ifg.rms, 'Sa': ifg.Sa, 'std': ifg.std, 'strehl': ifg.strehl,
           'pvr': ifg.pvr()}
    p = ifg.fill(0).psd()
    out['psd'] = p.data
    out['bandlimited_rms'] = bandlimited_rms(p.r, p.data, *steps.METROLOGY_BAND)
    out['azavg'] = p.slices().azavg[1]
    out['filtered'] = ifg.filter(steps.METROLOGY_LOWPASS, 'lowpass').data
    out['slope_x'], out['slope_y'], out['slope'] = (s.data for s in ifg.slope())
    return out


def probe(N):
    measurement = steps.metrology_measurement(N)
    m32 = steps.build_metrology(N, dtype=torch.float32, device='cpu', measurement=measurement)
    m64 = steps.build_metrology(N, dtype=torch.float64, device='cpu', measurement=measurement)
    out64 = m64()
    s64 = m64.surface(out64['wrapped']).data.numpy()
    ap = m64.aperture.numpy()
    pv = np.ptp(s64[ap])
    s32 = m32.surface(m32.wrapped()).data.double().numpy()
    sj = jax_f32_map(measurement, N)
    print(f'N={N}: map PV {pv:.4f} nm; unwrapped map vs f64 over the aperture, of PV: '
          f'port f32 {np.abs(s32 - s64)[ap].max() / pv:.3e}, '
          f'JAX f32 {np.abs(sj - s64)[ap].max() / pv:.3e}')
    clip64 = np.isnan(out64['map'].numpy())

    def clipped(z):
        return np.where(clip64, np.nan, np.asarray(z, np.float32))

    from prysm_tpu_torch.interferogram import Interferogram as TIfg
    rows = {
        'f64 map cast to f32, port': m32.analyze(TIfg(torch.from_numpy(clipped(s64)), dx=m32.dx)),
        'f64 map cast to f32, JAX ': jax_analyze(clipped(s64), m32.dx),
        'end to end f32, port     ': m32.analyze(TIfg(torch.from_numpy(clipped(s32)), dx=m32.dx)),
        'end to end f32, JAX      ': jax_analyze(clipped(sj), m32.dx),
    }
    for what, out in rows.items():
        print(f'  {what}: ' + ', '.join(f'{k} {rel(out[k], out64[k]):.2e}' for k in KEYS))


def main(argv):
    torch.set_num_threads(4)
    jax.config.update('jax_platforms', 'cpu')
    for N in [int(a) for a in argv] or [256, 512, 1024]:
        probe(N)


if __name__ == '__main__':
    main(sys.argv[1:])
