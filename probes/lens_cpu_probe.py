"""Rehearse the lens-analysis path's float32 errors on the CPU, and the JAX package's own.

Run from the repository root (no card needed; ~5 min at the defaults):

    env PYTHONPATH=. JAX_PLATFORMS=cpu python3 probes/lens_cpu_probe.py [RINGS N FN]

At ``Sampling.hex(RINGS)`` (default 64: 3 x 12,481 rays), an N^2 pupil
(default 1024) and FN^2 focal samples (default 256) it builds
``steps.build_lens_analysis`` in float64 (the mode stack) and float32 on the
CPU, and composes the same path from the JAX package's functions in float32
(x64 off: its traces, fit, rendering, MDFT, adjoint, parabasal first order
and analysis verbs all in float32), from the same real-aimed launches; its
PSF through the step's plan takes the MDFT's products from TF32 operands
(``probes/coating_cpu_probe.py``'s emulation of the card's TF32 plan).  It
prints, for each quantity phase 3n of ``chip_smoke.py`` checks, the JAX
package's float32 error and the port's against the port's float64 path
(which matches the JAX package's float64 path, tests/test_torch_raytrace_*.py),
beside the suggested bar and the bar phase 3n holds: the suggested one, or
twice the JAX package's error where that is larger.  The measures are
``chip_smoke.lens_errors``' and ``lens_same_coefficients``' own, so this
checks what phase 3n checks.  Then the float64 checks of ``lens_f64_checks``.

These are CPU numbers: they say how float32 rounding propagates through the
algorithm, not what the card does.
"""
import math
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from probes.coating_cpu_probe import tf32_mdft
from chip_smoke import (LENS_CURVE_SAMPLES, LENS_FO_SLOTS, LENS_FULL_FIELD_SAMPLES,
                        lens_errors, lens_f64_checks, lens_quantities, lens_same_coefficients)
from prysm_tpu_torch import steps
from prysm_tpu_torch.polynomials import zernike_nm_seq as t_zernike_nm_seq
from prysm_tpu_torch.propagation import Wavefront as TWavefront
from prysm_tpu_torch.x.raytracing import Sampling

torch.set_num_threads(4)
jax.config.update('jax_platforms', 'cpu')

# the suggested bars (chip_smoke.py's phase 3n names them); None: no suggestion
SUGGESTED = {'landing': 1e-4, 'opl': 1e-5, 'xp_z': 1e-5, 'coefs': 1e-4, 'rms': None,
             'opd': 1e-6, 'psf': 2e-5, 'psf_plan': 1e-4, 'psfs': None, 'grads': 1e-3,
             'first_order': None, 'seidel': None, 'distortion': None,
             'field_curvature': None, 'spots': None, 'opd_fans': None, 'full_field': None,
             'lost': None}


def jax_system():
    import prysm_tpu.x.materials as jmat
    import prysm_tpu.x.raytracing as jrt
    media = [jmat.model_glass(nd, vd, name=name) for nd, vd, name in steps.CFG6_GLASSES]
    lens = jrt.LensData()
    for c, t, m in zip(steps.CFG6_CURVATURES, steps.CFG6_THICKNESSES, media + [jmat.air]):
        lens.add(jrt.Sphere(c), thickness=t, material=m)
    return jrt.OpticalSystem(lens, aperture=jrt.ApertureSpec.epd(steps.CFG6_EPD),
                             fields=list(steps.CFG6_FIELDS), wavelengths=[steps.WVL],
                             stop_index=steps.CFG6_STOP, ray_aiming='real')


class JaxPath:
    """The lens-analysis path composed from the JAX package's functions (float32)."""

    def __init__(self, la64, N, fN):
        from prysm_tpu.coordinates import make_xy_grid, cart_to_polar
        from prysm_tpu.geometry import circle_sdf, antialias
        from prysm_tpu.polynomials import zernike_nm_seq
        from prysm_tpu.propagation import prepare_executor
        from prysm_tpu.x.raytracing import adjoint as ja
        self.system = jax_system()
        self.plan64 = la64.fit_plan
        self.P, self.S = la64.P.astype(np.float32), la64.S.astype(np.float32)
        self.x, self.y = make_xy_grid(N, diameter=steps.DIAMETER)
        self.dx = steps.DIAMETER / N
        r, t = cart_to_polar(self.x, self.y)
        self.amp = antialias(circle_sdf(1.0, r), self.dx)
        self.modes = zernike_nm_seq(steps.LENS_NMS, r, t)
        self.mdft = prepare_executor(self.dx, (N, N), 0.25, fN, steps.WVL, steps.EFL)
        self.seeds = ([ja.seed_curvature(j) for j in steps.LENS_SPHERES]
                      + [ja.seed_despace(m) for m in steps.LENS_THICKNESSES])
        self.heads = [ja.RmsSpotHead(), ja.OplSpreadHead()]

    def opd(self, c):
        from prysm_tpu.polynomials import sum_of_2d_modes
        return sum_of_2d_modes(self.modes, jnp.asarray(c, jnp.float32) * 1e6)

    def psf(self, opd, tf32=False):
        """The focal intensity; ``tf32``: the MDFT's products take TF32 operands, as the
        card's TF32 plan (cfg2's, ``matmul_precision='high'``) does."""
        from prysm_tpu.propagation import Wavefront
        wf = Wavefront.from_amp_and_phase(self.amp, opd, steps.WVL, self.dx)
        if tf32:
            E = tf32_mdft(self.mdft)(wf.data)
            return jnp.abs(E) ** 2
        return wf.focus_dft(self.mdft).intensity.data

    def quantities(self):
        import prysm_tpu.x.raytracing as jrt
        from prysm_tpu.x.raytracing import adjoint as ja
        from prysm_tpu.x.raytracing.batch import fit_from_trace
        system, plan = self.system, self.plan64
        F, Nr = plan.P.shape[:2]
        res = jrt.raytrace(system.to_surfaces(), self.P, self.S, steps.WVL)
        onehot = np.zeros((F, Nr), np.float32)
        onehot[np.arange(F), plan.chiefs] = 1.0
        coefs, rms = fit_from_trace(
            res.P[-1].reshape(F, Nr, 3), res.S[-1].reshape(F, Nr, 3),
            res.OPL.sum(axis=0).reshape(F, Nr), (res.status.imag == 0).reshape(F, Nr),
            jnp.asarray(plan.A, jnp.float32), jnp.asarray(plan.ramps, jnp.float32),
            jnp.asarray(onehot), jnp.asarray(plan.P_xp, jnp.float32), plan.n_image)
        grads, values = ja.adjoint_gradient_multi(system, self.P, self.S, steps.WVL,
                                                  self.seeds, self.heads)
        fo = [system.first_order(field=k) for k in range(F)]
        seidel = jrt.seidel_aberrations(system)
        curvature = system.analysis.field_curvature(samples=LENS_CURVE_SAMPLES)
        spots = system.analysis.spot_diagrams()
        fans = system.analysis.opd_fans()
        return {
            'status': np.asarray(res.status), 'landing': np.asarray(res.P[-1]),
            'opl': np.asarray(res.OPL.sum(0)), 'xp_z': float(system.exit_pupil(steps.WVL)[2]),
            'coefs': np.asarray(coefs)[None], 'rms': np.asarray(rms)[None],
            'psfs': np.stack([np.asarray(self.psf(self.opd(c))) for c in np.asarray(coefs)]),
            'grads': np.asarray(grads), 'values': np.asarray(values),
            'first_order': np.array([[getattr(f, s) for s in LENS_FO_SLOTS] for f in fo], float),
            'seidel': np.array([seidel.sums[k] for k in sorted(seidel.sums)]),
            'distortion': system.analysis.distortion(samples=LENS_CURVE_SAMPLES).percent,
            'field_curvature': np.stack([curvature.x_fan_z, curvature.y_fan_z]),
            'spots': np.stack([spots.x, spots.y]), 'opd_fans': np.stack([fans.x, fans.y]),
            'full_field': system.analysis.full_field(
                'rms wfe', samples=LENS_FULL_FIELD_SAMPLES).data}

    def same_coefficients(self, coefs, fN):
        """lens_same_coefficients' measures for the JAX package's float32 rendering and
        MDFT, against the port's float64 mode stack on the JAX grids cast."""
        from prysm_tpu_torch.steps import make_cfg2_plan, make_pupil
        N = self.x.shape[0]
        x64 = torch.as_tensor(np.asarray(self.x, np.float64))
        y64 = torch.as_tensor(np.asarray(self.y, np.float64))
        stack = t_zernike_nm_seq(steps.LENS_NMS, torch.hypot(x64, y64), torch.atan2(y64, x64))
        amp64 = torch.as_tensor(np.asarray(self.amp, np.float64))
        plan64 = make_cfg2_plan(make_pupil(N, dtype=torch.float64, device='cpu'), fN,
                                matmul_precision=None)
        err = {'opd': 0.0, 'psf': 0.0, 'psf_plan': 0.0}
        for c in coefs[0]:
            opd64 = torch.tensordot(torch.as_tensor(np.asarray(c, np.float64)) * 1e6, stack,
                                    dims=1)
            psf64 = (TWavefront.from_amp_and_phase(amp64, opd64, steps.WVL, self.dx)
                     .focus_dft(plan64).intensity.data.numpy())
            opd32 = self.opd(c)
            err['opd'] = max(err['opd'], float(np.abs(np.asarray(opd32, np.float64)
                                                      - opd64.numpy()).max()
                                               / np.abs(opd64.numpy()).max()))
            for key, tf32 in (('psf', False), ('psf_plan', True)):
                psf32 = np.asarray(self.psf(opd32, tf32=tf32), np.float64)
                err[key] = max(err[key], float(np.abs(psf32 - psf64).max() / psf64.max()))
        return err


def bar_for(key, jax_err, scale):
    """The suggested bar, or twice the JAX package's error rounded up to 2 digits."""
    twice = 2 * jax_err
    if twice > 0:
        e = math.floor(math.log10(twice))
        twice = math.ceil(twice / 10 ** (e - 1)) * 10 ** (e - 1)
    suggested = SUGGESTED[key] if key != 'rms' else 1e-3 * scale
    if suggested is None:
        return twice
    return max(suggested, twice)


def main(rings=64, N=1024, fN=256):
    print(f'lens analysis at hex({rings}), {N}^2 pupil, {fN}^2 focal samples (CPU)', flush=True)
    la64 = steps.build_lens_analysis(Sampling.hex(rings), N=N, fN=fN, fused=False,
                                     dtype=torch.float64, device='cpu')
    la32 = steps.build_lens_analysis(Sampling.hex(rings), N=N, fN=fN, dtype=torch.float32,
                                     device='cpu')
    q64, q32 = lens_quantities(la64), lens_quantities(la32)
    jaxp = JaxPath(la64, N, fN)
    qj = jaxp.quantities()
    ours, theirs = lens_errors(q32, q64), lens_errors(qj, q64)
    ours.update(lens_same_coefficients(la32, q32['coefs'], fN))
    theirs.update(jaxp.same_coefficients(qj['coefs'], fN))
    print(f'statuses equal: port {np.array_equal(q32["status"], q64["status"])}, JAX '
          f'{np.array_equal(qj["status"], q64["status"])}; every ray OK in f64: '
          f'{bool((q64["status"].imag == 0).all())}')
    rms_scale = float(np.abs(q64['rms'].numpy()).max())
    print(f'{"quantity":18s} {"suggested":>10s} {"JAX f32":>10s} {"port f32":>10s} '
          f'{"bar":>10s}')
    bars = {}
    for key in SUGGESTED:
        j = theirs[key]
        bars[key] = bar_for(key, 0.0 if math.isnan(j) else j, rms_scale)
        sug = SUGGESTED[key] if key != 'rms' else 1e-3 * rms_scale
        print(f'{key:18s} {sug if sug is not None else float("nan"):10.3e} {j:10.3e} '
              f'{ours[key]:10.3e} {bars[key]:10.3e}', flush=True)
    print('bars (rounded up): ' + ', '.join(f"'{k}': {v:.2g}" for k, v in bars.items()))
    print('f64 checks (port, CPU): ' + ', '.join(
        f'{k} {v:.3e}' for k, v in lens_f64_checks(la64).items()), flush=True)


if __name__ == '__main__':
    main(*(int(a) for a in sys.argv[1:]))
