"""Rehearse the lens-design path's float32 errors on the CPU, and the JAX package's own.

Run from the repository root (no card needed; ~3 min at the defaults):

    env PYTHONPATH=. JAX_PLATFORMS=cpu python3 probes/design_cpu_probe.py [RINGS NPUPIL NPIX]

At ``Sampling.hex(RINGS)`` (default 64: 12,481 rays a field), ``NPUPIL``^2 pupil fields
(default 128) and ``NPIX``^2 PSF grids (default 512, Q=2) it builds
``steps.build_lens_design`` in float64 on the CPU, optimises it (``DESIGN_SOLVE``, 10
iterations), and then measures, with ``chip_smoke.py``'s own functions
(``design_start``, ``design_diffraction``, ``design_errors``), the float32 errors that
phase 3o checks: at the start the residuals and the 'auto' Jacobian, and on the
optimised lens the pupil-field PSFs (on axis apart) and the PRT Jones matrices; for the
port in float32 on the CPU and for the JAX package's own path composed from its
functions in float32 (x64 off), both against the port's float64 path (which matches
the JAX package's float64 path, tests/test_torch_raytrace_*.py).  Beside each it prints
the suggested bar and the bar phase 3o holds: the suggested one, or twice the JAX
package's error where that is larger.  It also prints both packages' float32 errors of
the tolerancing step on the optimised lens (the sensitivity table, the on-axis
wavefront differential's maps and expected RMS), which phase 3o runs in float64 only.  Then the float64 checks phase 3o makes on the
card, at full size: the 'auto' Jacobian against central differences, the sensitivity
table against the adjoint over the table's own truncation, and the wavefront
differential's tangents against its central differences.  It also measures the focus
alone in float32 (``pupil_field_psf`` of the float64 pupil fields, both packages) and,
last, with the JAX package's float64 on, the rounding between two float64
implementations of the diffraction step (the JAX package's against the port's on the
CPU): the floor that phase 3o's card-against-CPU float64 bars rest on.

These are CPU numbers: they say how float32 rounding propagates through the algorithm,
not what the card does.
"""
import math
import sys
import time

import numpy as np
import torch

import jax

from chip_smoke import (DESIGN_FD_STEP, design_diffraction, design_errors, design_fd_jacobian,
                        design_refocus, design_start, peak_errors)
from prysm_tpu_torch import steps
from prysm_tpu_torch.x.raytracing import Sampling

torch.set_num_threads(4)
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', False)

# the suggested bars (phase 3o's target tiers); None: no suggestion
SUGGESTED = {'residuals': 1e-3, 'jacobian': 1e-3, 'opd': None, 'psf': 2e-5, 'psf_axis': 2e-5,
             'jones': 1e-5, 'psf_focus': 2e-5}
# the float64 rounding tier (the CPU parity tests' bars); phase 3o holds card against CPU
# at these or at ten times the two packages' float64 difference on the CPU, where larger
SUGGESTED64 = {'opd64': 1e-10, 'psf64': 1e-10, 'focus64': 1e-10, 'jones64': 1e-12}


def jax_system():
    """The designer's lens read back through the JAX package (its .zmx text), with the
    design variables of steps._LensDesign, and its starting EFL."""
    import prysm_tpu.x.materials as jmat
    import prysm_tpu.x.raytracing as jrt
    from prysm_tpu.x.raytracing import lensdata as jlensdata
    WVL = steps.WVL
    lens = jrt.LensData()
    media = [jmat.model_glass(nd, vd, name=name) for nd, vd, name in steps.CFG6_GLASSES]
    for c, t, m in zip(steps.CFG6_CURVATURES, steps.CFG6_THICKNESSES, media + [jmat.air]):
        lens.add(jrt.Sphere(c), thickness=t, material=m)
    source = jrt.OpticalSystem(lens, aperture=jrt.ApertureSpec.epd(steps.CFG6_EPD),
                               fields=list(steps.CFG6_FIELDS), wavelengths=[WVL],
                               stop_index=steps.CFG6_STOP)
    source.lens.rows.insert(steps.DESIGN_DECENTRE_ROW, jlensdata.CoordBreak())
    system = jrt.read_zmx(jrt.write_zmx(source), _is_text=True,
                          database=jmat.Catalog.from_materials(media))
    efl = float(jrt.effective_focal_length(system.to_surfaces(), wvl=WVL))
    system.opt.vary('curvature', steps.DESIGN_CURVATURE_ROWS)
    system.opt.vary('thickness', steps.DESIGN_THICKNESS_ROWS)
    return system, efl


def jax_quantities(rings, npupil, npix, x, fields64):
    """design_start's and design_diffraction's quantities, from the JAX package's
    functions in float32 (x64 off), on the same launches (host float64 paraxial aims);
    and the float32 focus alone, of the port's float64 pupil fields ``fields64``."""
    import prysm_tpu.x.raytracing as jrt
    WVL = steps.WVL
    system, efl = jax_system()
    sampling = jrt.Sampling.hex(rings)
    fields = [system.field(k) for k in range(3)]
    prob = jrt.Problem(system, [jrt.RmsSpotRadius(f, WVL, sampling) for f in fields]
                       + [jrt.WavefrontRMS(fields[-1], WVL, sampling)],
                       constraints=[jrt.EFL(WVL, target=efl)], gradient='auto')
    x0 = prob.x0()
    out = {'r': prob.residuals(x0), 'J': prob.residual_jacobian(x0)}
    system.opt.update(x)
    pfs = [jrt.pupil_field(system, system.field(k), WVL, npupil=npupil) for k in range(3)]
    P, S = jrt.launch(system, system.field(2), WVL, sampling)
    out['tolerance'] = tolerance_quantities(jrt, system, *jax_perturbations(jrt, system), rings)
    out.update(opd=[np.asarray(pf.opd, float) for pf in pfs],
               psfs=jax_refocus(pfs, npix),
               jones=np.asarray(jrt.raytrace_prt(system, np.asarray(P), np.asarray(S),
                                                 WVL).P_matrix),
               refocus=jax_refocus(fields64, npix))
    return out


def jax_refocus(fields, npix):
    """The JAX package's ``pupil_field_psf`` of the given pupil fields, in its precision."""
    import prysm_tpu.x.raytracing as jrt
    return [np.asarray(jrt.pupil_field_psf(pf, npix=npix, Q=steps.DESIGN_Q)[0], float)
            for pf in fields]


def jax_diffraction64(rings, npupil, npix, x, q64):
    """With the JAX package's float64 on: its diffraction step with the lens at x against
    the port's float64 one (``q64``, design_diffraction's), as phase 3o compares the card
    with the CPU: the OPD (um), the PSFs end to end (peak rel), the JAX package's focus
    of the port's pupil fields, and the Jones matrices (abs)."""
    import prysm_tpu.x.raytracing as jrt
    WVL = steps.WVL
    system, _ = jax_system()
    system.opt.update(x)
    pfs = [jrt.pupil_field(system, system.field(k), WVL, npupil=npupil) for k in range(3)]
    psfs = jax_refocus(pfs, npix)
    P, S = jrt.launch(system, system.field(2), WVL, jrt.Sampling.hex(rings))
    jones = np.asarray(jrt.raytrace_prt(system, np.asarray(P), np.asarray(S), WVL).P_matrix)
    return {'opd64': max(float(np.abs(np.asarray(a.opd, float) - b).max())
                         for a, b in zip(pfs, q64['opd'])),
            'psf': peak_errors(psfs, q64['psfs']),
            'focus64': max(peak_errors(jax_refocus(q64['fields'], npix), q64['psfs'])),
            'jones64': float(np.abs(jones - q64['jones']).max())}


def tolerance_quantities(rt, system, perturbations, focus, rings):
    """The tolerancing step's sensitivities, wavefront-differential maps and expected RMS
    through ``rt`` (either package's raytracing) on ``system`` as it stands."""
    WVL = steps.WVL
    sampling = rt.Sampling.hex(rings)
    P2, S2 = (np.asarray(a, float) for a in rt.launch(system, system.field(2), WVL, sampling))
    P0, S0 = (np.asarray(a, float) for a in rt.launch(system, system.field(0), WVL, sampling))
    spot = rt.RmsSpotRadius()

    def merit(s):
        return float(spot.value(s.trace(P2, S2, WVL), s, WVL))

    table = system.tol.sensitivity(perturbations, merit).sensitivities()
    wd = system.tol.wavefront(perturbations, P0, S0, WVL, compensators=[focus])
    return {'table': table, 'dW': np.asarray(wd.dW, float), 'expected_rms': wd.expected_rms()}


def jax_perturbations(jrt, system):
    """steps._LensDesign.perturbations and its focus compensator, through the JAX package."""
    s = steps.DESIGN_SIGMAS
    perts = ([jrt.Perturbation.normal(system, 'curvature', r, s['curvature'], name=f'c{r}')
              for r in steps.DESIGN_CURVATURE_ROWS]
             + [jrt.Perturbation.normal(system, 'thickness', r, s['thickness'], name=f't{r}')
                for r in steps.DESIGN_THICKNESS_ROWS]
             + [jrt.Perturbation.normal(system, 'decenter', steps.DESIGN_DECENTRE_ROW,
                                        s['decenter'], name='dy', component=1)])
    focus = jrt.Perturbation.normal(system, 'thickness', steps.DESIGN_FOCUS_ROW, s['focus'],
                                    name='focus')
    return perts, focus


def tolerance_errors(q, ref):
    """Relative errors of tolerance_quantities' outputs against ``ref``: the table and
    the maps against their largest magnitude, the expected RMS against itself."""
    return {'table': float(np.abs(q['table'] - ref['table']).max() / np.abs(ref['table']).max()),
            'dW': float(np.abs(q['dW'] - ref['dW']).max() / np.abs(ref['dW']).max()),
            'expected_rms': abs(q['expected_rms'] - ref['expected_rms']) / ref['expected_rms']}


def bar_for(key, jax_err, suggested=SUGGESTED, factor=2):
    """The suggested bar, or ``factor`` times the JAX package's error rounded up to 2
    digits, where that is larger."""
    scaled = factor * jax_err
    if scaled > 0:
        e = math.floor(math.log10(scaled))
        scaled = math.ceil(scaled / 10 ** (e - 1)) * 10 ** (e - 1)
    return scaled if suggested[key] is None else max(suggested[key], scaled)


def f64_checks(design, problem, res):
    """Phase 3o's float64 checks on the CPU: the start's auto Jacobian against central
    differences (per column), the optimised lens's sensitivity table against the adjoint
    (the worst ratio to its truncation estimate) and its wavefront differential's
    tangents against central differences (per column)."""
    from prysm_tpu_torch.x.raytracing.adjoint import RmsSpotHead
    out = {}
    x0 = problem.x0() if res is None else None
    if res is None:
        with design.configured():
            J = problem.residual_jacobian(x0)
            fd = design_fd_jacobian(problem, x0, DESIGN_FD_STEP)
        out['fd'] = float((np.abs(J - fd).max(axis=0) / np.abs(J).max(axis=0)).max())
        return out
    P2, S2 = design.bundle(2)
    P0, S0 = design.bundle(0)
    merit = design.spot_merit(P2, S2)
    perts = design.perturbations()
    with design.configured():
        table = design.system.tol.sensitivity(perts, merit).sensitivities()
        half = design.system.tol.sensitivity(design.perturbations(0.5), merit).sensitivities()
        exact = design.system.tol.adjoint_sensitivity(perts, [RmsSpotHead()], P2, S2).jacobian[0]
        tangent = design.system.tol.wavefront(perts, P0, S0, steps.WVL).dW
        central = design.system.tol.wavefront(perts, P0, S0, steps.WVL, method='fd').dW
    floor = 1e-9 * np.abs(exact).max()
    out['table_over_truncation'] = float((np.abs(table - exact)
                                          / (4 / 3 * np.abs(table - half) + floor)).max())
    out['table_rel'] = float(np.abs(table - exact).max() / np.abs(exact).max())
    per_col = np.abs(tangent - central).max(axis=0) / np.abs(central).max(axis=0)
    out['wd_fd'] = float(per_col.max())
    out['wd_fd_columns'] = [float(v) for v in per_col]
    return out


def main(rings=64, npupil=steps.DESIGN_NPUPIL, npix=steps.DESIGN_NPIX):
    print(f'lens design at hex({rings}), {npupil}^2 pupil fields, {npix}^2 PSFs (CPU)',
          flush=True)

    def plan(dtype):
        return steps.build_lens_design(Sampling.hex(rings), npupil, npix, dtype=dtype,
                                       device='cpu')

    d64 = plan(torch.float64)
    d64.prescription()
    problem = d64.problem()
    print('f64 check at the start: ' + ', '.join(
        f'{k} {v:.3e}' for k, v in f64_checks(d64, problem, None).items()), flush=True)
    t0 = time.perf_counter()
    res, problem = d64.optimise(problem=problem)
    print(f'f64 optimisation: {res.nit} iterations, {res.nfev} evaluations, '
          f'{time.perf_counter() - t0:.1f} s; cost {res.history[0]["cost"]:.6e} -> '
          f'{res.cost:.6e}; x {res.x.tolist()}', flush=True)
    print('f64 checks on the optimised lens: ' + ', '.join(
        f'{k} {v}' for k, v in f64_checks(d64, problem, res).items()), flush=True)

    ref64, ref32 = plan(torch.float64), plan(torch.float32)
    q64 = {**design_start(ref64), **design_diffraction(ref64, res.x)}
    q32 = {**design_start(ref32), **design_diffraction(ref32, res.x)}
    t0 = time.perf_counter()
    qj = jax_quantities(rings, npupil, npix, res.x, q64['fields'])
    print(f'JAX package float32 path: {time.perf_counter() - t0:.1f} s', flush=True)
    ours, theirs = design_errors(q32, q64), design_errors(qj, q64)
    focus = {'port': peak_errors(design_refocus(ref32, q64['fields']), q64['psfs']),
             'JAX': peak_errors(qj['refocus'], q64['psfs'])}
    print('f32 focus of the f64 pupil fields against f64, by field (peak rel): '
          + '; '.join(f'{k} ' + ', '.join(f'{e:.3e}' for e in v) for k, v in focus.items()),
          flush=True)
    ours['psf_focus'], theirs['psf_focus'] = max(focus['port']), max(focus['JAX'])
    print(f'{"quantity":12s} {"suggested":>10s} {"JAX f32":>10s} {"port f32":>10s} '
          f'{"bar":>10s}')
    bars = {}
    for key in SUGGESTED:
        bars[key] = bar_for(key, theirs[key])
        sug = float('nan') if SUGGESTED[key] is None else SUGGESTED[key]
        print(f'{key:12s} {sug:10.3e} {theirs[key]:10.3e} {ours[key]:10.3e} '
              f'{bars[key]:10.3e}', flush=True)
    print('bars (rounded up): ' + ', '.join(f"'{k}': {v:.2g}" for k, v in bars.items()))
    print(f'the f32 Jacobian column by column: port {ours["jacobian_columns"]:.3e}, '
          f'JAX {theirs["jacobian_columns"]:.3e}', flush=True)
    from prysm_tpu_torch.x import raytracing as trt
    tol = {}
    for name, design in (('f64', ref64), ('f32', ref32)):
        focus = trt.Perturbation.normal(design.system, 'thickness', steps.DESIGN_FOCUS_ROW,
                                        steps.DESIGN_SIGMAS['focus'], name='focus')
        with design.configured():
            tol[name] = tolerance_quantities(trt, design.system, design.perturbations(), focus,
                                             rings)
    print('f32 tolerancing errors against f64 (printed; phase 3o tolerances in f64): port '
          + ', '.join(f'{k} {v:.3e}' for k, v in tolerance_errors(tol['f32'], tol['f64']).items())
          + '; JAX ' + ', '.join(f'{k} {v:.3e}' for k, v in
                                 tolerance_errors(qj['tolerance'], tol['f64']).items()),
          flush=True)

    jax.config.update('jax_enable_x64', True)
    floor = jax_diffraction64(rings, npupil, npix, res.x, q64)
    print('f64 diffraction, the JAX package against the port (CPU): OPD '
          f'{floor["opd64"]:.3e} um, PSFs by field ' + ', '.join(f'{e:.3e}' for e in floor['psf'])
          + f', focus of the same samples {floor["focus64"]:.3e}, Jones {floor["jones64"]:.3e}',
          flush=True)
    floor['psf64'] = max(floor['psf'][1:])
    print('f64 card-vs-CPU bars (rounded up): ' + ', '.join(
        f"'{k}': {bar_for(k, floor[k], SUGGESTED64, 10):.2g}" for k in SUGGESTED64), flush=True)


if __name__ == '__main__':
    main(*(int(a) for a in sys.argv[1:]))
