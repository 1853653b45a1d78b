"""The lens designer's path (``steps.build_lens_design``) against the same composition
of the JAX package's functions, in float64 on the CPU at a small size.

``Sampling.hex(4)`` bundles, 2 DLS iterations, 4 Monte Carlo trials, 16^2 pupil fields
focused at ``npix`` 64: the prescription text is string-equal and reads into the same
lens; the optimised free vector within 1e-9; the sensitivity table, the Monte Carlo
merits, the wavefront differential's maps, expected RMS, compensator motions and fast
Monte Carlo within 1e-10 (the differential's nominal-wavefront terms within 1e-10 plus
the closing's rounding, 1e-13 mm on 100 mm paths, over the on-axis bundle's compensated
OPD); the PRT Jones matrices within 1e-12 and the off-axis pupil-field PSFs within
1e-10 plus twice the phase of the OPD's difference.  On axis the sine-space samples
form a symmetric grid whose Delaunay triangulation (SciPy's cubic ``griddata``) breaks
its ties by rounding: a 1e-15 relative change of the samples moves the JAX package's
own PSF by 2.1e-2 of its peak at ``npupil`` 16, so there the port's resampling and
focus are held to the JAX package's on the JAX package's own samples.  The analysis
step with ``system=`` given cfg6 reproduces ``build_lens_analysis``'s default.
The JAX package's session is read from its record (``_jax_refs``) where it is
current.
"""
import numpy as np
import pytest
import torch

from _jax_refs import jax_ref
import prysm_tpu.x.materials as jmat
import prysm_tpu.x.raytracing as jrt
from prysm_tpu.x.raytracing import lensdata as jlensdata

from prysm_tpu_torch import steps
from prysm_tpu_torch.conf import config
from prysm_tpu_torch.x.raytracing import Sampling

torch.set_num_threads(2)
WVL = steps.WVL
RINGS, ITERS, TRIALS, NPUPIL, NPIX = 4, 2, 4, 16, 64
BAR, ITERATE_BAR, JONES_BAR = 1e-10, 1e-9, 1e-12
# the closing's rounding: ~1e-15 of 100 mm paths
OPD_FLOOR = 1e-13


def jax_session():
    """steps._LensDesign's steps, composed from the JAX package's functions: the values
    the tests compare."""
    lens = jrt.LensData()
    media = [jmat.model_glass(nd, vd, name=name) for nd, vd, name in steps.CFG6_GLASSES]
    for c, t, m in zip(steps.CFG6_CURVATURES, steps.CFG6_THICKNESSES, media + [jmat.air]):
        lens.add(jrt.Sphere(c), thickness=t, material=m)
    source = jrt.OpticalSystem(lens, aperture=jrt.ApertureSpec.epd(steps.CFG6_EPD),
                               fields=list(steps.CFG6_FIELDS), wavelengths=[WVL],
                               stop_index=steps.CFG6_STOP)
    source.lens.rows.insert(steps.DESIGN_DECENTRE_ROW, jlensdata.CoordBreak())
    db = jmat.Catalog.from_materials(media)
    zmx, seq = jrt.write_zmx(source), jrt.write_seq(source)
    system = jrt.read_zmx(zmx, _is_text=True, database=db)
    from_seq = jrt.read_seq(seq, _is_text=True, database=db)
    efl = float(jrt.effective_focal_length(system.to_surfaces(), wvl=WVL))
    system.opt.vary('curvature', steps.DESIGN_CURVATURE_ROWS)
    system.opt.vary('thickness', steps.DESIGN_THICKNESS_ROWS)
    sampling = jrt.Sampling.hex(RINGS)
    fields = [system.field(k) for k in range(3)]
    prob = jrt.Problem(system, [jrt.RmsSpotRadius(f, WVL, sampling) for f in fields]
                       + [jrt.WavefrontRMS(fields[-1], WVL, sampling)],
                       constraints=[jrt.EFL(WVL, target=efl)], gradient='auto')
    res = prob.solve(**{**steps.DESIGN_SOLVE, 'maxiter': ITERS})

    def bundle(k):
        return tuple(np.asarray(a) for a in jrt.launch(system, system.field(k), WVL,
                                                       sampling))

    s = steps.DESIGN_SIGMAS
    perts = ([jrt.Perturbation.normal(system, 'curvature', r, s['curvature'], name=f'c{r}')
              for r in steps.DESIGN_CURVATURE_ROWS]
             + [jrt.Perturbation.normal(system, 'thickness', r, s['thickness'], name=f't{r}')
                for r in steps.DESIGN_THICKNESS_ROWS]
             + [jrt.Perturbation.normal(system, 'decenter', steps.DESIGN_DECENTRE_ROW,
                                        s['decenter'], name='dy', component=1)])
    P2, S2 = bundle(2)
    P0, S0 = bundle(0)
    spot = jrt.RmsSpotRadius()

    def merit(sys_):
        return spot.value(sys_.trace(P2, S2, WVL), sys_, WVL)

    focus = jrt.Perturbation.normal(system, 'thickness', steps.DESIGN_FOCUS_ROW, s['focus'],
                                    name='focus')
    table = system.tol.sensitivity(perts, merit)
    mc = system.tol.monte_carlo(perts, merit, TRIALS, seed=steps.DESIGN_MC_SEED)
    wd = system.tol.wavefront(perts, P0, S0, WVL, compensators=[focus])
    fast = wd.fast_monte_carlo(perts, steps.DESIGN_FAST_MC_TRIALS, seed=steps.DESIGN_FAST_MC_SEED)
    pfs = [jrt.pupil_field(system, system.field(k), WVL, npupil=NPUPIL) for k in range(3)]
    psfs = [jrt.pupil_field_psf(pf, npix=NPIX, Q=steps.DESIGN_Q)[0] for pf in pfs]
    prt = jrt.raytrace_prt(system, P2, S2, WVL)
    P, S = (np.asarray(a) for a in jrt.launch(from_seq, from_seq.field(2), WVL,
                                              jrt.Sampling.hex(RINGS)))
    landed = jrt.raytrace(from_seq.to_surfaces(), P, S, WVL).P[-1]
    differential = {'dW': wd.dW, 'G': wd.G, 'A': wd.A, 'comp_maps': wd.comp_maps,
                    'motions': wd.compensator_motions(), 'B': wd.B, 'W0': wd.W0,
                    'expected_rms': wd.expected_rms()}
    return {'zmx': zmx, 'seq': seq, 'read_back': (P, S, landed),
            'result': {'nit': res.nit, 'x': res.x, 'cost': float(res.cost)},
            'table': table.sensitivities(), 'mc': mc.merits, 'wd': differential,
            'fast': fast.merits, 'psfs': psfs, 'prt': prt.P_matrix,
            'pfs': [{k: getattr(pf, k) for k in jrt.PupilField.__slots__} for pf in pfs]}


# each value's bar below; the read-back landing points are held to 1e-12 mm
SESSION_BARS = dict(zmx=0.0, seq=0.0, read_back=(BAR, BAR, 1e-14), result=ITERATE_BAR,
                    table=BAR, mc=BAR, wd=BAR, fast=BAR, psfs=BAR, prt=JONES_BAR, pfs=BAR)


def torch_session():
    ld = steps.build_lens_design(Sampling.hex(RINGS), npupil=NPUPIL, npix=NPIX,
                                 dtype=torch.float64, device='cpu')
    zmx, seq, system, from_seq = ld.prescription()
    res, _ = ld.optimise(ITERS)
    tol = ld.tolerance(TRIALS)
    pfs, psfs, prt = ld.diffraction()
    return {'zmx': zmx, 'seq': seq, 'from_seq': from_seq, 'result': res, 'table': tol.table,
            'mc': tol.monte_carlo, 'wd': tol.differential, 'fast': tol.fast_monte_carlo,
            'expected_rms': tol.expected_rms, 'motions': tol.compensator_motions,
            'pfs': pfs, 'psfs': [p[0] for p in psfs], 'prt': prt, 'system': system,
            'design': ld}


@pytest.fixture(scope='module')
def sessions():
    saved = config._precision, config._device
    config._precision, config._device = torch.float64, 'cpu'
    try:
        return {'jax': jax_ref('session', jax_session, bar=SESSION_BARS),
                'torch': torch_session()}
    finally:
        config._precision, config._device = saved


@pytest.fixture(autouse=True)
def f64_on_cpu(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _rel(a, b, floor=0.0):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale), floor / scale


@pytest.mark.parametrize('fmt', ('zmx', 'seq'))
def test_prescription_text_is_the_jax_packages(sessions, fmt):
    assert sessions['torch'][fmt] == sessions['jax'][fmt]


def test_prescription_reads_back_the_lens(sessions):
    """The .zmx and .seq reads trace one bundle alike, and like the JAX package's."""
    t, j = sessions['torch'], sessions['jax']
    P, S, jl = j['read_back']
    src = steps.cfg6_design_system()
    from prysm_tpu_torch.x.raytracing import raytrace
    landed = [raytrace(s.to_surfaces(), P, S, WVL).P[-1].numpy()
              for s in (t['from_seq'], t['design'].source)]
    assert float(np.abs(landed[0] - jl).max()) <= 1e-12
    # the writers keep 6 significant digits: the read lens is cfg6 to that rounding
    assert float(np.abs(landed[0] - landed[1]).max()) <= 1e-4
    assert len(src.to_surfaces()) == len(t['system'].to_surfaces())


def test_optimised_lens_matches(sessions):
    t, j = sessions['torch']['result'], sessions['jax']['result']
    assert t.nit == j['nit'] == ITERS and _rel(t.x, j['x'])[0] <= ITERATE_BAR
    assert abs(t.cost - j['cost']) <= ITERATE_BAR * j['cost']
    assert _rel(sessions['torch']['system'].opt.pack(), j['x'])[0] <= ITERATE_BAR


def test_sensitivity_table_and_monte_carlo_match(sessions):
    t, j = sessions['torch'], sessions['jax']
    assert _rel(t['table'].sensitivities(), j['table'])[0] <= BAR
    assert t['mc'].n_trials == TRIALS
    assert _rel(t['mc'].merits, j['mc'])[0] <= BAR


@pytest.mark.parametrize('name', ('dW', 'G', 'A', 'comp_maps', 'motions', 'B', 'W0',
                                  'expected_rms', 'fast'))
def test_wavefront_differential_matches(sessions, name):
    t, j = sessions['torch']['wd'], sessions['jax']['wd']
    get = {'dW': lambda w: w.dW, 'G': lambda w: w.G, 'A': lambda w: w.A,
           'comp_maps': lambda w: w.comp_maps, 'motions': lambda w: w.compensator_motions(),
           'B': lambda w: w.B, 'W0': lambda w: w.W0, 'expected_rms': lambda w: w.expected_rms()}
    # the nominal wavefront's terms carry the closing's rounding
    floor = {'W0': OPD_FLOOR, 'B': 2 * OPD_FLOOR * np.abs(j['dW']).max(),
             'expected_rms': OPD_FLOOR, 'fast': OPD_FLOOR}.get(name, 0.0)
    if name == 'fast':
        a, b = sessions['torch']['fast'].merits, sessions['jax']['fast']
    else:
        a, b = get[name](t), j[name]
    err, slack = _rel(a, b, floor)
    assert err <= BAR + slack
    if name == 'expected_rms':
        assert sessions['torch']['expected_rms'] == a
    if name == 'motions':
        np.testing.assert_array_equal(sessions['torch']['motions'], a)


@pytest.mark.parametrize('field', range(3))
def test_pupil_fields_and_psfs_match(sessions, field):
    tpf, jpf = sessions['torch']['pfs'][field], sessions['jax']['pfs'][field]
    for name in ('X', 'Y', 'amplitude', 'opd'):
        assert _rel(getattr(tpf, name), jpf[name])[0] <= BAR
    phase = 2 * (2 * np.pi / WVL) * float(np.abs(tpf.opd - jpf['opd']).max())
    t, j = sessions['torch']['psfs'][field], sessions['jax']['psfs'][field]
    assert t.shape == (NPIX * steps.DESIGN_Q,) * 2
    if field == 0:
        from prysm_tpu_torch.x.raytracing import pupil_field_psf
        t, _ = pupil_field_psf(jrt.PupilField(**jpf), npix=NPIX, Q=steps.DESIGN_Q)
        phase = 0.0
    assert _rel(t, j)[0] <= BAR + phase


def test_prt_matches(sessions):
    t, j = sessions['torch']['prt'].P_matrix, sessions['jax']['prt']
    assert float(np.abs(t - j).max()) <= JONES_BAR


def test_analysis_step_takes_a_system():
    """build_lens_analysis(system=cfg6) is the default plan; the design's analysis step
    runs on the optimised lens (real aiming on a copy: the design's own system keeps
    paraxial aiming)."""
    default = steps.build_lens_analysis(Sampling.hex(3), N=32, fN=8, fused=False,
                                        dtype=torch.float64, device='cpu')
    given = steps.build_lens_analysis(Sampling.hex(3), N=32, fN=8, fused=False,
                                      dtype=torch.float64, device='cpu',
                                      system=steps.cfg6_system())
    np.testing.assert_array_equal(given.P, default.P)
    for a, b in zip(given(), default()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ld = steps.build_lens_design(Sampling.hex(3), dtype=torch.float64, device='cpu')
    ld.prescription()
    la, (coefs, rms, psfs, grads, values) = ld.analysis(N=32, fN=8)
    assert ld.system.ray_aiming == 'paraxial' and la.system.ray_aiming == 'real'
    assert coefs.shape == (1, 3, 36) and psfs.shape == (3, 8, 8) and grads.shape == (2, 5)
    assert bool(torch.isfinite(psfs).all()) and np.isfinite(grads).all()
