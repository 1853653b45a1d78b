"""The port's ``tolerance`` and ``wavefront_differential`` against the JAX package's.

Float64 on the CPU, on the designer's lens (``steps.cfg6_design_system``) and its six
tolerances (``steps.DESIGN_SIGMAS``: three curvatures, two glass thicknesses and the
rear sphere's y decentre), through the ``system.tol`` verbs: the sensitivity table
and a seeded Monte Carlo of the edge field's RMS spot radius on a fixed
``Sampling.hex(4)`` bundle, and the same bundle's wavefront differential with the
image gap as the focus compensator (forward-mode tangents), its quadratic, roll-ups
and fast Monte Carlo, all within 1e-10 of each quantity's largest magnitude.  (The
on-axis bundle's compensated OPD is 1.6e-5 mm at most, and the closing's rounding,
about 1e-14 mm on 100 mm paths, is 6e-10 of that: the edge field's 1e-3 mm keeps
the comparison above the rounding.)  The
draws come from ``np.random.default_rng`` on the host in both packages, so one seed
gives the same samples, compared exactly.  The finite-difference wavefront
differential (``method='fd'``) divides differences of 100 mm optical paths by its
1e-6 step, so the two packages' agree within 1e-7 of its largest entry, and the
tangents agree with it within its truncation.
"""
import importlib

import numpy as np
import pytest
import torch

import prysm_tpu.x.materials as jmat
import prysm_tpu.x.raytracing as jrt
from prysm_tpu.x.raytracing import lensdata as jlensdata

import prysm_tpu_torch.x.materials as tmat
import prysm_tpu_torch.x.raytracing as trt
from prysm_tpu_torch import steps
from prysm_tpu_torch.conf import config
from prysm_tpu_torch.x.raytracing import lensdata as tlensdata

# both packages export a function named like the module
jwd = importlib.import_module('prysm_tpu.x.raytracing.wavefront_differential')
twd = importlib.import_module('prysm_tpu_torch.x.raytracing.wavefront_differential')

torch.set_num_threads(2)
WVL = steps.WVL
RINGS, TRIALS, FAST_TRIALS = 4, 8, steps.DESIGN_FAST_MC_TRIALS
BAR, FD_PARITY_BAR = 1e-10, 1e-7
PACKAGES = {'jax': (jrt, jmat, jlensdata), 'torch': (trt, tmat, tlensdata)}


@pytest.fixture(autouse=True)
def f64_on_cpu(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    scale = np.nanmax(np.abs(b)) if b.size else 0.0
    return float(np.nanmax(np.abs(a - b)) / (scale if scale > 0 else 1.0)) if b.size else 0.0


def design_system(pkg):
    """steps.cfg6_design_system through either package."""
    rt, mat, lensdata = PACKAGES[pkg]
    lens = rt.LensData()
    media = [mat.model_glass(nd, vd, name=name) for nd, vd, name in steps.CFG6_GLASSES]
    for c, t, m in zip(steps.CFG6_CURVATURES, steps.CFG6_THICKNESSES, media + [mat.air]):
        lens.add(rt.Sphere(c), thickness=t, material=m)
    system = rt.OpticalSystem(lens, aperture=rt.ApertureSpec.epd(steps.CFG6_EPD),
                              fields=list(steps.CFG6_FIELDS), wavelengths=[WVL],
                              stop_index=steps.CFG6_STOP)
    system.lens.rows.insert(steps.DESIGN_DECENTRE_ROW, lensdata.CoordBreak())
    return system


def perturbations(rt, system, kind='normal', scale=1.0):
    """steps._LensDesign.perturbations through either package (``kind`` picks the
    distribution, ``scale`` multiplies the widths)."""
    s = {k: v * scale for k, v in steps.DESIGN_SIGMAS.items()}
    make = getattr(rt.Perturbation, kind)
    return ([make(system, 'curvature', r, s['curvature'], name=f'c{r}')
             for r in steps.DESIGN_CURVATURE_ROWS]
            + [make(system, 'thickness', r, s['thickness'], name=f't{r}')
               for r in steps.DESIGN_THICKNESS_ROWS]
            + [make(system, 'decenter', steps.DESIGN_DECENTRE_ROW, s['decenter'], name='dy',
                    component=1)])


def focus(rt, system):
    return rt.Perturbation.normal(system, 'thickness', steps.DESIGN_FOCUS_ROW,
                                  steps.DESIGN_SIGMAS['focus'], name='focus')


def bundle(system, field):
    """A host launch (the JAX package's) shared by both packages."""
    return tuple(np.asarray(a) for a in jrt.launch(system, system.field(field), WVL,
                                                   jrt.Sampling.hex(RINGS)))


def spot_merit(rt, P, S):
    operand = rt.RmsSpotRadius()
    return lambda system: operand.value(system.trace(P, S, WVL), system, WVL)


@pytest.fixture(scope='module')
def runs():
    """Each package's table, Monte Carlo and wavefront differentials on the same bundles."""
    saved = config._precision, config._device
    config._precision, config._device = torch.float64, 'cpu'
    try:
        jsys = design_system('jax')
        P2, S2 = bundle(jsys, 2)
        P0, S0 = P2, S2
        out = {}
        for pkg in PACKAGES:
            rt = PACKAGES[pkg][0]
            system = design_system(pkg)
            perts = perturbations(rt, system)
            merit = spot_merit(rt, P2, S2)
            wd = system.tol.wavefront(perts, P0, S0, WVL, compensators=[focus(rt, system)])
            out[pkg] = {
                'perts': perts,
                'table': system.tol.sensitivity(perts, merit),
                'mc': system.tol.monte_carlo(perts, merit, TRIALS, seed=steps.DESIGN_MC_SEED,
                                             record_samples=True),
                'wd': wd,
                'fast': wd.fast_monte_carlo(perts, FAST_TRIALS, seed=steps.DESIGN_FAST_MC_SEED,
                                            record_samples=True),
                'wd_fd': system.tol.wavefront(perts, P0, S0, WVL, method='fd'),
                'wd_piston': system.tol.wavefront(perts[:3], P0, S0, WVL,
                                                  rms_reference='piston'),
            }
            if pkg == 'torch':
                from prysm_tpu_torch.x.raytracing.adjoint import RmsSpotHead
                out[pkg]['adjoint'] = system.tol.adjoint_sensitivity(
                    perts, [RmsSpotHead()], P2, S2).jacobian[0]
                out[pkg]['wd_tangent'] = system.tol.wavefront(perts, P0, S0, WVL)
                out[pkg]['half_table'] = system.tol.sensitivity(
                    perturbations(rt, system, scale=0.5), merit)
        return out
    finally:
        config._precision, config._device = saved


PERTURBATION_KINDS = ('normal', 'normal_relative', 'uniform', 'triangular')


@pytest.mark.parametrize('kind', PERTURBATION_KINDS)
def test_perturbations_resolve_alike(kind):
    got = {}
    for pkg in PACKAGES:
        rt = PACKAGES[pkg][0]
        perts = perturbations(rt, design_system(pkg), kind, 1e-2 if kind == 'normal_relative'
                              else 1.0)
        got[pkg] = [(p.name, p.slot, p.nominal, p.step, p.variance, p.distribution)
                    for p in perts]
    assert got['torch'] == got['jax']


@pytest.mark.parametrize('kind', PERTURBATION_KINDS)
def test_perturbation_draws_are_the_jax_packages(kind):
    draws = {}
    for pkg in PACKAGES:
        rt = PACKAGES[pkg][0]
        rng = np.random.default_rng(7)
        perts = perturbations(rt, design_system(pkg), kind)
        draws[pkg] = [p.sample(rng) for _ in range(5) for p in perts]
    assert draws['torch'] == draws['jax']


def test_perturbation_set_and_reset_edit_the_lens():
    system = design_system('torch')
    p = perturbations(trt, system)[-1]
    p.set(0.25)
    assert tuple(system.rows[steps.DESIGN_DECENTRE_ROW].decenter)[1] == 0.25
    p.reset()
    assert tuple(system.rows[steps.DESIGN_DECENTRE_ROW].decenter)[1] == 0.0
    with pytest.raises(ValueError, match='component'):
        trt.Perturbation.normal(system, 'decenter', steps.DESIGN_DECENTRE_ROW, 0.1)


TABLE_KEYS = ('nominal', 'step', 'merit_nominal', 'merit_plus', 'merit_minus', 'delta_plus',
              'delta_minus', 'sensitivity')


@pytest.mark.parametrize('key', TABLE_KEYS)
def test_sensitivity_table_matches(runs, key):
    t, j = runs['torch']['table'], runs['jax']['table']
    assert t.names() == j.names()
    assert _rel([r[key] for r in t.rows], [r[key] for r in j.rows]) <= BAR


def test_sensitivity_table_reports_alike(runs):
    t, j = runs['torch']['table'], runs['jax']['table']
    assert repr(t) == repr(j)
    assert _rel(t.worst_delta_per_row(), j.worst_delta_per_row()) <= BAR


def test_sensitivity_table_agrees_with_the_adjoint(runs):
    """The table's central differences (h = one sigma) against the exact reverse-mode
    sensitivities over the same seeds: within the differences' truncation, estimated
    per perturbation from a second table at half the steps (4/3 of the two's gap, to
    1.5x), and the half-step table closer to them."""
    fd = runs['torch']['table'].sensitivities()
    half = runs['torch']['half_table'].sensitivities()
    exact = runs['torch']['adjoint']
    floor = 1e-9 * np.abs(exact).max()
    truncation = 4 / 3 * np.abs(fd - half)
    assert np.all(np.abs(fd - exact) <= 1.5 * truncation + floor)
    assert np.all(np.abs(half - exact) <= np.abs(fd - exact) + floor)


def test_monte_carlo_matches(runs):
    t, j = runs['torch']['mc'], runs['jax']['mc']
    np.testing.assert_array_equal(t.sampled_x, j.sampled_x)
    assert _rel(t.merits, j.merits) <= BAR
    assert t.names == j.names and t.n_trials == TRIALS
    np.testing.assert_array_equal(t.nominals, j.nominals)


@pytest.mark.parametrize('stat', ('min', 'max', 'mean', 'std', 'median', 'p95', 'p99'))
def test_monte_carlo_summary_matches(runs, stat):
    t, j = runs['torch']['mc'].summary(), runs['jax']['mc'].summary()
    assert abs(t[stat] - j[stat]) <= BAR * abs(j[stat])


def test_monte_carlo_restores_the_lens(runs):
    perts = runs['torch']['perts']
    assert [p.lensdata._slot_value(p.slot) for p in perts] == [p.nominal for p in perts]
    mc = runs['torch']['mc']
    assert mc.yield_at(float(np.median(mc.merits))) == runs['jax']['mc'].yield_at(
        float(np.median(runs['jax']['mc'].merits)))


WD_ARRAYS = {
    'W0': lambda wd: wd.W0,
    'dW': lambda wd: wd.dW,
    'B': lambda wd: wd.B,
    'G': lambda wd: wd.G,
    'sensitivity': lambda wd: wd.sensitivity(),
    'rms_change': lambda wd: wd.rms_change_per_tolerance(),
    'inverse_lo': lambda wd: wd.inverse_sensitivity(1e-5)[0],
    'inverse_hi': lambda wd: wd.inverse_sensitivity(1e-5)[1],
    'predict': lambda wd: wd.predict_rms(np.outer(np.linspace(-1, 1, 5), wd.steps)),
    'rms_at': lambda wd: wd.rms_at(0, np.linspace(-1e-4, 1e-4, 5)),
    'compensator_maps': lambda wd: wd.comp_maps,
    'compensator_motions': lambda wd: wd.compensator_motions(),
    'pupil': lambda wd: np.stack([wd.x_pupil, wd.y_pupil]),
    'zernike': lambda wd: np.column_stack(wd.zernike_sensitivity([(1, 1), (1, -1), (2, 0),
                                                                  (2, 2), (3, 1), (4, 0)])),
}


@pytest.mark.parametrize('name', WD_ARRAYS)
def test_wavefront_differential_matches(runs, name):
    t, j = WD_ARRAYS[name](runs['torch']['wd']), WD_ARRAYS[name](runs['jax']['wd'])
    assert _rel(t, j) <= BAR


def test_wavefront_differential_scalars_match(runs):
    t, j = runs['torch']['wd'], runs['jax']['wd']
    for a, b in ((t.C, j.C), (t.rms_nominal, j.rms_nominal), (t.expected_rms(), j.expected_rms()),
                 (t.expected_rms_sq(0.5), j.expected_rms_sq(0.5))):
        assert abs(a - b) <= BAR * abs(b)
    assert t.names == j.names and t.comp_names == j.comp_names
    assert t.sensitivity_table() == j.sensitivity_table()


def test_fast_monte_carlo_matches(runs):
    t, j = runs['torch']['fast'], runs['jax']['fast']
    np.testing.assert_array_equal(t.sampled_x, j.sampled_x)
    assert t.n_trials == FAST_TRIALS and _rel(t.merits, j.merits) <= BAR
    thresholds, prob = twd.cumulative_probability(t)
    jthresholds, jprob = jwd.cumulative_probability(j)
    assert _rel(thresholds, jthresholds) <= BAR
    np.testing.assert_array_equal(prob, jprob)


def test_piston_referenced_differential_matches(runs):
    t, j = runs['torch']['wd_piston'], runs['jax']['wd_piston']
    assert t.reference == j.reference == 'piston'
    assert _rel(t.dW, j.dW) <= BAR and abs(t.C - j.C) <= BAR * j.C


def test_finite_difference_differential_matches(runs):
    t, j = runs['torch']['wd_fd'], runs['jax']['wd_fd']
    assert _rel(t.W0, j.W0) <= BAR
    assert _rel(t.dW, j.dW) <= FD_PARITY_BAR


@pytest.mark.parametrize('column', range(6))
def test_tangents_agree_with_finite_differences(runs, column):
    """The forward-mode maps against the FD maps of the same (uncompensated) model,
    column by column: within the differences' rounding, about 1e-14 mm of path over
    their step of 2e-6 x max(1, |nominal|), which is 2e-5 of the glass-thickness and
    decentre columns' largest entries (7e-4 and 1.4e-3 mm per unit)."""
    t, fd = runs['torch']['wd_tangent'], runs['torch']['wd_fd']
    assert _rel(t.dW[:, column], fd.dW[:, column]) <= 3e-5


def test_compensation_helpers_match():
    rng = np.random.default_rng(3)
    opd, tol, comp = rng.normal(size=40), rng.normal(size=(40, 3)), rng.normal(size=(40, 2))
    for a, b in zip(twd.compensate(opd, tol, comp), jwd.compensate(opd, tol, comp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-13)
    np.testing.assert_allclose(twd.project_out(tol, comp[:, :0]), tol)


def test_fast_monte_carlo_rejects_a_mismatched_list(runs):
    with pytest.raises(ValueError, match='expected 6 perturbations'):
        runs['torch']['wd'].fast_monte_carlo(runs['torch']['perts'][:2], 10)
