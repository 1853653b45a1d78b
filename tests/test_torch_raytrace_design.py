"""The port's ``x/raytracing/design`` against the JAX package's, in float64 on the CPU.

The lens is the designer's path's (``steps.cfg6_design_system``: bench.py's cfg6 with
a neutral coordinate break before the rear sphere), built in both packages, with the
three curvatures and two glass thicknesses free, on ``Sampling.hex(4)`` bundles.
Operand values, residual vectors, the ``'auto'`` residual Jacobian (reverse mode for
the spots, forward mode for the wavefront) and the merits' adjoint seeds agree within
1e-10 of each quantity's largest magnitude; the first damped-least-squares iterates
within 1e-9.  Central differences check the ``'auto'`` Jacobian within 1e-6 of each
column's largest entry: Richardson-extrapolated from the DLS's step (``FD_STEP``, 1e-6
scaled by max(1, |x|)) and twice it, since at that step alone the curvature columns'
truncation is 5e-6, and at a tenth of it the wavefront row's rounding (its OPD is a
difference of 100 mm paths) is 3e-6 of the thickness columns.
"""
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

torch.set_num_threads(2)
WVL = steps.WVL
RINGS = 4
BAR, ITERATE_BAR, FD_BAR, FD_STEP = 1e-10, 1e-9, 1e-6, 1e-6
ITERATES = 3


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


PACKAGES = {'jax': (jrt, jmat, jlensdata), 'torch': (trt, tmat, tlensdata)}


def design_system(pkg, stop=True):
    """steps.cfg6_design_system through either package; without its stop, if asked."""
    rt, mat, lensdata = PACKAGES[pkg]
    lens = rt.LensData()
    media = [mat.model_glass(nd, vd, name=name) for nd, vd, name in steps.CFG6_GLASSES]
    for c, t, m in zip(steps.CFG6_CURVATURES, steps.CFG6_THICKNESSES, media + [mat.air]):
        lens.add(rt.Sphere(c), thickness=t, material=m)
    system = rt.OpticalSystem(lens, aperture=rt.ApertureSpec.epd(steps.CFG6_EPD),
                              fields=list(steps.CFG6_FIELDS), wavelengths=[WVL],
                              stop_index=steps.CFG6_STOP if stop else None)
    system.lens.rows.insert(steps.DESIGN_DECENTRE_ROW, lensdata.CoordBreak())
    return system


def systems(stop=True):
    pair = {pkg: (PACKAGES[pkg][0], design_system(pkg, stop)) for pkg in PACKAGES}
    for _, system in pair.values():
        system.opt.vary('curvature', steps.DESIGN_CURVATURE_ROWS)
        system.opt.vary('thickness', steps.DESIGN_THICKNESS_ROWS)
    return pair


def design_operands(rt, system):
    """The designer's operands (steps._LensDesign.problem) on hex(RINGS) bundles."""
    sampling = rt.Sampling.hex(RINGS)
    fields = [system.field(k) for k in range(len(system.fields))]
    return ([rt.RmsSpotRadius(f, WVL, sampling) for f in fields]
            + [rt.WavefrontRMS(fields[-1], WVL, sampling)])


def design_problem(rt, system, gradient='auto'):
    efl = float(rt.effective_focal_length(system.to_surfaces(), wvl=WVL))
    return rt.Problem(system, design_operands(rt, system), constraints=[rt.EFL(WVL, target=efl)],
                      gradient=gradient)


@pytest.fixture(scope='module')
def start():
    """Both packages' residuals and 'auto' Jacobians at the start, and the port's FD."""
    saved = config._precision, config._device
    config._precision, config._device = torch.float64, 'cpu'
    try:
        out = {}
        for name, (rt, system) in systems().items():
            prob = design_problem(rt, system)
            x = prob.x0()
            r, cache = prob.residuals(x, return_cache=True)
            out[name] = {'x': x, 'r': r, 'J': prob.residual_jacobian(x),
                         'n_traces': cache.n_traces, 'eq': prob.equalities(x)}
            if name == 'torch':
                fd = [np.zeros_like(out[name]['J']) for _ in range(2)]
                for k, h in enumerate((FD_STEP, 2 * FD_STEP)):
                    prob._fd_fill(fd[k], list(range(len(prob.operands))), x, h)
                out[name]['fd'] = (4 * fd[0] - fd[1]) / 3
        return out
    finally:
        config._precision, config._device = saved


def test_free_vectors_match(start):
    np.testing.assert_array_equal(start['torch']['x'], start['jax']['x'])


def test_the_design_system_is_the_steps_one():
    """steps.cfg6_design_system compiles to the surfaces this file builds, and traces
    as cfg6 (the coordinate break is neutral)."""
    built, ours, cfg6 = (steps.cfg6_design_system(), design_system('torch'),
                         steps.cfg6_system())
    P, S = trt.launch(cfg6, cfg6.field(2), WVL, trt.Sampling.hex(RINGS))
    landed = [trt.raytrace(s.to_surfaces(), P, S, WVL).P[-1].numpy()
              for s in (built, ours, cfg6)]
    np.testing.assert_array_equal(landed[0], landed[1])
    np.testing.assert_allclose(landed[0], landed[2], rtol=0, atol=1e-12)
    assert isinstance(built.rows[steps.DESIGN_DECENTRE_ROW], tlensdata.CoordBreak)


def test_residuals_match(start):
    assert _rel(start['torch']['r'], start['jax']['r']) <= BAR
    np.testing.assert_allclose(start['torch']['eq'], start['jax']['eq'], atol=1e-12)


@pytest.mark.parametrize('row', range(4))
def test_auto_jacobian_rows_match(start, row):
    """Rows 0-2: reverse mode, one pass per spot head; row 3: forward mode (wavefront)."""
    assert _rel(start['torch']['J'][row], start['jax']['J'][row]) <= BAR


def test_auto_jacobian_matches_central_differences(start):
    J, fd = start['torch']['J'], start['torch']['fd']
    scale = np.abs(J).max(axis=0)
    assert float((np.abs(J - fd) / scale).max()) <= FD_BAR


def test_one_trace_per_bundle(start):
    """Four operands on three launch bundles: the trace cache traces three times."""
    assert start['torch']['n_traces'] == start['jax']['n_traces'] == 3


OPERANDS = {
    'spot-axis': lambda rt, s, smp: rt.RmsSpotRadius(s.field(0), WVL, smp),
    'spot-edge': lambda rt, s, smp: rt.RmsSpotRadius(s.field(2), WVL, smp),
    'ray-height': lambda rt, s, smp: rt.RayHeightAt(s.field(1), WVL, smp, surface_index=3,
                                                    axis=1, ray_index=5),
    'boresight': lambda rt, s, smp: rt.Boresight(s.field(2), WVL, smp, target_xy=(0.0, 3.0)),
    'efl': lambda rt, s, smp: rt.EFL(WVL),
    'bfl': lambda rt, s, smp: rt.BFL(WVL),
    'image-distance': lambda rt, s, smp: rt.ParaxialImageDistance(WVL),
    'total-track': lambda rt, s, smp: rt.TotalTrack(),
    'thickness': lambda rt, s, smp: rt.Thickness(2),
    'wavefront-chief': lambda rt, s, smp: rt.WavefrontRMS(s.field(2), WVL, smp),
    'wavefront-piston': lambda rt, s, smp: rt.WavefrontRMS(s.field(1), WVL, smp,
                                                           reference='piston'),
    'wavefront-fixed-xp': lambda rt, s, smp: rt.WavefrontRMS(s.field(2), WVL, smp,
                                                             P_xp=(0.0, 0.0, 20.0)),
    'zernike': lambda rt, s, smp: rt.ZernikeCoefficient(
        s.field(2), WVL, smp, n=2, m=0, nms_basis=[(1, 1), (1, -1), (2, 0), (2, 2)]),
    'distortion': lambda rt, s, smp: rt.Distortion(s.field(2), WVL, epd=steps.CFG6_EPD),
    'field-curvature': lambda rt, s, smp: rt.FieldCurvature(s.field(2), WVL),
}


@pytest.mark.parametrize('name', OPERANDS)
def test_operand_values_match(name):
    values = {}
    for pkg, (rt, system) in systems().items():
        op = OPERANDS[name](rt, system, rt.Sampling.hex(RINGS))
        values[pkg] = op(system, rt.design._TraceCache(system))
    assert abs(values['torch'] - values['jax']) <= BAR * max(abs(values['jax']), 1e-300)


SEEDED = {
    'spot': (True, lambda rt, s, smp: rt.RmsSpotRadius(s.field(2), WVL, smp)),
    'boresight': (True, lambda rt, s, smp: rt.Boresight(s.field(2), WVL, smp,
                                                        target_xy=(0.0, 3.0))),
    'wavefront-paraxial-xp': (True, lambda rt, s, smp: rt.WavefrontRMS(s.field(2), WVL, smp)),
    'wavefront-piston': (True, lambda rt, s, smp: rt.WavefrontRMS(s.field(1), WVL, smp,
                                                                  reference='piston')),
    'wavefront-fixed-xp': (True, lambda rt, s, smp: rt.WavefrontRMS(
        s.field(2), WVL, smp, P_xp=(0.0, 0.0, 20.0))),
    # no stop: the exit pupil is the chief ray's closest approach to the axis, live
    'wavefront-geometric-xp': (False, lambda rt, s, smp: rt.WavefrontRMS(s.field(2), WVL, smp)),
}


@pytest.mark.parametrize('name', SEEDED)
def test_adjoint_seeds_and_values_match(name):
    stop, make = SEEDED[name]
    out = {}
    pair = systems(stop)
    jsys = pair['jax'][1]
    P, S = (np.asarray(a) for a in jrt.launch(jsys, jsys.field(1 if 'piston' in name else 2),
                                              WVL, jrt.Sampling.hex(RINGS)))
    for pkg, (rt, system) in pair.items():
        op = make(rt, system, rt.Sampling.hex(RINGS))
        trace = rt.raytrace(system.to_surfaces(), P, S, WVL)
        out[pkg] = (op.seed(trace, system, WVL), op.value(trace, system, WVL))
        assert op.seedable and op.has_value
    for a, b in zip(out['torch'][0], out['jax'][0]):
        assert _rel(a, b) <= BAR
    assert abs(out['torch'][1] - out['jax'][1]) <= BAR * abs(out['jax'][1])


@pytest.fixture(scope='module')
def iterates():
    """The designer's DLS (steps.DESIGN_SOLVE) for ITERATES iterations in both packages."""
    saved = config._precision, config._device
    config._precision, config._device = torch.float64, 'cpu'
    try:
        out = {}
        for name, (rt, system) in systems().items():
            prob = design_problem(rt, system)
            merit0 = prob.merit(prob.x0())
            res = prob.solve(**{**steps.DESIGN_SOLVE, 'maxiter': ITERATES})
            efl = float(rt.effective_focal_length(system.to_surfaces(), wvl=WVL))
            out[name] = (res, efl, prob.equality_constraints[0].target, merit0,
                         prob.merit(prob.x0()))
        return out
    finally:
        config._precision, config._device = saved


@pytest.mark.parametrize('k', range(ITERATES))
def test_dls_iterates_match(iterates, k):
    (rt_res, *_), (jx_res, *_) = iterates['torch'], iterates['jax']
    assert len(rt_res.history) == len(jx_res.history) == ITERATES
    a, b = rt_res.history[k], jx_res.history[k]
    assert _rel(a['x'], b['x']) <= ITERATE_BAR
    assert abs(a['cost'] - b['cost']) <= ITERATE_BAR * abs(b['cost'])


def test_dls_holds_the_efl_and_lowers_the_merit(iterates):
    """The EFL equality holds to 1e-9 in both packages; the working set of inequalities is
    empty in both (the port's active-set QP returns the set it solved with, which only
    differs from the JAX package's when inequality rounds run out), and the equality
    multipliers agree."""
    res, efl, target, merit0, merit = iterates['torch']
    jres, jefl, jtarget, jmerit0, jmerit = iterates['jax']
    assert abs(efl - target) <= 1e-9 * abs(target) and abs(jefl - jtarget) <= 1e-9 * abs(jtarget)
    assert merit < merit0 and abs(merit - jmerit) <= ITERATE_BAR * jmerit
    assert res.active_inequalities.size == jres.active_inequalities.size == 0
    assert _rel(res.lambda_eq, jres.lambda_eq) <= 1e-6


def test_dls_with_an_active_inequality_matches():
    """A BFL floor that the spot merit pushes against: both packages' active-set QPs
    take the same steps."""
    out = {}
    for name, (rt, system) in systems().items():
        bfl = float(rt.back_focal_length(system.to_surfaces(), wvl=WVL))
        prob = rt.Problem(system, design_operands(rt, system)[:1],
                          constraints=[rt.BFL(WVL, min=bfl - 1e-3)], gradient='auto')
        res = prob.solve(**{**steps.DESIGN_SOLVE, 'maxiter': 2})
        out[name] = (res, prob.inequalities(res.x))
    assert _rel(out['torch'][0].x, out['jax'][0].x) <= ITERATE_BAR
    np.testing.assert_allclose(out['torch'][1], out['jax'][1], atol=1e-9)


GOALS = {
    'spot': 'spot',
    'wavefront': 'wavefront',
    'spot+efl': lambda rt: ['spot', rt.EFL(WVL, target=100.0)],
    'classes': lambda rt: [rt.RmsSpotRadius, rt.TotalTrack, rt.BFL],
}


@pytest.mark.parametrize('goal', GOALS)
def test_build_problem_fans_out_alike(goal):
    out = {}
    for name, (rt, system) in systems().items():
        g = GOALS[goal]
        prob = system.opt.problem(g(rt) if callable(g) else g, sampling=rt.Sampling.hex(3))
        out[name] = ([type(op).__name__ for op in prob.operands],
                     [op.weight for op in prob.operands], prob.residuals(prob.x0()))
    assert out['torch'][:2] == out['jax'][:2]
    assert _rel(out['torch'][2], out['jax'][2]) <= BAR


def test_constraint_routing_matches():
    out = {}
    for name, (rt, system) in systems().items():
        prob = rt.Problem(system, design_operands(rt, system)[:1], constraints=[
            rt.BFL(WVL, min=80.0), rt.TotalTrack(max=120.0), rt.Thickness(1, min=5.0, max=7.0),
            rt.EFL(WVL, target=100.0)])
        out[name] = (prob.inequalities(prob.x0()), prob.equalities(prob.x0()),
                     [(type(op).__name__, kind, b) for op, kind, b in prob.inequality_constraints])
    np.testing.assert_allclose(out['torch'][0], out['jax'][0], rtol=1e-12)
    np.testing.assert_allclose(out['torch'][1], out['jax'][1], rtol=1e-12)
    assert out['torch'][2] == out['jax'][2]
    with pytest.raises(ValueError, match='mixes target'):
        trt.Problem(design_system('torch'), [],
                    constraints=[trt.BFL(WVL, target=1.0, min=0.0)])


def test_optimize_verb_matches():
    """system.opt.optimize runs and lands where the JAX package's does."""
    out = {}
    for name, (rt, system) in systems().items():
        out[name] = system.opt.optimize('spot', sampling=rt.Sampling.hex(3), fields=[0, 2],
                                        **{**steps.DESIGN_SOLVE, 'maxiter': 2})
    assert _rel(out['torch'].x, out['jax'].x) <= ITERATE_BAR
    assert abs(out['torch'].cost - out['jax'].cost) <= ITERATE_BAR * out['jax'].cost


def test_problem_rejects_what_the_jax_package_rejects():
    system = design_system('torch')
    with pytest.raises(TypeError, match='not an OpticalSystem'):
        trt.Problem(system.lens, [])
    with pytest.raises(ValueError, match='gradient mode'):
        trt.Problem(system, [], gradient='exact')
    with pytest.raises(ValueError, match='not a known goal'):
        trt.build_problem(system, 'strehl')
    assert trt.Problem(system, [], gradient='fd').residual_jacobian(system.opt.pack()) is None
