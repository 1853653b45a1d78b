"""Pins of the port's faults against the JAX package, each fixed: the same inputs, the same answer.

With ``jax_enable_x64`` on and ``config.precision = 64`` (CPU), the port
must give the JAX package's float64 results where it used to round to
float32, and take the inputs the JAX package takes:

1. list coefficients of the fused Zernike sum keep the grids' dtype;
2. Python numbers and lists take ``config.precision`` (``mathops``, ``otf``,
   ``psf``);
3. ``cart_to_polar`` / ``polar_to_cart`` take Python numbers;
4. ``Wavefront.from_amp_and_phase`` takes a scalar amplitude;
5. ``sum_of_2d_modes`` and its adjoint take a list of mode arrays;
6. ``conf.set_matmul_precision`` exists and maps onto the TF32 switch,
   and the MDFT's TF32 scope restores the setting it found;
7. (found beside them) ``mathops.cis`` takes Python numbers and numpy arrays;
9. needle synthesis takes the shallowest of the depths that only thicken a
   layer of the candidate's own medium (P is flat there but for rounding),
   so it grows the JAX package's design and not a rounding's choice.
10. ``propagation.dft`` re-exports ``MDFT``, ``CZT``, ``FFTDFT`` and
   ``fftrange`` from ``fttools``, as the JAX package's module does.
12. a thin-film ``Stack`` with no layers (a bare interface, as
   ``x/raytracing/field`` builds for an uncoated metal or dielectric surface)
   evaluates: ``stack_rt`` gives the Fresnel coefficients, as in the JAX
   package, where it raised an IndexError.
13. the paraxial pupil-z tangents (``_diff_raytrace.paraxial_exit_pupil_z_tangents``,
   which the forward-mode wavefront of the design operands and the wavefront
   differential call) run in float32: under ``torch.func.jvp`` a Python float
   combined with a 0-d float32 tensor gives a float64 tangent, and the ABCD
   matrices stacked from them raised a dtype error; they are float32 tangents
   within float32 rounding of the float64 ones.
14-17. the port's custom autograd Functions take ``torch.func``'s transforms
   where the JAX package's counterparts take JAX's: the ``'high'`` MDFT
   plan (14), the fused Zernike sum (15), the thin-film suffix products
   (16) and the collectives ``psum``, ``enter`` and ``all_to_all`` (17).
   They were written without ``setup_context``, which every transform
   refuses; ``x/optym``'s problems then fell back to finite differences.
   Bars 1e-10 relative (f64): the transforms and autograd evaluate the
   same operations, the JAX package's only float64 rounding apart.  The
   JAX side's transforms run under ``jax.jit`` (eager JAX compiles each
   operation on its own, which takes seconds here).
"""
import datetime
import os
import queue
import traceback

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prysm_tpu import coordinates as jcoords
from prysm_tpu import fttools as jft
from prysm_tpu import mathops as jmath
from prysm_tpu import otf as jotf
from prysm_tpu import psf as jpsf
from prysm_tpu.polynomials import zernike as jzern
from prysm_tpu.polynomials import fitting as jfit
from prysm_tpu.propagation import Wavefront as JWavefront

from prysm_tpu.x import coatings as jcoat

from prysm_tpu_torch import coordinates, mathops, otf, psf
from prysm_tpu_torch.conf import config
from prysm_tpu_torch.polynomials import zernike, fitting
from prysm_tpu_torch.propagation import Wavefront
from prysm_tpu_torch.x import coatings as tcoat
from prysm_tpu_torch.x.coatings import needle as tneedle

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def f64_on_cpu(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _rel(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _grid8():
    x, y = np.meshgrid(np.linspace(-1, 0.75, 8), np.linspace(-0.9, 0.85, 8))
    return x, y


def test_fault1_zernike_sum_list_coefficients_keep_float64():
    nms = [(2, 0), (3, 1), (4, -2)]
    coefs = [0.1, 1e-3, 123.456789]
    x, y = _grid8()
    got = zernike.zernike_sum(coefs, nms, torch.from_numpy(x), torch.from_numpy(y))
    want = jzern.zernike_sum(coefs, nms, jnp.asarray(x), jnp.asarray(y))
    assert got.dtype == torch.float64
    assert _rel(got, want) <= 1e-13
    # a tensor that requires grad keeps its graph
    c = torch.tensor(coefs, dtype=torch.float64, requires_grad=True)
    zernike.zernike_sum(c, nms, torch.from_numpy(x), torch.from_numpy(y)).sum().backward()
    assert c.grad is not None and bool(torch.isfinite(c.grad).all())


def test_fault2_python_numbers_take_config_precision():
    assert _rel(psf.airydisk(1.0, 8, 0.55), jpsf.airydisk(1.0, 8, 0.55)) <= 1e-13
    assert _rel(otf.diffraction_limited_mtf(8, 0.55, [10., 100.]),
                jotf.diffraction_limited_mtf(8, 0.55, [10., 100.])) <= 1e-13
    for v in (0.3, 2.5, 11.0):
        assert _rel(mathops.jinc(v), jmath.jinc(v)) <= 1e-13
        assert _rel(mathops._j1(v), jmath._j1(v)) <= 1e-13
        assert _rel(otf._j0(v), jotf._j0(v)) <= 1e-13
        assert _rel(mathops.cexp(v), jmath.cexp(v)) <= 1e-13
    assert _rel(mathops.cexp(0.2 + 1.3j), jmath.cexp(0.2 + 1.3j)) <= 1e-13
    assert _rel(otf.analytical_encircled_energy_circular_aperture(10.0, 0.5, 6.0),
                jotf.analytical_encircled_energy_circular_aperture(10.0, 0.5, 6.0)) <= 1e-13
    args = (50.0, 1e-9, 10.0, 500.0, 0.55)
    assert _rel(otf.longexposure_otf(*args), jotf.longexposure_otf(*args)) <= 1e-13
    assert psf.airydisk(1.0, 8, 0.55).dtype == torch.float64


def test_fault3_polar_conversions_take_python_numbers():
    got, want = coordinates.cart_to_polar(1.0, -2.0), jcoords.cart_to_polar(1.0, -2.0)
    assert all(_rel(g, w) <= 1e-15 for g, w in zip(got, want))
    got, want = coordinates.polar_to_cart(2.0, 0.5), jcoords.polar_to_cart(2.0, 0.5)
    assert all(_rel(g, w) <= 1e-15 for g, w in zip(got, want))
    r = torch.linspace(0, 1, 5, dtype=torch.float64)
    got, want = coordinates.polar_to_cart(r, 0.5), jcoords.polar_to_cart(jnp.asarray(r.numpy()), 0.5)
    assert all(_rel(g, w) <= 1e-15 for g, w in zip(got, want))


def test_fault4_wavefront_takes_a_scalar_amplitude():
    phase = np.random.default_rng(0).normal(scale=50.0, size=(6, 7))
    got = Wavefront.from_amp_and_phase(0.5, torch.from_numpy(phase), 0.55, 0.1)
    want = JWavefront.from_amp_and_phase(0.5, jnp.asarray(phase), 0.55, 0.1)
    assert got.data.dtype == torch.complex128
    assert _rel(got.data, want.data) <= 1e-13


def test_fault5_mode_sums_take_a_list_of_modes():
    rng = np.random.default_rng(1)
    modes, w, bar = rng.normal(size=(3, 5, 6)), rng.normal(size=3), rng.normal(size=(5, 6))
    listed = [torch.from_numpy(m) for m in modes]
    assert _rel(fitting.sum_of_2d_modes(listed, torch.from_numpy(w)),
                jfit.sum_of_2d_modes(list(modes), w)) <= 1e-13
    assert _rel(fitting.sum_of_2d_modes_adjoint(listed, torch.from_numpy(bar)),
                jfit.sum_of_2d_modes_adjoint(list(modes), jnp.asarray(bar))) <= 1e-13


def test_fault6_set_matmul_precision_maps_onto_tf32():
    from prysm_tpu_torch.conf import set_matmul_precision
    from prysm_tpu_torch.fttools import _tf32_matmuls
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        for mode, flag in (('highest', False), ('high', True), ('default', True)):
            set_matmul_precision(mode)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
        with pytest.raises(ValueError):
            set_matmul_precision('bf16')
        # the MDFT's TF32 scope restores what it found, either way
        for mode, flag in (('highest', False), ('high', True)):
            set_matmul_precision(mode)
            with _tf32_matmuls():
                assert torch.backends.cuda.matmul.allow_tf32 is True
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert 'not bf16' in set_matmul_precision.__doc__


def test_fault7_cis_takes_python_numbers_and_numpy():
    assert _rel(mathops.cis(0.3), jmath.cis(0.3)) <= 1e-15
    theta = np.linspace(-3, 3, 7)
    got = mathops.cis(theta)
    assert got.dtype == torch.complex128
    assert _rel(got, jmath.cis(theta)) <= 1e-15


def test_fault9_needle_takes_the_shallowest_depth_of_a_thickening():
    """The second round of ``test_synthesize_matches_jax[two]``: a 1.38 needle
    anywhere in the 1.38 layer at 0.196-0.207 um thickens it, so z[34] and
    z[35] tie but for rounding; the parent took z[35] by one ulp where the JAX
    package's rounding takes z[34], and the two syntheses parted there."""
    n = [1.38, 2.05, 1.38, 2.05]
    d = [0.09463160570770332, 0.10143196172733025, 0.010502237069625319,
         0.02341294293364351]
    z = np.linspace(0.0, sum(d), 40)

    def merit(m):
        return m.MeritFunction([m.Reflectance(np.linspace(0.45, 0.65, 7), pol='s',
                                              target=0.0)])

    P = tcoat.needle_function(tcoat.Stack(n, d, 1.52), merit(tcoat), 1.38, z).numpy()
    Pj = np.asarray(jcoat.needle_function(jcoat.Stack(n, d, 1.52), merit(jcoat), 1.38,
                                          jnp.asarray(z)))
    assert np.abs(P - Pj).max() <= 1e-12 * np.abs(Pj).max()
    assert abs(P[35] - P[34]) <= 1e-14 * abs(P[34]) and abs(Pj[35] - Pj[34]) <= 1e-14 * abs(Pj[34])
    best = tneedle._best_insertion(tcoat.Stack(n, d, 1.52), merit(tcoat), [1.38, 2.05], z)
    assert (best[1], best[2]) == (1.38, float(z[34]))
    assert best[0] == pytest.approx(float(Pj.min()), rel=1e-12)


@pytest.mark.parametrize('name', ['MDFT', 'CZT', 'FFTDFT', 'fftrange'])
def test_fault10_dft_reexports_the_fttools_names(name):
    """``from ...propagation.dft import MDFT`` works in both packages, and the
    port's name is its ``fttools`` object itself."""
    import importlib
    jdft = importlib.import_module('prysm_tpu.propagation.dft')
    tdft = importlib.import_module('prysm_tpu_torch.propagation.dft')
    tft = importlib.import_module('prysm_tpu_torch.fttools')
    assert getattr(jdft, name) is getattr(importlib.import_module('prysm_tpu.fttools'), name)
    assert getattr(tdft, name) is getattr(tft, name)


@pytest.mark.parametrize('substrate', [1.5, 0.96 + 6.7j])
@pytest.mark.parametrize('pol', ['s', 'p'])
def test_fault12_a_stack_without_layers_is_a_bare_interface(substrate, pol):
    theta = np.linspace(0.0, 1.3, 9)
    r, tr = tcoat.stack_rt(tcoat.Stack([], [], substrate_index=substrate), 0.55, theta, pol)
    jr, jt = jcoat.stack_rt(jcoat.Stack([], [], substrate_index=substrate), 0.55,
                            jnp.asarray(theta), pol)
    assert _rel(r, np.asarray(jr)) <= 1e-14 and _rel(tr, np.asarray(jt)) <= 1e-14
    rs, _ = tcoat.stack_rt(tcoat.Stack([], [], substrate_index=substrate), 0.55, 0.0, 's')
    assert abs(complex(rs) - (1 - substrate) / (1 + substrate)) <= 1e-15


@pytest.mark.parametrize('which, stop', [('exit', 1), ('entrance', 3)])
def test_fault13_paraxial_pupil_tangents_run_in_float32(monkeypatch, which, stop):
    from prysm_tpu_torch import steps
    from prysm_tpu_torch.x.raytracing import _diff_raytrace as dr
    from prysm_tpu_torch.x.raytracing.adjoint.seeds import seed_curvature, seed_despace
    fn = getattr(dr, f'paraxial_{which}_pupil_z_tangents')
    seeds = ([seed_curvature(j) for j in steps.LENS_SPHERES]
             + [seed_despace(moved) for moved in steps.LENS_THICKNESSES])
    out = {}
    for dtype in (torch.float64, torch.float32):
        monkeypatch.setattr(config, '_precision', dtype)
        surfaces = steps.cfg6_system().to_surfaces()
        out[dtype] = fn(surfaces, steps.WVL, seeds, stop_index=stop)
    f64, f32 = out[torch.float64], out[torch.float32]
    assert f32.dtype == np.float32 and np.abs(f64).max() > 0
    assert np.abs(f32 - f64).max() <= 1e-4 * np.abs(f64).max()


# ---------------------------------------------------------------------------
# faults 14-17: the custom autograd Functions under torch.func
# ---------------------------------------------------------------------------

BAR = 1e-10


def _close(got, want, what=''):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= BAR, (what, err)


def _high_plans():
    """The JAX package's MDFT plan at 'high' (10 x 9 -> 7 x 8), and the port's
    built by ``interop`` from its leaves."""
    from prysm_tpu_torch import interop
    x, y = np.linspace(-1.0, 0.8, 9), np.linspace(-0.9, 1.0, 10)
    fx, fy = np.linspace(-2.5, 3.0, 8), np.linspace(-3.0, 2.0, 7)
    jplan = jft.plan_mdft(x, y, fx, fy, dtype=jnp.complex128, matmul_precision='high')
    leaves = (np.asarray(jplan.Ex_re), np.asarray(jplan.Ex_im), np.asarray(jplan.Ey_re),
              np.asarray(jplan.Ey_im))
    tplan = interop.mdft_from_numpy(*leaves, jplan.norm, jplan.forward_left_first,
                                    jplan.adjoint_left_first, matmul_precision='high',
                                    device='cpu')
    return jplan, tplan


def _plan_inputs():
    rng = np.random.default_rng(14)
    amp, phase = rng.uniform(0.5, 1.0, (10, 9)), rng.normal(size=(10, 9))
    weights, mask = rng.uniform(size=(7, 8)), rng.normal(size=(7, 8)) + 1j * rng.normal(size=(7, 8))
    return amp, phase, weights, mask


def _plan_losses(jplan, tplan):
    """loss(phase): the forward plan, then the adjoint of a masked field, on both sides."""
    amp, _, weights, mask = _plan_inputs()

    def tfield(p):
        return tplan(torch.complex(torch.from_numpy(amp) * torch.cos(p),
                                   torch.from_numpy(amp) * torch.sin(p)))

    def jfield(p):
        return jplan(amp * jnp.cos(p) + 1j * (amp * jnp.sin(p)))

    def tloss(p):
        F = tfield(p)
        B = tplan.adjoint(F * torch.from_numpy(mask))
        return torch.sum(torch.from_numpy(weights) * F.abs() ** 2) + torch.sum(B.abs() ** 2)

    def jloss(p):
        F = jfield(p)
        B = jplan.adjoint(F * mask)
        return jnp.sum(weights * jnp.abs(F) ** 2) + jnp.sum(jnp.abs(B) ** 2)

    def tint(p):
        return tfield(p).abs() ** 2

    def jint(p):
        return jnp.abs(jfield(p)) ** 2

    return tloss, jloss, tint, jint


def test_fault14_high_plan_takes_grad_jacfwd_vmap_and_jvp():
    jplan, tplan = _high_plans()
    tloss, jloss, tint, jint = _plan_losses(jplan, tplan)
    _, phase, _, _ = _plan_inputs()
    p = torch.from_numpy(phase)
    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(phase)))
    _close(torch.func.grad(tloss)(p), want, 'grad vs jax.grad')
    pa = p.clone().requires_grad_(True)
    _close(torch.autograd.grad(tloss(pa), pa)[0], want, 'autograd vs jax.grad')
    want = np.asarray(jax.jit(jax.jacfwd(jint))(jnp.asarray(phase)))
    _close(torch.func.jacfwd(tint)(p), want, 'jacfwd vs jax.jacfwd')
    _close(torch.autograd.functional.jacobian(tint, p), want, 'autograd jacobian vs jax.jacfwd')
    batch = np.random.default_rng(15).normal(size=(3, 10, 9))
    want = np.asarray(jax.jit(jax.vmap(jint))(jnp.asarray(batch)))
    _close(torch.func.vmap(tint)(torch.from_numpy(batch)), want, 'vmap vs jax.vmap')
    _close(torch.stack([tint(b) for b in torch.from_numpy(batch)]), want, 'loop vs jax.vmap')
    # the plan is linear: its tangent is the plan applied to the tangent, both ways
    tangent = torch.from_numpy(batch[0]).to(torch.complex128)
    for apply in (tplan, tplan.adjoint):
        x = tangent if apply is tplan else tplan(tangent)
        value, dvalue = torch.func.jvp(apply, (x,), (2 * x,))
        _close(dvalue, 2 * apply(x).numpy(), 'jvp of the plan')


def test_fault14_the_tf32_switch_is_restored_when_a_transform_raises():
    """``_tf32_matmuls`` flips a process-wide switch: a transform through the
    plan leaves it as it found it, also when the plan raises inside the scope."""
    _, tplan = _high_plans()
    fields = torch.from_numpy(np.random.default_rng(14).normal(size=(3, 10, 9))).to(torch.complex128)
    wrong = fields.transpose(-1, -2)  # rows and columns swapped
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            torch.func.vmap(tplan)(fields)
            torch.func.jvp(tplan, (fields[0],), (fields[1],))
            assert torch.backends.cuda.matmul.allow_tf32 is flag
            with pytest.raises(RuntimeError, match='shape|size'):
                torch.func.vmap(tplan)(wrong)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
            with pytest.raises(RuntimeError, match='shape|size'):
                torch.func.jvp(tplan, (wrong[0],), (wrong[1],))
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


NMS15 = [(2, 0), (2, 2), (3, -1), (4, 0), (5, 3)]


def _zernike_inputs(n=12):
    rng = np.random.default_rng(15)
    x, y = np.meshgrid(np.linspace(-1.0, 0.95, n), np.linspace(-0.9, 1.0, n))
    return rng.normal(size=len(NMS15)), x, y, rng.normal(size=(n, n)), rng.normal(size=(4, len(NMS15)))


def _tzern(grads):
    from prysm_tpu_torch.ops.zernike import zernike_sum_pallas

    def opd(c, x, y):
        return zernike_sum_pallas(c, NMS15, torch.hypot(x, y), torch.atan2(y, x), grads=grads)
    return opd


def _jzern(c, x, y):
    return jzern.zernike_sum(c, NMS15, x, y)


@pytest.mark.parametrize('grads', ['all', 'coefs'])
def test_fault15_zernike_sum_takes_grad(grads):
    c, x, y, W, _ = _zernike_inputs()
    opd = _tzern(grads)
    args = tuple(torch.from_numpy(a) for a in (c, x, y))

    def tloss(c, x, y):
        return torch.sum((opd(c, x, y) * torch.from_numpy(W)) ** 2)

    def jloss(c, x, y):
        return jnp.sum((_jzern(c, x, y) * W) ** 2)

    got = torch.func.grad(tloss, argnums=(0, 1, 2))(*args)
    leaves = tuple(a.clone().requires_grad_(True) for a in args)
    auto = torch.autograd.grad(tloss(*leaves), leaves)
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*(jnp.asarray(a) for a in (c, x, y)))
    for k in range(3):
        assert torch.equal(got[k], auto[k]), k
    _close(got[0], want[0], 'coefficient gradient vs jax.grad')
    if grads == 'all':
        _close(got[1], want[1], 'x gradient vs jax.grad')
        _close(got[2], want[2], 'y gradient vs jax.grad')
    else:  # the grids are declared constant
        assert not got[1].any() and not got[2].any()


@pytest.mark.parametrize('grads', ['all', 'coefs'])
def test_fault15_zernike_sum_takes_vmap(grads):
    from prysm_tpu_torch.ops.zernike import LAUNCHES
    _, x, y, _, batch = _zernike_inputs()
    opd = _tzern(grads)
    X, Y = torch.from_numpy(x), torch.from_numpy(y)
    before = dict(LAUNCHES)
    got = torch.func.vmap(lambda c: opd(c, X, Y))(torch.from_numpy(batch))
    assert LAUNCHES == before  # CPU tensors: the plain version, no launch
    want = jax.jit(jax.vmap(lambda c: _jzern(c, x, y)))(jnp.asarray(batch))
    _close(got, want, 'vmap vs jax.vmap')
    assert torch.equal(got, torch.stack([opd(c, X, Y) for c in torch.from_numpy(batch)]))
    # a batched gradient: vmap of grad runs the backward once per item
    W = torch.from_numpy(_zernike_inputs()[3])
    vg = torch.func.vmap(torch.func.grad(lambda c: torch.sum((opd(c, X, Y) * W) ** 2)))(
        torch.from_numpy(batch))
    wg = jax.jit(jax.vmap(jax.grad(lambda c: jnp.sum((_jzern(c, x, y) * W.numpy()) ** 2))))(
        jnp.asarray(batch))
    _close(vg, wg, 'vmap of grad vs jax.vmap of jax.grad')


@pytest.mark.parametrize('grads', ['all', 'coefs'])
def test_fault15_zernike_sum_takes_jacfwd_on_cpu_tensors(grads):
    c, x, y, _, _ = _zernike_inputs(8)
    opd = _tzern(grads)
    args = tuple(torch.from_numpy(a) for a in (c, x, y))
    jargs = tuple(jnp.asarray(a) for a in (c, x, y))
    got = torch.func.jacfwd(opd, argnums=(0, 1, 2))(*args)
    auto = torch.autograd.functional.jacobian(opd, args)
    want = jax.jit(jax.jacfwd(_jzern, argnums=(0, 1, 2)))(*jargs)
    _close(got[0], want[0], 'coefficient jacfwd vs jax.jacfwd')
    _close(auto[0], want[0], 'coefficient autograd jacobian vs jax.jacfwd')
    if grads == 'all':
        for k in (1, 2):
            _close(got[k], want[k], f'grid {k} jacfwd vs jax.jacfwd')
            _close(auto[k], want[k], f'grid {k} autograd jacobian vs jax.jacfwd')
    else:  # grads='coefs' declares the grids constant, in forward mode as in reverse
        assert not got[1].any() and not got[2].any()
        assert not auto[1].any() and not auto[2].any()


def test_fault15_zernike_sum_has_no_second_derivative():
    """The backward is once differentiable, as the JAX package's ``custom_vjp``
    is: ``torch.func.hessian`` raises (as ``jax.hessian`` through it does)."""
    c, x, y, W, _ = _zernike_inputs(8)
    opd = _tzern('all')
    X, Y = torch.from_numpy(x), torch.from_numpy(y)
    with pytest.raises(NotImplementedError):
        torch.func.hessian(lambda c: torch.sum(opd(c, X, Y) ** 2))(torch.from_numpy(c))


def test_fault15_as_problem_takes_torch_func_gradient_of_zernike_sum(monkeypatch):
    """The scalar adapter's ``fg`` and ``Problem.g`` return torch.func's gradient
    of a 64^2 ``zernike_sum`` objective; the finite differences are never reached."""
    from prysm_tpu_torch.polynomials.zernike import zernike_sum
    from prysm_tpu_torch.x.optym import problem as tproblem

    def no_fd(self, x):
        raise AssertionError('finite differences reached')
    monkeypatch.setattr(tproblem.Problem, '_finite_difference_g', no_fd)
    rng = np.random.default_rng(16)
    x, y = np.meshgrid(np.linspace(-1, 1, 64), np.linspace(-1, 1, 64))
    c0, target = rng.normal(size=len(NMS15)), rng.normal(size=(64, 64))
    X, Y, T = (torch.from_numpy(a) for a in (x, y, target))

    def f(c):
        return torch.sum((zernike_sum(c, NMS15, X, Y) - T) ** 2)

    want = jax.jit(jax.grad(lambda c: jnp.sum((jzern.zernike_sum(c, NMS15, x, y) - target) ** 2)))(
        jnp.asarray(c0))
    prob = tproblem.as_problem(f, scalar=True)
    value, grad = prob.fg(torch.from_numpy(c0))
    assert torch.is_tensor(grad)
    _close(grad, want, 'fg gradient vs jax.grad')
    assert float(value) == pytest.approx(float(f(torch.from_numpy(c0))), rel=1e-14)
    _close(prob.g(torch.from_numpy(c0)), want, 'g vs jax.grad')


def _coating_inputs():
    n = [1.38, 2.05 + 0.01j, 1.46]
    d = np.array([0.0996, 0.0671, 0.0942])
    theta = np.linspace(0.0, 0.7, 5)
    return n, d, theta


def _coating_fns(mod, asarray, d_of):
    n, _, theta = _coating_inputs()

    def rt(d):
        out = []
        for pol in ('s', 'p'):
            r, t = mod.stack_rt(mod.Stack(n, d_of(d), 1.52), 0.55, asarray(theta), pol)
            out += [r.real, r.imag, t.real, t.imag]
        return out

    return rt


def test_fault16_stack_rt_takes_grad_jacfwd_and_vmap():
    _, d, _ = _coating_inputs()
    trt = _coating_fns(tcoat, torch.from_numpy, lambda d: d)
    jrt = _coating_fns(jcoat, jnp.asarray, lambda d: d)

    def tstack(d):
        return torch.stack(trt(d))

    def jstack(d):
        return jnp.stack(jrt(d))

    def tmerit(d):
        return torch.sum(tstack(d) ** 2)

    def jmerit(d):
        return jnp.sum(jstack(d) ** 2)

    D, JD = torch.from_numpy(d), jnp.asarray(d)
    want = np.asarray(jax.jit(jax.grad(jmerit))(JD))
    _close(torch.func.grad(tmerit)(D), want, 'grad vs jax.grad')
    leaf = D.clone().requires_grad_(True)
    _close(torch.autograd.grad(tmerit(leaf), leaf)[0], want, 'autograd vs jax.grad')
    want = np.asarray(jax.jit(jax.jacfwd(jstack))(JD))
    _close(torch.func.jacfwd(tstack)(D), want, 'jacfwd vs jax.jacfwd')
    _close(torch.autograd.functional.jacobian(tstack, D), want, 'autograd jacobian vs jax.jacfwd')
    batch = np.stack([d, d * 1.07, d[::-1].copy()])
    want = np.asarray(jax.jit(jax.vmap(jstack))(jnp.asarray(batch)))
    _close(torch.func.vmap(tstack)(torch.from_numpy(batch)), want, 'vmap vs jax.vmap')


def test_fault16_backward_products_take_jvp():
    """The suffix products' tangent (the product rule through the doubling)
    against autograd's Jacobian-vector product, on random complex matrices."""
    from prysm_tpu_torch.x.coatings.stack import backward_products
    rng = np.random.default_rng(16)
    mats, dmats = (torch.from_numpy(rng.normal(size=(5, 3, 2, 2)) + 1j * rng.normal(size=(5, 3, 2, 2)))
                   for _ in range(2))

    def products(m):
        return torch.stack(backward_products(m)[:-1])  # the identity closes the list

    _, got = torch.func.jvp(products, (mats,), (dmats,))
    _, want = torch.autograd.functional.jvp(products, mats, dmats)
    _close(got, want.numpy(), 'jvp vs autograd')


# fault 17 runs on two gloo ranks of the CPU, as tests/test_torch_parallel.py
# spawns them; the serial loss is the same numpy inputs through both packages
N17, W17, FN17, Q17 = 16, 4, 8, 2
COEFS17 = (5.0, -3.0, 2.0)
SPAWN_TIMEOUT = 180


def _inputs17():
    dx = 2.2 / N17
    x = (np.arange(N17) - N17 // 2) * dx
    X, Y = np.meshgrid(x, x)
    r, t = np.hypot(X, Y), np.arctan2(Y, X)
    amp = np.clip(0.5 - (r - 1.0) / dx, 0.0, 1.0)
    modes = np.stack([2 * r * r - 1, r * r * np.cos(2 * t), (3 * r ** 3 - 2 * r) * np.cos(t)])
    rng = np.random.default_rng(17)
    return {'dx': dx, 'amp': amp, 'modes': modes, 'wavelengths': np.linspace(0.5, 0.6, W17),
            'weights': np.full(W17, 1.0 / W17), 'coefs': np.asarray(COEFS17),
            'tangent': np.array([1.0, 0.5, -0.2]), 'batch': np.array([COEFS17, [4.0, -2.5, 1.5]]),
            'E': rng.normal(size=(2, N17, N17)), 'E_tangent': rng.normal(size=(N17, N17))}


def _fault17_rank(rank, world, rendezvous, results):
    """One gloo rank: torch.func through psum / enter (the sharded broadband loss)
    and all_to_all (the distributed focus), and their collectives counted."""
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        dist.init_process_group('gloo', init_method=f'file://{rendezvous}', rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=60))
        from prysm_tpu_torch import parallel as par
        from prysm_tpu_torch.parallel import _collectives
        from prysm_tpu_torch.parallel.fft import plan_distributed_focus
        from prysm_tpu_torch.parallel.sharding import _local_plan, broadband_psf
        from prysm_tpu_torch.propagation.fft import focus
        config.device, config.precision = 'cpu', torch.float64
        inp = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in _inputs17().items()}
        calls = {'all_reduce': 0, 'all_to_all_single': 0}
        for name in calls:
            def counted(*a, _name=name, _fn=getattr(dist, name), **k):
                calls[_name] += 1
                return _fn(*a, **k)
            setattr(_collectives.dist, name, counted)

        def counting(fn, *args):
            for name in calls:
                calls[name] = 0
            out = fn(*args)
            return out, dict(calls)

        plan = par.plan_mdft_spectral(inp['dx'], (N17, N17), 0.4, FN17,
                                      _inputs17()['wavelengths'], 10.0)
        args = (inp['amp'], inp['modes'], inp['wavelengths'], inp['weights'])
        I_meas = broadband_psf(inp['coefs'] * 0.5, *args, plan)
        # the JAX package's local_loss of shard_broadband_step, wavelengths over 'wl'
        mesh = par.make_mesh({'wl': world, 'ty': 1})
        local = _local_plan(plan, mesh, 'wl', 'ty')
        wl_local, w_local = (_collectives.shard(inp[k], mesh, 'wl', 0)
                             for k in ('wavelengths', 'weights'))

        def loss(c):
            I_partial = broadband_psf(_collectives.enter(c, mesh, ('wl', 'ty')), *args[:2],
                                      wl_local, w_local, local)
            resid = _collectives.psum(I_partial, mesh, 'wl') - I_meas
            return _collectives.psum(torch.sum(resid * resid), mesh, 'ty')

        def serial(c):
            return torch.sum((broadband_psf(c, *args, plan) - I_meas) ** 2)

        c0 = inp['coefs']
        leaf = c0.clone().requires_grad_(True)
        out = {'grad': torch.func.grad(loss)(c0), 'autograd': torch.autograd.grad(loss(leaf), leaf)[0],
               'serial_grad': torch.func.grad(serial)(c0),
               'jvp': torch.func.jvp(loss, (c0,), (inp['tangent'],))[1],
               'serial_jvp': torch.func.jvp(serial, (c0,), (inp['tangent'],))[1],
               'serial_batch': torch.stack([serial(c) for c in inp['batch']])}
        _, out['calls'] = counting(loss, c0)
        out['vmap'], out['vmap_calls'] = counting(torch.func.vmap(loss), inp['batch'])

        # all_to_all: a loss through the distributed focus, rows over 'fy'
        fmesh = par.make_mesh({'fy': world})
        apply = plan_distributed_focus(fmesh, (N17, N17), Q17, dtype=np.float64)

        def focus_loss(re):
            F = apply(torch.complex(re, inp['E'][1]))
            return _collectives.psum(torch.sum((F.real ** 2 + F.imag ** 2) ** 2), fmesh, 'fy')

        def focus_serial(re):
            F = focus(torch.complex(re, inp['E'][1]), Q17)
            return torch.sum((F.real ** 2 + F.imag ** 2) ** 2)

        re = inp['E'][0]
        leaf = re.clone().requires_grad_(True)
        out.update({
            'focus_grad': torch.func.grad(focus_loss)(re),
            'focus_autograd': torch.autograd.grad(focus_loss(leaf), leaf)[0],
            'focus_serial_grad': torch.func.grad(focus_serial)(re),
            'focus_jvp': torch.func.jvp(focus_loss, (re,), (inp['E_tangent'],))[1],
            'focus_serial_jvp': torch.func.jvp(focus_serial, (re,), (inp['E_tangent'],))[1],
            'focus_serial_batch': torch.stack([focus_serial(re), focus_serial(inp['E_tangent'])])})
        _, out['focus_calls'] = counting(focus_loss, re)
        out['focus_vmap'], out['focus_vmap_calls'] = counting(
            torch.func.vmap(focus_loss), torch.stack([re, inp['E_tangent']]))
        results.put((rank, 'ok', {k: v.numpy() if torch.is_tensor(v) else v
                                  for k, v in out.items()}))
    except BaseException:  # every failure goes back to the parent, which re-raises it
        results.put((rank, 'error', traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn17(world, tmp):
    ctx = torch.multiprocessing.get_context('spawn')
    results = ctx.Queue()
    procs = [ctx.Process(target=_fault17_rank,
                         args=(r, world, os.path.join(tmp, 'rendezvous'), results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in range(world):
            rank, status, payload = results.get(timeout=SPAWN_TIMEOUT)
            if status != 'ok':
                errors.append(f'rank {rank}:\n{payload}')
                break
            got[rank] = payload
    except queue.Empty:
        errors.append(f'no result within {SPAWN_TIMEOUT} s')
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if errors:
        raise RuntimeError('\n'.join(errors))
    return got


def test_fault17_collectives_take_grad_jvp_and_vmap(tmp_path):
    """At 2 ranks: torch.func.grad and jvp of the sharded broadband loss
    (``enter`` and ``psum``) and of a loss through the distributed focus
    (``all_to_all``) equal autograd's and the serial loss's on every rank;
    the serial broadband gradient equals ``jax.grad`` of the JAX package's
    serial loss; ``vmap`` over two inputs runs the collectives of one call."""
    from prysm_tpu.parallel.broadband import plan_mdft_spectral as jplan_spectral
    from prysm_tpu.parallel.sharding import broadband_psf as jbroadband_psf
    got = _spawn17(2, str(tmp_path))
    inp = _inputs17()
    jplan = jplan_spectral(inp['dx'], (N17, N17), 0.4, FN17, inp['wavelengths'], 10.0)
    jargs = tuple(jnp.asarray(inp[k]) for k in ('amp', 'modes', 'wavelengths', 'weights'))
    I_meas = jbroadband_psf(jnp.asarray(inp['coefs']) * 0.5, *jargs, jplan)
    want = jax.jit(jax.grad(lambda c: jnp.sum((jbroadband_psf(c, *jargs, jplan) - I_meas) ** 2)))(
        jnp.asarray(inp['coefs']))
    for rank, out in got.items():
        _close(out['serial_grad'], want, f'rank {rank}: serial gradient vs jax.grad')
        for prefix in ('', 'focus_'):
            for key in ('grad', 'autograd'):
                _close(out[prefix + key], out[prefix + 'serial_grad'], f'rank {rank} {prefix}{key}')
            _close(out[prefix + 'jvp'], out[prefix + 'serial_jvp'], f'rank {rank} {prefix}jvp')
            _close(out[prefix + 'vmap'], out[prefix + 'serial_batch'], f'rank {rank} {prefix}vmap')
        # one collective per call, whatever the batch: psum twice (the wavelength
        # and the tile axes), the focus's two transposes and its psum
        assert out['calls'] == out['vmap_calls'] == {'all_reduce': 2, 'all_to_all_single': 0}
        assert out['focus_calls'] == out['focus_vmap_calls'] == {'all_reduce': 1,
                                                                 'all_to_all_single': 2}
