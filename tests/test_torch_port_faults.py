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
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prysm_tpu import coordinates as jcoords
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
