"""The port's encircled energy, OTF adjoints and analytic helpers against the JAX package's.

Same numpy PSFs through both packages on the CPU in float64.  Bars: 1e-9
relative on the encircled energy (both paths: the rfft2 half plane for
even real PSFs, the full-plane MTF for odd ones and ``return_more``) and
on the adjoints, which are also held to torch autograd; 1e-12 on the
elementwise analytic helpers, which evaluate the same rational forms;
the A&S ``_j1`` and ``_j0`` against scipy at their documented 1e-7
absolute accuracy.  The JAX package's encircled energies and adjoints are
read from their records (``_jax_refs``) where they are current.
"""
import numpy as np
import pytest
import scipy.special
import torch

import jax
import jax.numpy as jnp

from _jax_refs import jax_ref
from prysm_tpu import otf as jotf
from prysm_tpu import mathops as jmath

from prysm_tpu_torch import mathops, otf

torch.set_num_threads(2)


def _psf(shape, seed):
    """A smooth positive PSF-like array: a bright core on a noisy floor."""
    rng = np.random.default_rng(seed)
    ny, nx = shape[-2:]
    y, x = np.meshgrid(np.arange(ny) - ny // 2, np.arange(nx) - nx // 2, indexing='ij')
    return np.exp(-(x ** 2 + y ** 2) / 6.0) + 0.05 * rng.random(shape)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


# (shape, dx, radius): even square and even non-square (the rfft path, where
# the y-derived frequency step is used on both axes, as in the JAX package),
# odd (the full plane), several radii, a batch
EE_CASES = {
    'even': ((32, 32), 1.5, 4.0),
    'even-rect': ((24, 40), 0.8, 3.0),
    'odd': ((31, 33), 1.2, 5.0),
    'radii': ((32, 32), 1.0, (2.0, 5.0, 9.0)),
    'batched': ((2, 16, 16), 0.9, 3.0),
}


@pytest.mark.parametrize('case', EE_CASES)
def test_encircled_energy_matches_jax(case):
    shape, dx, radius = EE_CASES[case]
    p = _psf(shape, 1)
    out = otf.encircled_energy(torch.from_numpy(p), dx, radius)
    want = jax_ref('ee', lambda p, dx, radius: jotf.encircled_energy(jnp.asarray(p), dx, radius),
                   p, dx, radius, bar=1e-9)
    assert _rel(out.numpy(), want) < 1e-9


def test_encircled_energy_return_more_takes_the_full_plane():
    p = _psf((32, 32), 2)
    (out, data), (jout, jdata) = (otf.encircled_energy(torch.from_numpy(p), 1.5, 4.0, True),
                                  jotf.encircled_energy(jnp.asarray(p), 1.5, 4.0, True))
    assert _rel(out.numpy(), jout) < 1e-9
    assert _rel(data.numpy(), jdata) < 1e-12
    # the two paths compute one integral
    assert _rel(otf.encircled_energy(torch.from_numpy(p), 1.5, 4.0).numpy(), jout) < 1e-9


def test_encircled_energy_weights_are_built_once():
    otf._encircled_energy_rfft_weights.cache_clear()
    p = torch.from_numpy(_psf((32, 32), 3))
    for _ in range(3):
        otf.encircled_energy(p, 1.5, 4.0)
    info = otf._encircled_energy_rfft_weights.cache_info()
    assert (info.misses, info.hits) == (1, 2)


def _jax_ee_adjoint(bars, p, radii):
    """The JAX package's adjoint of the encircled energy at ``radii``, and jax.grad of it."""
    jadj = jotf.encircled_energy_adjoint(bars, jnp.asarray(p), 1.1, radii)
    jgrad = jax.grad(lambda q: jnp.vdot(jnp.asarray(bars),
                                        jotf.encircled_energy(q, 1.1, radii)))(jnp.asarray(p))
    return jadj, jgrad


@pytest.mark.parametrize('shape', [(32, 32), (31, 33)], ids=['even', 'odd'])
def test_encircled_energy_adjoint_matches_jax_and_autograd(shape):
    p = _psf(shape, 4)
    radii, bars = (3.0, 6.0), (0.7, -1.3)
    adj = otf.encircled_energy_adjoint(bars, torch.from_numpy(p), 1.1, radii).numpy()
    jadj, jgrad = jax_ref('ee-adjoint', _jax_ee_adjoint, bars, p, radii, bar=1e-9)
    assert _rel(adj, jadj) < 1e-9
    x = torch.from_numpy(p).requires_grad_(True)
    ee = otf.encircled_energy(x, 1.1, radii)
    grad, = torch.autograd.grad(ee, x, torch.tensor(bars, dtype=torch.float64))
    assert _rel(grad.numpy(), adj) < 1e-9
    assert _rel(grad.numpy(), jgrad) < 1e-9


def test_encircled_energy_adjoint_from_transform_data():
    p = _psf((32, 32), 5)
    data, _ = otf.transform_psf(torch.from_numpy(p), 1.1)
    adj = otf.encircled_energy_adjoint(0.5, dx=1.1, radius=4.0, data=data)
    jdata, _ = jotf.transform_psf(jnp.asarray(p), 1.1)
    jadj = jotf.encircled_energy_adjoint(0.5, dx=1.1, radius=4.0, data=jdata)
    assert _rel(adj.numpy(), jadj) < 1e-9
    with pytest.raises(ValueError, match='dx'):
        otf.encircled_energy_adjoint(0.5, radius=4.0, data=data)


@pytest.mark.parametrize('which', ['mtf', 'ptf', 'otf'])
@pytest.mark.parametrize('shape', [(16, 16), (15, 17)], ids=['even', 'odd'])
def test_transfer_function_adjoints_match_jax_and_autograd(which, shape):
    p = _psf(shape, 6)
    rng = np.random.default_rng(7)
    bar = rng.standard_normal(shape)
    if which == 'otf':
        bar = bar + 1j * rng.standard_normal(shape)
    adjoint = getattr(otf, f'{which}_from_psf_adjoint')
    adj = adjoint(torch.from_numpy(bar), torch.from_numpy(p), 1.0).numpy()
    jadj = getattr(jotf, f'{which}_from_psf_adjoint')(jnp.asarray(bar), jnp.asarray(p), 1.0)
    assert _rel(adj, jadj) < 1e-9
    x = torch.from_numpy(p).requires_grad_(True)
    # the complex path of mtf_from_psf (return_more) differentiates like the adjoint
    out = getattr(otf, f'{which}_from_psf')(x, 1.0, return_more=True)[0].data
    grad, = torch.autograd.grad(out, x, torch.from_numpy(bar))
    assert _rel(grad.numpy(), adj) < 1e-9


def test_mtf_ptf_otf_from_psf_matches_jax():
    p = _psf((24, 24), 8)
    *mine, data = otf.mtf_ptf_otf_from_psf(torch.from_numpy(p), 1.3, return_more=True)
    *theirs, jdata = jotf.mtf_ptf_otf_from_psf(jnp.asarray(p), 1.3, return_more=True)
    for m, t in zip(mine, theirs):
        diff = m.data.numpy() - np.asarray(t.data)
        if m is mine[1]:  # the PTF: a negative real value may sit on either side of the wrap
            diff = np.angle(np.exp(1j * diff))
        assert np.abs(diff).max() < 1e-12
        assert m.dx == t.dx
    assert _rel(data.numpy(), jdata) < 1e-12


def test_j1_and_j0_match_jax_and_scipy():
    x = np.concatenate([np.linspace(-30, 30, 1201), [0.0, 7.999999, 8.0, 8.000001, 1e3]])
    j1 = mathops._j1(torch.from_numpy(x)).numpy()
    j0 = otf._j0(torch.from_numpy(x)).numpy()
    assert np.abs(j1 - np.asarray(jmath._j1(jnp.asarray(x)))).max() < 1e-12
    assert np.abs(j0 - np.asarray(jotf._j0(jnp.asarray(x)))).max() < 1e-12
    assert np.abs(j1 - scipy.special.j1(x)).max() < 1e-7
    assert np.abs(j0 - scipy.special.j0(x)).max() < 1e-7


def test_jinc_cexp_and_scalar_helpers_match_jax():
    r = np.concatenate([np.linspace(-12, 12, 241), [0.0, 1e-9]])
    assert np.abs(mathops.jinc(torch.from_numpy(r)).numpy()
                  - np.asarray(jmath.jinc(jnp.asarray(r)))).max() < 1e-12
    assert float(mathops.jinc(torch.tensor(0.0, dtype=torch.float64))) == 0.5
    z = np.random.default_rng(9).standard_normal(16) * (1 + 1j)
    assert _rel(mathops.cexp(torch.from_numpy(z)).numpy(), jmath.cexp(jnp.asarray(z))) < 1e-14
    assert _rel(mathops.cexp(torch.from_numpy(z.real)).numpy(), np.exp(z.real)) < 1e-14
    a, b = np.random.default_rng(10).standard_normal((2, 5, 3))
    assert _rel(mathops.row_dot(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                jmath.row_dot(jnp.asarray(a), jnp.asarray(b))) < 1e-14
    for n in range(1, 5):
        for m in range(2, 7):
            assert mathops.gamma(n, m) == jmath.gamma(n, m)
    assert [mathops.is_power_of_2(v) for v in range(0, 70)] == \
           [jmath.is_power_of_2(v) for v in range(0, 70)]


def test_analytic_helpers_match_jax():
    pts = np.linspace(0.0, 30.0, 61)
    ee = otf.analytical_encircled_energy_circular_aperture(10.0, 0.5, torch.from_numpy(pts))
    jee = jotf.analytical_encircled_energy_circular_aperture(10.0, 0.5, jnp.asarray(pts))
    assert np.abs(ee.numpy() - np.asarray(jee)).max() < 1e-12
    f, m = otf.diffraction_limited_mtf(4.0, 0.55, samples=64, dtype=torch.float64, device='cpu')
    jf, jm = jotf.diffraction_limited_mtf(4.0, 0.55, samples=64)
    assert _rel(f.numpy(), jf) < 1e-12 and np.abs(m.numpy() - np.asarray(jm)).max() < 1e-12
    freqs = np.linspace(-500, 500, 41)
    assert np.abs(otf.diffraction_limited_mtf(4.0, 0.55, torch.from_numpy(freqs)).numpy()
                  - np.asarray(jotf.diffraction_limited_mtf(4.0, 0.55, jnp.asarray(freqs)))
                  ).max() < 1e-12
    nu = np.linspace(0, 200, 21)
    args = (1e-14, 1e4, 500.0, 0.55)
    assert _rel(otf.longexposure_otf(torch.from_numpy(nu), *args).numpy(),
                jotf.longexposure_otf(jnp.asarray(nu), *args)) < 1e-12
    assert otf.komogorov(0.3, 0.1) == pytest.approx(float(jotf.komogorov(0.3, 0.1)), rel=1e-15)
    assert otf.estimate_Cn() == pytest.approx(float(jotf.estimate_Cn()), rel=1e-15)
