"""The port's coating stack engine, monitoring and rugate modules against the JAX package's.

Stacks of one to nine layers, lossless and absorbing, for s and p, at
normal and oblique incidence (and past the critical angle of an internal
layer), on scalar and meshed (wavelength, angle) grids: the characteristic
matrices, the forward and backward products (log-depth doublings in the
port, ``lax.associative_scan`` in the JAX package), r and t, R, T and the
per-layer absorptance, the internal fields and the field at any depth; the
deposition monitor's traces, cut strategies, simulated runs and error
sensitivity; the rugate profiles and Fourier synthesis;
``interop.stack_from_numpy``.  Inputs from seeded numpy generators,
``jax_enable_x64``, ``config.precision = 64``, CPU.  Bar: closed forms
<= 1e-12 relative (of each output's peak; of 1 for R, T, A and the fields,
fractions of the incident power and field).  The JAX package's side of the
slow comparisons is read from its record (``_jax_refs``) where it is current.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _jax_refs import jax_ref
from prysm_tpu.x import coatings as jc
from prysm_tpu.x.coatings import monitoring as jmon, rugate as jru

from prysm_tpu_torch import interop
from prysm_tpu_torch.conf import config
from prysm_tpu_torch.x import coatings as tc
from prysm_tpu_torch.x.coatings import monitoring as tmon, rugate as tru

torch.set_num_threads(2)

BAR = 1e-12
SUB = 1.52


@pytest.fixture(autouse=True)
def _cpu_f64(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _host(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, bar=BAR, floor=1e-300):
    """|a - b| <= bar x max(peak |b|, floor): R, T, A and the fields, fractions of the
    incident power and field, take floor 1 (a lossless layer's A is rounding)."""
    a, b = _host(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= bar * max(np.abs(b).max(), floor), np.abs(a - b).max()


def _design(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == 'single':
        return [1.38], [0.1]
    if name == 'quarter-wave-9':
        n = [2.3, 1.45] * 4 + [2.3]
        return n, [0.55 / (4 * v) for v in n]
    if name == 'absorbing':
        return [1.46, 2.1 + 0.02j, 1.38, 0.9 + 3.2j, 1.6], list(rng.uniform(0.02, 0.15, 5))
    if name == 'random-7':
        return list(rng.uniform(1.35, 2.4, 7)), list(rng.uniform(0.01, 0.2, 7))
    raise KeyError(name)


DESIGNS = ['single', 'quarter-wave-9', 'absorbing', 'random-7']
# (wavelengths, angles in radians): a point, a spectrum at an oblique angle, a meshed grid
GRIDS = {'point': (0.55, 0.0), 'oblique-spectrum': (np.linspace(0.42, 0.72, 9), 0.6),
         'mesh': (np.linspace(0.45, 0.65, 5)[:, None], np.asarray([0.0, 0.3, 1.2])[None, :])}


def _pair(name):
    n, d = _design(name)
    return tc.Stack(n, d, SUB), jc.Stack(n, d, SUB)


def _args(grid):
    wvl, theta = GRIDS[grid]
    return (wvl, theta), (jnp.asarray(wvl), jnp.asarray(theta))


@pytest.mark.parametrize('pol', ['s', 'p'])
@pytest.mark.parametrize('grid', list(GRIDS))
@pytest.mark.parametrize('design', DESIGNS)
def test_rt_rta_fields_match_jax(design, grid, pol):
    mine, _ = _pair(design)
    ta, _ = _args(grid)

    def jax_side(design, grid, pol):
        _, ref = _pair(design)
        _, ja = _args(grid)
        return (jc.stack_rt(ref, *ja, pol), jc.RTA(ref, *ja, pol),
                jc.internal_fields(ref, *ja, pol))

    rt, rta, fields = jax_ref('rt-rta-fields', jax_side, design, grid, pol, bar=BAR)
    for got, want in zip(tc.stack_rt(mine, *ta, pol), rt):
        _close(got, want)
    for got, want in zip(tc.RTA(mine, *ta, pol), rta):
        _close(got, want, floor=1.0)
    for got, want in zip(tc.internal_fields(mine, *ta, pol), fields):
        _close(got, want, floor=1.0)


@pytest.mark.parametrize('pol', ['s', 'p'])
@pytest.mark.parametrize('design', DESIGNS)
def test_matrices_and_products_match_jax(design, pol):
    mine, _ = _pair(design)
    ta, _ = _args('oblique-spectrum')

    def jax_side(design, pol):
        _, ref = _pair(design)
        _, ja = _args('oblique-spectrum')
        m_j = jc.stack_characteristic_matrices(ref, *ja, pol)
        return m_j, jc.forward_products(m_j), jc.backward_products(m_j)

    m_j, *products = jax_ref('matrices', jax_side, design, pol, bar=BAR)
    m_t = tc.stack_characteristic_matrices(mine, *ta, pol)
    assert len(m_t) == len(m_j)
    for a, b in zip(m_t, m_j):
        _close(a, b)
    for fn_t, want in zip((tc.forward_products, tc.backward_products), products):
        got = fn_t(m_t)
        assert len(got) == len(want) == len(m_t) + 1
        for a, b in zip(got, want):
            _close(torch.broadcast_to(a, np.broadcast_shapes(a.shape, np.shape(b))),
                   np.broadcast_to(b, np.broadcast_shapes(a.shape, np.shape(b))))


def test_products_are_the_ordered_products():
    """The doublings give M_0 ... M_k and M_k ... M_{N-1}, for every length up to 13."""
    rng = np.random.default_rng(3)
    for n in range(1, 14):
        mats = [torch.as_tensor(rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2)))
                for _ in range(n)]
        fwd, bwd = tc.forward_products(mats), tc.backward_products(mats)
        acc = np.eye(2)
        for k in range(n):
            acc = acc @ mats[k].numpy()
            _close(fwd[k + 1], acc)
        acc = np.eye(2)
        for k in reversed(range(n)):
            acc = mats[k].numpy() @ acc
            _close(bwd[k], acc)


@pytest.mark.parametrize('n', [1, 2, 5, 9])
def test_suffix_products_backward_is_the_products_gradient(n):
    """The written-out backward of the doubled suffix products against finite differences
    (gradcheck, complex inputs) and against autograd through the plain doubling."""
    from prysm_tpu_torch.x.coatings.stack import _SuffixProducts, _suffix_doubling
    rng = np.random.default_rng(n)
    mats = torch.as_tensor(rng.standard_normal((n, 3, 2, 2))
                           + 1j * rng.standard_normal((n, 3, 2, 2))).requires_grad_(True)
    assert torch.autograd.gradcheck(_SuffixProducts.apply, (mats,))
    G = torch.as_tensor(rng.standard_normal((n, 3, 2, 2)) + 1j * rng.standard_normal((n, 3, 2, 2)))
    got, = torch.autograd.grad(_SuffixProducts.apply(mats), mats, G)
    want, = torch.autograd.grad(_suffix_doubling(mats), mats, G)
    _close(got, want)


@pytest.mark.parametrize('pol', ['s', 'p'])
@pytest.mark.parametrize('design', ['quarter-wave-9', 'absorbing'])
def test_field_at_depth_matches_jax(design, pol):
    mine, ref = _pair(design)
    total = float(np.sum(_design(design)[1]))
    z = np.linspace(0.0, total, 23)
    for got, want in zip(tc.field_at_depth(mine, z, 0.55, 0.4, pol),
                         jc.field_at_depth(ref, jnp.asarray(z), 0.55, 0.4, pol)):
        _close(got, want)
    with pytest.raises(ValueError):
        tc.field_at_depth(mine, [total * 1.5], 0.55, 0.0, pol)


def test_lossless_energy_balance_and_thinfilm_crosscheck():
    from prysm_tpu_torch.thinfilm import multilayer_stack_rt
    n, d = _design('random-7')
    stack = tc.Stack(n, d, SUB)
    wvl = np.linspace(0.4, 0.8, 17)
    for pol in 'sp':
        R, T, A = tc.RTA(stack, wvl, 0.3, pol)
        assert float((R + T - 1).abs().max()) < 1e-13
        assert float(A.abs().max()) < 1e-13
        r, _ = tc.stack_rt(stack, wvl, 0.3, pol)
        r2, _ = multilayer_stack_rt(torch.as_tensor(n)[:, None], torch.as_tensor(d)[:, None],
                                    torch.as_tensor(wvl), pol, SUB, aoi=float(np.degrees(0.3)))
        _close(r, r2, 1e-12)


def test_stack_validation_and_callables():
    with pytest.raises(ValueError):
        tc.Stack([1.4, 2.0], [0.1], SUB)
    assert len(tc.Stack([1.4, 2.0], 0.1, SUB)) == 2
    with pytest.raises(ValueError):
        tc.stack_rt(tc.Stack([1.4], [0.1], SUB), 0.55, 0.0, 'x')

    def disp_t(w):
        return 1.45 + 0.004 / w ** 2

    def disp_j(w):
        return 1.45 + 0.004 / w ** 2

    wvl = np.linspace(0.45, 0.65, 6)
    mine = tc.Stack([2.1, disp_t, 2.1], [0.06, 0.09, 0.06], SUB)
    ref = jc.Stack([2.1, disp_j, 2.1], [0.06, 0.09, 0.06], SUB)
    for got, want in zip(tc.RTA(mine, wvl, 0.2, 'p'), jc.RTA(ref, jnp.asarray(wvl), 0.2, 'p')):
        _close(got, want, floor=1.0)


def test_interop_stack_from_numpy():
    n, d = _design('absorbing')
    ref = jc.Stack(n, d, SUB)
    mine = interop.stack_from_numpy(np.asarray(n), np.asarray(ref.thicknesses), SUB,
                                    device='cpu')
    assert mine.thicknesses.dtype == torch.float64 and mine.indices == n
    for got, want in zip(tc.RTA(mine, 0.5, 0.1, 's'), jc.RTA(ref, 0.5, 0.1, 's')):
        _close(got, want, floor=1.0)
    f32 = interop.stack_from_numpy(n, d, SUB, 1.0, device='cpu', dtype=torch.float32)
    assert f32.thicknesses.dtype == torch.float32


# ---------------------------------------------------------------------------
# deposition monitoring
# ---------------------------------------------------------------------------

MON = (0.55, 0.0, 's')


def _jax_monitoring(mode):
    """Each layer's trace, turning points and level cut, and the cut-off levels."""
    _, ref = _pair('quarter-wave-9')
    traces = []
    for layer in (0, 4, 8):
        d_j, s_j = jmon.monitoring_trace(ref, layer, 0.55, mode=mode, n_points=60, pol='p',
                                         theta=0.2)
        traces.append((d_j, s_j, jmon.turning_points(d_j, s_j),
                       jmon.level_cut(d_j, s_j, float(s_j[30]))))
    return traces, jmon.cutoff_levels(ref, 0.55, mode=mode)


@pytest.mark.parametrize('mode', ['R', 'T'])
def test_monitoring_traces_and_levels_match_jax(mode):
    mine, _ = _pair('quarter-wave-9')
    traces, cutoffs = jax_ref('monitoring', _jax_monitoring, mode, bar=BAR)
    for layer, (d_j, s_j, turning_j, cut_j) in zip((0, 4, 8), traces):
        d_t, s_t = tmon.monitoring_trace(mine, layer, 0.55, mode=mode, n_points=60, pol='p',
                                         theta=0.2)
        _close(d_t, d_j)
        _close(s_t, s_j)
        np.testing.assert_allclose(tmon.turning_points(d_t, s_t), turning_j, rtol=BAR)
        assert tmon.level_cut(d_t, s_t, float(s_j[30])) == pytest.approx(cut_j, rel=BAR)
    _close(tmon.cutoff_levels(mine, 0.55, mode=mode), cutoffs)


def _jax_monitor_runs(strategy, key, errors, design):
    """The simulated run's thicknesses, the error sensitivity, the chosen wavelength and
    its scores."""
    _, ref = _pair('quarter-wave-9')
    run_j = jmon.simulate_run(ref, 0.55, strategy=strategy, n_points=200, **{key: errors})
    return (run_j.thicknesses,
            jmon.monitoring_error_sensitivity(ref, 0.55, design, strategy=strategy,
                                              n_points=200),
            *jmon.choose_monitor_wavelength(ref, [0.5, 0.6], design, strategy=strategy,
                                            n_points=200))


@pytest.mark.parametrize('strategy', ['level', 'turning'])
def test_simulated_runs_and_sensitivity_match_jax(strategy):
    n, d = _design('quarter-wave-9')
    mine, _ = _pair('quarter-wave-9')
    errors = np.random.default_rng(4).normal(0, 1e-3, len(n))
    key = 'thickness_errors' if strategy == 'turning' else 'signal_errors'
    design = np.asarray([0.5, 0.55, 0.6])
    thicknesses, sensitivity, best_j, scores_j = jax_ref(
        'monitor-runs', _jax_monitor_runs, strategy, key, errors, design, bar=1e-10)
    run_t = tmon.simulate_run(mine, 0.55, strategy=strategy, n_points=200, **{key: errors})
    _close(run_t.thicknesses, thicknesses, 1e-10)
    _close(tmon.monitoring_error_sensitivity(mine, 0.55, design, strategy=strategy,
                                             n_points=200), sensitivity, 1e-8)
    best_t, scores_t = tmon.choose_monitor_wavelength(mine, [0.5, 0.6], design,
                                                      strategy=strategy, n_points=200)
    assert best_t == best_j
    _close(scores_t, scores_j, 1e-8)
    with pytest.raises(ValueError):
        tmon.simulate_run(mine, 0.55, strategy='other')


# ---------------------------------------------------------------------------
# rugate synthesis
# ---------------------------------------------------------------------------

def _same_stack(a, b):
    assert len(a) == len(b)
    np.testing.assert_allclose(np.real(np.asarray(a.indices, dtype=complex)),
                               np.real(np.asarray(b.indices, dtype=complex)), rtol=BAR)
    _close(a.thicknesses, b.thicknesses)
    assert a.substrate_index == b.substrate_index and a.ambient_index == b.ambient_index


@pytest.mark.parametrize('apodized', [False, True])
def test_sinusoidal_rugate_matches_jax(apodized):
    kw = dict(sublayers_per_period=12, substrate_index=SUB, clamp=(1.45, 2.2))
    if apodized:
        kw_t = dict(kw, apodization=tru.quintic_taper(0.3))
        kw_j = dict(kw, apodization=jru.quintic_taper(0.3))
    else:
        kw_t = kw_j = kw
    _same_stack(tru.sinusoidal_rugate(1.8, 0.2, 0.6, 8.5, **kw_t),
                jru.sinusoidal_rugate(1.8, 0.2, 0.6, 8.5, **kw_j))


def test_rugate_profiles_and_synthesis_match_jax():
    assert tru.rugate_period(1.8, 0.6) == jru.rugate_period(1.8, 0.6)
    assert tru.notch_wavelength(1.8, 0.2) == jru.notch_wavelength(1.8, 0.2)
    u = np.linspace(0, 1, 11)
    _close(tru.quintic_taper(0.25)(u), jru.quintic_taper(0.25)(u))
    profile = (lambda z: 1.7 + 0.1 * np.cos(9 * z))  # noqa: E731
    _same_stack(tru.discretize_profile(profile, 1.2, 30, SUB),
                jru.discretize_profile(profile, 1.2, 30, SUB))
    tapered_t = tru.apodize(profile, 1.7, 1.2, tru.quintic_taper(0.3))
    tapered_j = jru.apodize(profile, 1.7, 1.2, jru.quintic_taper(0.3))
    assert tapered_t(0.4) == pytest.approx(tapered_j(0.4), rel=BAR)
    k = np.linspace(9.0, 12.0, 64)
    target = 0.3 * np.exp(-((k - 10.5) / 0.4) ** 2)
    _same_stack(tru.rugate_from_target(k, target, 1.7, 3.0, 40, substrate_index=SUB),
                jru.rugate_from_target(k, target, 1.7, 3.0, 40, substrate_index=SUB))
