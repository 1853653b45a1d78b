"""The port's coating design modules against the JAX package's, and against finite differences.

``diff`` (every gradient and cotangent, lossless and absorbing, s and p),
``merit`` (every term, alone and summed), ``problem``, ``refine`` (bounded
L-BFGS-B and damped least squares), ``needle`` (the needle function,
insertion, clean-up, synthesis with the same layer count),
``common_materials`` and ``plotting``.  Inputs from seeded numpy
generators, ``jax_enable_x64``, ``config.precision = 64``, CPU.

The complex-gradient convention: a cotangent c pairs as
dF = Re(sum(conj(c) dz)).  ``jax.grad`` returns the conjugate of that pairing
for a complex leaf and the JAX package conjugates it once; torch's gradient
is the pairing's c as it stands, so the port does not conjugate.  The
cotangents are held to a central difference of F along random complex
directions dz, which fixes the sign of their imaginary parts whatever either
package does.

Bars: closed forms and gradients <= 1e-12 relative (of peak) against the JAX
package (of 1 where the peak is below 1 for the physical quantities and
their gradients and merits: a lossless stack's absorptance is rounding); <= 1e-6 against central differences (step 1e-6, the truncation's
order); optimizer iterates <= 1e-10 relative over the first 20 iterations,
but damped least squares' <= 1e-9: its central-difference Jacobian divides
the residuals' last-ulp differences (the two packages round the transfer
matrices differently) by its 1e-6 step, eps / h = 2.2e-10; a synthesis's
layers equal and its thicknesses and merit <= 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prysm_tpu.x import coatings as jc
from prysm_tpu.x.coatings import diff as jdiff

from prysm_tpu_torch.conf import config
from prysm_tpu_torch.x import coatings as tc
from prysm_tpu_torch.x.coatings import diff as tdiff

torch.set_num_threads(2)

BAR, FD_BAR, ITERATE_BAR, DLS_BAR = 1e-12, 1e-6, 1e-10, 1e-9
SUB = 1.52


@pytest.fixture(autouse=True)
def _cpu_f64(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _host(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, bar=BAR, floor=1e-300):
    a, b = _host(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(b).max(), floor)
    assert err <= bar, err


LOSSLESS = ([1.46, 2.2, 1.38, 2.05, 1.6], [0.10, 0.07, 0.12, 0.05, 0.09])
ABSORBING = ([1.46, 2.2 + 0.03j, 1.38, 0.5 + 2.8j, 1.6], [0.10, 0.07, 0.12, 0.02, 0.09])
WVL = np.linspace(0.45, 0.65, 7)[:, None]
THETA = np.asarray([0.0, 0.35])[None, :]


def _stacks(design):
    n, d = design
    return tc.Stack(n, d, SUB), jc.Stack(n, d, SUB)


def _seeds(fwd_shape_n, rng):
    """Seeds of every kind at the evaluation's shapes: R, T (calc), A (N), |E|^2 (N + 1)."""
    calc = (7, 2)
    return {'dR': rng.standard_normal(calc), 'dT': rng.standard_normal(calc),
            'dA': rng.standard_normal((fwd_shape_n,) + calc),
            'dEsq': rng.standard_normal((fwd_shape_n + 1,) + calc)}


def _pair_seeds(seeds, keys):
    return ({k: torch.as_tensor(v) for k, v in seeds.items() if k in keys},
            {k: jnp.asarray(v) for k, v in seeds.items() if k in keys})


DESIGNS = {'lossless': LOSSLESS, 'absorbing': ABSORBING}
SEED_SETS = {'R': ('dR',), 'RT': ('dR', 'dT'), 'A': ('dA',), 'Esq': ('dEsq',),
             'all': ('dR', 'dT', 'dA', 'dEsq')}


@pytest.mark.parametrize('keys', list(SEED_SETS))
@pytest.mark.parametrize('pol', ['s', 'p'])
@pytest.mark.parametrize('design', list(DESIGNS))
def test_thickness_and_index_gradients_match_jax(design, pol, keys):
    mine, ref = _stacks(DESIGNS[design])
    seeds = _seeds(len(mine), np.random.default_rng(len(keys)))
    st, sj = _pair_seeds(seeds, SEED_SETS[keys])
    ft, fj = tdiff.forward_eval(mine, WVL, THETA, pol), jdiff.forward_eval(ref, WVL, THETA, pol)
    for q in ('R_value', 'T_value', 'A_value', 'Esq_value'):
        _close(getattr(ft, q), getattr(fj, q), floor=1.0)
    _close(tdiff.thickness_gradient(ft, **st), jdiff.thickness_gradient(fj, **sj), floor=1.0)
    _close(tdiff.index_gradient(ft, **st), jdiff.index_gradient(fj, **sj), floor=1.0)


def _seeded_value(stack, pol, seeds):
    """The seeded scalar sum(seed * quantity) of a stack, evaluated from scratch."""
    f = tdiff.forward_eval(stack, WVL, THETA, pol)
    total = 0.0
    for key, q in (('dR', f.R_value), ('dT', f.T_value), ('dA', f.A_value), ('dEsq', f.Esq_value)):
        if key in seeds:
            total += float(torch.sum(seeds[key] * q))
    return total


@pytest.mark.parametrize('pol', ['s', 'p'])
@pytest.mark.parametrize('design', list(DESIGNS))
def test_thickness_and_index_gradients_match_central_differences(design, pol):
    n, d = DESIGNS[design]
    seeds, _ = _pair_seeds(_seeds(len(n), np.random.default_rng(7)), SEED_SETS['all'])
    g = tdiff.thickness_gradient(tdiff.forward_eval(tc.Stack(n, d, SUB), WVL, THETA, pol), **seeds)
    gi = tdiff.index_gradient(tdiff.forward_eval(tc.Stack(n, d, SUB), WVL, THETA, pol), **seeds)
    h = 1e-6
    fd, fdi = [], []
    for j in range(len(n)):
        bump = np.zeros(len(n))
        bump[j] = h
        fd.append((_seeded_value(tc.Stack(n, np.add(d, bump), SUB), pol, seeds)
                   - _seeded_value(tc.Stack(n, np.subtract(d, bump), SUB), pol, seeds)) / (2 * h))
        up, down = list(n), list(n)
        up[j], down[j] = n[j] + h, n[j] - h
        fdi.append((_seeded_value(tc.Stack(up, d, SUB), pol, seeds)
                    - _seeded_value(tc.Stack(down, d, SUB), pol, seeds)) / (2 * h))
    _close(g, np.asarray(fd), FD_BAR)
    _close(gi, np.asarray(fdi), FD_BAR)


def _random_direction(shape, rng):
    return torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))


@pytest.mark.parametrize('pol', ['s', 'p'])
@pytest.mark.parametrize('design', list(DESIGNS))
def test_assembly_cotangent_pairs_with_dM_and_matches_conjugated_jax(design, pol):
    """c_M against dF = Re(sum(conj(c_M) dM)) by central differences of F(M + h dM)."""
    mine, ref = _stacks(DESIGNS[design])
    rng = np.random.default_rng(11)
    dR, dT = rng.standard_normal((7, 2)), rng.standard_normal((7, 2))
    ft = tdiff.forward_eval(mine, WVL, THETA, pol)
    c_M = tdiff.assembly_cotangent(ft, dR=torch.as_tensor(dR), dT=torch.as_tensor(dT))
    _close(c_M, jdiff.assembly_cotangent(jdiff.forward_eval(ref, WVL, THETA, pol),
                                         dR=jnp.asarray(dR), dT=jnp.asarray(dT)))
    eta0, eta_sub = ft.eta0, ft.eta_sub

    def F(M):
        B = M[..., 0, 0] + M[..., 0, 1] * eta_sub
        C = M[..., 1, 0] + M[..., 1, 1] * eta_sub
        r = (eta0 * B - C) / (eta0 * B + C)
        t = 2 * eta0 / (eta0 * B + C)
        T = torch.real(eta_sub) / torch.real(eta0) * t.abs() ** 2
        return float(torch.sum(torch.as_tensor(dR) * r.abs() ** 2 + torch.as_tensor(dT) * T))

    h = 1e-6
    for _ in range(3):
        dM = _random_direction(ft.M.shape, rng)
        fd = (F(ft.M + h * dM) - F(ft.M - h * dM)) / (2 * h)
        paired = float(torch.real(torch.sum(torch.conj(c_M) * dM)))
        assert paired == pytest.approx(fd, rel=FD_BAR)
        # the JAX package's jax.grad, unconjugated, pairs with the wrong sign of Im
        wrong = float(torch.real(torch.sum(c_M * dM)))
        assert abs(wrong - fd) > 1e-3 * abs(fd)


@pytest.mark.parametrize('pol', ['s', 'p'])
@pytest.mark.parametrize('design', list(DESIGNS))
def test_layer_cotangents_pair_with_d_beta_eta(design, pol):
    mine, ref = _stacks(DESIGNS[design])
    seeds = _seeds(len(mine), np.random.default_rng(13))
    st, sj = _pair_seeds(seeds, SEED_SETS['all'])
    ft = tdiff.forward_eval(mine, WVL, THETA, pol)
    cb, ce = tdiff.layer_cotangents(ft, **st)
    cbj, cej = jdiff.layer_cotangents(jdiff.forward_eval(ref, WVL, THETA, pol), **sj)
    for a, b in zip(cb + ce, cbj + cej):
        _close(a, b)
    # pin the convention: F as a function of the (beta, eta) leaves, along complex directions
    rng = np.random.default_rng(17)
    betas, etas = ft.betas.expand(ft.matrices.shape[:-2]) + 0j, ft.etas.expand(
        ft.matrices.shape[:-2]) + 0j

    def F(b, e):
        r, t, E, H = tdiff._quantities_from_matrices(tc.stack._char_matrix(b, e), ft.eta0,
                                                     ft.eta_sub)
        return float(tdiff._seeded_scalar(r, t, E, H, ft.eta0, ft.eta_sub, **st))

    h = 1e-6
    db, de = _random_direction(betas.shape, rng), _random_direction(etas.shape, rng)
    fd = (F(betas + h * db, etas + h * de) - F(betas - h * db, etas - h * de)) / (2 * h)
    paired = float(torch.real(torch.sum(torch.conj(torch.stack(cb)) * db)
                              + torch.sum(torch.conj(torch.stack(ce)) * de)))
    assert paired == pytest.approx(fd, rel=FD_BAR)


def test_char_matrix_vjp_matches_jax_and_autograd():
    rng = np.random.default_rng(19)
    beta = rng.uniform(0.2, 2.0, 6) + 1j * rng.uniform(0, 0.1, 6)
    eta = rng.uniform(1.2, 2.3, 6) + 1j * rng.uniform(0, 0.05, 6)
    M_bar = rng.standard_normal((6, 2, 2)) + 1j * rng.standard_normal((6, 2, 2))
    got = tdiff.char_matrix_vjp(torch.as_tensor(beta), torch.as_tensor(eta), torch.as_tensor(M_bar))
    want = jdiff.char_matrix_vjp(jnp.asarray(beta), jnp.asarray(eta), jnp.asarray(M_bar))
    for a, b in zip(got, want):
        _close(a, b)
    # the analytic pullback equals autograd's for the pairing Re(sum(conj(M_bar) M))
    b = torch.as_tensor(beta).requires_grad_(True)
    e = torch.as_tensor(eta).requires_grad_(True)
    pairing = torch.real(torch.sum(torch.conj(torch.as_tensor(M_bar)) * tc.stack._char_matrix(b, e)))
    gb, ge = torch.autograd.grad(pairing, (b, e))
    _close(got[0], gb)
    _close(got[1], ge)


# ---------------------------------------------------------------------------
# merit terms and the problem
# ---------------------------------------------------------------------------

TERMS = ['R', 'T-p', 'A', 'Esq', 'peak', 'peak-all', 'layer']


def _terms(m):
    wvl2 = np.linspace(0.5, 0.6, 4)
    return {
        'R': m.Reflectance(WVL, THETA, target=0.05, weight=2.0),
        'T-p': m.Transmittance(wvl2, 0.3, pol='p', target=0.9),
        'A': m.LayerAbsorptance(1, wvl2, pol='s', target=0.01),
        'Esq': m.FieldIntensityAtBoundary(2, 0.55, 0.2, target=0.5),
        'peak': m.PeakFieldAtInterfaces(wvl2, 0.1, boundaries=[1, 2, 3], target=0.3),
        'peak-all': m.PeakFieldAtInterfaces(0.55, 0.0),
        'layer': m.FieldInLayer(2, wvl2, 0.15, pol='avg', target=0.4),
    }


@pytest.mark.parametrize('design', list(DESIGNS))
@pytest.mark.parametrize('term', TERMS)
def test_merit_terms_match_jax(term, design):
    mine, ref = _stacks(DESIGNS[design])
    tt, tj = _terms(tc)[term], _terms(jc)[term]
    assert tt.value(mine) == pytest.approx(tj.value(ref), rel=BAR, abs=BAR)
    _close(tt.residuals(mine), tj.residuals(ref), floor=1.0)
    v, g = tt.value_and_grad(mine)
    vj, gj = tj.value_and_grad(ref)
    assert v == pytest.approx(vj, rel=BAR, abs=BAR)
    _close(g, gj, floor=1.0)
    if tt.assembly_capable:
        (_, c_M), = tt.assembly_seeds(mine)
        want = [np.asarray(c) for _, c in tj.assembly_seeds(ref)]
        # the port's one evaluation carries the polarizations on a trailing axis
        _close(torch.movedim(c_M, -3, 0).reshape(len(want), *want[0].shape), np.stack(want))


def test_merit_function_and_validation():
    mine, ref = _stacks(ABSORBING)
    mt, mj = tc.MeritFunction(list(_terms(tc).values())), jc.MeritFunction(list(_terms(jc).values()))
    assert mt.value(mine) == pytest.approx(mj.value(ref), rel=BAR)
    _close(mt.residuals(mine), mj.residuals(ref))
    for fn_t, fn_j in ((tc.thickness_gradient, jc.thickness_gradient),
                       (tc.index_gradient, jc.index_gradient)):
        v, g = mt.value_and_grad(mine, grad_fn=fn_t)
        vj, gj = mj.value_and_grad(ref, grad_fn=fn_j)
        assert v == pytest.approx(vj, rel=BAR)
        _close(g, gj)
    assert tc.as_merit(mt) is mt and len(tc.as_merit(_terms(tc)['R']).terms) == 1
    with pytest.raises(ValueError, match='broadcast'):
        tc.Reflectance(np.ones((3, 2)), np.ones((4, 5)))
    with pytest.raises(ValueError, match='meshgrid'):
        tc.Reflectance(np.ones(3), np.ones(4))
    with pytest.raises(ValueError):
        tc.Reflectance(0.5, pol='x')
    with pytest.raises(NotImplementedError):
        _terms(tc)['A'].assembly_seeds(mine)


@pytest.mark.parametrize('variables', ['thickness', 'index'])
def test_coating_problem_matches_jax(variables):
    n, d = LOSSLESS
    mt, mj = _terms(tc), _terms(jc)
    pt = tc.CoatingProblem(tc.Stack(n, d, SUB), [mt['R'], mt['T-p']], variables=variables,
                           variable_layers=[0, 2, 3])
    pj = jc.CoatingProblem(jc.Stack(n, d, SUB), [mj['R'], mj['T-p']], variables=variables,
                           variable_layers=[0, 2, 3])
    _close(pt.x0(), pj.x0())
    x = _host(pt.x0()) * 1.03
    ft, gt = pt.fg(torch.as_tensor(x))
    fj, gj = pj.fg(jnp.asarray(x))
    assert ft == pytest.approx(fj, rel=BAR)
    _close(gt, gj)
    _close(pt.residuals(x), pj.residuals(x))
    assert pt.variable_layers == [0, 2, 3]
    with pytest.raises(ValueError):
        tc.CoatingProblem(tc.Stack(n, d, SUB), mt['R'], variables='other')
    with pytest.raises(TypeError):
        tc.CoatingProblem(tc.Stack([lambda w: 1.5 + 0 * w], [0.1], SUB), mt['R'],
                          variables='index')


# ---------------------------------------------------------------------------
# refine
# ---------------------------------------------------------------------------

def _edge(m, wvl_r=np.linspace(0.44, 0.54, 6), wvl_t=np.linspace(0.6, 0.9, 10)):
    theta = np.deg2rad([0.0, 15.0])[None, :]
    return [m.Reflectance(wvl_r[:, None], theta, target=1.0),
            m.Transmittance(wvl_t[:, None], theta, target=1.0)]


def _edge_start():
    n = [2.1, 1.46] * 3 + [2.1]
    rng = np.random.default_rng(9)
    return n, 0.49 / (4 * np.asarray(n)) * (1 + 0.05 * rng.standard_normal(len(n)))


@pytest.mark.parametrize('kwargs', [{}, {'min_thickness': 0.05}, {'bounds': (0.04, 0.09)},
                                    {'variables': 'index', 'maxiter': 15, 'bounds': (1.3, 2.5)}],
                         ids=['free', 'floor', 'box', 'index'])
def test_refine_lbfgsb_matches_jax(kwargs):
    n, d = _edge_start()
    kw = dict(dict(maxiter=10), **kwargs)
    mine = tc.refine(tc.Stack(n, d, SUB), _edge(tc), **kw)
    ref = jc.refine(jc.Stack(n, d, SUB), _edge(jc), **kw)
    assert (mine.nit, mine.success) == (ref.nit, ref.success)
    for a, b in zip(mine.optimizer_result.records, ref.optimizer_result.records):
        _close(a.x_next, b.x_next, ITERATE_BAR)
    assert mine.merit == pytest.approx(ref.merit, rel=ITERATE_BAR)
    assert 'CoatingResult' in repr(mine)


@pytest.mark.parametrize('design', ['edge', 'ar'])
def test_refine_lm_matches_jax(design):
    """Damped least squares where the JAX package's active-set loop completes (the edge
    filter at damping 1e-2; at the default 1e-6 it raises, see the test below)."""
    if design == 'edge':
        n, d = _edge_start()
        merit_t, merit_j, kw = _edge(tc), _edge(jc), {'damping': 1e-2}
    else:
        n, d = [1.38, 2.05, 1.6], [0.1, 0.05, 0.08]
        merit_t, merit_j, kw = _ar(tc), _ar(jc), {}
    mine = tc.refine(tc.Stack(n, d, SUB), merit_t, method='lm', maxiter=6, **kw)
    ref = jc.refine(jc.Stack(n, d, SUB), merit_j, method='lm', maxiter=6, **kw)
    res_t, res_j = mine.optimizer_result, ref.optimizer_result
    assert (res_t.nit, res_t.nfev) == (res_j.nit, res_j.nfev)
    for a, b in zip(res_t.history, res_j.history):
        _close(a['x'], b['x'], DLS_BAR)
    assert mine.merit == pytest.approx(ref.merit, rel=DLS_BAR)
    with pytest.raises(ValueError):
        tc.refine(tc.Stack(n, d, SUB), merit_t, method='other')


def test_refine_lm_with_a_floor_runs_where_the_jax_package_raises():
    """The edge filter at 9 layers with a 5 nm floor: the JAX package's active-set loop
    exhausts its rounds and raises on mismatched multipliers; the port's pairs them with
    the set they were solved with, and the run lowers the merit."""
    n = [2.1, 1.46] * 4 + [2.1]
    rng = np.random.default_rng(9)
    d = 0.49 / (4 * np.asarray(n)) * (1 + 0.05 * rng.standard_normal(len(n)))
    merit = _edge(tc, np.linspace(0.44, 0.54, 8), np.linspace(0.6, 0.9, 24))
    start = tc.MeritFunction(merit).value(tc.Stack(n, d, SUB))
    with pytest.raises(ValueError, match='shape mismatch'):
        jc.refine(jc.Stack(n, d, SUB), _edge(jc, np.linspace(0.44, 0.54, 8),
                                             np.linspace(0.6, 0.9, 24)),
                  method='lm', maxiter=10, min_thickness=0.005)
    res = tc.refine(tc.Stack(n, d, SUB), merit, method='lm', maxiter=10, min_thickness=0.005)
    assert res.merit < start and bool((res.stack.thicknesses >= 0.005 - 1e-12).all())


# ---------------------------------------------------------------------------
# needle synthesis
# ---------------------------------------------------------------------------

def _ar(m, npts=7):
    return m.MeritFunction([m.Reflectance(np.linspace(0.45, 0.65, npts), pol='s', target=0.0)])


@pytest.mark.parametrize('material', [1.38, 2.05, 1.9 + 0.01j])
@pytest.mark.parametrize('design', list(DESIGNS))
def test_needle_function_matches_jax_and_differences(design, material):
    mine, ref = _stacks(DESIGNS[design])
    z = np.linspace(0.0, float(np.sum(DESIGNS[design][1])), 13)
    P = tc.needle_function(mine, _ar(tc), material, z)
    _close(P, jc.needle_function(ref, _ar(jc), material, jnp.asarray(z)))
    if isinstance(material, complex) or design == 'absorbing':
        return
    base, dn = _ar(tc).value(mine), 1e-7
    for k in (2, 7, 11):
        fd = (_ar(tc).value(tc.insert_needle(mine, z[k], material, thickness=dn)) - base) / dn
        assert float(P[k]) == pytest.approx(fd, rel=3e-3, abs=1e-6)


def test_needle_helpers_match_jax():
    mine, ref = _stacks(LOSSLESS)
    grown_t, at_t = tc.insert_needle(mine, 0.21, 1.9, thickness=2e-3, return_index=True)
    grown_j, at_j = jc.insert_needle(ref, 0.21, 1.9, thickness=2e-3, return_index=True)
    assert at_t == at_j and grown_t.indices == grown_j.indices
    _close(grown_t.thicknesses, grown_j.thicknesses)
    with pytest.raises(ValueError):
        tc.insert_needle(mine, 5.0, 1.9)
    stack = tc.Stack([1.4, 2.0, 1.4, 1.4, 2.0], [0.10, 5e-4, 0.15, 0.05, 0.02], SUB)
    for keep in (None, [1]):
        cleaned = tc.cleanup(stack, keep_indices=keep)
        want = jc.cleanup(jc.Stack([1.4, 2.0, 1.4, 1.4, 2.0], [0.10, 5e-4, 0.15, 0.05, 0.02],
                                   SUB), keep_indices=keep)
        assert cleaned.indices == want.indices
        _close(cleaned.thicknesses, want.thicknesses)


@pytest.mark.parametrize('materials', [[1.38, 2.05], [2.05, 1.38, 1.7]], ids=['two', 'three'])
def test_synthesize_matches_jax(materials):
    """The same layers from the same start; the thicknesses and merit within 1e-6 (each
    round refines 10 L-BFGS-B iterations, and rounding grows through the rounds)."""
    kw = dict(z_samples=40, max_iters=3, max_layers=8, refine_kwargs={'maxiter': 10})
    mine = tc.synthesize(tc.Stack([1.38, 2.05], [0.10, 0.10], SUB), _ar(tc), materials, **kw)
    ref = jc.synthesize(jc.Stack([1.38, 2.05], [0.10, 0.10], SUB), _ar(jc), materials, **kw)
    assert (mine.n_layers, mine.iterations, mine.success) == (ref.n_layers, ref.iterations,
                                                              ref.success)
    assert mine.stack.indices == ref.stack.indices
    _close(mine.stack.thicknesses, ref.stack.thicknesses, 1e-6)
    assert mine.merit == pytest.approx(ref.merit, rel=1e-6)
    assert mine.merit < _ar(tc).value(tc.Stack([1.38, 2.05], [0.10, 0.10], SUB)) / 5
    with pytest.raises(ValueError):
        tc.synthesize(tc.Stack([1.38], [0.1], SUB), _ar(tc), [])


# ---------------------------------------------------------------------------
# common materials and plotting
# ---------------------------------------------------------------------------

# a refractiveindex.info database holding the VIS antireflection tokens' books and pages
_AR_VIS_PAGES = {('MgF2', 'Dodge'): (1.38, 1.37), ('SiO2', 'Malitson'): (1.47, 1.45),
                 ('Al2O3', 'Malitson'): (1.78, 1.76), ('TiO2', 'Sarkar'): (2.60, 2.45),
                 ('TiO2', 'Devore'): (2.70, 2.50), ('Ta2O5', 'Gao'): (2.25, 2.12)}


def _ar_vis_database(root):
    lines = ['- SHELF: main', '  content:']
    for book in dict.fromkeys(b for b, _ in _AR_VIS_PAGES):
        lines += [f'    - BOOK: {book}', '      content:']
        for (b, page), (n0, n1) in _AR_VIS_PAGES.items():
            if b == book:
                lines += [f'        - PAGE: {page}', f'          data: main/{b}/{page}.yml']
                path = root / 'data' / 'main' / b / f'{page}.yml'
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_text('DATA:\n  - type: tabulated nk\n    data: |\n'
                                f'      0.35 {n0} 0.001\n      0.75 {n1} 0.0\n')
    (root / 'catalog-nk.yml').write_text('\n'.join(lines) + '\n')
    return root


def test_common_materials_tables_and_resolution(tmp_path, monkeypatch):
    """The tables, and resolution through x/materials: a refractiveindex.info database given,
    and the default catalog (its folder patched to the same tmp_path database; the download
    patched to raise), both as the JAX package resolves them."""
    import importlib
    from prysm_tpu.x.coatings import common_materials as jcm
    from prysm_tpu.x.materials import RefractiveIndexCatalog as JRII, rii as jrii
    from prysm_tpu_torch.x.coatings import common_materials as tcm
    from prysm_tpu_torch.x.materials import RefractiveIndexCatalog as TRII, rii as trii
    for table in ('BANDS', 'ANTIREFLECTION', 'BANDPASS', 'MIRROR', 'APPLICATIONS'):
        assert getattr(tcm, table) == getattr(jcm, table)
    assert tcm.names('ar', 'vis') == jcm.names('ar', 'vis')

    db = _ar_vis_database(tmp_path)

    def refuse(db_path):
        raise AssertionError(f'the test reached the download of {db_path}')

    for rii, pkg in ((trii, 'prysm_tpu_torch'), (jrii, 'prysm_tpu')):
        monkeypatch.setattr(rii, '_fetch_database', refuse)
        monkeypatch.setattr(rii, 'default_db_path', lambda: db)
        monkeypatch.setattr(importlib.import_module(f'{pkg}.x.materials.lookup'), '_SHARED_DB', [])
    w = np.linspace(0.4, 0.7, 4)
    for mine, ref in ((tcm.materials('AR', 'VIS', database=TRII.from_database(db, download=False)),
                       jcm.materials('AR', 'VIS', database=JRII.from_database(db, download=False))),
                      (tcm.materials('AR', 'VIS'), jcm.materials('AR', 'VIS'))):
        assert list(mine) == list(ref)
        for tier in ref:
            assert [m.page_info for m in mine[tier]] == [m.page_info for m in ref[tier]]
            for m, r in zip(mine[tier], ref[tier]):
                np.testing.assert_array_equal(m.nk(w), r.nk(w))

    class _Catalog:
        def material_for_name(self, name, page=None):
            return (name, page)

    got = tcm.materials('MIRROR', 'LWIR', database=_Catalog())
    assert got['metal'] == (('Au', None), ('Al', 'Rakic'))


def test_plotting_draws():
    pytest.importorskip('matplotlib')
    import matplotlib
    matplotlib.use('Agg')
    from prysm_tpu_torch.x.coatings import plotting as tplot
    n, d = LOSSLESS
    stack = tc.Stack(n, d, SUB)
    wvl = np.linspace(0.45, 0.65, 11)
    for fig_ax in (tplot.plot_spectrum(stack, wvl, quantities=('R', 'T', 'A')),
                   tplot.plot_index_profile(stack), tplot.plot_field_intensity(stack, 0.55),
                   tplot.plot_admittance(stack, 0.55), tplot.plot_monitoring_trace(stack, 1, 0.55)):
        assert fig_ax[1] is not None
    with pytest.raises(ValueError):
        tplot.plot_spectrum(stack, wvl, quantities=('X',))
