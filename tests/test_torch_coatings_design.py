"""The port's coating design modules against the JAX package's, and against finite differences.

``diff`` (every gradient and cotangent, lossless and absorbing, s and p),
``merit`` (every term, alone and summed), ``problem``, ``refine`` (bounded
L-BFGS-B and damped least squares), ``needle`` (the needle function,
insertion, clean-up, synthesis with the same layer count),
``common_materials`` and ``plotting``; and the coating design path,
``steps.build_coating_design`` at 9 layers and 32 wavelengths (8 in the
reflect band, 24 in the transmit band, 2 angles) with a needle synthesis at
16 wavelengths x 3 angles: its start, its merit and gradient, its bounded
L-BFGS-B refinement and its synthesis against the JAX package's
``x.coatings`` on the same numbers, and its damped least squares, where the
JAX package's active-set loop raises, held to the merit it lowers and the
floor it keeps.  Inputs from seeded numpy generators, ``jax_enable_x64``,
``config.precision = 64``, CPU.  The JAX package's side of each comparison
is read from its record (``_jax_refs``) and computed live where there is
none; live, its forward evaluation of each design and polarization is made
once a module (``_jax_forward``).

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
layers equal and its thicknesses and merit <= 1e-6 relative (the design
path's refines 15 iterations a round).
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _jax_refs import jax_ref
from prysm_tpu.x import coatings as jc
from prysm_tpu.x.coatings import diff as jdiff

from prysm_tpu_torch import steps
from prysm_tpu_torch.conf import config
from prysm_tpu_torch.x import coatings as tc
from prysm_tpu_torch.x.coatings import diff as tdiff

torch.set_num_threads(2)

BAR, FD_BAR, ITERATE_BAR, DLS_BAR, SYNTH_BAR = 1e-12, 1e-6, 1e-10, 1e-9, 1e-6
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


@functools.cache
def _jax_forward(design, pol):
    """The JAX package's forward evaluation of ``DESIGNS[design]`` on (WVL, THETA), made
    once a module: the gradient and cotangent references only read it."""
    n, d = DESIGNS[design]
    return jdiff.forward_eval(jc.Stack(n, d, SUB), WVL, THETA, pol)


QUANTITIES = ('R_value', 'T_value', 'A_value', 'Esq_value')


def _jax_gradients(design, pol, seeds):
    fj = _jax_forward(design, pol)
    sj = {k: jnp.asarray(v) for k, v in seeds.items()}
    return ([getattr(fj, q) for q in QUANTITIES], jdiff.thickness_gradient(fj, **sj),
            jdiff.index_gradient(fj, **sj))


def _seeds(fwd_shape_n, rng):
    """Seeds of every kind at the evaluation's shapes: R, T (calc), A (N), |E|^2 (N + 1)."""
    calc = (7, 2)
    return {'dR': rng.standard_normal(calc), 'dT': rng.standard_normal(calc),
            'dA': rng.standard_normal((fwd_shape_n,) + calc),
            'dEsq': rng.standard_normal((fwd_shape_n + 1,) + calc)}


def _pair_seeds(seeds, keys):
    """The seeds named by ``keys``, as tensors and as numpy arrays."""
    return ({k: torch.as_tensor(v) for k, v in seeds.items() if k in keys},
            {k: v for k, v in seeds.items() if k in keys})


DESIGNS = {'lossless': LOSSLESS, 'absorbing': ABSORBING}
SEED_SETS = {'R': ('dR',), 'RT': ('dR', 'dT'), 'A': ('dA',), 'Esq': ('dEsq',),
             'all': ('dR', 'dT', 'dA', 'dEsq')}


@pytest.mark.parametrize('keys', list(SEED_SETS))
@pytest.mark.parametrize('pol', ['s', 'p'])
@pytest.mark.parametrize('design', list(DESIGNS))
def test_thickness_and_index_gradients_match_jax(design, pol, keys):
    mine = tc.Stack(*DESIGNS[design], SUB)
    seeds = _seeds(len(mine), np.random.default_rng(len(keys)))
    st, sj = _pair_seeds(seeds, SEED_SETS[keys])
    ft = tdiff.forward_eval(mine, WVL, THETA, pol)
    values, g, gi = jax_ref('gradients', _jax_gradients, design, pol, sj, bar=BAR)
    for q, want in zip(QUANTITIES, values):
        _close(getattr(ft, q), want, floor=1.0)
    _close(tdiff.thickness_gradient(ft, **st), g, floor=1.0)
    _close(tdiff.index_gradient(ft, **st), gi, floor=1.0)


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
    mine = tc.Stack(*DESIGNS[design], SUB)
    rng = np.random.default_rng(11)
    dR, dT = rng.standard_normal((7, 2)), rng.standard_normal((7, 2))
    ft = tdiff.forward_eval(mine, WVL, THETA, pol)
    c_M = tdiff.assembly_cotangent(ft, dR=torch.as_tensor(dR), dT=torch.as_tensor(dT))
    _close(c_M, jax_ref('assembly', lambda design, pol, dR, dT: jdiff.assembly_cotangent(
        _jax_forward(design, pol), dR=jnp.asarray(dR), dT=jnp.asarray(dT)),
        design, pol, dR, dT, bar=BAR))
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
    mine = tc.Stack(*DESIGNS[design], SUB)
    seeds = _seeds(len(mine), np.random.default_rng(13))
    st, sj = _pair_seeds(seeds, SEED_SETS['all'])
    ft = tdiff.forward_eval(mine, WVL, THETA, pol)
    cb, ce = tdiff.layer_cotangents(ft, **st)
    cbj, cej = jax_ref('layers', lambda design, pol, sj: jdiff.layer_cotangents(
        _jax_forward(design, pol), **{k: jnp.asarray(v) for k, v in sj.items()}),
        design, pol, sj, bar=BAR)
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
    want = jax_ref('char-vjp', lambda *a: jdiff.char_matrix_vjp(*map(jnp.asarray, a)),
                   beta, eta, M_bar, bar=BAR)
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


def _jax_term(term, design, assembly_capable):
    """A term's value, residuals, value and gradient, and (where the port's term assembles)
    assembly seeds, as the JAX package computes them."""
    tj, ref = _terms(jc)[term], jc.Stack(*DESIGNS[design], SUB)
    vj, gj = tj.value_and_grad(ref)
    seeds = [c for _, c in tj.assembly_seeds(ref)] if assembly_capable else None
    return float(tj.value(ref)), tj.residuals(ref), float(vj), gj, seeds


@pytest.mark.parametrize('design', list(DESIGNS))
@pytest.mark.parametrize('term', TERMS)
def test_merit_terms_match_jax(term, design):
    mine = tc.Stack(*DESIGNS[design], SUB)
    tt = _terms(tc)[term]
    value, residuals, vj, gj, seeds = jax_ref('term', _jax_term, term, design,
                                              tt.assembly_capable, bar=BAR)
    assert tt.value(mine) == pytest.approx(value, rel=BAR, abs=BAR)
    _close(tt.residuals(mine), residuals, floor=1.0)
    v, g = tt.value_and_grad(mine)
    assert v == pytest.approx(vj, rel=BAR, abs=BAR)
    _close(g, gj, floor=1.0)
    if tt.assembly_capable:
        (_, c_M), = tt.assembly_seeds(mine)
        want = seeds
        # the port's one evaluation carries the polarizations on a trailing axis
        _close(torch.movedim(c_M, -3, 0).reshape(len(want), *want[0].shape), np.stack(want))


def _jax_merit():
    """The merit function of every term on the absorbing design: value, residuals, and
    value and gradient in thickness and in index, as the JAX package computes them."""
    mj, ref = jc.MeritFunction(list(_terms(jc).values())), jc.Stack(*ABSORBING, SUB)
    grads = [mj.value_and_grad(ref, grad_fn=fn) for fn in (jc.thickness_gradient,
                                                            jc.index_gradient)]
    return float(mj.value(ref)), mj.residuals(ref), [(float(v), g) for v, g in grads]


def test_merit_function_and_validation():
    mine = tc.Stack(*ABSORBING, SUB)
    mt = tc.MeritFunction(list(_terms(tc).values()))
    value, residuals, grads = jax_ref('merit', _jax_merit, bar=BAR)
    assert mt.value(mine) == pytest.approx(value, rel=BAR)
    _close(mt.residuals(mine), residuals)
    for fn_t, (vj, gj) in zip((tc.thickness_gradient, tc.index_gradient), grads):
        v, g = mt.value_and_grad(mine, grad_fn=fn_t)
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


def _jax_problem(variables, x):
    """The JAX package's problem on the lossless design: x0, and f, g and the residuals
    at ``x``."""
    mj = _terms(jc)
    pj = jc.CoatingProblem(jc.Stack(*LOSSLESS, SUB), [mj['R'], mj['T-p']], variables=variables,
                           variable_layers=[0, 2, 3])
    fj, gj = pj.fg(jnp.asarray(x))
    return pj.x0(), float(fj), gj, pj.residuals(x)


@pytest.mark.parametrize('variables', ['thickness', 'index'])
def test_coating_problem_matches_jax(variables):
    n, d = LOSSLESS
    mt = _terms(tc)
    pt = tc.CoatingProblem(tc.Stack(n, d, SUB), [mt['R'], mt['T-p']], variables=variables,
                           variable_layers=[0, 2, 3])
    x = _host(pt.x0()) * 1.03
    x0, fj, gj, residuals = jax_ref('problem', _jax_problem, variables, x, bar=BAR)
    _close(pt.x0(), x0)
    ft, gt = pt.fg(torch.as_tensor(x))
    assert ft == pytest.approx(fj, rel=BAR)
    _close(gt, gj)
    _close(pt.residuals(x), residuals)
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


def _jax_lbfgsb(stack, terms, kw):
    """(nit, success, each iteration's x_next, merit) of the JAX package's refinement."""
    ref = jc.refine(stack, terms, **kw)
    return (ref.nit, ref.success, [b.x_next for b in ref.optimizer_result.records],
            float(ref.merit))


@pytest.mark.parametrize('kwargs', [{}, {'min_thickness': 0.05}, {'bounds': (0.04, 0.09)},
                                    {'variables': 'index', 'maxiter': 15, 'bounds': (1.3, 2.5)}],
                         ids=['free', 'floor', 'box', 'index'])
def test_refine_lbfgsb_matches_jax(kwargs):
    n, d = _edge_start()
    kw = dict(dict(maxiter=10), **kwargs)
    mine = tc.refine(tc.Stack(n, d, SUB), _edge(tc), **kw)
    nit, success, x_next, merit = jax_ref(
        'refine', lambda n, d, kw: _jax_lbfgsb(jc.Stack(n, d, SUB), _edge(jc), kw), n, d, kw,
        bar=ITERATE_BAR)
    assert (mine.nit, mine.success) == (nit, success)
    for a, b in zip(mine.optimizer_result.records, x_next):
        _close(a.x_next, b, ITERATE_BAR)
    assert mine.merit == pytest.approx(merit, rel=ITERATE_BAR)
    assert 'CoatingResult' in repr(mine)


def _jax_lm(design, n, d, kw):
    """(nit, nfev, each iteration's x, merit) of the JAX package's damped least squares."""
    merit = _edge(jc) if design == 'edge' else _ar(jc)
    ref = jc.refine(jc.Stack(n, d, SUB), merit, method='lm', maxiter=6, **kw)
    res = ref.optimizer_result
    return res.nit, res.nfev, [h['x'] for h in res.history], float(ref.merit)


@pytest.mark.parametrize('design', ['edge', 'ar'])
def test_refine_lm_matches_jax(design):
    """Damped least squares where the JAX package's active-set loop completes (the edge
    filter at damping 1e-2; at the default 1e-6 it raises, see the test below)."""
    if design == 'edge':
        n, d = _edge_start()
        merit_t, kw = _edge(tc), {'damping': 1e-2}
    else:
        n, d = [1.38, 2.05, 1.6], [0.1, 0.05, 0.08]
        merit_t, kw = _ar(tc), {}
    mine = tc.refine(tc.Stack(n, d, SUB), merit_t, method='lm', maxiter=6, **kw)
    nit, nfev, xs, merit = jax_ref('refine-lm', _jax_lm, design, n, d, kw, bar=DLS_BAR)
    res_t = mine.optimizer_result
    assert (res_t.nit, res_t.nfev) == (nit, nfev)
    for a, b in zip(res_t.history, xs):
        _close(a['x'], b, DLS_BAR)
    assert mine.merit == pytest.approx(merit, rel=DLS_BAR)
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
        jax_ref('refine-lm-floor', lambda n, d: jc.refine(
            jc.Stack(n, d, SUB), _edge(jc, np.linspace(0.44, 0.54, 8), np.linspace(0.6, 0.9, 24)),
            method='lm', maxiter=10, min_thickness=0.005), n, d)
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
    mine = tc.Stack(*DESIGNS[design], SUB)
    z = np.linspace(0.0, float(np.sum(DESIGNS[design][1])), 13)
    P = tc.needle_function(mine, _ar(tc), material, z)
    _close(P, jax_ref('needle', lambda design, material, z: jc.needle_function(
        jc.Stack(*DESIGNS[design], SUB), _ar(jc), material, jnp.asarray(z)),
        design, material, z, bar=BAR))
    if isinstance(material, complex) or design == 'absorbing':
        return
    base, dn = _ar(tc).value(mine), 1e-7
    for k in (2, 7, 11):
        fd = (_ar(tc).value(tc.insert_needle(mine, z[k], material, thickness=dn)) - base) / dn
        assert float(P[k]) == pytest.approx(fd, rel=3e-3, abs=1e-6)


def _jax_needle_helpers():
    """The JAX package's insert_needle on the lossless design, and its clean-up of a stack
    with a thin layer and a repeated index, keeping nothing and then index 1: each as
    (indices, thicknesses)."""
    grown, at = jc.insert_needle(jc.Stack(*LOSSLESS, SUB), 0.21, 1.9, thickness=2e-3,
                                 return_index=True)
    cleaned = [jc.cleanup(jc.Stack([1.4, 2.0, 1.4, 1.4, 2.0], [0.10, 5e-4, 0.15, 0.05, 0.02],
                                   SUB), keep_indices=keep) for keep in (None, [1])]
    return at, [(s.indices, s.thicknesses) for s in [grown] + cleaned]


def test_needle_helpers_match_jax():
    mine = tc.Stack(*LOSSLESS, SUB)
    at_j, ((indices, thicknesses), *cleaned_j) = jax_ref('needle-helpers', _jax_needle_helpers,
                                                          bar=BAR)
    grown_t, at_t = tc.insert_needle(mine, 0.21, 1.9, thickness=2e-3, return_index=True)
    assert at_t == at_j and grown_t.indices == indices
    _close(grown_t.thicknesses, thicknesses)
    with pytest.raises(ValueError):
        tc.insert_needle(mine, 5.0, 1.9)
    stack = tc.Stack([1.4, 2.0, 1.4, 1.4, 2.0], [0.10, 5e-4, 0.15, 0.05, 0.02], SUB)
    for keep, (indices, thicknesses) in zip((None, [1]), cleaned_j):
        cleaned = tc.cleanup(stack, keep_indices=keep)
        assert cleaned.indices == indices
        _close(cleaned.thicknesses, thicknesses)


def _jax_synthesis(stack, terms, materials, kw):
    """The JAX package's needle synthesis: its counts, success, layers and merit."""
    ref = jc.synthesize(stack, terms, materials, **kw)
    return {'n_layers': ref.n_layers, 'iterations': ref.iterations, 'success': ref.success,
            'indices': ref.stack.indices, 'thicknesses': ref.stack.thicknesses,
            'merit': float(ref.merit)}


@pytest.mark.parametrize('materials', [[1.38, 2.05], [2.05, 1.38, 1.7]], ids=['two', 'three'])
def test_synthesize_matches_jax(materials):
    """The same layers from the same start; the thicknesses and merit within 1e-6 (each
    round refines 10 L-BFGS-B iterations, and rounding grows through the rounds)."""
    kw = dict(z_samples=40, max_iters=3, max_layers=8, refine_kwargs={'maxiter': 10})
    mine = tc.synthesize(tc.Stack([1.38, 2.05], [0.10, 0.10], SUB), _ar(tc), materials, **kw)
    ref = jax_ref('synthesize', lambda materials, kw: _jax_synthesis(
        jc.Stack([1.38, 2.05], [0.10, 0.10], SUB), _ar(jc), materials, kw), materials, kw,
        bar=1e-6)
    assert (mine.n_layers, mine.iterations, mine.success) == (ref['n_layers'],
                                                              ref['iterations'], ref['success'])
    assert mine.stack.indices == ref['indices']
    _close(mine.stack.thicknesses, ref['thicknesses'], 1e-6)
    assert mine.merit == pytest.approx(ref['merit'], rel=1e-6)
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


# ---------------------------------------------------------------------------
# the coating design path (steps.build_coating_design)
# ---------------------------------------------------------------------------

SMALL = dict(pairs=4, samples=(8, 24), needle_samples=16,
             needle=dict(z_samples=40, max_layers=8, max_iters=2, refine_kwargs={'maxiter': 15}))


def _rel(a, b):
    a, b = np.asarray(_host(a), np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope='module')
def path_design():
    return steps.build_coating_design(**SMALL, dtype=torch.float64, device='cpu')


def _design_data(design, needle=False):
    """The design's merit terms and start as plain data: (class name, wavelengths, angles,
    polarization, target) a term, and (indices, thicknesses, substrate, ambient)."""
    terms = design.needle_merit if needle else design.merit
    stack = design.needle_start if needle else design.stack0
    return ([(type(t).__name__, np.asarray(t.wvl), np.asarray(t.theta), t.pol, float(t.target))
             for t in terms],
            (stack.indices, _host(stack.thicknesses), stack.substrate_index, stack.ambient_index))


def _jax_design(terms, stack):
    """The design's start and merit terms, built by the JAX package on the port's grids."""
    return jc.Stack(*stack), [getattr(jc, cls)(wvl, theta, pol=pol, target=target)
                              for cls, wvl, theta, pol, target in terms]


def _jax_start(terms, stack):
    stack, terms = _jax_design(terms, stack)
    fj, gj = jc.MeritFunction(terms).value_and_grad(stack)
    return float(fj), gj


def test_design_start_and_merit(path_design):
    assert len(path_design.stack0) == 9
    assert sum(t.wvl.numel() for t in path_design.merit) == 32
    quarter = steps.COATING_WVL0 / (4 * np.asarray(path_design.stack0.indices))
    rng = np.random.default_rng(steps.COATING_SEED)
    np.testing.assert_array_equal(_host(path_design.stack0.thicknesses),
                                  quarter * (1 + steps.COATING_SPREAD * rng.standard_normal(9)))
    mine = path_design.problem()
    f, g = mine.fg(mine.x0())
    fj, gj = jax_ref('design-start', _jax_start, *_design_data(path_design), bar=BAR)
    assert f == pytest.approx(fj, rel=BAR)
    assert _rel(g, gj) <= BAR


def test_design_refine_lbfgsb_matches_jax(path_design):
    """The path's bounded L-BFGS-B refinement, its first 20 iterations against the JAX package's."""
    mine = path_design.refine('lbfgsb', 20)
    _, _, x_next, merit = jax_ref(
        'design-refine', lambda terms, stack, floor: _jax_lbfgsb(
            *_jax_design(terms, stack),
            dict(method='lbfgsb', maxiter=20, min_thickness=floor)),
        *_design_data(path_design), steps.COATING_MIN_THICKNESS, bar=ITERATE_BAR)
    recs_t = mine.optimizer_result.records
    assert len(recs_t) == len(x_next) == 20
    for a, b in zip(recs_t, x_next):
        assert _rel(a.x_next, b) <= ITERATE_BAR
    start = sum(t.value(path_design.stack0) for t in path_design.merit)
    assert mine.merit < 0.6 * start
    assert mine.merit == pytest.approx(merit, rel=ITERATE_BAR)
    assert mine.x.dtype == torch.float64


def test_design_refine_lm_lowers_the_merit_where_jax_raises(path_design):
    start = sum(t.value(path_design.stack0) for t in path_design.merit)
    with pytest.raises(ValueError, match='shape mismatch'):
        jax_ref('design-refine-lm', lambda terms, stack, floor: jc.refine(
            *_jax_design(terms, stack), method='lm', maxiter=10, min_thickness=floor),
            *_design_data(path_design), steps.COATING_MIN_THICKNESS)
    res = path_design.refine('lm', 10)
    assert res.merit < start
    assert float(res.stack.thicknesses.min()) >= steps.COATING_MIN_THICKNESS - 1e-12
    # 2n + 1 residual evaluations an iteration, and the backtracking's
    assert res.optimizer_result.nfev >= res.nit * (2 * 9 + 1)


def test_design_synthesis_matches_jax(path_design):
    mine = path_design.synthesize()
    ref = jax_ref('design-synthesis', lambda terms, stack, materials, kw: _jax_synthesis(
        *_jax_design(terms, stack), materials, kw),
        *_design_data(path_design, needle=True), steps.NEEDLE_MATERIALS, path_design.needle,
        bar=SYNTH_BAR)
    assert (mine.n_layers, mine.iterations) == (ref['n_layers'], ref['iterations'])
    assert mine.stack.indices == ref['indices']
    assert _rel(mine.stack.thicknesses, ref['thicknesses']) <= SYNTH_BAR
    assert mine.merit == pytest.approx(ref['merit'], rel=SYNTH_BAR)
    assert mine.n_layers > 2


def test_design_problem_runs_in_its_precision(path_design):
    """The design's problem evaluates in the path's dtype whatever config says outside."""
    with torch.no_grad():
        config.precision = torch.float32
        try:
            f, g = path_design.problem().fg(path_design.problem().x0())
        finally:
            config.precision = torch.float64
    assert g.dtype == torch.float64
