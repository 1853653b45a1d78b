"""The port's six small instruments against the JAX package: the deformable
mirror, the Shack-Hartmann screen, the PS/PDI and SRI interferometers, the
fiber modes and the Jones calculus.

Float64 on the CPU (``jax_enable_x64``, ``config.precision = 64``), both
packages fed the same numpy inputs.  Bars: 1e-12 relative to the peak for
every field, screen, render, adjoint and gradient (FFT convolutions, matrix
DFTs and bilinear warps, rounded differently by XLA and torch); the fiber
mode solve, host SciPy in both, 1e-14; the Jones matrices 1e-15 absolute.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import prysm_tpu.propagation as jprop
from prysm_tpu.coordinates import make_xy_grid as jgrid, cart_to_polar as jc2p
from prysm_tpu.geometry import circle as jcircle, circle_sdf, antialias, gaussian
from prysm_tpu.x import dm as jdm, fibers as jfib, pdi as jpdi, polarization as jpol
from prysm_tpu.x import shack_hartmann as jsh, sri as jsri

import prysm_tpu_torch.propagation as tprop
from prysm_tpu_torch import interop
from prysm_tpu_torch.conf import config
from prysm_tpu_torch.coordinates import make_xy_grid as tgrid, cart_to_polar as tc2p
from prysm_tpu_torch.geometry import circle as tcircle
from prysm_tpu_torch.x import dm as tdm, fibers as tfib, pdi as tpdi, polarization as tpol
from prysm_tpu_torch.x import shack_hartmann as tsh, sri as tsri

torch.set_num_threads(2)

BAR = 1e-12


@pytest.fixture(autouse=True)
def f64_on_cpu(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# the deformable mirror
# ---------------------------------------------------------------------------

def _ifn(N=128):
    x, y = jgrid(N, diameter=2)
    return np.asarray(gaussian(0.12, x, y))


DM_CASES = {
    'plain': {},
    'folded': dict(rot=(0, 10, 0)),
    'rotated-shifted': dict(rot=(5, 10, 3), shift=(0.3, -0.2)),
    'clocked-shifted': dict(rot=(0, 0, 10), shift=(0.5, 0)),
    'upsampled': dict(upsample=1.5),
    'upsampled-folded': dict(upsample=1.25, rot=(0, 8, 0)),
}


def _dms(case, Nout=96, Nact=8, sep=8):
    ifn = _ifn()
    acts = np.random.default_rng(0).standard_normal((Nact, Nact))
    j = jdm.DM(ifn, Nout=Nout, Nact=Nact, sep=sep, **DM_CASES[case])
    j.update(jnp.asarray(acts))
    t = tdm.DM(ifn, Nout=Nout, Nact=Nact, sep=sep, **DM_CASES[case])
    t.update(acts)
    return t, j, acts


@pytest.mark.parametrize('wfe', [True, False])
@pytest.mark.parametrize('case', list(DM_CASES))
def test_dm_render_and_adjoint_match_jax(case, wfe):
    t, j, _ = _dms(case)
    out_t, out_j = t.render(wfe=wfe), j.render(wfe=wfe)
    assert _rel(out_t, out_j) <= BAR
    assert t.Nintermediate == j.Nintermediate and t.obliquity == j.obliquity
    g = np.random.default_rng(1).standard_normal(out_j.shape)
    assert _rel(t.render_adjoint(_t(g), wfe=wfe), j.render_adjoint(jnp.asarray(g), wfe=wfe)) <= BAR


@pytest.mark.parametrize('Nout', [80, 128, 160])
def test_dm_pads_and_crops_like_jax(Nout):
    t, j, _ = _dms('folded', Nout=Nout)
    assert _rel(t.render(), j.render()) <= BAR
    g = np.random.default_rng(2).standard_normal((Nout, Nout))
    assert _rel(t.render_adjoint(_t(g)), j.render_adjoint(jnp.asarray(g))) <= BAR


@pytest.mark.parametrize('case', list(DM_CASES))
def test_dm_autograd_matches_jax_grad_and_the_inner_product_identity(case):
    """The actuators reach the render through a slice assignment that autograd follows:
    its gradient equals jax.grad's, and <render(a), y> == <a, J^T y> (render is linear)."""
    t, j, acts = _dms(case)
    y = np.random.default_rng(3).standard_normal((96, 96))
    render_t, render_j = t.render_fn(wfe=True), j.render_fn(wfe=True)
    a = _t(acts).requires_grad_(True)
    lhs = torch.sum(render_t(a) * _t(y))
    grad, = torch.autograd.grad(lhs, a)
    grad_j = jax.grad(lambda aa: jnp.sum(render_j(aa) * jnp.asarray(y)))(jnp.asarray(acts))
    assert _rel(grad, grad_j) <= BAR
    assert float(lhs) == pytest.approx(float(torch.sum(a.detach() * grad)), rel=1e-12)


def test_dm_render_adjoint_is_autograds_chain_when_unrotated():
    t, _, acts = _dms('plain')
    target = _t(np.random.default_rng(4).standard_normal((96, 96)))
    a = _t(acts).requires_grad_(True)
    sfe = t.render_fn(wfe=True)(a)
    grad, = torch.autograd.grad(torch.sum((sfe - target) ** 2), a)
    assert _rel(t.render_adjoint(2 * (sfe.detach() - target), wfe=True), grad) <= 1e-13


def test_dm_lattice_projection_update_and_copy_match_jax():
    for Nact, sep in (((8, 6), (8, 10)), ((7, 7), (9, 9))):
        t = tdm.prepare_actuator_lattice((128, 96), Nact, sep, torch.float64, device='cpu')
        j = jdm.prepare_actuator_lattice((128, 96), Nact, sep, jnp.float64)
        assert (t['ixx'], t['iyy']) == (j['ixx'], j['iyy'])
        assert tuple(t['actuators'].shape) == j['actuators'].shape
    for rot in ((0, 10, 0), (3, -7, 12)):
        tf, tr = tdm.prepare_fwd_reverse_projection_coordinates((64, 48), rot, device='cpu')
        jf, jr = jdm.prepare_fwd_reverse_projection_coordinates((64, 48), rot)
        for a, b in zip(tf + tr, jf + jr):
            assert _rel(a, b) <= 1e-14
    t, j, acts = _dms('folded')
    other = t.copy()
    other.update(acts * 2)
    assert _rel(other.render(), j.render() * 2) <= BAR and _rel(t.render(), j.render()) <= BAR


def test_dm_from_numpy_carries_the_jax_dm():
    _, j, acts = _dms('rotated-shifted')
    kw = DM_CASES['rotated-shifted']
    carried = interop.dm_from_numpy(np.asarray(j.ifn), 96, 8, 8, shift=kw['shift'], rot=kw['rot'],
                                    actuators=np.asarray(j.actuators), device='cpu')
    assert carried.actuators.dtype == torch.float64
    assert _rel(carried.render(), j.render()) <= BAR
    assert _rel(carried.tf[0], np.asarray(j.tf[0])) <= 1e-14


# ---------------------------------------------------------------------------
# the Shack-Hartmann screen
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shift', [False, True])
@pytest.mark.parametrize('n', [4, 5, (4, 5)])
def test_shack_hartmann_screens_match_jax(n, shift):
    """Even and odd lenslet counts; the windows overlap and the samples on two
    lenslets' edges take both phases, as the JAX package's loop adds them."""
    xj, yj = jgrid(128, diameter=4)
    xt, yt = tgrid(128, diameter=4, device='cpu')
    got = tsh.shack_hartmann(0.5, n, 10, 0.55, xt, yt, shift=shift)
    want = jsh.shack_hartmann(0.5, n, 10, 0.55, xj, yj, shift=shift)
    assert got.dtype == torch.complex128
    assert _rel(got, want) <= 1e-12


def test_shack_hartmann_shared_edges_and_radial_aperture_match_jax():
    """32 samples a pitch: the edges fall on samples, which take both lenslets' phase;
    a radial aperture takes the (rsq, r=...) call."""
    xj, yj = jgrid(128, diameter=2.2)
    xt, yt = tgrid(128, diameter=2.2, device='cpu')
    pitch = 32 * 2.2 / 128
    for aperture in ((tcircle, jcircle), (None, None)):
        kt = {} if aperture[0] is None else {'aperture': aperture[0]}
        kj = {} if aperture[1] is None else {'aperture': aperture[1]}
        got = tsh.shack_hartmann(pitch, 4, 60.0, 0.55, xt, yt, shift=True, **kt)
        want = jsh.shack_hartmann(pitch, 4, 60.0, 0.55, xj, yj, shift=True, **kj)
        assert _rel(got, want) <= 1e-12


# ---------------------------------------------------------------------------
# the interferometers
# ---------------------------------------------------------------------------

def _pupil(N=64, epd=10.0):
    x, y = jgrid(N, diameter=epd * 1.1)
    r, t = jc2p(x, y)
    dx = float(x[0, 1] - x[0, 0])
    amp = np.asarray(antialias(circle_sdf(epd / 2, r), dx))
    phase = 0.3 * (np.asarray(r) / (epd / 2)) ** 2 * np.cos(2 * np.asarray(t))
    wave = amp * np.exp(1j * phase)
    xt, yt = tgrid(N, diameter=epd * 1.1, device='cpu')
    return (x, y), (xt, yt), wave


PDI_KW = dict(efl=100, epd=10, wavelength=0.55, test_arm_samples=64, pinhole_samples=48,
              grating_rulings=32, test_arm_fov=32, test_arm_offset=32)


@pytest.mark.parametrize('grating', [dict(), dict(grating_type='ronchi'),
                                     dict(grating_axis='y', pinhole_diameter=3.0,
                                          test_arm_transmissivity=0.5)],
                         ids=['sin_amp', 'ronchi', 'y-axis'])
def test_pspdi_forward_model_matches_jax(grating):
    (xj, yj), (xt, yt), wave = _pupil()
    j = jpdi.PSPDI(xj, yj, **PDI_KW, **grating)
    t = tpdi.PSPDI(xt, yt, **PDI_KW, **grating)
    for shift in (0.0, 0.7, -np.pi / 2):
        assert _rel(t.forward_model(_t(wave), phase_shift=shift).data,
                    j.forward_model(jnp.asarray(wave), phase_shift=shift).data) <= BAR
    dt = t.forward_model(_t(wave), phase_shift=0.4, debug=True)
    dj = j.forward_model(jnp.asarray(wave), phase_shift=0.4, debug=True)
    assert _rel(dt['total_field'].data, dj['total_field'].data) <= BAR
    for arm in ('ref', 'test'):
        assert _rel(dt['at_camera'][arm].data, dj['at_camera'][arm].data) <= BAR
        for a, b in zip(dt['at_fpm'][arm], dj['at_fpm'][arm]):
            assert _rel(a.data, b.data) <= BAR
    ratio_t, *_ = tpdi.evaluate_test_ref_arm_matching(dt)
    ratio_j, *_ = jpdi.evaluate_test_ref_arm_matching(dj)
    assert float(ratio_t) == pytest.approx(float(ratio_j), rel=BAR)


def test_rectangle_pulse_matches_jax():
    x = np.linspace(-7, 7, 301)
    for kw in ({}, dict(duty=0.3, amplitude=0.2, offset=0.6, period=1.7)):
        got, want = tpdi.rectangle_pulse(_t(x), **kw), jpdi.rectangle_pulse(jnp.asarray(x), **kw)
        assert got.dtype == torch.float64 and _rel(got, want) == 0


@pytest.mark.parametrize('debug', [False, True])
def test_sri_forward_model_matches_jax(debug):
    (xj, yj), (xt, yt), wave = _pupil()
    j = jsri.SelfReferencedInterferometer(xj, yj, efl=100, epd=10, wavelength=0.55,
                                          fiber_samples=64)
    t = tsri.SelfReferencedInterferometer(xt, yt, efl=100, epd=10, wavelength=0.55,
                                          fiber_samples=64)
    assert _rel(t.Efib, j.Efib) <= 1e-14 and t.dxfib == j.dxfib
    for shift in (0, 0.9):
        got = t.forward_model(_t(wave), phase_shift=shift, debug=debug)
        want = j.forward_model(jnp.asarray(wave), phase_shift=shift, debug=debug)
        if debug:
            for arm in ('ref', 'test'):
                assert _rel(got['at_camera'][arm].data, want['at_camera'][arm].data) <= BAR
        else:
            assert _rel(got.data, want.data) <= BAR


def test_sri_fiber_round_trip_matches_jax():
    (xj, yj), (xt, yt), wave = _pupil()
    j = jsri.SelfReferencedInterferometer(xj, yj, efl=100, epd=10, wavelength=0.55,
                                          fiber_samples=64)
    t = tsri.SelfReferencedInterferometer(xt, yt, efl=100, epd=10, wavelength=0.55,
                                          fiber_samples=64)
    dx = float(xj[0, 1] - xj[0, 0])
    got = tsri.to_photonic_fiber_and_back(tprop.Wavefront(_t(wave), 0.55, dx), 100, t.Efib,
                                          t.dxfib, t.Ifibsum, shift=(1.0, 0), phase_shift=0.3,
                                          return_more=True)
    want = jsri.to_photonic_fiber_and_back(jprop.Wavefront(jnp.asarray(wave), 0.55, dx), 100,
                                           j.Efib, j.dxfib, j.Ifibsum, shift=(1.0, 0),
                                           phase_shift=0.3, return_more=True)
    for a, b in zip(got[:3], want[:3]):
        assert _rel(a.data, b.data) <= BAR
    assert float(got[3]) == pytest.approx(float(want[3]), rel=BAR)
    assert float(tsri.overlap_integral(got[1].data, t.Efib, got[1].intensity.data.sum(),
                                       t.Ifibsum)) == pytest.approx(float(got[3]), rel=1e-14)


# ---------------------------------------------------------------------------
# fibers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('V', [1.5, 2.405, 3.0, 6.5, 10.0, 17.0])
def test_find_all_modes_matches_jax(V):
    t, j = tfib.find_all_modes(V), jfib.find_all_modes(V)
    assert sorted(t) == sorted(j)
    for k in j:
        assert _rel(t[k], j[k]) <= 1e-14
    assert tfib.find_all_modes(V, count_only=True) == jfib.find_all_modes(V, count_only=True)


def test_fiber_scalars_match_jax():
    for name, args in (('critical_angle', (1.46, 1.45)), ('numerical_aperture', (1.46, 1.45)),
                       ('V', (4.1, 0.14, 1.55)), ('marcuse_mfr_from_V', (2.2,)),
                       ('petermann_mfr_from_V', (2.2,))):
        assert getattr(tfib, name)(*args) == getattr(jfib, name)(*args)
    assert tfib.critical_angle(1.46, 1.45, deg=False) == jfib.critical_angle(1.46, 1.45, deg=False)
    np.testing.assert_array_equal(tfib._besselj_positive_zeros(3, 25.0),
                                  jfib._besselj_positive_zeros(3, 25.0))


def test_lp_modes_smf_field_and_overlaps_match_jax():
    xj, yj = jgrid(96, diameter=12)
    rj, tj = jc2p(xj, yj)
    xt, yt = tgrid(96, diameter=12, device='cpu')
    rt, tt = tc2p(xt, yt)
    modes = jfib.find_all_modes(8.0)
    lp_t = tfib.compute_LP_modes(8.0, tfib.find_all_modes(8.0), 2.0, rt, tt)
    lp_j = jfib.compute_LP_modes(8.0, modes, 2.0, rj, tj)
    assert sorted(lp_t) == sorted(lp_j)
    for k in lp_j:
        for a, b in zip(lp_t[k], lp_j[k]):
            assert a.dtype == torch.float64 and _rel(a, b) <= 1e-13
    smf_t, smf_j = tfib.smf_mode_field(2.3, 2.0, 0.5, rt), jfib.smf_mode_field(2.3, 2.0, 0.5, rj)
    assert _rel(smf_t, smf_j) <= 1e-13
    E = smf_t * torch.polar(torch.ones_like(rt), 0.1 * xt)
    Ej = smf_j * jnp.exp(1j * 0.1 * xj)
    assert float(tfib.mode_overlap_integral(lp_t[0][0], E)) == pytest.approx(
        float(jfib.mode_overlap_integral(lp_j[0][0], Ej)), rel=1e-12)
    # efficiencies (of 1): orthogonal modes couple ~0, so the bar is absolute
    ct, cj = tfib.multimode_coupling(E, lp_t), jfib.multimode_coupling(Ej, lp_j)
    for k in cj:
        assert float(np.abs(_np(torch.stack(ct[k])) - np.asarray(cj[k])).max()) <= 1e-13


# ---------------------------------------------------------------------------
# Jones calculus
# ---------------------------------------------------------------------------

def _close_jones(a, b, tol=1e-15):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert float(np.abs(a - b).max()) <= tol


def test_jones_elements_match_jax():
    theta = np.linspace(-1, 1, 5)
    pairs = [
        (tpol.linear_pol_vector(30), jpol.linear_pol_vector(30)),
        (tpol.linear_pol_vector(_t(theta), degrees=False), jpol.linear_pol_vector(
            jnp.asarray(theta), degrees=False)),
        (tpol.circular_pol_vector(), jpol.circular_pol_vector()),
        (tpol.circular_pol_vector('right', shape=(3, 2)),
         jpol.circular_pol_vector('right', (3, 2))),
        (tpol.jones_rotation_matrix(0.3), jpol.jones_rotation_matrix(0.3)),
        (tpol.jones_rotation_matrix(_t(theta)), jpol.jones_rotation_matrix(jnp.asarray(theta))),
        (tpol.jones_rotation_matrix(0.3, shape=(2, 3)), jpol.jones_rotation_matrix(0.3, (2, 3))),
        (tpol.half_wave_plate(0.2), jpol.half_wave_plate(0.2)),
        (tpol.quarter_wave_plate(0.2, shape=(2,)), jpol.quarter_wave_plate(0.2, (2,))),
        (tpol.linear_polarizer(0.4), jpol.linear_polarizer(0.4)),
        (tpol.vector_vortex_retarder(2, _t(theta)),
         jpol.vector_vortex_retarder(2, jnp.asarray(theta))),
        (tpol.vector_vortex_retarder(4, _t(theta), retardance=2.0, rotate=0.3),
         jpol.vector_vortex_retarder(4, jnp.asarray(theta), retardance=2.0, rotate=0.3)),
    ]
    for theta0 in (0, 0.3):
        pairs += [(tpol.linear_retarder(1.0, theta0), jpol.linear_retarder(1.0, theta0)),
                  (tpol.linear_diattenuator(0.4, theta0, shape=(2,)),
                   jpol.linear_diattenuator(0.4, theta0, (2,)))]
    for i in range(4):
        pairs.append((tpol.pauli_spin_matrix(i), jpol.pauli_spin_matrix(i)))
    pairs.append((tpol.pauli_spin_matrix(3, shape=(2,)), jpol.pauli_spin_matrix(3, (2,))))
    for a, b in pairs:
        assert a.dtype == torch.complex128
        _close_jones(a, b)
    for bad in (lambda m: m.linear_diattenuator(1.5), lambda m: m.circular_pol_vector('up'),
                lambda m: m.pauli_spin_matrix(4)):
        for m in (tpol, jpol):
            with pytest.raises(ValueError):
                bad(m)


def test_mueller_kron_and_pauli_match_jax():
    J = np.asarray(jpol.linear_retarder(0.7, 0.2))
    stack = np.stack([J, np.asarray(jpol.linear_diattenuator(0.3, 1.1))])
    for broadcast in (True, False):
        _close_jones(tpol.jones_to_mueller(_t(J), broadcast=broadcast),
                     jpol.jones_to_mueller(jnp.asarray(J), broadcast=broadcast), 1e-15)
    _close_jones(tpol.jones_to_mueller(_t(stack)), jpol.jones_to_mueller(jnp.asarray(stack)))
    _close_jones(tpol.broadcast_kron(_t(stack), _t(stack[::-1])),
                 jpol.broadcast_kron(jnp.asarray(stack), jnp.asarray(stack[::-1])))
    for a, b in zip(tpol.pauli_coefficients(_t(stack)),
                    jpol.pauli_coefficients(jnp.asarray(stack))):
        _close_jones(a, b)


def test_jones_adapter_and_polarization_optic_match_jax():
    (xj, yj), (xt, yt), wave = _pupil(N=32)
    _, tj = jc2p(xj, yj)
    field_j = jpol.apply_polarization_optic(jnp.asarray(wave), jpol.vector_vortex_retarder(2, tj))
    field_t = tpol.apply_polarization_optic(_t(wave), tpol.vector_vortex_retarder(2, _t(tj)))
    assert _rel(field_t, field_j) <= 1e-15
    for name, args in (('focus', (2,)), ('unfocus', (2,)), ('angular_spectrum', (0.55, 0.1, 50.0))):
        got = tpol.jones_adapter(getattr(tprop, name))(field_t, *args)
        want = jpol.jones_adapter(getattr(jprop, name))(field_j, *args)
        assert got.shape == want.shape and _rel(got, want) <= BAR
    wrapped = tpol.jones_adapter(tprop.focus)
    assert tpol.jones_adapter(wrapped) is wrapped
    assert _rel(wrapped(field_t[..., 0, 0], 2), tprop.focus(field_t[..., 0, 0], 2)) == 0


def test_add_jones_propagation_patches_the_port(monkeypatch):
    for name in tpol.supported_propagation_funcs:
        monkeypatch.setattr(tprop, name, getattr(tprop, name))
    tpol.add_jones_propagation()
    assert all(getattr(tprop, n)._jones_adapted for n in tpol.supported_propagation_funcs)
    (_, _), (xt, yt), wave = _pupil(N=32)
    polarizer = tpol.linear_polarizer(0.3) * torch.ones(32, 32, 1, 1, dtype=torch.complex128)
    J = tpol.apply_polarization_optic(_t(wave), polarizer)
    out = tprop.focus(J, 2)
    assert out.shape == (64, 64, 2, 2)
    assert _rel(out[..., 0, 1], tprop.focus.__wrapped__(J[..., 0, 1], 2)) <= 1e-15


def test_public_names_match_jax():
    for t, j in ((tpol, jpol), (tfib, jfib), (tsri, jsri), (tpdi, jpdi), (tdm, jdm), (tsh, jsh)):
        names = [n for n in vars(j) if not n.startswith('_') and callable(getattr(j, n))
                 and getattr(getattr(j, n), '__module__', None) == j.__name__]
        assert names and all(hasattr(t, n) for n in names), (j.__name__, names)
