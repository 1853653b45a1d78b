"""The port's segmented apertures against the JAX package's.

Both packages plan from the same numpy grid (``make_xy_grid(host=True)``)
in float64 on the CPU.  The planning is host bookkeeping and elementwise
SDF arithmetic, so the hexagonal aperture's windows, segment ids,
centers, local grids, masks and amplitude are held equal exactly; the
Zernike bases (a recurrence on hypot/atan2 grids), the composed OPD and
its coefficient gradient to 1e-9 relative.  cfg3's geometry (2 rings of
0.4 mm segments 7 um apart on a grid 2.4 mm across) at 128^2 and 127^2,
and a flat-top, partly excluded variant.  The keystone aperture at 96^2
and 95^2: its windows and ids equal, its masks to 1e-12 absolute, because
they ramp hypot(x, y) and test atan2(y, x), whose implementations in XLA
and in torch differ in the last bit, and the ramp divides by dx.  The JAX
package's keystone aperture is read from its record (``_jax_refs``) where it
is current.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _jax_refs import jax_ref
from prysm_tpu import segmented as jseg
from prysm_tpu.coordinates import make_xy_grid as jax_make_xy_grid
from prysm_tpu.polynomials import zernike_nm_seq as jax_zernike_nm_seq

from prysm_tpu_torch import interop, segmented as seg
from prysm_tpu_torch.coordinates import make_xy_grid
from prysm_tpu_torch.polynomials import zernike_nm_seq

torch.set_num_threads(2)

NMS = ((0, 0), (1, -1), (1, 1))
HEX_CASES = {
    'cfg3-128': (128, dict()),
    'cfg3-127': (127, dict()),
    'flat-top-excluded': (128, dict(segment_angle=0, exclude=(0, 3, 11))),
}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _grid(n, diameter=2.4):
    x, y = make_xy_grid(n, diameter=diameter, host=True, dtype=torch.float64)
    jx, jy = jax_make_xy_grid(n, diameter=diameter, host=True)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    return x, y


def _hex(case):
    n, kw = HEX_CASES[case]
    x, y = _grid(n)
    jcha = jseg.CompositeHexagonalAperture(x, y, 2, 0.4, 0.007, **kw)
    cha = seg.CompositeHexagonalAperture(x, y, 2, 0.4, 0.007, device='cpu', **kw)
    return jcha, cha


def _coefs(nseg, seed=7):
    return np.random.default_rng(seed).normal(scale=20.0, size=(nseg, len(NMS)))


def test_hex_arithmetic_matches_jax():
    for ring in range(0, 5):
        assert seg.hex_ring(ring) == [seg.Hex(*h) for h in jseg.hex_ring(ring)]
    h1, h2 = seg.Hex(1, -2, 1), seg.Hex(-3, 1, 2)
    for name in ('add_hex', 'sub_hex', 'mul_hex'):
        assert getattr(seg, name)(h1, h2) == tuple(getattr(jseg, name)(h1, h2))
    assert seg.scale_hex(h1, 3) == tuple(jseg.scale_hex(h1, 3))
    for rot in (0, 90):
        assert seg.hex_to_xy(h2, 0.23, rot) == jseg.hex_to_xy(h2, 0.23, rot)
    assert [seg.hex_neighbor(h1, d) for d in range(8)] == \
           [tuple(jseg.hex_neighbor(h1, d)) for d in range(8)]


@pytest.mark.parametrize('case', HEX_CASES)
def test_hex_aperture_plan_equals_jax(case):
    jcha, cha = _hex(case)
    assert cha.segment_ids == jcha.segment_ids
    assert cha.windows == jcha.windows
    assert cha.vtov == jcha.vtov
    np.testing.assert_array_equal(np.asarray(cha.all_centers), np.asarray(jcha.all_centers))
    for (x, y), (jx, jy) in zip(cha.local_coords, jcha.local_coords):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    for m, jm in zip(cha.local_masks, jcha.local_masks):
        np.testing.assert_array_equal(m.numpy(), jm)
    np.testing.assert_array_equal(cha.amp.numpy(), jcha.amp)
    assert cha.amp.dtype == torch.float64 and float(cha.amp.sum()) > 0


def test_hex_aperture_refuses_other_angles():
    x, y = _grid(32)
    with pytest.raises(ValueError, match='cartesian'):
        seg.CompositeHexagonalAperture(x, y, 1, 0.4, 0.007, segment_angle=45, device='cpu')


@pytest.mark.parametrize('case', HEX_CASES)
def test_compose_opd_and_its_gradient_match_jax(case):
    jcha, cha = _hex(case)
    grids, bases = cha.prepare_opd_bases(zernike_nm_seq, NMS)
    jgrids, jbases = jcha.prepare_opd_bases(jax_zernike_nm_seq, NMS)
    assert len(bases) == len(jbases)
    for b, jb in zip(bases, jbases):
        assert _rel(b.numpy(), jb) < 1e-9
    for (r, t), (jr, jt) in zip(grids, jgrids):
        assert _rel(r.numpy(), jr) < 1e-12 and _rel(t.numpy(), jt) < 1e-12
    c = _coefs(len(cha.segment_ids))
    opd = cha.compose_opd(torch.from_numpy(c))
    assert _rel(opd.numpy(), jcha.compose_opd(jnp.asarray(c))) < 1e-9
    # a weighted loss: its coefficient gradient, by autograd and by jax.grad
    w = np.random.default_rng(1).standard_normal(opd.shape)
    ct = torch.from_numpy(c).requires_grad_(True)
    grad, = torch.autograd.grad(torch.sum(cha.compose_opd(ct) * torch.from_numpy(w)), ct)
    jgrad = jax.grad(lambda q: jnp.sum(jcha.compose_opd(q) * w))(jnp.asarray(c))
    assert _rel(grad.numpy(), jgrad) < 1e-9


def test_compose_opd_adds_onto_out_without_touching_it():
    jcha, cha = _hex('cfg3-128')
    cha.prepare_opd_bases(zernike_nm_seq, NMS)
    jcha.prepare_opd_bases(jax_zernike_nm_seq, NMS)
    c = _coefs(len(cha.segment_ids), 2)
    out = torch.full(cha.amp.shape, 3.0, dtype=torch.float64, requires_grad=True)
    total = cha.compose_opd(torch.from_numpy(c), out=out)
    assert torch.equal(out.detach(), torch.full_like(out.detach(), 3.0))
    want = jcha.compose_opd(jnp.asarray(c), out=jnp.full(cha.amp.shape, 3.0))
    assert _rel(total.detach().numpy(), want) < 1e-9
    g, = torch.autograd.grad(total.sum(), out)
    assert torch.equal(g, torch.ones_like(g))


def test_xy_basis_and_normalization_radius_match_jax():
    def monomials(orders, x, y):
        return [x ** i * y ** j for i, j in orders]

    jcha, cha = _hex('cfg3-127')
    orders = ((0, 0), (1, 0), (0, 1), (1, 1))
    _, bases = cha.prepare_opd_bases(monomials, orders, normalization_radius=(0.2, 0.25))
    _, jbases = jcha.prepare_opd_bases(monomials, orders, normalization_radius=(0.2, 0.25))
    for b, jb in zip(bases, jbases):
        assert _rel(b.numpy(), jb) < 1e-12
    c = np.random.default_rng(3).standard_normal((len(cha.segment_ids), len(orders)))
    assert _rel(cha.compose_opd(torch.from_numpy(c)).numpy(),
                jcha.compose_opd(jnp.asarray(c))) < 1e-9


def test_interop_aperture_composes_the_jax_opd():
    jcha, _ = _hex('flat-top-excluded')
    jcha.prepare_opd_bases(jax_zernike_nm_seq, NMS)
    carried = interop.composite_aperture_from_numpy(
        jcha.amp, jcha.windows, jcha.local_masks, [np.asarray(b) for b in jcha.opd_bases],
        jcha.segment_ids, device='cpu')
    c = _coefs(len(jcha.segment_ids), 4)
    assert _rel(carried.compose_opd(torch.from_numpy(c)).numpy(),
                jcha.compose_opd(jnp.asarray(c))) < 1e-12
    np.testing.assert_array_equal(carried.amp.numpy(), jcha.amp)


KEYSTONE = dict(center_circle_diameter=0.5, rings=2, ring_radius=0.35,
                segments_per_ring=(6, 9), radial_gap=0.02, rotation_per_ring=(10.0, None))


KEYSTONE_PLAN = ('segment_ids', 'segment_windows', 'center_window', 'amp', 'center_mask',
                 'segment_masks', 'segment_rotations')


def _jax_keystone(x, y, cc, sc):
    """The JAX package's keystone aperture: its plan, its OPD bases, and its OPD composed
    from the coefficients ``cc`` (centre) and ``sc`` (segments)."""
    jka = jseg.CompositeKeystoneAperture(x, y, **KEYSTONE)
    plan = {k: getattr(jka, k) for k in KEYSTONE_PLAN}
    jka.prepare_opd_bases(jax_zernike_nm_seq, NMS, jax_zernike_nm_seq, NMS)
    return plan, jka.opd_bases, jka.compose_opd(jnp.asarray(cc), jnp.asarray(sc))


@pytest.mark.parametrize('n', [96, 95])
def test_keystone_aperture_matches_jax(n):
    x, y = _grid(n, diameter=2.2)
    ka = seg.CompositeKeystoneAperture(x, y, device='cpu', **KEYSTONE)
    cc = np.random.default_rng(5).standard_normal(len(NMS))
    sc = np.random.default_rng(6).standard_normal((len(ka.segment_ids), len(NMS)))
    jka, bases, opd = jax_ref('keystone', _jax_keystone, x, y, cc, sc, bar=1e-12)
    assert ka.segment_ids == jka['segment_ids']
    assert ka.segment_windows == jka['segment_windows']
    assert ka.center_window == jka['center_window']
    assert np.abs(ka.amp.numpy() - jka['amp']).max() < 1e-12
    assert np.abs(ka.center_mask.numpy() - jka['center_mask']).max() < 1e-12
    for m, jm in zip(ka.segment_masks, jka['segment_masks']):
        assert np.abs(m.numpy() - jm).max() < 1e-12
    assert ka.segment_rotations == jka['segment_rotations']
    ka.prepare_opd_bases(zernike_nm_seq, NMS, zernike_nm_seq, NMS)
    for b, jb in zip(ka.opd_bases, bases):
        assert _rel(b.numpy(), jb) < 1e-9
    assert _rel(ka.compose_opd(torch.from_numpy(cc), torch.from_numpy(sc)).numpy(), opd) < 1e-9
