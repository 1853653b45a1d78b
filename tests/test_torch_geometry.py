"""The port's geometry, coordinates and psf modules against the JAX package's.

Same numpy grids through both packages on the CPU in float64, on even and
odd, square and non-square grids.  Bars: 1e-12 absolute on signed
distances, masks and coverage (elementwise arithmetic; hypot and atan2
differ in the last bit between XLA and torch), 1e-12 relative on
interpolated and analytic values, equal on host-built matrices, index
math and boolean masks away from ties.  The JAX package's interpolation and
PSF sizes are read from their records (``_jax_refs``) where they are current.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _jax_refs import jax_ref
from prysm_tpu import coordinates as jco
from prysm_tpu import geometry as jgeo
from prysm_tpu import psf as jpsf

from prysm_tpu_torch import coordinates as co
from prysm_tpu_torch import geometry as geo
from prysm_tpu_torch import psf

torch.set_num_threads(2)

SHAPES = {'even': (32, 32), 'odd-rect': (31, 36)}


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol


def _grids(shape):
    x, y = co.make_xy_grid(shape, diameter=2.2, dtype=torch.float64, device='cpu')
    jx, jy = jco.make_xy_grid(shape, diameter=2.2)
    _close(x, jx, 0.0)
    return x, y, jx, jy


SDFS = {
    'circle': lambda m, x, y: m.circle_sdf(0.7, m.cart_to_polar(x, y)[0]),
    'annulus': lambda m, x, y: m.annulus_sdf(0.3, 0.8, m.cart_to_polar(x, y)[0]),
    'rectangle': lambda m, x, y: m.rectangle_sdf(0.5, x, y, height=0.3),
    'rectangle-90': lambda m, x, y: m.rectangle_sdf(0.5, x, y, height=0.3, angle=90),
    'rectangle-30': lambda m, x, y: m.rectangle_sdf(0.5, x, y, height=0.3, angle=30),
    'ellipse': lambda m, x, y: m.rotated_ellipse_sdf(0.8, 0.4, x, y, major_axis_angle=25),
    'hexagon': lambda m, x, y: m.regular_polygon_sdf(6, 0.6, x, y, center=(0.1, -0.05),
                                                     rotation=15),
    'triangle': lambda m, x, y: m.polygon_sdf([(0, 0.6), (0.5, -0.4), (-0.5, -0.3)], x, y),
    'spider': lambda m, x, y: m.spider_sdf(4, 0.05, x, y, rotation=10, center=(0.02, 0)),
    'fillets': lambda m, x, y: m.rectangle_with_corner_fillets_sdf(0.6, 0.4, 0.1, x, y,
                                                                   center=(0.05, 0)),
    'fillets-rot': lambda m, x, y: m.rectangle_with_corner_fillets_sdf(0.6, 0.4, 0.1, x, y,
                                                                       rotation=20),
    'csg': lambda m, x, y: m.subtract(m.union(m.circle_sdf(0.7, m.cart_to_polar(x, y)[0]),
                                              m.rectangle_sdf(0.9, x, y, height=0.1)),
                                      m.intersect(m.circle_sdf(0.2, m.cart_to_polar(x, y)[0]),
                                                  m.rectangle_sdf(0.3, x, y))),
}


class _Both:
    """One namespace over a geometry module and its coordinates module."""

    def __init__(self, geometry, coordinates):
        self.g, self.c = geometry, coordinates

    def __getattr__(self, name):
        return getattr(self.g if hasattr(self.g, name) else self.c, name)


TORCH, JAX = _Both(geo, co), _Both(jgeo, jco)


@pytest.mark.parametrize('shape', SHAPES.values(), ids=SHAPES.keys())
@pytest.mark.parametrize('name', SDFS)
def test_signed_distances_and_coverage_match_jax(name, shape):
    x, y, jx, jy = _grids(shape)
    d, jd = SDFS[name](TORCH, x, y), SDFS[name](JAX, jx, jy)
    _close(d, jd)
    dx = 2.2 / max(shape)
    _close(geo.antialias(d, dx), jgeo.antialias(jd, dx))


@pytest.mark.parametrize('shape', SHAPES.values(), ids=SHAPES.keys())
def test_masks_match_jax(shape):
    x, y, jx, jy = _grids(shape)
    r, jr = co.cart_to_polar(x, y)[0], jco.cart_to_polar(jx, jy)[0]
    pairs = [
        (geo.circle(0.7, r), jgeo.circle(0.7, jr)),
        (geo.annulus(0.3, 0.81, r), jgeo.annulus(0.3, 0.81, jr)),
        (geo.rectangle(0.5, x, y, height=0.33), jgeo.rectangle(0.5, jx, jy, height=0.33)),
        (geo.rotated_ellipse(0.8, 0.4, x, y, 25), jgeo.rotated_ellipse(0.8, 0.4, jx, jy, 25)),
        (geo.regular_polygon(5, 0.6, x, y), jgeo.regular_polygon(5, 0.6, jx, jy)),
        (geo.spider(3, 0.07, x, y, rotation=5), jgeo.spider(3, 0.07, jx, jy, rotation=5)),
        (geo.offset_circle(0.3, x, y, (0.2, -0.1)), jgeo.offset_circle(0.3, jx, jy, (0.2, -0.1))),
        (geo.rectangle_with_corner_fillets(0.6, 0.4, 0.1, x, y),
         jgeo.rectangle_with_corner_fillets(0.6, 0.4, 0.1, jx, jy)),
        (geo.square(x, y), jgeo.square(jx, jy)),
    ]
    for mine, theirs in pairs:
        np.testing.assert_array_equal(np.broadcast_to(mine.numpy(), np.shape(theirs)), theirs)
    _close(geo.gaussian(0.5, x, y, center=(0.1, 0)), jgeo.gaussian(0.5, jx, jy, center=(0.1, 0)))
    with pytest.raises(ValueError, match='major'):
        geo.rotated_ellipse_sdf(0.2, 0.4, x, y)


@pytest.mark.parametrize('shape', SHAPES.values(), ids=SHAPES.keys())
def test_multisample_matches_jax(shape):
    x, y, jx, jy = _grids(shape)
    cover = geo.multisample(lambda a, b: (a * a + 2 * b * b) < 0.4, x, y, samples=4)
    jcover = jgeo.multisample(lambda a, b: (a * a + 2 * b * b) < 0.4, jx, jy, samples=4)
    _close(cover, jcover)
    assert 0 < float(cover.mean()) < 1


def test_polygon_sdf_takes_numpy_on_the_host():
    x, y = co.make_xy_grid((20, 24), dx=0.07, host=True, dtype=torch.float64)
    d = geo.regular_polygon_sdf(6, 0.5, x, y, rotation=90)
    assert isinstance(d, np.ndarray)
    np.testing.assert_array_equal(d, np.asarray(jgeo.regular_polygon_sdf(6, 0.5, x, y,
                                                                        rotation=90)))
    np.testing.assert_array_equal(geo.antialias(d, 0.07), np.asarray(jgeo.antialias(d, 0.07)))


def test_grid_helpers_match_jax():
    x, y = co.make_xy_grid((6, 5), dx=0.5, host=True, dtype=torch.float32)
    jx, jy = jco.make_xy_grid((6, 5), dx=0.5, host=True)
    assert x.dtype == np.float32
    np.testing.assert_array_equal(x, np.asarray(jx, dtype=np.float32))
    xv, yv = co.make_xy_grid((6, 5), dx=0.5, grid=False, dtype=torch.float64, device='cpu')
    jxv, jyv = jco.make_xy_grid((6, 5), dx=0.5, grid=False)
    _close(xv, jxv, 0.0)
    _close(yv, jyv, 0.0)
    X, Y = co.broadcast_1d_to_2d(xv, yv)
    jX, jY = jco.broadcast_1d_to_2d(jxv, jyv)
    _close(X, jX, 0.0)
    _close(Y, jY, 0.0)
    for a, b in zip(co.optimize_xy_separable(X, Y), jco.optimize_xy_separable(jX, jY)):
        _close(a, b, 0.0)
    for a, b in zip(co.optimize_xy_separable(xv, yv), jco.optimize_xy_separable(jxv, jyv)):
        _close(a, b, 0.0)
    r = torch.linspace(0.1, 1.0, 7, dtype=torch.float64)
    _close(co.distort_annular_grid(r, 0.2), jco.distort_annular_grid(jnp.asarray(r.numpy()), 0.2))
    for a, b in zip(co.chebygauss_quadrature_xy(4, 1.5, center=(0.1, 0.2), dtype=torch.float64,
                                                device='cpu'),
                    jco.chebygauss_quadrature_xy(4, 1.5, center=(0.1, 0.2))):
        _close(a, b)
    for dist in ('uniform', 'cheby'):
        _close(co.sample_axis(dist, -1.0, 2.0, 9, dtype=torch.float64, device='cpu'),
               jco.sample_axis(dist, -1.0, 2.0, 9))
    _close(co.sample_axis('uniform', 0.0, 1.0, 1, dtype=torch.float64, device='cpu'), [0.5])
    gen = torch.Generator().manual_seed(0)
    u = co.sample_axis('random', 2.0, 3.0, 50, dtype=torch.float64, generator=gen, device='cpu')
    assert 2.0 <= float(u.min()) and float(u.max()) <= 3.0
    with pytest.raises(ValueError, match='Generator'):
        co.sample_axis('random', 0.0, 1.0, 3, device='cpu')


def test_three_d_and_homography_helpers_match_jax():
    kw = dict(dtype=torch.float64, device='cpu')
    _close(co.make_rotation_matrix((10, -20, 30), **kw), jco.make_rotation_matrix((10, -20, 30)))
    _close(co.make_rotation_matrix((0.1, 0.2), radians=True, host=True, dtype=torch.float64),
           jco.make_rotation_matrix((0.1, 0.2), radians=True, host=True))
    R0 = co.make_rotation_matrix((5, 6, 7), **kw)
    assert co.coerce_3d_rotation(None) is None and co.coerce_3d_rotation(R0) is R0
    for P in (2.5, (1.0, 2.0), (1.0, 2.0, 3.0)):
        _close(co.promote_3d_point(P, **kw), jco.promote_3d_point(P))
    with pytest.raises(ValueError):
        co.promote_3d_point((1, 2, 3, 4), **kw)
    P, R = co.apply_tilt_decenter(co.promote_3d_point(1.0, **kw), None, tilt=(5, 0, 2),
                                  decenter=(0.1, 0.2, 0.3))
    jP, jR = jco.apply_tilt_decenter(jco.promote_3d_point(1.0), None, tilt=(5, 0, 2),
                                     decenter=(0.1, 0.2, 0.3))
    _close(P, jP)
    _close(R, jR)
    M = np.arange(9.0).reshape(3, 3)
    H4 = co.promote_3d_transformation_to_homography(M, **kw)
    _close(H4, jco.promote_3d_transformation_to_homography(M))
    _close(co.drop_z_3d_transformation(H4), jco.drop_z_3d_transformation(jnp.asarray(H4.numpy())))
    _close(co.promote_affine_transformation_to_homography(M[:2], **kw),
           jco.promote_affine_transformation_to_homography(M[:2]))
    _close(co.make_homomorphic_translation_matrix(1, 2, 3, **kw),
           jco.make_homomorphic_translation_matrix(1, 2, 3))
    src = np.array([[0, 0], [1, 0], [1, 1], [0, 1], [0.5, 0.3]])
    dst = src @ np.array([[1.1, 0.1], [-0.2, 0.9]]) + [0.3, -0.1]
    dst[:, 0] /= 1 + 0.05 * src[:, 0]
    H = co.solve_for_planar_homography(src, dst, **kw)
    _close(H, jco.solve_for_planar_homography(src, dst))
    x, y = np.meshgrid(np.linspace(-1, 1, 5), np.linspace(-1, 1, 4))
    for a, b in zip(co.apply_homography(H, torch.from_numpy(x), torch.from_numpy(y)),
                    jco.apply_homography(jnp.asarray(H.numpy()), jnp.asarray(x), jnp.asarray(y))):
        _close(a, b)
    pts = co.pack_xy_to_homographic_points(torch.from_numpy(x), torch.from_numpy(y))
    _close(pts, jco.pack_xy_to_homographic_points(jnp.asarray(x), jnp.asarray(y)), 0.0)
    with pytest.raises(ValueError, match='four'):
        co.solve_for_planar_homography(src[:3], dst[:3])


def _jax_interpolation(shape, img, xn, yn, xs, ys, xq, yq):
    """The JAX package's warp, polar resampling and 2-D resampling of ``img``."""
    jx, jy = jco.make_xy_grid(shape, diameter=2.2)
    return (jco.warp(jnp.asarray(img), jnp.asarray(xn), jnp.asarray(yn)),
            jco.uniform_cart_to_polar(jx, jy, jnp.asarray(img)),
            jco.resample_2d(jnp.asarray(img), (jnp.asarray(xs), jnp.asarray(ys)),
                            (jnp.asarray(xq), jnp.asarray(yq))))


@pytest.mark.parametrize('shape', SHAPES.values(), ids=SHAPES.keys())
def test_interpolation_matches_jax(shape):
    x, y, jx, jy = _grids(shape)
    img = np.random.default_rng(1).random(shape)
    rng = np.random.default_rng(2)
    xn = rng.uniform(-3, shape[1] + 2, shape)
    yn = rng.uniform(-3, shape[0] + 2, shape)
    xs, ys = x[0, :], y[:, 0]
    xq, yq = xs[::2] * 0.9, ys[::3] * 0.8
    warped, polar, resampled = jax_ref('interpolation', _jax_interpolation, shape, img, xn, yn,
                                       *(a.numpy() for a in (xs, ys, xq, yq)), bar=1e-12)
    _close(co.warp(torch.from_numpy(img), torch.from_numpy(xn), torch.from_numpy(yn)), warped)
    for a, b in zip(co.uniform_cart_to_polar(x, y, torch.from_numpy(img)), polar):
        _close(a, b)
    _close(co.resample_2d(torch.from_numpy(img), (xs, ys), (xq, yq)), resampled)
    # differentiable: the gather's gradient reaches the image
    t = torch.from_numpy(img).requires_grad_(True)
    g, = torch.autograd.grad(co.warp(t, torch.from_numpy(xn), torch.from_numpy(yn)).sum(), t)
    assert float(g.sum()) > 0


def _airy(shape, dx=0.5, fno=8.0, wvl=0.55):
    y, x = np.meshgrid(*((np.arange(s) - s // 2) * dx for s in shape), indexing='ij')
    r = np.hypot(x, y)
    return np.array(jpsf.airydisk(jnp.asarray(r), fno, wvl)), r


SIZES = ('fwhm', 'one_over_e', 'one_over_e_sq')


def _jax_psf_sizes(shape, criteria):
    """The Airy PSF of ``shape``, its three sizes and its size at 0.3, in the JAX package."""
    data, _ = _airy(shape)
    sizes = [float(getattr(jpsf, fn)(jnp.asarray(data), dx=0.5, criteria=criteria))
             for fn in SIZES]
    return data, sizes, float(jpsf.estimate_size(jnp.asarray(data), 0.3, dx=0.5,
                                                 criteria=criteria))


@pytest.mark.parametrize('criteria', ['first', 'last'])
@pytest.mark.parametrize('shape', [(48, 48), (47, 50)], ids=['even', 'odd-rect'])
def test_psf_sizes_match_jax(shape, criteria):
    data, sizes, at_03 = jax_ref('psf-sizes', _jax_psf_sizes, shape, criteria, bar=1e-12)
    for fn, theirs in zip(SIZES, sizes):
        mine = getattr(psf, fn)(torch.from_numpy(data), dx=0.5, criteria=criteria)
        assert float(mine) == pytest.approx(float(theirs), rel=1e-12)
    mine = psf.estimate_size(torch.from_numpy(data), 0.3, dx=0.5, criteria=criteria)
    assert float(mine) == pytest.approx(float(at_03), rel=1e-12)
    with pytest.raises(ValueError, match='metric'):
        psf.estimate_size(torch.from_numpy(data), 'half', dx=0.5)


def test_centroid_autocrop_and_airy_match_jax():
    data, r = _airy((40, 44))
    data = np.roll(data, (3, -5), axis=(0, 1))
    for unit in ('spatial', 'pixels'):
        for a, b in zip(psf.centroid(torch.from_numpy(data), 0.5, unit),
                        jpsf.centroid(jnp.asarray(data), 0.5, unit)):
            assert float(a) == pytest.approx(float(b), rel=1e-12)
    for px in (16, 60):
        _close(psf.autocrop(torch.from_numpy(data), px), jpsf.autocrop(jnp.asarray(data), px), 0.0)
    rt = torch.from_numpy(r)
    for fn in ('airydisk', 'airydisk_efield', 'airydisk_ft'):
        a = getattr(psf, fn)(rt / 40 if fn == 'airydisk_ft' else rt, 8.0, 0.55)
        b = getattr(jpsf, fn)(jnp.asarray(r / 40 if fn == 'airydisk_ft' else r), 8.0, 0.55)
        _close(a, b)
    assert psf.AIRYDATA == jpsf.AIRYDATA
