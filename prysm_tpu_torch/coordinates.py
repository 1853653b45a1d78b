"""Coordinate grids, conversions, homographies, and warping.

Counterpart of ``prysm_tpu/coordinates.py``.  Interpolation (warp, polar
resampling) is a differentiable four-point bilinear gather, as in the JAX
package.  Functions on tensors follow their inputs' dtype and device;
constructors take ``dtype`` (default ``config.precision``) and ``device``
(default ``config.device``).  Small matrices are built on the host in
numpy, as in the JAX package.
"""
import numpy as np
import torch

from .conf import config, numpy_dtype, resolve_device, to_tensor
from .fttools import fftrange

__all__ = ['optimize_xy_separable', 'broadcast_1d_to_2d', 'cart_to_polar',
           'polar_to_cart', 'make_xy_grid', 'sample_axis', 'promote_3d_point',
           'make_rotation_matrix', 'coerce_3d_rotation', 'apply_tilt_decenter',
           'promote_3d_transformation_to_homography',
           'promote_affine_transformation_to_homography',
           'make_homomorphic_translation_matrix', 'drop_z_3d_transformation',
           'pack_xy_to_homographic_points', 'apply_homography',
           'solve_for_planar_homography', 'warp', 'uniform_cart_to_polar',
           'resample_2d', 'distort_annular_grid', 'chebygauss_quadrature_xy']


def _tensor(a, dtype=None, device=None):
    """A host array as a tensor of ``dtype`` (default config.precision) on ``device``."""
    return torch.as_tensor(np.asarray(a), dtype=config.precision if dtype is None else dtype,
                           device=resolve_device(device))


def optimize_xy_separable(x, y):
    """Reduce 2D x, y grids to broadcastable 1D row/column vectors."""
    if x.ndim == 2:
        return x[0, :], y[:, 0][:, None]
    return x.reshape(1, -1), y.reshape(-1, 1)


def broadcast_1d_to_2d(x, y):
    """Broadcast two (x, y) vectors to 2D grids."""
    shpx = (y.numel(), x.numel())
    return torch.broadcast_to(x, shpx), torch.broadcast_to(y[:, None], shpx)


def cart_to_polar(x, y, vec_to_grid=True):
    """(rho, phi) polar coordinates of the (x, y) input points.

    Python numbers take ``config.precision`` on ``config.device``; 1-D
    tensors (``vec_to_grid``) give the grid of their outer product.
    """
    if vec_to_grid and hasattr(x, 'ndim') and x.ndim == 1:
        y = y[:, None]
        x = x[None, :]
    x, y = to_tensor(x), to_tensor(y)
    return torch.hypot(x, y), torch.atan2(y, x)


def polar_to_cart(rho, phi):
    """(x, y) cartesian coordinates of the (rho, phi) input points."""
    phi = to_tensor(phi)
    return rho * torch.cos(phi), rho * torch.sin(phi)


def make_xy_grid(shape, *, dx=0, diameter=0, grid=True, host=False, dtype=None, device=None):
    """Create an FFT-aligned x, y grid with given spacing or diameter.

    Samples sit at fftrange(n) * dx: the zero-coordinate sample is at index
    n//2.  ``dtype`` defaults to ``config.precision``, ``device`` to
    ``config.device``.  ``host=True`` returns numpy grids of the same
    values, computed as the JAX package's host grids are: host-side
    planners (composite apertures) take them.
    """
    if not isinstance(shape, tuple):
        shape = (shape, shape)
    if diameter != 0:
        dx = diameter / max(shape)
    if dtype is None:
        dtype = config.precision
    if host:
        npdtype = numpy_dtype(dtype)
        y, x = (np.fft.fftshift(np.fft.fftfreq(s, 1 / s)).astype(npdtype) * dx
                for s in shape)
        if grid:
            x, y = np.meshgrid(x, y)
        return x, y
    dev = resolve_device(device)
    y, x = (fftrange(s, dtype=dtype, device=dev) * dx for s in shape)
    if grid:
        y, x = torch.meshgrid(y, x, indexing='ij')
    return x, y


def sample_axis(distribution, lo, hi, n, dtype=None, generator=None, device=None):
    """Samples between two endpoints under a named distribution.

    'random' draws from ``generator`` (a ``torch.Generator``, required),
    where the JAX package takes a ``jax.random`` key.
    """
    if dtype is None:
        dtype = config.precision
    dev = resolve_device(device)
    if n == 1:
        return torch.tensor([(lo + hi) / 2.0], dtype=dtype, device=dev)
    distribution = distribution.lower()
    if distribution == 'uniform':
        return torch.linspace(lo, hi, n, dtype=dtype, device=dev)
    if distribution == 'random':
        if generator is None:
            raise ValueError("distribution 'random' requires a torch.Generator")
        u = torch.rand(n, generator=generator, dtype=dtype, device=generator.device)
        return (lo + (hi - lo) * u).to(dev)
    if distribution == 'cheby':
        nodes = np.cos(np.arange(n) * np.pi / (n - 1))
        return _tensor((lo + hi) / 2.0 - (hi - lo) / 2.0 * nodes, dtype, dev)
    raise ValueError(f'unknown distribution {distribution!r}; '
                     "expected 'uniform', 'random', or 'cheby'")


def promote_3d_point(P, dtype=None, device=None):
    """Coerce a scalar or trailing-coordinate iterable into a 3-vector."""
    if not hasattr(P, '__iter__'):
        return _tensor([0, 0, P], dtype, device)
    P = list(P)
    if not 1 <= len(P) <= 3:
        raise ValueError('P must contain one to three coordinates')
    out = [0.0, 0.0, 0.0]
    out[-len(P):] = P
    return _tensor(out, dtype, device)


def make_rotation_matrix(zyx, radians=False, host=False, dtype=None, device=None):
    """3x3 rotation matrix from (Z, Y, X) Euler angles, built on the host.

    ``host=True`` returns the numpy matrix in the working precision.
    """
    ZYX = np.zeros(3)
    ZYX[:len(zyx)] = zyx
    if not radians:
        ZYX = np.radians(ZYX)
    gamma, beta, alpha = ZYX
    c1, c2, c3 = np.cos(alpha), np.cos(beta), np.cos(gamma)
    s1, s2, s3 = np.sin(alpha), np.sin(beta), np.sin(gamma)
    Rx = np.asarray([[1, 0, 0], [0, c1, -s1], [0, s1, c1]])
    Ry = np.asarray([[c2, 0, s2], [0, 1, 0], [-s2, 0, c2]])
    Rz = np.asarray([[c3, -s3, 0], [s3, c3, 0], [0, 0, 1]])
    out = Rx @ Ry @ Rz
    if host:
        return out.astype(numpy_dtype(config.precision if dtype is None else dtype))
    return _tensor(out, dtype, device)


def coerce_3d_rotation(R):
    """None, a supplied rotation matrix, or a matrix from (Z,Y,X) Euler angles."""
    if isinstance(R, (list, tuple)):
        return make_rotation_matrix(R)
    return R


def apply_tilt_decenter(P, R, tilt=None, decenter=None, tilt_radians=False, dtype=None):
    """Combine a base 3D position and rotation with tilt/decenter offsets."""
    if dtype is None:
        dtype = P.dtype
    if decenter is not None:
        decenter = torch.as_tensor(decenter, dtype=dtype, device=P.device)
        if decenter.shape != (3,):
            raise ValueError(
                f'decenter must be a length-3 vector, got shape {tuple(decenter.shape)}')
        P = P + decenter
    if tilt is not None:
        R_tilt = make_rotation_matrix(tilt, radians=tilt_radians, dtype=dtype, device=P.device)
        R = R_tilt if R is None else R @ R_tilt
    return P, R


def promote_3d_transformation_to_homography(M, dtype=None, device=None):
    """3x3 transformation -> 4x4 homography."""
    out = np.zeros((4, 4))
    out[:3, :3] = np.asarray(M)
    out[3, 3] = 1
    return _tensor(out, dtype, device)


def promote_affine_transformation_to_homography(Maff, dtype=None, device=None):
    """2x3 affine transformation -> 3x3 homography."""
    out = np.zeros((3, 3))
    out[:2, :3] = np.asarray(Maff)
    out[2, 2] = 1
    return _tensor(out, dtype, device)


def make_homomorphic_translation_matrix(tx=0, ty=0, tz=0, dtype=None, device=None):
    """4x4 homography translating (x, y, z) by (tx, ty, tz)."""
    out = np.eye(4)
    out[0, -1] = tx
    out[1, -1] = ty
    out[2, -1] = tz
    return _tensor(out, dtype, device)


def drop_z_3d_transformation(M):
    """Drop the Z row/column of a 4x4 homography -> 3x3 (x, y, w)."""
    keep = [0, 1, 3]
    return M[keep][:, keep]


def pack_xy_to_homographic_points(x, y):
    """Pack (x, y) arrays into a 3xN homogeneous-coordinate matrix."""
    xr = torch.ravel(x)
    return torch.stack([xr, torch.ravel(y), torch.ones_like(xr)], dim=0)


def apply_homography(M, x, y):
    """Apply a 3x3 homography to (x, y) point arrays."""
    xp, yp, w = M @ pack_xy_to_homographic_points(x, y)
    xp = xp / w
    yp = yp / w
    if x.ndim > 1:
        xp = xp.reshape(x.shape)
        yp = yp.reshape(x.shape)
    return xp, yp


def solve_for_planar_homography(src, dst, dtype=None, device=None):
    """Planar homography H with H * src = dst (normalized DLT), solved on the host."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    if src.ndim != 2 or src.shape[-1] != 2 or src.shape != dst.shape:
        raise ValueError('src and dst must be matching (N, 2) point sets')
    if src.shape[0] < 4:
        raise ValueError('the DLT needs at least four correspondences')

    def normalize(points):
        # Hartley conditioning: centroid to the origin, mean radius sqrt(2)
        center = points.mean(axis=0)
        spread = np.hypot(*(points - center).T).mean()
        if spread == 0:
            raise ValueError('points must not all coincide')
        s = np.sqrt(2) / spread
        T = np.array([[s, 0.0, -s * center[0]],
                      [0.0, s, -s * center[1]],
                      [0.0, 0.0, 1.0]])
        return (points - center) * s, T

    srcn, Tsrc = normalize(src)
    dstn, Tdst = normalize(dst)
    # each correspondence gives an x row [-p1, 0, x2 p1] and a y row
    # [0, -p1, y2 p1]; row order does not change the nullspace
    p1 = np.column_stack((srcn, np.ones(len(srcn))))
    zero = np.zeros_like(p1)
    A = np.concatenate([
        np.concatenate([-p1, zero, dstn[:, :1] * p1], axis=1),
        np.concatenate([zero, -p1, dstn[:, 1:] * p1], axis=1),
    ], axis=0)
    if np.linalg.matrix_rank(A) < 8:
        raise ValueError('point configuration is degenerate')
    Hn = np.linalg.svd(A)[2][-1].reshape(3, 3)
    H = np.linalg.inv(Tdst) @ Hn @ Tsrc
    w = H[2, 2]
    H = H / (w if abs(w) > np.finfo(H.dtype).eps else np.linalg.norm(H))
    return _tensor(H, dtype, device)


def _bilinear_lookup(img, rows, cols):
    """Differentiable bilinear sample of img at fractional (row, col) points.

    Points outside [0, N-1] on either axis return exactly 0 (the whole
    sample, no partial blending), as scipy's map_coordinates with
    mode='constant', cval=0 does.
    """
    nr, nc = img.shape[-2:]
    inside = (rows >= 0) & (rows <= nr - 1) & (cols >= 0) & (cols <= nc - 1)
    r0 = torch.floor(rows)
    c0 = torch.floor(cols)
    fr = rows - r0
    fc = cols - c0
    r0 = r0.long()
    c0 = c0.long()

    def gather(ri, ci):
        return img[..., torch.clamp(ri, 0, nr - 1), torch.clamp(ci, 0, nc - 1)]

    top = gather(r0, c0) * (1 - fc) + gather(r0, c0 + 1) * fc
    bot = gather(r0 + 1, c0) * (1 - fc) + gather(r0 + 1, c0 + 1) * fc
    out = top * (1 - fr) + bot * fr
    return torch.where(inside, out, torch.zeros_like(out))


def warp(img, xnew, ynew):
    """Warp an image by "pull" (dst -> src) lookup with bilinear interpolation."""
    return _bilinear_lookup(img, ynew, xnew)


def uniform_cart_to_polar(x, y, data):
    """Interpolate uniformly-sampled cartesian data onto a polar grid.

    Returns (rho, phi, f(rho, phi)); bilinear interpolation.
    """
    x, y = optimize_xy_separable(x, y)
    xv = x.ravel()
    yv = y.ravel()
    _max = float(torch.stack([xv[0], xv[-1], yv[0], yv[-1]]).abs().max())
    rho = torch.linspace(0, _max, xv.numel(), dtype=xv.dtype, device=xv.device)
    phi = torch.linspace(0, 2 * np.pi, yv.numel(), dtype=xv.dtype, device=xv.device)
    rv, pv = torch.meshgrid(rho, phi, indexing='xy')
    xq, yq = polar_to_cart(rv, pv)
    cols = (xq - xv[0]) / (xv[1] - xv[0])
    rows = (yq - yv[0]) / (yv[1] - yv[0])
    return rho, phi, _bilinear_lookup(data, rows, cols)


def resample_2d(array, sample_pts, query_pts, kind='linear'):
    """Resample a 2D array from uniform sample_pts onto query_pts grids (bilinear).

    sample_pts/query_pts are (x, y) 1D vector pairs; only uniform source
    grids are supported.
    """
    x, y = sample_pts
    xq, yq = query_pts
    xq2, yq2 = torch.meshgrid(xq, yq, indexing='xy')
    cols = (xq2 - x[0]) / (x[1] - x[0])
    rows = (yq2 - y[0]) / (y[1] - y[0])
    return _bilinear_lookup(array, rows, cols)


def distort_annular_grid(r, eps):
    """Distort an annular grid so the annulus [eps, 1] maps to the unit disk."""
    return (r - eps) * (1 / (1 - eps))


def chebygauss_quadrature_xy(rings, radius=1, spokes=-1, center=(0, 0), dtype=None,
                             device=None):
    """Chebyshev-Gauss quadrature sampling of a polar grid (Forbes spiral).

    Built on the host; returns the (x, y) sample points as tensors.
    """
    if spokes == -1:
        spokes = 2 * rings + 1
    n = rings
    radii = [(0.5 + 0.5 * np.cos(((2 * k - 1) / (2 * n)) * np.pi)) * radius
             for k in range(1, n + 1)]
    psi = (5 ** 0.5 + 1) / 2
    o_x = np.empty(spokes * len(radii))
    o_y = np.empty(spokes * len(radii))
    lower = 0
    for k, rr in enumerate(radii):
        Delta = 2 * np.pi / spokes
        j = np.arange(1, spokes + 1, dtype=np.float64)
        t = (j + ((k + 1) / psi)) * Delta
        o_x[lower:lower + spokes] = rr * np.cos(t)
        o_y[lower:lower + spokes] = rr * np.sin(t)
        lower += spokes
    return _tensor(o_x + center[0], dtype, device), _tensor(o_y + center[1], dtype, device)
