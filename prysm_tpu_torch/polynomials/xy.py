"""XY monomials x^m y^n (counterpart of ``prysm_tpu/polynomials/xy.py``).

Sums on a Cartesian grid evaluate through separable power tables and two
matmuls (y_powers.T @ C @ x_powers).
"""
import numpy as np
import torch

from ..conf import to_tensor
from ..coordinates import optimize_xy_separable
from ._recurrence import coef_vector, grid_zeros

__all__ = ['xy', 'xy_seq', 'xy_der_x', 'xy_der_y', 'xy_der_xy', 'xy_der_x_seq', 'xy_der_y_seq',
           'xy_der_xy_seq', 'xy_sum', 'xy_sum_der_xy', 'xy_j_to_mn']


def xy_j_to_mn(j):
    """Convert a mono-index j into the (m, n) powers; j=1 is piston."""
    if j < 1:
        raise ValueError('j must be >= 1')
    if j == 1:
        return 0, 0
    # the diagonal (total order) of the triangular index layout, then the
    # offset of j within that diagonal splits into the y and x powers
    order = int(np.ceil((np.sqrt(8 * j + 1) - 3) / 2))
    n = j - (order * (order + 1) // 2 + 1)
    return order - n, n


def _sep(x, y, cartesian_grid):
    """Separable-optimize the grid when it is a plain cartesian product."""
    x, y = to_tensor(x), to_tensor(y)
    return optimize_xy_separable(x, y) if cartesian_grid else (x, y)


def xy(m, n, x, y, cartesian_grid=True):
    """XY monomial x^m * y^n."""
    x, y = _sep(x, y, cartesian_grid)
    return x ** m * y ** n


def xy_der_x(m, n, x, y, cartesian_grid=True):
    """d/dx of x^m y^n = m x^(m-1) y^n (0 when m == 0)."""
    x, y = _sep(x, y, cartesian_grid)
    if m == 0:
        return grid_zeros(x, y)
    return m * x ** (m - 1) * y ** n


def xy_der_y(m, n, x, y, cartesian_grid=True):
    """d/dy of x^m y^n = n x^m y^(n-1) (0 when n == 0)."""
    x, y = _sep(x, y, cartesian_grid)
    if n == 0:
        return grid_zeros(x, y)
    return n * x ** m * y ** (n - 1)


def xy_der_xy(m, n, x, y, cartesian_grid=True):
    """d2/dxdy of x^m y^n = m n x^(m-1) y^(n-1) (0 when m or n == 0)."""
    x, y = _sep(x, y, cartesian_grid)
    if m == 0 or n == 0:
        return grid_zeros(x, y)
    return (m * n) * x ** (m - 1) * y ** (n - 1)


def _monomial_seq(maxk, z):
    """[z^0, z^1, ..., z^maxk] as a list (cumulative products)."""
    out = [torch.ones_like(z)]
    for _ in range(maxk):
        out.append(out[-1] * z)
    return out


def _monomial_der_seq(maxk, z):
    """[0, 1, 2z, ..., maxk z^(maxk-1)] as a list."""
    powers = _monomial_seq(maxk - 1, z) if maxk else []
    return [torch.zeros_like(z)] + [k * p for k, p in enumerate(powers, 1)]


def _xy_seq_with(mns, x, y, cartesian_grid, x_powers_op, y_powers_op):
    mns2 = np.asarray(mns)
    maxm, maxn = (int(v) for v in np.max(mns2, axis=0))
    x, y = to_tensor(x), to_tensor(y)
    if cartesian_grid and x.ndim > 1:
        x, y = optimize_xy_separable(x, y)
    x_seq = x_powers_op(maxm, x)
    y_seq = y_powers_op(maxn, y)
    shape = torch.broadcast_shapes(x.shape, y.shape)
    return torch.stack([torch.broadcast_to(x_seq[m] * y_seq[n], shape) for m, n in mns2])


def xy_seq(mns, x, y, cartesian_grid=True):
    """XY monomials at (m, n) pairs; shape (len(mns), *grid.shape)."""
    return _xy_seq_with(mns, x, y, cartesian_grid, _monomial_seq, _monomial_seq)


def xy_der_x_seq(mns, x, y, cartesian_grid=True):
    """d/dx of the XY monomial seq."""
    return _xy_seq_with(mns, x, y, cartesian_grid, _monomial_der_seq, _monomial_seq)


def xy_der_y_seq(mns, x, y, cartesian_grid=True):
    """d/dy of the XY monomial seq."""
    return _xy_seq_with(mns, x, y, cartesian_grid, _monomial_seq, _monomial_der_seq)


def xy_der_xy_seq(mns, x, y, cartesian_grid=True):
    """Mixed d2/dxdy of the XY monomial seq."""
    return _xy_seq_with(mns, x, y, cartesian_grid, _monomial_der_seq, _monomial_der_seq)


def _monomial_table(maxk, z):
    """(maxk+1, len(z)) tensor of powers z^0..z^maxk."""
    return torch.stack(_monomial_seq(maxk, z.reshape(-1)))


def _xy_coefficient_matrices(coefs, mns, like):
    """Sparse XY coefficients packed into dense host power tables, as like's dtype and device."""
    mns2 = np.asarray(mns)
    m, n = mns2[:, 0], mns2[:, 1]
    coefs = np.asarray(coefs, dtype=np.float64)
    mat = np.zeros((n.max() + 1, m.max() + 1))
    dx_mat, dy_mat = np.zeros_like(mat), np.zeros_like(mat)
    np.add.at(mat, (n, m), coefs)
    hx = m > 0
    np.add.at(dx_mat, (n[hx], m[hx] - 1), coefs[hx] * m[hx])
    hy = n > 0
    np.add.at(dy_mat, (n[hy] - 1, m[hy]), coefs[hy] * n[hy])
    return tuple(torch.as_tensor(a, dtype=like.dtype, device=like.device)
                 for a in (mat, dx_mat, dy_mat))


def _xy_sum_cartesian(coefs, mns, x, y, with_derivatives):
    x, y = optimize_xy_separable(x, y)
    mns2 = np.asarray(mns)
    maxm, maxn = (int(v) for v in np.max(mns2, axis=0))
    x_powers = _monomial_table(maxm, x)
    y_powers = _monomial_table(maxn, y)
    mat, dx_mat, dy_mat = _xy_coefficient_matrices(coefs, mns2, x_powers)
    z = y_powers.T @ mat @ x_powers
    if not with_derivatives:
        return z
    return z, y_powers.T @ dx_mat @ x_powers, y_powers.T @ dy_mat @ x_powers


def xy_sum(coefs, mns, x, y, cartesian_grid=True):
    """Weighted sum of XY monomials."""
    mns = tuple(mns)
    x, y = to_tensor(x), to_tensor(y)
    if not mns:
        return torch.zeros_like(x)
    if cartesian_grid and x.ndim > 1:
        return _xy_sum_cartesian(coefs, mns, x, y, with_derivatives=False)
    modes = xy_seq(mns, x, y, cartesian_grid=cartesian_grid)
    return torch.tensordot(coef_vector(coefs, modes), modes, dims=1)


def xy_sum_der_xy(coefs, mns, x, y, cartesian_grid=True):
    """Weighted XY sum and its Cartesian first derivatives."""
    mns = tuple(mns)
    x, y = to_tensor(x), to_tensor(y)
    if not mns:
        z = torch.zeros_like(x)
        return z, z, torch.zeros_like(y)
    if cartesian_grid and x.ndim > 1:
        return _xy_sum_cartesian(coefs, mns, x, y, with_derivatives=True)
    modes = xy_seq(mns, x, y, cartesian_grid=cartesian_grid)
    dx_modes = xy_der_x_seq(mns, x, y, cartesian_grid=cartesian_grid)
    dy_modes = xy_der_y_seq(mns, x, y, cartesian_grid=cartesian_grid)
    c = coef_vector(coefs, modes)
    return (torch.tensordot(c, modes, dims=1), torch.tensordot(c, dx_modes, dims=1),
            torch.tensordot(c, dy_modes, dims=1))
