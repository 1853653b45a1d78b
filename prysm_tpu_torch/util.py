"""Statistics of the finite elements of a tensor, by masked reductions.

Counterpart of ``prysm_tpu/util.py``.  Non-finite values are masked out
with ``torch.where`` and counted, not compressed out by boolean indexing:
the shapes stay static, nothing is read back to the host, and the sums run
in the same order as the JAX package's.
"""
import torch

from .conf import config, to_tensor

__all__ = ['mean', 'pv', 'rms', 'Sa', 'std', 'ecdf', 'sort_xy']


def mean(array):
    """Mean of the finite elements of an array."""
    m = torch.isfinite(array)
    return torch.sum(torch.where(m, array, 0)) / torch.sum(m)


def pv(array):
    """Peak-to-valley of the finite elements of an array."""
    m = torch.isfinite(array)
    return (torch.max(torch.where(m, array, -torch.inf))
            - torch.min(torch.where(m, array, torch.inf)))


def rms(array):
    """RMS of the finite elements of an array."""
    m = torch.isfinite(array)
    return torch.sqrt(torch.sum(torch.where(m, array * array, 0)) / torch.sum(m))


def Sa(array):
    """Sa (mean absolute deviation) of the finite elements of an array."""
    m = torch.isfinite(array)
    n = torch.sum(m)
    mu = torch.sum(torch.where(m, array, 0)) / n
    return torch.sum(torch.where(m, torch.abs(array - mu), 0)) / n


def std(array):
    """Standard deviation (ddof 0) of the finite elements of an array."""
    m = torch.isfinite(array)
    n = torch.sum(m)
    mu = torch.sum(torch.where(m, array, 0)) / n
    return torch.sqrt(torch.sum(torch.where(m, (array - mu) ** 2, 0)) / n)


def ecdf(x):
    """Empirical cumulative distribution function: (sorted x, cdf values)."""
    xs = torch.sort(to_tensor(x)).values
    n = xs.shape[0]
    dtype = xs.dtype if xs.is_floating_point() else config.precision
    return xs, torch.arange(1, n + 1, dtype=dtype, device=xs.device) / float(n)


def sort_xy(x, y):
    """Sort a pair of iterables in order of ascending x (stable)."""
    x, y = to_tensor(x), to_tensor(y)
    order = torch.argsort(x, stable=True)
    return x[order], y[order]
