"""Finite-difference Jacobians of scalar merits over lens free vectors.

Counterpart of ``prysm_tpu/x/raytracing/sensitivity.py``.
"""
import numpy as np


def central_difference(probe, base, h):
    """(probe(base + h), probe(base - h))."""
    return float(probe(base + h)), float(probe(base - h))


def fd_jacobian(f, x, step=1e-6, mask=None):
    """Central-difference gradient of scalar f over vector x.

    Steps are relative (``step * |x_i|``, floored at ``step``); masked-out
    entries keep a zero gradient.
    """
    x = np.asarray(x, dtype=np.float64)
    grad = np.zeros(x.size, dtype=np.float64)
    live = range(x.size) if mask is None else np.flatnonzero(mask)
    for i in live:
        center = float(x[i])
        h = step * (abs(center) or 1.0)

        def probe(value, slot=i):
            bumped = x.copy()
            bumped[slot] = value
            return f(bumped)

        hi, lo = central_difference(probe, center, h)
        grad[i] = (hi - lo) / (2.0 * h)
    return grad


def merit_jacobian_free(dofs, merit, method='fd', step=1e-6):
    """Gradient of a scalar merit w.r.t. a system's dense free vector.

    ``dofs`` is the DesignState (pack/update); it is restored before return
    even if the merit raises.
    """
    if method != 'fd':
        raise ValueError(f"method must be 'fd', got {method!r}")
    frozen = dofs.pack()

    def objective(x):
        dofs.update(x)
        return float(merit())

    try:
        return fd_jacobian(objective, frozen, step=step)
    finally:
        dofs.update(frozen)


__all__ = ['central_difference', 'fd_jacobian', 'merit_jacobian_free']
