"""Mode summation (counterpart of ``prysm_tpu/polynomials/fitting.py``, the main path's part)."""
import torch

__all__ = ['sum_of_2d_modes', 'sum_of_2d_modes_adjoint']


def sum_of_2d_modes(modes, weights):
    """Weighted sum of a mode stack: (k, m, n) x (..., k) -> (..., m, n)."""
    weights = torch.as_tensor(weights, dtype=modes.dtype, device=modes.device)
    return torch.tensordot(weights, modes, dims=([-1], [0]))


def sum_of_2d_modes_adjoint(modes, databar):
    """Adjoint of sum_of_2d_modes w.r.t. weights: contract modes with databar."""
    return torch.tensordot(modes.to(databar.dtype), databar, dims=([1, 2], [-2, -1]))
