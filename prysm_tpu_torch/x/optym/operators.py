"""Differentiable spatial operators (counterpart of ``prysm_tpu/x/optym/operators.py``)."""
import torch

__all__ = ['SpatialGradient2D']


class SpatialGradient2D:
    """Forward-difference spatial partial derivatives and their adjoints."""

    def forward_x(self, x):
        """X spatial gradient of a 2D array."""
        assert x.ndim == 2, 'This operator only works on 2D arrays.'
        out = torch.zeros_like(x)
        out[:, 1:-1] = x[:, 2:] - x[:, 1:-1]
        return out

    def adjoint_x(self, xbar):
        """Adjoint of forward_x."""
        assert xbar.ndim == 2, 'This operator only works on 2D arrays.'
        out = torch.zeros_like(xbar)
        out[:, 1:-1] -= xbar[:, 1:-1]
        out[:, 2:] += xbar[:, 1:-1]
        return out

    def forward_y(self, x):
        """Y spatial gradient of a 2D array."""
        assert x.ndim == 2, 'This operator only works on 2D arrays.'
        out = torch.zeros_like(x)
        out[1:-1, :] = x[2:, :] - x[1:-1, :]
        return out

    def adjoint_y(self, xbar):
        """Adjoint of forward_y."""
        assert xbar.ndim == 2, 'This operator only works on 2D arrays.'
        out = torch.zeros_like(xbar)
        out[1:-1, :] -= xbar[1:-1, :]
        out[2:, :] += xbar[1:-1, :]
        return out
