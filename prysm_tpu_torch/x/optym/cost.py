"""Figures of merit returning ``(cost, gradient)``.

Counterpart of ``prysm_tpu/x/optym/cost.py``.  Every cost is written as a
pure scalar torch function and the gradient comes from autograd — exact
(the bias/gain invariant error's fit coefficients drop out of the
derivative by the envelope theorem).

Masks select a subset of pixels; gradients scatter back to the full grid
(``index_put``).
"""
import functools

import numpy as onp
import torch

__all__ = ['bias_and_gain_invariant_error', 'mean_square_error', 'negative_loglikelihood']


def _grad_pair(scalar_fn):
    """Wrap a scalar-valued f(M, D) into (cost, dcost/dM) with mask support."""

    def value_and_grad(M, D):
        M = M.detach().requires_grad_(True)
        with torch.enable_grad():
            cost = scalar_fn(M, D)
        grad, = torch.autograd.grad(cost, M)
        return cost.detach(), grad

    @functools.wraps(scalar_fn)
    def wrapped(M, D, mask=None):
        if hasattr(M, 'dtype') and hasattr(D, 'dtype') and M.dtype != D.dtype:
            raise TypeError(
                f'{scalar_fn.__name__}: input dtype mismatch; first array is '
                f'{M.dtype}, second is {D.dtype}; cast one to match before calling')
        M = torch.as_tensor(M)
        if mask is None:
            return value_and_grad(M, D)
        sel = torch.as_tensor(onp.asarray(mask) if not torch.is_tensor(mask) else mask,
                              device=M.device)
        D_sel = torch.as_tensor(D, device=M.device)[sel] if getattr(D, 'ndim', 0) else D
        cost, partial = value_and_grad(M[sel], D_sel)
        full = torch.zeros(M.shape, dtype=partial.dtype, device=M.device)
        return cost, full.index_put((sel,), partial)

    return wrapped


@_grad_pair
def bias_and_gain_invariant_error(I, D):  # NOQA
    """Error between I and D, invariant to overall bias and gain in I."""
    I0 = I - I.mean()
    D0 = D - D.mean()
    gain = (I0 * D0).sum() / (I0 * I0).sum()
    bias = D.mean() - gain * I.mean()
    misfit = gain * I + bias - D
    return (misfit * misfit).sum() / (D * D).sum()


@_grad_pair
def mean_square_error(M, D):
    """Mean square error between model M and data D."""
    delta = M - D
    return (delta * delta).mean()


@_grad_pair
def negative_loglikelihood(y, yhat):
    """Mean negative log-likelihood of Bernoulli data yhat under model y."""
    per_pixel = yhat * torch.log(y) + (1 - yhat) * torch.log(1 - y)
    return -per_pixel.mean()
