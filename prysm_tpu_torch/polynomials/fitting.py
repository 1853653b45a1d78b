"""Mode summation and fitting (counterpart of ``prysm_tpu/polynomials/fitting.py``).

Masking is done with weights (a mask as a float), as in the JAX package,
so every operation has a static shape: ``lstsq`` zeroes the NaN points of
the normal equations instead of compressing them out.
"""
import numpy as np
import torch

from ..conf import to_tensor

__all__ = ['sum_of_2d_modes', 'sum_of_2d_modes_adjoint', 'hopkins', 'lstsq',
           'normalize_modes', 'orthogonalize_modes']


def _flat_mask(mask, like):
    """The mask as a flat boolean tensor on like's device."""
    m = mask if torch.is_tensor(mask) else torch.as_tensor(np.asarray(mask))
    return m.reshape(-1).to(like.device) != 0


def _stack(modes):
    """A mode stack from a tensor, an array or a list of mode arrays."""
    if isinstance(modes, (list, tuple)):
        return torch.stack([to_tensor(m) for m in modes])
    return to_tensor(modes)


def sum_of_2d_modes(modes, weights):
    """Weighted sum of a mode stack: (k, m, n) x (..., k) -> (..., m, n)."""
    modes = _stack(modes)
    weights = torch.as_tensor(weights, dtype=modes.dtype, device=modes.device)
    return torch.tensordot(weights, modes, dims=([-1], [0]))


def sum_of_2d_modes_adjoint(modes, databar):
    """Adjoint of sum_of_2d_modes w.r.t. weights: contract modes with databar."""
    return torch.tensordot(_stack(modes).to(databar.dtype), databar, dims=([1, 2], [-2, -1]))


def hopkins(a, b, c, r, t, H):
    """Hopkins' aberration expansion W_abc; negative a selects the sine term."""
    t = to_tensor(t)
    c1 = torch.sin(abs(a) * t) if a < 0 else torch.cos(a * t)
    return c1 * (r ** b) * (H ** c)


def lstsq(modes, data):
    """Least-squares fit of modes to data; NaN data points are ignored.

    Solves the weighted normal equations, with the NaN points' weights
    zero, as the JAX package does (static shapes).  The (k, k) Gram matrix
    is one matmul under the process's matmul precision
    (``conf.set_matmul_precision``; full float32 unless it asks for TF32).
    """
    modes = _stack(modes)
    M = modes.reshape(modes.shape[0], -1)         # (k, P)
    d = to_tensor(data).reshape(-1).to(M.dtype)   # (P,)
    w = torch.isfinite(d)
    Mw = M * w                                    # ignored pixels zeroed
    A = Mw @ M.T                                  # (k, k)
    b = Mw @ torch.where(w, d, torch.zeros_like(d))
    return torch.linalg.solve(A, b)


def _mode_norms(modes, mask, to='std'):
    """Each mode's RMS ('std') or PV ('ptp') over the mask; under 1e-9 (piston) reads 1.

    The scale ``normalize_modes`` divides by: a (k,) tensor for a (k, m, n)
    stack.
    """
    flat = modes.reshape(modes.shape[0], -1)
    m = _flat_mask(mask, flat)
    if to == 'std':
        # torch's reductions sum pairwise (a tree on the card); a float32
        # matrix-vector product on the CPU sums each row in one running
        # accumulator, whose error grows with the pixel count
        # (probes/freeform_cpu_probe.py compares the two)
        w = m.to(flat.dtype)
        n = torch.sum(w)
        mean = torch.sum(flat * w, dim=1) / n
        norms = torch.sqrt(torch.sum((flat - mean[:, None]) ** 2 * w, dim=1) / n)
    elif to == 'ptp':
        norms = (torch.amax(torch.where(m, flat, -torch.inf), dim=1)
                 - torch.amin(torch.where(m, flat, torch.inf), dim=1))
    else:
        raise ValueError(f"to must be 'std' or 'ptp', got {to}")
    return torch.where(norms < 1e-9, torch.ones_like(norms), norms)


def normalize_modes(modes, mask, to='std'):
    """Scale modes to unit RMS (to='std') or unit PV (to='ptp') over mask."""
    modes = _stack(modes)
    squeeze = modes.ndim == 2
    if squeeze:
        modes = modes[None]
    out = modes * (1 / _mode_norms(modes, mask, to))[:, None, None]
    return out[0] if squeeze else out


def orthogonalize_modes(modes, mask):
    """Gram-Schmidt (QR) orthogonalization of modes over a mask.

    Zeroing the masked-out pixels before QR gives the inner products of
    compressing them away; the columns of Q are zero outside the mask, to
    rounding.
    Signs follow sign(diag(R)), so LAPACK and cuSOLVER give one basis.
    """
    modes = _stack(modes)
    k = modes.shape[0]
    basis = modes.reshape(k, -1) * _flat_mask(mask, modes)  # (k, P), zero outside mask
    Q, R = torch.linalg.qr(basis.T)
    Qmod = Q * torch.sign(torch.diagonal(R))
    return Qmod.T.reshape(modes.shape)
