"""The port's checkerboard shift-fold identities against their naive shift forms.

The counterpart of ``tests/test_shift_identities.py`` for
``prysm_tpu_torch.propagation.fft``: the pruned and sign-folded focus,
unfocus and adjoints must equal the plain fftshift/ifftshift sandwich,
including the odd-size fallbacks.  float64 on the CPU; bars as in that
file (1e-12, 1e-11 for the pruned adjoints).
"""
import numpy as np
import pytest
import torch

from prysm_tpu_torch.fttools import crop_center, pad2d
from prysm_tpu_torch.propagation.fft import focus, unfocus, focus_adjoint, unfocus_adjoint

torch.set_num_threads(2)

_AX = (-2, -1)


def _sandwich(x, inverse):
    fn = torch.fft.ifft2 if inverse else torch.fft.fft2
    return torch.fft.fftshift(fn(torch.fft.ifftshift(x, dim=_AX), dim=_AX, norm='ortho'),
                              dim=_AX)


def _naive(E, Q, inverse=False):
    return _sandwich(pad2d(E, Q) if Q != 1 else E, inverse)


def _rand_complex(shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape) + 1j * rng.normal(size=shape))


def _close(a, b, tol=1e-12):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize('N', [16, 64])
@pytest.mark.parametrize('Q', [1, 2, 3])
def test_focus_matches_naive_shift_sandwich(N, Q):
    E = _rand_complex((N, N))
    _close(focus(E, Q), _naive(E, Q))


@pytest.mark.parametrize('N', [16, 64])
@pytest.mark.parametrize('Q', [1, 2])
def test_unfocus_matches_naive_shift_sandwich(N, Q):
    E = _rand_complex((N, N), seed=1)
    _close(unfocus(E, Q), _naive(E, Q, inverse=True))


@pytest.mark.parametrize('N', [15, 17])
def test_odd_sizes_fall_back_to_shifts(N):
    E = _rand_complex((N, N), seed=2)
    _close(focus(E, 1), _naive(E, 1))
    _close(unfocus(E, 1), _naive(E, 1, inverse=True))


@pytest.mark.parametrize('N, Q', [(16, 2), (32, 2), (16, 3)])
def test_pruned_adjoints_match_naive(N, Q):
    X = _rand_complex((N * Q, N * Q), seed=3)
    _close(focus_adjoint(X, Q), crop_center(_sandwich(X, True), (N, N)), 1e-11)
    _close(unfocus_adjoint(X, Q), crop_center(_sandwich(X, False), (N, N)), 1e-11)


def test_batched_leading_axes_survive_the_fold():
    E = _rand_complex((3, 16, 16), seed=4)
    _close(focus(E, 2), _naive(E, 2))
    _close(focus(E, 1), _naive(E, 1))


def test_focus_gradient_is_focus_adjoint():
    """Autograd through the pruned, sign-folded focus gives its explicit adjoint."""
    E = _rand_complex((16, 16), seed=5).requires_grad_(True)
    G = _rand_complex((32, 32), seed=6)
    torch.sum(torch.real(torch.conj(G) * focus(E, 2))).backward()
    _close(E.grad, focus_adjoint(G, 2))
