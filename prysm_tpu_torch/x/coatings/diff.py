"""Gradients for coating merits by torch autograd.

Counterpart of ``prysm_tpu/x/coatings/diff.py``.  A :class:`ForwardEval`
runs the transfer-matrix forward pass once with the thicknesses as an
autograd leaf; ``thickness_gradient`` is one backward pass of a seeded
scalar through that graph, kept for further seeds.  ``index_gradient``
re-evaluates with the real parts of the layer indices as the leaf.

Cotangent convention: a complex cotangent c_z pairs as
dF = Re(conj(c_z) dz), as in the JAX package.  torch's gradient of a real
scalar with respect to a complex leaf is that c_z already (for |z|^2 it is
2z), while ``jax.grad`` returns its conjugate (2 conj(z)).  So where the JAX
package conjugates its gradient once (``assembly_cotangent``,
``layer_cotangents``), the port takes torch's as it comes.
"""
import math

import torch

from ...conf import config

from .stack import (
    _Evaluation,
    _char_matrix,
    _complex,
    _identity_row,
    _layer_matrices,
    _prefix_products,
    _rtEH,
    _stacked,
    _suffix_products,
)

__all__ = [
    'ForwardEval',
    'forward_eval',
    'char_matrix_vjp',
    'assembly_cotangent',
    'layer_cotangents',
    'thickness_gradient',
    'index_gradient',
]


class ForwardEval:
    """Cached forward evaluation of a stack at one (wvl, theta, pol) grid.

    Per-layer quantities (``ns``, ``costs``, ``dbeta_dd``, ``betas``,
    ``etas``, ``matrices``) are stacked tensors with the layer axis first;
    ``L`` and ``R`` are the (N + 1)-long forward and backward products.
    ``pol`` is 's', 'p', or a tuple of them evaluated together on a trailing
    polarization axis (the merit terms' 'avg').
    """

    def __init__(self, stack, wvl, theta0, pol):
        self.stack = stack
        self._d = stack.thicknesses.detach().requires_grad_(True)
        with torch.enable_grad():
            ev = _Evaluation(stack, wvl, theta0, pol, d=self._d)
        self.pol = ev.pol
        self._graph = (ev.r, ev.t, ev.E, ev.H)
        self.wvl, self.theta0 = ev.wvl, ev.theta0
        self.n0, self.eta0, self.eta_sub = ev.n0, ev.eta0, ev.eta_sub

        # per-layer kinematics, factored through the free-space wavenumber:
        # beta_j = (k0 n_j cos(theta_j)) d_j, so d(beta)/d(d) is the prefactor
        k0 = 2 * math.pi / self.wvl
        self.ns, self.costs = ev.ns, ev.costs.detach()
        self.dbeta_dd = k0 * self.ns * self.costs
        self.betas = ev.betas.detach()
        self.etas = ev.etas.detach()
        self.matrices = ev.matrices.detach()
        self.R = ev.R.detach()
        self.M = self.R[0]
        self.r, self.t, self.E, self.H = (q.detach() for q in self._graph)
        self.v_sub = torch.stack(torch.broadcast_tensors(self.t, self.t * self.eta_sub), dim=-1)
        self._L = None

    @property
    def L(self):
        """Forward products, (N + 1, *calc, 2, 2), the identity first."""
        if self._L is None:
            self._L = torch.cat([_identity_row(self.matrices),
                                 _prefix_products(self.matrices)])
        return self._L

    @property
    def R_value(self):
        """Reflectance abs(r)^2."""
        return torch.abs(self.r) ** 2

    @property
    def T_value(self):
        """Transmittance with the tilted-admittance flux factor."""
        return torch.real(self.eta_sub) / torch.real(self.eta0) * torch.abs(self.t) ** 2

    @property
    def A_value(self):
        """Per-layer absorptance, shape (N, *calc)."""
        flux = torch.real(self.E * torch.conj(self.H)) / torch.real(self.eta0)
        return flux[:-1] - flux[1:]

    @property
    def Esq_value(self):
        """Standing-wave intensity abs(E)^2 at each boundary, (N+1, *calc)."""
        return torch.abs(self.E) ** 2


def forward_eval(stack, wvl, theta0, pol):
    """Build a ForwardEval for one sample set."""
    return ForwardEval(stack, wvl, theta0, pol)


def _quantities_from_matrices(matrices, eta0, eta_sub):
    """(r, t, E, H) from per-layer characteristic matrices (N, *calc, 2, 2)."""
    mats = _stacked(matrices)
    R = torch.cat([_suffix_products(mats), _identity_row(mats)])
    return _rtEH(R, eta0, eta_sub)


def _seeded_scalar(r, t, E, H, eta0, eta_sub, dR, dT, dA, dEsq):
    """Seed-weighted sum of the physical quantities (the VJP scalar)."""
    total = torch.zeros((), dtype=config.precision, device=r.device)
    if dR is not None:
        total = total + torch.sum(dR * torch.abs(r) ** 2)
    if dT is not None:
        T = torch.real(eta_sub) / torch.real(eta0) * torch.abs(t) ** 2
        total = total + torch.sum(dT * T)
    if dA is not None:
        flux = torch.real(E * torch.conj(H)) / torch.real(eta0)
        A = flux[:-1] - flux[1:]
        total = total + torch.sum(dA * A)
    if dEsq is not None:
        total = total + torch.sum(dEsq * torch.abs(E) ** 2)
    return total


def thickness_gradient(fwd, dR=None, dT=None, dA=None, dEsq=None):
    """Gradient of a seeded scalar merit w.r.t. every layer thickness.

    One backward pass through the forward evaluation's graph, which is kept
    for the next seeds.
    """
    with torch.enable_grad():
        total = _seeded_scalar(*fwd._graph, fwd.eta0, fwd.eta_sub, dR, dT, dA, dEsq)
    if not total.requires_grad:
        return torch.zeros_like(fwd._d)
    grad, = torch.autograd.grad(total, fwd._d, retain_graph=True, allow_unused=True)
    return torch.zeros_like(fwd._d) if grad is None else grad


def index_gradient(fwd, dR=None, dT=None, dA=None, dEsq=None):
    """Gradient of a seeded scalar merit w.r.t. every (real) layer index.

    The derivative is taken in the real part of each layer index; any
    imaginary (absorbing) component is held fixed at its forward value
    so lossy layers differentiate at the right point.
    """
    eta0, eta_sub = fwd.eta0, fwd.eta_sub
    ns = _complex(fwd.ns)
    nvec = ns.real.reshape(ns.shape[0]).detach().requires_grad_(True)
    imag = ns.imag
    d = fwd.stack.thicknesses.detach().to(config.precision)
    lead = (-1,) + (1,) * (ns.ndim - 1)
    with torch.enable_grad():
        n = torch.complex(nvec.reshape(lead).expand_as(imag), imag)
        *_, mats = _layer_matrices(n, d.reshape(lead), fwd.n0, fwd.theta0, fwd.wvl, fwd.pol)
        r, t, E, H = _quantities_from_matrices(mats, eta0, eta_sub)
        total = _seeded_scalar(r, t, E, H, eta0, eta_sub, dR, dT, dA, dEsq)
    grad, = torch.autograd.grad(total, nvec)
    return grad


def _dchar_dbeta(beta, eta):
    """Derivative of the characteristic matrix w.r.t. phase thickness."""
    cosb = _complex(torch.cos(beta))
    sinb = _complex(torch.sin(beta))
    eta = _complex(eta)
    row0 = torch.stack(torch.broadcast_tensors(-sinb, -1j * cosb / eta), dim=-1)
    row1 = torch.stack(torch.broadcast_tensors(-1j * eta * cosb, -sinb), dim=-1)
    return torch.stack([row0, row1], dim=-2)


def char_matrix_vjp(beta, eta, M_bar):
    """Pull a matrix cotangent back to (c_beta, c_eta) cotangents.

    Kept for API parity; implemented with the analytic derivative matrices.
    """
    sinb = _complex(torch.sin(beta))
    eta = _complex(eta)
    zero = torch.zeros_like(sinb)
    dMdb = _dchar_dbeta(beta, eta)
    dMde = torch.stack([
        torch.stack(torch.broadcast_tensors(zero, 1j * sinb / (eta * eta)), dim=-1),
        torch.stack(torch.broadcast_tensors(-1j * sinb, zero), dim=-1)], dim=-2)
    c_beta = torch.sum(torch.conj(dMdb) * M_bar, dim=(-2, -1))
    c_eta = torch.sum(torch.conj(dMde) * M_bar, dim=(-2, -1))
    return c_beta, c_eta


def assembly_cotangent(fwd, dR=None, dT=None):
    """Assembled-matrix cotangent c_M with dF = Re(sum(conj(c_M) dM)).

    torch's gradient with respect to the complex leaf M is that pairing's
    c_M as it stands (the JAX package conjugates ``jax.grad``'s once).
    """
    eta0, eta_sub = fwd.eta0, fwd.eta_sub
    M = fwd.M.detach().requires_grad_(True)
    with torch.enable_grad():
        B = M[..., 0, 0] + M[..., 0, 1] * eta_sub
        C = M[..., 1, 0] + M[..., 1, 1] * eta_sub
        denom = eta0 * B + C
        r = (eta0 * B - C) / denom
        t = 2 * eta0 / denom
        total = torch.zeros((), dtype=config.precision, device=M.device)
        if dR is not None:
            total = total + torch.sum(dR * torch.abs(r) ** 2)
        if dT is not None:
            T = torch.real(eta_sub) / torch.real(eta0) * torch.abs(t) ** 2
            total = total + torch.sum(dT * T)
    if not total.requires_grad:
        return torch.zeros_like(M)
    g, = torch.autograd.grad(total, M)
    return g


def layer_cotangents(fwd, dR=None, dT=None, dA=None, dEsq=None):
    """Per-layer (c_beta, c_eta) cotangent lists for a seeded scalar.

    API parity; one autograd sweep over the stacked (beta, eta) leaves.
    """
    eta0, eta_sub = fwd.eta0, fwd.eta_sub
    N = fwd.matrices.shape[0]
    if N == 0:
        return [], []
    shape = fwd.matrices.shape[:-2]
    b0 = _complex(fwd.betas).expand(shape).detach().requires_grad_(True)
    e0 = _complex(fwd.etas).expand(shape).detach().requires_grad_(True)
    with torch.enable_grad():
        mats = _char_matrix(b0, e0)
        r, t, E, H = _quantities_from_matrices(mats, eta0, eta_sub)
        total = _seeded_scalar(r, t, E, H, eta0, eta_sub, dR, dT, dA, dEsq)
    gb, ge = torch.autograd.grad(total, (b0, e0))
    return list(gb.unbind(0)), list(ge.unbind(0))
