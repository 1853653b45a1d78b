"""Thin-film stack engine with internal field access.

Counterpart of ``prysm_tpu/x/coatings/stack.py``.  Layers are ambient-side
first; angles radians; thicknesses and wavelengths microns.  The compute
core works on one stacked (N, *calc, 2, 2) tensor of characteristic
matrices, where the JAX package keeps per-layer lists:

* the cumulative products are log-depth doublings over the layer axis
  (Hillis-Steele): pass k multiplies each running product by the one 2^k
  layers before it (forward) or after it (backward).  Each product is a
  balanced tree of the layers' matrices, ceil(log2 N) levels deep, where
  the JAX package's ``lax.associative_scan`` builds its own tree; the two
  orders agree to rounding (1e-13 relative in float64 on the stacks of the
  tests);
* a 2x2 product is written elementwise, as two broadcast outer products
  and a sum over the (..., 2, 2) trailing axes;
* complex cos and sin are built from real cos/sin/cosh/sinh with the JAX
  package's formulas, so values with large imaginary parts stay equal;
* each layer's cos(theta), phase thickness, admittance and characteristic
  matrix are formed in float64 from the working-dtype inputs and rounded
  once to the working dtype, where the JAX package forms them in the
  working dtype: on the card, float32 trigonometry and the four roundings
  of the phase took the float32 merit of a 41-layer design to 8.1e-6 of
  float64, 2.7x the JAX package's own float32 error on the CPU.  The
  products, the fields and everything after them stay in the working dtype.

Python numbers and numpy arrays become ``config.precision`` tensors on
``config.device``; tensors keep their device.
"""
import math

import numpy as onp
import torch

from ...conf import complex_for, config, numpy_dtype, resolve_device
from ...thinfilm import _cos_snell

__all__ = ['Stack', 'stack_characteristic_matrices', 'forward_products', 'backward_products',
           'internal_fields', 'field_at_depth', 'RTA', 'stack_rt']


def _resolve(index, wvl):
    """Resolve a constant, callable, or material index at wavelength wvl."""
    nk = getattr(index, 'nk', None)
    if callable(nk):
        return nk(wvl)
    if callable(index):
        return index(wvl)
    return index


def _admittance(n, cost, pol):
    """Tilted optical admittance for index n at cos(theta).

    A tuple of polarizations gives one admittance each, concatenated along
    the last sample axis (the polarization axis, size 1 in the operands).
    """
    if isinstance(pol, tuple):
        return torch.cat([_admittance(n, cost, p) for p in pol], dim=-1)
    if pol == 'p':
        return n / cost
    return n * cost


def _polarizations(pol):
    """'s' / 'p' (one evaluation), or a tuple of them (a trailing polarization axis)."""
    pols = pol if isinstance(pol, tuple) else (pol,)
    pols = tuple(p.lower() for p in pols)
    if not pols or any(p not in ('p', 's') for p in pols):
        raise ValueError("unknown polarization, use 'p' or 's'")
    return pols if isinstance(pol, tuple) else pols[0]


def _real(x, device=None):
    """x as a real tensor of ``config.precision``: tensors are cast and keep their device."""
    if torch.is_tensor(x):
        return x.to(config.precision)
    return torch.as_tensor(onp.asarray(x, dtype=numpy_dtype()),
                           device=resolve_device(device))


def _complex(z):
    z = torch.as_tensor(z)
    return z if z.is_complex() else z.to(complex_for(z.dtype))


def _ccos(z):
    """cos of a complex tensor from real primitives."""
    z = torch.as_tensor(z)
    if not z.is_complex():
        return _complex(torch.cos(z))
    zr, zi = z.real, z.imag
    return torch.complex(torch.cos(zr) * torch.cosh(zi), -torch.sin(zr) * torch.sinh(zi))


def _csin(z):
    """sin of a complex tensor from real primitives."""
    z = torch.as_tensor(z)
    if not z.is_complex():
        return _complex(torch.sin(z))
    zr, zi = z.real, z.imag
    return torch.complex(torch.sin(zr) * torch.cosh(zi), torch.cos(zr) * torch.sinh(zi))


def _char_matrix(beta, eta):
    """Per-layer characteristic matrix with trailing (2, 2) axes."""
    cosb = _ccos(beta)
    sinb = _csin(beta)
    eta = _complex(eta)
    m01 = -1j * sinb / eta
    m10 = -1j * eta * sinb
    cosb, m01, m10 = torch.broadcast_tensors(cosb, m01, m10)
    row0 = torch.stack([cosb, m01], dim=-1)
    row1 = torch.stack([m10, cosb], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _mul(A, B):
    """Batched 2x2 product A @ B over trailing (2, 2) axes, written elementwise.

    One broadcast product (..., 2, 2, 1) x (..., 1, 2, 2) and a sum of its
    two terms: no slices, so autograd's backward allocates nothing per entry.
    """
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _matvec(M, v):
    """Batched matrix-vector product: (*calc, 2, 2) applied to (*calc, 2)."""
    return (M * v[..., None, :]).sum(-1)


def _ct(M):
    """Conjugate transpose over the trailing (2, 2) axes."""
    return M.conj().transpose(-1, -2)


def _eye2(like=None):
    """2x2 complex identity (broadcasts against any (..., 2, 2) stack)."""
    if like is None:
        return torch.eye(2, dtype=config.precision_complex, device=resolve_device())
    return torch.eye(2, dtype=like.dtype, device=like.device)


def _identity_row(mats):
    """The (1, *calc, 2, 2) identity beside a (N, *calc, 2, 2) stack of matrices,
    N = 0 included (a bare interface: no layers)."""
    return _eye2(mats).expand((1,) + tuple(mats.shape[1:]))


def _prefix_products(mats):
    """P_k = M_0 M_1 ... M_k over the leading axis, by log-depth doubling."""
    P, k, n = mats, 1, mats.shape[0]
    while k < n:
        P = torch.cat([P[:k], _mul(P[:-k], P[k:])])
        k *= 2
    return P


def _suffix_doubling(mats):
    S, k, n = mats, 1, mats.shape[0]
    while k < n:
        S = torch.cat([_mul(S[:-k], S[k:]), S[-k:]])
        k *= 2
    return S


def _affine_prefix(A, G):
    """x_0 = G_0, x_k = A_k x_{k-1} + G_k over the leading axis (A_0 unused), by doubling."""
    P, x, k, n = A, G, 1, G.shape[0]
    while k < n:
        x = torch.cat([x[:k], x[k:] + _mul(P[k:], x[:-k])])
        P = torch.cat([P[:k], _mul(P[k:], P[:-k])])
        k *= 2
    return x


def _suffix_doubling_jvp(mats, dmats):
    """The tangent of ``_suffix_doubling`` at mats along dmats: the same
    doubling over (S, dS) pairs, d(AB) = dA B + A dB."""
    S, dS, k, n = mats, dmats, 1, mats.shape[0]
    while k < n:
        dS = torch.cat([_mul(dS[:-k], S[k:]) + _mul(S[:-k], dS[k:]), dS[-k:]])
        S = torch.cat([_mul(S[:-k], S[k:]), S[-k:]])
        k *= 2
    return dS


class _SuffixProducts(torch.autograd.Function):
    """S_k = M_k M_{k+1} ... M_{N-1}, with its backward written out.

    The forward is the doubling of ``_suffix_doubling``.  Backward: the
    cotangent reaching S_k in all is Gt_k = G_k + M_{k-1}^H Gt_{k-1} (a
    prefix recurrence, also by doubling), and M_k's is Gt_k S_{k+1}^H (S_N
    the identity), torch's convention for a complex product.  Autograd
    through the doubling's slices and concatenations would allocate and
    copy full-size zeros for each of them.  The tangent is the product
    rule carried through the same doubling (``_suffix_doubling_jvp``), and
    ``vmap`` is torch's generated rule: every step is a torch operation.
    """

    generate_vmap_rule = True

    @staticmethod
    def forward(mats):
        # a view, not mats itself, where there is nothing to multiply (N <= 1)
        return _suffix_doubling(mats).view_as(mats)

    @staticmethod
    def setup_context(ctx, inputs, output):
        mats, = inputs
        ctx.save_for_backward(mats, output)
        ctx.save_for_forward(mats)

    @staticmethod
    def backward(ctx, G):
        mats, S = ctx.saved_tensors
        A = torch.cat([_eye2(mats).expand_as(mats[:1]), _ct(mats[:-1])])
        Gt = _affine_prefix(A, G)
        S_next = torch.cat([S[1:], _eye2(S).expand_as(S[:1])])
        return _mul(Gt, _ct(S_next))

    @staticmethod
    def jvp(ctx, dmats):
        mats, = ctx.saved_tensors
        return _suffix_doubling_jvp(mats, dmats)


def _suffix_products(mats):
    """S_k = M_k M_{k+1} ... M_{N-1} over the leading axis, by log-depth doubling."""
    return _SuffixProducts.apply(mats)


def _stacked(matrices):
    """A list of (..., 2, 2) matrices (or one stacked tensor) as one (N, ..., 2, 2) tensor."""
    if torch.is_tensor(matrices):
        return matrices
    shape = torch.broadcast_shapes(*(M.shape for M in matrices))
    return torch.stack([M.expand(shape) for M in matrices])


class Stack:
    """A multilayer thin-film stack.

    indices: per-layer index (number / callable / material), ambient side
    first; thicknesses: per-layer physical thickness, microns (a tensor
    keeps its device; anything else goes to ``config.device``);
    substrate_index / ambient_index: the bounding media.
    """

    __slots__ = ('indices', 'thicknesses', 'substrate_index', 'ambient_index')

    def __init__(self, indices, thicknesses, substrate_index,
                 ambient_index=1.0):
        indices = list(indices)
        if isinstance(thicknesses, (list, tuple)) and any(torch.is_tensor(t) for t in thicknesses):
            thicknesses = torch.stack([torch.as_tensor(t) for t in thicknesses])
        thicknesses = _real(thicknesses)
        if thicknesses.ndim == 0:
            thicknesses = thicknesses.expand(len(indices)).clone()
        if len(indices) != thicknesses.shape[0]:
            raise ValueError('indices and thicknesses must describe the same '
                             'number of layers')
        self.indices = indices
        self.thicknesses = thicknesses
        self.substrate_index = substrate_index
        self.ambient_index = ambient_index

    def __len__(self):
        return self.thicknesses.shape[0]

    def resolved_indices(self, wvl):
        """Per-layer indices evaluated at wavelength wvl."""
        return [_resolve(n, wvl) for n in self.indices]

    def __repr__(self):
        return f'Stack({len(self)} layers, substrate={self.substrate_index!r})'


def _layer_indices(stack, wvl, calc_ndim):
    """(N, ...) tensor of the layer indices at wvl, broadcastable against (N, *calc).

    Numbers become one tensor in a single transfer; callables and materials
    are evaluated per layer and stacked.
    """
    ns = stack.resolved_indices(wvl)
    dev = wvl.device
    lead = (len(ns),) + (1,) * calc_ndim
    if all(isinstance(n, (int, float, complex, onp.number)) for n in ns):
        cplx = any(isinstance(n, (complex, onp.complexfloating)) for n in ns)
        dtype = complex_for(wvl.dtype) if cplx else wvl.dtype
        return torch.tensor(ns, dtype=dtype, device=dev).reshape(lead)
    parts = [n if torch.is_tensor(n) else torch.as_tensor(onp.asarray(n)) for n in ns]
    cplx = any(p.is_complex() for p in parts)
    dtype = complex_for(wvl.dtype) if cplx else wvl.dtype
    parts = [p.to(device=dev, dtype=dtype) for p in parts]
    shape = torch.broadcast_shapes(*(p.shape for p in parts))
    out = torch.stack([p.expand(shape) for p in parts])
    return out.reshape((len(ns),) + (1,) * (calc_ndim - len(shape)) + tuple(shape))


class _Evaluation:
    """The transfer-matrix forward pass of one stack on one (wvl, theta, pol) grid.

    Holds stacked tensors: ``ns``, ``costs``, ``betas``, ``etas`` (N, *calc),
    ``matrices`` (N, *calc, 2, 2), ``R`` (N + 1, *calc, 2, 2) backward
    products with the identity last, and ``r``, ``t``, ``E``, ``H``.
    ``d`` replaces the stack's thicknesses (an autograd leaf for the
    thickness gradient).  ``pol`` is 's', 'p' or a tuple of them: a tuple
    evaluates every polarization at once, on a trailing sample axis that
    ``wvl`` and ``theta0`` gain.
    """

    def __init__(self, stack, wvl, theta0, pol, d=None):
        pol = _polarizations(pol)
        dev = stack.thicknesses.device
        wvl, theta0 = _real(wvl, dev), _real(theta0, dev)
        if isinstance(pol, tuple):
            wvl, theta0 = wvl[..., None], theta0[..., None]
        self.wvl, self.theta0, self.pol = wvl, theta0, pol
        calc = torch.broadcast_shapes(wvl.shape, theta0.shape)
        self.n0 = n0 = _resolve(stack.ambient_index, wvl)
        nsub = _resolve(stack.substrate_index, wvl)
        N = len(stack)
        d = stack.thicknesses if d is None else d
        self.ns = _layer_indices(stack, wvl, len(calc))

        theta_w, n0_w, nsub_w = _wide(theta0), _wide(n0), _wide(nsub)
        self.eta0 = _narrow(_admittance(n0_w, torch.cos(theta_w), pol), wvl.dtype)
        self.eta_sub = _narrow(_admittance(nsub_w, _cos_snell(n0_w, nsub_w, theta_w), pol),
                               wvl.dtype)
        self.costs, self.betas, self.etas, self.matrices = _layer_matrices(
            self.ns, d.reshape((N,) + (1,) * len(calc)), n0, theta0, wvl, pol)
        self.R = torch.cat([_suffix_products(self.matrices),
                            _identity_row(self.matrices)])
        self.M = self.R[0]
        self.r, self.t, self.E, self.H = _rtEH(self.R, self.eta0, self.eta_sub)


def _layer_matrices(ns, d, n0, theta0, wvl, pol):
    """(cos(theta_j), phase thickness, admittance, characteristic matrix) of each layer.

    Formed in float64 from the working-dtype inputs (ns and d lead with the
    layer axis) and rounded once to the working dtype of ``wvl``: the
    products, the fields and the merit after them stay in the working dtype.
    """
    ns_w, theta_w = _wide(ns), _wide(theta0)
    costs = _cos_snell(_wide(n0), ns_w, theta_w)
    betas = (2 * math.pi * ns_w * _wide(d) * costs) / _wide(wvl)
    etas = _admittance(ns_w, costs, pol)
    return tuple(_narrow(v, wvl.dtype) for v in (costs, betas, etas, _char_matrix(betas, etas)))


def _wide(v):
    """A tensor in float64 (complex128 if complex); anything else as it is."""
    if not torch.is_tensor(v):
        return v
    return v.to(torch.complex128 if v.is_complex() else torch.float64)


def _narrow(v, dtype):
    """A float64 / complex128 tensor in the working ``dtype`` (or its complex pair)."""
    if not torch.is_tensor(v):
        return v
    return v.to(complex_for(dtype) if v.is_complex() else dtype)


def _rtEH(R, eta0, eta_sub):
    """(r, t, E, H) from the stacked backward (substrate-side) matrix products."""
    # Abeles B/C assembly, [B, C] = M [1, eta_sub]: the substrate admittance
    # closes the recursion
    eta_sub = _complex(eta_sub)
    B, C = _matvec(R[0], torch.stack(torch.broadcast_tensors(torch.ones_like(eta_sub), eta_sub),
                                     dim=-1)).unbind(-1)
    denom = eta0 * B + C
    r = (eta0 * B - C) / denom
    t = 2 * eta0 / denom
    E, H = _matvec(R, torch.stack(torch.broadcast_tensors(t, t * eta_sub), dim=-1)).unbind(-1)
    return r, t, E, H


def stack_characteristic_matrices(stack, wvl, theta0, pol):
    """Per-layer characteristic matrices, ambient side first."""
    return list(_Evaluation(stack, wvl, theta0, pol).matrices.unbind(0))


def forward_products(matrices):
    """Cumulative left products: length N+1 list, entry 0 the identity.

    Log-depth doubling over the stacked layer axis.
    """
    if len(matrices) == 0:
        return [_eye2()]
    mats = _stacked(matrices)
    return [_eye2(mats)] + list(_prefix_products(mats).unbind(0))


def backward_products(matrices):
    """Cumulative right products: length N+1 list, entry N the identity."""
    if len(matrices) == 0:
        return [_eye2()]
    mats = _stacked(matrices)
    return list(_suffix_products(mats).unbind(0)) + [_eye2(mats)]


def stack_rt(stack, wvl, theta0, pol):
    """Amplitude reflection and transmission coefficients (r, t)."""
    ev = _Evaluation(stack, wvl, theta0, pol)
    return ev.r, ev.t


def internal_fields(stack, wvl, theta0, pol):
    """Tangential E and H at every boundary; leading axis = boundary."""
    ev = _Evaluation(stack, wvl, theta0, pol)
    return ev.E, ev.H


def field_at_depth(stack, z, wvl, theta0, pol):
    """Tangential (E, H) at arbitrary depth(s) z inside the stack."""
    pol = pol.lower()
    N = len(stack)
    if N == 0:
        raise ValueError('field_at_depth requires at least one layer')
    ev = _Evaluation(stack, wvl, theta0, pol)
    wvl, theta0 = ev.wvl, ev.theta0
    z = _real(z, stack.thicknesses.device)

    ds = stack.thicknesses
    Z = torch.cat([torch.zeros(1, dtype=ds.dtype, device=ds.device), torch.cumsum(ds, 0)])
    zh = z.detach().cpu().numpy()
    if bool(onp.any((zh < 0) | (zh > float(Z[-1])))):
        raise ValueError('z must lie within the coating stack')
    li = torch.clamp(torch.searchsorted(Z, z.to(Z.dtype), right=True) - 1, 0, N - 1)

    # the JAX package's per-layer index array: (N,) for numbers, (N, *wvl) otherwise
    n_z = _layer_indices(stack, wvl, 0)[li]
    cost_z = _cos_snell(ev.n0, n_z, theta0)
    eta_z = _admittance(n_z, cost_z, pol)
    t_below = Z[li + 1] - z
    beta_z = (2 * math.pi * n_z * t_below * cost_z) / wvl
    Mz = _char_matrix(beta_z, eta_z)

    v_bottom = torch.stack([ev.E[li + 1], ev.H[li + 1]], dim=-1)
    f = _matvec(Mz, v_bottom)
    return f[..., 0], f[..., 1]


def RTA(stack, wvl, theta0, pol):
    """Reflectance, transmittance, and per-layer absorptance (R, T, A)."""
    ev = _Evaluation(stack, wvl, theta0, pol)
    R = torch.abs(ev.r) ** 2
    T = torch.real(ev.eta_sub) / torch.real(ev.eta0) * torch.abs(ev.t) ** 2

    # net substrate-ward power flux at each boundary over incident power;
    # each layer absorbs the difference (telescopes to A = 1 - R - T)
    flux = torch.real(ev.E * torch.conj(ev.H)) / torch.real(ev.eta0)
    A = flux[:-1] - flux[1:]
    return R, T, A
