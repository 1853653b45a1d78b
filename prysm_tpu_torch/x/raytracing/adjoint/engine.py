"""Reverse-mode trace sensitivities through autograd.

Counterpart of ``prysm_tpu/x/raytracing/adjoint/engine.py``: seeds are
materialized as a perturbation vector ``eps`` applied *functionally* to
the compiled surface list, and autograd differentiates the whole trace —
the Newton intersections already carry implicit-function gradients, so
one backward pass yields d(merit)/d(every seed) exactly.

Heads are either

* a callable ``head(P_hist, S_hist, OPL_hist) -> scalar`` in torch math
  (gradients come from autograd; no hand-derived cotangent seeds), or
* an object with ``seed(trace, system, wavelength) -> (P_bar, S_bar,
  L_bar)`` history-shaped cotangents (the duck-typed head protocol),
  optionally plus ``direct_gradient(trace, system, wavelength, seeds)``.

The bundle and ``eps`` live on ``config.device`` in ``config.precision``;
gradients come back as host numpy.
"""
import numpy as onp
import torch

from ....conf import config
from ..spencer_and_murty import _like, raytrace, to_host, valid_mask
from ..surfaces import Surface, CallableShape
from .._resolve import compiled_surfaces


class _IndexOffset:
    """Material wrapper adding a (tensor) offset to the real index."""

    __slots__ = ('base', 'delta')

    def __init__(self, base, delta):
        self.base = base
        self.delta = delta

    def n(self, wvl, temperature=None):
        return self.base.n(wvl) + self.delta

    def k(self, wvl, temperature=None):
        return self.base.k(wvl) if hasattr(self.base, 'k') else 0.0

    @property
    def name(self):
        return getattr(self.base, 'name', 'material')


def _resolve_surfaces(system_or_surfaces):
    return compiled_surfaces(system_or_surfaces)


def _eps0(n):
    """The zero perturbation vector, on ``config.device`` in ``config.precision``."""
    return torch.zeros(n, dtype=config.precision, device=config.device)


def apply_seeds(surfaces, seeds, eps):
    """The surface list perturbed by eps[k] along each seed's action.

    Pure function of (surfaces, eps): vertices translate by eps*Qdot,
    rotations linearize as R + eps*Rdot, scalar shape DOFs shift by
    eps*scale, sag terms add eps*fn(x, y), media gain eps on the index.
    Exact at eps=0, which is where the derivatives linearize.  A pose no
    seed moves stays as it was (host numpy); a moved one becomes a tensor
    in eps's dtype, on eps's device.
    """
    out = []
    for j, s in enumerate(surfaces):
        Pj = s.P
        Rj = s.R
        shape = s.shape
        shape_contribs = []
        sag_terms = []
        index_delta = None
        for k, seed in enumerate(seeds):
            pq = seed.pose.get(j)
            if pq is not None:
                Qdot, Rdot = pq
                if Qdot is not None and onp.any(to_host(Qdot)):
                    Pj = _like(Pj, eps) + eps[k] * _like(Qdot, eps)
                if Rdot is not None:
                    base_R = (torch.eye(3, dtype=eps.dtype, device=eps.device)
                              if Rj is None else _like(Rj, eps))
                    Rj = base_R + eps[k] * _like(Rdot, eps)
            for sidx, pname, scale in seed.shapes:
                if sidx == j:
                    shape_contribs.append((pname, scale, k))
            if seed.sag_term is not None and seed.sag_term[0] == j:
                sag_terms.append((seed.sag_term[1], k))
            if seed.index is not None and seed.index[0] == j:
                contrib = eps[k] * seed.index[1]
                index_delta = (contrib if index_delta is None
                               else index_delta + contrib)

        if shape_contribs:
            p = dict(shape.params)
            for pname, scale, k in shape_contribs:
                if pname not in p:
                    kind = getattr(shape, 'kind', type(shape).__name__)
                    raise KeyError(
                        f'surface {j} is a {kind} shape with '
                        f'shape DOFs {sorted(p)}; seed targets {pname!r} '
                        '(note: indices are compiled indices, OBJECT = 0)')
                p[pname] = p[pname] + eps[k] * scale
            shape = shape.with_params(p)
        if sag_terms:
            base = shape

            def _sag(x, y, _b=base, _t=tuple(sag_terms)):
                z = _b.sag(x, y)
                for fn, k in _t:
                    z = z + eps[k] * fn(x, y)
                return z

            shape = CallableShape(_sag, params=dict(base.params))
        mat = s.material
        if index_delta is not None and mat is not None:
            mat = _IndexOffset(mat, index_delta)
        out.append(Surface(shape=shape, interaction=s.typ, P=Pj, R=Rj,
                           material=mat, aperture=s.aperture,
                           grating=s.grating, coating=s.coating))
    return out


def _trace_fn(surfaces, seeds, P, S, wvl, tol_sag, Pdot0=None, Sdot0=None):
    """f(eps) over the nominal-valid subset of the bundle.

    Rays dead at the nominal point (clipped, TIR, missed) are dropped
    BEFORE differentiation: the derivatives linearize at eps = 0, where
    the kept lanes are all finite, so no NaN from dead-lane masking can
    reach the backward pass (0 cotangent times a NaN partial poisons the
    whole bundle otherwise).  Heads therefore see an all-valid bundle.

    Pdot0 / Sdot0 ((N, 3, K)) carry launch-recipe tangents: when the
    launch bundle itself depends on the seed parameters (an internal
    stop moves the entrance pupil; an F/#/NA aperture spec rescales the
    pupil with focal length), the start of each ray becomes
    P + Pdot0 @ eps.
    """
    P = onp.asarray(to_host(P), dtype=float)
    S = onp.asarray(to_host(S), dtype=float)
    r0 = raytrace(surfaces, P, S, wvl, tol_sag=tol_sag)
    valid = to_host(valid_mask(r0.status, r0.P[-1]))
    if not valid.all():
        P = P[valid]
        S = S[valid]
        if Pdot0 is not None:
            Pdot0 = onp.asarray(Pdot0, dtype=float)[valid]
        if Sdot0 is not None:
            Sdot0 = onp.asarray(Sdot0, dtype=float)[valid]
    ref = r0.P
    P, S = _like(P, ref), _like(S, ref)
    Pdot0 = None if Pdot0 is None else _like(onp.asarray(Pdot0, dtype=float), ref)
    Sdot0 = None if Sdot0 is None else _like(onp.asarray(Sdot0, dtype=float), ref)

    def f(eps):
        Pe, Se = P, S
        if Pdot0 is not None:
            Pe = Pe + Pdot0 @ eps
        if Sdot0 is not None:
            Se = Se + Sdot0 @ eps
            Se = Se / torch.linalg.norm(Se, dim=-1, keepdim=True)
        r = raytrace(apply_seeds(surfaces, seeds, eps), Pe, Se, wvl,
                     tol_sag=tol_sag)
        return r.P, r.S, r.OPL

    return f


def _grad(out, eps, grad_outputs=None, retain_graph=False):
    """d out / d eps as host numpy; zeros where out does not depend on eps."""
    g, = torch.autograd.grad(out, eps, grad_outputs=grad_outputs,
                             retain_graph=retain_graph, allow_unused=True)
    return onp.zeros(tuple(eps.shape)) if g is None else to_host(g)


def adjoint_gradient(system, P, S, wvl, seeds, head, *, tol_sag=None,
                     Pdot0=None, Sdot0=None):
    """Gradient of a scalar merit w.r.t. every seed parameter.

    One forward trace and one reverse-mode pass; see the module docstring
    for the two head protocols.  Returns (grad, nominal) when the head
    yields a value (callable heads always do; seed-protocol heads return
    nominal=None unless they expose ``value``).
    """
    surfaces = _resolve_surfaces(system)
    seeds = list(seeds)
    eps0 = _eps0(len(seeds)).requires_grad_(True)
    f = _trace_fn(surfaces, seeds, P, S, wvl, tol_sag, Pdot0=Pdot0,
                  Sdot0=Sdot0)

    seed_meth = getattr(head, 'seed', None)
    if seed_meth is None:
        if not callable(head):
            raise TypeError('head must be callable or provide seed()')
        value = head(*f(eps0))
        return _grad(value, eps0), float(value.detach())

    trace = raytrace(surfaces, onp.asarray(to_host(P), dtype=float),
                     onp.asarray(to_host(S), dtype=float), wvl,
                     tol_sag=tol_sag)
    cot = seed_meth(trace, system, wvl)
    outs = f(eps0)
    grad = _grad(outs, eps0, grad_outputs=tuple(_like(c, o) for c, o in zip(cot, outs)))
    direct = getattr(head, 'direct_gradient', None)
    if direct is not None:
        extra = direct(trace, system, wvl, seeds)
        if extra is not None:
            grad = grad + onp.asarray(to_host(extra))
    value_meth = getattr(head, 'value', None)
    nominal = (value_meth(trace, system, wvl)
               if callable(value_meth) else None)
    return grad, nominal


def adjoint_gradient_multi(system, P, S, wvl, seeds, heads, *,
                           tol_sag=None, Pdot0=None, Sdot0=None):
    """(grads, values) for several callable heads over one bundle.

    One forward trace and one graph shared by all heads; each head costs
    only a backward pass, not a re-trace.  grads is (M, n_seeds); values
    is the list of nominal head values.
    """
    surfaces = _resolve_surfaces(system)
    seeds = list(seeds)
    heads = list(heads)
    eps0 = _eps0(len(seeds)).requires_grad_(True)
    f = _trace_fn(surfaces, seeds, P, S, wvl, tol_sag, Pdot0=Pdot0,
                  Sdot0=Sdot0)
    Ph, Sh, L = f(eps0)
    vals = [h(Ph, Sh, L) for h in heads]
    grads = onp.stack([_grad(v, eps0, retain_graph=m < len(heads) - 1)
                       for m, v in enumerate(vals)])
    return grads, [float(v.detach()) for v in vals]


def _masked_mean(v, m, axis=None):
    m = m.to(v.dtype)
    if axis is None:
        return (v * m).sum() / torch.clamp(m.sum(), min=1.0)
    return (v * m).sum(axis) / torch.clamp(m.sum(axis), min=1.0)


def _final_xy_and_mask(P_hist):
    xy = P_hist[-1][:, :2]
    valid = torch.isfinite(P_hist[-1]).all(dim=-1)
    xy = torch.where(valid[:, None], xy, 0.0)
    return xy, valid


class RmsSpotHead:
    """RMS transverse spot radius about the centroid (or the chief ray)."""

    def __init__(self, reference='centroid', chief_index=0,
                 name='rms_spot'):
        self.reference = reference
        self.chief_index = int(chief_index)
        self.name = name

    def __call__(self, P_hist, S_hist, OPL_hist):
        xy, valid = _final_xy_and_mask(P_hist)
        if self.reference == 'chief':
            ref = xy[self.chief_index]
        else:
            ref = _masked_mean(xy, valid[:, None] & torch.ones_like(xy, dtype=torch.bool),
                               axis=0)
        d2 = ((xy - ref) ** 2).sum(dim=1)
        return torch.sqrt(_masked_mean(d2, valid))


class BoresightHead:
    """Distance of the image-plane centroid from a target point."""

    def __init__(self, target=(0.0, 0.0), name='boresight'):
        self.target = onp.asarray(target, dtype=float)
        self.name = name

    def __call__(self, P_hist, S_hist, OPL_hist):
        xy, valid = _final_xy_and_mask(P_hist)
        cen = _masked_mean(xy, valid[:, None] & torch.ones_like(xy, dtype=torch.bool),
                           axis=0)
        return torch.sqrt(((cen - _like(self.target, cen)) ** 2).sum() + 1e-30)


class OplSpreadHead:
    """RMS spread of total optical path about the bundle mean.

    A closing-free proxy for wavefront error (rays sharing a pupil grid
    to a common image point); exact OPD closings live in analysis.py.
    """

    def __init__(self, name='opl_spread'):
        self.name = name

    def __call__(self, P_hist, S_hist, OPL_hist):
        L = OPL_hist.sum(dim=0)
        valid = torch.isfinite(L)
        L = torch.where(valid, L, 0.0)
        mean = _masked_mean(L, valid)
        return torch.sqrt(_masked_mean((L - mean) ** 2, valid))


class RayHeightHead:
    """RMS ray height at one surface of the history (footprint control).

    RMS rather than mean-|y|: |y| is non-differentiable for a ray
    sitting exactly on the axis (the chief), where AD's abs convention
    and the one-sided truth disagree; the quadratic form is smooth.
    """

    def __init__(self, surface, axis=1, name=None):
        self.surface = int(surface)
        self.axis = int(axis)
        self.name = name or f'height_s{surface}'

    def __call__(self, P_hist, S_hist, OPL_hist):
        v = P_hist[self.surface][:, self.axis]
        valid = torch.isfinite(v)
        v = torch.where(valid, v, 0.0)
        return torch.sqrt(_masked_mean(v * v, valid))


__all__ = [
    'adjoint_gradient', 'adjoint_gradient_multi', 'apply_seeds',
    'RmsSpotHead', 'BoresightHead', 'OplSpreadHead', 'RayHeightHead',
]
