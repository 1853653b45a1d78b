"""Spectral/angular merit terms for coating design.

Counterpart of ``prysm_tpu/x/coatings/merit.py``.  Wavelengths and
thicknesses are microns, angles radians; ``pol`` is 's', 'p', or 'avg'
(incoherent average of both).

Each term is a quantity extractor (R, T, per-layer A, boundary |E|^2)
paired with a cotangent seeder that maps dF/dq into the diff engine's seed
keywords; the shared base class owns sampling-grid validation, polarization
averaging, and the value / residual / gradient plumbing.
"""
import numpy as onp
import torch

from ...conf import config
from .diff import forward_eval, thickness_gradient, assembly_cotangent
from .stack import _real

__all__ = ['Reflectance', 'Transmittance', 'LayerAbsorptance',
           'FieldIntensityAtBoundary', 'PeakFieldAtInterfaces',
           'FieldInLayer', 'MeritFunction', 'as_merit']


def _sampled(x):
    return _real(x)


class _Term:
    """One weighted least-squares term over a (wvl, theta, pol) sample set."""

    quantity = None

    def __init__(self, wvl, theta=0.0, pol='avg', target=0.0, weight=1.0):
        """Sample grid (wvl um, theta rad), polarization, target, weight."""
        self.wvl, self.theta = _sampled(wvl), _sampled(theta)
        self.target, self.weight = _sampled(target), _sampled(weight)
        self.pol = pol.lower()
        if self.pol not in ('s', 'p', 'avg'):
            raise ValueError("pol must be one of 's', 'p', 'avg'")
        if (self.wvl.ndim == 1 and self.theta.ndim == 1
                and self.wvl.numel() > 1 and self.theta.numel() > 1):
            raise ValueError('wvl and theta are both 1-D; meshgrid them '
                             'to sample a spectral/angular grid')
        try:
            torch.broadcast_shapes(self.wvl.shape, self.theta.shape,
                                   self.target.shape, self.weight.shape)
        except (ValueError, TypeError, RuntimeError) as exc:
            # torch raises RuntimeError for incompatible shapes
            raise ValueError('wvl, theta, target, and weight must be '
                             'broadcast-compatible') from exc

    # -- hooks each quantity implements --------------------------------------

    def _extract(self, fwd):
        raise NotImplementedError('subclasses supply the quantity extractor')

    def _seed(self, fwd, dq):
        """Map a quantity cotangent into diff-engine seed kwargs."""
        raise NotImplementedError('subclasses supply the cotangent seeder')

    assembly_capable = False

    # -- shared machinery ----------------------------------------------------

    def _forward(self, stack):
        """(pol-averaged quantity, one ForwardEval of every polarization at once).

        The polarizations share one evaluation on a trailing axis (the JAX
        package evaluates them one after the other); the average adds them
        in the same order.
        """
        pols = ('s', 'p') if self.pol == 'avg' else (self.pol,)
        fwd = forward_eval(stack, self.wvl, self.theta, pols)
        each = self._extract(fwd)
        total = each[..., 0]
        for k in range(1, len(pols)):
            total = total + each[..., k]
        return total / len(pols), fwd

    def _misfit(self, q):
        return q - self.target

    def residuals(self, stack):
        """Weighted residual vector sqrt(w)(q - target), flattened."""
        q, _ = self._forward(stack)
        return torch.atleast_1d(torch.sqrt(self.weight) * self._misfit(q)).ravel()

    def value(self, stack):
        """Weighted sum of squared deviations from target (scalar)."""
        q, _ = self._forward(stack)
        return float(torch.sum(self.weight * self._misfit(q) ** 2))

    def _cotangent(self, q, n_pols):
        dF_dq = 2 * self.weight * self._misfit(q)
        return torch.broadcast_to(dF_dq, q.shape) / n_pols

    def value_and_grad(self, stack, grad_fn=thickness_gradient):
        """Scalar value and its gradient through ``grad_fn``."""
        q, fwd = self._forward(stack)
        dF_dq = self._cotangent(q, len(fwd.pol))
        grad = torch.zeros(len(stack), dtype=config.precision, device=q.device)
        grad = grad + grad_fn(fwd, **self._seed(fwd, dF_dq[..., None]))
        return float(torch.sum(self.weight * self._misfit(q) ** 2)), grad

    def assembly_seeds(self, stack):
        """(ForwardEval, M-cotangent) pairs for needle synthesis (one, of every polarization)."""
        if not self.assembly_capable:
            raise NotImplementedError('needle synthesis supports only '
                                      'reflectance/transmittance targets')
        q, fwd = self._forward(stack)
        dF_dq = self._cotangent(q, len(fwd.pol))
        return [(fwd, assembly_cotangent(fwd, **self._seed(fwd, dF_dq[..., None])))]


def _one_hot_seed(shape, where, dq):
    seeded = torch.zeros(shape, dtype=config.precision, device=dq.device)
    seeded[where] = dq
    return seeded


class Reflectance(_Term):
    """Target the intensity reflectance R = abs(r)^2."""

    quantity, assembly_capable = 'R', True

    def _extract(self, fwd):  # NOQA: D102
        return fwd.R_value

    def _seed(self, fwd, dq):  # NOQA: D102
        return {'dR': dq}


class Transmittance(_Term):
    """Target the intensity transmittance T."""

    quantity, assembly_capable = 'T', True

    def _extract(self, fwd):  # NOQA: D102
        return fwd.T_value

    def _seed(self, fwd, dq):  # NOQA: D102
        return {'dT': dq}


class _IndexedTerm(_Term):
    """Term addressing one layer or boundary by position."""

    def __init__(self, where, wvl, theta=0.0, pol='avg', target=0.0,
                 weight=1.0):
        super().__init__(wvl, theta=theta, pol=pol, target=target,
                         weight=weight)
        self.where = int(where)


class LayerAbsorptance(_IndexedTerm):
    """Target the absorptance A of one layer."""

    quantity = 'A'

    @property
    def layer(self):
        """The addressed layer."""
        return self.where

    def _extract(self, fwd):  # NOQA: D102
        return fwd.A_value[self.where]

    def _seed(self, fwd, dq):  # NOQA: D102
        return {'dA': _one_hot_seed(fwd.A_value.shape, self.where, dq)}


class FieldIntensityAtBoundary(_IndexedTerm):
    """Target the standing-wave intensity |E|^2 at one boundary."""

    quantity = 'Esq'

    @property
    def boundary(self):
        """The addressed boundary."""
        return self.where

    def _extract(self, fwd):  # NOQA: D102
        return fwd.Esq_value[self.where]

    def _seed(self, fwd, dq):  # NOQA: D102
        return {'dEsq': _one_hot_seed(fwd.Esq_value.shape, self.where, dq)}


class PeakFieldAtInterfaces(_Term):
    """Target the peak standing-wave intensity over a set of boundaries."""

    quantity = 'Esq'

    def __init__(self, wvl, theta=0.0, pol='avg', boundaries=None,
                 target=0.0, weight=1.0):
        super().__init__(wvl, theta=theta, pol=pol, target=target,
                         weight=weight)
        self.boundaries = None if boundaries is None else list(boundaries)

    def _subset(self, fwd):
        Esq = fwd.Esq_value
        if self.boundaries is None:
            return Esq, torch.arange(len(Esq), device=Esq.device)
        chosen = torch.as_tensor(onp.asarray(self.boundaries), device=Esq.device)
        return Esq[chosen], chosen

    def _extract(self, fwd):
        Esq, _ = self._subset(fwd)
        return torch.max(Esq, dim=0).values

    def _seed(self, fwd, dq):
        # route the cotangent entirely to the argmax boundary per sample
        Esq, chosen = self._subset(fwd)
        trailing = Esq.ndim - 1
        winner = torch.argmax(Esq, dim=0)
        lane = torch.arange(Esq.shape[0], device=Esq.device).reshape((-1,) + (1,) * trailing)
        selector = (lane == winner[None]).to(config.precision)
        full = torch.zeros(fwd.Esq_value.shape, dtype=config.precision, device=Esq.device)
        full[chosen] = selector * dq[None]
        return {'dEsq': full}


class FieldInLayer(_IndexedTerm):
    """Target mean standing-wave intensity at a layer's two boundaries."""

    quantity = 'Esq'

    @property
    def layer(self):
        """The addressed layer."""
        return self.where

    def _extract(self, fwd):  # NOQA: D102
        both = fwd.Esq_value[self.where:self.where + 2]
        return 0.5 * (both[0] + both[1])

    def _seed(self, fwd, dq):  # NOQA: D102
        half = torch.zeros(fwd.Esq_value.shape, dtype=config.precision, device=dq.device)
        half[self.where] += 0.5 * dq
        half[self.where + 1] += 0.5 * dq
        return {'dEsq': half}


class MeritFunction:
    """A weighted collection of merit terms, summed."""

    def __init__(self, terms):
        self.terms = [terms] if isinstance(terms, _Term) else list(terms)

    def value(self, stack):
        """Total weighted sum-of-squares merit (scalar)."""
        return float(sum(term.value(stack) for term in self.terms))

    def residuals(self, stack):
        """Every term's weighted residual vector, concatenated."""
        if not self.terms:
            return torch.zeros(0, dtype=config.precision, device=stack.thicknesses.device)
        return torch.cat([term.residuals(stack) for term in self.terms])

    def value_and_grad(self, stack, grad_fn=thickness_gradient):
        """Total merit plus its gradient through grad_fn."""
        pairs = [term.value_and_grad(stack, grad_fn=grad_fn)
                 for term in self.terms]
        total = sum(v for v, _ in pairs)
        grad = torch.zeros(len(stack), dtype=config.precision, device=stack.thicknesses.device)
        for _, g in pairs:
            grad = grad + g
        return float(total), grad


def as_merit(obj):
    """Normalize a term / list of terms / MeritFunction to a MeritFunction."""
    if isinstance(obj, MeritFunction):
        return obj
    return MeritFunction(obj)

