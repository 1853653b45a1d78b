"""Needle synthesis for multilayer coating design.

Counterpart of ``prysm_tpu/x/coatings/needle.py``.  The needle function
P(z) is the merit derivative of inserting a zero-thickness layer of a
candidate material at depth z; negative P means the insertion helps.  P is
evaluated vectorized over the whole depth grid: the host layer's partial
characteristic matrices above and below each z are formed in one batch on
the stack's device, and the candidate's thin-layer generator is contracted
against the assembly cotangent from the merit terms.  Which host layer each
depth falls in is found on the host (``searchsorted`` of the boundaries).

Synthesis alternates insertion at the most negative P with gradient
refinement and pruning of sub-tolerance layers.
"""
from dataclasses import dataclass
from itertools import groupby

import math

import numpy as onp
import torch

from ...conf import numpy_dtype
from ...thinfilm import _cos_snell
from ..optym.problem import to_host

from .stack import Stack, _resolve, _admittance, _char_matrix, _complex, _mul
from .diff import _dchar_dbeta
from .merit import as_merit
from .refine import refine

__all__ = [
    'needle_function',
    'insert_needle',
    'cleanup',
    'synthesize',
    'NeedleResult',
]


def _layer_boundaries(stack):
    """Cumulative boundary depths [0, d1, d1+d2, ...]."""
    depth = to_host(stack.thicknesses).astype(numpy_dtype())
    return onp.concatenate([[0.0], onp.cumsum(depth)]).astype(numpy_dtype())


def _thin_layer_generator(fwd, needle_material, sample_shape):
    """d(char matrix)/d(thickness) of a zero-thickness candidate layer."""
    ambient = _resolve(fwd.stack.ambient_index, fwd.wvl)
    candidate = _resolve(needle_material, fwd.wvl)
    cos_t = _cos_snell(ambient, candidate, fwd.theta0)
    admittance = torch.broadcast_to(
        _complex(_admittance(candidate, cos_t, fwd.pol)), sample_shape)
    phase_rate = torch.broadcast_to(
        _complex((2 * math.pi * candidate * cos_t) / fwd.wvl), sample_shape)
    zeros = torch.zeros(sample_shape, dtype=fwd.wvl.dtype, device=fwd.wvl.device)
    return phase_rate[..., None, None] * _dchar_dbeta(zeros, admittance)


def _insertion_gradient(fwd, c_M, needle_material, z, Z):
    """P(z) contribution from one (ForwardEval, M-cotangent) pair."""
    sample_shape = fwd.r.shape
    n_sample_axes = len(sample_shape)
    host_count = len(fwd.stack)

    G = _thin_layer_generator(fwd, needle_material, sample_shape)

    # which host layer each z lives in, and the split thicknesses
    host = onp.clip(onp.searchsorted(Z, z, side='right') - 1, 0, host_count - 1)
    dev = fwd.r.device
    lead = (slice(None),) + (None,) * n_sample_axes
    above_t = torch.as_tensor(z - Z[host], device=dev)[lead]
    below_t = torch.as_tensor(Z[host + 1] - z, device=dev)[lead]
    host_t = torch.as_tensor(host, device=dev)

    def batched(parts):
        parts = _complex(parts)
        return parts.expand((parts.shape[0],) + sample_shape)

    phase_rates = batched(fwd.dbeta_dd)[host_t]
    admittances = batched(fwd.etas)[host_t]
    upper = _char_matrix(phase_rates * above_t, admittances)
    lower = _char_matrix(phase_rates * below_t, admittances)

    dM = _mul(_mul(_mul(fwd.L[host_t], upper), G[None]), _mul(lower, fwd.R[host_t + 1]))

    per_z = torch.real(torch.sum(torch.conj(c_M)[None] * dM, dim=(-2, -1)))
    if n_sample_axes:
        per_z = torch.sum(per_z, dim=tuple(range(1, per_z.ndim)))
    return per_z


def needle_function(stack, targets, needle_material, z):
    """Merit derivative P(z) of inserting ``needle_material`` at depth z.

    Negative values mean the insertion lowers the merit.
    """
    merit = as_merit(targets)
    z = onp.atleast_1d(onp.asarray(z, dtype=numpy_dtype()))
    Z = _layer_boundaries(stack)
    contributions = [
        _insertion_gradient(fwd, c_M, needle_material, z, Z)
        for term in merit.terms
        for fwd, c_M in term.assembly_seeds(stack)
    ]
    total = torch.zeros(z.shape, dtype=stack.thicknesses.dtype,
                        device=stack.thicknesses.device)
    for c in contributions:
        total = total + c
    return total


def insert_needle(stack, z, material, thickness=1e-3, return_index=False):
    """Split the host layer at depth z and insert ``material`` there."""
    Z = _layer_boundaries(stack)
    if len(stack) == 0:
        raise ValueError('insert_needle requires at least one layer')
    z = float(z)
    if not 0.0 <= z <= float(Z[-1]):
        raise ValueError('z must lie within the coating stack')
    host = int(onp.clip(onp.searchsorted(Z, z, side='right') - 1,
                        0, len(stack) - 1))

    media = list(stack.indices)
    depths = [float(t) for t in to_host(stack.thicknesses).astype(numpy_dtype())]
    media[host:host + 1] = [media[host], material, media[host]]
    depths[host:host + 1] = [z - float(Z[host]), float(thickness),
                             float(Z[host + 1]) - z]
    grown = Stack(media, depths, stack.substrate_index, stack.ambient_index)
    return (grown, host + 1) if return_index else grown


class _MediumKey:
    """Equality wrapper so adjacent-layer merging can groupby materials."""

    __slots__ = ('medium',)

    def __init__(self, medium):
        self.medium = medium

    def __eq__(self, other):
        a, b = self.medium, other.medium
        if callable(a) or callable(b):
            return a is b
        return bool(onp.isclose(complex(a), complex(b)))

    def __hash__(self):
        return 0


def cleanup(stack, prune_tol=2e-3, keep_indices=None):
    """Drop sub-tolerance layers, then merge adjacent same-material runs."""
    protected = frozenset(keep_indices or ())
    survivors = [
        (medium, float(t))
        for k, (medium, t) in enumerate(zip(stack.indices, to_host(stack.thicknesses)))
        if float(t) >= prune_tol or k in protected
    ]
    media, depths = [], []
    for key, run in groupby(survivors, key=lambda pair: _MediumKey(pair[0])):
        media.append(key.medium)
        depths.append(sum(t for _, t in run))
    return Stack(media, depths, stack.substrate_index, stack.ambient_index)


@dataclass
class NeedleResult:
    """Outcome of needle synthesis."""

    stack: Stack
    merit: float
    iterations: int
    success: bool

    @property
    def n_layers(self):
        """Layer count of the synthesized stack."""
        return len(self.stack)

    def __repr__(self):
        """Compact representation."""
        return (f'NeedleResult(merit={self.merit:.3e}, '
                f'n_layers={self.n_layers}, iterations={self.iterations}, '
                f'success={self.success})')


def _best_insertion(stack, merit, materials, z):
    """(P value, material, depth) of the most favorable insertion.

    A needle of a host layer's own medium only thickens that layer, so every
    depth inside it is the same insertion and P is flat there but for
    rounding; the shallowest of those depths is taken, whatever the rounding.
    """
    champion = (onp.inf, None, None)
    Z = _layer_boundaries(stack)
    hosts = onp.clip(onp.searchsorted(Z, z, side='right') - 1, 0, len(stack) - 1)
    for mat in materials:
        P = to_host(needle_function(stack, merit, mat, z))
        k = int(onp.argmin(P))
        if _MediumKey(stack.indices[hosts[k]]) == _MediumKey(mat):
            k = int(onp.argmax(hosts == hosts[k]))
        if P[k] < champion[0]:
            champion = (float(P[k]), mat, float(z[k]))
    return champion


def synthesize(stack0, targets, materials, *, z_samples=240, max_layers=40,
               max_iters=30, tol=1e-9, prune_tol=2e-3, seed_thickness=1e-3,
               refine_kwargs=None):
    """Grow a multilayer design by repeated needle insertion + refinement."""
    merit = as_merit(targets)
    materials = list(materials)
    if not materials:
        raise ValueError('materials pool is empty')
    refine_kwargs = dict(refine_kwargs or {})

    def polish(s):
        return refine(s, merit, **refine_kwargs).stack

    stack = polish(stack0)
    stationary = False
    rounds = 0
    for rounds in range(1, max_iters + 1):
        total_depth = float(onp.sum(to_host(stack.thicknesses)))
        if len(stack) >= max_layers or len(stack) == 0 or total_depth <= 0:
            break
        depth_grid = onp.linspace(0.0, total_depth, z_samples)
        P_best, mat_best, z_best = _best_insertion(stack, merit, materials,
                                                   depth_grid)
        if P_best >= -tol:
            stationary = True
            break

        stack, where = insert_needle(stack, z_best, mat_best,
                                     thickness=seed_thickness,
                                     return_index=True)
        stack = polish(stack)
        pruned = cleanup(stack, prune_tol=prune_tol, keep_indices=[where])
        if len(pruned) == 0:
            stack = pruned
            break
        stack = polish(pruned) if len(pruned) != len(stack) else pruned

    return NeedleResult(stack, merit.value(stack), rounds, stationary)

