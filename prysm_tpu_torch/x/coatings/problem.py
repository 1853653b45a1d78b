"""Design-vector view of a coating stack for the optym optimizers.

Counterpart of ``prysm_tpu/x/coatings/problem.py``.  A
:class:`_LayerSelection` owns the variable-layer bookkeeping (pack a stack
into a design vector, scatter a design vector back); :class:`CoatingProblem`
wires that view to a merit function and the gradient engine.  A thickness
design vector stays on the stack's device: packing gathers and scattering
writes by an index tensor, so neither reads the card back.
"""
import numpy as onp
import torch

from ...conf import config
from ..optym.problem import Problem, to_host

from .stack import Stack, _real
from .merit import as_merit
from .diff import thickness_gradient, index_gradient

__all__ = ['CoatingProblem']


class _LayerSelection:
    """Which layers are free, and how they map to/from the design vector."""

    def __init__(self, stack, variable_layers, variables):
        self.variables = str(variables)
        self.layers = (list(range(len(stack))) if variable_layers is None
                       else list(variable_layers))
        self.mask = onp.zeros(len(stack), dtype=bool)
        self.mask[self.layers] = True
        self._index = torch.as_tensor(onp.flatnonzero(self.mask),
                                      device=stack.thicknesses.device)
        if variables == 'index':
            bad = [i for i in self.layers if callable(stack.indices[i])]
            if bad:
                raise TypeError('index-variable design requires numeric layer '
                                f'indices, but layer {bad[0]} is a '
                                'dispersion callable')

    def pack(self, stack):
        """Stack -> design vector of the free thicknesses or indices."""
        if self.variables == 'index':
            values = [onp.real(stack.indices[i]) for i in self.layers]
            return _real(onp.asarray(values), stack.thicknesses.device)
        everything = stack.thicknesses.detach().to(config.precision)
        return everything[self._index]

    def scatter(self, stack, x):
        """Design vector -> new Stack with the free entries replaced."""
        if self.variables == 'index':
            x = to_host(x).astype(onp.float64)
            media = list(stack.indices)
            for slot, i in enumerate(self.layers):
                media[i] = float(x[slot])
            return Stack(media, stack.thicknesses, stack.substrate_index,
                         stack.ambient_index)
        depths = stack.thicknesses.detach().to(config.precision).clone()
        depths[self._index] = _real(x if torch.is_tensor(x) else to_host(x),
                                    depths.device).to(depths.device)
        return Stack(stack.indices, depths, stack.substrate_index,
                     stack.ambient_index)


class CoatingProblem(Problem):
    """Minimize a MeritFunction over a Stack's thicknesses or indices."""

    has_fg = True

    def __init__(self, stack, merit, *, variable_layers=None,
                 variables='thickness'):
        super().__init__()
        if variables not in ('thickness', 'index'):
            raise ValueError("variables must be either 'thickness' or 'index'")
        self.stack0, self.merit = stack, as_merit(merit)
        self.variables = variables
        self.selection = _LayerSelection(stack, variable_layers, variables)
        self._grad_engine = (index_gradient if variables == 'index'
                             else thickness_gradient)

    @property
    def variable_layers(self):
        """Indices of the free layers."""
        return self.selection.layers

    def x0(self):
        """Initial design vector: variable layers' thickness or index."""
        return self.selection.pack(self.stack0)

    def stack_from_x(self, x):
        """Build a Stack with the variable thickness/index set to x."""
        return self.selection.scatter(self.stack0, x)

    def _fg(self, x):
        trial = self.stack_from_x(x)
        value, full_grad = self.merit.value_and_grad(
            trial, grad_fn=self._grad_engine)
        return value, full_grad[self.selection._index.to(full_grad.device)]

    def residuals(self, x):
        """Weighted residual vector at x (for the least-squares path)."""
        return self.merit.residuals(self.stack_from_x(x))
