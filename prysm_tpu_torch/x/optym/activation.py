"""Activation functions and related nodes.

Counterpart of ``prysm_tpu/x/optym/activation.py``.  The forward/backprop
pair API is preserved for manual-chain users; every forward is also a plain
torch expression, so autograd gives the same gradients.  GumbelSoftmax
draws its uniforms from a ``torch.Generator`` where the JAX package splits
a ``jax.random`` key.
"""
import torch

from ...conf import config
from ...mathops import row_dot

__all__ = ['Softmax', 'GumbelSoftmax', 'DiscreteEncoder', 'Tanh', 'Arctan', 'Softplus',
           'Sigmoid']


class Softmax:
    """Softmax over the final axis; leading axes are independent variables."""

    def __init__(self):
        """Create a new Softmax node."""
        self.out = None
        self.in_shape = None
        self.work_shape = None

    def forward(self, x):
        """Softmax activation on logits; sum(axis=-1) == 1."""
        assert x.ndim > 1, 'softmax is meant for multiple independent variables at once'
        xx = x.reshape((-1, x.shape[-1]))
        self.in_shape = x.shape
        self.work_shape = xx.shape
        xnorm = xx - xx.max(dim=1).values[:, None]
        e_x = torch.exp(xnorm)
        self.out = e_x / e_x.sum(dim=1)[:, None]
        return self.out.reshape(self.in_shape)

    def backprop(self, grad):
        """Backpropagate grad through the last forward()."""
        assert self.out is not None, 'must run forward() before backprop()'
        grad = grad.reshape(self.work_shape)
        tmp = row_dot(grad, self.out)
        tmp = torch.broadcast_to(tmp[:, None], self.work_shape)
        gout = self.out * (grad - tmp)
        return gout.reshape(self.in_shape)


class GumbelSoftmax:
    """Softmax with stochastic Gumbel noise (Jang/Maddison et al.)."""

    def __init__(self, tau=1, eps=None, generator=None):
        """tau is the temperature; smaller positive values are more discrete.

        ``generator`` is the ``torch.Generator`` the uniforms are drawn from;
        by default one seeded with 0 on the device of the first input.
        """
        self.tau = tau
        self.eps = eps or float(torch.finfo(config.precision).eps)
        self.generator = generator
        self.smax = Softmax()

    def forward(self, x):
        """Gumbel-softmax process on x (advances the generator)."""
        if self.generator is None:
            self.generator = torch.Generator(device=x.device).manual_seed(0)
        eps = self.eps
        u = torch.rand(x.shape, generator=self.generator, dtype=x.dtype, device=x.device)
        g = -torch.log(-torch.log(u + eps) + eps)
        yy = (x + g) / self.tau
        return self.smax.forward(yy)

    def backprop(self, protograd):
        """Adjoint of forward()."""
        return self.smax.backprop(protograd) / self.tau


class DiscreteEncoder:
    """Continuous proxy for discrete-valued variables."""

    def __init__(self, estimator, levels):
        """estimator e.g. GumbelSoftmax(); levels int or array of states."""
        if isinstance(levels, int):
            levels = torch.arange(levels)
        self.est = estimator
        self.levels = torch.as_tensor(levels)
        self.tmpshape = None

    def _levels(self, like):
        return self.levels.to(like.device)[None, :]

    def forward(self, x):
        """Forward pass through the continuous proxy."""
        samples = self.est.forward(x)
        tmp = samples * self._levels(samples)
        self.tmpshape = tmp.shape
        return tmp.sum(dim=-1)

    def backprop(self, grad):
        """Backpropagation through the continuous proxy."""
        tmpbar = torch.broadcast_to(grad[:, None], self.tmpshape) * self._levels(grad)
        return self.est.backprop(tmpbar)

    def discretize(self, x):
        """Discrete encoding of x (argmax over the estimator output)."""
        encoded = self.est.forward(x)
        indices = torch.argmax(encoded, dim=-1)
        return self.levels.to(indices.device)[indices]


class _AffineActivation:
    """Base for elementwise activations y = f(a (x - x0)) + y0."""

    def __init__(self, a=1, x0=0, y0=0):
        self.a = a
        self.x0 = x0
        self.y0 = y0


class Tanh(_AffineActivation):
    """Affine-scaled hyperbolic tangent."""

    def forward(self, x):
        """tanh(a (x - x0)) + y0."""
        x = x - self.x0
        return 2 / (1 + torch.exp(-2 * self.a * x)) - 1 + self.y0

    def backprop(self, x):
        """dy/dx at x."""
        fx = self.forward(x) - self.y0
        return self.a * (1 - fx ** 2)


class Arctan(_AffineActivation):
    """Affine-scaled arctangent."""

    def forward(self, x):
        """arctan(a (x - x0)) + y0."""
        return torch.arctan(self.a * (x - self.x0)) + self.y0

    def backprop(self, x):
        """dy/dx at x."""
        u = self.a * (x - self.x0)
        return self.a / (u ** 2 + 1)


class Softplus(_AffineActivation):
    """Affine-scaled softplus."""

    def forward(self, x):
        """log(1 + exp(a (x - x0))) + y0."""
        return torch.log(1 + torch.exp(self.a * (x - self.x0))) + self.y0

    def backprop(self, x):
        """dy/dx at x."""
        return self.a / (1 + torch.exp(-self.a * (x - self.x0)))


class Sigmoid(_AffineActivation):
    """Affine-scaled logistic sigmoid."""

    def forward(self, x):
        """sigma(a (x - x0)) + y0."""
        return 1 / (1 + torch.exp(-self.a * (x - self.x0))) + self.y0

    def backprop(self, x):
        """dy/dx at x."""
        sig = self.forward(x) - self.y0
        return self.a * sig * (1 - sig)
