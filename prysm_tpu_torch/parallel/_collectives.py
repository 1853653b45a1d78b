"""Collectives over mesh axes, with the autograd rules of JAX's ``shard_map``.

A sharded function here takes every logical tensor whole on every rank
(replicated) and slices its own shard.  Its gradients must equal the
serial ones, as ``jax.grad`` of a ``shard_map`` gives them with its
varying-axis checks on.  Two functions carry that, in the spirit of
Megatron's f/g pair:

* ``psum``: all-reduce forward, identity backward.  The cotangent of a
  replicated result is replicated already; reducing it again would
  multiply the gradient by the group size (which is what
  ``torch.distributed.nn.functional.all_reduce`` does: its backward
  all-reduces).
* ``enter``: identity forward, all-reduce backward.  A replicated tensor
  that feeds rank-local work passes through it, so each rank's partial
  cotangent is summed over the axes the work varies on.

``all_to_all`` transposes a tiled layout; its backward is the opposite
all-to-all.  Each takes ``torch.func``'s transforms: a tangent goes
through the same collective as the value, and ``vmap`` runs one collective
on the batched tensor.  Complex tensors travel as ``torch.view_as_real`` views.
Collectives run on the process group's own stream (NCCL) or thread (gloo);
nothing is gathered to the host.
"""
import torch
import torch.distributed as dist

__all__ = ['axis_size', 'axis_index', 'shard', 'psum', 'enter', 'all_to_all',
           'all_reduce_']


def _names(mesh):
    return tuple(mesh.mesh_dim_names)


def _check_axis(mesh, axis):
    if axis not in _names(mesh):
        raise ValueError(f'mesh has axes {sorted(_names(mesh))}; no axis named {axis!r}')


def axis_size(mesh, axis):
    """Number of ranks along a mesh axis."""
    _check_axis(mesh, axis)
    return mesh.size(_names(mesh).index(axis))


def axis_index(mesh, axis):
    """This rank's coordinate along a mesh axis."""
    _check_axis(mesh, axis)
    return mesh.get_local_rank(axis)


def _groups(mesh, axes):
    if isinstance(axes, str):
        axes = (axes,)
    for axis in axes:
        _check_axis(mesh, axis)
    return tuple(mesh.get_group(axis) for axis in axes)


def shard(x, mesh, axis, dim, what='dimension'):
    """This rank's block of ``x`` along ``dim``, split evenly over ``axis``."""
    d = axis_size(mesh, axis)
    n = x.shape[dim]
    if n % d:
        raise ValueError(f'{what} {n} does not divide over {d} devices on axis {axis!r}')
    size = n // d
    return x.narrow(dim, axis_index(mesh, axis) * size, size)


def _buffer(x):
    """A contiguous copy of x that a collective may overwrite (lazy conjugation and
    negation resolved: a collective reads the stored values)."""
    return x.resolve_conj().resolve_neg().clone(memory_format=torch.contiguous_format)


def _real(x):
    return torch.view_as_real(x) if x.is_complex() else x


def all_reduce_(x, groups):
    """Sum contiguous ``x`` in place over each group in turn; returns x."""
    buf = _real(x)
    for group in groups:
        dist.all_reduce(buf, group=group)
    return x


class _Psum(torch.autograd.Function):
    """All-reduce forward; backward ``enter``'s forward (the identity).

    The tangent is the all-reduce of the tangent; a batch (``vmap``) is
    one all-reduce of the batched tensor.  The forward writes into a buffer
    through the collective, so no rule is generated.
    """

    @staticmethod
    def forward(x, groups):
        return all_reduce_(_buffer(x), groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.groups = inputs

    @staticmethod
    def backward(ctx, grad):
        return _Enter.apply(grad, ctx.groups), None

    @staticmethod
    def jvp(ctx, tangent, _):
        return _Psum.apply(tangent, ctx.groups)

    @staticmethod
    def vmap(info, in_dims, x, groups):
        return _Psum.apply(x, groups), in_dims[0]


class _Enter(torch.autograd.Function):
    """Identity forward; backward ``psum``'s forward (the all-reduce).

    The tangent passes unchanged; a batch passes through whole.
    """

    @staticmethod
    def forward(x, groups):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.groups = inputs

    @staticmethod
    def backward(ctx, grad):
        return _Psum.apply(grad, ctx.groups), None

    @staticmethod
    def jvp(ctx, tangent, _):
        return tangent.view_as(tangent)

    @staticmethod
    def vmap(info, in_dims, x, groups):
        return _Enter.apply(x, groups), in_dims[0]


def psum(x, mesh, axes):
    """Sum of x over the mesh axis (or axes): all-reduce forward, identity backward."""
    return _Psum.apply(x, _groups(mesh, axes))


def enter(x, mesh, axes):
    """A replicated x entering work that varies over ``axes``: identity forward,
    all-reduce backward."""
    return _Enter.apply(x, _groups(mesh, axes))


def _exchange(x, group, d, split_axis, concat_axis):
    # blocks along split_axis go to ranks in order; what comes back is
    # concatenated along concat_axis in rank order (JAX's tiled all_to_all)
    x = x.movedim(split_axis, 0)
    blocks = _buffer(x).reshape(d, x.shape[0] // d, *x.shape[1:])
    out = torch.empty_like(blocks)
    dist.all_to_all_single(_real(out), _real(blocks), group=group)
    out = out.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shape = list(out.shape)
    merged = shape[concat_axis] * shape[concat_axis + 1]
    return out.reshape(shape[:concat_axis] + [merged] + shape[concat_axis + 2:])


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all; backward and tangent are exchanges too.

    The cotangent takes the opposite exchange (split and concatenation axes
    swapped), the tangent the same one.  A batch (``vmap``) is one exchange
    of the batched tensor with both axes moved past the batch axis.
    """

    @staticmethod
    def forward(x, group, d, split_axis, concat_axis):
        return _exchange(x, group, d, split_axis, concat_axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, grad):
        group, d, split_axis, concat_axis = ctx.args
        return _AllToAll.apply(grad, group, d, concat_axis, split_axis), None, None, None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return _AllToAll.apply(tangent, *ctx.args)

    @staticmethod
    def vmap(info, in_dims, x, group, d, split_axis, concat_axis):
        x, ndim = x.movedim(in_dims[0], 0), x.ndim - 1
        return _AllToAll.apply(x, group, d, split_axis % ndim + 1, concat_axis % ndim + 1), 0


def all_to_all(x, mesh, axis, split_axis, concat_axis):
    """JAX's ``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``;
    the backward is the opposite all-to-all."""
    group, = _groups(mesh, axis)
    return _AllToAll.apply(x, group, axis_size(mesh, axis), split_axis, concat_axis)
