"""Device meshes over the ranks of a torch.distributed process group.

Counterpart of ``prysm_tpu/parallel/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names`` are
the axis names; its device type is ``config.device``'s ('cuda': NCCL),
unless the caller sets ``config.device = 'cpu'`` (gloo).  The default
process group must be initialised first (``init_process_group`` with an
explicit address, world size and rank: nothing here discovers a cluster).
Where the JAX functions take devices, these take ranks.
"""
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..conf import resolve_device

__all__ = ['make_mesh', 'mesh_axes', 'make_hybrid_mesh', 'mesh_device']


def _world_ranks(devices):
    if devices is not None:
        return [int(r) for r in devices]
    if not dist.is_initialized():
        raise RuntimeError('a mesh spans the ranks of the default process group: call '
                           'torch.distributed.init_process_group first')
    return list(range(dist.get_world_size()))


def _device_mesh(ranks, shape, names):
    return DeviceMesh(resolve_device().type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=tuple(names))


def make_mesh(axis_sizes, devices=None):
    """Create a mesh from an ordered {axis_name: size} mapping.

    The product of sizes must equal the rank count; pass -1 for at most
    one axis to infer its size.  ``devices`` is a list of ranks (default:
    every rank of the default process group).
    """
    ranks = _world_ranks(devices)
    names = list(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    n = len(ranks)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(f'mesh sizes {sizes} do not match device count {n}')
    return _device_mesh(ranks, sizes, names)


def mesh_axes(mesh):
    """Ordered axis names of a mesh."""
    return tuple(mesh.mesh_dim_names)


def make_hybrid_mesh(dcn_axes, ici_axes, devices=None):
    """A mesh with slow (inter-host) and fast (intra-host) axes.

    dcn_axes / ici_axes are ordered {name: size} mappings; the inter-host
    axes come first and the ranks are laid out host-major, as
    ``init_process_group`` numbers them (rank = host * ranks_per_host +
    local rank), so a collective over the leading axes crosses hosts and
    one over the trailing axes stays on a host's NVLink.
    """
    ranks = _world_ranks(devices)
    names = tuple(dcn_axes) + tuple(ici_axes)
    shape = tuple(dcn_axes.values()) + tuple(ici_axes.values())
    want = int(np.prod(shape))
    if want != len(ranks):
        raise ValueError(f'hybrid mesh wants {want} devices, have {len(ranks)}')
    return _device_mesh(ranks, shape, names)


def mesh_device(mesh):
    """The torch.device this rank's shards live on: its card for a CUDA mesh."""
    if mesh.device_type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(mesh.device_type)
