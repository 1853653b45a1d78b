"""Checkpoint / resume for governed optimizer runs.

Counterpart of ``prysm_tpu/x/optym/checkpoint.py``.  State is every
array/scalar attribute of the optimizer object (accumulators, moment
vectors, L-BFGS history, bound arrays, iteration counters) — the objective
callable itself is not serialized and must be re-supplied at restore time.
Arrays are pickled as host numpy under the same tags and format string as
the JAX package's, so a checkpoint written by either package loads in the
other.
"""
import pickle

import numpy as onp
import torch

from ...conf import resolve_device
from .governors import Governor, GovernorDecision
from .problem import to_host

__all__ = [
    'optimizer_state', 'restore_optimizer_state',
    'save_checkpoint', 'load_checkpoint', 'CheckpointGovernor',
]

_SKIP = ('problem',)
FORMAT = 'prysm_tpu.optym.checkpoint.v1'


def _is_array(v):
    return torch.is_tensor(v) or isinstance(v, onp.ndarray)


def _snapshot_value(v):
    if _is_array(v):
        return ('array', to_host(v))
    if isinstance(v, (bool, int, float, str, bytes, type(None))):
        return ('scalar', v)
    if isinstance(v, (list, tuple)) and all(_is_array(e) for e in v) and v:
        return (type(v).__name__ + '_of_arrays', [to_host(e) for e in v])
    if isinstance(v, dict):
        return ('dict', {k: _snapshot_value(e) for k, e in v.items()})
    return None  # unsupported (callable, driver handle, ...) — skipped


def _array_like(a, like=None):
    """A host array as the kind ``like`` is: numpy stays numpy; otherwise a tensor on
    like's device (``config.device`` when like is not a tensor)."""
    if isinstance(like, onp.ndarray):
        return onp.array(a)
    device = like.device if torch.is_tensor(like) else resolve_device()
    return torch.as_tensor(onp.array(a), device=device)


def _restore_value(tagged, like=None):
    tag, v = tagged
    if tag == 'array':
        return _array_like(v, like)
    if tag == 'scalar':
        return v
    if tag in ('list_of_arrays', 'tuple_of_arrays'):
        likes = like if isinstance(like, (list, tuple)) and len(like) == len(v) else [like] * len(v)
        out = [_array_like(e, lk) for e, lk in zip(v, likes)]
        return out if tag == 'list_of_arrays' else tuple(out)
    if tag == 'dict':
        return {k: _restore_value(e) for k, e in v.items()}
    raise ValueError(f'unknown checkpoint tag {tag!r}')


def optimizer_state(optimizer):
    """Serializable state dict for any step-API optimizer."""
    state = {}
    for name, v in vars(optimizer).items():
        if name in _SKIP or name.startswith('__'):
            continue
        snap = _snapshot_value(v)
        if snap is not None:
            state[name] = snap
    return state


def restore_optimizer_state(optimizer, state):
    """Write a state dict back onto an optimizer instance.

    Each array takes the kind of the attribute it replaces: host numpy where
    the optimizer holds numpy (the SciPy driver's buffers), else a tensor on
    that attribute's device (``config.device`` where it holds none).
    """
    for name, tagged in state.items():
        setattr(optimizer, name, _restore_value(tagged, getattr(optimizer, name, None)))
    return optimizer


def save_checkpoint(path, optimizer, records=None, metadata=None):
    """Persist optimizer state (plus a light record trail) to path."""
    payload = {
        'format': FORMAT,
        'optimizer_type': type(optimizer).__name__,
        'state': optimizer_state(optimizer),
        'metadata': dict(metadata or {}),
    }
    if records is not None:
        payload['records'] = [
            {'iteration': r.iteration, 'f': float(r.f)} for r in records]
    with open(path, 'wb') as f:
        pickle.dump(payload, f)
    return path


def load_checkpoint(path, optimizer=None):
    """Load a checkpoint; restores onto optimizer when given.

    Returns the payload dict (with 'state', 'optimizer_type',
    'records', 'metadata').  When ``optimizer`` is provided its type
    must match the checkpoint's, and its state is overwritten in place.
    """
    with open(path, 'rb') as f:
        payload = pickle.load(f)
    if payload.get('format') != FORMAT:
        raise ValueError(f'{path!r} is not an optym checkpoint')
    if optimizer is not None:
        want = payload['optimizer_type']
        got = type(optimizer).__name__
        if got != want:
            raise TypeError(
                f'checkpoint holds {want} state; got a {got} instance')
        restore_optimizer_state(optimizer, payload['state'])
    return payload


class CheckpointGovernor(Governor):
    """Governor that saves the optimizer every N observed steps.

    Composes with stopping governors through AnyGovernor/AllGovernor; on
    its own it never stops the run.
    """

    def __init__(self, path, every=50):
        self.path = str(path)
        self.every = int(every)
        self._records = []

    def observe(self, record):
        """Record the step; checkpoint when the cadence divides."""
        self._records.append(record)
        if len(self._records) % self.every == 0:
            save_checkpoint(self.path, record.optimizer,
                            records=self._records)
        return GovernorDecision(False, False, '')
