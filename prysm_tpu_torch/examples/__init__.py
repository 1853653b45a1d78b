"""The JAX package's five examples (``examples/*.py``) on the port.

Each module keeps its example's functions, arguments, defaults, prints and
return value, and adds ``device=None``, which means ``config.device`` (the
card unless set).  The working precision is ``config.precision``.  Run one
with ``python -m prysm_tpu_torch.examples.<name>``.
"""
import os
import subprocess

import torch

__all__ = ['card_name']


def card_name(device):
    """``device``'s name and power limit as ``nvidia-smi`` reports them, or 'cpu'."""
    device = torch.device(device)
    if device.type != 'cuda':
        return 'cpu'
    index = torch.cuda.current_device() if device.index is None else device.index
    visible = os.environ.get('CUDA_VISIBLE_DEVICES')
    physical = visible.split(',')[index] if visible else str(index)
    out = subprocess.run(['nvidia-smi', f'--id={physical}', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
