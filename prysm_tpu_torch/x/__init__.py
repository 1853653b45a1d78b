"""Experimental subsystems: glass models, sequential raytracing and phase-shifting interferometry.

Counterpart of ``prysm_tpu/x/__init__.py``.  Subpackages are imported
explicitly: ``from prysm_tpu_torch.x import raytracing``.
"""
