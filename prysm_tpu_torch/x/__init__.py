"""Experimental subsystems: glass models and sequential raytracing.

Counterpart of ``prysm_tpu/x/__init__.py``.  Subpackages are imported
explicitly: ``from prysm_tpu_torch.x import raytracing``.
"""
