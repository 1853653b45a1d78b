"""Prescription IO for sequential ray tracing.

Counterpart of ``prysm_tpu/x/raytracing/io``: readers/writers translating
between LensData and the text prescription formats of commercial codes
(Code V .seq, Zemax .zmx), plus the shared parser internals.
"""
from .codev import read_seq, write_seq
from .zemax import read_zmx, write_zmx
from ._surface_spec import SurfaceSpec, build_shape, build_surface

__all__ = [
    'read_seq',
    'write_seq',
    'read_zmx',
    'write_zmx',
    'SurfaceSpec',
    'build_shape',
    'build_surface',
]
