"""Normalized, format-neutral surface specs shared by the IO ports.

Counterpart of ``prysm_tpu/x/raytracing/io/_surface_spec.py``.  Readers own
token semantics; this module owns shape/material semantics.  Shape
construction is table-driven: ``_SHAPE_BUILDERS`` maps a spec kind to the
constructor closure that realizes it.
"""
from dataclasses import dataclass, field
from typing import Any

from ... import materials as _materials
from ..surfaces import (Surface, Biconic, Conic, EvenAsphere, Plane,
                        Toroid, XY, Zernike)
from ._common import scale_surface_params_to_mm


@dataclass
class SurfaceSpec:
    """Format-neutral surface construction/serialization record."""

    kind: str
    typ: str
    P: Any
    n: Any = None
    params: dict = field(default_factory=dict)
    R: Any = None
    aperture: Any = None
    tilt: Any = None
    decenter: Any = None
    grating: Any = None
    coating: Any = None
    tilt_radians: bool = False
    thickness: float = 0.0


def make_surface_spec(kind, typ, material, params, length_scale=1.0):
    """Pose-free parser-neutral spec in millimeter units."""
    scaled = scale_surface_params_to_mm(kind, params, length_scale)
    return SurfaceSpec(kind, typ, None, material, scaled)


def surface_spec_factory(material, length_scale=1.0):
    """Bind parser-level material semantics and source-unit scaling."""
    mirror = material is _materials.MIRROR
    interaction = 'refl' if mirror else 'refr'
    medium = None if mirror else material

    def make(kind, params):
        return make_surface_spec(kind, interaction, medium, params,
                                 length_scale)

    return make


def surface_spec_from_row(row):
    """Normalize a LensData SurfaceRow for a writer port."""
    shape = row.build_shape()
    kind = getattr(shape, 'kind', 'callable')
    if kind == 'sphere':
        kind = 'conic'
    return SurfaceSpec(kind=kind, typ=row.typ, P=None, n=row.material,
                       params=dict(shape.params or {}),
                       aperture=row.aperture, grating=row.grating,
                       coating=row.coating, thickness=float(row.thickness))


# kind -> params -> Shape; the normalized vocabulary of the IO layer
_SHAPE_BUILDERS = {
    'plane': lambda p: Plane(),
    'conic': lambda p: Conic(p.get('c', 0.0), p.get('k', 0.0)),
    'even_asphere': lambda p: EvenAsphere(p.get('c', 0.0), p.get('k', 0.0),
                                          p.get('coefs', ())),
    'toroid': lambda p: Toroid(p['c_x'], p['c_y'], p['k_y'],
                               p.get('coefs_y', ())),
    'biconic': lambda p: Biconic(p['c_x'], p['c_y'], p.get('k_x', 0.0),
                                 p.get('k_y', 0.0)),
    'zernike': lambda p: Zernike(p.get('c', 0.0), p.get('k', 0.0),
                                 p['normalization_radius'], p['nms'],
                                 p['coefs'], norm=p.get('norm', True)),
    'xy': lambda p: XY(p.get('c', 0.0), p.get('k', 0.0),
                       p['normalization_radius'], p['mns'], p['coefs']),
}


def build_shape(spec):
    """Build the Shape object for a normalized parser spec (no pose)."""
    builder = _SHAPE_BUILDERS.get(spec.kind)
    if builder is None:
        raise NotImplementedError(f'unknown surface spec kind {spec.kind!r}')
    return builder(spec.params)


def build_surface(spec):
    """Build a posed Surface from a normalized parser spec."""
    return Surface(shape=build_shape(spec), interaction=spec.typ,
                   P=spec.P, material=spec.n, R=spec.R,
                   aperture=spec.aperture, tilt=spec.tilt,
                   decenter=spec.decenter,
                   tilt_radians=spec.tilt_radians,
                   grating=spec.grating, coating=spec.coating)


__all__ = ['SurfaceSpec', 'build_shape', 'build_surface',
           'make_surface_spec', 'surface_spec_factory',
           'surface_spec_from_row']
