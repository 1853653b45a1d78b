"""Object/image-space medium bookkeeping over compiled surface lists.

Counterpart of ``prysm_tpu/x/raytracing/_meta.py``.  The medium on each
side of the system is found by walking the refracting surfaces in order,
carrying the most recent material's index forward.
"""
from .spencer_and_murty import STYPE_REFRACT, _is_measurement_surf


def _index_of(surface, wavelength, carried):
    """Index after ``surface``: its material's n, or the carried value."""
    material = getattr(surface, 'material', None)
    return float(carried) if material is None else float(material.n(wavelength))


def _is_eval_surface(surface):
    return _is_measurement_surf(getattr(surface, 'typ', None))


def object_space_index(surfaces, wavelength):
    """Object-space medium index from the object surface (air if absent)."""
    if hasattr(surfaces, 'to_surfaces'):
        surfaces = surfaces.to_surfaces()
    if len(surfaces) and _is_eval_surface(surfaces[0]):
        return _index_of(surfaces[0], wavelength, 1.0)
    return 1.0


def image_space_index(surfaces, wavelength, fallback=1.0):
    """Image-space medium index from an explicit image surface."""
    if len(surfaces) == 0:
        return float(fallback)
    if not _is_eval_surface(surfaces[-1]):
        raise ValueError(
            'image-space index requires a trailing eval image surface; '
            'append an explicit image surface instead of relying on a bare '
            'final powered surface.')
    carried = object_space_index(surfaces, wavelength)
    interior = surfaces[1:] if _is_eval_surface(surfaces[0]) else surfaces
    for surface in interior:
        if getattr(surface, 'typ', None) == STYPE_REFRACT:
            carried = _index_of(surface, wavelength, carried)
    return float(carried)


def object_image_indices(surfaces, wavelength):
    """(n_object, n_image); the image side falls back to the object side."""
    n_obj = object_space_index(surfaces, wavelength)
    return n_obj, image_space_index(surfaces, wavelength, fallback=n_obj)
