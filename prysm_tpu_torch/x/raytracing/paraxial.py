"""Paraxial (first-order) ABCD analysis of surface sequences.

Counterpart of ``prysm_tpu/x/raytracing/paraxial.py``.  The surface list is
compiled into a lazy stream of 2x2 (y, u) ray-transfer legs
(:func:`_legs`) — gap translations and surface refractions/reflections —
and every first-order quantity is a fold over that stream.  Host-side
scalar math; a pose or index held as a tensor is read back to the host.
"""
from dataclasses import dataclass, fields

import numpy as np

from .spencer_and_murty import (STYPE_REFRACT, STYPE_REFLECT,
                                _is_measurement_surf, to_host)

_AXIAL_GEOMETRY_TOL = 1e-12
_NO_POWER = 1e-30


class NonAxialSystemError(ValueError):
    """A surface sequence is outside the centered-axial ABCD contract."""


def _require_wavelength(wvl):
    if wvl is None:
        raise ValueError('paraxial primitives need a resolved wavelength; '
                         'pass wvl= explicitly.')
    return float(wvl)


def _as_surface_list(surfaces):
    if hasattr(surfaces, 'to_surfaces'):
        raise TypeError('paraxial primitives want a compiled surface list; '
                        'call system.to_surfaces() first.')
    return list(surfaces)


def local_vertex_curvatures(surf):
    """(c_x, c_y) local vertex curvatures of a surface."""
    shape = getattr(surf, 'shape', None)
    params = (getattr(shape, 'params', None)
              or getattr(surf, 'params', None) or {})
    if 'c_x' in params and 'c_y' in params:
        return float(params['c_x']), float(params['c_y'])
    rotational = float(params.get('c', 0.0))
    return rotational, rotational


def local_x_vertex_curvature(surf):
    """Vertex curvature of the local x section."""
    return local_vertex_curvatures(surf)[0]


def local_y_vertex_curvature(surf):
    """Vertex curvature of the local y section."""
    return local_vertex_curvatures(surf)[1]


def _paraxial_curvature(surf):
    return local_y_vertex_curvature(surf)


def _interacts(surf):
    return surf.typ in (STYPE_REFLECT, STYPE_REFRACT)


def _first_order_surfaces(surfaces):
    """Validate the centered-axial contract and return a plain list."""
    surfaces = _as_surface_list(surfaces)

    def refuse(idx, why):
        raise NonAxialSystemError(
            'first-order calculations are defined on centered axial '
            f'geometry only; surface {idx} {why}.')

    for idx, surf in enumerate(surfaces):
        P = to_host(getattr(surf, 'P', (0.0, 0.0, 0.0)))
        if P.shape[0] >= 2 and not np.allclose(
                P[:2], 0.0, atol=_AXIAL_GEOMETRY_TOL, rtol=0):
            refuse(idx, 'has a decentered vertex')
        R = getattr(surf, 'R', None)
        if R is not None and not np.allclose(
                to_host(R), np.eye(3), atol=_AXIAL_GEOMETRY_TOL, rtol=0):
            refuse(idx, 'is tilted or rotated')
    return surfaces


def object_space_index(surfaces, wvl):
    """Index of the medium on the object side of the first surface."""
    if surfaces and _is_measurement_surf(getattr(surfaces[0], 'typ', None)):
        material = getattr(surfaces[0], 'material', None)
        if material is not None:
            return float(material.n(wvl))
    return 1.0


def _gap(reduced_t):
    return np.array([[1.0, reduced_t], [0.0, 1.0]])


def _power_leg(power):
    return np.array([[1.0, 0.0], [-power, 1.0]])


def _legs(surfaces, wvl, n_start, *, end_index=None,
          include_end_surface=True):
    """Yield (leg matrix, index after leg) through the surface sequence.

    Legs alternate gap translations (reduced thickness t/n) and surface
    interactions; reflections negate the running index per the signed
    ABCD convention.
    """
    n = float(n_start)
    stop_at = len(surfaces) - 1 if end_index is None else end_index
    z_prev = float(surfaces[0].P[2])
    for k, surf in enumerate(surfaces):
        if k > stop_at:
            return
        z_here = float(surf.P[2])
        if k > 0:
            yield _gap((z_here - z_prev) / n), n
        if include_end_surface or k != stop_at:
            if surf.typ == STYPE_REFLECT:
                n_after = -n
                yield _power_leg((n_after - n) * _paraxial_curvature(surf)), n_after
                n = n_after
            elif surf.typ == STYPE_REFRACT:
                n_after = float(surf.material.n(wvl))
                yield _power_leg((n_after - n) * _paraxial_curvature(surf)), n_after
                n = n_after
        z_prev = z_here


def _walk_matrix(surfaces, wvl, n_start, *, end_index=None,
                 include_end_surface=True):
    """Fold the leg stream into (ABCD matrix, exit index)."""
    surfaces = _first_order_surfaces(surfaces)
    M = np.eye(2)
    n = float(n_start)
    for leg, n in _legs(surfaces, wvl, n_start, end_index=end_index,
                        include_end_surface=include_end_surface):
        M = leg @ M
    return M, n


def system_matrix(surfaces, wvl=None):
    """2x2 ABCD system matrix in (y, u) and the signed image-space index."""
    surfaces = _first_order_surfaces(surfaces)
    wvl = _require_wavelength(wvl)
    return _walk_matrix(surfaces, wvl, object_space_index(surfaces, wvl))


def _powered_landmarks(surfaces):
    """(first powered, last powered, last interacting) surfaces."""
    front_powered = rear_powered = rear_active = None
    for surf in filter(_interacts, surfaces):
        rear_active = surf
        if _paraxial_curvature(surf) != 0.0:
            front_powered = front_powered or surf
            rear_powered = surf
    return front_powered, rear_powered, rear_active


def _drop_trailing_evals(surfaces):
    while len(surfaces) > 1 and _is_measurement_surf(
            getattr(surfaces[-1], 'typ', None)):
        surfaces.pop()
    return surfaces


def paraxial_image_distance(surfaces, wvl=None):
    """Signed distance from the last interacting vertex to the paraxial image."""
    surfaces = _drop_trailing_evals(_as_surface_list(surfaces))
    M, n_exit = system_matrix(surfaces, wvl=wvl)
    if abs(M[1, 0]) < _NO_POWER:
        raise ValueError('paraxial system has no net power; cannot solve for '
                         'an image distance from a collimated input.')
    return -M[0, 0] * n_exit / M[1, 0]


def effective_focal_length(surfaces, wvl=None):
    """System EFL from the ABCD matrix: -n_object / C."""
    surfaces, wvl = _first_order_surfaces(surfaces), _require_wavelength(wvl)
    n_obj = object_space_index(surfaces, wvl)
    M, _ = _walk_matrix(surfaces, wvl, n_obj)
    if abs(M[1, 0]) < _NO_POWER:
        raise ValueError('paraxial system has no net power; EFL is infinite.')
    return -float(n_obj) / M[1, 0]


def back_focal_length(surfaces, wvl=None):
    """Distance from the last powered vertex to the rear focal point."""
    surfaces = _first_order_surfaces(surfaces)
    rear_powered, rear_active = _powered_landmarks(surfaces)[1:]
    if rear_powered is None:
        raise ValueError('surfaces contain no powered surfaces; BFL is undefined.')
    focal_dist = paraxial_image_distance(surfaces, wvl=wvl)
    return focal_dist + (float(rear_active.P[2])
                         - float(rear_powered.P[2]))


def front_focal_length(surfaces, wvl=None):
    """Distance from the front focal point to the first powered vertex."""
    surfaces, wvl = _first_order_surfaces(surfaces), _require_wavelength(wvl)
    front_powered = _powered_landmarks(surfaces)[0]
    if front_powered is None:
        raise ValueError('surfaces contain no powered surfaces; FFL is undefined.')
    n_obj = object_space_index(surfaces, wvl)
    M, _ = _walk_matrix(surfaces, wvl, n_obj)
    if abs(M[1, 0]) < _NO_POWER:
        raise ValueError('paraxial system has no net power; FFL is infinite.')
    from_first_entry = -float(M[1, 1]) * float(n_obj) / float(M[1, 0])
    return from_first_entry + (float(front_powered.P[2])
                               - float(surfaces[0].P[2]))


def _matrix_to_plane(surfaces, k, wvl, n_start):
    return _walk_matrix(surfaces, wvl, n_start, end_index=k,
                        include_end_surface=False)


def entrance_pupil_z(surfaces, wvl=None, stop_index=None):
    """Lab-frame z of the paraxial entrance pupil (None if undefined)."""
    surfaces, wvl = _first_order_surfaces(surfaces), _require_wavelength(wvl)
    if stop_index is None or not 0 <= int(stop_index) < len(surfaces):
        return None
    M_to_stop, _ = _matrix_to_plane(surfaces, int(stop_index), wvl,
                                    object_space_index(surfaces, wvl))
    if abs(M_to_stop[0, 0]) < _NO_POWER:
        return None
    n_obj = object_space_index(surfaces, wvl)
    return (float(surfaces[0].P[2])
            + float(M_to_stop[0, 1]) * n_obj / float(M_to_stop[0, 0]))


@dataclass
class FirstOrderProperties:
    """Paraxial first-order properties of a surface sequence."""

    wavelength: float = None
    n_object: float = None
    n_image: float = None
    n_surfaces: int = None
    n_refractive: int = None
    n_reflective: int = None
    n_eval: int = None
    total_track: float = None
    efl: float = None
    bfl: float = None
    ffl: float = None
    paraxial_image_distance: float = None
    paraxial_image_z: float = None
    epd: float = None
    fno: float = None
    na_image: float = None
    stop_index: int = None
    ep_z: float = None
    xp_z: float = None
    ep_distance: float = None
    xp_distance: float = None
    stop_diameter: float = None
    ep_diameter: float = None
    xp_diameter: float = None

    _ROW_LABELS = (
        ('wavelength', 'wavelength'), ('n_surfaces', 'surfaces'),
        ('total_track', 'total track'), ('efl', 'EFL'), ('bfl', 'BFL'),
        ('ffl', 'FFL'),
        ('paraxial_image_distance', 'paraxial image distance'),
        ('epd', 'EPD'), ('fno', 'F/#'), ('na_image', 'NA (image)'),
        ('ep_z', 'EP z'), ('xp_z', 'XP z'),
        ('stop_diameter', 'stop diameter'),
        ('ep_diameter', 'EP diameter'), ('xp_diameter', 'XP diameter'),
    )

    def __repr__(self):
        """Readable report; only the populated rows appear."""
        rows = []
        for name, label in self._ROW_LABELS:
            value = getattr(self, name)
            if value is None:
                continue
            text = f'{value:g}' if isinstance(value, float) else f'{value}'
            rows.append(f'  {label}: {text}')
        return 'FirstOrderProperties(\n' + '\n'.join(rows) + '\n)'


def _fill_focal_block(summary, surfaces, M, n_obj):
    """EFL/BFL/FFL and image-plane fields of the summary."""
    A, C, D = float(M[0, 0]), float(M[1, 0]), float(M[1, 1])
    summary.efl = -float(n_obj) / C
    from_last_vertex = -A * summary.n_image / C
    summary.paraxial_image_z = float(surfaces[-1].P[2]) + from_last_vertex
    front_powered, rear_powered, rear_active = _powered_landmarks(surfaces)
    summary.paraxial_image_distance = (
        summary.paraxial_image_z - float(rear_active.P[2])
        if rear_active is not None else from_last_vertex)
    if rear_powered is not None:
        summary.bfl = summary.paraxial_image_z - float(rear_powered.P[2])
    if front_powered is not None:
        summary.ffl = (-D * float(n_obj) / C + float(front_powered.P[2])
                   - float(surfaces[0].P[2]))


def _fill_pupil_block(summary, surfaces, wvl, n_obj, k):
    """Pupil locations and diameters relative to the stop surface."""
    M_to_stop, n_at_stop = _matrix_to_plane(surfaces, k, wvl, n_obj)
    M_from_stop, _ = _walk_matrix(surfaces[k:], wvl, n_at_stop)
    A_b, B_b = float(M_to_stop[0, 0]), float(M_to_stop[0, 1])
    A_a, B_a = float(M_from_stop[0, 0]), float(M_from_stop[0, 1])
    C_a, D_a = float(M_from_stop[1, 0]), float(M_from_stop[1, 1])
    if abs(A_b) >= _NO_POWER:
        summary.ep_distance = B_b * float(n_obj) / A_b
        summary.ep_z = float(surfaces[0].P[2]) + summary.ep_distance
    if abs(D_a) >= _NO_POWER:
        summary.xp_distance = -B_a * summary.n_image / D_a
        summary.xp_z = float(surfaces[-1].P[2]) + summary.xp_distance
    if summary.epd is not None:
        summary.ep_diameter = summary.epd
        if abs(A_b) >= _NO_POWER:
            summary.stop_diameter = summary.epd * abs(A_b)
            if abs(D_a) >= _NO_POWER:
                det_from_stop = A_a * D_a - B_a * C_a
                summary.xp_diameter = summary.stop_diameter * abs(det_from_stop / D_a)


def ynu_first_order(surfaces, wvl=None, *, epd=None, stop_index=None):
    """First-order properties via the scalar YNU/ABCD matrix walk."""
    surfaces, wvl = _first_order_surfaces(surfaces), _require_wavelength(wvl)
    if not surfaces:
        raise ValueError('ynu_first_order got an empty surface sequence')
    n_obj = object_space_index(surfaces, wvl)

    summary = FirstOrderProperties(wavelength=float(wvl), n_object=float(n_obj))
    summary.n_surfaces = len(surfaces)
    summary.n_refractive = sum(s.typ == STYPE_REFRACT for s in surfaces)
    summary.n_reflective = sum(s.typ == STYPE_REFLECT for s in surfaces)
    summary.n_eval = summary.n_surfaces - summary.n_refractive - summary.n_reflective
    summary.total_track = float(surfaces[-1].P[2]) - float(surfaces[0].P[2])

    M, n_image_signed = _walk_matrix(surfaces, wvl, n_obj)
    summary.n_image = float(n_image_signed)
    has_power = abs(float(M[1, 0])) >= _NO_POWER
    if has_power:
        _fill_focal_block(summary, surfaces, M, n_obj)

    if epd is not None:
        summary.epd = float(epd)
        if has_power:
            summary.fno = abs(summary.efl) / summary.epd
            summary.na_image = abs(float(M[1, 0])) * summary.epd / 2.0

    if stop_index is not None:
        k = int(stop_index)
        if not 0 <= k < summary.n_surfaces:
            raise IndexError(f'stop_index {k} summary of range for surfaces of '
                             f'length {summary.n_surfaces}')
        summary.stop_index = k
        _fill_pupil_block(summary, surfaces, wvl, n_obj, k)
    return summary
