"""Parabasal first-order analysis about a real chief ray.

Counterpart of ``prysm_tpu/x/raytracing/parabasal.py``.  A chief ray is
traced with four launch tangents (dx/dy/du/dv) in its transverse frame —
through ``torch.func.jvp`` on ``config.device``, one sweep per seed — and the
resulting 4x4 launch-to-image map yields per-section (x, y) EFL/BFL/FFL,
foci, and pupil geometry.  When the chief dies (clipped, TIR, ...) the
report falls back to the scalar YNU walk.

Design: the per-section extraction is decomposed into small pure helpers
(:func:`_focal_quantities`, :func:`_pupil_quantities`) fed by 2x2 section
blocks, accumulating into a plain dict that is poured into the report at
the end.  The trace and its tangents are read back to the host once, after
the sweeps; the extraction is host numpy.
"""
import numpy as np
import torch

from .launch import Field, Sampling, launch, _perp_basis
from .spencer_and_murty import (
    STYPE_REFLECT, STYPE_REFRACT, reflect, to_host, valid_mask)
from ._diff_raytrace import DiffSeed, raytrace_with_tangents
from ._resolve import trace_context
from .paraxial import _powered_landmarks

_PREC = np.float64
_SEED_NAMES = ('dx', 'dy', 'du', 'dv')

# report slots holding (x, y) section pairs
_PAIR_SLOTS = ('efl', 'bfl', 'ffl', 'paraxial_image_distance',
               'paraxial_image_z', 'fno', 'na_image', 'ep_z', 'xp_z',
               'ep_distance', 'xp_distance', 'stop_diameter', 'ep_diameter',
               'xp_diameter')


def _literal_field(field):
    if field is None:
        return Field(0.0, 0.0)
    if isinstance(field, Field):
        return field
    if np.isscalar(field):
        raise TypeError('a literal field must be an (hx, hy) pair or a '
                        f'Field, not a bare scalar; got {field!r}')
    return Field(float(field[0]), float(field[1]))


def _resolve_field(system, field):
    """Resolve the chief-ray field: system resolver first, then literals."""
    resolver = getattr(system, 'field', None)
    if not callable(resolver):
        return _literal_field(field)
    try:
        return resolver(field)
    except IndexError:
        # index 0 on a system that carries no fields means the on-axis chief
        asked_for_axis = np.isscalar(field) and float(field) == 0.0
        fields = getattr(system, 'fields', None)
        if asked_for_axis and fields is not None and len(fields) == 0:
            return Field(0.0, 0.0)
        raise


def _chief_tangent_trace(system, surfaces, the_field, wvl):
    """Trace the chief with dx/dy/du/dv launch tangents in its T/S frame."""
    P0, S0 = launch(system, the_field, wvl, Sampling.chief())
    e1, e2 = _perp_basis(np.asarray(to_host(S0)[0]))
    zero3 = np.zeros(3, dtype=_PREC)
    position_seeds = np.stack([e1, e2, zero3, zero3], axis=-1)[None, ...]
    direction_seeds = np.stack([zero3, zero3, e1, e2], axis=-1)[None, ...]
    return raytrace_with_tangents(
        surfaces, P0, S0, wvl, [DiffSeed(name=n) for n in _SEED_NAMES],
        Pdot0=position_seeds, Sdot0=direction_seeds)


def _raw_matrix(res, j_pos, j_dir, basis):
    """4x4 launch-to-surface map in the chief T/S frame at that surface.

    Rows are (x, y, theta_x, theta_y); columns are dx, dy, du, dv seeds.
    """
    e1, e2 = basis
    Pd, Sd = res.Pdot[j_pos][0], res.Sdot[j_dir][0]
    return np.stack([e1 @ Pd, e2 @ Pd, e1 @ Sd, e2 @ Sd])


def _section(M, i):
    """The 2x2 (position, angle) block of section i (0 = x, 1 = y)."""
    p, q = (0, 2) if i == 0 else (1, 3)
    return tuple(float(M[r, c]) for r in (p, q) for c in (p, q))


def _axis_crossing(y, th):
    """Distance along the chief to a ray's axis crossing, or None."""
    return None if abs(th) < 1e-30 else -y / th


def _image_space_physical_index(surfaces, wvl, n_object):
    """Physical (positive) image-space index: last refracting material."""
    refracting = [s for s in surfaces if s.typ == STYPE_REFRACT]
    return (float(refracting[-1].material.n(wvl)) if refracting
            else float(n_object))


def _project_transverse(vector, direction):
    """Drop the component along direction; renormalize unless degenerate."""
    flat = vector - float(vector @ direction) * direction
    magnitude = float(np.sqrt(flat @ flat))
    return flat / magnitude if magnitude > 1e-12 else vector


def _section_parity(trace, surfaces, e1, e2, exit_basis):
    """Orientation of the transported launch frame at the image."""
    carried = [np.array(e, dtype=_PREC, copy=True) for e in (e1, e2)]
    for j, surf in enumerate(surfaces):
        if surf.typ == STYPE_REFLECT:
            n_hat = to_host(trace.intermediates[j].n_hat)[0]
            if surf.R is not None:
                n_hat = np.asarray(to_host(surf.R), dtype=_PREC).T @ n_hat
            # Householder transport: the same flip the ray itself undergoes
            carried = [to_host(reflect(torch.as_tensor(b), torch.as_tensor(n_hat)))[0]
                       for b in carried]
        S_here = to_host(trace.S)[j + 1, 0]
        carried = [_project_transverse(b, S_here) for b in carried]
    return tuple(float(np.sign(b @ e)) or 1.0
                 for b, e in zip(carried, exit_basis))


def _collapse(pair):
    """Mean of an (x, y) pair; lone defined section if one is degenerate."""
    defined = [v for v in (pair or ()) if v is not None]
    return sum(defined) / len(defined) if defined else None


def _section_image_foci(res, from_infinity):
    """(launch_to_image, (x_z, y_z)): per-section paraxial image z from the tangents."""
    trace = res.trace
    P_img = to_host(trace.P)[-1, 0]
    S_img = to_host(trace.S)[-1, 0]
    launch_to_image = _raw_matrix(res, -1, -1, _perp_basis(S_img))

    def focus_of(i):
        A, B, C, D = _section(launch_to_image, i)
        t = (_axis_crossing(A, C) if from_infinity
             else _axis_crossing(B, D))
        return None if t is None else float(P_img[2]) + t * float(S_img[2])

    return launch_to_image, (focus_of(0), focus_of(1))


class ParabasalFirstOrder:
    """Parabasal first-order properties about a chief ray."""

    __slots__ = _PAIR_SLOTS + (
        'wavelength', 'field', 'backend', 'force_sym', 'n_object',
        'n_image', 'n_surfaces', 'n_refractive', 'n_reflective', 'n_eval',
        'total_track', 'stop_index', 'epd', 'abcd')

    def __init__(self):
        for name in type(self).__slots__:
            setattr(self, name, None)

    _ROW_LABELS = (
        ('efl', 'EFL'), ('bfl', 'BFL'), ('ffl', 'FFL'),
        ('paraxial_image_distance', 'paraxial image distance'),
        ('paraxial_image_z', 'paraxial image z'),
        ('fno', 'F/#'), ('na_image', 'NA (image)'),
        ('ep_z', 'EP z'), ('xp_z', 'XP z'),
        ('ep_distance', 'EP distance'), ('xp_distance', 'XP distance'),
        ('stop_diameter', 'stop diameter'),
        ('ep_diameter', 'EP diameter'), ('xp_diameter', 'XP diameter'),
    )

    def __repr__(self):
        """Labeled report; paired slots render X/Y section columns.

        A title with the backend, scalar metadata rows, then the
        first-order table -- two columns for the astigmatic sections,
        one when force_sym collapsed them to scalars.
        """
        lines = [f'ParabasalFirstOrder (backend: {self.backend})']
        meta = (('wavelength', self.wavelength), ('field', self.field),
                ('surfaces', self.n_surfaces),
                ('total track', self.total_track),
                ('stop index', self.stop_index), ('EPD', self.epd),
                ('n (object)', self.n_object), ('n (image)', self.n_image))
        for label, value in meta:
            if value is None:
                continue
            text = f'{value:g}' if isinstance(value, float) else f'{value}'
            lines.append(f'  {label}: {text}')
        paired = not self.force_sym
        rows = []
        for name, label in self._ROW_LABELS:
            value = getattr(self, name)
            if value is None:
                continue
            if paired:
                rows.append(f'  {label:<24}{value[0]:>12.6g} '
                            f'{value[1]:>12.6g}')
            else:
                rows.append(f'  {label:<24}{value:>12.6g}')
        if rows:
            if paired:
                lines.append('  ' + ' ' * 22 + f'{"X":>12} {"Y":>12}')
            lines.extend(rows)
        return '\n'.join(lines)


def _fill_metadata(report, tc, the_field, force_sym):
    surfaces = tc.surfaces
    report.wavelength, report.field = tc.wavelength, the_field
    report.force_sym = bool(force_sym)
    report.n_surfaces = len(surfaces)
    report.n_refractive = sum(s.typ == STYPE_REFRACT for s in surfaces)
    report.n_reflective = sum(s.typ == STYPE_REFLECT for s in surfaces)
    report.n_eval = (report.n_surfaces - report.n_refractive
                     - report.n_reflective)
    report.total_track = float(surfaces[-1].P[2]) - float(surfaces[0].P[2])
    if tc.epd is not None:
        report.epd = tc.epd
    if tc.stop_index is not None:
        if not 0 <= tc.stop_index < report.n_surfaces:
            raise IndexError(f'stop_index {tc.stop_index} outside the '
                             f'{report.n_surfaces}-surface sequence')
        report.stop_index = tc.stop_index


def _fill_from_ynu(report, system, tc):
    """Populate section pairs from the scalar YNU walk (chief failed)."""
    resolver = getattr(system, '_ynu_first_order', None)
    if resolver is not None and callable(resolver):
        fo = resolver(wvl=tc.wavelength, epd=tc.epd,
                      stop_index=tc.stop_index)
    else:
        from .paraxial import ynu_first_order
        fo = ynu_first_order(tc.surfaces, wvl=tc.wavelength, epd=tc.epd,
                             stop_index=tc.stop_index)
    report.backend = 'ynu'
    report.n_object, report.n_image = fo.n_object, fo.n_image
    for name in _PAIR_SLOTS:
        scalar = getattr(fo, name)
        setattr(report, name,
                None if scalar is None else (float(scalar),) * 2)


def _focal_quantities(into, i, blocks, geometry, landmarks, epd):
    """EFL/BFL/FFL/fno/NA + image plane for section i."""
    A, B, C, D = blocks['image']
    sigma_i, n_img_phys, n_obj = geometry['parity'][i], geometry['n_img'], \
        geometry['n_obj']
    front_powered, rear_powered, rear_active = landmarks
    C_reduced = sigma_i * n_img_phys * C
    if abs(C_reduced) > 0.999e-30:
        into['efl'][i] = -n_obj / C_reduced
        if epd is not None:
            into['fno'][i] = abs(into['efl'][i]) / epd
            into['na_image'][i] = abs(C_reduced) * epd / 2.0
        reach_f = _axis_crossing(A, C)
        if reach_f is not None and rear_powered is not None:
            focal_z = geometry['z_img'] + reach_f * geometry['s_img_z']
            into['bfl'][i] = focal_z - float(rear_powered.P[2])
        if front_powered is not None:
            reach_ffp = _axis_crossing(D, -C)
            if reach_ffp is not None:
                front_z = geometry['z0'] + reach_ffp * geometry['s0z']
                into['ffl'][i] = float(front_powered.P[2]) - front_z
    focus_z = geometry['section_foci'][i]
    if focus_z is not None:
        into['paraxial_image_z'][i] = focus_z
        if rear_active is not None:
            into['paraxial_image_distance'][i] = (focus_z
                                                  - float(rear_active.P[2]))


def _pupil_quantities(into, i, blocks, geometry, epd, from_infinity, first_z,
                      last_z):
    """Entrance/exit pupil locations and diameters for section i."""
    A, B, C, D = blocks['image']
    As, Bs, Cs, Ds = blocks['stop']
    reach_ep = _axis_crossing(Bs, -As)
    if reach_ep is not None:
        into['ep_z'][i] = geometry['z0'] + reach_ep * geometry['s0z']
        into['ep_distance'][i] = into['ep_z'][i] - first_z
    # exit pupil: the same stop-center ray carried to image space
    reach_xp = _axis_crossing(A * Bs - B * As, C * Bs - D * As)
    if reach_xp is not None:
        into['xp_z'][i] = geometry['z_img'] + reach_xp * geometry['s_img_z']
        into['xp_distance'][i] = into['xp_z'][i] - last_z

    if epd is None:
        return
    into['ep_diameter'][i] = epd
    semi = epd / 2.0
    if from_infinity:
        marg_x, marg_u = semi, 0.0
    elif reach_ep is not None and abs(reach_ep) >= 1e-30:
        marg_x, marg_u = 0.0, semi / reach_ep
    else:
        return
    semi_at_stop = abs(As * marg_x + Bs * marg_u)
    into['stop_diameter'][i] = 2.0 * semi_at_stop
    stop_det = As * Ds - Bs * Cs
    if reach_xp is not None and abs(stop_det) >= 1e-30:
        magnification = ((A * Ds - B * Cs) + reach_xp * (C * Ds - D * Cs)) / stop_det
        into['xp_diameter'][i] = into['stop_diameter'][i] * abs(magnification)


def first_order(system, field=None, wavelength=None, *,
                epd=None, stop_index=None, force_sym=False):
    """Parabasal first-order properties about a chief ray.

    force_sym collapses each (x, y) pair to its mean for the classical
    scalar report shape.
    """
    tc = trace_context(system, wavelength, chief=True,
                       epd=epd, stop_index=stop_index)
    surfaces = tc.surfaces
    if not surfaces:
        raise ValueError('first_order got an empty surface sequence')
    the_field = _resolve_field(system, field)

    report = ParabasalFirstOrder()
    _fill_metadata(report, tc, the_field, force_sym)

    res = _chief_tangent_trace(system, surfaces, the_field, tc.wavelength)
    trace = res.trace
    alive = to_host(valid_mask(trace.status, trace.P[-1]))
    tangents_finite = (np.all(np.isfinite(res.Pdot[-1]))
                       and np.all(np.isfinite(res.Sdot[-1])))
    chief_alive = bool(alive[0]) and bool(tangents_finite)
    if not chief_alive:
        _fill_from_ynu(report, system, tc)
        if force_sym:
            for name in _PAIR_SLOTS:
                setattr(report, name, _collapse(getattr(report, name)))
        return report

    report.backend = 'parabasal'
    n_obj = tc.n_object
    n_img_phys = _image_space_physical_index(surfaces, tc.wavelength, n_obj)
    report.n_object = n_obj
    report.n_image = (n_img_phys if report.n_reflective % 2 == 0
                      else -n_img_phys)

    Ph, Sh = to_host(trace.P), to_host(trace.S)
    S0, S_img = Sh[0, 0], Sh[-1, 0]
    from_infinity = the_field.kind == 'angle'

    launch_to_image, section_foci = _section_image_foci(res, from_infinity)
    report.abcd = launch_to_image
    geometry = {
        'z0': float(Ph[0, 0][2]), 's0z': float(S0[2]),
        'z_img': float(Ph[-1, 0][2]), 's_img_z': float(S_img[2]),
        'n_obj': n_obj, 'n_img': n_img_phys,
        'section_foci': section_foci,
        'parity': _section_parity(trace, surfaces, *_perp_basis(S0),
                                  exit_basis=_perp_basis(S_img)),
    }
    launch_to_stop = None
    if report.stop_index is not None:
        k = report.stop_index
        launch_to_stop = _raw_matrix(res, k + 1, k, _perp_basis(Sh[k, 0]))

    landmarks = _powered_landmarks(surfaces)
    collected = {name: [None, None] for name in _PAIR_SLOTS}
    for i in (0, 1):
        blocks = {'image': _section(launch_to_image, i)}
        _focal_quantities(collected, i, blocks, geometry, landmarks,
                          report.epd)
        if launch_to_stop is not None:
            blocks['stop'] = _section(launch_to_stop, i)
            _pupil_quantities(collected, i, blocks, geometry, report.epd,
                              from_infinity, float(surfaces[0].P[2]),
                              float(surfaces[-1].P[2]))

    for name, (x, y) in collected.items():
        if (x, y) == (None, None):
            continue
        setattr(report, name, _collapse((x, y)) if force_sym else (x, y))
    return report


def parabasal_foci(system, field, wavelength=None):
    """(x_z, y_z): T/S focus z for one field via the parabasal tangents."""
    tc = trace_context(system, wavelength)
    the_field = _resolve_field(system, field)
    res = _chief_tangent_trace(system, tc.surfaces, the_field, tc.wavelength)
    alive = to_host(valid_mask(res.trace.status, res.trace.P[-1]))
    if not bool(alive[0]):
        return (float('nan'),) * 2
    _, foci = _section_image_foci(res, the_field.kind == 'angle')
    return tuple(float(z) if z is not None else float('nan') for z in foci)


__all__ = ['ParabasalFirstOrder', 'first_order', 'parabasal_foci']
