"""Ray-optics analysis: wavefront, spots, fans, distortion, color.

Counterpart of ``prysm_tpu/x/raytracing/analysis.py``.  Grid arrays are
indexed [field_index, wavelength_index, sample_index].  Host numpy
orchestration over the trace kernel, which runs on ``config.device``;
every trace is read back with ``to_host``, a few rays at a time for the
chief-ray probes (exit pupil, distortion, colour).
"""
from dataclasses import dataclass, field as _dc_field
from typing import NamedTuple

import numpy as np
import torch

from ...conf import config
from ...polynomials import zernike_nm_seq, lstsq

from .spencer_and_murty import _is_measurement_surf, raytrace, to_host, valid_mask
from .opt import (_pupil_center_chief_index, centroid_referenced_max,
                  centroid_referenced_rms, hopkins_eic_closing,
                  reference_sphere_curvature, xp_reference_sphere)
from .paraxial import NonAxialSystemError, paraxial_image_distance
from .launch import _apply_vignetting, Field, Sampling
from ._trace_grid import (  # NOQA: F401
    TraceRecord, _require_epd, _resolve_fields, _resolve_wavelengths,
    field_sweep, iter_trace_grid, trace_cell)
from ._resolve import (compiled_surfaces, resolve_wavelength,
                       trace_context)

_PREC = np.float64


@dataclass(frozen=True)
class DistortionResult:
    """Chief-ray vs paraxial-proxy image landings and percent distortion."""

    real_xy: object
    paraxial_xy: object
    percent: object
    fields: object = None
    unit: str = 'percent'
    reference: str = 'paraxial'


@dataclass(frozen=True)
class FieldCurvatureResult:
    """X/Y-fan parabasal focus z per field."""

    x_fan_z: object
    y_fan_z: object
    fields: object = None
    labels: object = None
    image_z: object = None
    unit: str = 'mm'
    reference: str = 'global_z'


class RayFanGrid(NamedTuple):
    """Transverse ray-aberration fans over field x wavelength."""

    fields: tuple
    wavelengths: object
    pupil_x: object
    pupil_y: object
    x: object
    y: object
    unit: str
    reference: str


class OPDFanGrid(NamedTuple):
    """Wavefront (OPD) fans over field x wavelength."""

    fields: tuple
    wavelengths: object
    pupil_x: object
    pupil_y: object
    x: object
    y: object
    unit: str
    reference: str


class SpotGrid(NamedTuple):
    """Image-plane spot landings over field x wavelength."""

    fields: tuple
    wavelengths: object
    x: object
    y: object
    valid: object
    anchor_xy: object
    unit: str
    reference: str


class FullFieldGrid(NamedTuple):
    """A scalar image-quality metric sampled over the field disc."""

    hx: object
    hy: object
    data: object
    metric: str
    kind: str
    unit: str
    data_unit: str
    reference: str


_AXIS_SLOTS = {'x': 0, 'y': 1}


def _axis_index(axis):
    try:
        return _AXIS_SLOTS[axis]
    except KeyError:
        raise ValueError(f"axis must be 'x' or 'y', got {axis!r}") from None


def _reference_value(samples, alive, reference, chief_index, *,
                     allow_none=False):
    """The anchor point shared by the fan and spot analyses."""
    samples = to_host(samples)
    if reference == 'centroid':
        return np.mean(samples[alive], axis=0)
    if reference == 'chief':
        if not bool(alive[chief_index]):
            raise ValueError('the chief ray is invalid; pass '
                             'reference="centroid" for an obscured or '
                             'vignetted bundle')
        return samples[chief_index]
    if reference is None and allow_none:
        return np.zeros(samples.shape[1:], dtype=samples.dtype)
    choices = ("'centroid', 'chief', or None" if allow_none
               else "'centroid' or 'chief'")
    raise ValueError(f'{reference!r} is not a reference mode; use {choices}')


def _center_valid(samples, alive, reference, chief_index, *,
                  allow_none=False):
    """Anchor-subtract samples and NaN-out invalid rays."""
    samples = np.array(samples, copy=True)
    anchor = _reference_value(samples, alive, reference, chief_index,
                              allow_none=allow_none)
    centered = samples - anchor
    centered[~alive] = np.nan
    return centered, anchor


def resolve_exit_pupil(system, wavelength, *, stop_index=None,
                       epd=None, field=None, chief=None, axis_point=None,
                       axis_dir=None, min_perp=1e-6, return_mode=False):
    """Exit-pupil reference point P_xp for a wavefront evaluation.

    Paraxial stop route when available, chief-axis closest approach
    otherwise; None for image-space telecentric.
    """
    def _package(P_xp, mode):
        if return_mode:
            return P_xp, mode
        return P_xp

    stop_slot = (getattr(system, 'stop_index', None)
                 if stop_index is None else stop_index)
    if stop_slot is not None:
        try:
            summary = _first_order_summary(system, wavelength, epd,
                                           stop_slot)
        except NonAxialSystemError:
            # no centered ABCD; only an explicit-axis call may go geometric
            if axis_dir is None and axis_point is None:
                raise
        else:
            if summary.xp_z is None:
                return _package(None, 'paraxial')
            return _package(np.array([0.0, 0.0, float(summary.xp_z)],
                                     dtype=_PREC), 'paraxial')

    if chief is not None:
        chief_end_P, chief_end_S = chief
    else:
        chief_end_P, chief_end_S = _chief_endpoint(system, field,
                                                   wavelength, epd)
    _, _, P_xp = xp_reference_sphere(chief_end_P, chief_end_S,
                                     axis_point=axis_point,
                                     axis_dir=axis_dir, min_perp=min_perp)
    return _package(np.asarray(to_host(P_xp), dtype=_PREC), 'geometric')


def _first_order_summary(system, wavelength, epd, stop_slot):
    """YNU summary through a system cache when one exists."""
    cached = getattr(system, '_ynu_first_order', None)
    if callable(cached):
        return cached(wvl=wavelength, epd=epd, stop_index=stop_slot)
    from .paraxial import ynu_first_order as _ynu_fo
    return _ynu_fo(compiled_surfaces(system), wvl=wavelength,
                           epd=epd, stop_index=stop_slot)


def _chief_endpoint(system, field, wavelength, epd):
    """Final (P, S) of a traced pupil-center chief ray."""
    if field is None:
        field = Field(0.0, 0.0)
    if epd is None:
        resolver = getattr(system, 'entrance_pupil_diameter', None)  # cached
        if callable(resolver):
            epd = resolver(wavelength)
    if epd is None:
        epd = 1.0  # the chief is a single pupil-center ray
    probe = trace_cell(system, field, wavelength, Sampling.chief(),
                       epd=epd).trace
    return to_host(probe.P)[-1, 0], to_host(probe.S)[-1, 0]


# ---------- transverse ray aberration ---------------------------------------

def transverse_ray_aberration(P_hist, axis='y', chief_index=None,
                              status=None, reference='chief'):
    """(pupil, delta): image-plane offset vs pupil coordinate per ray."""
    track = to_host(P_hist)
    ax = _axis_index(axis)
    if chief_index is None:
        chief_index = _pupil_center_chief_index(track[0])
    at_pupil, at_image = track[0, :, ax], track[-1, :, ax]
    alive = to_host(valid_mask(status, track[-1]))

    if reference == 'chief':
        pupil_anchor = at_pupil[chief_index]
    elif reference == 'centroid':
        pupil_anchor = np.mean(at_pupil[alive])
    else:
        pupil_anchor = _reference_value(at_pupil, alive, reference,
                                        chief_index)
    image_anchor = _reference_value(at_image, alive, reference, chief_index)
    return at_pupil[alive] - pupil_anchor, at_image[alive] - image_anchor


def spot_positions(P_final, status=None, origin=None):
    """(x, y) valid image-plane spot landings, optionally re-centered."""
    P_final = to_host(P_final)
    x, y = P_final[..., 0], P_final[..., 1]
    if status is not None:
        alive = to_host(valid_mask(status, P_final))
        x, y = x[alive], y[alive]
    if origin is None:
        return x, y
    if isinstance(origin, str):
        if origin.lower() != 'centroid':
            raise ValueError("the only origin string is 'centroid'")
        origin = (np.nanmean(x), np.nanmean(y))
    origin = to_host(origin)
    return x - origin[0], y - origin[1]


# ---------- wavefront --------------------------------------------------------

def _packed_chief_index(alive, chief_index):
    alive_slots = np.flatnonzero(alive)
    return int(np.flatnonzero(alive_slots == chief_index)[0])


def _resolve_chief_index(P, alive, reference, chief_index):
    if chief_index is not None:
        return int(chief_index)
    return _pupil_center_chief_index(
        to_host(P), alive if reference == 'centroid' else None)


def _require_valid_chief(alive, chief_index, reference='chief'):
    if bool(alive[chief_index]):
        return
    if reference == 'chief':
        raise ValueError(
            'the chief ray is invalid, so no reference sphere exists.  '
            "Pass reference='centroid' for an obscured or vignetted "
            'bundle.')
    raise ValueError(
        f'the anchor ray (chief_index={chief_index}) is invalid; pass a '
        'chief_index that survives the trace, or omit it so the center '
        'the surviving ray nearest the pupil center')


@dataclass
class ReferenceSphereClosing:
    """Chief-zeroed OPD plus the reusable reference-sphere geometry."""

    opd: object
    curvature: float
    packed_chief: int
    R: float
    delta: object


def close_on_reference_sphere(trace, valid, chief_index, *,
                              center, P_xp,
                              n_image, curvature=None):
    """Close a traced bundle onto the chief-image reference sphere."""
    center = to_host(center)
    curvature = (reference_sphere_curvature(P_xp, center)
                 if curvature is None else float(curvature))
    if P_xp is None:
        delta, R = None, np.inf
    else:
        delta = np.asarray(P_xp, dtype=center.dtype) - center
        R = float(np.linalg.norm(delta))
    packed_chief = _packed_chief_index(valid, chief_index)
    P, S = to_host(trace.P), to_host(trace.S)
    OPL = to_host(trace.OPL)
    opd = hopkins_eic_closing(P[:, valid], S[:, valid], OPL[:, valid],
                              center=center, curvature=curvature,
                              n_image=n_image, chief_index=packed_chief)
    return ReferenceSphereClosing(opd, curvature, packed_chief, R, delta)


@dataclass
class WavefrontClosing:
    """Closed wavefront of one bundle, with the geometry that made it."""

    opd: object
    valid: object
    chief_index: int
    center: object
    P_xp: object
    xp_mode: str
    curvature: float
    R: float
    delta: object
    packed_chief: int
    n_image: float


def close_wavefront(system, trace, wavelength, chief_index, *,
                    field=None, center=None, P_xp=None, stop_index=None,
                    epd=None, axis_point=None, axis_dir=None,
                    min_perp=1e-6, valid=None, reference='chief',
                    apply_field_tilt=True, ctx=None):
    """Close a traced bundle into a chief-referenced OPD.

    Owns validity, medium indices, exit-pupil resolution, EIC closed,
    and the launch-plane field-tilt ramp.
    """
    if valid is None:
        valid = to_host(valid_mask(trace.status, trace.P[-1]))
    chief_index = int(chief_index)
    _require_valid_chief(valid, chief_index, reference=reference)
    ctx = trace_context(system, wavelength) if ctx is None else ctx
    chief_P_end = to_host(trace.P)[-1, chief_index]
    center = chief_P_end if center is None else center
    if P_xp is not None:
        xp_mode = 'fixed'
    else:
        P_xp, xp_mode = resolve_exit_pupil(
            system, wavelength, stop_index=stop_index,
            epd=epd,
            chief=(chief_P_end, to_host(trace.S)[-1, chief_index]),
            axis_point=axis_point, axis_dir=axis_dir,
            min_perp=min_perp, return_mode=True)
    if P_xp is not None:
        P_xp = np.asarray(to_host(P_xp), dtype=_PREC)
    closed = close_on_reference_sphere(trace, valid, chief_index,
                                       center=center, P_xp=P_xp,
                                       n_image=ctx.n_image)
    opd = closed.opd
    if field is not None and apply_field_tilt:
        ax, ay = field.angle_radians()
        at_launch = to_host(trace.P)[0]
        pupil_u = at_launch[valid, 0] - at_launch[chief_index, 0]
        pupil_v = at_launch[valid, 1] - at_launch[chief_index, 1]
        opd = opd + (np.sin(ax) * pupil_u + np.sin(ay) * pupil_v)
    return WavefrontClosing(opd, valid, chief_index, center, P_xp,
                            xp_mode, closed.curvature, closed.R,
                            closed.delta, closed.packed_chief, ctx.n_image)


def _wavefront_from_trace(system, P, wavelength, trace, *,
                          P_xp=None,
                          chief_index=None, pupil_coords=None,
                          field=None, output='length', reference='chief'):
    """Wavefront kernel for callers that already hold the trace."""
    alive = to_host(valid_mask(trace.status, trace.P[-1]))
    P = to_host(P)
    chief_index = _resolve_chief_index(P, alive, reference, chief_index)
    closed = close_wavefront(system, trace, wavelength, chief_index,
                             field=field, P_xp=P_xp, valid=alive,
                             reference=reference,
                             apply_field_tilt=(pupil_coords is None))
    if pupil_coords is None:
        pupil_u = P[alive, 0] - P[chief_index, 0]
        pupil_v = P[alive, 1] - P[chief_index, 1]
        tilt_field = None
    else:
        pupil_u = to_host(pupil_coords[0])[alive]
        pupil_v = to_host(pupil_coords[1])[alive]
        tilt_field = field
    opd, _ = _apply_field_and_output(closed.opd, pupil_u, pupil_v,
                                     tilt_field, output, wavelength)
    return opd, pupil_u, pupil_v, alive


def _apply_field_and_output(opd, pupil_u, pupil_v, field, output,
                            wavelength):
    """Field-tilt removal and length/waves scaling."""
    if field is not None:
        ax, ay = field.angle_radians()
        opd = opd + (np.sin(ax) * pupil_u + np.sin(ay) * pupil_v)
    try:
        scale = {'length': 1.0,
                 'waves': -1.0 / (float(wavelength) * 1e-3)}[output]
    except KeyError:
        raise ValueError(f"output must be 'length' or 'waves', got "
                         f'{output!r}') from None
    return opd * scale, scale


def wavefront(system, P, S, wavelength=None, *, P_xp=None, chief_index=None,
              pupil_coords=None, field=None, output='length',
              reference='chief'):
    """(opd, x_pupil, y_pupil): OPD on the chief-centered reference sphere."""
    if reference not in {'chief', 'centroid'}:
        raise ValueError(f"reference must be 'chief' or 'centroid', "
                         f'got {reference!r}')
    wavelength = resolve_wavelength(system, wavelength)
    trace = raytrace(compiled_surfaces(system), P, S,
                     wavelength)
    opd, pupil_u, pupil_v, _ = _wavefront_from_trace(
        system, P, wavelength, trace, P_xp=P_xp, chief_index=chief_index,
        pupil_coords=pupil_coords, field=field, output=output,
        reference=reference)
    return opd, pupil_u, pupil_v


def wavefront_zernike_fit(opd, x_pupil, y_pupil, nms, *, norm=True,
                          normalization_radius=None):
    """(coefs, residual_rms): least-squares Zernike fit of a wavefront.

    The coefficients carry the OPD's units (length, or waves when the OPD
    is in waves) per unit-RMS Zernike mode over the normalization disk
    (``norm=True``); the pupil coordinates are divided by the normalization
    radius.  The fit runs in ``config.precision`` on ``config.device``;
    coefficients come back as host numpy.
    """
    opd, u, v = (to_host(a) for a in (opd, x_pupil, y_pupil))
    finite = np.isfinite(opd) & np.isfinite(u) & np.isfinite(v)
    if not finite.any():
        raise ValueError('the fit needs at least one finite OPD sample')
    opd, u, v = opd[finite], u[finite], v[finite]
    radius_sq = u * u + v * v
    if normalization_radius is None:  # default: tight circumscribing radius
        normalization_radius = float(np.sqrt(radius_sq.max()))
    if not normalization_radius > 0.0:
        raise ValueError('normalization_radius must be positive; got '
                         f'{normalization_radius}')
    def working(a):
        return torch.as_tensor(a, dtype=config.precision, device=config.device)

    rho = np.sqrt(radius_sq) / normalization_radius
    basis = zernike_nm_seq(nms, working(rho), working(np.arctan2(v, u)),
                           norm=norm)
    opd_t = working(opd)
    coefs = lstsq(basis, opd_t)
    misfit = opd_t - torch.tensordot(coefs, basis, dims=1)
    return to_host(coefs), float(torch.sqrt(torch.mean(misfit * misfit)))


# ---------- distortion -------------------------------------------------------

def distortion(system, fields=None, wavelength=None, *,
               epd=None,
               paraxial_fraction=1e-4, pupil_z=None,
               distortion_type='f-tan', samples=101):
    """Per-field chief-ray image error vs a generalized paraxial map."""
    wavelength = resolve_wavelength(system, wavelength)
    epd = _require_epd(system, epd, wavelength)  # distortion needs a pupil
    fields = field_sweep(system, fields, int(samples))
    if distortion_type not in ('f-tan', 'linear-angle'):
        raise ValueError("distortion_type must be 'f-tan' or "
                         f"'linear-angle', got {distortion_type!r}")
    if paraxial_fraction <= 0:
        raise ValueError('paraxial_fraction must be a positive step')

    n_fields = len(fields)
    chief_landings = np.zeros((n_fields, 2), dtype=_PREC)
    ideal_landings = np.zeros((n_fields, 2), dtype=_PREC)
    percent = np.zeros(n_fields, dtype=_PREC)
    chief = Sampling.chief()

    # two basis launches retain anamorphic scale and x/y coupling
    on_axis = Field(0.0, 0.0, kind='angle', unit='rad')
    axis_cell = trace_cell(system, on_axis, wavelength, chief, epd=epd,
                           pupil_z=pupil_z)
    axis_landing = to_host(axis_cell.trace.P)[-1, 0, :2]
    field_to_image = np.zeros((2, 2), dtype=_PREC)
    for axis in range(2):
        def probe_landing(sign):
            angles = [0.0, 0.0]
            angles[axis] = sign * float(paraxial_fraction)
            cell = trace_cell(system,
                              Field(*angles, kind='angle', unit='rad'),
                              wavelength, chief, epd=epd, pupil_z=pupil_z)
            return to_host(cell.trace.P)[-1, 0, :2]

        field_to_image[:, axis] = ((probe_landing(+1.0)
                                    - probe_landing(-1.0))
                                   / (2.0 * float(paraxial_fraction)))

    for i, fld in enumerate(fields):
        ax, ay = fld.angle_radians()
        chief_cell = trace_cell(system, fld, wavelength, chief, epd=epd,
                                pupil_z=pupil_z)
        chief_landings[i] = to_host(chief_cell.trace.P)[-1, 0, :2]
        field_vec = (np.array([ax, ay], dtype=_PREC)
                     if distortion_type == 'linear-angle'
                     else np.array([np.tan(ax), np.tan(ay)], dtype=_PREC))
        ideal_landings[i] = axis_landing + field_to_image @ field_vec

        ideal_offset = ideal_landings[i] - axis_landing
        chief_offset = chief_landings[i] - axis_landing
        ideal_height = float(np.hypot(*ideal_offset))
        if ideal_height > 0.0:
            # signed: project the chief_cell landing onto the ideal image-height
            # direction (positive pincushion, negative barrel)
            real_height = float(np.dot(chief_offset, ideal_offset)) / ideal_height
            percent[i] = 100.0 * (real_height - ideal_height) / ideal_height

    return DistortionResult(
        chief_landings, ideal_landings, percent, tuple(fields),
        unit='percent', reference=f'paraxial:{distortion_type}')


# ---------- field curvature --------------------------------------------------

_AXISYMMETRIC_KINDS = ('plane', 'conic', 'sphere', 'even_asphere')


def _field_is_pure_y(field):
    return abs(float(getattr(field, 'hx', 0.0))) < 1.000001e-12


def _system_is_axisymmetric(system):
    compiler = getattr(system, 'to_surfaces', None)
    prescription = compiler() if callable(compiler) else list(system)

    def symmetric(surf):
        if getattr(surf, 'R', None) is not None:
            return False
        P = np.asarray(to_host(getattr(surf, 'P', (0, 0, 0))), dtype=float)
        return (not np.any(np.abs(P[:2]) > 1e-12)
                and getattr(getattr(surf, 'shape', None), 'kind', None)
                in _AXISYMMETRIC_KINDS)

    return all(symmetric(surf) for surf in prescription)


def _field_curvature_labels(system, fields):
    fields = list(fields)
    meridional_only = fields and all(map(_field_is_pure_y, fields))
    if meridional_only and _system_is_axisymmetric(system):
        return ('S', 'T'), ('sagittal', 'tangential')
    return ('X', 'Y'), ('x fan', 'y fan')


def field_curvature(system, fields=None, wavelength=None, *, samples=101):
    """X- and y-section parabasal focus z per field point."""
    from .parabasal import parabasal_foci  # local: avoid a circular import

    ctx = trace_context(system, wavelength)
    wavelength = ctx.wavelength
    fields = field_sweep(system, fields, int(samples))
    n_fields = len(fields)
    x_section_focus = np.zeros(n_fields, dtype=_PREC)
    y_section_focus = np.zeros(n_fields, dtype=_PREC)
    for i, fld in enumerate(fields):
        x_section_focus[i], y_section_focus[i] = parabasal_foci(
            system, fld, wavelength)
    labels, _ = _field_curvature_labels(ctx.surfaces, fields)
    return FieldCurvatureResult(
        x_section_focus, y_section_focus, tuple(fields), labels,
        image_z=float(ctx.surfaces[-1].P[2]),
        unit=getattr(system, 'unit', None) or 'mm', reference='global_z')


# ---------- color ------------------------------------------------------------

def _system_wavelength_range(system):
    carried = getattr(system, 'wavelengths', None)
    if not (carried is not None and len(carried)):
        return None
    as_floats = [float(w) for w in carried]
    return min(as_floats), max(as_floats)


def _chromatic_wavelength_samples(system, wavelengths, samples):
    if wavelengths is not None:
        return np.asarray([float(w) for w in wavelengths], dtype=_PREC)
    wvl_span = _system_wavelength_range(system)
    if wvl_span is None:
        raise TypeError('wavelengths is required unless the system carries '
                        'wavelength metadata')
    return np.linspace(*wvl_span, int(samples), dtype=_PREC)


def _best_focus_shift_from_trace(P_final, S_final, status=None):
    """Axial shift minimizing centroid-referenced RMS spot radius."""
    P_final, S_final = to_host(P_final), to_host(S_final)
    alive = (to_host(valid_mask(status, P_final))
             & np.isfinite(S_final).all(axis=1)
             & (np.abs(S_final[:, 2]) > 1e-30))
    if not alive.any():
        raise ValueError('best focus needs at least one valid ray')

    xy = P_final[alive][:, :2]
    slopes = S_final[alive][:, :2] / S_final[alive][:, 2:3]
    xy = xy - np.mean(xy, axis=0)
    slopes = slopes - np.mean(slopes, axis=0)
    steepness = float(np.sum(slopes * slopes))
    if steepness <= 0.0:
        return 0.0
    return -float(np.sum(xy * slopes)) / steepness


def _best_focus_z(system, wavelength, *, epd, field, sampling):
    if field is None:
        field = Field(0.0, 0.0, unit='deg')
    if sampling is None:
        sampling = Sampling.hex(nrings=8)
    rec = trace_cell(system, field, wavelength, sampling, epd=epd)
    refocus = _best_focus_shift_from_trace(rec.trace.P[-1], rec.trace.S[-1],
                                      rec.trace.status)
    return float(compiled_surfaces(system)[-1].P[2]) + refocus


def _chromatic_focus_z(system, wavelength, focus, *, epd, field, sampling):
    prescription = compiled_surfaces(system)
    if focus == 'paraxial':
        trimmed = prescription
        while len(trimmed) > 1 and _is_measurement_surf(
                getattr(trimmed[-1], 'typ', None)):
            trimmed = trimmed[:-1]
        return (float(trimmed[-1].P[2])
                + float(paraxial_image_distance(prescription,
                                                wvl=wavelength)))
    if focus == 'best':
        return _best_focus_z(system, wavelength, epd=epd, field=field,
                             sampling=sampling)
    raise ValueError(f"focus must be 'best' or 'paraxial', got {focus!r}")


def chromatic_focal_shift(system, wavelengths=None, *,
                          reference_wavelength=None, focus='best',
                          epd=None, field=None, sampling=None, samples=101):
    """(wavelengths, shift): best-focus shift as a function of wavelength."""
    wavelengths = _chromatic_wavelength_samples(system, wavelengths, samples)
    if reference_wavelength is None:
        reference_wavelength = resolve_wavelength(system, None)
    reference_wavelength = float(reference_wavelength)
    focus = focus.lower()
    focus_curve = np.array([
        _chromatic_focus_z(system, float(w), focus, epd=epd, field=field,
                           sampling=sampling)
        for w in wavelengths
    ], dtype=_PREC)

    ref = _chromatic_focus_z(system, reference_wavelength, focus, epd=epd,
                             field=field, sampling=sampling)
    return wavelengths, focus_curve - ref


def lateral_color(system, fields=None, wavelengths=None, *, epd=None,
                  samples=101):
    """Chief-ray landing at every (field, wavelength): (n_fld, n_wvl, 2)."""
    epd = _require_epd(system, epd)
    fields = field_sweep(system, fields, samples)
    wavelengths = _resolve_wavelengths(system, wavelengths)
    landings = np.zeros((len(fields), len(wavelengths), 2), dtype=_PREC)
    for rec in iter_trace_grid(system, fields, wavelengths,
                               Sampling.chief(), epd=epd):
        landings[rec.i, rec.j] = to_host(rec.trace.P)[-1, 0, :2]
    return landings


# ---------- grid analyses ----------------------------------------------------

def _fan_grid_setup(system, fields, wavelengths, nrays, distribution):
    fields = _resolve_fields(system, fields)
    wavelengths = _resolve_wavelengths(system, wavelengths)
    u_fan = Sampling.fan(n=nrays, axis='x', distribution=distribution)
    v_fan = Sampling.fan(n=nrays, axis='y', distribution=distribution)
    u_samples, v_samples = u_fan.build(1.0), v_fan.build(1.0)
    nrays = u_samples.shape[0]
    pupil_x = np.empty((len(fields), nrays), dtype=_PREC)
    pupil_y = np.empty((len(fields), nrays), dtype=_PREC)
    for i, fld in enumerate(fields):
        pupil_x[i] = _apply_vignetting(u_samples, fld)[:, 0]
        pupil_y[i] = _apply_vignetting(v_samples, fld)[:, 1]
    shape = (len(fields), len(wavelengths), nrays)
    x = np.full(shape, np.nan, dtype=_PREC)
    y = np.full(shape, np.nan, dtype=_PREC)
    return fields, wavelengths, u_fan, v_fan, pupil_x, pupil_y, x, y


def _fan_image_error(record, axis, reference):
    """NaN-padded reference-subtracted image error of one fan."""
    ax = _axis_index(axis)
    image = to_host(record.trace.P)[-1, :, ax]
    center_slot = _pupil_center_chief_index(to_host(record.P))
    centered, _ = _center_valid(image, record.valid, reference, center_slot)
    return centered


def ray_aberration_fans(system, fields=None, wavelengths=None, *,
                        nrays=21, epd=None, distribution='uniform',
                        reference='chief'):
    """RayFanGrid of transverse ray aberrations per field x wavelength."""
    fields, wavelengths, u_fan, v_fan, pupil_x, pupil_y, x, y = \
        _fan_grid_setup(system, fields, wavelengths, nrays, distribution)
    for u_rec, v_rec in zip(
            iter_trace_grid(system, fields, wavelengths, u_fan, epd=epd),
            iter_trace_grid(system, fields, wavelengths, v_fan, epd=epd)):
        x[u_rec.i, u_rec.j] = _fan_image_error(u_rec, 'x', reference)
        y[v_rec.i, v_rec.j] = _fan_image_error(v_rec, 'y', reference)
    return RayFanGrid(
        tuple(fields), np.asarray(wavelengths, dtype=_PREC),
        pupil_x, pupil_y, x, y,
        getattr(system, 'unit', None) or 'mm', reference)


def _exit_pupil_for(system, wavelength, *, field=None, stop_index=None,
                    epd=None):
    if hasattr(system, 'exit_pupil') and hasattr(system, 'lens'):
        return system.exit_pupil(wavelength, field=field,
                                 stop_index=stop_index, epd=epd)
    return resolve_exit_pupil(system, wavelength, stop_index=stop_index,
                              epd=epd, field=field)


def _opd_fan(system, record, tilt_field, P_xp, output, fan_width):
    opd, _, _, valid = _wavefront_from_trace(
        system, record.P, record.wvl, record.trace, P_xp=P_xp,
        field=tilt_field, output=output)
    full = np.full(fan_width, np.nan, dtype=_PREC)
    full[valid] = opd
    return full


def opd_fans(system, fields=None, wavelengths=None, *, nrays=21,
             epd=None, distribution='uniform', stop_index=None,
             output='waves'):
    """OPDFanGrid of wavefront fans per field x wavelength."""
    fields, wavelengths, u_fan, v_fan, pupil_x, pupil_y, x, y = \
        _fan_grid_setup(system, fields, wavelengths, nrays, distribution)
    fan_width = pupil_x.shape[-1]
    for u_rec, v_rec in zip(
            iter_trace_grid(system, fields, wavelengths, u_fan, epd=epd),
            iter_trace_grid(system, fields, wavelengths, v_fan, epd=epd)):
        field = v_rec.field
        tilt_field = (field if getattr(field, 'kind', 'angle') == 'angle'
                      else None)
        P_xp = _exit_pupil_for(system, v_rec.wvl, field=field,
                               stop_index=stop_index, epd=v_rec.epd)
        x[u_rec.i, u_rec.j] = _opd_fan(system, u_rec, tilt_field, P_xp, output,
                                 fan_width)
        y[v_rec.i, v_rec.j] = _opd_fan(system, v_rec, tilt_field, P_xp, output,
                                 fan_width)
    unit = 'waves' if output == 'waves' else (
        getattr(system, 'unit', None) or 'mm')
    return OPDFanGrid(
        tuple(fields), np.asarray(wavelengths, dtype=_PREC),
        pupil_x, pupil_y, x, y, unit, 'chief')


def spot_diagrams(system, fields=None, wavelengths=None, *,
                  sampling=None, epd=None, reference='centroid'):
    """SpotGrid of image-plane landings per field x wavelength."""
    fields = _resolve_fields(system, fields)
    wavelengths = _resolve_wavelengths(system, wavelengths)
    if sampling is None:
        sampling = Sampling.hex(nrings=6)
    n_fld = len(fields)
    n_wvl = len(wavelengths)
    n_pupil_samples = sampling.build(1.0).shape[0]
    x = np.full((n_fld, n_wvl, n_pupil_samples), np.nan, dtype=_PREC)
    y = np.full((n_fld, n_wvl, n_pupil_samples), np.nan, dtype=_PREC)
    valid = np.zeros((n_fld, n_wvl, n_pupil_samples), dtype=bool)
    anchor_xy = np.full((n_fld, n_wvl, 2), np.nan, dtype=_PREC)
    for rec in iter_trace_grid(system, fields, wavelengths, sampling,
                               epd=epd):
        alive_row = rec.valid
        track = to_host(rec.trace.P)
        landing_xy = track[-1, :, :2].copy()
        center_slot = _pupil_center_chief_index(to_host(rec.P))
        centered, anchor = _center_valid(landing_xy, alive_row, reference,
                                         center_slot, allow_none=True)
        x[rec.i, rec.j], y[rec.i, rec.j] = centered[:, 0], centered[:, 1]
        valid[rec.i, rec.j] = alive_row
        anchor_xy[rec.i, rec.j] = anchor
    return SpotGrid(
        tuple(fields), np.asarray(wavelengths, dtype=_PREC),
        x, y, valid, anchor_xy,
        getattr(system, 'unit', None) or 'mm', reference)


def spot_rms_radius(spot_grid):
    """(n_fld, n_wvl) centroid-referenced RMS spot radii."""
    return centroid_referenced_rms(
        to_host(spot_grid.x), to_host(spot_grid.y), axis=2)


def spot_geometric_radius(spot_grid):
    """(n_fld, n_wvl) maximum (geometric) spot radii from the centroid."""
    return centroid_referenced_max(
        to_host(spot_grid.x), to_host(spot_grid.y), axis=2)


# ---------- full-field displays ----------------------------------------------

def _full_field_template(system, max_field):
    anchors = _resolve_fields(system, None)

    def single(label, values):
        distinct = set(values)
        if len(distinct) != 1:
            raise ValueError('full_field requires system fields with a '
                             f'single {label}')
        return distinct.pop()

    kind = single('kind', (f.kind for f in anchors))
    if kind == 'angle':
        single('angular unit', (f.unit for f in anchors))
        object_z = None
    else:
        object_z = single('object plane', (f.object_z for f in anchors))
    if max_field is None:
        max_field = max(float(np.hypot(f.hx, f.hy)) for f in anchors)
    max_field = float(max_field)
    if max_field <= 0.0:
        raise ValueError('full_field needs a nonzero field extent; define '
                         'off-axis system fields or pass max_field')
    return kind, anchors[0].unit, object_z, max_field


def _as_wavelength_list(wavelengths):
    if wavelengths is None:
        return None
    if np.ndim(wavelengths):
        return [float(w) for w in wavelengths]
    return [float(wavelengths)]


def _spectral_weights(system, wavelengths, resolved):
    if wavelengths is None:
        carried = getattr(system, 'weights', None)
        if carried is not None and len(carried) == len(resolved):
            return [float(x) for x in carried]
    return [1.0] * len(resolved)


def _full_field_rms_spot(system, fields, wavelengths, sampling, epd):
    """Polychromatic pooled centroid-referenced RMS spot radius per field."""
    wvl_list = _resolve_wavelengths(system, wavelengths)
    weights = _spectral_weights(system, wavelengths, wvl_list)
    if sampling is None:
        sampling = Sampling.hex(nrings=6)
    n_pupil_samples = sampling.build(1.0).shape[0]
    shape = (len(fields), len(wvl_list), n_pupil_samples)
    x = np.full(shape, np.nan, dtype=_PREC)
    y = np.full(shape, np.nan, dtype=_PREC)
    for rec in iter_trace_grid(system, fields, wvl_list, sampling, epd=epd):
        alive_row = rec.valid
        track = to_host(rec.trace.P)
        x_row = np.full(n_pupil_samples, np.nan, dtype=_PREC)
        y_row = np.full(n_pupil_samples, np.nan, dtype=_PREC)
        x_row[alive_row] = track[-1, alive_row, 0]
        y_row[alive_row] = track[-1, alive_row, 1]
        x[rec.i, rec.j] = x_row
        y[rec.i, rec.j] = y_row
    w = np.asarray(weights, dtype=_PREC)[None, :, None]
    live = np.isfinite(x)
    w_live = np.where(live, w, 0.0)
    x_live = np.where(live, x, 0.0)
    y_live = np.where(live, y, 0.0)
    weight_total = w_live.sum(axis=(1, 2))
    weight_floor = np.where(weight_total > 0.0, weight_total, 1.0)
    centroid_x = (w_live * x_live).sum(axis=(1, 2)) / weight_floor
    centroid_y = (w_live * y_live).sum(axis=(1, 2)) / weight_floor
    rsq_live = (x_live - centroid_x[:, None, None]) ** 2 + (y_live - centroid_y[:, None, None]) ** 2
    rms = np.sqrt((w_live * rsq_live).sum(axis=(1, 2)) / weight_floor)
    rms[weight_total == 0.0] = np.nan
    return rms


def _full_field_rms_wfe(system, fields, wavelength, sampling, epd,
                        stop_index):
    """Piston-removed RMS wavefront error (waves) per field."""
    if sampling is None:
        sampling = Sampling.hex(nrings=6)
    out = np.full(len(fields), np.nan, dtype=_PREC)
    for i, fld in enumerate(fields):
        rec = trace_cell(system, fld, wavelength, sampling, epd=epd)
        tilt_field = fld if fld.kind == 'angle' else None
        P_xp = _exit_pupil_for(system, wavelength, field=fld,
                               stop_index=stop_index, epd=rec.epd)
        try:
            opd, _, _, _ = _wavefront_from_trace(
                system, rec.P, wavelength, rec.trace, P_xp=P_xp,
                field=tilt_field, output='waves')
        except ValueError:
            continue  # the chief ray was clipped: a hole in the map
        if opd.size:
            detrended = opd - np.mean(opd)
            out[i] = float(np.sqrt(np.mean(detrended * detrended)))
    return out


def _metric_rms_spot(system, flat_fields, wavelengths, sampling, epd,
                     stop_index):
    return (_full_field_rms_spot(system, flat_fields, wavelengths,
                                 sampling, epd),
            getattr(system, 'unit', None) or 'mm', 'centroid')


def _metric_rms_wfe(system, flat_fields, wavelengths, sampling, epd,
                    stop_index):
    wvl = resolve_wavelength(
        system, None if wavelengths is None else wavelengths[0])
    return (_full_field_rms_wfe(system, flat_fields, wvl, sampling, epd,
                                stop_index), 'waves', 'piston')


def _metric_distortion(system, flat_fields, wavelengths, sampling, epd,
                       stop_index):
    wvl = None if wavelengths is None else wavelengths[0]
    return (distortion(system, flat_fields, wvl, epd=epd).percent,
            'percent', 'paraxial:f-tan')


def _metric_lateral_color(system, flat_fields, wavelengths, sampling, epd,
                          stop_index):
    wvl_list = _resolve_wavelengths(system, wavelengths)
    if len(wvl_list) < 2:
        raise ValueError("metric 'lateral color' needs at least two "
                         'wavelengths')
    landings = lateral_color(system, flat_fields, wvl_list, epd=epd)
    spread = (landings[:, int(np.argmax(wvl_list))]
              - landings[:, int(np.argmin(wvl_list))])
    return (np.hypot(spread[:, 0], spread[:, 1]),
            getattr(system, 'unit', None) or 'mm', 'spectral-extremes')


_FULL_FIELD_METRICS = {
    'rms spot': _metric_rms_spot,
    'rms wfe': _metric_rms_wfe,
    'distortion': _metric_distortion,
    'lateral color': _metric_lateral_color,
}


def full_field(system, metric='rms spot', *, samples=15, max_field=None,
               wavelengths=None, sampling=None, epd=None, stop_index=None):
    """FullFieldGrid of a scalar image-quality metric over the field disc."""
    kind, unit, object_z, radius = _full_field_template(system, max_field)
    wavelengths = _as_wavelength_list(wavelengths)
    rungs = np.linspace(-radius, radius, int(samples))
    hx, hy = np.meshgrid(rungs, rungs)
    inside = np.hypot(hx, hy) <= radius * (1.0 + 1e-9)
    idx = np.flatnonzero(inside.ravel())
    flat_fields = [
        Field(float(fx), float(fy), kind=kind, unit=unit, object_z=object_z)
        for fx, fy in zip(hx.ravel()[idx], hy.ravel()[idx])
    ]
    key = metric.lower().replace('-', ' ').replace('_', ' ')
    evaluate = _FULL_FIELD_METRICS.get(key)
    if evaluate is None:
        raise ValueError("metric must be 'rms spot', 'rms wfe', "
                         f"'distortion', or 'lateral color', got {metric!r}")
    values, data_unit, reference = evaluate(system, flat_fields,
                                            wavelengths, sampling, epd,
                                            stop_index)
    data = np.full(hx.size, np.nan, dtype=_PREC)
    data[idx] = np.asarray(to_host(values), dtype=_PREC)
    return FullFieldGrid(hx, hy, data.reshape(hx.shape), key, kind, unit,
                         data_unit, reference)
