"""Complex pupil fields from ray traces.

Counterpart of ``prysm_tpu/x/raytracing/field.py``.  This is the bridge
from geometric traces to the physical-optics stack: per-ray Fresnel and
coating amplitudes, sine-space exit-pupil coordinates, energy-conservation
apodization, polarization ray tracing (3x3 P matrices), and resampling
onto a regular-grid Wavefront for diffraction propagation.

Design notes: incidence data is re-derived from the recorded trace (the
hot kernel stays untouched) in torch on the trace's device, in its dtype,
and read back with ``to_host``; the amplitude rules, the s-p-k rotation
basis (:func:`_spk_basis`) and the P matrices are host numpy in complex128,
as in the JAX package, with coated interfaces through the port's
``coatings.stack_rt``.  The scattered pupil samples are resampled on the
host (SciPy's cubic ``griddata``) and propagated by the port's
``Wavefront`` on ``config.device`` in ``config.precision``.
"""
import numpy as np
import torch
from scipy import interpolate

from ...conf import complex_for, config, numpy_dtype
from ...coordinates import make_xy_grid
from ...propagation import Wavefront
from ..coatings.stack import Stack, stack_rt

from . import spencer_and_murty as sm
from .spencer_and_murty import (
    STYPE_REFLECT, STYPE_REFRACT, raytrace, to_host,
)
from .launch import Sampling, _apply_vignetting
from .paraxial import effective_focal_length
from .opt import _pupil_center_chief_index
from .analysis import _apply_field_and_output, close_wavefront
from ._resolve import compiled_surfaces, trace_context
from ._trace_grid import trace_cell
from ._meta import object_space_index

_PREC = np.float64
_CPREC = np.complex128


def _csqrt(x):
    return np.sqrt(np.asarray(x, dtype=_CPREC))


def _unit(v):
    return v / np.sqrt(np.sum(v * v, axis=-1, keepdims=True))


class _TraceCarrier:
    """Base wrapper pairing a geometric trace with a physical payload."""

    __slots__ = ('trace',)

    def __init__(self, trace):
        self.trace = trace

    @property
    def P(self):
        """Position history of the wrapped trace."""
        return self.trace.P

    @property
    def S(self):
        """Direction history of the wrapped trace."""
        return self.trace.S

    @property
    def OPL(self):
        """OPL history of the wrapped trace."""
        return self.trace.OPL

    @property
    def status(self):
        """Status of the wrapped trace."""
        return self.trace.status


class FieldTraceResult(_TraceCarrier):
    """A geometric trace plus per-ray scalar amplitude."""

    __slots__ = ('amplitude',)

    def __init__(self, trace, amplitude):
        super().__init__(trace)
        self.amplitude = amplitude


class PRTResult(_TraceCarrier):
    """A geometric trace plus a per-ray 3x3 polarization ray-trace matrix."""

    __slots__ = ('P_matrix',)

    def __init__(self, trace, P_matrix):
        super().__init__(trace)
        self.P_matrix = P_matrix


# ---------- per-interface incidence data ------------------------------------


def _complex_index(material, wavelength, *, consumer):
    nk = getattr(material, 'nk', None)
    if not callable(nk):
        raise TypeError(
            f'{consumer} requires material objects with callable '
            f'.nk(wvl_um); {material!r} only satisfies the geometric '
            '.n tier')
    return complex(nk(wavelength))


def _complex_object_space_index(prescription, wavelength, *, consumer):
    if (prescription and sm._is_measurement_surf(prescription[0].typ)
            and prescription[0].material is not None):
        return _complex_index(prescription[0].material, wavelength,
                              consumer=consumer)
    return 1.0 + 0.0j


def surface_normals_from_trace(system, trace, wavelength, *,
                               complex_indices=False):
    """(cos_inc, n_in, n_out, kind): per-surface incidence data from a trace.

    Re-evaluates sag_and_normal at the recorded intersections (the
    exact path the kernel walked) in torch on the trace's device, so the
    hot trace needs no changes; the results are host numpy.
    """
    P_track, S_track = torch.as_tensor(trace.P), torch.as_tensor(trace.S)
    prescription = list(system)
    cos_rows, n_before, n_after, kinds = [], [], [], []

    if complex_indices:
        running = _complex_object_space_index(
            prescription, wavelength, consumer='physical field tracing')
    else:
        running = object_space_index(prescription, wavelength)
    for j, surf in enumerate(prescription):
        local_P, local_S = sm.transform_to_local_coords(
            P_track[j + 1], surf.P, S_track[j], surf.R)
        _, n_hat = surf.sag_and_normal(local_P[..., 0], local_P[..., 1])
        cos_rows.append(to_host(torch.sum(n_hat * local_S, dim=-1)))
        n_before.append(running)
        kinds.append(surf.typ)
        if surf.typ == STYPE_REFRACT:
            running = (_complex_index(surf.material, wavelength,
                                      consumer='physical field tracing')
                       if complex_indices
                       else float(surf.material.n(wavelength)))
        n_after.append(running)

    index_dtype = _CPREC if complex_indices else _PREC
    return (np.asarray(cos_rows, dtype=numpy_dtype(P_track.dtype)),
            np.asarray(n_before, dtype=index_dtype),
            np.asarray(n_after, dtype=index_dtype),
            np.asarray(kinds, dtype=int))


# ---------- interface amplitude rules ---------------------------------------


def _fresnel_transmission(n_in, n_out, aoi, aot):
    """(t_s, t_p) Fresnel transmission amplitudes (complex-safe)."""
    driving = 2 * n_in * np.cos(aoi)
    t_s = driving / (n_in * np.cos(aoi) + n_out * np.cos(aot))
    t_p = driving / (n_in * np.cos(aot) + n_out * np.cos(aoi))
    return t_s, t_p


def _refracted_cosine(n_in, n_out, aoi):
    return _csqrt(1.0 - ((n_in / n_out) * np.sin(aoi)) ** 2)


def _zero_dead_rays(cos_aot, *amplitudes):
    """Zero TIR / non-finite entries (evanescent rays carry no power)."""
    dead = np.imag(cos_aot) != 0
    for a in amplitudes:
        dead = dead | ~np.isfinite(a)
    for a in amplitudes:
        a[dead] = 0.0
    return amplitudes


def _transmission_energy_norm(n_in, n_out, aoi, pol):
    """Obliquity factor from field transmission to sqrt(power)."""
    cos_aoi = np.cos(aoi)
    cos_aot = _refracted_cosine(n_in, n_out, aoi)
    with np.errstate(divide='ignore', invalid='ignore'):
        ratio = ((n_out * cos_aot) / (n_in * cos_aoi) if pol == 's'
                 else (n_out * cos_aoi) / (n_in * cos_aot))
    return _csqrt(np.real(ratio))


def _coating_coefficients(coating, n_in, n_out, cos_inc, aoi, kind, wvl_um):
    """Thin-film stack s/p amplitudes for one traced interface."""
    if wvl_um is None:
        raise TypeError('a coated surface requires a wvl_um')
    if kind == STYPE_REFRACT:
        layered = Stack(coating.indices, coating.thicknesses,
                        substrate_index=n_out, ambient_index=n_in)
        amplitudes = []
        for pol in ('s', 'p'):
            _, t = stack_rt(layered, wvl_um, aoi, pol)
            amplitudes.append((to_host(t)
                               * _transmission_energy_norm(n_in, n_out, aoi,
                                                           pol)).astype(_CPREC))
        return _zero_dead_rays(_refracted_cosine(n_in, n_out, aoi),
                               *amplitudes)
    if kind == STYPE_REFLECT:
        layered = Stack(coating.indices, coating.thicknesses,
                        substrate_index=coating.substrate_index,
                        ambient_index=n_in)
        r_s, _ = stack_rt(layered, wvl_um, aoi, 's')
        r_p, _ = stack_rt(layered, wvl_um, aoi, 'p')
        # s-p-k basis signs match the bare ideal mirror limit (1, -1)
        return ((-to_host(r_s)).astype(_CPREC),
                to_host(r_p).astype(_CPREC))
    passthrough = np.ones_like(cos_inc, dtype=_CPREC)
    return passthrough, passthrough


def interface_coefficients(n0, n1, cosI, typ, *, coating=None,
                           wavelength=None):
    """Energy-normalized s/p amplitude coefficients for one interface.

    TIR returns zero; bare reflection is the ideal mirror (1, -1).
    """
    n_in, n_out, cos_inc, kind, wvl_um = n0, n1, cosI, typ, wavelength
    cos_inc = np.abs(to_host(cos_inc))
    aoi = np.arccos(np.clip(cos_inc, 0.0, 1.0))
    if coating is not None:
        return _coating_coefficients(coating, n_in, n_out, cos_inc, aoi, kind,
                                     wvl_um)
    if kind == STYPE_REFRACT:
        cos_aot = _refracted_cosine(n_in, n_out, aoi)
        with np.errstate(divide='ignore', invalid='ignore'):
            t_s, t_p = _fresnel_transmission(n_in, n_out, aoi,
                                             np.arccos(cos_aot))
            oblique = _csqrt((n_out * cos_aot) / (n_in * np.cos(aoi)))
            amp_s = (t_s * oblique).astype(_CPREC)
            amp_p = (t_p * oblique).astype(_CPREC)
        return _zero_dead_rays(cos_aot, amp_s, amp_p)
    passthrough = np.ones_like(cos_inc, dtype=_CPREC)
    if kind == STYPE_REFLECT:
        return passthrough, -passthrough
    return passthrough, passthrough


def unpolarized_amplitude(system, trace, wavelength):
    """Per-ray scalar amplitude transmittance through the system."""
    wvl_um = wavelength
    cos_inc, n_in, n_out, kinds = surface_normals_from_trace(
        system, trace, wvl_um, complex_indices=True)
    prescription = list(system)
    throughput = np.ones(cos_inc.shape[1], dtype=_PREC)
    for j, surf in enumerate(prescription):
        if surf.coating is None and kinds[j] != STYPE_REFRACT:
            continue
        amp_s, amp_p = interface_coefficients(
            n_in[j], n_out[j], cos_inc[j], kinds[j], coating=surf.coating,
            wavelength=wvl_um)
        mean_power = 0.5 * (np.abs(amp_s) ** 2 + np.abs(amp_p) ** 2)
        throughput = throughput * np.sqrt(np.clip(mean_power, 0.0, None))
    return throughput


def raytrace_field(system, P, S, wavelength):
    """Intensity-aware trace: geometry plus a scalar amplitude."""
    wvl_um = wavelength
    prescription = compiled_surfaces(system)
    trace = raytrace(prescription, P, S, wvl_um)
    return FieldTraceResult(trace,
                            unpolarized_amplitude(prescription, trace,
                                                  wvl_um))


# ---------- sine space & apodization ----------------------------------------


def _axis_perp_basis(axis_dir, dtype):
    """Orthonormal (u, v) spanning the plane perpendicular to the axis."""
    if axis_dir is None:
        w = np.array([0.0, 0.0, 1.0], dtype=dtype)
    else:
        w = np.asarray(axis_dir, dtype=dtype)
        w = w / np.sqrt(np.sum(w * w))
    seed = np.array([1.0, 0.0, 0.0], dtype=dtype)
    if abs(float(np.sum(seed * w))) > 0.9:
        seed = np.array([0.0, 1.0, 0.0], dtype=dtype)
    u = seed - np.sum(seed * w) * w
    u = u / np.sqrt(np.sum(u * u))
    return u, np.cross(w, u)


def sine_space_coords(S_last, S_chief, scale, axis_dir=None):
    """(X, Y): sine-space pupil coordinates of a bundle, chief-referenced."""
    S_last = to_host(S_last)
    S_chief = np.asarray(to_host(S_chief), dtype=S_last.dtype)
    u, v = _axis_perp_basis(axis_dir, S_last.dtype)
    # chief minus ray: the reference-sphere landing sits downstream of XP
    offsets = float(scale) * (S_chief[None, :] - S_last)
    return offsets @ u, offsets @ v


def _inpaint_nan(arr):
    """Fill non-finite samples from finite neighbors (diffusion passes)."""
    arr = np.asarray(arr, dtype=_PREC).copy()
    hole = ~np.isfinite(arr)
    if not np.any(hole):
        return arr
    arr[hole] = 0.0
    neighbor_count = np.zeros_like(arr)
    for sl_to, sl_from in (((slice(1, None),), (slice(None, -1),)),
                           ((slice(None, -1),), (slice(1, None),)),
                           ((slice(None), slice(1, None)),
                            (slice(None), slice(None, -1))),
                           ((slice(None), slice(None, -1)),
                            (slice(None), slice(1, None)))):
        neighbor_count[sl_to] += 1.0
    for _ in range(int(max(arr.shape))):
        spread = np.zeros_like(arr)
        spread[1:] += arr[:-1]
        spread[:-1] += arr[1:]
        spread[:, 1:] += arr[:, :-1]
        spread[:, :-1] += arr[:, 1:]
        arr[hole] = spread[hole] / neighbor_count[hole]
    return arr


def amplitude_apodization(entrance_xy, sphere_xy, *, valid=None):
    """sqrt(dA_entrance / dA_sphere): energy-conservation amplitude."""
    entrance_xy = np.asarray(entrance_xy)
    sphere_xy = np.asarray(sphere_xy)
    a_axis = entrance_xy[0, :, 0]
    b_axis = entrance_xy[:, 0, 1]
    X = _inpaint_nan(sphere_xy[..., 0])
    Y = _inpaint_nan(sphere_xy[..., 1])
    dX_da = np.gradient(X, a_axis, axis=1)
    dX_db = np.gradient(X, b_axis, axis=0)
    dY_da = np.gradient(Y, a_axis, axis=1)
    dY_db = np.gradient(Y, b_axis, axis=0)
    jacobian = np.abs(dX_da * dY_db - dX_db * dY_da)
    with np.errstate(divide='ignore', invalid='ignore'):
        density = 1.0 / np.sqrt(jacobian)
    density[~np.isfinite(density)] = 0.0
    if valid is not None:
        density[~valid] = 0.0
    return density


# ---------- orchestration: pupil field + propagation bridge -----------------


class PupilField:
    """Complex pupil-field samples on the exit-pupil reference sphere."""

    __slots__ = ('X', 'Y', 'amplitude', 'opd', 'wavelength', 'efl',
                 'n_image', 'P_xp', 'P_img', 'P_matrix')

    def __init__(self, X, Y, amplitude, opd, wavelength, efl, n_image,
                 P_xp, P_img, P_matrix=None):
        self.X, self.Y = X, Y
        self.amplitude, self.opd = amplitude, opd
        self.wavelength, self.efl, self.n_image = wavelength, efl, n_image
        self.P_xp, self.P_img, self.P_matrix = P_xp, P_img, P_matrix

    @property
    def polarized(self):
        """True when the field carries per-ray polarization matrices."""
        return self.P_matrix is not None

    def waves(self):
        """OPD in waves at this field's wvl_um (both in microns)."""
        return np.asarray(self.opd) / float(self.wavelength)


def _pupil_coordinate_scale(tc, P_xp, center):
    """abs(EFL) when available, else the reference-sphere radius."""
    try:
        return abs(float(effective_focal_length(tc.surfaces,
                                                wvl=tc.wavelength)))
    except ValueError:
        if P_xp is None:
            raise
        gap = np.asarray(P_xp) - np.asarray(center)
        return float(np.sqrt(np.sum(gap * gap)))


def _chief_augmented_sampling(sampling, epd):
    """(trace sampling, chief index, nominal entrance xy, grid count).

    Even rect grids carry no exact chief, so one is appended and traced
    alongside the grid.
    """
    nominal_grid = sampling.build(0.5 * epd)
    n_grid = len(nominal_grid)
    if sampling.chief_index is not None:
        return sampling, sampling.chief_index, nominal_grid, n_grid
    normalized = sampling.build(1.0)
    padded = Sampling.points(
        np.concatenate([normalized, np.zeros((1, 2), dtype=_PREC)], axis=0))
    with_chief = np.concatenate(
        [nominal_grid, np.zeros((1, 2), dtype=_PREC)], axis=0)
    return padded, n_grid, with_chief, n_grid


def pupil_field(system, field, wavelength=None, *, epd=None, npupil=64,
                stop_index=None, P_xp=None, P_img=None, axis_dir=None,
                pupil_z=None, reference='chief', polarized=False):
    """Realize the complex pupil field on the exit-pupil reference sphere.

    Traces an npupil x npupil entrance grid, closes the wavefront, and
    returns the scattered sine-space samples (amplitudes x OPD) ready
    for pupil_field_to_wavefront.
    """
    tc = trace_context(system, wavelength, chief=True, epd=epd,
                       stop_index=stop_index)
    wvl_um, epd = tc.wavelength, tc.epd
    if epd is None:
        raise TypeError('epd is required; pass epd=... or an OpticalSystem '
                        'whose aperture spec resolves it.')
    if reference not in ('chief', 'centroid'):
        raise ValueError(
            f"reference must be 'chief' or 'centroid', got {reference!r}")
    trace_sampling, chief_slot, entrance_nominal, n_grid = \
        _chief_augmented_sampling(Sampling.rect(n=npupil), epd)

    tracer = raytrace_prt if polarized else raytrace_field
    record = trace_cell(system, field, wvl_um, trace_sampling,
                        epd=epd, pupil_z=pupil_z,
                        kernel=lambda presc, P, S, w: tracer(presc, P, S, w))
    valid = record.valid
    carrier = record.trace
    trace = carrier.trace
    coating_amp = None if polarized else carrier.amplitude
    P_matrix_all = carrier.P_matrix if polarized else None

    # nominal coordinates define the circle; vignetted ones match rays
    pupil_xy = _apply_vignetting(entrance_nominal, field)
    if reference == 'centroid':
        chief_slot = _pupil_center_chief_index(pupil_xy, valid)

    # rect fills a square; the entrance pupil is the inscribed circle
    r_entrance = np.hypot(
        entrance_nominal[:, 0] - entrance_nominal[chief_slot, 0],
        entrance_nominal[:, 1] - entrance_nominal[chief_slot, 1])
    valid = valid & (r_entrance <= (0.5 * epd) * (1.0 + 1e-9))

    P_img = None if P_img is None else to_host(P_img)
    closing = close_wavefront(system, trace, wvl_um, chief_slot,
                              center=P_img, P_xp=P_xp,
                              stop_index=tc.stop_index,
                              epd=epd, axis_dir=axis_dir, min_perp=1e-3,
                              valid=valid, reference=reference,
                              apply_field_tilt=False, ctx=tc)
    P_img, P_xp = closing.center, closing.P_xp
    opd = closing.opd

    scale = _pupil_coordinate_scale(tc, P_xp, P_img)
    S_track = to_host(trace.S)
    X_all, Y_all = sine_space_coords(S_track[-1], S_track[-1, chief_slot],
                                     scale, axis_dir)

    entrance_xy = np.ascontiguousarray(
        pupil_xy[:n_grid]).reshape(npupil, npupil, 2)
    sphere_xy = np.stack(
        [X_all[:n_grid], Y_all[:n_grid]], axis=-1
    ).reshape(npupil, npupil, 2)
    geometric_amp = amplitude_apodization(
        entrance_xy, sphere_xy,
        valid=valid[:n_grid].reshape(npupil, npupil)).reshape(-1)
    if coating_amp is not None:
        geometric_amp = geometric_amp * to_host(coating_amp)[:n_grid]

    x_pupil = pupil_xy[valid, 0] - pupil_xy[chief_slot, 0]
    y_pupil = pupil_xy[valid, 1] - pupil_xy[chief_slot, 1]
    tilt_field = field if field.kind == 'angle' else None
    opd, _ = _apply_field_and_output(opd, x_pupil, y_pupil, tilt_field,
                                     'length', wvl_um)
    valid_indices = np.nonzero(valid)[0]
    grid_valid = valid[:n_grid]
    keep_grid_samples = valid_indices < n_grid
    opd_um = opd[keep_grid_samples] * 1e3

    n_image = abs(float(closing.n_image))
    P_matrix = (None if P_matrix_all is None
                else to_host(P_matrix_all)[valid][keep_grid_samples])
    return PupilField(
        X=X_all[:n_grid][grid_valid], Y=Y_all[:n_grid][grid_valid],
        amplitude=geometric_amp[:n_grid][grid_valid],
        opd=opd_um, wavelength=wvl_um, efl=scale / n_image,
        n_image=n_image,
        P_xp=(None if P_xp is None else to_host(P_xp)),
        P_img=P_img, P_matrix=P_matrix)


def _scatter_to_grid(pts, values, grid_xy):
    """Cubic scattered-data interpolation with NaN scrubbing."""
    gridded = interpolate.griddata(pts, values, grid_xy, method='cubic',
                                   fill_value=0.0)
    gridded[~np.isfinite(gridded)] = 0.0
    return gridded


def _resample_grid(pf, npix, margin):
    """Scatter-to-regular-grid setup shared by the wavefront bridge."""
    x, y = np.asarray(pf.X), np.asarray(pf.Y)
    finite = np.isfinite(x) & np.isfinite(y) & np.isfinite(pf.opd)
    x, y = x[finite], y[finite]
    diameter = 2.0 * float(np.max(np.hypot(x, y))) * float(margin)
    xg, yg = make_xy_grid(npix, diameter=diameter, host=True)
    pts = np.stack([x, y], axis=-1)
    opd_grid = _scatter_to_grid(pts, np.asarray(pf.opd)[finite], (xg, yg))
    phase_nm = opd_grid * 1.0e3   # OPD um -> nm
    return finite, pts, (xg, yg), diameter / npix, phase_nm


def _device_wavefront(data, wavelength, dx):
    """A Wavefront of host complex samples, on ``config.device`` in the
    complex dtype of ``config.precision``."""
    return Wavefront(torch.as_tensor(data, dtype=complex_for(config.precision),
                                     device=config.device), wavelength, dx)


def pupil_field_to_wavefront(pf, *, npix=256, margin=1.05,
                             input_polarization=None):
    """Resample scattered pupil-field samples onto a regular-grid Wavefront.

    A polarized field returns the [Ex, Ey] component wavefronts.
    Propagate to the PSF with .focus(efl=pf.efl).  The resampling runs on
    the host in float64; the Wavefront's samples go to ``config.device``
    in ``config.precision``.
    """
    finite, pts, grid_xy, dx, phase_nm = _resample_grid(pf, npix, margin)
    k = 2 * np.pi / pf.wavelength / 1e3   # radians per nm of OPD
    phase_term = np.exp(1j * k * phase_nm)
    amp = np.asarray(pf.amplitude)[finite]

    if not pf.polarized:
        amp_grid = _scatter_to_grid(pts, amp, grid_xy)
        return _device_wavefront(amp_grid * phase_term, pf.wavelength, dx)

    if input_polarization is None:
        raise TypeError(
            'input_polarization is required for a polarized PupilField')
    e_in = np.zeros(3, dtype=_CPREC)
    e_in[:len(input_polarization)] = np.asarray(input_polarization,
                                                dtype=_CPREC)
    e_vec = np.einsum('nij,j->ni', pf.P_matrix[finite], e_in)
    out = []
    for c in (0, 1):   # transverse x, y; Ez neglected
        component = amp * e_vec[:, c]
        g = (_scatter_to_grid(pts, np.real(component), grid_xy)
             + 1j * _scatter_to_grid(pts, np.imag(component), grid_xy))
        out.append(_device_wavefront(g * phase_term, pf.wavelength, dx))
    return out


def pupil_field_psf(pf, *, npix=256, margin=1.05, Q=2,
                    input_polarization='unpolarized'):
    """(psf, dx): intensity PSF from a pupil field.

    Polarized fields are illuminated with the requested input state;
    'unpolarized' incoherently averages two orthogonal inputs.  The focus
    and |E|^2 run on ``config.device``; the PSF is read back as host numpy.
    """
    if not pf.polarized:
        focused = pupil_field_to_wavefront(pf, npix=npix,
                                           margin=margin).focus(pf.efl, Q=Q)
        return to_host(torch.abs(focused.data) ** 2), focused.dx

    if isinstance(input_polarization, str):
        if input_polarization != 'unpolarized':
            raise ValueError("string input_polarization must be "
                             "'unpolarized'")
        illuminations = [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0)]
        weight = 0.5
    else:
        illuminations = [input_polarization]
        weight = 1.0

    total = None
    last_dx = None
    for e_in in illuminations:
        for wf in pupil_field_to_wavefront(pf, npix=npix, margin=margin,
                                           input_polarization=e_in):
            focused = wf.focus(pf.efl, Q=Q)
            last_dx = focused.dx
            term = weight * to_host(torch.abs(focused.data) ** 2)
            total = term if total is None else total + term
    return total, last_dx


# ---------- polarization ray tracing (PRT) ----------------------------------


def _global_normal_and_cosI(surf, P_int_global, S_in_global):
    """Global-frame surface normal and incidence cosine, as host arrays
    (computed in torch on the trace's device, in its dtype)."""
    local_P, local_S = sm.transform_to_local_coords(
        P_int_global, surf.P, S_in_global, surf.R)
    _, n_local = surf.sag_and_normal(local_P[..., 0], local_P[..., 1])
    cos_inc = to_host(torch.sum(n_local * local_S, dim=-1))
    n_local = to_host(n_local)
    if surf.R is None:
        n_global = n_local
    else:
        n_global = np.matmul(to_host(surf.R).astype(n_local.dtype).T,
                             n_local[..., np.newaxis]).squeeze(-1)
    return n_global, cos_inc


def _spk_basis(k_in, n_global):
    """Unit s vector of the s-p-k basis, robust at normal incidence."""
    s = np.cross(k_in, n_global)
    s_norm = np.sqrt(np.sum(s * s, axis=-1, keepdims=True))
    # normal incidence: any perpendicular works since amp_s == amp_p there
    degenerate = s_norm[..., 0] < 1e-12
    fallback = np.cross(k_in, np.array([1.0, 0.0, 0.0], dtype=k_in.dtype))
    fb_norm = np.sqrt(np.sum(fallback * fallback, axis=-1, keepdims=True))
    tiny = fb_norm[..., 0] < 1e-12
    if np.any(tiny):
        fallback[tiny] = np.cross(k_in[tiny],
                                  np.array([0.0, 1.0, 0.0],
                                           dtype=k_in.dtype))
        fb_norm = np.sqrt(np.sum(fallback * fallback, axis=-1,
                                 keepdims=True))
    safe = np.where(s_norm > 0, s_norm, 1.0)
    return np.where(degenerate[:, None], fallback / fb_norm, s / safe)


def raytrace_prt(system, P, S, wavelength):
    """Polarization ray trace: geometry plus a per-ray 3x3 P matrix."""
    wvl_um = wavelength
    prescription = list(compiled_surfaces(system))
    trace = raytrace(prescription, P, S, wvl_um)
    P_dev, S_dev = trace.P, trace.S
    S_track = to_host(S_dev)
    n_rays = S_track.shape[1]
    Pmat = np.broadcast_to(np.eye(3, dtype=_CPREC), (n_rays, 3, 3)).copy()

    running = _complex_object_space_index(
        prescription, wvl_um, consumer='polarization ray tracing')
    for j, surf in enumerate(prescription):
        k_in, k_out = _unit(S_track[j]), _unit(S_track[j + 1])
        n_global, cos_inc = _global_normal_and_cosI(surf, P_dev[j + 1],
                                                 S_dev[j])
        s = _spk_basis(k_in, n_global)
        p_in, p_out = np.cross(k_in, s), np.cross(k_out, s)

        if surf.typ == STYPE_REFRACT:
            n_next = _complex_index(surf.material, wvl_um,
                                    consumer='polarization ray tracing')
        else:
            n_next = running
        amp_s, amp_p = interface_coefficients(
            running, n_next, cos_inc, surf.typ, coating=surf.coating,
            wavelength=wvl_um)
        if surf.typ == STYPE_REFRACT:
            running = n_next

        O_in = np.stack([s, p_in, k_in], axis=-1)
        O_out = np.stack([s, p_out, k_out], axis=-1)
        jones = np.zeros((n_rays, 3, 3), dtype=_CPREC)
        jones[:, 0, 0] = amp_s
        jones[:, 1, 1] = amp_p
        jones[:, 2, 2] = 1.0
        Pmat = (O_out @ jones
                @ np.swapaxes(O_in, -1, -2).astype(_CPREC)) @ Pmat
    return PRTResult(trace, Pmat)


__all__ = [
    'FieldTraceResult',
    'PRTResult',
    'PupilField',
    'amplitude_apodization',
    'interface_coefficients',
    'pupil_field',
    'pupil_field_psf',
    'pupil_field_to_wavefront',
    'raytrace_field',
    'raytrace_prt',
    'sine_space_coords',
    'surface_normals_from_trace',
    'unpolarized_amplitude',
]
