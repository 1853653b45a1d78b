"""Field x wavelength trace-grid plumbing shared by the analysis layer.

Counterpart of ``prysm_tpu/x/raytracing/_trace_grid.py``.  Resolution of
the field/wavelength sets, pupil launches, and per-cell trace records.
"""
import math
from dataclasses import dataclass

import numpy as np

from .spencer_and_murty import raytrace, to_host, valid_mask
from .launch import Field, Sampling, launch
from ._resolve import compiled_surfaces, resolve_wavelength, trace_context


def _resolve_fields(system, fields):
    """Fields to evaluate, defaulting to the system FieldSet, else on-axis."""
    if fields is not None:
        chosen = list(fields)
        if not chosen:
            raise ValueError('an explicit fields iterable needs at least one '
                             'field; fields=None means the on-axis field')
        return chosen
    carried = getattr(system, 'fields', None)
    if carried is not None and len(carried) > 0:
        return list(carried)
    return [Field(0.0, 0.0)]


def _shared_or_none(values):
    """The single shared value of an iterable, else None."""
    distinct = set(values)
    return distinct.pop() if len(distinct) == 1 else None


def field_sweep(system, fields=None, samples=101):
    """Dense field samples spanning the system field set."""
    anchors = _resolve_fields(system, fields)
    if fields is not None or len(anchors) == 0:
        return anchors
    kind = _shared_or_none(f.kind for f in anchors)
    if kind is None:
        return anchors
    if kind == 'angle':
        if _shared_or_none(f.unit for f in anchors) is None:
            return anchors
        object_z = None
    else:
        distinct_z = {f.object_z for f in anchors}
        if len(distinct_z) != 1:
            return anchors
        object_z = anchors[0].object_z

    magnitudes = [math.hypot(f.hx, f.hy) for f in anchors]
    top = max(magnitudes)
    if top <= 0.0:
        return anchors
    outermost = anchors[magnitudes.index(top)]
    ux, uy = outermost.hx / top, outermost.hy / top
    bottom = min(magnitudes)
    if bottom >= top:
        bottom = 0.0
    samples = max(int(samples), 2)
    rungs = np.linspace(bottom, top, samples)
    return [Field(ux * h, uy * h, kind=kind, unit=anchors[0].unit,
                  object_z=object_z) for h in rungs]


def _resolve_wavelengths(system, wavelengths):
    """Wavelengths (microns) to evaluate, defaulting to the system set."""
    if wavelengths is None:
        wavelengths = getattr(system, 'wavelengths', None)
    if wavelengths is not None and len(wavelengths):
        return [float(w) for w in wavelengths]
    try:
        return [resolve_wavelength(system, None)]
    except ValueError:
        raise TypeError('only an OpticalSystem defaults the wavelength set; '
                        'pass wavelengths= for a bare surface sequence.'
                        ) from None


def _require_epd(system, epd, wavelength_um=None):
    """Resolve epd from an explicit value or the system; error if neither."""
    resolved = (trace_context(system, wavelength_um, chief=True).epd
                if epd is None else epd)
    if resolved is None:
        raise TypeError('epd is required; pass epd=... or supply an '
                        'OpticalSystem whose aperture spec resolves it.')
    return float(resolved)


@dataclass
class TraceRecord:
    """One traced (field, wavelength) cell: indices, bundle, and trace."""

    i: int
    j: int
    field: object
    wvl: float
    epd: float
    P: object
    S: object
    trace: object
    valid: object


def _launch_trace(system, field, wavelength_um, sampling, *, epd, pupil_z,
                  aim_to, kernel):
    epd = _require_epd(system, epd, wavelength_um)
    P, S = launch(system, field, wavelength_um, sampling, epd=epd,
                  pupil_z=pupil_z, aim_to=aim_to, drop_unaimed=True)
    trace = kernel(compiled_surfaces(system), P, S, wavelength_um)
    alive = to_host(valid_mask(trace.status, trace.P[-1]))
    return epd, P, S, trace, alive


def trace_cell(system, field, wavelength_um, sampling, *, epd=None,
               pupil_z=None, aim_to=None, kernel=raytrace, trace_fn=None):
    """Launch and trace one (field, wavelength) bundle -> TraceRecord.

    ``trace_fn`` is the reference-parity spelling of ``kernel``.
    """
    kernel = trace_fn if trace_fn is not None else kernel
    parts = _launch_trace(system, field, wavelength_um, sampling, epd=epd,
                          pupil_z=pupil_z, aim_to=aim_to, kernel=kernel)
    return TraceRecord(0, 0, field, wavelength_um, *parts)


def iter_trace_grid(system, fields, wavelengths, sampling, *,
                    epd=None, pupil_z=None, aim_to=None, kernel=raytrace,
                    trace_fn=None):
    """Trace one pupil sampling over every field x wavelength cell."""
    kernel = trace_fn if trace_fn is not None else kernel
    for i, field in enumerate(_resolve_fields(system, fields)):
        for j, wavelength_um in enumerate(_resolve_wavelengths(system, wavelengths)):
            parts = _launch_trace(system, field, wavelength_um, sampling, epd=epd,
                                  pupil_z=pupil_z, aim_to=aim_to,
                                  kernel=kernel)
            yield TraceRecord(i, j, field, wavelength_um, *parts)


@dataclass
class LayoutRecord:
    """One traced layout fan: the field, its trace, and the valid mask."""

    field: object
    trace: object
    valid: object


@dataclass
class _OutlineTrace:
    """Minimal P/S carrier for layout glass sizing over many fields."""

    P: object
    S: object


def _alive_positions(trace):
    history = np.array(to_host(trace.P))
    alive = valid_mask(to_host(trace.status), history[-1])
    if alive is not None:
        history[:, ~alive, :] = np.nan
    return history


def layout_records(system, fields=None, wavelength=None, sampling=None,
                   axis='y'):
    """(records, outline): one traced fan per field for a 2D layout."""
    wavelength_um = resolve_wavelength(system, wavelength)
    if sampling is None or isinstance(sampling, int):
        sampling = Sampling.fan(n=3 if sampling is None else int(sampling),
                                axis=axis)
    compiled = compiled_surfaces(system)
    records = []
    for field in _resolve_fields(system, fields):
        bundle = launch(system, field, wavelength_um, sampling,
                        drop_unaimed=True)
        trace = raytrace(compiled, *bundle, wavelength_um)
        records.append(
            LayoutRecord(field, trace, valid_mask(trace.status, trace.P[-1])))
    outline = _OutlineTrace(
        np.concatenate([_alive_positions(r.trace) for r in records], axis=1),
        np.concatenate([to_host(r.trace.S) for r in records], axis=1))
    return records, outline
