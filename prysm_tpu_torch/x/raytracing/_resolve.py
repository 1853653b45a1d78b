"""Normalization of trace entry points (system object vs bare surface list).

Counterpart of ``prysm_tpu/x/raytracing/_resolve.py``.  Public analysis
functions accept either an OpticalSystem or a plain surface sequence; this
module funnels both into a :class:`TraceContext` carrying the compiled
surfaces, the resolved wavelength, and lazily-computed medium indices.
"""
from functools import cached_property

from ._meta import image_space_index, object_space_index


def compiled_surfaces(system):
    """Compile a system into its Surface list (sequences pass through)."""
    compiler = getattr(system, 'to_surfaces', None)
    return compiler() if callable(compiler) else list(system)


def resolve_wavelength(system, wavelength):
    """Resolve a possibly-None wavelength through the system's reference."""
    system_resolver = getattr(system, 'wavelength', None)
    if callable(system_resolver):
        return float(system_resolver(wavelength))
    if wavelength is not None:
        return float(wavelength)
    raise ValueError(
        'a bare surface sequence cannot default its wavelength; pass '
        'wavelength= explicitly (an OpticalSystem resolves None to its '
        'reference wavelength)')


class TraceContext:
    """Compiled surfaces plus trace metadata, with lazy medium indices."""

    def __init__(self, surfaces, wavelength, epd=None, stop_index=None):
        coerced = (float(epd) if epd is not None else None,
                   int(stop_index) if stop_index is not None else None)
        self.surfaces, self.wavelength = surfaces, float(wavelength)
        self.epd, self.stop_index = coerced

    @cached_property
    def n_object(self):
        """Medium index on the object side."""
        return object_space_index(self.surfaces, self.wavelength)

    @cached_property
    def n_image(self):
        """Medium index on the image side (object side when absent)."""
        return image_space_index(self.surfaces, self.wavelength,
                                 fallback=self.n_object)


def trace_context(system, wavelength=None, *, chief=False, epd=None,
                  stop_index=None):
    """Funnel a system or bare sequence into a TraceContext.

    ``chief=True`` additionally pulls the entrance pupil diameter and stop
    index off the system (when it can supply them) for chief-ray aiming.
    """
    wvl = resolve_wavelength(system, wavelength)
    if chief:
        epd_resolver = getattr(system, 'entrance_pupil_diameter', None)
        if epd is None and callable(epd_resolver):
            epd = epd_resolver(wvl)
        stop_index = (getattr(system, 'stop_index', None)
                      if stop_index is None else stop_index)
    return TraceContext(compiled_surfaces(system), wvl, epd=epd,
                        stop_index=stop_index)
