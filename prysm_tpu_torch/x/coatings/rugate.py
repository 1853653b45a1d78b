"""Rugate and inhomogeneous-index coating synthesis.

Counterpart of ``prysm_tpu/x/coatings/rugate.py``: profile
discretization, sinusoidal notch rugates with apodization, and Fourier
synthesis of an index profile from a target reflectance spectrum.

Profiles are evaluated vectorized over the whole sublayer-center grid in
one shot (:func:`_profile_samples`) on the host; the stacks they make are
ordinary ``Stack`` objects.
"""
import numpy as onp

from ...conf import numpy_dtype
from .stack import Stack

__all__ = [
    'quintic_taper',
    'discretize_profile',
    'rugate_period',
    'notch_wavelength',
    'sinusoidal_rugate',
    'apodize',
    'rugate_from_target',
]


def _midpoints(total_thickness, count):
    """Centers of count equal sublayers spanning [0, total_thickness]."""
    edges = onp.linspace(0.0, total_thickness, count + 1)
    return 0.5 * (edges[:-1] + edges[1:])


def _profile_samples(n_of_z, depths):
    """Evaluate an index profile at many depths, vectorized when possible."""
    try:
        sampled = n_of_z(onp.asarray(depths, dtype=numpy_dtype()))
        sampled = onp.asarray(sampled)
        if sampled.shape == onp.shape(depths):
            return sampled
    except Exception:  # NOQA: BLE001 - scalar-only profiles are fine
        pass
    return onp.asarray([n_of_z(float(z)) for z in depths])


def _uniform_stack(indices, total_thickness, substrate_index, ambient_index):
    """Stack of equal-thickness sublayers with the given index samples."""
    count = len(indices)
    thicknesses = onp.full(count, total_thickness / count,
                           dtype=numpy_dtype())
    return Stack(list(indices), thicknesses, substrate_index, ambient_index)


def quintic_taper(edge_fraction=0.5):
    """Amplitude window w(u) ramping with a quintic smoothstep at both ends.

    Formulated as a single smoothstep of the distance to the nearest
    profile edge, normalized by edge_fraction.
    """
    e = float(edge_fraction)

    def window(u):
        u = onp.asarray(u, dtype=numpy_dtype())
        if e <= 0:
            return onp.ones_like(u)
        edge_distance = onp.minimum(u, 1.0 - u)
        t = onp.clip(edge_distance / e, 0.0, 1.0)
        return t * t * t * (10 - 15 * t + 6 * t * t)

    return window


def discretize_profile(n_of_z, total_thickness, n_sublayers, substrate_index,
                       ambient_index=1.0):
    """Sample a continuous index profile into a Stack of thin sublayers."""
    samples = _profile_samples(n_of_z, _midpoints(total_thickness, n_sublayers))
    return _uniform_stack(samples, total_thickness, substrate_index,
                          ambient_index)


def rugate_period(n_avg, design_wvl):
    """Physical period for a first-order rugate notch at design_wvl."""
    return design_wvl / (2.0 * n_avg)


def notch_wavelength(n_avg, period):
    """First-order notch wavelength of a rugate of given period."""
    return 2.0 * n_avg * period


def sinusoidal_rugate(n_avg, n_amp, design_wvl, n_periods, *,
                      sublayers_per_period=30, substrate_index=None,
                      ambient_index=1.0, apodization=None, clamp=None):
    """Sinusoidal rugate stack with a first-order notch at design_wvl."""
    period = rugate_period(n_avg, design_wvl)
    total = n_periods * period
    count = int(round(n_periods * sublayers_per_period))

    z = _midpoints(total, count)
    envelope = n_amp if apodization is None else n_amp * apodization(z / total)
    profile = n_avg + envelope * onp.sin(2 * onp.pi * z / period)
    if clamp is not None:
        profile = onp.clip(profile, *clamp)

    fallback = n_avg if substrate_index is None else substrate_index
    return _uniform_stack(profile, total, fallback, ambient_index)


def apodize(n_of_z, n_avg, total_thickness, window):
    """Wrap a profile so its modulation about n_avg is amplitude-tapered."""
    def tapered(z):
        modulation = n_of_z(z) - n_avg
        return n_avg + float(window(z / total_thickness)) * modulation

    return tapered


def rugate_from_target(wavenumbers, target_amplitude, n_avg,
                       total_optical_thickness, n_sublayers, *,
                       substrate_index=None, ambient_index=1.0, clamp=None):
    """Fourier-synthesize an index profile from a target r(k) spectrum.

    The classic rugate inverse recipe: the kernel
    Q(x) = (1/pi) Re int r(k) exp(2 i k x) dk drives d(ln n)/dx on the
    optical-thickness axis x; physical depth follows from dz = dx / n.
    """
    k = onp.asarray(wavenumbers, dtype=numpy_dtype())
    r = onp.asarray(target_amplitude, dtype=numpy_dtype())
    dk = k[1] - k[0]

    dense = max(n_sublayers * 4, 2000)
    x = onp.linspace(0.0, total_optical_thickness, dense)
    dx = x[1] - x[0]
    # one dense matvec for the cosine-kernel integral over the k grid
    kernel = onp.real(onp.exp(2j * onp.outer(x, k)) @ r.astype(complex))
    Q = kernel * (dk / onp.pi)
    n_x = n_avg * onp.exp(2.0 * onp.cumsum(Q) * dx)
    if clamp is not None:
        n_x = onp.clip(n_x, *clamp)

    # walk optical thickness to physical depth
    z = onp.zeros_like(x)
    z[1:] = onp.cumsum(dx / n_x[:-1])

    def n_of_z(zz):
        return float(onp.interp(zz, z, n_x))

    fallback = n_avg if substrate_index is None else substrate_index
    return discretize_profile(n_of_z, float(z[-1]), n_sublayers, fallback,
                              ambient_index)

