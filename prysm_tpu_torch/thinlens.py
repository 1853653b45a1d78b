"""First-order (Gaussian) optics built on ray-transfer matrices.

Counterpart of ``prysm_tpu/thinlens.py``.  The compound-element relations
(thick singlet, two-lens systems) come from 2x2 ray-transfer (ABCD)
matrices composed with ``_chain``; the conjugate relations work in
reciprocal space (vergence/power algebra).  Functions that the JAX package
writes as plain arithmetic take and return Python floats or tensors alike;
the matrix relations build tensors of ``config.precision`` (a tensor input
keeps its device and graph), so every relation differentiates under torch
autograd.

Sign conventions follow the reference: object distances are negative to the
left of the lens, image distances positive to the right.
"""
import numpy as np
import torch

from .conf import config, resolve_device, to_tensor


def _real(v):
    """v as a tensor of config.precision (the JAX package's ``jnp.asarray(v, dtype=float)``)."""
    if torch.is_tensor(v):
        return v.to(config.precision)
    return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=config.precision,
                           device=resolve_device())

# ---------------------------------------------------------------------------
# ABCD matrix core.
#
# A paraxial element is a 2x2 matrix acting on (height, n*angle) column
# vectors.  ``_refraction(phi)`` is a thin element of power phi,
# ``_gap(reduced_t)`` is a translation by reduced thickness t/n.  For a
# composite system M = [[A, B], [C, D]]:
#     power = -C,    efl = -1/C,    bfl = -A/C,    ffl = D/C
# (see e.g. Greivenkamp, Field Guide to Geometrical Optics).
# ---------------------------------------------------------------------------


def _refraction(phi):
    phi = _real(phi)
    one = torch.ones_like(phi)
    zero = torch.zeros_like(one)
    return torch.stack([
        torch.stack([one, zero], dim=-1),
        torch.stack([-phi, one], dim=-1),
    ], dim=-2)


def _gap(reduced_t):
    t = _real(reduced_t)
    one = torch.ones_like(t)
    zero = torch.zeros_like(t)
    return torch.stack([
        torch.stack([one, t], dim=-1),
        torch.stack([zero, one], dim=-1),
    ], dim=-2)


def _chain(*elements):
    """Compose ray-transfer matrices; first argument is hit first by the ray."""
    system = elements[0]
    for el in elements[1:]:
        system = el @ system
    return system


def _cardinal_points(system, n_ambient=1.0):
    """(efl, bfl, ffl) of an ABCD ``system`` immersed in index ``n_ambient``."""
    A = system[..., 0, 0]
    C = system[..., 1, 0]
    D = system[..., 1, 1]
    efl = -n_ambient / C
    bfl = -A / C * n_ambient
    ffl = D / C * n_ambient
    return efl, bfl, ffl


# ---------------------------------------------------------------------------
# Conjugate (vergence) relations.
# ---------------------------------------------------------------------------


def object_to_image_dist(efl, object_distance):
    """Image conjugate of an object at ``object_distance`` (negative = left)."""
    vergence_out = 1 / efl + 1 / object_distance
    return 1 / vergence_out


def image_to_object_dist(efl, image_distance):
    """Object conjugate of an image at ``image_distance``."""
    vergence_in = 1 / efl - 1 / image_distance
    return 1 / vergence_in


def object_image_to_efl(object_distance, image_distance):
    """Focal length that conjugates the given object/image distances."""
    return 1 / (1 / image_distance - 1 / object_distance)


def efl_to_power(efl, n=1):
    """Power of a lens of focal length ``efl`` in a medium of index ``n``."""
    return n / efl


def power_to_efl(power, n=1):
    """Focal length of a lens of power ``power`` in a medium of index ``n``."""
    return n / power


# ---------------------------------------------------------------------------
# Aperture-speed relations (F-number / NA).
# ---------------------------------------------------------------------------


def efl_to_fno(efl, epd):
    """Infinite-conjugate F-number given focal length and pupil diameter."""
    return abs(efl) / epd


def fno_to_efl(fno, epd):
    """Focal length implied by an F-number at a given pupil diameter."""
    return fno * epd


def fno_to_epd(fno, efl):
    """Entrance pupil diameter implied by an F-number at a focal length."""
    return abs(efl) / fno


def image_dist_epd_to_na(image_distance, epd):
    """Exact (non-paraxial) NA of the marginal ray to the image point."""
    half_aperture = to_tensor(epd) / 2
    return torch.sin(torch.abs(torch.atan2(half_aperture, to_tensor(image_distance))))


def image_dist_epd_to_fno(image_distance, epd):
    """Working F-number of the marginal ray cone to the image point."""
    return na_to_fno(image_dist_epd_to_na(image_distance, epd))


def fno_to_na(fno):
    """Paraxial NA equivalent to an F-number."""
    return 1 / (2 * fno)


def na_to_fno(na):
    """Paraxial F-number equivalent to an NA."""
    return 1 / (2 * na)


# ---------------------------------------------------------------------------
# Magnification relations (Newtonian form: m = f / (f - z_obj)).
# ---------------------------------------------------------------------------


def object_dist_to_mag(efl, object_dist):
    """Lateral magnification for an object at ``object_dist``."""
    return efl / (efl - object_dist)


def mag_to_object_dist(efl, mag):
    """Object distance producing lateral magnification ``mag``."""
    return efl * (1 - 1 / mag)


def mag_to_image_dist(efl, mag):
    """Image distance producing lateral magnification ``mag``."""
    return efl * (1 - mag)


def linear_to_long_mag(lateral_mag):
    """Longitudinal magnification is the square of the lateral one."""
    return lateral_mag ** 2


def mag_to_fno(mag, infinite_fno, pupil_mag=1):
    """Working F-number at magnification ``mag`` (bellows factor)."""
    return infinite_fno * (1 + abs(mag) / pupil_mag)


# ---------------------------------------------------------------------------
# Defocus / image-motion equivalences (Hopkins W020 / W111 conventions).
# ---------------------------------------------------------------------------


def defocus_to_image_displacement(W020, fno, wavelength=None):
    """Longitudinal image motion equivalent to W020 waves (or length units)."""
    scale = 8 * fno ** 2
    if wavelength is None:
        return scale * W020
    return scale * wavelength * W020


def image_displacement_to_defocus(dz, fno, wavelength=None):
    """W020 equivalent to a longitudinal image motion ``dz``."""
    scale = 8 * fno ** 2
    if wavelength is None:
        return dz / scale
    return dz / (scale * wavelength)


def image_shift_to_tilt(dx, fno):
    """Wavefront tilt coefficient equivalent to a lateral image shift."""
    return dx / (2 * fno)


def tilt_to_image_shift(W111, fno):
    """Lateral image shift equivalent to a wavefront tilt coefficient."""
    return W111 * fno * 2


# ---------------------------------------------------------------------------
# Thick singlet via ABCD: refraction(R1) . gap(t/n) . refraction(R2).
# ---------------------------------------------------------------------------


def _singlet_system(c1, c2, t, n, n_ambient=1.0):
    front = _refraction((n - n_ambient) * c1)
    middle = _gap(t / n)
    back = _refraction((n_ambient - n) * c2)
    return _chain(front, middle, back)


def singlet_power(c1, c2, t, n, n_ambient=1.):
    """Power of a thick singlet (curvatures c1, c2; center thickness t)."""
    system = _singlet_system(c1, c2, t, n, n_ambient)
    return -system[..., 1, 0]


def singlet_efl(c1, c2, t, n, n_ambient=1.):
    """Effective focal length of a thick singlet."""
    efl, _, _ = _cardinal_points(_singlet_system(c1, c2, t, n, n_ambient), n_ambient)
    return efl


def singlet_bfl(c1, c2, t, n, n_ambient=1.):
    """Back focal distance (rear vertex to rear focal point) of a singlet."""
    _, bfl, _ = _cardinal_points(_singlet_system(c1, c2, t, n, n_ambient), n_ambient)
    return bfl


def singlet_ffl(c1, c2, t, n, n_ambient=1.):
    """Front focal distance (front vertex to front focal point) of a singlet."""
    _, _, ffl = _cardinal_points(_singlet_system(c1, c2, t, n, n_ambient), n_ambient)
    return ffl


# ---------------------------------------------------------------------------
# Two thin lenses in air via ABCD.
# ---------------------------------------------------------------------------


def _twolens_system(efl1, efl2, separation):
    return _chain(_refraction(1 / _real(efl1)),
                  _gap(separation),
                  _refraction(1 / _real(efl2)))


def twolens_efl(efl1, efl2, separation):
    """Effective focal length of two thin lenses separated by ``separation``."""
    efl, _, _ = _cardinal_points(_twolens_system(efl1, efl2, separation))
    return efl


def twolens_power(efl1, efl2, separation):
    """Power of two thin lenses separated by ``separation``."""
    return -_twolens_system(efl1, efl2, separation)[..., 1, 0]


def twolens_bfl(efl1, efl2, separation):
    """Back focal distance of a two thin-lens system."""
    _, bfl, _ = _cardinal_points(_twolens_system(efl1, efl2, separation))
    return bfl


def twolens_ffl(efl1, efl2, separation):
    """Front focal distance of a two thin-lens system."""
    _, _, ffl = _cardinal_points(_twolens_system(efl1, efl2, separation))
    return ffl


def twolens_separation(efl1, efl2, efl):
    """Separation of two thin lenses that yields system focal length ``efl``.

    Inverts power composition: phi = phi1 + phi2 - d*phi1*phi2 for d.
    """
    phi1, phi2, phi = 1 / efl1, 1 / efl2, 1 / efl
    return (phi1 + phi2 - phi) / (phi1 * phi2)
