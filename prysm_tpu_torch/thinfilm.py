"""Thin film calculations: Fresnel coefficients and multilayer stacks.

Counterpart of ``prysm_tpu/thinfilm.py``.  The characteristic-matrix
product over layers is a Python loop of elementwise 2x2 products, each
vectorized over the trailing (spatial/spectral) dimensions, where the JAX
package scans; it differentiates under torch autograd with respect to every
thickness and index.

Complex-aware square roots (numpy's scimath) are emulated by promoting to
the complex dtype, so evanescent and TIR cases take the same branch as in
the JAX package.  Python numbers and lists become tensors of
``config.precision`` on ``config.device`` (``conf.to_tensor``).
"""
import math

import torch

from .conf import complex_for, to_tensor

__all__ = ['brewsters_angle', 'critical_angle', 'snell_aor', 'fresnel_rs', 'fresnel_ts',
           'fresnel_rp', 'fresnel_tp', 'multilayer_stack_rt']


def brewsters_angle(n0, n1, deg=True):
    """Brewster's angle at an interface."""
    ang = torch.atan2(to_tensor(n1), to_tensor(n0))
    return torch.rad2deg(ang) if deg else ang


def critical_angle(n0, n1, deg=True):
    """Minimum angle for total internal reflection."""
    ang = torch.asin(to_tensor(n1 / n0))
    return torch.rad2deg(ang) if deg else ang


def _to_complex(x):
    x = to_tensor(x)
    return x.to(complex_for(x.dtype))


def snell_aor(n0, n1, theta, deg=True):
    """Angle of refraction via Snell's law (complex for evanescent cases)."""
    theta = to_tensor(theta)
    if deg:
        theta = torch.deg2rad(theta)
    return torch.asin(_to_complex(n0 / n1 * torch.sin(theta)))


def _cos_snell(n0, n1, theta):
    """cos(theta_1) from Snell's law, complex-aware, TIR sign flip."""
    sint = n0 / n1 * torch.sin(theta)
    cost = torch.sqrt(_to_complex(1 - sint * sint))
    if sint.is_complex():
        tir = (sint.imag == 0) & (sint.real > 1)
    else:
        tir = sint > 1
    return torch.where(tir, -cost, cost)


def fresnel_rs(n0, n1, theta0, theta1):
    """Fresnel reflection coefficient, s-polarization."""
    c0, c1 = torch.cos(to_tensor(theta0)), torch.cos(to_tensor(theta1))
    return (n0 * c0 - n1 * c1) / (n0 * c0 + n1 * c1)


def fresnel_ts(n0, n1, theta0, theta1):
    """Fresnel transmission coefficient, s-polarization."""
    c0, c1 = torch.cos(to_tensor(theta0)), torch.cos(to_tensor(theta1))
    return (2 * n0 * c0) / (n0 * c0 + n1 * c1)


def fresnel_rp(n0, n1, theta0, theta1):
    """Fresnel reflection coefficient, p-polarization."""
    c0, c1 = torch.cos(to_tensor(theta0)), torch.cos(to_tensor(theta1))
    return (n0 * c1 - n1 * c0) / (n0 * c1 + n1 * c0)


def fresnel_tp(n0, n1, theta0, theta1):
    """Fresnel transmission coefficient, p-polarization."""
    c0, c1 = torch.cos(to_tensor(theta0)), torch.cos(to_tensor(theta1))
    return (2 * n0 * c0) / (n0 * c1 + n1 * c0)


def multilayer_stack_rt(indices, thicknesses, wavelength, polarization,
                        substrate_index, aoi=0, ambient_index=1):
    """r, t coefficients of a multilayer stack (characteristic matrices).

    indices/thicknesses: leading layer axis, trailing vectorized dims.
    wavelength um; polarization {'p', 's'}; aoi degrees.
    """
    polarization = polarization.lower()
    if polarization not in ('p', 's'):
        raise ValueError('unknown polarization, use p or s')
    indices = torch.atleast_1d(to_tensor(indices))
    thicknesses = torch.atleast_1d(to_tensor(thicknesses))
    indices, thicknesses = torch.broadcast_tensors(indices, thicknesses)
    if indices.shape[0] == 0:
        raise ValueError('indices and thicknesses must contain at least one film layer')
    aoi = torch.deg2rad(to_tensor(aoi, device=indices.device))
    wavelength = to_tensor(wavelength, device=indices.device)
    cost0 = torch.cos(aoi)

    def layer_mats(n, d):
        cost = _cos_snell(ambient_index, n, aoi)
        beta = (2 * math.pi * n * d * cost) / wavelength
        sinb, cosb = torch.sin(beta), torch.cos(beta)
        if polarization == 'p':
            upper_right = -1j * sinb * cost / n
            lower_left = -1j * n * sinb / cost
        else:
            upper_right = -1j * sinb / (cost * n)
            lower_left = -1j * n * sinb * cost
        return cosb, upper_right, lower_left

    c0, u0, l0 = layer_mats(indices[0], thicknesses[0])
    ones = torch.ones_like(c0)
    m00, m01, m10, m11 = c0 * ones, u0 * ones, l0 * ones, c0 * ones
    for n, d in zip(indices[1:], thicknesses[1:]):
        cosb, upper_right, lower_left = layer_mats(n, d)
        m00, m01 = m00 * cosb + m01 * lower_left, m00 * upper_right + m01 * cosb
        m10, m11 = m10 * cosb + m11 * lower_left, m10 * upper_right + m11 * cosb

    substrate_index = to_tensor(substrate_index, device=indices.device)
    cos_sub = _cos_snell(ambient_index, substrate_index, aoi)
    # Macleod B/C form: [B; C] = M @ [1; eta_sub] with tilted admittances
    # eta = n*cos (s) / n/cos (p); r = (eta0*B - C)/(eta0*B + C).  The
    # p-pol transmission amplitude carries an extra cos(aoi)/cos(aot)
    # obliquity factor relative to the plain 2*eta0/(eta0*B + C) form, the
    # reference's field convention.
    if polarization == 'p':
        eta0 = ambient_index / cost0
        eta_sub = substrate_index / cos_sub
        obliquity = cost0 / cos_sub
    else:
        eta0 = ambient_index * cost0
        eta_sub = substrate_index * cos_sub
        obliquity = 1.0
    B = m00 + m01 * eta_sub
    C = m10 + m11 * eta_sub
    denom = eta0 * B + C
    r = (eta0 * B - C) / denom
    t = obliquity * 2 * eta0 / denom
    return r, t
