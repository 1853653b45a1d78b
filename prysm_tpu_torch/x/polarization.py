"""Jones and Mueller calculus.

Counterpart of ``prysm_tpu/x/polarization.py``.  Jones matrices carry their
(2, 2) matrix in the trailing axes with arbitrary leading (spatial) batch
axes; polarized propagation moves the four components onto one leading
batch axis, so the batch-aware propagation runs them in one call.  Elements
are assembled with ``torch.stack`` in ``config.precision_complex``, on the
device of the tensors given (``config.device`` when none is).
"""
import functools
import math

import numpy as np
import torch

from ..conf import config, resolve_device
from ..mathops import cis
from .. import propagation

__all__ = ['supported_propagation_funcs', 'linear_pol_vector', 'circular_pol_vector',
           'jones_rotation_matrix', 'linear_retarder', 'linear_diattenuator',
           'half_wave_plate', 'quarter_wave_plate', 'linear_polarizer',
           'vector_vortex_retarder', 'broadcast_kron', 'jones_to_mueller',
           'pauli_spin_matrix', 'pauli_coefficients', 'jones_adapter',
           'add_jones_propagation', 'apply_polarization_optic']

supported_propagation_funcs = [
    'focus', 'unfocus', 'focus_dft', 'unfocus_dft', 'angular_spectrum',
]


def _device_of(*items):
    """The device of the first tensor among ``items``, else ``config.device``."""
    for item in items:
        if torch.is_tensor(item):
            return item.device
    return resolve_device()


def _real(x, device):
    """x as a tensor of ``config.precision`` on ``device`` (tensors keep theirs)."""
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(x, dtype=config.precision, device=device)


def _stack22(e00, e01, e10, e11, shape=None, device=None):
    """Assemble (..., 2, 2) from four broadcastable elements, on ``device`` (default:
    the first tensor's)."""
    cdt = config.precision_complex
    dev = _device_of(e00, e01, e10, e11) if device is None else device
    elems = [e.to(device=dev, dtype=cdt) if torch.is_tensor(e)
             else torch.as_tensor(e, dtype=cdt, device=dev) for e in (e00, e01, e10, e11)]
    shp = tuple(shape) if shape is not None else torch.broadcast_shapes(
        *(e.shape for e in elems))
    e00, e01, e10, e11 = (torch.broadcast_to(e, shp) for e in elems)
    row0 = torch.stack([e00, e01], dim=-1)
    row1 = torch.stack([e10, e11], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def linear_pol_vector(angle, degrees=True):
    """Linearly polarized Jones vector at the given angle.

    Scalar angle -> shape (2,); array angle -> (*angle.shape, 2, 1).
    """
    angle = _real(angle, _device_of(angle))
    if degrees:
        angle = angle * math.pi / 180
    cost = torch.cos(angle)
    sint = torch.sin(angle)
    cdt = config.precision_complex
    if angle.ndim:
        return torch.stack([cost, sint], dim=-1)[..., :, None].to(cdt)
    return torch.stack([cost, sint]).to(cdt)


def circular_pol_vector(handedness='left', shape=None):
    """Circularly polarized Jones vector."""
    cdt = config.precision_complex
    s = 1 / math.sqrt(2)
    if handedness == 'left':
        vec = torch.tensor([s, 1j * s], dtype=cdt, device=resolve_device())
    elif handedness == 'right':
        vec = torch.tensor([s, -1j * s], dtype=cdt, device=resolve_device())
    else:
        raise ValueError(f"unknown handedness {handedness}, use 'left' or 'right'")
    if shape is not None:
        return torch.broadcast_to(vec[:, None], (*shape, 2, 1))
    return vec


def jones_rotation_matrix(theta, shape=None):
    """In-plane rotation of the transverse coordinate system."""
    theta = _real(theta, _device_of(theta))
    cost = torch.cos(theta)
    sint = torch.sin(theta)
    out = _stack22(cost, sint, -sint, cost)
    if shape is not None:
        out = torch.broadcast_to(out, (*shape, 2, 2))
    return out


def linear_retarder(retardance, theta=0, shape=None):
    """Homogeneous linear retarder Jones matrix."""
    dev = _device_of(retardance, theta)
    retphasor = cis(_real(retardance, dev).to(config.precision))
    jones = _stack22(1, 0, 0, retphasor)
    if shape is not None:
        jones = torch.broadcast_to(jones, (*shape, 2, 2))
    theta = _real(theta, dev)
    return jones_rotation_matrix(-theta) @ jones @ jones_rotation_matrix(theta)


def linear_diattenuator(alpha, theta=0, shape=None):
    """Homogeneous linear diattenuator Jones matrix."""
    if not 0 <= alpha <= 1:
        raise ValueError(f'alpha cannot be less than 0 or greater than 1, got: {alpha}')
    dev = _device_of(alpha, theta)
    jones = _stack22(1, 0, 0, alpha, device=dev)
    if shape is not None:
        jones = torch.broadcast_to(jones, (*shape, 2, 2))
    theta = _real(theta, dev)
    return jones_rotation_matrix(-theta) @ jones @ jones_rotation_matrix(theta)


def half_wave_plate(theta=0, shape=None):
    """Half wave plate (pi retardance)."""
    return linear_retarder(math.pi, theta=theta, shape=shape)


def quarter_wave_plate(theta=0, shape=None):
    """Quarter wave plate (pi/2 retardance)."""
    return linear_retarder(math.pi / 2, theta=theta, shape=shape)


def linear_polarizer(theta=0, shape=None):
    """Linear polarizer (unit diattenuation)."""
    return linear_diattenuator(0, theta=theta, shape=shape)


def vector_vortex_retarder(charge, theta, retardance=math.pi, rotate=0):
    """Spatially-varying vector vortex retarder, Mawet et al. 2009 Eq (7)."""
    theta = _real(theta, _device_of(theta)) * charge
    dev = theta.device
    cost = torch.cos(theta)
    sint = torch.sin(theta)
    retardance = _real(retardance, dev)
    jcosr = -1j * torch.cos(retardance / 2)
    jsinr = torch.sin(retardance / 2)
    vvr_lhs = _stack22(cost, sint, sint, -cost) * jsinr
    # jcosr only into [0, 0], as the JAX package (and prysm) write it
    vvr_rhs = _stack22(jcosr * torch.ones_like(cost), 0, 0, 0)
    vvr = vvr_lhs + vvr_rhs
    rotate = _real(rotate, dev)
    return jones_rotation_matrix(-rotate) @ vvr @ jones_rotation_matrix(rotate)


def broadcast_kron(a, b):
    """Broadcasted Kronecker product of (..., 2, 2) arrays -> (..., 4, 4)."""
    tmp = torch.einsum('...ik,...jl->...ijkl', a, b)
    return tmp.reshape([*a.shape[:-2], a.shape[-2] * b.shape[-2],
                        a.shape[-1] * b.shape[-1]])


def jones_to_mueller(jones, broadcast=True):
    """Jones -> Mueller conversion (Chipman, Lam, Young Eq 6.99)."""
    U = np.asarray([[1, 0, 0, 1],
                    [1, 0, 0, -1],
                    [0, 1, 1, 0],
                    [0, 1j, -1j, 0]]) / np.sqrt(2)
    cdt, dev = config.precision_complex, jones.device
    Uj = torch.as_tensor(U, dtype=cdt, device=dev)
    Uinv = torch.as_tensor(np.linalg.inv(U), dtype=cdt, device=dev)
    jones = jones.to(cdt)
    if broadcast:
        jprod = broadcast_kron(torch.conj(jones), jones)
    else:
        jprod = torch.kron(torch.conj(jones), jones)
    return torch.real(Uj @ jprod @ Uinv)


def pauli_spin_matrix(index, shape=None):
    """Pauli spin matrix of given index (CLY Eq 6.108)."""
    if index not in (0, 1, 2, 3):
        raise ValueError(f'index should be 0,1,2, or 3. Got {index}')
    elements = {0: (1, 0, 0, 1), 1: (1, 0, 0, -1), 2: (0, 1, 1, 0), 3: (0, -1j, 1j, 0)}
    out = _stack22(*elements[index])
    if shape is not None:
        out = torch.broadcast_to(out, (*shape, 2, 2))
    return out


def pauli_coefficients(jones):
    """Pauli coefficients (c0, c1, c2, c3) of a Jones matrix."""
    c0 = (jones[..., 0, 0] + jones[..., 1, 1]) / 2
    c1 = (jones[..., 0, 0] - jones[..., 1, 1]) / 2
    c2 = (jones[..., 0, 1] + jones[..., 1, 0]) / 2
    c3 = 1j * (jones[..., 0, 1] - jones[..., 1, 0]) / 2
    return c0, c1, c2, c3


def jones_adapter(prop_func):
    """Wrap a propagation function to act on (..., 2, 2) Jones fields.

    The four components propagate independently; they are moved onto a
    leading axis so the underlying batch-aware propagation runs them in one
    call rather than a Python loop.  Idempotent: wrapping an already-adapted
    function returns it unchanged, so an explicit ``jones_adapter(focus)``
    composes safely with a prior ``add_jones_propagation()`` module patch.
    """
    if getattr(prop_func, '_jones_adapted', False):
        return prop_func

    @functools.wraps(prop_func)
    def wrapper(*args, **kwargs):
        wavefunction = args[0]
        other_args = args[1:] if len(args) > 1 else ()
        if wavefunction.ndim == 2:
            return prop_func(*args, **kwargs)
        # (..., 2, 2) -> (4, ...) leading batch
        J = torch.movedim(wavefunction.reshape(*wavefunction.shape[:-2], 4), -1, 0)
        ret = prop_func(J, *other_args, **kwargs)
        out = torch.movedim(ret, 0, -1)
        return out.reshape(*out.shape[:-1], 2, 2)
    wrapper._jones_adapted = True
    return wrapper


def add_jones_propagation(funcs_to_change=supported_propagation_funcs):
    """Monkey-patch prysm_tpu_torch.propagation functions with the Jones adapter."""
    for name, func in list(vars(propagation).items()):
        if name in funcs_to_change:
            setattr(propagation, name, jones_adapter(func))


def apply_polarization_optic(field, pol_optic):
    """Apply a Jones-matrix optic to a scalar field -> (..., 2, 2) field."""
    if field.ndim == 2:
        field = field[..., None, None]
    return pol_optic * field
