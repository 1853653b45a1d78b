"""Parameter seeds for adjoint (reverse-mode) sensitivities.

Counterpart of ``prysm_tpu/x/raytracing/adjoint/seeds.py``.  A seed names
one tolerance parameter and how it perturbs the compiled prescription:

* ``pose``: {surface_index: (Qdot, Rdot)} vertex / rotation tangents
* ``shapes``: (surface_index, param_name, scale) scalar shape-DOF tangents
* ``sag_term``: (surface_index, fn) an additive sag contribution
  ``delta z = eps * fn(x, y)`` (the engine differentiates the term
  directly, so no hand-derived partials are needed)
* ``index``: (surface_index, scale) tangent of the following medium

The engine materializes seeds as a perturbation vector ``eps`` applied
functionally to the surface list, then differentiates the whole trace
with autograd (reverse mode) or ``torch.func.jvp`` (forward mode).
"""
import numpy as onp

from ..lensdata import SurfaceMap
from ..spencer_and_murty import to_host


class DiffSeed:
    """One tolerance parameter's action on the compiled prescription."""

    __slots__ = ('pose', 'shapes', 'sag_term', 'index', 'name')

    def __init__(self, pose=None, shapes=None, sag_term=None, index=None,
                 name=''):
        self.pose = dict(pose) if pose else {}
        self.shapes = tuple(shapes) if shapes else ()
        self.sag_term = sag_term
        self.index = index
        self.name = str(name)

    def __repr__(self):
        return f'DiffSeed(name={self.name!r})'


def seed_curvature(surface, name='c'):
    """Seed for a curvature (DLR-style) tolerance on shape DOF 'c'."""
    return DiffSeed(shapes=[(surface, 'c', 1.0)], name=name)


def seed_conic(surface, name='k'):
    """Seed for a conic-constant tolerance on shape DOF 'k'."""
    return DiffSeed(shapes=[(surface, 'k', 1.0)], name=name)


def seed_shape_param(surface, param_name, name=None):
    """Seed for an arbitrary scalar shape DOF."""
    return DiffSeed(shapes=[(surface, param_name, 1.0)],
                    name=name or param_name)


def seed_decenter(surface, axis, name=None):
    """Seed for a decenter tolerance: the vertex moves along axis."""
    idx = {'x': 0, 'y': 1, 'z': 2}[axis]
    q = onp.zeros(3)
    q[idx] = 1.0
    return DiffSeed(pose={surface: (q, None)},
                    name=name or f'decenter_{axis}')


def seed_despace(surfaces, name='despace'):
    """Seed for a despace tolerance: (surface_index, sign) vertex shifts.

    All listed surfaces translate along +z scaled by their sign, which
    expresses a thickness change as the rigid motion of everything
    downstream.
    """
    q_plus = onp.array([0.0, 0.0, 1.0])
    pose = {}
    for sidx, sgn in surfaces:
        pose[sidx] = (sgn * q_plus, None)
    return DiffSeed(pose=pose, name=name)


_GENERATORS = {
    'x': onp.array([[0., 0., 0.], [0., 0., -1.], [0., 1., 0.]]),
    'y': onp.array([[0., 0., 1.], [0., 0., 0.], [-1., 0., 0.]]),
    'z': onp.array([[0., -1., 0.], [1., 0., 0.], [0., 0., 0.]]),
}


def seed_tilt(surface, axis, R_nominal=None, name=None):
    """Seed for a tilt tolerance about a local axis, radians.

    R_total = R_nominal @ R_tilt(a) to first order gives
    Rdot = R_nominal @ G_axis; R_nominal=None means identity.
    """
    G = _GENERATORS[axis]
    Rdot = G if R_nominal is None else onp.asarray(R_nominal, float) @ G
    return DiffSeed(pose={surface: (onp.zeros(3), Rdot)},
                    name=name or f'tilt_{axis}')


def seed_index(surface, name='index'):
    """Seed for an index tolerance on the medium following a surface."""
    return DiffSeed(index=(surface, 1.0), name=name)


def seed_irregularity(surface, n, m, normalization_radius, *, norm=True,
                      name=None):
    """Seed for a Zernike surface-irregularity tolerance.

    delta z = eps * Z_n^m(x / R, y / R); with norm=True unit amplitude
    is unit RMS over the disk of radius R.  The term flattens the ray
    coordinates, so ``zernike_sum`` builds its mode stack: the fused kernel
    it takes for 2-D grids has no forward-mode rule.
    """
    from ....polynomials.zernike import zernike_sum

    R = float(normalization_radius)

    def term(x, y):
        # flattened: a 2-D bundle would reach the fused kernel
        shape = x.shape
        return zernike_sum([1.0], [(n, m)], x.reshape(-1) / R, y.reshape(-1) / R,
                           norm=norm).reshape(shape)

    return DiffSeed(sag_term=(surface, term), name=name or f'irr_Z{n}_{m}')


def _shape_dof_name(row, off):
    """Resolve a shape-DOF offset to its scalar parameter name."""
    for key, (start, length) in row.key_offsets.items():
        if start <= off < start + length:
            if length == 1:
                return key
            raise NotImplementedError(
                f'vector shape DOF {key!r} element sensitivities are not '
                'mapped to a seed; use the FD sensitivity_table instead')
    raise KeyError(f'no shape DOF at offset {off}')


def seed_from_slot(lensdata, slot, design=None, *, name=None,
                   pose_step=1e-6):
    """DiffSeed for one editor DOF slot (group, row, offset).

    Shape DOFs map through the design's pickup expansion when a
    DesignState is given; pose tangents come from finite-differencing
    the compiled layout (host side, exact enough at pose_step ~1e-6 for
    the linear model).
    """
    group, row_idx, off = slot
    ld = lensdata
    if design is None:
        owner = getattr(ld, 'system_owner', None)
        design = None if owner is None else owner._design
    expansion = ({slot: 1.0} if design is None
                 else design.pickup_expansion(slot))

    mapping = SurfaceMap(ld)
    shapes = []
    for dep_slot, scale in expansion.items():
        dep_group, dep_row, dep_off = dep_slot
        if dep_group != 'shape' or scale == 0.0:
            continue
        shapes.append((mapping.surface_for_row(dep_row),
                       _shape_dof_name(ld.rows[dep_row], dep_off),
                       float(scale)))

    pose = _pose_tangents(ld, slot, pose_step)
    return DiffSeed(pose=pose, shapes=shapes,
                    name=name or f'{group}{row_idx}')


def seed_from_perturbation(perturbation, *, pose_step=1e-6):
    """DiffSeed matching a tolerance.Perturbation on a LensData."""
    group, row_idx, _ = perturbation.slot
    return seed_from_slot(perturbation.lensdata, perturbation.slot,
                          name=perturbation.name or f'{group}{row_idx}',
                          pose_step=pose_step)


def seeds_from_perturbations(perturbations, *, pose_step=1e-6):
    """One DiffSeed per tolerance.Perturbation, in the given order.

    The returned seeds define the trailing parameter axis of
    raytrace_with_tangents / wavefront_with_tangents.
    """
    return [seed_from_perturbation(p, pose_step=pose_step)
            for p in perturbations]


def _pose_tangents(ld, slot, h):
    """Central-difference (Qdot, Rdot) of every compiled pose wrt one DOF."""
    nominal = float(ld._slot_value(slot))

    def _layout(value):
        ld._set_slot_value(slot, value)
        ld._invalidate()
        surfs = ld.to_surfaces()
        return ([onp.array(to_host(s.P), dtype=float) for s in surfs],
                [onp.eye(3) if s.R is None else onp.array(to_host(s.R), dtype=float)
                 for s in surfs])

    try:
        Pp, Rp = _layout(nominal + h)
        Pm, Rm = _layout(nominal - h)
    finally:
        ld._set_slot_value(slot, nominal)
        ld._invalidate()

    inv2h = 0.5 / h
    pose = {}
    for j in range(len(Pp)):
        Qdot = (Pp[j] - Pm[j]) * inv2h
        Rdot = (Rp[j] - Rm[j]) * inv2h
        r_nz = bool(onp.any(Rdot))
        if bool(onp.any(Qdot)) or r_nz:
            pose[j] = (Qdot, Rdot if r_nz else None)
    return pose


__all__ = [
    'DiffSeed',
    'seed_curvature', 'seed_conic', 'seed_shape_param', 'seed_decenter',
    'seed_despace', 'seed_tilt', 'seed_index', 'seed_irregularity',
    'seed_from_slot', 'seed_from_perturbation',
]
