"""3D line/ray geometry helpers used by raytracing routines.

Counterpart of ``prysm_tpu/x/raytracing/_line_math.py``; host numpy.
"""
import numpy as np


def normalize_vector(v, axis=-1):
    """v scaled to unit length along axis."""
    v = np.asarray(v)
    return v / np.linalg.norm(v, axis=axis, keepdims=True)


def unit_vector_between(P1, P2):
    """Unit vector pointing from P1 to P2."""
    return normalize_vector(np.asarray(P2) - np.asarray(P1), axis=-1)


def closest_point_on_line_to_line(P, S, axis_point, axis_dir):
    """Point on the axis line (axis_point, axis_dir) closest to line (P, S).

    Solves the 2x2 Gram system for the parameter pair minimizing
    ``|P + t S - (axis_point + u Sa)|``; parallel lines degrade to the foot
    of the perpendicular dropped from P onto the axis.
    """
    P = np.asarray(P)
    ray_dir = np.asarray(S)
    origin = np.asarray(axis_point)
    axis_unit = normalize_vector(axis_dir, axis=-1)

    separation = P - origin
    gram = np.array([[ray_dir @ ray_dir, -(ray_dir @ axis_unit)],
                     [ray_dir @ axis_unit, -(axis_unit @ axis_unit)]])
    rhs = np.array([-(ray_dir @ separation), -(axis_unit @ separation)])
    det = gram[0, 0] * gram[1, 1] - gram[0, 1] * gram[1, 0]
    if abs(det) < 1e-30:
        # parallel: foot of the perpendicular from P
        u = (axis_unit @ separation) / (axis_unit @ axis_unit)
        return origin + u * axis_unit
    u = (gram[0, 0] * rhs[1] - gram[1, 0] * rhs[0]) / det
    return origin + u * axis_unit
