"""Posed surfaces and the sag-shape kind table for raytracing.

Counterpart of ``prysm_tpu/x/raytracing/surfaces.py``: the shape
vocabulary (Plane .. Biconic), ``Surface`` construction keywords, and the
departure-band first-root policing:

* every shape *kind* is one row in ``SHAPE_MODELS``: a static
  :class:`SagModel` spec holding pure sag/gradient functions over a plain
  parameter dict, its self-describing DOF list, and (when they exist) the
  conic seed and closed-form intersector;
* :class:`Shape` is a single final class — ``(spec, params)``.  A
  parameter is a Python number or a tensor; a tensor parameter (a
  curvature with ``requires_grad``) carries its graph through the trace.
  There is no per-shape subclass: editing machinery (``LensData``) goes
  through ``Shape.with_params`` and reads DOF layout from ``spec.dofs``;
* the classic constructors (``Sphere(c)``, ``EvenAsphere(c, k, coefs)``,
  …) are factory functions returning ``Shape`` instances, with the JAX
  package's names and signatures;
* sag math lives in :mod:`sagjets` as ``(value, d/d(rho^2))`` jets: one
  pass yields sag + gradient, so there are no separate ``*_sag`` /
  ``*_sag_der`` twins to keep in sync and Newton steps stay one memory
  pass.

Conic-seeded kinds are policed by a :class:`DepartureBand` — bounds on how
far (and how steeply) the sag departs from its seed conic over a
characterized disk — which backs the first-root acceptance test and the
Lipschitz-march rescue in ``intersections``.

Poses: a surface built from host values keeps P and R in host numpy (the
planners read them there) and keeps one tensor copy per device and dtype
for the trace; a pose given as tensors stays a tensor, with its graph.
"""
import warnings
from collections import namedtuple

import numpy as onp
import torch
from torch import func as tfunc

from ...conf import config, numpy_dtype
from ...coordinates import apply_tilt_decenter, make_rotation_matrix
from ...polynomials import (
    cheby1_2d_sum, cheby1_2d_sum_der_xy,
    jacobi_radial_sum, jacobi_radial_sum_der_xy,
    xy_sum, xy_sum_der_xy,
    zernike_sum, zernike_sum_der_xy,
)

from .spencer_and_murty import (
    STYPE_EVAL, STYPE_OBJ, STYPE_IMG, STYPE_REFLECT, STYPE_REFRACT,
    _is_measurement_surf,
    STATUS_OK, STATUS_MISS, STATUS_NEWTON, STATUS_CLIP, STATUS_TIR,
    STATUS_EVANESCENT,
    refract, refract_with_tir, reflect,
    diffract as _diffract_kernel,
    transform_to_local_coords, transform_to_global_coords,
    intersect as newton_intersect,
    SURFACE_INTERSECTION_DEFAULT_MAXITER,
    _index_value,
)
from .intersections import (
    MARCH_RADIUS_MARGIN,
    ray_conic_intersect,
    ray_plane_intersect,
    ray_sphere_intersect,
    seeded_newton_intersect,
)
from .aperture import annular_aperture, as_aperture, circular_aperture
from .opl import OPLFunc
from . import sagjets
from .sagjets import add_conic_base, asphere_jet, conic_jet, unit_normal
from .sags import (
    Q2d_and_der, Q2d_sag,
    autodiff_sag_and_normal,
    conic_sag, conic_sag_der, even_asphere_sag, even_asphere_sag_der_xy,
    gradient_to_unit_normal, phi_conic, plane_sag_and_normal, product_rule,
    sphere_sag, sphere_sag_der, _float_tensor,
)


# Sample count per axis when characterizing a departure band; the
# max-departure estimate is padded 10% to absorb grid resolution.
DEPARTURE_BAND_SAMPLES = 64
# Departure-slope ceiling: the crossing spacing scale is ~D/G against a
# band width of ~2D, so slopes at or past 0.5 can put more than one
# crossing inside the acceptance band and first-root selection warns.
DEPARTURE_GRADIENT_WARN = 0.5


def _map_stype(typ):
    """Map a user-facing interaction spec to an STYPE constant."""
    if isinstance(typ, str):
        t = typ.lower()
        mapping = {
            'reflect': STYPE_REFLECT, 'refl': STYPE_REFLECT,
            'mirror': STYPE_REFLECT,
            'refract': STYPE_REFRACT, 'refr': STYPE_REFRACT,
            'eval': STYPE_EVAL, 'evaluate': STYPE_EVAL,
            'object': STYPE_OBJ, 'obj': STYPE_OBJ,
            'image': STYPE_IMG, 'img': STYPE_IMG,
        }
        try:
            return mapping[t]
        except KeyError:
            raise ValueError(f'unknown interaction {typ!r}')
    if typ in (STYPE_REFLECT, STYPE_REFRACT, STYPE_EVAL, STYPE_OBJ, STYPE_IMG):
        return typ
    raise ValueError(f'unknown interaction {typ!r}')


def _concrete_float(x):
    """float(x) for a host scalar, else None.

    A tensor is never static: ``float()`` would read it back from the
    device and cut its graph, so a tensor answers None.
    """
    if torch.is_tensor(x):
        return None
    try:
        return float(x)
    except (TypeError, ValueError):
        return None


def _carries_tensor(params):
    """The first tensor among a parameter dict's values (or None)."""
    for v in params.values():
        if torch.is_tensor(v):
            return v
        if isinstance(v, (tuple, list)):
            for w in v:
                if torch.is_tensor(w):
                    return w
    return None


# ---------------------------------------------------------------------------
# shape kind table
# ---------------------------------------------------------------------------

class DOF(namedtuple('DOF', 'name vector tags')):
    """One editable degree of freedom of a shape kind.

    name is the parameter-dict key; vector marks variable-length
    coefficient blocks; tags are the edit categories ('curvature',
    'radius', 'conic', 'coefs', …) the DOF answers to.
    """

    __slots__ = ()

    def __new__(cls, name, vector=False, tags=()):
        return super().__new__(cls, name, vector, tuple(tags))


class SagModel(namedtuple(
        'SagModel', 'name dofs meta field fz seed closed canon')):
    """Static spec of one shape kind: pure functions over a param dict.

    Attributes
    ----------
    name : str
        kind name; lowercase snake, shared with the IO layer vocabulary.
    dofs : tuple of DOF
        editable parameters in dense-vector order.
    meta : tuple of str
        static configuration parameter names (index lists, norms, …).
    field : callable
        ``field(p, x, y) -> (z, dz/dx, dz/dy)`` — the fused evaluation
        every consumer (normals, Newton, AD) is built on.
    fz : callable or None
        sag-only fast path; None derives it from ``field``.
    seed : callable or None
        ``seed(p) -> (c, k, dx, dy)`` conic approximant for seeded Newton
        intersection; None for kinds with no usable seed.
    closed : callable or None
        ``closed(p, P, S) -> (Q, n, valid)`` closed-form intersection;
        None for kinds that need Newton.
    canon : callable or None
        in-place canonicalization of a freshly built param dict
        (tuple-ification of coefficient blocks and the like).
    """

    __slots__ = ()

    def __new__(cls, name, dofs=(), meta=(), field=None, fz=None,
                seed=None, closed=None, canon=None):
        return super().__new__(cls, name, tuple(dofs), tuple(meta),
                               field, fz, seed, closed, canon)

    def tagged(self, *tags):
        """Names of the DOFs carrying any of the given tags, in DOF order."""
        for tag in tags:
            found = tuple(d.name for d in self.dofs if tag in d.tags)
            if found:
                return found
        return ()

    @property
    def param_names(self):
        """All constructor parameter names: DOFs then meta."""
        return tuple(d.name for d in self.dofs) + self.meta


SHAPE_MODELS = {}


def _model(**kw):
    m = SagModel(**kw)
    SHAPE_MODELS[m.name] = m
    return m


class Shape:
    """A sag-bearing shape: a static :class:`SagModel` plus its parameters.

    One final class for every kind; behavior is table-dispatched through
    ``self.spec``.  DOF parameter values may be tensors, whose graphs the
    trace carries.
    """

    __slots__ = ('spec', 'p')

    def __init__(self, spec, params=None, **kw):
        if isinstance(spec, str):
            spec = SHAPE_MODELS[spec]
        p = dict(params) if params else {}
        p.update(kw)
        if spec.canon is not None:
            spec.canon(p)
        self.spec = spec
        self.p = p

    @property
    def kind(self):
        """Kind name of this shape ('sphere', 'even_asphere', …)."""
        return self.spec.name

    @property
    def params(self):
        """Copy of the full parameter dict (DOFs + meta)."""
        return dict(self.p)

    @property
    def analytic_intersect(self):
        """True when the kind carries a closed-form intersector."""
        return self.spec.closed is not None

    def with_params(self, params):
        """A fresh shape of the same kind with a replaced parameter dict."""
        return Shape(self.spec, params)

    def __repr__(self):
        inner = ', '.join(f'{k}={v!r}' for k, v in self.p.items())
        return f'Shape<{self.spec.name}>({inner})'

    # ---- evaluation --------------------------------------------------------
    def sag(self, x, y):
        """Surface sag at local (x, y)."""
        if self.spec.fz is not None:
            return self.spec.fz(self.p, x, y)
        return self.spec.field(self.p, x, y)[0]

    def sag_and_normal(self, x, y):
        """(sag, unit normal) at local (x, y), one fused pass."""
        z, gx, gy = self.spec.field(self.p, x, y)
        return z, unit_normal(gx, gy)

    def sag_hessian(self, x, y):
        """Sag second derivatives (z_xx, z_xy, z_yy) via one jvp sweep
        per axis over the fused gradient."""
        x = _float_tensor(x)
        y = _float_tensor(y, like=x)

        def grad(xv, yv):
            return self.spec.field(self.p, xv, yv)[1:]

        ones = torch.ones_like(x)
        zeros = torch.zeros_like(x)
        _, (z_xx, z_xy) = tfunc.jvp(grad, (x, y), (ones, zeros))
        _, (_, z_yy) = tfunc.jvp(grad, (x, y), (zeros, ones))
        return z_xx, z_xy, z_yy

    def sag_param_partials(self, x, y, name):
        """(z_t, gx_t, gy_t): partials of sag and gradient wrt a scalar
        parameter at fixed (x, y), by one jvp through the fused field."""
        if name not in self.p:
            raise ValueError(
                f'shape has no parameter {name!r} to differentiate against')
        x = _float_tensor(x)
        y = _float_tensor(y, like=x)

        def f(v):
            return self.spec.field({**self.p, name: v}, x, y)

        v0 = torch.as_tensor(float(self.p[name]), dtype=x.dtype, device=x.device)
        _, tangents = tfunc.jvp(f, (v0,), (torch.ones_like(v0),))
        return tangents

    # ---- intersection ------------------------------------------------------
    def seed_conic(self):
        """(c, k, dx, dy) conic approximant, or None for seedless kinds."""
        if self.spec.seed is None:
            return None
        return self.spec.seed(self.p)

    def intersect(self, P, S, sag_and_normal=None, tol_sag=None,
                  maxiter=None):
        """Closed-form intersection when the kind has one, else Newton."""
        if self.spec.closed is not None:
            return self.spec.closed(self.p, P, S)
        if maxiter is None:
            maxiter = SURFACE_INTERSECTION_DEFAULT_MAXITER
        return newton_intersect(P, S, sag_and_normal or self.sag_and_normal,
                                tol_sag=tol_sag, maxiter=maxiter)


class CallableShape:
    """Shape-protocol adapter around user callables.

    ``sag(x, y)`` is required; ``sag_and_normal(x, y)`` is derived by
    autodiff when not supplied.  Not a table kind — it has no spec, so it
    takes the plain (unseeded) Newton intersection path and cannot be
    packed into a LensData DOF vector.
    """

    __slots__ = ('_fz', '_fsan', 'p', '_auto')

    spec = None
    kind = 'callable'
    analytic_intersect = False

    def __init__(self, sag, sag_and_normal=None, params=None):
        self._fz = sag
        self._fsan = sag_and_normal
        self._auto = None
        self.p = dict(params) if params else {}

    @property
    def params(self):
        """Copy of the descriptive parameter dict (not used in evaluation)."""
        return dict(self.p)

    def sag(self, x, y):
        """Evaluate the user sag."""
        return self._fz(x, y)

    def sag_and_normal(self, x, y):
        """Evaluate sag and normal (autodiff if not supplied)."""
        if self._fsan is not None:
            return self._fsan(x, y)
        if self._auto is None:
            self._auto = autodiff_sag_and_normal(self._fz)
        return self._auto(x, y)

    def seed_conic(self):
        """Callable shapes carry no conic approximant."""
        return None


# ---------------------------------------------------------------------------
# kind definitions
# ---------------------------------------------------------------------------

def _tuplify(p, *names):
    for n in names:
        v = p.get(n)
        if v is not None and not isinstance(v, tuple):
            p[n] = tuple(v)


def _radial(jet):
    """Lift a jet function jet(p, s) -> (z, dz/ds) to a cartesian field."""
    def field(p, x, y):
        z, d = jet(p, x * x + y * y)
        g = 2.0 * d
        return z, g * x, g * y
    return field


_C_TAGS = ('curvature', 'radius')

_PLANE = _model(
    name='plane',
    field=lambda p, x, y: sagjets.zero_field(x, y),
    fz=lambda p, x, y: sagjets.zero_field(x, y)[0],
    closed=lambda p, P, S: ray_plane_intersect(P, S),
)

_SPHERE = _model(
    name='sphere',
    dofs=(DOF('c', tags=_C_TAGS),),
    field=_radial(lambda p, s: conic_jet(p['c'], 0.0, s)),
    fz=lambda p, x, y: conic_jet(p['c'], 0.0, x * x + y * y)[0],
    closed=lambda p, P, S: ray_sphere_intersect(P, S, p['c']),
)

_CONIC = _model(
    name='conic',
    dofs=(DOF('c', tags=_C_TAGS), DOF('k', tags=('conic',))),
    field=_radial(lambda p, s: conic_jet(p['c'], p['k'], s)),
    fz=lambda p, x, y: conic_jet(p['c'], p['k'], x * x + y * y)[0],
    closed=lambda p, P, S: ray_conic_intersect(P, S, p['c'], p['k']),
)


def _oac_field(p, x, y):
    z, d = conic_jet(p['c'], p['k'],
                     (x + p['dx']) ** 2 + (y + p['dy']) ** 2)
    g = 2.0 * d
    return z, g * (x + p['dx']), g * (y + p['dy'])


_OFF_AXIS_CONIC = _model(
    name='off_axis_conic',
    dofs=(DOF('c', tags=_C_TAGS), DOF('k', tags=('conic',))),
    meta=('dx', 'dy'),
    field=_oac_field,
    fz=lambda p, x, y: conic_jet(
        p['c'], p['k'], (x + p['dx']) ** 2 + (y + p['dy']) ** 2)[0],
    closed=lambda p, P, S: ray_conic_intersect(P, S, p['c'], p['k'],
                                               dx=p['dx'], dy=p['dy']),
)

_EVEN_ASPHERE = _model(
    name='even_asphere',
    dofs=(DOF('c', tags=_C_TAGS), DOF('k', tags=('conic',)),
          DOF('coefs', vector=True, tags=('coefs',))),
    field=_radial(lambda p, s: asphere_jet(p['c'], p['k'], p['coefs'], s)),
    fz=lambda p, x, y: asphere_jet(p['c'], p['k'], p['coefs'],
                                   x * x + y * y)[0],
    seed=lambda p: (p['c'], p['k'], 0.0, 0.0),
    canon=lambda p: _tuplify(p, 'coefs'),
)


def _zernike_field(p, x, y):
    R = p['normalization_radius']
    z, gx, gy = zernike_sum_der_xy(p['coefs'], p['nms'], x / R, y / R,
                                   norm=p['norm'])
    return add_conic_base(p['c'], p['k'], x, y, z, gx / R, gy / R)


def _base_z(c, k, x, y, z):
    """Add a conic base sag to a polynomial departure sag."""
    if sagjets.is_concrete_zero(c):
        return z
    return z + conic_jet(c, k, x * x + y * y)[0]


def _zernike_fz(p, x, y):
    R = p['normalization_radius']
    z = zernike_sum(p['coefs'], p['nms'], x / R, y / R, norm=p['norm'])
    return _base_z(p['c'], p['k'], x, y, z)


def _zernike_canon(p):
    _tuplify(p, 'coefs')
    p['nms'] = tuple(map(tuple, p['nms']))


_ZERNIKE = _model(
    name='zernike',
    dofs=(DOF('c', tags=_C_TAGS), DOF('k', tags=('conic',)),
          DOF('coefs', vector=True, tags=('coefs',))),
    meta=('normalization_radius', 'nms', 'norm'),
    field=_zernike_field,
    fz=_zernike_fz,
    seed=lambda p: (p['c'], p['k'], 0.0, 0.0),
    canon=_zernike_canon,
)


def _xy_field(p, x, y):
    R = p['normalization_radius']
    z, gx, gy = xy_sum_der_xy(p['coefs'], p['mns'], x / R, y / R)
    return add_conic_base(p['c'], p['k'], x, y, z, gx / R, gy / R)


def _xy_canon(p):
    _tuplify(p, 'coefs')
    p['mns'] = tuple(map(tuple, p['mns']))


_XY = _model(
    name='xy',
    dofs=(DOF('c', tags=_C_TAGS), DOF('k', tags=('conic',)),
          DOF('coefs', vector=True, tags=('coefs',))),
    meta=('normalization_radius', 'mns'),
    field=_xy_field,
    fz=lambda p, x, y: _base_z(
        p['c'], p['k'], x, y,
        xy_sum(p['coefs'], p['mns'],
               x / p['normalization_radius'],
               y / p['normalization_radius'])),
    seed=lambda p: (p['c'], p['k'], 0.0, 0.0),
    canon=_xy_canon,
)


def _cheby_field(p, x, y):
    xn, yn = p['x_norm'], p['y_norm']
    z, gx, gy = cheby1_2d_sum_der_xy(p['coefs'], p['mns'], x / xn, y / yn,
                                     x_norm=xn, y_norm=yn)
    return add_conic_base(p['c'], p['k'], x, y, z, gx, gy)


_CHEBYSHEV = _model(
    name='chebyshev',
    dofs=(DOF('c', tags=_C_TAGS), DOF('k', tags=('conic',)),
          DOF('coefs', vector=True, tags=('coefs',))),
    meta=('x_norm', 'y_norm', 'mns'),
    field=_cheby_field,
    fz=lambda p, x, y: _base_z(
        p['c'], p['k'], x, y,
        cheby1_2d_sum(p['coefs'], p['mns'],
                      x / p['x_norm'], y / p['y_norm'])),
    seed=lambda p: (p['c'], p['k'], 0.0, 0.0),
    canon=_xy_canon,
)


def _jacobi_field(p, x, y):
    z, gx, gy = jacobi_radial_sum_der_xy(
        p['coefs'], p['ns'], p['alpha'], p['beta'], x, y,
        p['normalization_radius'])
    return add_conic_base(p['c'], p['k'], x, y, z, gx, gy)


def _jacobi_canon(p):
    _tuplify(p, 'coefs', 'ns')


_JACOBI = _model(
    name='jacobi',
    dofs=(DOF('c', tags=_C_TAGS), DOF('k', tags=('conic',)),
          DOF('coefs', vector=True, tags=('coefs',))),
    meta=('normalization_radius', 'alpha', 'beta', 'ns'),
    field=_jacobi_field,
    fz=lambda p, x, y: _base_z(
        p['c'], p['k'], x, y,
        jacobi_radial_sum(p['coefs'], p['ns'], p['alpha'], p['beta'],
                          x, y, p['normalization_radius'])),
    seed=lambda p: (p['c'], p['k'], 0.0, 0.0),
    canon=_jacobi_canon,
)


def _q2d_field(p, x, y):
    return Q2d_and_der(p['cm0'], p['ams'], p['bms'], x, y,
                       p['normalization_radius'], p['c'], p['k'],
                       dx=p['dx'], dy=p['dy'])


def _q2d_canon(p):
    p['cm0'] = tuple(p['cm0'])
    p['ams'] = tuple(map(tuple, p['ams']))
    p['bms'] = tuple(map(tuple, p['bms']))


_Q2D = _model(
    name='q2d',
    dofs=(DOF('c', tags=_C_TAGS), DOF('k', tags=('conic',))),
    meta=('normalization_radius', 'cm0', 'ams', 'bms', 'dx', 'dy'),
    field=_q2d_field,
    fz=lambda p, x, y: Q2d_sag(p['cm0'], p['ams'], p['bms'], x, y,
                               p['normalization_radius'], p['c'], p['k'],
                               dx=p['dx'], dy=p['dy']),
    seed=lambda p: (p['c'], p['k'], p['dx'], p['dy']),
    canon=_q2d_canon,
)

_TOROID = _model(
    name='toroid',
    dofs=(DOF('c_x', tags=_C_TAGS + ('radius_x',)),
          DOF('c_y', tags=_C_TAGS + ('radius_y',)),
          DOF('k_y', tags=('conic',)),
          DOF('coefs_y', vector=True, tags=('coefs',))),
    field=lambda p, x, y: sagjets.toroid_field(
        p['c_x'], p['c_y'], p['k_y'], p['coefs_y'], x, y),
    fz=lambda p, x, y: (conic_jet(p['c_x'], 0.0, x * x)[0]
                        + asphere_jet(p['c_y'], p['k_y'], p['coefs_y'],
                                      y * y)[0]),
    seed=lambda p: (0.5 * (p['c_x'] + p['c_y']), 0.0, 0.0, 0.0),
    canon=lambda p: p.update(
        coefs_y=tuple(p['coefs_y']) if p.get('coefs_y') is not None else ()),
)

_BICONIC = _model(
    name='biconic',
    dofs=(DOF('c_x', tags=_C_TAGS + ('radius_x',)),
          DOF('c_y', tags=_C_TAGS + ('radius_y',)),
          DOF('k_x', tags=('conic',)),
          DOF('k_y', tags=('conic',))),
    field=lambda p, x, y: sagjets.biconic_field(
        p['c_x'], p['c_y'], p['k_x'], p['k_y'], x, y),
    seed=lambda p: (0.5 * (p['c_x'] + p['c_y']),
                    0.5 * (p['k_x'] + p['k_y']), 0.0, 0.0),
)


# ---------------------------------------------------------------------------
# parity constructors
# ---------------------------------------------------------------------------

def Plane():
    """Flat surface z = 0."""
    return Shape(_PLANE)


def Sphere(c):
    """Sphere of curvature c."""
    return Shape(_SPHERE, c=c)


def Conic(c, k):
    """Conicoid of curvature c and conic constant k."""
    return Shape(_CONIC, c=c, k=k)


def OffAxisConic(c, k, dx=0.0, dy=0.0):
    """Off-axis section of a parent conicoid, decentered by (dx, dy)."""
    return Shape(_OFF_AXIS_CONIC, c=c, k=k, dx=dx, dy=dy)


def EvenAsphere(c, k, coefs):
    """Conic base plus even-order polynomial asphere."""
    return Shape(_EVEN_ASPHERE, c=c, k=k, coefs=coefs)


def Q2D(c, k, normalization_radius, cm0, ams, bms, dx=0.0, dy=0.0):
    """2D-Q (Forbes) freeform on a conic base."""
    return Shape(_Q2D, c=c, k=k, normalization_radius=normalization_radius,
                 cm0=cm0, ams=ams, bms=bms, dx=dx, dy=dy)


def Zernike(c, k, normalization_radius, nms, coefs, norm=True):
    """Zernike freeform departure on a conic base."""
    return Shape(_ZERNIKE, c=c, k=k,
                 normalization_radius=normalization_radius,
                 nms=nms, coefs=coefs, norm=norm)


def XY(c, k, normalization_radius, mns, coefs):
    """XY-polynomial freeform on a conic base."""
    return Shape(_XY, c=c, k=k, normalization_radius=normalization_radius,
                 mns=mns, coefs=coefs)


def Chebyshev(c, k, x_norm, y_norm, mns, coefs):
    """Chebyshev-T tensor-product freeform on a conic base."""
    return Shape(_CHEBYSHEV, c=c, k=k, x_norm=x_norm, y_norm=y_norm,
                 mns=mns, coefs=coefs)


def Jacobi(c, k, normalization_radius, alpha, beta, ns, coefs):
    """Radial Jacobi polynomial freeform on a conic base."""
    return Shape(_JACOBI, c=c, k=k,
                 normalization_radius=normalization_radius,
                 alpha=alpha, beta=beta, ns=ns, coefs=coefs)


def Toroid(c_x, c_y, k_y, coefs_y):
    """Toroid: circular x section, even-asphere y section."""
    return Shape(_TOROID, c_x=c_x, c_y=c_y, k_y=k_y, coefs_y=coefs_y)


def Biconic(c_x, c_y, k_x, k_y):
    """Biconic: independent curvatures/conics along x and y."""
    return Shape(_BICONIC, c_x=c_x, c_y=c_y, k_x=k_x, k_y=k_y)


# ---------------------------------------------------------------------------
# departure band
# ---------------------------------------------------------------------------

class DepartureBand(namedtuple(
        'DepartureBand',
        'bounded max_departure domain_radius gradient_bound lipschitz')):
    """Conic-seed departure bounds backing the first-root guarantee.

    max_departure pads the sag envelope, domain_radius records the
    characterized disk, gradient_bound feeds the monotonicity certificate,
    and lipschitz the Lipschitz-march rescue.  An unbounded band (analytic
    kind, or no characterizable conic domain) carries None in every
    numeric field and bounded=False.
    """

    __slots__ = ()

    def __new__(cls, bounded, max_departure=None, domain_radius=None,
                gradient_bound=None, lipschitz=None):
        return super().__new__(cls, bounded, max_departure, domain_radius,
                               gradient_bound, lipschitz)

    @classmethod
    def unbounded(cls):
        """A band with no finite bound (analytic shape / no conic domain)."""
        return cls(False)


def _certifiable_radius(shape, aperture):
    """Disk radius the departure band may certify, or None.

    Only a physical clip or the shape's own normalization domain counts —
    drawn extent is cosmetic and must never change intersection physics.
    Bare conic-based shapes fall back to just inside the seed conic's
    finite-sag limit when that limit exists.
    """
    R = aperture.limiting_radius()
    if R is not None:
        return R
    p = shape.params
    R = p.get('normalization_radius')
    if R is None and 'x_norm' in p:
        R = max(p['x_norm'], p['y_norm'])
    if R is not None:
        return R
    c, k = shape.seed_conic()[:2]
    cf, kf = _concrete_float(c), _concrete_float(k)
    if cf is not None and kf is not None:
        edge = (1.0 + kf) * cf * cf
        if edge > 0.0:
            return 0.999 / edge ** 0.5
    return None


def characterize_departure(shape, aperture):
    """Bound the sag's departure from its conic seed over a disk.

    Computed under ``torch.no_grad`` on detached parameters: the band is a
    certificate, not physics, so it must not leak gradients into the
    trace.  A shape whose parameters are host numbers is characterized on
    the CPU and its bounds come back as Python floats (cached by the
    surface); a shape carrying tensor parameters is characterized on their
    device and its bounds stay (detached) tensors, recomputed per trace.
    Returns an unbounded DepartureBand for kinds with no seed (analytic or
    callable shapes) or no characterizable domain.
    """
    spec = getattr(shape, 'spec', None)
    if spec is None or spec.seed is None or spec.closed is not None:
        return DepartureBand.unbounded()
    R = _certifiable_radius(shape, aperture)
    Rf = _concrete_float(R)
    if R is None or (Rf is not None and not (0.0 < Rf < float('inf'))):
        return DepartureBand.unbounded()

    dt = config.precision
    tensor_param = _carries_tensor(shape.p)
    if tensor_param is None and torch.is_tensor(R):
        tensor_param = R
    traced = tensor_param is not None
    device = tensor_param.device if traced else torch.device('cpu')

    def host(v):
        if torch.is_tensor(v):
            return v.detach().to(dt)
        return torch.as_tensor(v, dtype=dt, device=device)

    def disk_samples(radius):
        if torch.is_tensor(radius):
            axis = radius * torch.linspace(-1.0, 1.0, DEPARTURE_BAND_SAMPLES,
                                           dtype=dt, device=device)
        else:
            axis = torch.as_tensor(
                onp.linspace(-radius, radius, DEPARTURE_BAND_SAMPLES),
                dtype=dt, device=device)
        Y, X = torch.meshgrid(axis, axis, indexing='ij')
        inside = X * X + Y * Y <= radius * radius
        return X, Y, inside

    def masked_max(values, inside):
        return torch.max(torch.where(inside & torch.isfinite(values), values,
                                     -float('inf')))

    with torch.no_grad():
        params = {k: (v.detach() if torch.is_tensor(v) else v)
                  for k, v in shape.p.items()}
        c, k, dx, dy = (host(v) for v in shape.seed_conic())
        R = R.detach().to(dt) if torch.is_tensor(R) else float(host(Rf))
        # departure value and slope vs the seed conic, over the certified
        # disk; both read from the fused field so the rim ring (where the
        # slope peaks) is sampled exactly, not finite-differenced
        X, Y, inside = disk_samples(R)
        z, gx, gy = spec.field(params, X, Y)
        zc, dc = conic_jet(c, k, (X + dx) ** 2 + (Y + dy) ** 2)
        gc = 2.0 * dc
        D = masked_max(torch.abs(z - zc), inside)
        G = masked_max(torch.hypot(gx - gc * (X + dx), gy - gc * (Y + dy)),
                       inside)
        if not traced and not bool(torch.isfinite(D)):
            return DepartureBand.unbounded()
        # sag slope bound for the Lipschitz rescue, over the enlarged disk
        Xm, Ym, inside_m = disk_samples(MARCH_RADIUS_MARGIN * R)
        _, gxm, gym = spec.field(params, Xm, Ym)
        L = masked_max(torch.hypot(gxm, gym), inside_m)
        bounds = (1.1 * D, 1.1 * G, 1.1 * L)

    if not traced:
        if float(G) >= DEPARTURE_GRADIENT_WARN:
            # static message: surfaces are recompiled every design edit, so
            # a value-templated warning would defeat once-per-location dedup
            warnings.warn(
                'surface sag leaves its conic seed with slope >= 0.5, so the '
                'first-root acceptance band may contain multiple ray '
                'crossings and intersections on this surface can be '
                'ambiguous.')
        bounds = tuple(float(v) for v in bounds)
    D_, G_, L_ = bounds
    return DepartureBand(True, max_departure=D_, domain_radius=R,
                         gradient_bound=G_, lipschitz=L_)


# ---------------------------------------------------------------------------
# posed surface
# ---------------------------------------------------------------------------

class Interaction(namedtuple(
        'Interaction',
        'P S n_post opl code P0 S_loc Q_loc n_hat Sprime S_specular '
        'grating_grad')):
    """Result of one Surface.interact, including local intermediates.

    (P, S) are the global outgoing position/direction; n_post the
    following index; opl the signed incoming-segment OPL (+ grating
    phase); code the per-ray STATUS_* outcome.  The local-frame fields
    (P0, S_loc, Q_loc, n_hat, Sprime, S_specular, grating_grad) let the
    AD stacks reuse intermediate results instead of re-tracing.
    """

    __slots__ = ()

    def __new__(cls, P, S, n_post, opl, code, P0, S_loc, Q_loc, n_hat,
                Sprime, S_specular, grating_grad=None):
        return super().__new__(cls, P, S, n_post, opl, code, P0, S_loc,
                               Q_loc, n_hat, Sprime, S_specular,
                               grating_grad)


def _pose_is_device(*vals):
    """True when any pose ingredient is a tensor (or holds one)."""
    def tensorish(v):
        if torch.is_tensor(v):
            return True
        return isinstance(v, (list, tuple)) and any(map(torch.is_tensor, v))
    return any(tensorish(v) for v in vals if v is not None)


def _device_pose(P, R, tilt, decenter, tilt_radians):
    """Resolve a pose given (partly) as tensors: tensors keep their graph.

    The pose lands in ``config.precision`` on the device of its first
    tensor ingredient.
    """
    dt = config.precision
    ref = next(v for v in (P, R, decenter, tilt) if _pose_is_device(v))
    if isinstance(ref, (list, tuple)):
        ref = next(v for v in ref if torch.is_tensor(v))
    device = ref.device

    def scalar(v):
        if torch.is_tensor(v):
            return v.to(dt).reshape(())
        return torch.as_tensor(float(v), dtype=dt, device=device)

    if torch.is_tensor(P) and P.ndim == 1 and P.shape[0] == 3:
        P = P.to(dt)
    else:
        coords = [P] if not hasattr(P, '__iter__') or (
            torch.is_tensor(P) and P.ndim == 0) else list(P)
        if not 1 <= len(coords) <= 3:
            raise ValueError('P must contain one to three coordinates')
        coords = [0.0] * (3 - len(coords)) + coords
        P = torch.stack([scalar(v) for v in coords])
    if isinstance(R, (list, tuple)):
        R = make_rotation_matrix(R, dtype=dt, device=device)
    elif R is not None:
        R = torch.as_tensor(R, dtype=dt, device=device) if not torch.is_tensor(R) \
            else R.to(dt)
    if decenter is not None:
        if isinstance(decenter, (list, tuple)):
            decenter = torch.stack([scalar(v) for v in decenter])
        elif torch.is_tensor(decenter):
            decenter = decenter.to(dt)
    return apply_tilt_decenter(P, R, tilt=tilt, decenter=decenter,
                               tilt_radians=tilt_radians, dtype=dt)


def _host_pose(P, R, tilt, decenter, tilt_radians):
    """Resolve a surface pose entirely in host numpy.

    The pose is static metadata read by host planners (paraxial walks,
    launch aiming, layout plots); the trace takes a tensor copy of it
    once per device and dtype.  Differentiable construction (a pose given
    as tensors) routes through :func:`_device_pose` instead; see the
    dispatch in Surface.__init__.
    """
    dt = numpy_dtype()
    if not hasattr(P, '__iter__'):
        P = [0.0, 0.0, P]
    else:
        P = list(onp.asarray(P).ravel())
        if not 1 <= len(P) <= 3:
            raise ValueError('P must contain one to three coordinates')
        P = [0.0] * (3 - len(P)) + [float(v) for v in P]
    P = onp.asarray(P, dtype=dt)
    if type(R) in (list, tuple):
        R = make_rotation_matrix(R, host=True)
    elif R is not None:
        R = onp.asarray(R, dtype=dt)
    if decenter is not None:
        decenter = onp.asarray(decenter, dtype=dt)
        if decenter.shape != (3,):
            raise ValueError('decenter must be a length-3 vector, got '
                             f'shape {decenter.shape}')
        P = P + decenter
    if tilt is not None:
        R_tilt = make_rotation_matrix(tilt, radians=tilt_radians, host=True)
        R = R_tilt if R is None else R @ R_tilt
    return P, R


class Surface:
    """A posed optical surface with a shape and interaction mode."""

    def __init__(self, shape=None, interaction=None, pose=None, material=None,
                 aperture=None, grating=None, *, P=None, R=None, tilt=None,
                 decenter=None, tilt_radians=False, coating=None):
        """shape: Shape; interaction: 'reflect'/'refract'/'eval'/... or STYPE.

        pose: (P, R) or object with .P/.R; material required for refraction;
        aperture: None / float radius / clip callable / Aperture; grating:
        an OPLFunc phase modifier; coating: a coatings.Stack consumed by
        the physical-field tracer.
        """
        for arg, label in ((shape, 'a shape'), (interaction, 'an interaction')):
            if arg is None:
                raise TypeError(f'Surface requires {label}')
        if pose is not None:
            try:
                P, R = pose
            except (TypeError, ValueError):
                P, R = pose.P, pose.R
        if P is None:
            raise TypeError('Surface requires a pose or P')

        typ = _map_stype(interaction)
        if typ == STYPE_REFRACT and material is None:
            raise ValueError('refractive surfaces must have a material, '
                             'not None')
        if _pose_is_device(P, R, tilt, decenter):
            P, R = _device_pose(P, R, tilt, decenter, tilt_radians)
        else:
            P, R = _host_pose(P, R, tilt, decenter, tilt_radians)

        self.shape = shape
        self.typ = typ
        self.P = P
        self.R = R
        self.material = material
        self.aperture = aperture
        self.grating = grating
        self.coating = coating
        # views onto the shape object, re-exposed for trace consumers
        self.params = shape.params
        self.sag = shape.sag
        self.sag_and_normal = shape.sag_and_normal
        self._analytic_intersect = bool(getattr(shape, 'analytic_intersect',
                                                False))
        self._departure_band = None

    # the pose: assigning P or R drops the tensor copies of the old pose
    @property
    def P(self):
        """Vertex position (host numpy, or a tensor for a tensor pose)."""
        return self._P

    @P.setter
    def P(self, value):
        self._P = value
        self._pose_tensors = {}

    @property
    def R(self):
        """Global->local rotation (None for identity)."""
        return self._R

    @R.setter
    def R(self, value):
        self._R = value
        self._pose_tensors = {}

    def pose_like(self, ref):
        """(P, R) as tensors in ref's dtype and on ref's device.

        A host pose is copied once per (device, dtype) and kept; a tensor
        pose is converted on each call, so its graph stays live.
        """
        key = (ref.device, ref.dtype)
        hit = self._pose_tensors.get(key)
        if hit is not None:
            return hit
        P = (self._P.to(ref.dtype) if torch.is_tensor(self._P)
             else torch.as_tensor(onp.asarray(self._P), dtype=ref.dtype, device=ref.device))
        R = self._R
        if R is not None:
            R = (R.to(ref.dtype) if torch.is_tensor(R)
                 else torch.as_tensor(onp.asarray(R), dtype=ref.dtype, device=ref.device))
        if not (torch.is_tensor(self._P) or torch.is_tensor(self._R)):
            self._pose_tensors[key] = (P, R)
        return P, R

    # validated attributes: setters coerce, getters return the stored model
    @property
    def aperture(self):
        """Surface aperture model."""
        return self._aperture_model

    @aperture.setter
    def aperture(self, value):
        self._aperture_model = as_aperture(value)

    @property
    def grating(self):
        """Optical-path modifier on this surface, or None."""
        return self._opl_modifier

    @grating.setter
    def grating(self, value):
        if not (value is None or isinstance(value, OPLFunc)):
            raise TypeError(
                'grating must be an OPLFunc (LinearGrating, CallableOPL) '
                f'or None; got {value!r}')
        self._opl_modifier = value

    def grating_opl(self, Q_loc, wavelength):
        """OPL added by the surface modifier at local intersection points.

        Q_loc: intersection points in the surface local frame, last axis
        xyz; returns the per-ray OPL contribution, shape Q_loc.shape[:-1].
        """
        return self.grating.opl(Q_loc[..., 0], Q_loc[..., 1], wavelength)

    def departure_band(self):
        """Conic-seed departure bounds for the first-root acceptance band.

        Cached when the bounds are Python floats; recomputed per trace
        when shape parameters are tensors (a design edit changes them).
        """
        if self._departure_band is not None:
            return self._departure_band
        band = characterize_departure(self.shape, self.aperture)
        cacheable = not band.bounded or all(
            isinstance(v, float) for v in band[1:])
        if cacheable:
            self._departure_band = band
        return band

    def intersect(self, P, S, tol_sag=None, maxiter=None, forward_only=False):
        """Intersect rays with the surface shape -> (Q, n, valid).

        Closed-form kinds use their analytic intersector; conic-seeded
        kinds run seeded Newton policed by the departure band (the
        monotonicity certificate decides which rays need the Lipschitz
        first-root rescue); everything else runs plain Newton.
        """
        shape = self.shape
        if self._analytic_intersect:
            return shape.intersect(P, S)
        seed = shape.seed_conic()
        if seed is not None:
            band = self.departure_band()
            return seeded_newton_intersect(
                seed, P, S, self.sag_and_normal, tol_sag=tol_sag,
                maxiter=maxiter,
                departure=band.max_departure,
                domain_radius=band.domain_radius,
                departure_gradient=band.gradient_bound,
                sag_lipschitz=band.lipschitz,
                forward_only=forward_only)
        if maxiter is None:
            maxiter = SURFACE_INTERSECTION_DEFAULT_MAXITER
        return newton_intersect(P, S, self.sag_and_normal, tol_sag=tol_sag,
                                maxiter=maxiter)

    def _bend(self, S_loc, n_hat, n_pre, wvl, code, converged):
        """Specular redirection for this surface's interaction type."""
        if self.typ == STYPE_REFLECT:
            return reflect(S_loc, n_hat), n_pre, code
        if self.typ == STYPE_REFRACT:
            n_post = _index_value(self.material.n(wvl))
            Sprime, tir = refract_with_tir(n_pre, n_post, S_loc, n_hat)
            code = torch.where((code == STATUS_OK) & tir & converged,
                               STATUS_TIR, code)
            return Sprime, n_post, code
        return S_loc, n_pre, code

    def interact(self, P_in, S_in, n_pre, wvl, tol_sag=None,
                 first_segment=False):
        """March one bundle through this surface: intersect, clip, bend.

        Returns an Interaction with global outgoing position/direction,
        following index, signed-segment OPL, and per-ray status codes.
        """
        P_pose, R_pose = self.pose_like(P_in)
        P0, S_loc = transform_to_local_coords(P_in, P_pose, S_in, R_pose)
        forward_only = not _is_measurement_surf(self.typ) and not first_segment
        Q_loc, n_hat, converged = self.intersect(P0, S_loc, tol_sag=tol_sag,
                                                 forward_only=forward_only)

        miss = STATUS_MISS if self._analytic_intersect else STATUS_NEWTON
        code = torch.where(converged, STATUS_OK, miss).to(torch.int32)
        if self.aperture.clip is not None:
            inside = self.aperture.clips(Q_loc[..., 0], Q_loc[..., 1])
            code = torch.where(converged & ~inside, STATUS_CLIP, code)

        Sprime, n_post, code = self._bend(S_loc, n_hat, n_pre, wvl, code,
                                          converged)

        S_specular = Sprime
        opl_grating = None
        grating_grad = None
        if (self.grating is not None
                and self.typ in (STYPE_REFLECT, STYPE_REFRACT)):
            # one OPL evaluation feeds the bend, path term, and AD capture
            opl_func, gx, gy = self.grating.opl_and_gradient(
                Q_loc[..., 0], Q_loc[..., 1], wvl)
            grating_grad = (gx, gy)
            Sprime, valid_diff = self.diffract(
                Sprime, n_hat, n_post, Q_loc, wvl, grad=grating_grad)
            code = torch.where((code == STATUS_OK) & ~valid_diff,
                               STATUS_EVANESCENT, code)
            opl_grating = opl_func

        P_out, S_out = transform_to_global_coords(Q_loc, P_pose, Sprime,
                                                  R_pose)

        seg = P_out - P_in
        # seg is collinear with the unit S_in by construction (the bend
        # happens after the intersection), so the signed length is just
        # seg . S_in — identical to sign(seg.S)*|seg| but smooth at zero
        # length, where the norm form would poison the backward pass with 0/0
        opl = n_pre * torch.sum(seg * S_in, dim=-1)
        if opl_grating is not None:
            opl = opl + opl_grating
        return Interaction(P_out, S_out, n_post, opl, code,
                           P0, S_loc, Q_loc, n_hat, Sprime, S_specular,
                           grating_grad=grating_grad)

    def diffract(self, S_specular, n_hat, n_post, Q_loc, wavelength,
                 grad=None):
        """Tangential momentum kick from the surface OPL function.

        Returns (S_out, valid); evanescent orders keep the specular
        direction and are masked invalid.  Branch-free masked torch.
        """
        if self.grating is None:
            return S_specular, torch.ones(S_specular.shape[:-1], dtype=torch.bool,
                                          device=S_specular.device)
        if grad is None:
            _, gx, gy = self.grating.opl_and_gradient(
                Q_loc[..., 0], Q_loc[..., 1], wavelength)
        else:
            gx, gy = grad
        return _diffract_kernel(S_specular, n_hat, gx, gy, n_post)


__all__ = [
    'STYPE_REFLECT', 'STYPE_REFRACT', 'STYPE_EVAL', 'STYPE_OBJ', 'STYPE_IMG',
    'DOF', 'SagModel', 'SHAPE_MODELS',
    'Shape', 'CallableShape', 'Plane', 'Sphere', 'Conic', 'OffAxisConic',
    'EvenAsphere', 'Q2D', 'Zernike', 'XY', 'Chebyshev', 'Jacobi', 'Toroid',
    'Biconic', 'Surface', 'Interaction', 'DepartureBand',
    'characterize_departure',
    'DEPARTURE_BAND_SAMPLES', 'DEPARTURE_GRADIENT_WARN',
    'circular_aperture', 'annular_aperture',
    'product_rule', 'phi_conic', 'sphere_sag', 'sphere_sag_der',
    'conic_sag', 'conic_sag_der', 'even_asphere_sag',
    'even_asphere_sag_der_xy', 'Q2d_and_der', 'Q2d_sag',
    'ray_plane_intersect', 'ray_sphere_intersect', 'ray_conic_intersect',
]
