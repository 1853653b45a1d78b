"""Editable lens prescription spine: rows, layout, and the DOF registry.

Counterpart of ``prysm_tpu/x/raytracing/lensdata.py``.  This layer is
deliberately host-side (plain numpy float64): it is the *editor* that
compiles a prescription into the posed ``Surface`` list consumed by the
trace kernel.  The design:

* layout is an immutable :class:`_Pose` algebra walked by a small
  interpreter whose coordinate-break verbs live in a registry
  (``_CB_OPS``) rather than an if/elif ladder;
* shape parameter packing is a per-class memoized :class:`_ParamPlan`;
* editable numeric cells are exposed through a notifying wrapper
  (:class:`_Cells`) instead of ndarray subclassing;
* scalar DOF addressing goes through a group->reader/writer dispatch
  table (``_SLOT_RW``);
* pickup dependency ordering uses :mod:`graphlib`.

Behavioral parity targets: row/endpoint invariants, the five coordinate
break kinds (basic/dar/ret/rev/ben per ``lensdata.py:820-875`` of the
reference), mirror frame folding, pickups/solves, and slot packing order.
"""
import copy
import graphlib
import math
import numbers
import warnings
import weakref
from collections import namedtuple
from collections.abc import MutableSequence

import numpy as np
import torch

from ..materials import air, MIRROR
from .aperture import as_aperture
from .surfaces import Plane, Shape, Surface, _map_stype
from .paraxial import paraxial_image_distance
from .spencer_and_murty import (
    _is_measurement_surf, STYPE_IMG, STYPE_OBJ, STYPE_REFLECT,
    STYPE_REFRACT)

_TO_RAD = math.tau / 360.0


def _xp_for(a):
    """numpy for host scalars, torch for tensor angles.

    Keeps the rotation builders backend-pure so tilt DOFs given as
    tensors stay on the autodiff tape.
    """
    return torch if torch.is_tensor(a) else np


def _matrix3(xp, rows, like):
    """A 3x3 matrix from rows of scalars: numpy, or a stacked tensor."""
    if xp is np:
        return np.array(rows)
    return torch.stack([torch.stack([v if torch.is_tensor(v)
                                     else torch.as_tensor(v, dtype=like.dtype,
                                                          device=like.device)
                                     for v in row]) for row in rows])


def _rot_x(a):
    xp = _xp_for(a)
    c, s = xp.cos(a), xp.sin(a)
    return _matrix3(xp, [[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]], a)


def _rot_y(a):
    xp = _xp_for(a)
    c, s = xp.cos(a), xp.sin(a)
    return _matrix3(xp, [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], a)


def _rot_z(a):
    xp = _xp_for(a)
    c, s = xp.cos(a), xp.sin(a)
    return _matrix3(xp, [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], a)


def R_rh(rz, ry, rx, radians=False):
    """Right-handed ZYX rotation matrix from per-axis angles.

    Angles default to degrees.  Composition order: x-rotation outermost,
    as in the JAX package.
    """
    k = 1.0 if radians else _TO_RAD
    angles = [rz * k, ry * k, rx * k]
    ref = next((a for a in angles if torch.is_tensor(a)), None)
    if ref is not None:
        # one tensor angle puts the whole matrix on the autodiff tape
        angles = [a if torch.is_tensor(a)
                  else torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
                  for a in angles]
    rz, ry, rx = angles
    return _rot_x(rx) @ _rot_y(ry) @ _rot_z(rz)


def _fold_gamma_deg(alpha_deg, beta_deg):
    """Roll angle (deg) that keeps a BEN-folded axis level.

    zero whenever either tilt component is zero; otherwise
    ``atan2(-sin a sin b, cos a + cos b)``.
    """
    a, b = alpha_deg * _TO_RAD, beta_deg * _TO_RAD
    return np.arctan2(-np.sin(a) * np.sin(b), np.cos(a) + np.cos(b)) / _TO_RAD


# half-turn about local x: the frame fold of a normal-incidence mirror
_MIRROR_FOLD = np.diag([1.0, -1.0, -1.0])

_IDENT3 = np.eye(3)


class _Pose:
    """Immutable rigid frame: global origin + global->local rotation.

    ``R is None`` encodes the identity so compiled surfaces can skip the
    rotation entirely in the trace kernel.
    """

    __slots__ = ('o', 'R')

    def __init__(self, o=None, R=None):
        self.o = np.zeros(3) if o is None else np.asarray(o, dtype=float)
        self.R = R

    def _Rm(self):
        return _IDENT3 if self.R is None else np.asarray(self.R)

    def to_global(self, v_local):
        """Express a local-frame vector in global coordinates."""
        return self._Rm().T @ np.asarray(v_local, dtype=float)

    def slid(self, dz):
        """New pose advanced dz along the local +z axis."""
        return _Pose(self.o + self.to_global((0.0, 0.0, float(dz))), self.R)

    def shifted(self, d_local):
        """New pose displaced by a local-frame decenter vector."""
        return _Pose(self.o + self.to_global(d_local), self.R)

    def turned(self, R_local):
        """New pose with an extra rotation applied in the local frame."""
        return _Pose(self.o, np.asarray(R_local) @ self._Rm())

    def broken(self, decenter, tilt):
        """Decenter-then-tilt, the standard coordinate-break composition."""
        return self.shifted(decenter).turned(
            R_rh(tilt[0], tilt[1], tilt[2]))

    def export_R(self):
        """Rotation for a compiled Surface (None when effectively identity)."""
        if self.R is None or np.allclose(np.asarray(self.R), _IDENT3):
            return None
        return self.R


# ---------------------------------------------------------------------------
# Layout interpreter
# ---------------------------------------------------------------------------

class _LayoutWalk:
    """Mutable cursor threading a _Pose through the row list.

    Carries the one-shot state coordinate breaks can arm:

    - ``armed_pose``: a (decenter, tilt) applied to the *next surface only*
      (DAR breaks) without deflecting the running axis;
    - ``armed_fold``: a rotation consumed by the *next reflector* in place
      of the normal-incidence half-turn (BEN breaks);
    - ``bookmarks``: row index -> placed pose, for RET breaks.
    """

    def __init__(self):
        self.pose = _Pose()
        self.bookmarks = {}
        self.armed_pose = None
        self.armed_fold = None

    def place(self, row_index):
        """Pose for the surface at row_index, consuming any armed DAR pose."""
        if self.armed_pose is not None:
            dec, tlt = self.armed_pose
            self.armed_pose = None
            placed = self.pose.broken(dec, tlt)
        else:
            placed = self.pose
        self.bookmarks[row_index] = placed
        return placed

    def fold_at_mirror(self):
        """Fold the running frame at a reflecting surface."""
        if self.armed_fold is not None:
            self.pose = self.pose.turned(self.armed_fold)
            self.armed_fold = None
        else:
            self.pose = self.pose.turned(_MIRROR_FOLD)

    def advance(self, thickness):
        self.pose = self.pose.slid(thickness)


_CB_OPS = {}


def _cb_op(kind):
    def bind(fn):
        _CB_OPS[kind] = fn
        return fn
    return bind


@_cb_op('basic')
def _cb_basic(cb, walk):
    # cumulative decenter + tilt; persists for every succeeding row
    walk.pose = walk.pose.broken(cb.decenter, cb.tilt)
    walk.advance(cb.thickness)


@_cb_op('dar')
def _cb_dar(cb, walk):
    # decenter-and-return: pose only the next surface; axis undisturbed
    walk.armed_pose = (np.asarray(cb.decenter, dtype=float),
                       np.asarray(cb.tilt, dtype=float))
    walk.advance(cb.thickness)


@_cb_op('ret')
def _cb_ret(cb, walk):
    # return-to-surface: rewind to a previously placed row's frame
    if cb.ret_target is None or cb.ret_target not in walk.bookmarks:
        raise ValueError(
            f'RET break names row {cb.ret_target!r}, but no such row '
            'has been placed upstream')
    walk.pose = walk.bookmarks[cb.ret_target]
    walk.advance(cb.thickness)


@_cb_op('rev')
def _cb_rev(cb, walk):
    # inverse of a matching basic break: un-tilt first, then back out the
    # decenter expressed in the restored frame
    Rt = R_rh(cb.tilt[0], cb.tilt[1], cb.tilt[2])
    undone = walk.pose.turned(Rt.T)
    walk.pose = undone.shifted(-np.asarray(cb.decenter, dtype=float))
    walk.advance(cb.thickness)


@_cb_op('ben')
def _cb_ben(cb, walk):
    # decenter-and-bend: orient the mirror now; arm a fold (tilt re-applied
    # with the level-keeping roll) for the next reflector so the axis bends
    # by twice the tilt
    walk.pose = walk.pose.broken(cb.decenter, cb.tilt)
    gamma = _fold_gamma_deg(cb.tilt[2], cb.tilt[1])
    walk.armed_fold = R_rh(gamma, cb.tilt[1], cb.tilt[2])
    walk.advance(cb.thickness)


def _run_coordbreak(cb, walk):
    op = _CB_OPS.get(cb.kind)
    if op is None:
        raise ValueError(
            f"unknown coordinate-break kind {cb.kind!r}; expected one of "
            "'basic', 'dar', 'ret', 'rev', 'ben'")
    op(cb, walk)


def _gap_of(row):
    """Finite axial gap a row contributes (infinite conjugates walk as 0)."""
    t = float(row.thickness)
    return t if math.isfinite(t) else 0.0


# ---------------------------------------------------------------------------
# Shape parameter plans
# ---------------------------------------------------------------------------

_Field = namedtuple('_Field', ['key', 'start', 'stop', 'scalar'])

_PLAN_CACHE = {}


class _ParamPlan:
    """How one shape kind flattens to a dense DOF vector.

    Computed once per :class:`SagModel` from its self-describing ``dofs``
    tuple and memoized; vector lengths are resolved per instance at pack
    time (the plan stores which DOFs are vectors, not their lengths).
    """

    __slots__ = ('spec', 'scalar_keys', 'vector_keys', 'meta_keys')

    def __init__(self, spec):
        self.spec = spec
        # scalars first, then vector blocks, preserving the spec's order
        # within each group — the dense-vector convention of the table UI
        self.scalar_keys = tuple(d.name for d in spec.dofs if not d.vector)
        self.vector_keys = tuple(d.name for d in spec.dofs if d.vector)
        self.meta_keys = tuple(spec.meta)

    @property
    def cls(self):
        """Kind identity of this plan (the shape kind string)."""
        return self.spec.name

    def pack(self, shape_params):
        """Flatten instance params -> (values, fields list)."""
        sp = shape_params or {}
        values, fields, cursor = [], [], 0
        for key in self.scalar_keys:
            values.append(sp[key])
            fields.append(_Field(key, cursor, cursor + 1, True))
            cursor += 1
        for key in self.vector_keys:
            block = list(sp[key])
            values.extend(block)
            fields.append(_Field(key, cursor, cursor + len(block), False))
            cursor += len(block)
        return values, fields

    def rebuild(self, fields, values, meta):
        """Inverse of pack: a fresh Shape from the dense vector + meta."""
        kwargs = dict(meta)
        for f in fields:
            kwargs[f.key] = values[f.start] if f.scalar \
                else values[f.start:f.stop]
        return Shape(self.spec, kwargs)

    def category_offsets(self, fields):
        """category name -> flat offsets into the dense vector."""
        span = {f.key: range(f.start, f.stop) for f in fields}
        cats = {}
        for d in self.spec.dofs:
            for tag in d.tags:
                cats.setdefault(tag, []).extend(span[d.name])
        return cats


def _plan_for(shape):
    spec = getattr(shape, 'spec', None)
    if spec is None:
        raise TypeError(
            f'{type(shape).__name__} lacks the LensData registration '
            'surface (a SagModel spec with a self-describing DOF list); '
            'only table-kind Shapes can be packed into a DOF vector')
    plan = _PLAN_CACHE.get(spec.name)
    if plan is None:
        plan = _PLAN_CACHE.setdefault(spec.name, _ParamPlan(spec))
    return plan


# ---------------------------------------------------------------------------
# Editable cells
# ---------------------------------------------------------------------------

class _Cells:
    """Dense float vector whose writes notify the owning row.

    A composition-based stand-in for subclassing ndarray: reads behave like
    the underlying array (including ``np.asarray`` interop); every write
    funnels through ``__setitem__`` so the owner's compiled-surface cache is
    dropped.
    """

    __slots__ = ('_a', '_row')

    def __init__(self, values, row):
        self._a = np.asarray(values, dtype=np.float64).copy()
        self._row = row

    def __len__(self):
        return len(self._a)

    def __iter__(self):
        return iter(self._a)

    def __getitem__(self, item):
        return self._a[item]

    def __setitem__(self, item, value):
        self._a[item] = value
        _drop_owner_cache(self._row)

    def __array__(self, dtype=None, copy=None):
        a = self._a
        return a.astype(dtype) if dtype is not None else a.copy()

    def __repr__(self):
        return repr(self._a)

    def tolist(self):
        return self._a.tolist()


class _TattlingMap(dict):
    """dict of shape metadata whose mutations notify the owning row."""

    __slots__ = ('_row',)

    def __init__(self, data, row):
        super().__init__(data)
        self._row = row

    def _report(self):
        _drop_owner_cache(self._row)

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        self._report()

    def __delitem__(self, k):
        super().__delitem__(k)
        self._report()

    def clear(self):
        super().clear()
        self._report()

    def pop(self, *a):
        out = super().pop(*a)
        self._report()
        return out

    def popitem(self):
        out = super().popitem()
        self._report()
        return out

    def setdefault(self, k, d=None):
        if k in self:
            return self[k]
        out = super().setdefault(k, d)
        self._report()
        return out

    def update(self, *a, **kw):
        super().update(*a, **kw)
        self._report()


def _drop_owner_cache(row):
    owner = getattr(row, '_owner', None)
    if owner is not None:
        owner._invalidate()


# ---------------------------------------------------------------------------
# Row validation helpers
# ---------------------------------------------------------------------------

def _checked_material(material):
    if material is MIRROR or material is None:
        return material
    if callable(getattr(material, 'n', None)) is False:
        raise TypeError(
            f'{material!r} is not usable as a material: expected an object '
            'exposing .n(wvl_um) (a catalog glass or ConstantMaterial), '
            'None meaning air, or the MIRROR sentinel')
    return material


def _checked_interaction(typ, material):
    """Infer/validate the (interaction, material) pairing of a row."""
    if typ is None:
        typ = 'refl' if (material is MIRROR) else 'refr'
    code = _map_stype(typ)
    if code == STYPE_REFLECT:
        if material not in (None, MIRROR):
            raise ValueError(
                f'a reflective surface wants MIRROR or None as its material, not {material!r}')
    else:
        if material is MIRROR:
            raise ValueError(
                'MIRROR is only meaningful on a reflective surface')
        if code == STYPE_REFRACT and material is None:
            raise ValueError('a refractive surface needs a material')
    return typ, material


def _endpoint_position_ok(index, n_rows, mapped):
    """Raise unless a row's mapped type is legal at its position."""
    if mapped != STYPE_OBJ and index == 0:
        raise ValueError('row 0 must stay the OBJECT endpoint')
    if index == n_rows - 1 and mapped != STYPE_IMG:
        raise ValueError('the last row must stay the IMAGE endpoint')
    if 0 < index < n_rows - 1 and mapped in (STYPE_OBJ, STYPE_IMG):
        raise ValueError('OBJECT/IMAGE rows are only legal at the endpoints')


# ---------------------------------------------------------------------------
# Rows
# ---------------------------------------------------------------------------

class _Row:
    """Shared machinery of SurfaceRow / CoordBreak: edit coercion + notify.

    Subclasses declare ``_EDIT_COERCE`` (attr -> coercer taking (self,
    value)) and ``_EDIT_NOTIFY`` (attrs whose writes drop the owner's
    compiled cache).  This replaces per-class ``__setattr__`` ladders.
    """

    _EDIT_COERCE = {}
    _EDIT_NOTIFY = frozenset()

    def __setattr__(self, name, value):
        coerce = self._EDIT_COERCE.get(name)
        if coerce is not None:
            value = coerce(self, value)
        object.__setattr__(self, name, value)
        if name in self._EDIT_NOTIFY:
            _drop_owner_cache(self)

    def _detached_clone(self, attrs):
        new = object.__new__(type(self))
        object.__setattr__(new, '_owner', None)
        for k, v in attrs.items():
            object.__setattr__(new, k, v)
        return new


def _coerce_typ(row, value):
    owner = getattr(row, '_owner', None)
    if owner is not None:
        index = next(i for i, r in enumerate(owner.rows) if r is row)
        _endpoint_position_ok(index, len(owner.rows), _map_stype(value))
    return value


class SurfaceRow(_Row):
    """One sequential optical surface in a LensData prescription."""

    _EDIT_COERCE = {
        'typ': _coerce_typ,
        'params': lambda row, v: _Cells(v, row),
        'meta': lambda row, v: (v if v is None or not isinstance(v, dict)
                                else _TattlingMap(v, row)),
        'material': lambda row, v: _checked_material(v),
        'aperture': lambda row, v: as_aperture(v),
    }
    _EDIT_NOTIFY = frozenset({
        'aperture', 'coating', 'grating', 'material', 'meta',
        'params', 'thickness', 'typ',
    })

    def __init__(self, shape, *, thickness=0.0, material=None,
                 typ=None, aperture=None, grating=None, coating=None):
        typ, material = _checked_interaction(typ, material)
        object.__setattr__(self, '_owner', None)
        plan = _plan_for(shape)
        values, fields = plan.pack(shape.params)

        self.shape_kind = plan.cls
        self.plan = plan
        self.fields = fields
        self.params = values if values else np.zeros(0)
        self.meta = {key: (shape.params or {})[key]
                     for key in plan.meta_keys}
        self.categories = plan.category_offsets(fields)

        self.thickness = thickness
        self.material = material
        self.typ = typ
        self.aperture = aperture
        self.grating = grating
        self.coating = coating

    # compat: the legacy name for the field layout ({key: (start, length)})
    @property
    def key_offsets(self):
        return {f.key: (f.start, f.stop - f.start) for f in self.fields}

    @property
    def is_reflective(self):
        """True when this surface folds the layout frame."""
        return _map_stype(self.typ) == STYPE_REFLECT

    def build_shape(self):
        """Fresh Shape object reflecting the current DOF vector + meta."""
        return self.plan.rebuild(self.fields, self.params, self.meta)

    def dof_slots(self, row_index):
        """Every scalar DOF of this row as (group, row_index, offset)."""
        for off, _ in enumerate(self.params):
            yield 'shape', row_index, off
        yield 'thickness', row_index, 0

    def copy(self):
        """Detached deep-enough copy of the row."""
        new = self._detached_clone({
            'shape_kind': self.shape_kind,
            'plan': self.plan,
            'fields': list(self.fields),
            'thickness': self.thickness,
            'material': self.material,
            'typ': self.typ,
            'grating': copy.deepcopy(self.grating),
            'coating': copy.deepcopy(self.coating),
        })
        # notifying containers must re-bind to the clone
        object.__setattr__(new, 'params', _Cells(np.asarray(self.params), new))
        object.__setattr__(new, 'meta',
                           _TattlingMap(copy.deepcopy(dict(self.meta)), new))
        object.__setattr__(new, 'categories',
                           {k: list(v) for k, v in self.categories.items()})
        object.__setattr__(new, 'aperture', copy.deepcopy(self.aperture))
        return new


class CoordBreak(_Row):
    """A right-handed coordinate break row (basic/dar/ret/rev/ben)."""

    _EDIT_COERCE = {
        'decenter': lambda row, v: _Cells(v, row),
        'tilt': lambda row, v: _Cells(v, row),
    }
    _EDIT_NOTIFY = frozenset({
        'decenter', 'kind', 'ret_target', 'thickness', 'tilt',
    })

    def __init__(self, *, decenter=(0.0, 0.0, 0.0),
                 tilt=(0.0, 0.0, 0.0), kind='basic', ret_target=None,
                 thickness=0.0):
        object.__setattr__(self, '_owner', None)
        self.decenter = decenter
        self.tilt = tilt
        self.kind = kind
        self.ret_target = ret_target
        self.thickness = thickness

    def dof_slots(self, row_index):
        """Decenter, tilt, and thickness DOF slots for this break."""
        for group in ('decenter', 'tilt'):
            for off in (0, 1, 2):
                yield group, row_index, off
        yield 'thickness', row_index, 0

    def copy(self):
        """Detached copy of the coordinate break."""
        new = self._detached_clone({
            'kind': self.kind,
            'ret_target': self.ret_target,
            'thickness': self.thickness,
        })
        object.__setattr__(new, 'decenter',
                           _Cells(np.asarray(self.decenter), new))
        object.__setattr__(new, 'tilt', _Cells(np.asarray(self.tilt), new))
        return new


# ---------------------------------------------------------------------------
# Row roster
# ---------------------------------------------------------------------------

def _audit_roster(rows, owner):
    """Validate a candidate row list against the LensData invariants."""
    if len(rows) < 2:
        raise ValueError('a lens needs at least its OBJECT and IMAGE endpoint rows')
    seen = set()
    for row in rows:
        if isinstance(row, (SurfaceRow, CoordBreak)) is False:
            raise TypeError(
                f'rows must be SurfaceRow or CoordBreak, not {type(row).__name__}')
        holder = getattr(row, '_owner', None)
        if holder is not None and holder is not owner:
            raise ValueError('row already belongs to a different LensData')
        if id(row) in seen:
            raise ValueError('a row object may appear in the roster only once')
        seen.add(id(row))
    for i, row in enumerate(rows):
        if isinstance(row, SurfaceRow):
            _endpoint_position_ok(i, len(rows), _map_stype(row.typ))
        elif i in (0, len(rows) - 1):
            raise ValueError(
                'row 0 must remain the OBJECT endpoint' if i == 0
                else 'the final row must remain the IMAGE endpoint')


class ControlledRows(MutableSequence):
    """Row roster: a MutableSequence that audits every edit and
    adopts/releases row ownership."""

    def __init__(self, owner, rows):
        self._owner = owner
        self._rows = []
        self._adopt(list(rows), invalidate=False)

    def _adopt(self, rows, *, invalidate=True):
        _audit_roster(rows, self._owner)
        keep = {id(r) for r in rows}
        for row in self._rows:
            if id(row) not in keep:
                object.__setattr__(row, '_owner', None)
        for row in rows:
            object.__setattr__(row, '_owner', self._owner)
        self._rows = rows
        if invalidate:
            self._owner._invalidate()

    def _edited(self, mutate):
        candidate = list(self._rows)
        mutate(candidate)
        self._adopt(candidate)

    def __len__(self):
        return len(self._rows)

    def __getitem__(self, item):
        return self._rows[item]

    def __setitem__(self, item, value):
        def put(c):
            c[item] = list(value) if isinstance(item, slice) else value
        self._edited(put)

    def __delitem__(self, item):
        def drop(c):
            del c[item]
        self._edited(drop)

    def insert(self, index, value):
        self._edited(lambda c: c.insert(index, value))

    def __repr__(self):
        return repr(self._rows)


# ---------------------------------------------------------------------------
# Row index <-> compiled surface index
# ---------------------------------------------------------------------------

class SurfaceMap:
    """Bidirectional row-index/surface-index mapping (breaks compile away)."""

    __slots__ = ('_surf_rows', '_row_to_surf', '_n_rows')

    def __init__(self, lens):
        self._surf_rows = [r for r, row in enumerate(lens.rows)
                           if isinstance(row, SurfaceRow)]
        self._row_to_surf = {r: s for s, r in enumerate(self._surf_rows)}
        self._n_rows = len(lens.rows)

    def row_for_surface(self, surface_index):
        """LensData row index of one compiled surface."""
        return self._surf_rows[surface_index]

    def surface_for_row(self, row_index):
        """Compiled surface index of one SurfaceRow."""
        return self._row_to_surf[row_index]

    def records(self):
        """Per-row dicts: row_index, surface_index (None for breaks), and
        the Zemax-style sequential number (every row counts)."""
        return [{'row_index': r,
                 'surface_index': self._row_to_surf.get(r),
                 'zemax_surface_number': r}
                for r in range(self._n_rows)]


def lens_element_groups(surfaces, *, wvl=0.587,
                        ambient_index=1.0, index_atol=1e-9):
    """Indices of consecutive refracting surfaces forming physical elements.

    A group opens at the first surface whose following material is not
    ambient and closes when the beam re-enters ambient; singlets and
    cemented multiplets come back as tuples of compiled-surface indices.
    """
    groups, open_group = [], []
    for j, surf in enumerate(surfaces):
        if STYPE_REFRACT != surf.typ:
            if open_group:
                raise ValueError(
                    'the prescription terminates a lens group before the '
                    'beam returned to the ambient medium')
            continue
        if surf.material is None:
            raise ValueError('every refracting surface needs a material')
        n_post = float(np.asarray(surf.material.n(wvl)).reshape(-1)[0])
        open_group.append(j)
        if abs(n_post - ambient_index) <= index_atol:
            if len(open_group) >= 2:
                groups.append(tuple(open_group))
            open_group = []
    if open_group:
        raise ValueError(
            'the prescription terminates inside glass: the final lens '
            'group never returns to the ambient medium')
    return groups


# ---------------------------------------------------------------------------
# Scalar DOF addressing
# ---------------------------------------------------------------------------
# A slot is (group, row_index, offset).  Access is table-dispatched so new
# groups are one registry entry, not another if/elif arm.

_SLOT_RW = {
    'shape': (lambda row, off: row.params[off],
              lambda row, off, v: row.params.__setitem__(off, v)),
    'thickness': (lambda row, off: row.thickness,
                  lambda row, off, v: setattr(row, 'thickness', v)),
    'decenter': (lambda row, off: row.decenter[off],
                 lambda row, off, v: row.decenter.__setitem__(off, v)),
    'tilt': (lambda row, off: row.tilt[off],
             lambda row, off, v: row.tilt.__setitem__(off, v)),
}


class LensData:
    """Editable sequential optical prescription.

    Rows are SurfaceRow / CoordBreak objects; ``to_surfaces()`` compiles
    them into posed Surface objects for the trace kernel, cached until the
    next edit.  ``_version`` keys system-side derived caches.
    """

    def __init__(self):
        self._surfaces_cache = None
        self._version = 0
        self._resolving = False
        self._sys_ref = None
        self._resolve_hook = None
        head = SurfaceRow(Plane(), thickness=float('inf'), material=air,
                          typ='object')
        tail = SurfaceRow(Plane(), thickness=0.0, typ='image')
        self._rows = ControlledRows(self, (head, tail))

    # -- rows --
    @property
    def rows(self):
        """The editable row roster (endpoint invariants enforced)."""
        return self._rows

    @property
    def object_row(self):
        """The OBJECT endpoint row."""
        return self.rows[0]

    @property
    def image_row(self):
        """The IMAGE endpoint row."""
        return self.rows[-1]

    def add(self, shape, *, thickness=0.0, material=None,
            typ=None, aperture=None, grating=None, coating=None):
        """Append a surface row just before the IMAGE endpoint; returns self."""
        new_row = SurfaceRow(shape, thickness=thickness,
                             material=material, typ=typ, aperture=aperture,
                             grating=grating, coating=coating)
        self.rows.insert(len(self.rows) - 1, new_row)
        self._invalidate()
        return self

    def add_coordbreak(self, *, decenter=(0.0, 0.0, 0.0),
                       tilt=(0.0, 0.0, 0.0), kind='basic', ret_target=None,
                       thickness=0.0):
        """Append a coordinate break just before the IMAGE endpoint."""
        brk = CoordBreak(decenter=decenter, tilt=tilt, kind=kind,
                         ret_target=ret_target, thickness=thickness)
        self.rows.insert(len(self.rows) - 1, brk)
        self._invalidate()
        return self

    # -- ownership --
    @property
    def system_owner(self):
        """The attached OpticalSystem, or None."""
        ref = self._sys_ref
        return None if ref is None else ref()

    def _attach_system(self, system):
        current = self.system_owner
        if current is not None and current is not system:
            raise ValueError(
                'this lens already backs an OpticalSystem; .copy() it to build '
                'a second system')
        self._sys_ref = weakref.ref(system)

    # -- cache / version --
    def _invalidate(self):
        if self._resolving:
            return
        self._surfaces_cache = None
        self._version += 1

    # -- compilation --
    def to_surfaces(self):
        """Compile rows into posed Surface objects (cached between edits)."""
        if self._surfaces_cache is None:
            if self._resolve_hook is not None:
                self._resolve_hook()
            self._surfaces_cache = self._compile_surfaces()
        return self._surfaces_cache

    def _compile_surfaces(self):
        """Uncached compile, no dependency resolution (used by the resolver)."""
        has_breaks = any(isinstance(r, CoordBreak) for r in self.rows)
        return (self._compile_folded() if has_breaks
                else self._compile_on_axis())

    def _surface_from_row(self, row, P, R=None):
        medium = None if row.material is MIRROR else row.material
        return Surface(shape=row.build_shape(), interaction=row.typ,
                       P=P, R=R, material=medium, aperture=row.aperture,
                       grating=row.grating,
                       coating=getattr(row, 'coating', None))

    def _compile_on_axis(self):
        """Fast path for break-free systems: scalar z walk, mirrors flip
        the walk direction and surfaces keep identity rotations."""
        out = []
        z, direction = 0.0, 1.0
        for row in self.rows:
            out.append(self._surface_from_row(row, P=[0.0, 0.0, z]))
            if row.is_reflective:
                direction = -direction
            z += direction * _gap_of(row)
        return out

    def _compile_folded(self):
        """General path: interpret rows through the _LayoutWalk pose cursor."""
        out = []
        walk = _LayoutWalk()
        for idx, row in enumerate(self.rows):
            if isinstance(row, CoordBreak):
                _run_coordbreak(row, walk)
                continue
            placed = walk.place(idx)
            out.append(self._surface_from_row(
                row, P=placed.o, R=placed.export_R()))
            if row.is_reflective:
                walk.fold_at_mirror()
            walk.advance(_gap_of(row))
        return out

    @property
    def surfaces(self):
        """Compiled surface list (cache dropped whenever a row changes)."""
        return self.to_surfaces()

    def element_groups(self, *, wvl=0.587,
                       ambient_index=1.0, index_atol=1e-9):
        """Singlet/cemented groupings of the compiled surfaces."""
        return lens_element_groups(
            self.to_surfaces(), wvl=wvl, ambient_index=ambient_index,
            index_atol=index_atol)

    # -- sequence protocol: duck-type as the compiled surface list --
    def __len__(self):
        """Number of compiled surfaces."""
        return len(self.to_surfaces())

    def __iter__(self):
        """Iterate the compiled surface list."""
        return iter(self.to_surfaces())

    def __getitem__(self, item):
        """Compiled surface(s) by index."""
        return self.to_surfaces()[item]

    # -- slot addressing --
    def _all_slots(self):
        """Every scalar DOF slot, row-major."""
        return [slot for r, row in enumerate(self.rows)
                for slot in row.dof_slots(r)]

    def _slot_value(self, slot):
        group, r, off = slot
        try:
            read, _ = _SLOT_RW[group]
        except KeyError:
            raise KeyError(group) from None
        return read(self.rows[r], off)

    def _set_slot_value(self, slot, value):
        group, r, off = slot
        try:
            _, write = _SLOT_RW[group]
        except KeyError:
            raise KeyError(group) from None
        write(self.rows[r], off, value)

    def _select_rows(self, surfaces):
        """Resolve a row selector (None/'all'/slice/int/iterable) to indices."""
        n = len(self.rows)
        if surfaces is None or (isinstance(surfaces, str)
                                and surfaces == 'all'):
            return list(range(n))
        if isinstance(surfaces, slice):
            lo_, hi_, st_ = surfaces.indices(n)
            return list(range(lo_, hi_, st_))
        if isinstance(surfaces, numbers.Integral):
            surfaces = (surfaces,)
        out = []
        for sel in surfaces:
            if not isinstance(sel, numbers.Integral):
                raise TypeError('row selectors must be integers')
            idx = int(sel) + (n if int(sel) < 0 else 0)
            if not 0 <= idx < n:
                raise IndexError(f'row selector {sel} falls outside the lens')
            out.append(idx)
        return out

    def _category_slots(self, category, surfaces):
        """All slots selected by a design category over a row selector."""
        known = {'decenter', 'thickness', 'tilt'}
        for row in self.rows:
            if isinstance(row, SurfaceRow):
                known.update(row.categories)
        if category not in known:
            raise KeyError(f'{category!r} is not a known design category')
        slots = []
        for r in self._select_rows(surfaces):
            row = self.rows[r]
            if category == 'thickness':
                slots.append(('thickness', r, 0),)
            elif category in ('tilt', 'decenter'):
                if isinstance(row, CoordBreak):
                    slots.extend((category, r, off) for off in range(3))
            elif isinstance(row, SurfaceRow):
                slots.extend(('shape', r, off)
                             for off in row.categories.get(category, ()))
        if not slots:
            raise ValueError(
                f'no {category!r} DOFs exist on the selected rows')
        return slots

    # -- listings --
    def list_surfaces(self, *, stop_index=None, unit=None):
        """Lens-data-editor surface table."""
        from .listings import surface_table
        return surface_table(self, stop_index=stop_index,
                             unit=unit)

    def list_apertures(self):
        """Per-surface clear-aperture table."""
        from .listings import aperture_table
        return aperture_table(self)

    def list_decenters(self):
        """Coordinate-break decenter / tilt table."""
        from .listings import decenter_table
        return decenter_table(self)

    def copy(self):
        """A structural copy with cloned rows."""
        new = LensData()
        new._rows = ControlledRows(new, [row.copy() for row in self.rows])
        return new

    def __repr__(self):
        return f'LensData(n_rows={len(self.rows)})'


# ---------------------------------------------------------------------------
# Design state
# ---------------------------------------------------------------------------

_Edge = namedtuple('_Edge', ['target', 'source', 'scale', 'offset'])


def _ordered_edges(edges):
    """Pickup edges in dependency order; cycles are a registration error."""
    graph = {e.target: {e.source} for e in edges}
    by_target = {e.target: e for e in edges}
    try:
        order = tuple(graphlib.TopologicalSorter(graph).static_order())
    except graphlib.CycleError as err:
        cycle = ', '.join(repr(s) for s in err.args[1])
        raise ValueError(f'pickups form a dependency cycle: {cycle}') from None
    return [by_target[slot] for slot in order if slot in by_target]


def _quantity_box(nominal, lo, hi, relative, is_radius):
    """Box bounds for one DOF, expressed in the slot's native quantity.

    Radius categories are user-facing in radius but stored as curvature;
    the box is computed in radius space and pushed through the reciprocal
    (which reverses interval orientation and maps +/-inf -> 0).
    """
    if is_radius:
        if nominal == 0.0:
            if relative is not None:
                warnings.warn(
                    'a relative radius bound degenerates on a flat (c=0) '
                    'surface; it stays unbounded', stacklevel=3)
            return None
        user_nominal = 1.0 / nominal
    else:
        user_nominal = nominal

    if relative is not None:
        if user_nominal == 0.0:
            warnings.warn(
                'a relative bound around a zero nominal is degenerate; '
                'it stays unbounded', stacklevel=3)
            return None
        span = (user_nominal * (1.0 - relative),
                user_nominal * (1.0 + relative))
    else:
        span = (-np.inf if lo is None else float(lo),
                np.inf if hi is None else float(hi))

    if is_radius:
        span = (0.0 if np.isinf(span[1]) else 1.0 / span[1],
                0.0 if np.isinf(span[0]) else 1.0 / span[0])
    return (min(span), max(span))


class DesignState:
    """DOF registry for one lens: free variables, bounds, pickups, solves.

    Installed as the lens's resolve hook so dependent DOFs (pickup targets
    and the image-distance solve) are refreshed on every compile.
    """

    def __init__(self, lens):
        self.lens = lens
        self._free = set()
        self._bounds = {}
        self._edges = []          # flat pickup edges, registration order
        self._gap_solve = None  # (row_index, wavelength) or None
        self._dependent = set()
        lens._resolve_hook = self._resolve_dependencies  # compile hook

    # -- free vector --
    def free_slots(self):
        """The free slots, in lens row-major order."""
        return [s for s in self.lens._all_slots() if s in self._free]

    def pack(self):
        """Dense vector of the free DOFs' current values."""
        return np.array([float(self.lens._slot_value(s))
                         for s in self.free_slots()], dtype=np.float64)

    def scatter(self, x):
        """Push a dense free vector back into the row scalars."""
        free = self.free_slots()
        if len(x) != len(free):
            raise ValueError(f'the free vector has {len(free)} DOFs but {len(x)} values arrived')
        for slot, value in zip(free, list(x)):
            self.lens._set_slot_value(slot, float(value))

    def bounds(self):
        """(lo, hi) arrays parallel to the free vector."""
        pairs = [self._bounds.get(s, (-np.inf, np.inf))
                 for s in self.free_slots()]
        if not pairs:
            empty = np.zeros(0, dtype=np.float64)
            return empty, empty.copy()
        lo, hi = zip(*pairs)
        return (np.asarray(lo, dtype=np.float64),
                np.asarray(hi, dtype=np.float64))

    def update(self, x):
        """Scatter a free vector, refresh dependents, and invalidate."""
        self.scatter(x)
        self._resolve_dependencies()
        self.lens._invalidate()
        return self

    # -- variable selection --
    def vary(self, category, surfaces='all'):
        """Release a category of DOFs over a row selection."""
        slots = self.lens._category_slots(category, surfaces)
        if category == 'thickness':
            self._drop_solve_if_selected(slots)
        self._free.update(s for s in slots if s not in self._dependent)
        return self

    def freeze(self, category, surfaces='all'):
        """Re-fix a category of DOFs (the inverse of vary)."""
        self._free.difference_update(
            self.lens._category_slots(category, surfaces))
        return self

    def vary_all(self):
        """Free every scalar DOF that is not pickup/solve-driven."""
        self._free.update(s for s in self.lens._all_slots()
                          if s not in self._dependent)
        return self

    def freeze_all(self):
        """Fix every scalar DOF."""
        self._free.clear()
        return self

    def constrain(self, category, *,
                  lo=None, hi=None, relative=None, surfaces='all'):
        """Box bounds on a category of DOFs (radius bounds -> curvature)."""
        if lo is None and hi is None and relative is None:
            raise ValueError('constrain wants absolute lo/hi bounds or a relative span')
        is_radius = category in {'radius', 'radius_x', 'radius_y'}
        for slot in self.lens._category_slots(category, surfaces):
            box = _quantity_box(float(self.lens._slot_value(slot)),
                                lo, hi, relative, is_radius)
            if box is None:
                self._bounds.pop(slot, None)
            else:
                self._bounds[slot] = box
        return self

    # -- pickups --
    def pickup(self, category, surface, *, from_surface,
               from_category=None, scale=1.0, offset=0.0):
        """Drive DOFs from others: target = scale * source + offset."""
        from_category = from_category or category
        tgt = self.lens._category_slots(category, surface)
        src = self.lens._category_slots(from_category, from_surface)
        if not tgt or not src:
            raise ValueError(
                f'no {category!r} / {from_category!r} DOFs exist on the '
                'rows named by the pickup')
        if len(tgt) != len(src):
            raise ValueError(
                f'pickup maps {len(src)} source DOFs onto '
                f'{len(tgt)} targets; the counts must agree')
        driven = {e.target for e in self._edges}
        clash = driven.intersection(tgt)
        if clash:
            raise ValueError(
                f'{next(iter(clash))!r} is already driven by another pickup')
        if self._gap_solve is not None:
            solve_slot = 'thickness', self._gap_solve[0], 0
            if solve_slot in tgt:
                raise ValueError(
                    f'{solve_slot!r} is held by the active image-distance '
                    'solve and cannot take a pickup')
        new_edges = [_Edge(t, s, float(scale), float(offset))
                     for t, s in zip(tgt, src)]
        _ordered_edges(self._edges + new_edges)  # cycle check before commit
        self._edges.extend(new_edges)
        for t in tgt:
            self._free.discard(t)
            self._dependent.add(t)
        self.lens._invalidate()
        return self

    def pickup_expansion(self, source_slot):
        """All slot tangents that follow from one unit source tangent."""
        tangents = {source_slot: float(1)}
        for e in _ordered_edges(self._edges):
            if e.source in tangents:
                tangents[e.target] = e.scale * tangents[e.source]
        return tangents

    # -- image-distance solve --
    def solve_image_distance(self, surface=None, *, wavelength=None):
        """Hold the final gap at the paraxial image distance.

        The solved thickness is dependent (not free) until
        clear_image_distance_solve() or a vary('thickness', ...) selecting
        it.
        """
        lens = self.lens
        if surface is None:
            powered = [i for i, r in enumerate(lens.rows)
                       if isinstance(r, SurfaceRow) and
                       not _is_measurement_surf(_map_stype(r.typ))]
            if not powered:
                raise ValueError('found no powered surface ahead of the image plane')
            surface = max(powered)
        else:
            surface = lens._select_rows(surface)[0]
        if isinstance(lens.rows[surface], SurfaceRow) is False:
            raise ValueError(
                'the image-distance solve can only hold a surface row')
        slot = 'thickness', surface, 0
        if slot in {e.target for e in self._edges}:
            raise ValueError(
                f'{slot!r} is already pickup-driven and cannot also be '
                'solved')
        self._gap_solve = (surface, wavelength)
        self._free.discard(slot)
        self._dependent.add(slot)
        lens._invalidate()
        return self

    def clear_image_distance_solve(self):
        """Drop the paraxial image-distance solve if one is active."""
        if self._gap_solve is None:
            return self
        surface = self._gap_solve[0]
        slot = 'thickness', surface, 0
        self._gap_solve = None
        if slot not in {e.target for e in self._edges}:
            self._dependent.discard(slot)
        self.lens._invalidate()
        return self

    def _drop_solve_if_selected(self, slots):
        if self._gap_solve is not None:
            if ('thickness', self._gap_solve[0], 0) in slots:
                self.clear_image_distance_solve()

    # -- resolution (the lens's compile hook) --
    def _resolve_dependencies(self):
        """Apply pickups, then the image solve, without bumping the version."""
        lens = self.lens
        lens._resolving = True
        try:
            for e in _ordered_edges(self._edges):
                lens._set_slot_value(
                    e.target,
                    e.scale * float(lens._slot_value(e.source)) + e.offset)
            if self._gap_solve is not None:
                self._apply_image_solve()
        finally:
            lens._resolving = False

    def _apply_image_solve(self):
        lens = self.lens
        row_idx, wvl = self._gap_solve
        compiled = lens._compile_surfaces()
        mapping = SurfaceMap(lens)
        image_surface = mapping.surface_for_row(row_idx) + 1
        valid = (image_surface == len(compiled) - 1
                 and _map_stype(
                     lens.rows[mapping.row_for_surface(image_surface)].typ)
                 == STYPE_IMG) if image_surface < len(compiled) else False
        if not valid:
            raise ValueError(
                'the image-distance solve only applies to the gap '
                'immediately ahead of the IMAGE plane')
        pid = paraxial_image_distance(compiled[:image_surface], wvl=wvl)
        lens.rows[row_idx].thickness = pid

    def copy(self, new_lens):
        """A DesignState over new_lens with this registry cloned."""
        new = DesignState(new_lens)
        new._free = set(self._free)
        new._bounds = dict(self._bounds)
        new._edges = list(self._edges)
        new._gap_solve = self._gap_solve
        new._dependent = set(self._dependent)
        return new


__all__ = ['LensData', 'SurfaceRow', 'CoordBreak', 'DesignState',
           'SurfaceMap', 'R_rh', 'lens_element_groups']
