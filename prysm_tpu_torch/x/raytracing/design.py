"""Design operands and optimization problems for raytracing systems.

Counterpart of ``prysm_tpu/x/raytracing/design.py``:

* the per-merit-call cache is one tag-keyed memo table
  (:class:`_TraceCache`); launches are host arrays and traces tensors on
  ``config.device``, both keyed on the identity of the launch arrays, so
  one merit evaluation traces each bundle once;
* the three paraxial scalar operands share a :class:`_FirstOrderMerit`
  base parameterized by its ABCD evaluator;
* gradient='auto' differentiates through the trace itself: reverse mode
  (one autograd pass per operand head, grouped by launch bundle, through
  ``adjoint/tolerance_analysis.multi_objective_sensitivity``) for
  spot/boresight merits, forward mode (``wavefront_with_tangents``, one
  ``torch.func.jvp`` per seed) for the wavefront-closing merits, and only
  an operand with no differentiable head falls back to central
  differences;
* the goal factory fans operand classes over fields x wavelengths by
  probing each class's keyword support once.

Host values (operand values, residual vectors, Jacobians, seeds) are
float64 numpy, as in the JAX package; traces are read back with
``to_host``.
"""
import inspect
import math
import warnings

import numpy as np
import torch

from ..optym.least_squares import (  # NOQA: F401 - re-export for users
    DampedLeastSquares,
    DampedLeastSquaresResult,
    damped_least_squares,
)

from .launch import launch as _launch, Field, Sampling
from .spencer_and_murty import (raytrace, to_host, valid_mask,
                                _is_measurement_surf as _is_meas)
from .surfaces import _map_stype  # row-type codes for TTL bookkeeping
from .sensitivity import merit_jacobian_free as _fd_merit_grad
from .opt import rms_spot_radius, _pupil_center_chief_index
from .paraxial import (
    back_focal_length,
    effective_focal_length,
    paraxial_image_distance,
)
from . import analysis as _analysis
from ._cache import structural_key, StateCache
from ._resolve import compiled_surfaces, trace_context

_PREC = np.float64


def _opt_float(v):
    """None passes through; anything else becomes a float."""
    return None if v is None else float(v)


_DEFAULT_SAMPLING = lambda: Sampling.hex(nrings=4)  # NOQA: E731


# ---------- Trace cache ------------------------------------------------------

class _TraceCache:
    """Per-merit-call memo table for traces and their prerequisites.

    One StateCache holds every kind of entry, disambiguated by a leading
    tag; launches/traces key on array identity (id) because operand
    bundles are reused by reference within a single merit evaluation.
    """

    __slots__ = ('_sys', '_memo', '_n_traces')

    def __init__(self, system):
        self._sys = system
        self._memo = StateCache()
        self._n_traces = 0

    def context(self, wavelength=None):
        """Resolved TraceContext for one wavelength, memoized."""
        tag = ('ctx', _opt_float(wavelength))
        return self._memo.get_or_compute(
            tag, lambda: trace_context(self._sys, wavelength))

    def launch(self, field, wavelength, sampling, *, epd=None):
        """Launch bundle (P, S) for a recipe, memoized per merit call."""
        tag = ('launch',
               None if field is None else id(field),
               None if sampling is None else id(sampling),
               float(wavelength), epd)

        def build():
            fld = field if field is not None else Field()
            smp = sampling if sampling is not None else _DEFAULT_SAMPLING()
            return _launch(self._sys, fld, wavelength, smp, epd=epd)

        return self._memo.get_or_compute(tag, build)

    def trace(self, P, S, wavelength):
        """Cached raytrace of one bundle."""
        tag = ('trace', id(P), id(S), float(wavelength))

        def build():
            self._n_traces += 1
            return raytrace(compiled_surfaces(self._sys),
                            P, S, wavelength)

        return self._memo.get_or_compute(tag, build)

    def exit_pupil(self, P, S, wavelength, *, P_xp=None,
                   chief_index=None, stop_index=None, epd=None,
                   axis_point=None, axis_dir=None):
        """Exit-pupil anchor for an operand bundle, resolved once."""
        if P_xp is not None:
            return np.asarray(to_host(P_xp))
        tag = ('xp', id(P), id(S), float(wavelength), chief_index,
               stop_index, epd, structural_key(axis_point),
               structural_key(axis_dir))

        def build():
            held_stop = stop_index
            if held_stop is None:
                held_stop = getattr(self._sys, 'stop_index', None)
            chief = None
            if held_stop is None:
                # no stop: anchor the pupil on the traced chief ray
                run = self.trace(P, S, wavelength)
                ci = chief_index
                if ci is None:
                    ci = _pupil_center_chief_index(P)
                chief = (to_host(run.P[-1, ci]), to_host(run.S[-1, ci]))
            return _analysis.resolve_exit_pupil(
                self._sys, wavelength, stop_index=stop_index, epd=epd,
                chief=chief, axis_point=axis_point,
                axis_dir=axis_dir)

        return self._memo.get_or_compute(tag, build)

    @property
    def n_traces(self):
        """Count of raytrace kernel invocations (memo misses)."""
        return self._n_traces


# ---------- Operands ---------------------------------------------------------

def _kw_support(cls):
    """The constructor keywords a Merit class accepts (memoized per class)."""
    cached = getattr(cls, '_kw_support_cache', None)
    if cached is not None and cached[0] is cls:
        return cached[1]
    params = inspect.signature(cls).parameters
    var_kw = inspect.Parameter.VAR_KEYWORD
    if any(p.kind == var_kw for p in params.values()):
        support = frozenset({'field', 'wavelength', 'sampling', 'weight'})
    else:
        support = frozenset(params)
    cls._kw_support_cache = (cls, support)
    return support


def _class_accepts_kw(cls, name):
    return name in _kw_support(cls)


class Merit:
    """Target/weight plumbing shared by merit terms."""

    name = 'merit'

    def __init__(self, target=None, weight=1.0, *, min=None, max=None):
        self._target_set = target is not None
        self.target = float(target) if self._target_set else 0.0
        self.weight = float(weight)
        self.min = _opt_float(min)
        self.max = _opt_float(max)

    def _bundle(self, system, cache):
        """Resolved (P, S, wavelength) for ray merits; None otherwise."""
        return None

    def __call__(self, system, cache):
        raise NotImplementedError(
            f'{type(self).__name__} does not produce an optimizer value')

    def value(self, trace, system, wavelength):
        """Merit value from an already-traced bundle.

        Evaluates the merit's differentiable head on the trace
        histories when one exists; merits without a head raise.
        """
        head_fn = getattr(self, 'adjoint_head', None)
        if head_fn is None:
            raise NotImplementedError(
                f'{type(self).__name__} does not evaluate traced bundles')
        head = head_fn()
        with torch.no_grad():
            return float(head(*_histories(trace)))

    def seed(self, trace, system, wavelength):
        """(P_bar, S_bar, L_bar) history-shaped adjoint cotangents.

        One ``torch.autograd.grad`` of the merit's differentiable head
        over detached copies of the trace histories: any head gets exact
        seeds.  Host numpy, as the adjoint engine takes them.
        """
        head_fn = getattr(self, 'adjoint_head', None)
        if head_fn is None:
            raise NotImplementedError(
                f'{type(self).__name__} cannot seed the adjoint sweep')
        return _head_seeds(head_fn(), trace)

    def direct_gradient(self, trace, system, wavelength, seeds):
        """Optional d merit / d seed terms outside the ray-state sweep."""
        return None

    @property
    def seedable(self):
        """True when this merit can drive the adjoint sweep."""
        return (type(self).seed is not Merit.seed
                or getattr(self, 'adjoint_head', None) is not None)

    @property
    def has_value(self):
        """True when this merit provides a traced-bundle value."""
        return (type(self).value is not Merit.value
                or getattr(self, 'adjoint_head', None) is not None)


def _histories(trace, requires_grad=False):
    """(P, S, OPL) histories of a trace as detached tensors (graph leaves)."""
    return tuple(torch.as_tensor(h).detach().requires_grad_(requires_grad)
                 for h in (trace.P, trace.S, trace.OPL))


def _head_seeds(head, trace):
    """(P_bar, S_bar, L_bar) host cotangents of a scalar head of the histories."""
    leaves = _histories(trace, requires_grad=True)
    with torch.enable_grad():
        grads = torch.autograd.grad(head(*leaves), leaves, allow_unused=True)
    return tuple(np.zeros(tuple(x.shape)) if g is None else to_host(g)
                 for g, x in zip(grads, leaves))


class _RayMerit(Merit):
    """Merit over one launch recipe (field, wavelength, sampling).

    Nones resolve at call time: on-axis field, the system reference
    wavelength, and a 4-ring hex sampling.  epd overrides the launch
    pupil size.
    """

    def __init__(self, field=None, wavelength=None, sampling=None, *,
                 target=None, weight=1.0, min=None, max=None,
                 epd=None):
        super().__init__(target, weight, min=min, max=max)
        self.field, self.sampling = field, sampling
        self.wavelength = _opt_float(wavelength)
        self.epd = epd

    def _bundle(self, system, cache):
        wvl = cache.context(self.wavelength).wavelength
        P, S = cache.launch(self.field, wvl, self.sampling,
                            epd=self.epd)
        return P, S, wvl

    def _traced(self, system, cache):
        """(trace, wavelength) for this recipe, via the cache."""
        P, S, wvl = self._bundle(system, cache)
        return cache.trace(P, S, wvl), wvl


class RmsSpotRadius(_RayMerit):
    """Weighted RMS spot radius at the image plane for one recipe."""

    name = 'rms_spot_radius'

    def __call__(self, system, cache):
        trace, _ = self._traced(system, cache)
        return float(rms_spot_radius(to_host(trace.P[-1]),
                                     status=to_host(trace.status)))

    def adjoint_head(self):
        """Differentiable twin of __call__ for the adjoint engine."""
        from .adjoint.engine import RmsSpotHead
        return RmsSpotHead(reference='centroid', name=self.name)


class RayHeightAt(_RayMerit):
    """One ray's position along one axis at one surface (history row)."""

    def __init__(self, field=None, wavelength=None, sampling=None, *,
                 surface_index, axis, target=None, weight=1.0, min=None,
                 max=None, ray_index=0, epd=None):
        super().__init__(field, wavelength, sampling,
                         target=target, weight=weight, min=min, max=max,
                         epd=epd)
        self.surface_index, self.axis = int(surface_index), int(axis)
        self.ray_index = int(ray_index)

    def __call__(self, system, cache):
        trace, _ = self._traced(system, cache)
        return float(trace.P[self.surface_index, self.ray_index, self.axis])


class Boresight(_RayMerit):
    """Centroid distance from a target point at the final surface."""

    def __init__(self, field=None, wavelength=None, sampling=None, *,
                 target_xy=(0.0, 0.0), weight=1.0, min=None, max=None,
                 epd=None):
        super().__init__(field, wavelength, sampling,
                         weight=weight, min=min, max=max, epd=epd)
        tx, ty = target_xy
        self.target_xy = (float(tx), float(ty))

    def __call__(self, system, cache):
        trace, _ = self._traced(system, cache)
        landed = to_host(trace.P[-1])
        alive = valid_mask(to_host(trace.status), landed)
        pool = landed[alive, :2] if alive.any() else landed[:, :2]
        offset = pool.mean(axis=0) - np.asarray(self.target_xy)
        return float(np.hypot(offset[0], offset[1]))

    def adjoint_head(self):
        """Differentiable twin of __call__ for the adjoint engine."""
        from .adjoint.engine import BoresightHead
        return BoresightHead(target=self.target_xy, name='boresight')


class _FirstOrderMerit(Merit):
    """A paraxial ABCD scalar of the compiled system at one wavelength.

    Subclasses set ``paraxial_fn`` (a ``fn(surfaces, wvl=...)``) and the
    operand name; everything else is shared.
    """

    paraxial_fn = None

    def __init__(self, wavelength=None, target=None, weight=1.0,
                 *, min=None, max=None):
        super().__init__(target, weight, min=min, max=max)
        self.wavelength = _opt_float(wavelength)

    def __call__(self, system, cache):
        ctx = cache.context(self.wavelength)
        fn = type(self).paraxial_fn
        return float(fn(ctx.surfaces, wvl=ctx.wavelength))


class EFL(_FirstOrderMerit):
    """Effective focal length (paraxial ABCD)."""

    name = 'efl'
    paraxial_fn = staticmethod(effective_focal_length)


class BFL(_FirstOrderMerit):
    """Back focal length (last powered vertex to rear focal point)."""

    name = 'bfl'
    paraxial_fn = staticmethod(back_focal_length)


class ParaxialImageDistance(_FirstOrderMerit):
    """Signed distance from the last vertex to the paraxial image plane."""

    name = 'paraxial_image_distance'
    paraxial_fn = staticmethod(paraxial_image_distance)


class TotalTrack(Merit):
    """Sum of finite row gaps from the first non-object row (Code V TTL)."""

    name = 'total_track'

    def __init__(self, target=None, weight=1.0, *, min=None,
                 max=None):
        super().__init__(target, weight, min=min, max=max)

    def __call__(self, system, cache):
        rows = system.rows
        skip = 0
        if len(rows):
            typ = getattr(rows[0], 'typ', None)
            # the leading OBJECT row's gap is object distance, not track
            if typ is not None and _is_meas(_map_stype(typ)):
                skip = 1
        gaps = (float(getattr(row, 'thickness', 0.0)) for row in rows[skip:])
        return float(sum(g for g in gaps if math.isfinite(g)))


class Thickness(Merit):
    """One system row's axial gap, by row index (the edge guard)."""

    name = 'thickness'

    def __init__(self, surface, target=None, weight=1.0,
                 *, min=None, max=None):
        super().__init__(target, weight, min=min, max=max)
        self.surface = int(surface)

    def __call__(self, system, cache):
        row = system.rows[self.surface]
        return float(row.thickness)


class _CallableMerit(Merit):
    """Adapter giving f(system, cache) -> float the Merit protocol."""

    def __init__(self, fn, target=None, weight=1.0, *, min=None,
                 max=None):
        super().__init__(target, weight, min=min, max=max)
        self.fn = fn
        self.name = getattr(fn, '__name__', 'callable')

    def __call__(self, system, cache):
        return float(self.fn(system, cache))


class WavefrontRMS(_RayMerit):
    """RMS of OPD on the chief-ray reference sphere for one recipe."""

    name = 'rms_wfe'

    def __init__(self, field=None, wavelength=None, sampling=None, *,
                 target=None, weight=1.0, min=None, max=None,
                 chief_index=None, axis_point=None, axis_dir=None,
                 P_xp=None, epd=None, stop_index=None, reference='chief'):
        super().__init__(field, wavelength, sampling,
                         target=target, weight=weight, min=min, max=max,
                         epd=epd)
        self.chief_index, self.stop_index = chief_index, stop_index
        self.axis_point, self.axis_dir = axis_point, axis_dir
        self.P_xp = P_xp
        if reference not in ('chief', 'piston'):
            raise ValueError("reference is either 'chief' or 'piston'")
        self.reference = reference

    def _geometry(self, trace, system, wavelength, *,
                  P_xp_override=None, ctx=None):
        chief = self.chief_index
        if chief is None:
            chief = _pupil_center_chief_index(trace.P[0])
        P_xp = self.P_xp if P_xp_override is None else P_xp_override
        return _analysis.close_wavefront(
            system, trace, wavelength, chief, field=self.field,
            P_xp=P_xp, stop_index=self.stop_index, epd=self.epd,
            axis_point=self.axis_point, axis_dir=self.axis_dir, ctx=ctx)

    def _rms(self, closing):
        opd = closing.opd
        if self.reference == 'piston':
            opd = opd - opd.mean()
        return float(np.sqrt(np.mean(np.square(opd))))

    def value(self, trace, system, wavelength):
        """RMS wavefront error of an already-traced bundle.

        The tolerancing layer re-traces a frozen hand bundle and asks
        the operand to score it directly (reference parity).
        """
        return self._rms(self._geometry(trace, system, wavelength))

    def seed(self, trace, system, wavelength):
        """(P_bar, S_bar, L_bar) adjoint cotangents of the closed RMS.

        The closing is re-expressed in torch over detached copies of the
        trace histories and one ``torch.autograd.grad`` supplies exact
        seeds (host numpy).  The exit-pupil anchor stays
        LIVE when it was resolved geometrically (it is the chief ray's
        closest approach to the reference axis, a function of the chief
        final state, so its motion belongs in the cotangent); fixed and
        paraxial anchors freeze (a user P_xp is constant; a paraxial one
        depends on the surfaces, not the histories).
        """
        from .spencer_and_murty import eic_closing

        closing = self._geometry(trace, system, wavelength)
        valid = np.asarray(closing.valid)
        chief = int(closing.chief_index)
        P_xp = closing.P_xp
        xp_live_axis = None
        if getattr(closing, 'xp_mode', None) == 'geometric':
            axis_point = (np.zeros(3) if self.axis_point is None
                          else np.asarray(self.axis_point, dtype=float))
            axis_dir = (np.array([0.0, 0.0, 1.0]) if self.axis_dir is None
                        else np.asarray(self.axis_dir, dtype=float))
            axis_dir = axis_dir / np.linalg.norm(axis_dir)
            xp_live_axis = (axis_point, axis_dir)
        n_image = float(closing.n_image)
        piston = self.reference == 'piston'
        n_valid = float(valid.sum())
        field = self.field
        tilt = None
        if field is not None:
            ax, ay = field.angle_radians()
            tilt = (float(np.sin(ax)), float(np.sin(ay)))
        P_hist0 = torch.as_tensor(trace.P)
        vmask = torch.as_tensor(valid, device=P_hist0.device)

        def const(v):
            return torch.as_tensor(np.asarray(v, dtype=float),
                                   dtype=P_hist0.dtype, device=P_hist0.device)

        def rms_of(P_hist, S_hist, OPL_hist):
            C = P_hist[-1][chief]
            if P_xp is None:
                kappa = 0.0
            else:
                if xp_live_axis is not None:
                    # geometric anchor: the chief's closest approach to
                    # the axis, re-derived from the live chief state
                    a0 = const(xp_live_axis[0])
                    u = const(xp_live_axis[1])
                    d = S_hist[-1][chief]
                    sep = C - a0
                    dd = d @ d
                    b = d @ u
                    det = b * b - dd          # u is unit length
                    s_axis = (b * (d @ sep) - dd * (u @ sep)) / det
                    anchor = a0 + s_axis * u
                else:
                    anchor = const(P_xp)
                gap = anchor - C
                kappa = 1.0 / torch.sqrt(torch.sum(gap * gap))
            s, _ = eic_closing(P_hist[-1], S_hist[-1], C, kappa)
            L = OPL_hist.sum(dim=0) + n_image * s
            opd = L - L[chief]
            if tilt is not None:
                launch = P_hist[0]
                opd = opd + (tilt[0] * (launch[:, 0] - launch[chief, 0])
                             + tilt[1] * (launch[:, 1] - launch[chief, 1]))
            opd = torch.where(vmask, opd, 0.0)
            if piston:
                opd = torch.where(vmask, opd - torch.sum(opd) / n_valid, 0.0)
            return torch.sqrt(torch.sum(opd * opd) / n_valid)

        return _head_seeds(rms_of, trace)

    def __call__(self, system, cache):
        P, S, wvl = self._bundle(system, cache)
        run = cache.trace(P, S, wvl)
        ctx = cache.context(self.wavelength)
        P_xp = cache.exit_pupil(
            P, S, wvl, P_xp=self.P_xp, chief_index=self.chief_index,
            stop_index=self.stop_index, epd=self.epd,
            axis_point=self.axis_point, axis_dir=self.axis_dir)
        closing = self._geometry(run, system, wvl,
                                 P_xp_override=P_xp, ctx=ctx)
        return self._rms(closing)

    def tangent_gradient(self, system, P, S, wvl, seeds,
                         Pdot0=None, Sdot0=None):
        """d(rms_wfe)/d(seed) row via the forward-mode tangent engine.

        One jvp sweep per seed carries the closing's exit-pupil and
        curvature couplings exactly (paraxial stop motion enters through
        P_xp_dot, as in wavefront_differential's tangent path).
        Pdot0/Sdot0 add launch-recipe tangents when the bundle itself
        depends on the seeds (internal stop, F/#-derived pupil).
        """
        from ._diff_raytrace import wavefront_with_tangents
        from .wavefront_differential import _xp_z_tangents_robust

        surfaces = compiled_surfaces(system)
        P_xp = self.P_xp
        P_xp_dot = None
        ref_curv = None
        ref_curv_dot = None
        stop_index = self.stop_index
        if stop_index is None:
            stop_index = getattr(system, 'stop_index', None)
        if P_xp is None and stop_index is not None:
            P_xp, xp_mode = _analysis.resolve_exit_pupil(
                system, wvl, stop_index=self.stop_index, epd=self.epd,
                field=self.field, axis_point=self.axis_point,
                axis_dir=self.axis_dir, return_mode=True)
            if xp_mode == 'paraxial':
                xp_z_dot = _xp_z_tangents_robust(
                    surfaces, wvl, seeds, stop_index)
                if P_xp is None:
                    ref_curv = 0.0
                    ref_curv_dot = np.zeros(len(seeds), dtype=_PREC)
                else:
                    P_xp_dot = np.zeros((3, len(seeds)), dtype=_PREC)
                    P_xp_dot[2] = xp_z_dot
        opd, _, _, dW = wavefront_with_tangents(
            surfaces, P, S, wvl, seeds,
            chief_index=self.chief_index,
            axis_point=self.axis_point, axis_dir=self.axis_dir,
            P_xp=P_xp, P_xp_dot=P_xp_dot,
            reference_curvature=ref_curv,
            reference_curvature_dot=ref_curv_dot,
            field=self.field, output='length',
            Pdot0=Pdot0, Sdot0=Sdot0)
        if self.reference == 'piston':
            opd = opd - np.mean(opd)
            dW = dW - np.mean(dW, axis=0, keepdims=True)
        rms = float(np.sqrt(np.mean(opd * opd)))
        if rms == 0.0:
            return np.zeros(len(seeds), dtype=_PREC)
        return (opd @ dW) / (opd.shape[0] * rms)


class ZernikeCoefficient(_RayMerit):
    """One coefficient of a Zernike fit to the OPD for one recipe."""

    name = 'zernike_coefficient'

    def __init__(self, field=None, wavelength=None, sampling=None, *,
                 n, m, nms_basis, target=None, weight=1.0, min=None,
                 max=None, chief_index=None, axis_point=None,
                 axis_dir=None, P_xp=None, epd=None, stop_index=None,
                 normalization_radius=None, norm=True):
        super().__init__(field, wavelength, sampling,
                         target=target, weight=weight, min=min, max=max,
                         epd=epd)
        self.n, self.m = int(n), int(m)
        basis = [(int(nn), int(mm)) for nn, mm in nms_basis]
        if (self.n, self.m) not in basis:
            raise ValueError(
                f'(n, m)=({self.n}, {self.m}) must appear in nms_basis '
                f'{basis!r}; the basis sets which modes are jointly fit')
        self.nms_basis = tuple(basis)
        self._idx = basis.index((self.n, self.m))
        self.chief_index, self.stop_index = chief_index, stop_index
        self.axis_point, self.axis_dir = axis_point, axis_dir
        self.P_xp = P_xp
        self.normalization_radius = normalization_radius
        self.norm = bool(norm)

    def __call__(self, system, cache):
        P, S, wvl = self._bundle(system, cache)
        run = cache.trace(P, S, wvl)
        P_xp = cache.exit_pupil(
            P, S, wvl, P_xp=self.P_xp, chief_index=self.chief_index,
            stop_index=self.stop_index, epd=self.epd,
            axis_point=self.axis_point, axis_dir=self.axis_dir)
        opd, xp_, yp_, _ = _analysis._wavefront_from_trace(
            system, P, wvl, run, chief_index=self.chief_index,
            P_xp=P_xp, field=self.field)
        coefs, _ = _analysis.wavefront_zernike_fit(
            opd, xp_, yp_, self.nms_basis,
            normalization_radius=self.normalization_radius,
            norm=self.norm)
        return float(coefs[self._idx])


class Distortion(Merit):
    """Percent distortion at one off-axis field, vs paraxial proxy."""

    name = 'distortion'

    def __init__(self, field, wavelength=None, *, epd, target=None,
                 weight=1.0, min=None, max=None,
                 paraxial_fraction=1e-4):
        super().__init__(target, weight, min=min, max=max)
        self.field, self.epd = field, float(epd)
        self.wavelength = _opt_float(wavelength)
        self.paraxial_fraction = float(paraxial_fraction)

    def __call__(self, system, cache):
        wvl = cache.context(self.wavelength).wavelength
        out = _analysis.distortion(
            system, [self.field], wvl, epd=self.epd,
            paraxial_fraction=self.paraxial_fraction)
        return float(out.percent[0])


class FieldCurvature(Merit):
    """abs(x_fan_z - y_fan_z) at one off-axis field (parabasal foci)."""

    name = 'field_curvature'

    def __init__(self, field, wavelength=None, *, target=None,
                 weight=1.0, min=None, max=None):
        super().__init__(target, weight, min=min, max=max)
        self.field = field
        self.wavelength = _opt_float(wavelength)  # None = reference

    def __call__(self, system, cache):
        from .parabasal import parabasal_foci

        wvl = cache.context(self.wavelength).wavelength
        x_z, y_z = parabasal_foci(system, self.field, wvl)  # nan on miss
        # nan foci mean the chief failed; surface a clear error rather than
        # feeding nan residuals to the solver, where they silently stall it
        if math.isfinite(x_z) and math.isfinite(y_z):
            return float(abs(x_z - y_z))
        raise ValueError(
            'field_curvature operand: the chief ray does not trace at '
            f'field {self.field!r}, so field curvature is undefined '
            '(check the starting geometry or constrain the variables).')


# ---------- Problem ----------------------------------------------------------

def _is_system(model):
    return hasattr(model, 'to_surfaces') and hasattr(model, '_design')


def _residual_of(op, system, cache, *, weighted):
    """One operand's (optionally weighted) residual against its target."""
    r = op(system, cache) - op.target
    return op.weight * r if weighted else r


class Problem:
    """Design optimization over an OpticalSystem's free vector."""

    def __init__(self, system, operands=None, *, constraints=None,
                 gradient='fd'):
        if not _is_system(system):
            raise TypeError(
                f'{type(system).__name__} is not an OpticalSystem; Problem '
                'needs one for its DesignState free vector and experiment '
                'metadata.')
        if gradient not in ('auto', 'fd'):
            raise ValueError(
                f"{gradient!r} is not a gradient mode; use 'auto' or 'fd'")
        self.system = system
        self.design = system._design
        self.operands = [*(operands or ())]
        self.equality_constraints, self.inequality_constraints = \
            _route_constraints(constraints)
        self.gradient = gradient

    def x0(self):
        """The DesignState's current free vector."""
        return self.design.pack()

    def _set_x(self, x):
        self.design.update(x)

    def _operand_vector(self, operands, *, weighted):
        cache = _TraceCache(self.system)  # shared across this evaluation
        vec = np.asarray(
            [_residual_of(op, self.system, cache, weighted=weighted)
             for op in operands], dtype=_PREC)
        return vec, cache

    def residuals(self, x, return_cache=False):
        """Per-operand weighted residual vector."""
        self._set_x(x)
        vec, cache = self._operand_vector(self.operands, weighted=True)
        return (vec, cache) if return_cache else vec

    def equalities(self, x, return_cache=False):
        """Unweighted equality constraints: op_i - target_i == 0."""
        self._set_x(x)
        vec, cache = self._operand_vector(
            self.equality_constraints, weighted=False)
        return (vec, cache) if return_cache else vec

    def inequalities(self, x, return_cache=False):
        """Unweighted inequality constraint vector, g_i(x) >= 0.

        min-bounded terms contribute value - min; max-bounded terms
        contribute max - value.
        """
        self._set_x(x)
        cache = _TraceCache(self.system)  # one cache across the terms
        vec = np.asarray(
            [(op(self.system, cache) - bound) if kind == 'min'
             else (bound - op(self.system, cache))
             for op, kind, bound in self.inequality_constraints],
            dtype=_PREC)
        return (vec, cache) if return_cache else vec

    def solve(self, x0=None, **kwargs):
        """Constrained damped least squares; updates the lens to the result."""
        eq = _combine_constraints(
            self.equalities,
            kwargs.pop('equality_constraints', None))
        ineq = _combine_constraints(
            self.inequalities,
            kwargs.pop('inequality_constraints', None))
        result = damped_least_squares(
            self, x0=x0, equality_constraints=eq,
            inequality_constraints=ineq, **kwargs)
        self._set_x(result.x)
        if not result.success:
            warnings.warn(
                f'optimization did not converge: {result.message}; the '
                'lens was updated to the best iterate anyway',
                stacklevel=2)
        return result

    def _eval_merit(self, system):
        cache = _TraceCache(system)  # fresh per merit evaluation
        return sum(_residual_of(op, system, cache, weighted=True) ** 2
                   for op in self.operands)

    def merit(self, x):
        """Sum of squared weighted residuals (the scalar objective)."""
        self._set_x(x)
        return float(self._eval_merit(self.system))

    def jacobian(self, x, method='fd', step=1e-6):
        """Gradient of the scalar merit with respect to x (FD)."""
        self._set_x(x)
        return _fd_merit_grad(self.design,
                              lambda: self._eval_merit(self.system),
                              method='fd', step=step)

    def residual_jacobian(self, x, step=1e-6):
        """Jacobian of the weighted residual vector at x, or None.

        None when gradient='fd' — damped_least_squares then central-
        differences the residuals itself.
        """
        if self.gradient != 'auto':
            return None
        return self._auto_residual_jacobian(x, step=step)

    # gradient='auto' machinery ------------------------------------------

    def _free_seeds(self):
        """One DiffSeed per free DOF slot, in pack() order."""
        from .adjoint.seeds import seed_from_slot
        return [seed_from_slot(self.system.lens, slot, self.design,
                               name=str(slot))
                for slot in self.design.free_slots()]

    def _auto_residual_jacobian(self, x, step=1e-6):
        """Exact d(weighted residual)/dx via the differentiable engines.

        Ray operands exposing adjoint_head() are grouped by launch bundle
        and done in one reverse-mode pass per head
        (``adjoint.tolerance_analysis.multi_objective_sensitivity``);
        operands with a tangent_gradient use the forward engine; only
        operands with neither fall back to central differences.
        """
        from .adjoint.tolerance_analysis import (
            multi_objective_sensitivity)

        self._set_x(x)
        x = np.asarray(x, dtype=float)
        try:
            seeds = self._free_seeds()
        except NotImplementedError:
            # a free DOF has no seed mapping (vector shape coefficients);
            # decline so the solver central-differences, as the JAX
            # package does
            return None
        launch_dots = self._launch_tangent_table(x, step)
        J = np.zeros((len(self.operands), x.size), dtype=_PREC)

        cache = _TraceCache(self.system)  # bundles shared across operands
        reverse_groups = {}
        fd_rows = []
        for i, op in enumerate(self.operands):
            tangent_fn = getattr(op, 'tangent_gradient', None)
            if tangent_fn is not None:
                P, S, wvl = op._bundle(self.system, cache)
                Pdot0, Sdot0 = launch_dots.get(i, (None, None))
                try:
                    row = tangent_fn(self.system, np.asarray(P),
                                     np.asarray(S), wvl, seeds,
                                     Pdot0=Pdot0, Sdot0=Sdot0)
                except (ValueError, NotImplementedError):
                    fd_rows.append(i)
                else:
                    J[i] = op.weight * np.asarray(row)
                continue
            if getattr(op, 'adjoint_head', None) is None:
                fd_rows.append(i)
                continue
            P, S, wvl = op._bundle(self.system, cache)
            entry = reverse_groups.setdefault(
                (float(wvl), id(P)), (P, S, wvl, []))
            entry[3].append(i)

        for P, S, wvl, rows in reverse_groups.values():
            heads = [self.operands[i].adjoint_head() for i in rows]
            Pdot0, Sdot0 = launch_dots.get(rows[0], (None, None))
            res = multi_objective_sensitivity(
                self.system, np.asarray(P), np.asarray(S), wvl, seeds,
                heads, Pdot0=Pdot0, Sdot0=Sdot0)
            for m, i in enumerate(rows):
                J[i] = self.operands[i].weight * res.jacobian[m]

        if fd_rows:
            self._fd_fill(J, fd_rows, x, step)
        return J

    def _launch_tangent_table(self, x, step=1e-6):
        """Per-operand launch tangents (N, 3, K), central-FD of the recipe.

        When the system carries a stop/aperture spec the launch bundle
        depends on the free vector (the entrance pupil moves with
        curvatures and gaps; an F/#/NA spec rescales the pupil with
        focal length).  The recipe itself -- paraxial solves, no full
        trace -- is central-differenced once per DOF on the host, and the
        tangents ride into the jvp / autograd engines.  Recipes
        whose launch is exactly x-independent map to (None, None).
        """
        table = {}
        memo = {}
        ray_ops = [(i, op) for i, op in enumerate(self.operands)
                   if getattr(op, '_bundle', None) is not None
                   and (getattr(op, 'tangent_gradient', None) is not None
                        or getattr(op, 'adjoint_head', None) is not None)]
        if not ray_ops:
            return table
        if getattr(self.system, 'stop_index', None) is None and not ray_ops:
            return table
        try:
            for i, op in ray_ops:
                nominal = op._bundle(self.system, _TraceCache(self.system))
                if nominal is None:
                    continue
                P0 = np.asarray(nominal[0], dtype=float)
                key = (float(nominal[2]), P0.tobytes())
                if key in memo:
                    table[i] = memo[key]
                    continue
                n = x.size
                Pdot = np.zeros(P0.shape + (n,), dtype=_PREC)
                Sdot = np.zeros_like(Pdot)
                moved = False
                for k in range(n):
                    h = step * max(1.0, abs(x[k]))
                    probe = x.copy()
                    probe[k] = x[k] + h
                    self._set_x(probe)
                    hi = op._bundle(self.system, _TraceCache(self.system))
                    probe[k] = x[k] - h
                    self._set_x(probe)
                    lo = op._bundle(self.system, _TraceCache(self.system))
                    dP = (np.asarray(hi[0], dtype=float)
                          - np.asarray(lo[0], dtype=float)) / (2 * h)
                    dS = (np.asarray(hi[1], dtype=float)
                          - np.asarray(lo[1], dtype=float)) / (2 * h)
                    if dP.any() or dS.any():
                        moved = True
                        Pdot[..., k] = dP
                        Sdot[..., k] = dS
                memo[key] = (Pdot, Sdot) if moved else (None, None)
                table[i] = memo[key]
        finally:
            self._set_x(x)
        return table

    def _fd_fill(self, J, rows, x, step):
        """Central-difference the given operand rows into J in place."""
        ops = [self.operands[i] for i in rows]

        def column(xv):
            self._set_x(xv)
            vec, _ = self._operand_vector(ops, weighted=True)
            return vec

        for k in range(x.size):
            h = step * max(1.0, abs(x[k]))
            probe = x.copy()
            probe[k] = x[k] + h
            hi = column(probe)
            probe[k] = x[k] - h
            lo = column(probe)
            for m, i in enumerate(rows):
                J[i, k] = (hi[m] - lo[m]) / (2 * h)
        self._set_x(x)


# ---------- constraint routing ----------------------------------------------

def _as_operand_list(operands):
    if operands is None:
        return []
    if isinstance(operands, Merit):
        return [operands]  # a lone operand, not a sequence
    return list(operands)


def _route_constraints(cons):
    """Split constraints into equality operands and (op, kind, bound) terms.

    No bounds -> equality on the operand target; min=/max= produce
    inequality terms in the g(x) >= 0 convention; mixing target with
    bounds is an error.
    """
    eqs, ineqs = [], []
    for op in _as_operand_list(cons):
        bounds = [(kind, getattr(op, kind, None))
                  for kind in ('min', 'max')]
        bounds = [(kind, b) for kind, b in bounds if b is not None]
        if not bounds:
            eqs.append(op)
            continue
        if getattr(op, '_target_set', False) is True:
            raise ValueError(
                f'constraint {getattr(op, "name", type(op).__name__)} '
                'mixes target= with min=/max=; use target= alone for an '
                'equality or min=/max= alone for inequalities')
        ineqs.extend((op, kind, float(b)) for kind, b in bounds)
    return eqs, ineqs


def _combine_constraints(primary, extra):
    if extra is None:
        return primary
    if callable(extra):
        return primary, extra
    return (primary, *tuple(extra))


# ---------- Goal factory -----------------------------------------------------

_GOAL_OPERANDS = {
    'spot': RmsSpotRadius,
    'wavefront': WavefrontRMS,
}  # the string goals build_problem understands


def _goal_axes(system, fields, wavelengths):
    """Resolved (fields, (wavelength, weight) pairs) to fan operands over."""
    to_field = getattr(system, 'field', None)
    if fields is not None:
        flds = [to_field(f) if callable(to_field) else f for f in fields]
    else:
        flds = [*(getattr(system, 'fields', None) or ())]
    if not flds:
        flds = [None]

    if wavelengths is not None:
        spectrum = [(float(w), 1.0) for w in wavelengths]
    else:
        wvls = [float(w) for w in getattr(system, 'wavelengths', ())]
        wts = [float(w) for w in getattr(system, 'weights', ())]
        if len(wts) != len(wvls):
            wts = [1.0] * len(wvls)  # weights out of sync: flat spectrum
        spectrum = list(zip(wvls, wts))
    if not spectrum:
        spectrum = [(None, 1.0)]
    return flds, spectrum


def _operand_class_for(item):
    """Resolve one goal item to a Merit class, or None if it is already
    an operand / callable (returned as ('literal', operand))."""
    if isinstance(item, str):
        cls = _GOAL_OPERANDS.get(item)
        if cls is None:
            raise ValueError(
                f'{item!r} is not a known goal; choose from '
                f'{sorted(_GOAL_OPERANDS)}')
        return ('class', cls)
    if isinstance(item, type) and issubclass(item, Merit):
        return ('class', item)
    if isinstance(item, Merit):
        return ('literal', item)
    if callable(item):
        return ('literal', _CallableMerit(item))
    raise TypeError(
        'goal items must be a string, a Merit subclass or '
        f'instance, or a callable; got {type(item).__name__}')


def _fan_operand_class(cls, flds, spectrum, sampling):
    """Instances of cls spanning the goal axes its constructor supports."""
    support = _kw_support(cls)
    per_recipe = 'field' in support or 'sampling' in support
    out = []
    if per_recipe:
        for f in flds:
            for w, wt in spectrum:
                kw = {}
                if 'field' in support:
                    kw['field'] = f
                if 'wavelength' in support:
                    kw['wavelength'] = w
                if 'sampling' in support:
                    kw['sampling'] = sampling
                if 'weight' in support:
                    kw['weight'] = wt
                out.append(cls(**kw))
    elif 'wavelength' in support:
        for w, wt in spectrum:
            kw = {'wavelength': w}
            if 'weight' in support:
                kw['weight'] = wt
            out.append(cls(**kw))
    else:
        out.append(cls(**({'weight': 1.0} if 'weight' in support else {})))
    return out


def build_problem(system, goal='spot', *, sampling=None,
                  fields=None, wavelengths=None, constraints=None):
    """Assemble a Problem from goal items fanned over fields/wavelengths."""
    items = list(goal) if isinstance(goal, (list, tuple)) else [goal]
    flds, spectrum = _goal_axes(system, fields, wavelengths)

    ops = []
    for item in items:
        kind, resolved = _operand_class_for(item)
        if kind == 'literal':
            ops.append(resolved)
        else:
            ops.extend(_fan_operand_class(resolved, flds, spectrum, sampling))
    return Problem(system, ops,
                   constraints=constraints)


__all__ = [
    'Merit', 'RmsSpotRadius', 'RayHeightAt', 'Boresight', 'EFL', 'BFL',
    'ParaxialImageDistance', 'TotalTrack', 'Thickness', 'WavefrontRMS',
    'ZernikeCoefficient', 'Distortion', 'FieldCurvature',
    'Problem', 'build_problem',
    'DampedLeastSquares', 'DampedLeastSquaresResult',
    'damped_least_squares',
]
