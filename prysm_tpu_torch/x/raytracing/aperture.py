"""Surface apertures: clip predicates, drawn extents, substrates, rims.

Counterpart of ``prysm_tpu/x/raytracing/aperture.py``.  Only the clip
predicate participates in the trace kernel; extents, substrates, and rim
features are layout-drawing metadata consumed by the plotting and solve
layers.  Radial clips share one base (:class:`_RadialClip`) that owns the
decenter and squared-radius plumbing.
"""
import copy
from dataclasses import dataclass, field

import numpy as np
import torch


def _host_eval(fn, x, y):
    """A surface evaluation on host float64 points, read back as numpy.

    Shapes compute on tensors; the drawing helpers here hold numpy.
    """
    out = fn(torch.as_tensor(x, dtype=torch.float64),
             torch.as_tensor(y, dtype=torch.float64))
    if isinstance(out, tuple):
        return tuple(v.detach().cpu().numpy() for v in out)
    return out.detach().cpu().numpy()


class _RadialMixin:
    """Squared-radius helper shared by decenterable radial clips."""

    def _rsq(self, x, y):
        dx, dy = x - self.x0, y - self.y0
        return dx * dx + dy * dy

    def _f64(self, *names):
        for name in names:
            setattr(self, name, float(getattr(self, name)))


@dataclass(repr=False)
class CircularClip(_RadialMixin):
    """Clip predicate: pass inside a (possibly decentered) disk."""

    radius: float
    x0: float = 0.0
    y0: float = 0.0

    def __post_init__(self):
        self._f64('radius', 'x0', 'y0')

    def __call__(self, x, y):
        """True where local coordinates land inside the disk."""
        return self._rsq(x, y) <= self.radius * self.radius

    @property
    def limiting_radius(self):
        """Outermost radius passing light."""
        return self.radius

    def __repr__(self):
        return f'CircularClip(radius={self.radius:g})'


@dataclass(repr=False)
class AnnularClip(_RadialMixin):
    """Clip predicate: pass the ring, block the central disk."""

    inner_radius: float
    outer_radius: float
    x0: float = 0.0
    y0: float = 0.0

    def __post_init__(self):
        self._f64('inner_radius', 'outer_radius', 'x0', 'y0')

    def __call__(self, x, y):
        """True where local coordinates land within the clear annulus."""
        rsq = self._rsq(x, y)
        return ((rsq >= self.inner_radius * self.inner_radius)
                & (rsq <= self.outer_radius * self.outer_radius))

    @property
    def limiting_radius(self):
        """Outermost radius passing light."""
        return self.outer_radius

    def __repr__(self):
        return (f'AnnularClip(inner_radius={self.inner_radius:g}, '
                f'outer_radius={self.outer_radius:g})')


def circular_aperture(radius, x0=0.0, y0=0.0):
    """Clip predicate for a disk of the given radius."""
    return CircularClip(radius, x0=x0, y0=y0)


def annular_aperture(inner_radius, outer_radius, x0=0.0, y0=0.0):
    """Clip predicate for the ring between the two radii."""
    return AnnularClip(inner_radius, outer_radius, x0=x0, y0=y0)


@dataclass(repr=False)
class CircularExtent:
    """Circular (annular when inner_radius > 0) drawn outline."""

    outer_radius: float
    inner_radius: float = 0.0

    def __post_init__(self):
        self.outer_radius = float(self.outer_radius)
        self.inner_radius = float(self.inner_radius)

    def outline(self, points, *, center=0.0, radius=None):
        """Meridian samples and bore mask; radius overrides outer_radius."""
        span = self.outer_radius if radius is None else radius
        offsets = np.linspace(-span, span, points)
        return center + offsets, np.abs(offsets) < self.inner_radius

    def __repr__(self):
        inner = (f', inner_radius={self.inner_radius:g}'
                 if self.inner_radius else '')
        return f'CircularExtent(outer_radius={self.outer_radius:g}{inner})'


class Substrate:
    """Mirror backing drawn behind a surface's meridian.

    Subclasses define the rear face through back_sag; back_outline closes
    the optical face against it, splitting a bored back into two disjoint
    loops (reference: x/raytracing/aperture.py:120-172).  Coordinates are
    the surface's local frame (sag along local z).
    """

    def __init__(self, thickness, side='auto', bore=0.0):
        self.thickness, self.bore, self.side = float(thickness), float(bore), side

    def _resolved_side(self, sag):
        """+1 / -1 offset sign; 'auto' puts the back behind the figure."""
        side = self.side
        if isinstance(side, str):
            if side != 'auto':
                raise ValueError(f'substrate side {side!r} not understood')
            bowl = np.nanmean(np.asarray(sag) - np.asarray(sag)[len(sag) // 2])
            return -1.0 if bowl > 0 else 1.0
        if float(side) == 0.0:
            raise ValueError('a numeric substrate side must be nonzero')
        return float(np.sign(float(side)))

    def back_sag(self, surf, ploty, sag, center=0.0):
        """Rear-face local z along the sampled meridian; override."""
        raise NotImplementedError('Substrate subclasses define back_sag()')

    def back_outline(self, surf, ploty, sag, center=0.0, bore=None):
        """Closed meridional outline (zz, yy) of face + back, local frame.

        A positive bore (default the substrate's) removes |y - center| <
        bore and renders the result as two loops separated by NaN.
        """
        bore = float(bore) if bore is not None else self.bore
        ploty = np.asarray(ploty, dtype=float)
        sag = np.asarray(sag, dtype=float)
        rear = np.asarray(self.back_sag(surf, ploty, sag, center=center),
                          dtype=float)
        if bore <= 0.0:
            # reference point order (aperture.py:169-171): face bottom-to-
            # top, the top rim corner, back top-to-bottom, close at the
            # face's first point
            loop_z = np.concatenate([sag, rear[-1:], rear[::-1], sag[:1]])
            loop_y = np.concatenate([ploty, ploty[-1:], ploty[::-1],
                                     ploty[:1]])
            return loop_z, loop_y
        # bored: one closed loop per side of the bore, each NaN-terminated
        zz, yy = [], []
        for keep in (ploty >= center + bore, ploty <= center - bore):
            ok = keep & np.isfinite(sag) & np.isfinite(rear)
            if not ok.any():
                continue
            face_z, back_z, side_y = sag[ok], rear[ok], ploty[ok]
            zz += [*face_z, *back_z[::-1], face_z[0], np.nan]
            yy += [*side_y, *side_y[::-1], side_y[0], np.nan]
        return np.asarray(zz), np.asarray(yy)

    def __repr__(self):
        return f'{type(self).__name__}(thickness={self.thickness:g})'


class SurfaceSubstrate:
    """Zero-thickness backing that traces the surface profile itself."""

    bore = 0.0

    def back_outline(self, surf, ploty, sag, center=0.0, bore=None):
        """Just the optical face (no drawn back)."""
        return np.asarray(sag, dtype=float), np.asarray(ploty, dtype=float)


class ParallelSubstrate(Substrate):
    """Backing offset parallel to the surface sag."""

    def back_sag(self, surf, ploty, sag, center=0.0):
        """The optical sag, displaced by the signed thickness."""
        sag = np.asarray(sag, dtype=float)
        return sag + self._resolved_side(sag) * self.thickness


class FlatParentSubstrate(Substrate):
    """Flat backing referenced to the parent vertex."""

    def back_sag(self, surf, ploty, sag, center=0.0):
        """Flat plane through the parent vertex plus the signed thickness.

        The parent vertex plane is local z = 0 — for an off-axis segment
        the nonzero parent sag at the section center is deliberately NOT
        added, so the back face is normal to the parent axis at the
        vertex (the machinable datum), matching the reference.
        """
        sag = np.asarray(sag, dtype=float)
        back = self._resolved_side(sag) * self.thickness
        return np.full_like(sag, back)


class FlatBackSubstrate(Substrate):
    """Flat backing tangent to the surface at a reference coordinate."""

    _VERTEX_NAMES = ('vertex', 'local_vertex', 'section_vertex', 'parent',
                     'parent_vertex')

    def __init__(self, thickness, side='auto', reference='aperture',
                 bore=0.0):
        super().__init__(thickness, side=side, bore=bore)
        self.reference = reference  # 'aperture' | 'center' | vertex | number

    def _reference_coordinate(self, ploty):
        ref = self.reference
        if not isinstance(ref, str):
            return float(ref)
        ref = ref.lower()
        if ref in ('center', 'centre'):
            return float(np.nanmean(np.asarray(ploty)))
        if ref in self._VERTEX_NAMES:
            return float(0)
        if ref == 'aperture':
            return float(np.nanmax(np.abs(ploty)))
        raise ValueError(f'unknown FlatBackSubstrate reference {ref!r}')

    def back_sag(self, surf, ploty, sag, center=0.0):
        """Plane through the surface tangent at the reference coordinate.

        reference='aperture' anchors at whichever aperture edge sits
        deepest toward the substrate side, so the flat back clears the
        whole optical face of an asymmetric (off-axis) part.
        """
        sag = np.asarray(sag, dtype=float)
        ploty = np.asarray(ploty, dtype=float)
        if isinstance(self.reference, str) \
                and self.reference.lower() == 'aperture':
            ymax = float(np.nanmax(np.abs(ploty)))
            cands = np.asarray([ymax, -ymax])
            z_c = _host_eval(surf.sag, np.zeros(2), cands)
            side = float(np.sign(self._resolved_side(sag)))
            y_ref = float(cands[int(np.argmin(side * z_c))])
        else:
            y_ref = self._reference_coordinate(ploty)
        probe = np.asarray([y_ref], dtype=float)
        z, n_hat = _host_eval(surf.sag_and_normal, np.zeros_like(probe), probe)
        tangent_slope = float(-n_hat[..., 1].ravel()[0]
                              / n_hat[..., 2].ravel()[0])
        shift = self._resolved_side(sag) * self.thickness
        return (float(np.asarray(z)[0]) + tangent_slope * (ploty - y_ref)
                + shift)


@dataclass
class EdgeFeature:
    """Rim-wall cosmetic feature."""

    side: str = 'both'
    is_chamfer = False

    def applies_to(self, wall_side):
        """True when this feature cuts the given wall ('upper'/'lower')."""
        return self.side in (wall_side, 'both')

    def span(self, x0, x1, endpoint_names):
        """(start, end, depth) axial extent of the inset; override."""
        raise NotImplementedError('EdgeFeature subclasses define span()')


@dataclass
class SquareCut(EdgeFeature):
    """Square cut on the rim wall."""

    z_start: float = 0.0
    z_end: float = 0.0
    depth: float = 0.0

    def __init__(self, z_start, z_end, depth, side='both'):
        super().__init__(side=side)
        self.z_start, self.z_end, self.depth = (float(z_start), float(z_end),
                                                float(depth))

    def span(self, x0, x1, endpoint_names):
        """Fixed axial inset extent (z_start, z_end, depth)."""
        return (self.z_start, self.z_end, self.depth)


class Flat(SquareCut):
    """Flat ground on the rim wall."""


class Chamfer(SquareCut):
    """Chamfer on the rim wall."""

    is_chamfer = True


@dataclass
class Seat(EdgeFeature):
    """Mounting seat stepped a fixed width in from a named wall face."""

    face: str = ''
    width: float = 0.0
    depth: float = 0.0

    def __init__(self, face, width, depth, side='both'):
        super().__init__(side=side)
        self.face, self.width, self.depth = face, float(width), float(depth)

    def span(self, x0, x1, endpoint_names):
        """Axial inset extent measured width in from the named face."""
        face = str(self.face).lower()
        direction = float(np.sign(x1 - x0)) or 1.0
        if face == endpoint_names[0]:
            return (x0, x0 + direction * self.width, self.depth)
        if face == endpoint_names[1]:
            return (x1 - direction * self.width, x1, self.depth)
        raise ValueError('the seat face must name one of the wall endpoints')


class Aperture:
    """A surface's clip, drawn extent, oversize, substrate, rim features.

    clip: None / float (circular) / callable.  extent is a drawn outline,
    never a clip; None derives or solves from the traced footprint.
    """

    def __init__(self, clip=None, *, extent=None, oversize=1.05,
                 substrate=None, features=()):
        if isinstance(clip, (int, float)) and not isinstance(clip, bool):
            clip = circular_aperture(clip)
        self.clip, self.substrate = clip, substrate
        self.oversize, self.features = float(oversize), tuple(features)
        self._user_extent, self.extent = extent is not None, extent
        self._solved_at_version = None

    @property
    def is_auto(self):
        """True with no clip and no user extent (the solve sizes it)."""
        return self.clip is None and not self._user_extent

    def clips(self, x, y):
        """Boolean mask of rays passing the clip (scalar True for no clip)."""
        return np.bool_(True) if self.clip is None else self.clip(x, y)

    def limiting_radius(self, footprint=None):
        """The clip's radius when it exposes one, else the footprint."""
        exposed = getattr(self.clip, 'limiting_radius', None)
        return footprint if exposed is None else exposed

    def center(self):
        """Local xy center from the clip, else the surface origin."""
        return (float(getattr(self.clip, 'x0', 0.0)),
                float(getattr(self.clip, 'y0', 0.0)))

    def drawn_radius(self, footprint=None):
        """Drawn radius: the extent, else limiting_radius times oversize."""
        if self.extent is not None:
            return self.extent.outer_radius
        bound = self.limiting_radius(footprint)
        return None if bound is None else bound * self.oversize

    def solve_extent(self, footprint, version, oversize=None):
        """Write a derived circular extent from a traced footprint."""
        scale = self.oversize if oversize is None else float(oversize)
        self.extent = CircularExtent(footprint * scale)
        self._user_extent, self._solved_at_version = False, version

    def is_stale(self, version):
        """True when an auto extent predates the given lens version."""
        return self.is_auto and self._solved_at_version != version

    def copy(self):
        """A deep parameter copy; the extent solve-stamp travels with it."""
        clip, extent, substrate, features = map(
            copy.deepcopy, (self.clip, self.extent, self.substrate,
                            self.features))
        twin = Aperture(clip, extent=extent, oversize=self.oversize,
                        substrate=substrate, features=features)
        twin._user_extent = self._user_extent
        twin._solved_at_version = self._solved_at_version
        return twin

    def __deepcopy__(self, memo):
        """Deep copy preserving the solve stamp."""
        return self.copy()

    def __repr__(self):
        shown = [f'{name}={value!r}' for name, value in
                 (('clip', self.clip), ('substrate', self.substrate))
                 if value is not None]
        if self.extent is not None:
            tag = '' if self._user_extent else ' (auto)'
            shown.insert(len(shown) and 1, f'extent={self.extent!r}{tag}')
        return f"Aperture({', '.join(shown)})"


def as_aperture(value):
    """Coerce None / float / callable / Aperture into an Aperture."""
    if isinstance(value, Aperture):
        return value
    return Aperture(clip=value) if value is not None else Aperture()
