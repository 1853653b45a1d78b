"""Layout drawings and analysis plots for raytracing.

Counterpart of ``prysm_tpu/x/raytracing/plotting.py``: surface meridional
profiles over their drawn radii, lens-element glass outlines, mirror
substrates, stop markers, ray-path overlays, and the standard analysis
plots (spots, fans, OPD fans, field curvature, distortion, chromatic focal
shift, lateral color, full-field maps).  Drawing is host work: traces and
poses are read back with ``to_host``, and surfaces are evaluated on host
float64 points (``aperture._host_eval``).  matplotlib is imported inside
the functions that draw, so the package imports without it.
"""
import warnings

import numpy as np

from .spencer_and_murty import STYPE_REFLECT, STYPE_REFRACT, to_host
from .aperture import _host_eval
from .lensdata import lens_element_groups
from ._resolve import compiled_surfaces, resolve_wavelength
from ._trace_grid import layout_records, _resolve_fields


def share_fig_ax(fig=None, ax=None):
    """(fig, ax), creating either as needed."""
    import matplotlib.pyplot as plt
    if fig is None and ax is None:
        fig, ax = plt.subplots()
    elif ax is None:
        ax = fig.gca()
    elif fig is None:
        fig = ax.get_figure()
    return fig, ax


_AXIS_INDEX = {'x': 0, 'y': 1, 'z': 2}


def _sag(surf, x, y):
    """Surface sag at host local (x, y), read back as host float64."""
    return _host_eval(surf.sag, np.asarray(x, dtype=float), np.asarray(y, dtype=float))


def _vertex_z(surf):
    return float(to_host(surf.P)[2])


def _to_local(p, surf):
    """Host global points in the surface's local frame (subtract P, rotate by R)."""
    loc = np.asarray(p, dtype=float) - to_host(surf.P)
    if surf.R is not None:
        loc = loc @ to_host(surf.R).T
    return loc


def _axis_pair(x, y):
    try:
        return _AXIS_INDEX[x.lower()], _AXIS_INDEX[y.lower()]
    except KeyError:
        raise ValueError(f"axes must be 'x', 'y', or 'z'; got {x!r}, {y!r}")


def plot_ray_paths(result, *, x='z', y='y', lw=1, ls='-', c='r', alpha=1,
                   zorder=4, fig=None, ax=None):
    """Draw the traced ray paths of a RayTraceResult.

    A failed ray's position history keeps marching past the surface
    that killed it; the drawn path stops where the ray did.  imag > 0
    status codes (clip / no convergence) mean the ray reached surface
    status.real (1-based), so its intersection there is drawn; imag < 0
    (miss / TIR / evanescent) means it never arrived (reference
    plotting.py:75-93).  The default view is the classical ZY plot.
    """
    ix, iy = _axis_pair(x, y)
    fig, ax = share_fig_ax(fig, ax)
    P = np.array(to_host(result.P), copy=True)
    status = getattr(result, 'status', None)
    if status is not None:
        status = to_host(status)
        real = status.real.astype(int)
        imag = status.imag.astype(int)
        nhist = P.shape[0]
        last = np.where(imag == 0, nhist - 1,
                        np.where(imag > 0, real, real - 1))
        dead = np.arange(nhist)[:, None] > last[None, :]
        if dead.any():
            P[dead] = np.nan
    ax.plot(P[..., ix], P[..., iy], lw=lw, ls=ls, c=c, alpha=alpha,
            zorder=zorder)
    ax.set(xlabel=x, ylabel=y)
    return fig, ax


def _footprint_radius(surf, phist, j):
    """Max valid ray radius at surface j, in its local frame."""
    loc = _to_local(to_host(phist)[j + 1], surf)
    r = np.hypot(loc[..., 0], loc[..., 1])
    r = r[np.isfinite(r)]
    return float(r.max()) if r.size else 0.0


def _drawn_radius(surf, phist, j):
    """Drawn semi-diameter for surface j (extent, clip, or footprint)."""
    foot = None if phist is None else _footprint_radius(surf, phist, j)
    r = surf.aperture.drawn_radius(foot)
    if r is None or r == 0.0:
        r = foot or 1.0
    return float(r)


def _surface_profile_points(surf, radius, points, inner_radius=0.0):
    """Global (N, 3) meridional profile of a surface along its local y."""
    yloc = np.linspace(-radius, radius, points)
    if inner_radius > 0:
        yloc = yloc[np.abs(yloc) >= inner_radius]
    xloc = np.zeros_like(yloc)
    sag = _sag(surf, xloc, yloc)
    pts = np.stack([xloc, yloc, sag], axis=1)
    return _profile_to_global(surf, pts)


def _sag_args(coord, axis):
    """(x, y) sag arguments for a transverse coordinate on one axis."""
    zeros = np.zeros_like(np.asarray(coord, dtype=float))
    if axis == 'x':
        return np.asarray(coord, dtype=float), zeros
    return zeros, np.asarray(coord, dtype=float)


def _face_to_plot(surf, zz, tt, x_axis, y_axis, draw_axis='y'):
    """Map local (sag z, transverse t) samples to global plot coords."""
    zz = np.asarray(zz, dtype=float)
    tt = np.asarray(tt, dtype=float)
    if draw_axis == 'x':
        pts = np.stack([tt, np.zeros_like(tt), zz], axis=1)
    else:
        pts = np.stack([np.zeros_like(tt), tt, zz], axis=1)
    pts = _profile_to_global(surf, pts)
    ix, iy = _axis_pair(x_axis, y_axis)
    return pts[:, ix], pts[:, iy]


def _extent_inner(surf):
    """Central bore radius of the drawn extent (0 when none)."""
    extent = surf.aperture.extent
    return 0.0 if extent is None else float(
        getattr(extent, 'inner_radius', 0.0))


def _surface_face(surf, points, axis, *, outer_radius, inner_radius=0.0,
                  center=0.0, max_radius=None):
    """(sag, ploty, edge_sag) meridional face samples, vertex-z included.

    inner_radius NaN-masks a central bore in sag (edge_sag keeps the
    unmasked values); max_radius clamps the sag evaluation so a steep
    surface holds its rim value flat out to the drawn outer radius
    (reference plotting.py:144-165).
    """
    local = np.linspace(-outer_radius, outer_radius, points)
    ploty = center + local
    eval_local = (local if max_radius is None
                  else np.clip(local, -max_radius, max_radius))
    xpt, ypt = _sag_args(center + eval_local, axis)
    sag = _sag(surf, xpt, ypt) + _vertex_z(surf)
    edge_sag = sag.copy()
    sag[np.abs(local) < inner_radius] = np.nan
    return sag, ploty, edge_sag


def _reachable_radius(surf, radius, axis, center=0.0, samples=512):
    """Largest radius (<= radius) where the surface sag is still finite.

    Steep surfaces have no sag past their equator; the caller bridges
    the remaining annulus to the element OD with a flat edge
    (reference plotting.py:167-191).
    """
    probe = np.linspace(0.0, radius, samples)
    xpt, ypt = _sag_args(center + probe, axis)
    with np.errstate(invalid='ignore'):
        sag = _sag(surf, xpt, ypt)
    bad = ~np.isfinite(sag)
    if not bad.any():
        return radius
    first = int(np.argmax(bad))
    return float(probe[first - 1]) if first > 0 else 0.0


def _wall_step(xs, ys, px, py):
    if xs and xs[-1] == px and ys[-1] == py:
        return
    xs.append(px)
    ys.append(py)


def _rim_wall(x0, x1, outer_y, features, side, endpoint_names):
    """Rim-wall meridian from x0 to x1, inset by applicable EdgeFeatures.

    Spans are clamped to the wall extent and walked in draw order;
    square cuts/flats step down-across-up, chamfers ramp directly to
    the inset depth (reference plotting.py:450-488).
    """
    xs, ys = [x0], [outer_y]
    direction = np.sign(x1 - x0) or 1
    lo, hi = min(x0, x1), max(x0, x1)
    spans = []
    for feature in features:
        if not feature.applies_to(side):
            continue
        start, end, depth = feature.span(x0, x1, endpoint_names)
        if direction < 0:
            start, end = end, start
        start = min(max(start, lo), hi)
        end = min(max(end, lo), hi)
        if start == end:
            continue
        spans.append((start, end, depth, feature.is_chamfer))
    spans.sort(key=lambda item: direction * item[0])

    current = x0
    for start, end, depth, is_chamfer in spans:
        inset = outer_y + depth if outer_y < 0 else outer_y - depth
        if direction * (start - current) > 0:
            _wall_step(xs, ys, start, outer_y)
        if is_chamfer:
            _wall_step(xs, ys, end, inset)
        else:
            _wall_step(xs, ys, start, inset)
            _wall_step(xs, ys, end, inset)
        _wall_step(xs, ys, end, outer_y)
        current = end
    _wall_step(xs, ys, x1, outer_y)
    return xs, ys


def _footprint_extent(phist, j, axis, surf=None, center=0.0):
    """Max |transverse coordinate - center| of finite rays at surface j."""
    p = to_host(phist)[j + 1].reshape(-1, 3)
    if surf is not None:
        p = _to_local(p, surf)
    coord = p[..., 0 if axis == 'x' else 1] - center
    coord = coord[np.isfinite(coord)]
    return float(np.abs(coord).max()) if coord.size else 0.0


def _warn_unsolved_extent():
    """Warn once: an auto aperture is drawn from the per-call footprint."""
    warnings.warn(
        'drawing a surface whose auto aperture is unsolved or stale; '
        'sizing it from the per-call ray footprint.  Call '
        'sys.solve.apertures() to size and persist the drawn extents.',
        stacklevel=2)


def _version_of(system):
    """The owning LensData edit version (None for a bare list)."""
    return getattr(getattr(system, 'lens', system), '_version', None)


def _drawn_radius_versioned(surf, phist, j, axis, version, center=0.0):
    """Drawn half-diameter; a stale/unsolved auto extent warns."""
    ap = surf.aperture
    extent = ap.extent
    if extent is not None and not ap.is_stale(version):
        return float(extent.outer_radius)
    if ap.clip is not None:
        return float(ap.drawn_radius())
    _warn_unsolved_extent()
    return _footprint_extent(phist, j, axis, surf=surf, center=center)


def _stop_marks_path(surf, phist, shist, j, x, y, stem_fraction=0.2):
    """Aperture-stop T marks in global plot coordinates, or None.

    One T per clear-aperture edge on the drawn meridian: a stem from
    the edge pointing radially outward normal to the local optical
    axis, and a shorter crossbar through the edge parallel to it.  The
    local optical axis is the chief ray direction at the stop, falling
    back to the surface local z when the trace has no usable
    directions; the clear radius is the traced ray extent there
    (reference plotting.py:193-261).
    """
    axis_slot = 0 if y == 'x' else 1
    p_loc = _to_local(to_host(phist)[j + 1].reshape(-1, 3), surf)
    coord = p_loc[..., axis_slot]
    if not np.isfinite(coord).any():
        return None
    a = max(abs(np.nanmin(coord)), abs(np.nanmax(coord)))
    if not (np.isfinite(a) and a > 0):
        return None

    ix, iy = _axis_pair(x, y)
    rsq = p_loc[..., 0] ** 2 + p_loc[..., 1] ** 2
    rsq = np.where(np.isfinite(rsq), rsq, np.inf)
    chief = int(np.argmin(rsq))
    s = to_host(shist)[j + 1].reshape(-1, 3)[chief]
    t = np.asarray([s[ix], s[iy]], dtype=float)
    norm = np.hypot(t[0], t[1])
    if norm == 0 or not np.isfinite(norm):
        # fall back to the surface local z axis, expressed globally
        axis = (np.asarray([0.0, 0.0, 1.0]) if surf.R is None
                else np.asarray(to_host(surf.R), dtype=float)[2])
        t = np.asarray([axis[ix], axis[iy]], dtype=float)
        norm = np.hypot(t[0], t[1])
        if norm == 0:
            return None
    t = t / norm
    outward = np.asarray([-t[1], t[0]])

    ploty = np.asarray([-a, a])
    xpt, ypt = _sag_args(ploty, y)
    sag = _sag(surf, xpt, ypt) + _vertex_z(surf)
    ex, ey = _face_to_plot(surf, sag - _vertex_z(surf), ploty, x, y,
                           draw_axis=y)
    cx, cy = float(np.mean(ex)), float(np.mean(ey))

    stem = stem_fraction * a
    bar = 0.5 * stem
    xx, yy = [], []
    for k in range(2):
        e0, e1 = float(ex[k]), float(ey[k])
        sign = (1.0 if outward[0] * (e0 - cx) + outward[1] * (e1 - cy) >= 0
                else -1.0)
        out = sign * outward
        xx += [e0 - 0.5 * bar * t[0], e0 + 0.5 * bar * t[0], np.nan,
               e0, e0 + stem * out[0], np.nan]
        yy += [e1 - 0.5 * bar * t[1], e1 + 0.5 * bar * t[1], np.nan,
               e1, e1 + stem * out[1], np.nan]
    return xx, yy


def plot_optics(system, result=None, *, wvl=None, ambient_index=1.0,
                index_atol=1e-9, points=100, lw=1, ls='-', c='k', alpha=1,
                zorder=3, x='z', y='y', fig=None, ax=None,
                stop_index=None):
    """Draw the optics of a system as closed element outlines.

    Each surface's Aperture drives the drawing: the drawn extent sizes
    the optical face, substrates (reflective surfaces) draw the back,
    and rim features inset the element walls.  Lens elements close with
    wall segments whose OD is the largest drawn radius in the group;
    steep surfaces bridge flat from their equator to the OD (with a
    warning unless capped by their own intentional aperture).  A stop
    on a bare plane or eval surface marks each clear-aperture edge with
    a small T; the clear radius comes from the traced rays
    (reference plotting.py:495-667).
    """
    wvl = resolve_wavelength(system, wvl)
    x, y = x.lower(), y.lower()
    fig, ax = share_fig_ax(fig, ax)
    ax.set(aspect='equal')
    surfaces = compiled_surfaces(system)
    phist = None if result is None else to_host(result.P)
    shist = None if result is None else to_host(result.S)
    version = _version_of(system)
    if stop_index is None:
        stop_index = getattr(system, 'stop_index', None)

    def stop_marker(j, surf):
        if phist is None:
            return
        marks = _stop_marks_path(surf, phist, shist, j, x, y)
        if marks is not None:
            ax.plot(*marks, c=c, lw=lw, ls=ls, alpha=alpha, zorder=zorder)

    groups = lens_element_groups(surfaces, wvl=wvl,
                                 ambient_index=ambient_index,
                                 index_atol=index_atol)
    group_at = {group[0]: group for group in groups}

    j = 0
    n = len(surfaces)
    while j < n:
        surf = surfaces[j]
        if surf.typ == STYPE_REFLECT:
            radius = _drawn_radius_versioned(surf, phist, j, y, version)
            substrate = surf.aperture.substrate
            inner = _extent_inner(surf)
            sag, ploty, edge_sag = _surface_face(
                surf, points, y, outer_radius=radius, inner_radius=inner)
            if substrate is None:
                zz, tt = sag, ploty
            else:
                bore = max(inner, float(getattr(substrate, 'bore', 0.0)
                                        or 0.0))
                zz, tt = substrate.back_outline(
                    surf, ploty, sag - _vertex_z(surf), bore=bore)
                zz = np.asarray(zz, dtype=float) + _vertex_z(surf)
            xx, yy = _face_to_plot(surf, np.asarray(zz) - _vertex_z(surf),
                                   tt, x, y, draw_axis=y)
            ax.plot(xx, yy, c=c, lw=lw, ls=ls, alpha=alpha, zorder=zorder)
            j += 1
        elif surf.typ == STYPE_REFRACT:
            if j not in group_at:
                # an ambient-to-ambient dummy plane belongs to no lens
                # element; the stop draws its marks, otherwise nothing
                if j == stop_index:
                    stop_marker(j, surf)
                j += 1
                continue
            group = group_at[j]
            radii = [_drawn_radius_versioned(surfaces[si], phist, si, y,
                                             version)
                     for si in group]
            od = max(radii)

            faces = []
            for own, si in zip(radii, group):
                member = surfaces[si]
                sag_reach = _reachable_radius(member, od, y)
                # an intentionally smaller drawn extent caps the optical
                # zone silently; a surface that cannot reach the OD warns
                cap = own if own < od * (1.0 - 1e-9) else None
                draw_r = sag_reach if cap is None else min(sag_reach, cap)
                if (sag_reach < od * (1.0 - 1e-9)
                        and (cap is None or sag_reach < cap)):
                    warnings.warn(
                        f'surface {si} optical sag only spans radius '
                        f'{sag_reach:.4g}, short of the element outer '
                        f'radius {od:.4g}; drawing a flat edge from the '
                        'surface rim out to the OD', stacklevel=2)
                faces.append(_surface_face(
                    member, points, y, outer_radius=od,
                    inner_radius=_extent_inner(member),
                    max_radius=draw_r))

            sag1, ploty1, edge1 = faces[0]
            sag2, ploty2, edge2 = faces[-1]
            # rim features come from the group's first and last surfaces
            features = (list(surfaces[group[0]].aperture.features)
                        + list(surfaces[group[-1]].aperture.features))
            top_x, top_y = _rim_wall(edge1[-1], edge2[-1], od, features,
                                     'upper', ('front', 'rear'))
            bot_x, bot_y = _rim_wall(edge2[0], edge1[0], -od, features,
                                     'lower', ('rear', 'front'))
            zz = [*sag1, *top_x[1:], *sag2[::-1], *bot_x[1:]]
            tt = [*ploty1, *top_y[1:], *ploty2[::-1], *bot_y[1:]]
            for sag_m, ploty_m, _ in faces[1:-1]:
                zz.extend([np.nan, *sag_m])
                tt.extend([np.nan, *ploty_m])
            # faces carry global z already; walls are drawn in the lab
            # frame (elements with internal tilts draw per-surface)
            ix, iy = _axis_pair(x, y)
            arr = np.stack([np.zeros(len(tt)),
                            np.asarray(tt, dtype=float),
                            np.asarray(zz, dtype=float)], axis=1)
            if y == 'x':
                arr = arr[:, [1, 0, 2]]
            ax.plot(arr[:, ix], arr[:, iy], c=c, lw=lw, ls=ls,
                    alpha=alpha, zorder=zorder)
            j = group[-1] + 1
        else:
            # eval surfaces draw nothing, except stop marks
            if j == stop_index:
                stop_marker(j, surf)
            j += 1

    ax.set(xlabel=x, ylabel=y)
    return fig, ax


def layout(system, *, fields=None, wavelength=None, sampling=None,
           axis='y', colors=None, lw=1, fig=None, ax=None, **optics_kwargs):
    """2D layout: the optics plus one traced fan per field."""
    records, outline = layout_records(system, fields=fields,
                                     wavelength=wavelength,
                                     sampling=sampling, axis=axis)
    fig, ax = share_fig_ax(fig, ax)
    plot_optics(system, outline, wvl=wavelength, fig=fig, ax=ax,
                **optics_kwargs)
    if colors is None:
        import matplotlib.pyplot as plt
        cycle = plt.rcParams['axes.prop_cycle'].by_key().get(
            'color', ['r', 'g', 'b'])
        colors = [cycle[i % len(cycle)] for i in range(len(records))]
    for rec, color in zip(records, colors):
        plot_ray_paths(rec.trace, y=axis, c=color, lw=lw, fig=fig, ax=ax)
    return fig, ax


def plot_transverse_ray_aberration(phist, lw=1, ls='-', c='r', alpha=1,
                                   zorder=4, axis='y', chief_index=None,
                                   status=None, reference='chief',
                                   fig=None, ax=None):
    """Transverse ray-aberration fan plot for one traced bundle.

    Accepts a RayTraceResult (its status masks failed rays) or a bare
    position history plus an explicit ``status=``.
    """
    from .analysis import transverse_ray_aberration
    if status is None and hasattr(phist, 'status'):
        status = phist.status
    if hasattr(phist, 'P'):
        phist = phist.P
    pupil, delta = transverse_ray_aberration(
        phist, axis=axis, chief_index=chief_index, status=status,
        reference=reference)
    order = np.argsort(pupil)
    fig, ax = share_fig_ax(fig, ax)
    ax.plot(pupil[order], delta[order], lw=lw, ls=ls, c=c, alpha=alpha,
            zorder=zorder)
    ax.set(xlabel=f'pupil {axis}', ylabel=f'image Δ{axis}')
    return fig, ax


def plot_wave_aberration_fan(coord, opd, *, wavelength=None, units='waves',
                             detrend=True, lw=1, ls='-', c='b', alpha=1,
                             zorder=4, axis='y', label=None, fig=None,
                             ax=None):
    """Wavefront (OPD, microns) fan plot from pupil coordinates.

    units 'waves' divides by the (required) wavelength; 'nm' scales by
    1e3.  detrend subtracts a first-degree (piston + tilt) fit, on by
    default (reference plotting.py:791-862).
    """
    coord = to_host(coord)
    opd = to_host(opd)
    units_l = str(units).lower()
    if units_l in ('wave', 'waves'):
        if wavelength is None:
            raise ValueError('wavelength is required when units="waves"')
        opd = opd / float(wavelength)
        ylabel = 'OPD [waves]'
    elif units_l in ('nm', 'nanometer', 'nanometers'):
        opd = opd * 1e3
        ylabel = 'OPD [nm]'
    else:
        raise ValueError("units must be 'waves' or 'nm'")
    if detrend:
        finite = np.isfinite(coord) & np.isfinite(opd)
        if np.count_nonzero(finite) >= 2:
            slope, intercept = np.polyfit(coord[finite], opd[finite], 1)
            opd = opd - (slope * coord + intercept)
    order = np.argsort(coord)
    fig, ax = share_fig_ax(fig, ax)
    ax.plot(coord[order], opd[order], lw=lw, ls=ls, c=c, alpha=alpha,
            zorder=zorder, label=label)
    ax.set(xlabel=f'normalized pupil {axis}', ylabel=ylabel)
    return fig, ax


def plot_spot_diagram(phist, marker='+', c='k', alpha=1, zorder=4, s=None,
                      status=None, origin=None, fig=None, ax=None):
    """Image-plane spot diagram for one traced bundle.

    Accepts a RayTraceResult (its status masks failed rays) or a bare
    position history plus an explicit ``status=``.
    """
    from .analysis import spot_positions
    if status is None and hasattr(phist, 'status'):
        status = phist.status
    if hasattr(phist, 'P'):
        phist = phist.P
    xs, ys = spot_positions(to_host(phist)[-1], status=status,
                            origin=origin)
    fig, ax = share_fig_ax(fig, ax)
    ax.scatter(xs, ys, marker=marker, c=c, alpha=alpha, zorder=zorder, s=s)
    ax.set(xlabel='x', ylabel='y')
    ax.set_aspect('equal')
    return fig, ax


def _field_axis_values(fields):
    """Scalar field magnitudes for sweep plots (signed along y)."""
    out = []
    for f in fields:
        mag = float(np.hypot(f.hx, f.hy))
        if f.hy < 0 or (f.hy == 0 and f.hx < 0):
            mag = -mag
        out.append(mag)
    return np.asarray(out)


def plot_field_curvature(system, fields=None, wavelength=None, *,
                         samples=101, label=None, fig=None, ax=None):
    """S/T (or X/Y) parabasal focus vs field.

    ``label`` prefixes the section labels ('d' -> 'd S' / 'd T') so
    multiple wavelengths can share one axes.
    """
    from .analysis import field_curvature
    r = field_curvature(system, fields, wavelength, samples=samples)
    h = _field_axis_values(r.fields)
    prefix = '' if label is None else f'{label} '
    fig, ax = share_fig_ax(fig, ax)
    ax.plot(to_host(r.x_fan_z) - r.image_z, h, label=f'{prefix}{r.labels[0]}')
    ax.plot(to_host(r.y_fan_z) - r.image_z, h, ls='--',
            label=f'{prefix}{r.labels[1]}')
    ax.legend()
    ax.set(xlabel=f'focus shift [{r.unit}]', ylabel='field')
    return fig, ax


def plot_distortion(system, fields=None, wavelength=None, *, epd=None,
                    samples=101, distortion_type='f-tan', fig=None, ax=None):
    """Percent distortion vs field."""
    from .analysis import distortion
    r = distortion(system, fields, wavelength, epd=epd, samples=samples,
                   distortion_type=distortion_type)
    h = _field_axis_values(r.fields)
    fig, ax = share_fig_ax(fig, ax)
    ax.plot(to_host(r.percent), h)
    ax.set(xlabel='distortion [%]', ylabel='field')
    return fig, ax


def plot_chromatic_focal_shift(system, wavelengths=None, *, samples=101,
                               focus='best', epd=None, label=None,
                               fig=None, ax=None):
    """Focus shift vs wavelength."""
    from .analysis import chromatic_focal_shift
    w, shift = chromatic_focal_shift(system, wavelengths, samples=samples,
                                     focus=focus, epd=epd)
    fig, ax = share_fig_ax(fig, ax)
    ax.plot(to_host(w), to_host(shift), label=label)
    ax.set(xlabel='wavelength [um]', ylabel='focus shift')
    return fig, ax


def plot_lateral_color(system, fields=None, wavelengths=None, *, epd=None,
                       samples=101, fig=None, ax=None):
    """Chief-ray lateral color vs field, referenced to the first column."""
    from .analysis import lateral_color
    from ._trace_grid import _resolve_wavelengths, field_sweep
    fields = field_sweep(system, fields, samples)
    wvls = _resolve_wavelengths(system, wavelengths)
    landing = to_host(lateral_color(system, fields, wvls, epd=epd))
    h = _field_axis_values(fields)
    fig, ax = share_fig_ax(fig, ax)
    # one curve per non-reference wavelength; the reference column is the
    # zero of the differences and would plot as a flat line
    ref = int(getattr(system, 'reference', 0) or 0)
    if not 0 <= ref < len(wvls):
        ref = 0
    for j, w in enumerate(wvls):
        if j == ref:
            continue
        dy = landing[:, j, 1] - landing[:, ref, 1]
        ax.plot(dy, h, label=f'{w:.4g} um')
    ax.legend()
    ax.set(xlabel='lateral shift', ylabel='field')
    return fig, ax


def plot_full_field(grid, *, cmap='viridis', clim=None, colorbar=True,
                    fig=None, ax=None):
    """Render a FullFieldGrid metric map."""
    fig, ax = share_fig_ax(fig, ax)
    im = ax.pcolormesh(to_host(grid.hx), to_host(grid.hy),
                       to_host(grid.data), cmap=cmap, shading='auto')
    if clim is not None:
        im.set_clim(*clim)
    if colorbar:
        fig.colorbar(im, ax=ax, label=f'{grid.metric} [{grid.data_unit}]')
    ax.set(xlabel=f'field x [{grid.unit}]', ylabel=f'field y [{grid.unit}]')
    ax.set_aspect('equal')
    return fig, ax


def _wavelength_colors(nw, colors):
    if colors is not None:
        return list(colors)
    import matplotlib.pyplot as plt
    cycle = plt.rcParams['axes.prop_cycle'].by_key().get(
        'color', ['b', 'g', 'r'])
    return [cycle[j % len(cycle)] for j in range(nw)]


def _plot_fan_grid(grid, value_label, *, axes='both', colors=None,
                   sharey='row', figsize=None):
    """Shared renderer for RayFanGrid / OPDFanGrid."""
    import matplotlib.pyplot as plt
    nf = len(grid.fields)
    ncols = 2 if axes == 'both' else 1
    fig, axs = plt.subplots(nf, ncols, sharey=sharey, figsize=figsize,
                            squeeze=False)
    colors = _wavelength_colors(len(grid.wavelengths), colors)
    panels = (('y', 'x') if axes == 'both'
              else (axes,))
    for i in range(nf):
        for kcol, which in enumerate(panels):
            ax = axs[i][kcol]
            pupil = to_host(grid.pupil_y[i] if which == 'y' else grid.pupil_x[i])
            data = to_host(grid.y[i] if which == 'y' else grid.x[i])
            for j, w in enumerate(grid.wavelengths):
                order = np.argsort(pupil)
                ax.plot(pupil[order], data[j][order], c=colors[j],
                        label=f'{w:.4g} um' if i == 0 else None)
            ax.set(xlabel=f'pupil {which}',
                   ylabel=value_label if kcol == 0 else None)
    axs[0][0].legend(fontsize='small')
    return fig, axs


def plot_ray_fans(fan_grid, *, axes='both', colors=None, sharey='row',
                  figsize=None):
    """Grid of transverse ray-aberration fans (RayFanGrid)."""
    return _plot_fan_grid(fan_grid, f'Δ [{fan_grid.unit}]',
                          axes=axes, colors=colors, sharey=sharey,
                          figsize=figsize)


def plot_opd_fans(fan_grid, *, axes='both', colors=None, sharey='row',
                  figsize=None):
    """Grid of OPD fans (OPDFanGrid)."""
    return _plot_fan_grid(fan_grid, f'OPD [{fan_grid.unit}]',
                          axes=axes, colors=colors, sharey=sharey,
                          figsize=figsize)


def plot_spots(spot_grid, *, colors=None, s=4, figsize=None,
               sharexy=True):
    """Grid of spot diagrams (SpotGrid), one panel per field."""
    import matplotlib.pyplot as plt
    nf = len(spot_grid.fields)
    fig, axs = plt.subplots(1, nf, figsize=figsize, squeeze=False,
                            sharex=sharexy, sharey=sharexy)
    colors = _wavelength_colors(len(spot_grid.wavelengths), colors)
    for i in range(nf):
        ax = axs[0][i]
        for j, w in enumerate(spot_grid.wavelengths):
            ax.scatter(to_host(spot_grid.x[i, j]), to_host(spot_grid.y[i, j]), s=s,
                       c=colors[j],
                       label=f'{w:.4g} um' if i == 0 else None)
        ax.set_aspect('equal')
        ax.set(xlabel='x', title=f'field {i}')
    axs[0][0].set(ylabel='y')
    axs[0][0].legend(fontsize='small')
    return fig, axs


def plot_spot_diagrams(spot_grid, *, ncols=None, colors=None, marker='+',
                       s=None, equal_limits=True, legend=True, figsize=None,
                       fig=None, axs=None):
    """Grid of spot diagrams, one subplot per field, richer layout.

    Consumes a SpotGrid from analysis.spot_diagrams and scatters every
    wavelength (colored) in each field's subplot; equal_limits gives all
    subplots the same square limits so spot sizes compare by eye
    (reference: x/raytracing/plotting.py:1417).
    """
    import matplotlib.pyplot as plt
    nf = len(spot_grid.fields)
    nw = len(spot_grid.wavelengths)
    if ncols is None:
        ncols = nf
    nrows = (nf + ncols - 1) // ncols
    if axs is None:
        fig, axs = plt.subplots(nrows, ncols, figsize=figsize,
                                squeeze=False)
    else:
        axs = np.atleast_2d(axs)
        fig = fig or axs.flat[0].figure
    colors = _wavelength_colors(nw, colors)
    half = 0.0
    for i in range(nf):
        ax = axs.flat[i]
        for j, w in enumerate(spot_grid.wavelengths):
            x = to_host(spot_grid.x[i, j])
            y = to_host(spot_grid.y[i, j])
            ax.scatter(x, y, s=s, marker=marker, c=colors[j],
                       label=f'{w:.4g} um' if i == 0 else None)
            fin = np.isfinite(x) & np.isfinite(y)
            if fin.any():
                half = max(half, float(np.abs(x[fin]).max()),
                           float(np.abs(y[fin]).max()))
        ax.set_aspect('equal')
        ax.set(xlabel='x', title=f'field {i}')
        if i % ncols == 0:
            ax.set(ylabel='y')
    if equal_limits and half > 0.0:
        pad = 1.05 * half
        for i in range(nf):
            axs.flat[i].set(xlim=(-pad, pad), ylim=(-pad, pad))
    for i in range(nf, nrows * ncols):
        axs.flat[i].set_visible(False)
    if legend:
        axs.flat[0].legend(fontsize='small')
    return fig, axs


# ---------- mirror outlines --------------------------------------------------

def _mirror_profile(surf, result, surface_index, points, radius, center,
                    axis='y'):
    """(N, 3) global meridional profile of a mirror's optical face.

    Returns (pts, tloc, sag, center) with center resolved to a number
    so callers can reference downstream geometry (bores, back rules) to
    the same origin as the sampled meridian.  axis selects the local
    transverse axis ('y' default) the meridian runs along; a string
    center ('chief' / 'rays' / 'footprint') re-centers on the bundle.
    """
    phist = None if result is None else result.P
    if isinstance(center, str):
        if center.lower() not in ('chief', 'rays', 'ray', 'footprint'):
            raise ValueError(f'unknown drawing center {center!r}')
        if phist is None:
            raise ValueError(
                "center='chief' needs a trace result to locate the "
                'bundle; pass result= or a numeric center')
        loc = _to_local(to_host(phist)[surface_index + 1], surf)
        tv = loc[..., 0 if axis == 'x' else 1]
        tv = tv[np.isfinite(tv)]
        center = float(tv.mean()) if tv.size else 0.0
    center = float(center)
    if radius is None:
        radius = _drawn_radius(surf, phist, surface_index)
    tloc = np.linspace(center - radius, center + radius, points)
    xpt, ypt = _sag_args(tloc, axis)
    sag = _sag(surf, xpt, ypt)
    pts = np.stack([xpt, ypt, sag], axis=1)
    return pts, tloc, sag, center


def _profile_to_global(surf, pts):
    if surf.R is not None:
        pts = pts @ to_host(surf.R)
    return pts + to_host(surf.P)


def mirror_surface_outline(surf, result=None, surface_index=0, *, points=100,
                           x='z', y='y', radius=None, center=0.0):
    """X/Y arrays drawing one mirror optical surface's meridian.

    The drawn half-diameter defaults to the surface aperture's drawn
    radius, else the traced ray footprint; center='chief' re-centers the
    profile on the bundle (reference: x/raytracing/plotting.py:334).
    """
    pts, tloc, sag, _ = _mirror_profile(surf, result, surface_index,
                                        points, radius, center,
                                        axis=y.lower())
    inner = _extent_inner(surf)
    if inner > 0.0:
        pts = pts.copy()
        pts[np.abs(tloc - float(np.mean(tloc))) < inner, 2] = np.nan
    g = _profile_to_global(surf, pts)
    ix, iy = _axis_pair(x, y)
    return g[:, ix], g[:, iy]


def mirror_substrate_outline(surf, result=None, surface_index=0, *,
                             substrate, points=100, x='z', y='y',
                             radius=None, center=0.0):
    """Closed X/Y outline of a mirror: optical face, back, rim walls.

    substrate selects the back-face rule: SurfaceSubstrate retraces the
    optical profile; ParallelSubstrate offsets it by the thickness;
    FlatParentSubstrate is flat at vertex sag + thickness;
    FlatBackSubstrate is flat at the aperture-edge (or vertex) sag +
    thickness; None draws the optical face only
    (reference: x/raytracing/plotting.py:374).
    """
    axis = y.lower()
    pts, tloc, sag, center = _mirror_profile(surf, result, surface_index,
                                             points, radius, center,
                                             axis=axis)
    ix, iy = _axis_pair(x, y)
    if substrate is None:
        g = _profile_to_global(surf, pts)
        return g[:, ix], g[:, iy]
    # an annular drawn extent bores the substrate too
    inner = _extent_inner(surf)
    bore = max(inner, float(getattr(substrate, 'bore', 0.0) or 0.0))
    face = np.asarray(sag, dtype=float).copy()
    face[np.abs(tloc - center) < inner] = np.nan
    zz, tt = substrate.back_outline(surf, tloc, face, center=center,
                                    bore=bore)
    zz = np.asarray(zz, dtype=float)
    tt = np.asarray(tt, dtype=float)
    xpt, ypt = _sag_args(tt, axis)
    path = np.stack([xpt, ypt, zz], axis=1)
    # NaN separators (bored backs) survive the rigid transform
    g = _profile_to_global(surf, path)
    return g[:, ix], g[:, iy]


def plot_mirror_surface(surf, result=None, surface_index=0, *, points=100,
                        x='z', y='y', radius=None, center=0.0,
                        lw=1, ls='-', c='k', alpha=1, zorder=3,
                        fig=None, ax=None):
    """Draw one mirror optical surface (see mirror_surface_outline)."""
    fig, ax = share_fig_ax(fig, ax)
    xx, yy = mirror_surface_outline(
        surf, result, surface_index, points=points, x=x, y=y,
        radius=radius, center=center)
    ax.plot(xx, yy, c=c, lw=lw, ls=ls, alpha=alpha, zorder=zorder)
    return fig, ax


def plot_mirror_substrate(surf, result=None, surface_index=0, *, substrate,
                          points=100, x='z', y='y', radius=None, center=0.0,
                          lw=1, ls='-', c='k', alpha=1, zorder=3,
                          fig=None, ax=None):
    """Draw one mirror with its optical surface and substrate outline."""
    fig, ax = share_fig_ax(fig, ax)
    xx, yy = mirror_substrate_outline(
        surf, result, surface_index, substrate=substrate, points=points,
        x=x, y=y, radius=radius, center=center)
    ax.plot(xx, yy, c=c, lw=lw, ls=ls, alpha=alpha, zorder=zorder)
    return fig, ax


__all__ = [
    'share_fig_ax',
    'plot_ray_paths',
    'plot_optics',
    'layout',
    'plot_transverse_ray_aberration',
    'plot_wave_aberration_fan',
    'plot_spot_diagram',
    'plot_spot_diagrams',
    'plot_field_curvature',
    'plot_distortion',
    'plot_chromatic_focal_shift',
    'plot_lateral_color',
    'plot_full_field',
    'plot_ray_fans',
    'plot_opd_fans',
    'plot_spots',
    'mirror_surface_outline',
    'mirror_substrate_outline',
    'plot_mirror_surface',
    'plot_mirror_substrate',
]
