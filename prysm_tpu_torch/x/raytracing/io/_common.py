"""Shared helpers for the raytracing prescription ports (Zemax, Code V).

Counterpart of ``prysm_tpu/x/raytracing/io/_common.py``.  Unit scaling is
rule-driven: ``_PARAM_SCALERS`` maps a normalized shape kind to the scaling
rules its parameters obey when converting from source units to mm.
"""
import math
import warnings
import re

_VIGNETTING_TOKENS = ('VUX', 'VUY', 'VLX', 'VLY', 'VDX', 'VDY', 'VCX',
                      'VCY', 'VAN')
_VIGNETTING_RE = re.compile(r'\b(' + '|'.join(_VIGNETTING_TOKENS) + r')\b',
                            re.IGNORECASE)


def warn_vignetting_ignored(text, dialect):
    """One-time note when a deck declares affine vignetting factors."""
    if not _VIGNETTING_RE.search(text or ''):
        return
    warnings.warn(
            f'{dialect} declares vignetting factors, which are ignored: '
            'vignetting is modeled by clipping at per-surface clear '
            'apertures, not by affine pupil-scaling factors.', stacklevel=3)


def read_text_or_path(source, is_text=False):
    """(text, source-path metadata) for parser entry points."""
    if is_text:
        return source, None
    with open(source, encoding='utf-8', errors='replace') as fh:
        return fh.read(), str(source)


def _padded(values, n, fill):
    values = list(values)
    return values + [fill] * (n - len(values))


def fields_from_xy(hx_list, hy_list, kind='angle', unit='deg',
                   object_z=None, length_scale=1.0, vignetting=None):
    """Field records from possibly uneven x/y field lists."""
    from ..launch import Field

    hx_list, hy_list = list(hx_list), list(hy_list)
    if not (hx_list or hy_list):
        return []
    n = max(len(hx_list), len(hy_list))
    triples = zip(_padded(hx_list, n, 0.0), _padded(hy_list, n, 0.0),
                  _padded(vignetting or [], n, None))
    if kind == 'angle':
        return [Field(hx, hy, vignetting=vig, kind='angle', unit=unit)
                for hx, hy, vig in triples]
    object_z = scale_length_to_mm(object_z, length_scale)
    return [Field(scale_length_to_mm(hx, length_scale),
                  scale_length_to_mm(hy, length_scale), vignetting=vig,
                  kind=kind, object_z=object_z)
            for hx, hy, vig in triples]


_MM_PER = {'mm': 1.0, 'cm': 10.0, 'm': 1000.0, 'in': 25.4, 'ft': 304.8}
_UNIT_TO_MM = {
    **_MM_PER,
    **{name: _MM_PER['mm'] for name in ('millimeter', 'millimeters')},
    **{name: _MM_PER['cm'] for name in ('centimeter', 'centimeters')},
    **{name: _MM_PER['m'] for name in ('meter', 'meters')},
    **{name: _MM_PER['in'] for name in ('inch', 'inches')},
    **{name: _MM_PER['ft'] for name in ('foot', 'feet')},
}


def length_scale_to_mm(unit):
    """Factor converting one source length unit to millimeters."""
    if unit is None:
        return float(1)
    try:
        return _UNIT_TO_MM[str(unit).strip().lower()]
    except KeyError as e:
        raise ValueError(f'prescription length unit {unit!r} is not '
                         'supported; use mm, cm, m, in, or ft') from e


def scale_length_to_mm(value, scale):
    """Scale a finite length-like value into millimeters."""
    if value is None:
        return None
    as_float = float(value)
    return as_float * scale if math.isfinite(as_float) else as_float


def _curvature_rule(params, scale, keys):
    for key in keys:
        params[key] = float(params.get(key, 0.0)) / scale


def _asphere_rule(params, scale, key):
    # i=1 is the rho**4 coefficient; rho**(2i+2) scales by scale**(2i+1)
    params[key] = tuple(
        float(coef) / scale ** (2 * (i + 1) - 1)
        for i, coef in enumerate(params.get(key, ()), start=1))


def scale_surface_params_to_mm(kind, params, scale):
    """Scale normalized SurfaceSpec shape params from source units to mm."""
    params = dict(params)
    if scale == 1.0:
        return params
    if kind in ('conic', 'even_asphere', 'xy', 'zernike'):
        _curvature_rule(params, scale, ('c',))
    if kind == 'even_asphere':
        _asphere_rule(params, scale, 'coefs')
    elif kind in ('toroid', 'biconic'):
        _curvature_rule(params, scale, ('c_x', 'c_y'))
        if kind == 'toroid':
            _asphere_rule(params, scale, 'coefs_y')
    elif kind in ('xy', 'zernike'):
        params['normalization_radius'] = scale_length_to_mm(
            params['normalization_radius'], scale)
        params['coefs'] = tuple(float(c) * scale
                                for c in params.get('coefs', ()))
    return params


def aperture_kwargs_from_radii(outer_radius, scale, inner_radius=None):
    """LensData.add keyword args for a circular or annular clear aperture."""
    outer = scale_length_to_mm(outer_radius, scale)
    if outer is None:
        return {}
    from ..aperture import Aperture, annular_aperture, CircularExtent
    inner = scale_length_to_mm(inner_radius, scale)
    if inner is None:
        return {'aperture': Aperture(clip=float(outer))}
    if inner < 0 or outer <= 0 or inner >= outer:
        raise ValueError('clear-aperture radii must satisfy '
                         '0 <= inner < outer')
    return {'aperture': Aperture(
        clip=annular_aperture(inner, outer),
        extent=CircularExtent(float(outer), inner_radius=float(inner)))}


def fold_sign(n_refl):
    """Gap sign given the number of preceding reflections.

    Zemax/Code V encode post-mirror gaps as negative thicknesses on an
    unfolded axis; LensData folds the frame and keeps thickness positive,
    so the sign alternates with the parity of n_refl.
    """
    return 1.0 - 2.0 * (n_refl % 2)


# shape kinds a prescription writer can serialize losslessly
_WRITABLE_KINDS = ('conic', 'sphere', 'plane')


def writable_shape_or_raise(shape_kind, is_eval, writer):
    """Reject surface rows a prescription writer would serialize lossily."""
    if is_eval:
        return
    if shape_kind in _WRITABLE_KINDS:
        return
    raise NotImplementedError(
        f'exporting {shape_kind!r} through {writer} would lose '
        'shape data; writers support only conic, sphere, and plane.')


def aperture_export_radii(aperture, *, allow_annular):
    """Strict (outer, inner) clip radii for a supported aperture."""
    from ..aperture import CircularClip, AnnularClip
    clip = aperture.clip
    if clip is None:
        cosmetic = (aperture.extent is not None
                    or aperture.substrate is not None or aperture.features)
        if cosmetic:
            raise ValueError(
                'cosmetic extent/substrate/features are unsupported')
        return (None,) * 2
    if isinstance(clip, CircularClip):
        bounds = (clip.radius, None)
    elif allow_annular and isinstance(clip, AnnularClip):
        bounds = (clip.outer_radius, clip.inner_radius)
    else:
        raise ValueError(f'{type(clip).__name__} clips are not supported '
                         'by this writer')
    if (clip.x0, clip.y0) != (0.0, 0.0):
        kind = 'circular' if isinstance(clip, CircularClip) else 'annular'
        raise ValueError(f'decentered {kind} clips are unsupported')
    if aperture.substrate is not None or aperture.features:
        raise ValueError('substrates and edge features are unsupported')
    outer, inner = bounds
    if aperture.extent is not None:
        mismatched = (float(aperture.extent.outer_radius) != float(outer)
                      or float(aperture.extent.inner_radius)
                      != float(inner or 0.0))
        if mismatched:
            raise ValueError('the drawn extent differs from the exported '
                             'clip')
    return float(outer), float(inner) if inner is not None else None


def _check_row(row, ri, writer, allow_annular, objections):
    from ... import materials
    from ..lensdata import CoordBreak, SurfaceRow

    if isinstance(row, CoordBreak):
        allowed = {'write_zmx': ('basic',)}.get(writer, ('basic', 'dar'))
        if row.kind not in allowed:
            objections.append(f'row {ri} CoordBreak kind {row.kind!r}')
        if row.ret_target is not None:
            objections.append(f'row {ri} CoordBreak ret_target')
    elif not isinstance(row, SurfaceRow):
        objections.append(f'row {ri} has an unknown row type')
    else:
        _check_surface_row(row, ri, allow_annular, objections)


def _check_surface_row(row, ri, allow_annular, objections):
    from ... import materials
    from ..spencer_and_murty import _is_measurement_surf, STYPE_REFLECT
    from ..surfaces import _map_stype

    stype = _map_stype(row.typ)
    exportable_shape = row.shape_kind in _WRITABLE_KINDS
    if not (_is_measurement_surf(stype) or exportable_shape):
        objections.append(f'row {ri} shape {row.shape_kind}')
    if row.grating is not None:  # OPL modifiers have no export encoding
        objections.append(f'row {ri} OPLFunc/grating')
    if row.coating is not None:
        objections.append(f'row {ri} coating stack')
    try:
        aperture_export_radii(row.aperture, allow_annular=allow_annular)
    except ValueError as exc:
        objections.append(f'row {ri} aperture ({exc})')
    nontrivial_medium = (stype != STYPE_REFLECT and row.material
                         not in (None, materials.air, materials.vacuum))
    if nontrivial_medium:
        page = getattr(row.material, 'page_info', None)
        if not page or not page.get('page'):
            objections.append(f'row {ri} material lacks an external '
                              'catalog name')


def preflight_export(system, writer):
    """Aggregate every semantic feature a strict writer cannot represent."""
    if writer not in ('write_zmx', 'write_seq'):
        raise ValueError(f'unknown writer {writer!r}')
    allow_annular = writer == 'write_seq'
    rows = getattr(getattr(system, 'lens', system), 'rows', None)
    if rows is None:
        raise TypeError(f'{writer} wants a LensData or an OpticalSystem')

    objections = []
    for ri, row in enumerate(rows):
        _check_row(row, ri, writer, allow_annular, objections)

    ap_spec = getattr(system, 'aperture', None)
    if ap_spec is not None and getattr(ap_spec, 'mode', None) != 'EPD':
        objections.append(
            f'system aperture mode {getattr(ap_spec, "mode", None)!r}')
    for i, fld in enumerate(list(getattr(system, 'fields', ()) or ())):
        if fld.kind == 'angle' and fld.unit != 'deg':
            objections.append(f'field {i} angular unit {fld.unit!r}')
        if writer == 'write_seq' and fld.kind != 'angle':
            objections.append(f'field {i} is an object-height field')
        if writer == 'write_zmx' and fld.vignetting is not None:
            objections.append(f'field {i} vignetting factors')
    leftovers = sorted(set(getattr(system, 'extras', None) or {})
                       - {'VERS', 'MODE'})
    if leftovers:
        objections.append('system extras: ' + ', '.join(leftovers))
    if objections:
        raise NotImplementedError(f'{writer} cannot losslessly export: '
                                  + '; '.join(objections))


def parse_float(token):
    """Parse a numeric token; INF / INFINITY (any case) is +inf."""
    stripped = token.strip()
    return (float('inf') if stripped.upper() in ('INF', 'INFINITY')
            else float(stripped))
