"""Zemax .zmx prescription port.

Counterpart of ``prysm_tpu/x/raytracing/io/zemax.py``.  Architecture:
tokenizer -> spec -> builder.  The text is tokenized into per-SURF keyword
records; header directives and per-surface directives are consumed by
dispatch registries (``_HEADER_HANDLERS`` / ``_SURF_HANDLERS``) that fill
plain dict states; surface types decode through a third registry
(``_TYPE_DECODERS``) into format-neutral SurfaceSpecs; the builder folds
the spec stream into a LensData + OpticalSystem, converting Zemax's
negative-thickness unfolded-axis convention for post-mirror gaps.

The writer serializes the strict rotationally-symmetric subset back out.
"""
import math

import numpy as np

from ... import materials as _materials
from ._indexing import noll_to_nm, xy_j_to_mn
from ._common import (
    aperture_export_radii, aperture_kwargs_from_radii, fields_from_xy,
    fold_sign, length_scale_to_mm, parse_float, preflight_export,
    read_text_or_path, scale_length_to_mm, writable_shape_or_raise,
    warn_vignetting_ignored as _warn_vignetting_ignored)
from ..lensdata import LensData
from ..system import OpticalSystem, ApertureSpec
from ._surface_spec import (build_shape, surface_spec_factory,
                            surface_spec_from_row)


# ---------- tokenizer -------------------------------------------------------


def _keyword_split(line):
    """(KEYWORD, remainder) of one directive line."""
    head, _, tail = line.partition(' ')
    return head.upper(), tail.strip()


def _tokenize_deck(text):
    """(header records, surf blocks) where each record is (keyword, rest).

    Surf blocks are (zemax surf number, [records]) in file order.
    """
    preamble, blocks, active = [], [], None
    for raw in text.splitlines():
        body = raw.strip()
        if not body:
            continue
        keyword, rest = _keyword_split(body)
        if keyword == 'SURF':
            try:
                number = int(rest.split()[0])
            except (IndexError, ValueError) as e:
                raise ValueError(f'malformed SURF line: {raw.rstrip()!r}') from e
            active = (number, [])
            blocks.append(active)
        elif active is None:
            preamble.append((keyword, rest))
        else:
            active[1].append((keyword, rest))
    return preamble, blocks


# ---------- header ----------------------------------------------------------

_UNIT_MAP = {
    'MM': 'mm', 'CM': 'cm', 'IN': 'in', 'INCHES': 'in',
    'M': 'm', 'METERS': 'm', 'FT': 'ft', 'FEET': 'ft',
}


def _first_float(rest):
    return float(rest.split()[0])


def _hdr_wavl(deck, rest):
    try:
        deck['wavelengths'].append(_first_float(rest))
    except (IndexError, ValueError):
        deck['extras'].setdefault('WAVL_unparsed', []).append(rest)


def _hdr_wavm(deck, rest):
    tokens = rest.split()
    if len(tokens) >= 2:
        try:
            deck['wavelengths'].append(float(tokens[1]))
            deck['weights'].append(float(tokens[2]) if len(tokens) >= 3
                                   else 1.0)
        except ValueError:
            pass


def _quietly(key, convert):
    def handler(deck, rest):
        try:
            deck[key] = convert(rest)
        except (IndexError, ValueError):
            pass
    return handler


_HEADER_HANDLERS = {
    'WAVL': _hdr_wavl,
    'WAVM': _hdr_wavm,
    'PWAV': _quietly('reference', lambda r: int(r.split()[0]) - 1),
    'NAME': lambda deck, rest: deck.__setitem__('title',
                                                rest.strip().strip('"')),
    'ENPD': _quietly('epd', _first_float),
    'STOP': _quietly('stop_index_zemax', lambda r: int(r.split()[0])),
    'UNIT': lambda deck, rest: deck.__setitem__(
        'unit', _UNIT_MAP.get(rest.split()[0].upper(),
                              rest.split()[0].lower()) if rest.split() else None),
    'XFLN': lambda deck, rest: deck.__setitem__(
        'xfln', [float(x) for x in rest.split() if x]),
    'YFLN': lambda deck, rest: deck.__setitem__(
        'yfln', [float(y) for y in rest.split() if y]),
    'FTYP': _quietly('field_type', lambda r: int(r.split()[0])),
}


def _digest_header(records):
    deck = {'wavelengths': [], 'weights': [], 'reference': None,
            'title': None, 'epd': None, 'stop_index_zemax': None,
            'unit': None, 'fields': [], 'extras': {},
            'xfln': [], 'yfln': [], 'field_type': 0}
    for keyword, rest in records:
        handler = _HEADER_HANDLERS.get(keyword)
        if handler is not None:
            handler(deck, rest)
        else:
            deck['extras'].setdefault(keyword, []).append(rest)
    # FTYP 0 = angle fields; height fields resolve later (need SURF 0 DISZ)
    if (deck['xfln'] or deck['yfln']) and deck['field_type'] == 0:
        deck['fields'] = fields_from_xy(deck['xfln'], deck['yfln'],
                                        kind='angle', unit='deg')
    return deck


# ---------- per-surface records ---------------------------------------------


def _surf_parm(state, rest):
    tokens = rest.split()
    if len(tokens) >= 2:
        try:
            state['parm'][int(tokens[0])] = parse_float(tokens[1])
        except ValueError:
            pass


def _surf_scalar(key, default=0.0):
    def handler(state, rest):
        tokens = rest.split()
        state[key] = parse_float(tokens[0]) if tokens else default
    return handler


def _surf_diam(state, rest):
    try:
        state['diam'] = parse_float(rest.split()[0])
    except (IndexError, ValueError):
        pass


_SURF_HANDLERS = {
    'TYPE': lambda st, r: st.__setitem__('type', r.split()[0].upper())
    if r.split() else None,
    'CURV': _surf_scalar('curv'),
    'CONI': _surf_scalar('coni'),
    'DISZ': _surf_scalar('disz'),
    'GLAS': lambda st, r: st.__setitem__('glas',
                                         r.split()[0] if r.split() else ''),
    'NMAT': lambda st, r: st.setdefault('glas',
                                        r.split()[0] if r.split() else ''),
    'DIAM': _surf_diam,
    'PARM': _surf_parm,
    'XDAT': lambda st, r: st.setdefault('xdat', []).append(r),
    'STOP': lambda st, r: st.__setitem__('is_stop', True),
    'COMM': lambda st, r: st.__setitem__('comment', r),
}

_KNOWN_IGNORED = frozenset({'MEMA', 'CTGT', 'CONF', 'HIDE', 'MIRR', 'COAT'})


def _digest_block(number, records):
    state = {'idx': number, 'parm': {}}
    for keyword, rest in records:
        handler = _SURF_HANDLERS.get(keyword)
        if handler is not None:
            handler(state, rest)
        elif keyword not in _KNOWN_IGNORED:
            state.setdefault('unknown', []).append(f'{keyword} {rest}')
    return state


def _xdat_terms(lines):
    """{term index: value} from raw XDAT payloads; bad lines skipped."""
    terms = {}
    for line in lines:
        tokens = line.split()
        if len(tokens) >= 2:
            try:
                terms[int(tokens[0])] = parse_float(tokens[1])
            except (ValueError, IndexError):
                pass
    return terms


def _dense_from_sparse(sparse, first=1):
    """Tuple of values for indices first..max, zero-filling gaps."""
    if not sparse:
        return ()
    top = max(sparse)
    return tuple(sparse.get(i, 0.0) for i in range(first, top + 1))


# ---------- surface-type decoders -------------------------------------------


def _decode_standard(state, spec, c, k):
    return spec('conic', dict(c=c, k=k))


def _decode_evenasph(state, spec, c, k):
    # PARM 1 = a4, PARM 2 = a6, ...
    return spec('even_asphere',
                dict(c=c, k=k, coefs=_dense_from_sparse(state['parm'])))


def _decode_toroidal(state, spec, c, k):
    # PARM 1 = radius of rotation (= 1/c_x); CURV = c_y, CONI = k_y
    rotation_radius = state['parm'].get(1)
    if not rotation_radius:
        raise ValueError(
            f'TOROIDAL surface {state["idx"]} missing PARM 1 '
            '(radius of rotation)')
    higher = {i - 1: v for i, v in state['parm'].items() if i > 1}
    return spec('toroid', dict(c_x=1.0 / float(rotation_radius),
                               c_y=float(c), k_y=float(k),
                               coefs_y=_dense_from_sparse(higher, first=2)))


def _decode_biconicx(state, spec, c, k):
    # PARM 1 = c_x; PARM 2 = k_x.  CURV = c_y, CONI = k_y
    return spec('biconic', dict(c_x=float(state['parm'].get(1, 0.0)),
                                c_y=float(c),
                                k_x=float(state['parm'].get(2, 0.0)),
                                k_y=float(k)))


def _decode_zernsag(state, spec, c, k):
    norm_r = state['parm'].get(1)
    if not norm_r:
        raise ValueError(f'ZERNSAG surface {state["idx"]} missing PARM 1 '
                         '(normalization radius)')
    terms = _xdat_terms(state.get('xdat', []))
    if not terms:
        return spec('conic', dict(c=c, k=k))
    top = max(terms)
    return spec('zernike', dict(
        c=c, k=k, normalization_radius=float(norm_r),
        nms=[noll_to_nm(j) for j in range(1, top + 1)],
        coefs=tuple(float(terms.get(j, 0.0)) for j in range(1, top + 1)),
        norm=True))


def _decode_xypoly(state, spec, c, k):
    norm_r = state['parm'].get(1, 1.0) or 1.0
    terms = _xdat_terms(state.get('xdat', []))
    if not terms:
        return spec('conic', dict(c=c, k=k))
    top = max(terms)
    return spec('xy', dict(
        c=c, k=k, normalization_radius=float(norm_r),
        mns=[xy_j_to_mn(j) for j in range(1, top + 1)],
        coefs=tuple(float(terms.get(j, 0.0)) for j in range(1, top + 1))))


_TYPE_DECODERS = {
    'STANDARD': _decode_standard,
    'EVENASPH': _decode_evenasph,
    'TOROIDAL': _decode_toroidal,
    'BICONICX': _decode_biconicx,
    'ZERNSAG': _decode_zernsag,
    'XYPOLY': _decode_xypoly,
}


def _make_spec(state, database, length_scale=1.0):
    """Pose-free SurfaceSpec from a digested SURF state (or coordbreak)."""
    surf_type = state.get('type', 'STANDARD')
    if surf_type == 'COORDBRK':
        return _CoordinateBreak(state)
    decoder = _TYPE_DECODERS.get(surf_type)
    if decoder is None:
        raise NotImplementedError(
            f'Zemax surface type {surf_type!r} not supported by read_zmx.  '
            'Supported: STANDARD, EVENASPH, TOROIDAL, BICONICX, ZERNSAG, '
            'XYPOLY, COORDBRK (folded into the next surface).')
    medium = _materials.lookup(state.get('glas', ''), database=database)
    spec = surface_spec_factory(medium, length_scale)
    return decoder(state, spec, state.get('curv', 0.0),
                   state.get('coni', 0.0))


class _CoordinateBreak:
    """Sentinel for a COORDBRK pseudo-surface (PARM 1..6 tilt/decenter)."""

    def __init__(self, state):
        self.state = state

    def tilt_decenter(self, length_scale=1.0):
        p = self.state.get('parm', {})
        shift = (scale_length_to_mm(p.get(1, 0.0), length_scale),
                 scale_length_to_mm(p.get(2, 0.0), length_scale), 0.0)
        # Zemax tilt order is PARM 3=Tx, 4=Ty, 5=Tz; ours is (rz, ry, rx)
        return (p.get(5, 0.0), p.get(4, 0.0), p.get(3, 0.0)), shift


# ---------- writer ----------------------------------------------------------


def _glas_line(material):
    if material is _materials.air or material is _materials.vacuum:
        return None
    page = getattr(material, 'page_info', None)
    if page and page.get('page'):
        return f'  GLAS {page["page"]}'
    return None


def _emit_header(system):
    out = ['VERS 100000 0', 'MODE SEQ']
    title = getattr(system, 'title', None)
    if title:
        out.append(f'NAME "{title}"')
    unit = getattr(system, 'unit', None)
    if unit:
        out.append(f'UNIT {unit.upper()}')
    epd = getattr(system, 'epd', None)
    if epd is not None:
        out.append(f'ENPD {epd:g}')

    stop_index = getattr(system, 'stop_index', None)
    if stop_index is not None:
        from ..listings import surface_row_mappings
        stop_surface = next(
            (m['zemax_surface_number']
             for m in surface_row_mappings(system.lens)
             if m['surface_index'] == stop_index), None)
        if stop_surface is None:
            raise ValueError(f'stop_index {stop_index!r} does not identify '
                             'a compiled surface')
        out.append(f'STOP {stop_surface}')

    def aslist(name, default):
        val = getattr(system, name, None)
        return default if val is None else list(val)

    wvls = aslist('wavelengths', [])
    weights = aslist('weights', [])
    for i, w in enumerate(wvls):
        weight = weights[i] if i < len(weights) else 1.0
        out.append(f'WAVM {i + 1} {float(w):g} {float(weight):g}')
    if wvls:
        out.append(f'PWAV {int(getattr(system, "reference", 0)) + 1}')

    fields = aslist('fields', [])
    if fields:
        out.append(f'FTYP {0 if fields[0].kind == "angle" else 1}')
        out.append('XFLN ' + ' '.join(f'{f.hx:g}' for f in fields))
        out.append('YFLN ' + ' '.join(f'{f.hy:g}' for f in fields))
    return out


def _emit_object_surf(obj_row):
    obj_thi = (float(obj_row.thickness) if obj_row is not None
               else float('inf'))
    disz = f'{obj_thi:g}' if math.isfinite(obj_thi) else 'INFINITY'
    out = ['SURF 0', '  TYPE STANDARD', '  CURV 0.0', f'  DISZ {disz}']
    if obj_row is not None:
        glas = _glas_line(obj_row.material)
        if glas:
            out.append(glas)
        outer, _ = aperture_export_radii(obj_row.aperture,
                                         allow_annular=False)
        if outer is not None:
            out.append(f'  DIAM {outer:g}')
    return out


def write_zmx(system):
    """Serialize an OpticalSystem to .zmx text (rot. symmetric subset).

    Post-reflection gaps use Zemax's negative-thickness unfolded-axis
    convention (the inverse of the import fold); coordinate breaks export
    as COORDBRK pseudo-surfaces.
    """
    preflight_export(system, 'write_zmx')
    from ..lensdata import CoordBreak
    from ..spencer_and_murty import (
        STYPE_OBJ, STYPE_REFLECT, _is_measurement_surf)
    from ..surfaces import _map_stype

    def is_object_row(row):
        return (not isinstance(row, CoordBreak)
                and _map_stype(row.typ) == STYPE_OBJ)

    lines = _emit_header(system)
    lines += _emit_object_surf(next(filter(is_object_row, system.rows), None))

    surf_no, n_refl = 0, 0
    for row in system.rows:
        if is_object_row(row):
            continue
        surf_no += 1
        if isinstance(row, CoordBreak):
            dx, dy, _ = (float(v) for v in row.decenter)
            rz, ry, rx = (float(v) for v in row.tilt)
            lines += [f'SURF {surf_no}', '  TYPE COORDBRK',
                      f'  DISZ {fold_sign(n_refl) * float(row.thickness):g}',
                      f'  PARM 1 {dx:g}', f'  PARM 2 {dy:g}',
                      f'  PARM 3 {rx:g}', f'  PARM 4 {ry:g}',
                      f'  PARM 5 {rz:g}']
            continue
        is_eval = _is_measurement_surf(_map_stype(row.typ))
        writable_shape_or_raise(row.shape_kind, is_eval, 'write_zmx')
        spec = surface_spec_from_row(row)
        reflective = _map_stype(row.typ) == STYPE_REFLECT
        n_refl += reflective
        block = [f'SURF {surf_no}', '  TYPE STANDARD',
                 f'  CURV {spec.params.get("c", 0.0):g}']
        if spec.params.get('k', 0.0):
            block.append(f'  CONI {spec.params["k"]:g}')
        block.append(f'  DISZ {fold_sign(n_refl) * spec.thickness:g}')
        outer, _ = aperture_export_radii(row.aperture, allow_annular=False)
        if outer is not None:
            block.append(f'  DIAM {outer:g}')
        if reflective:
            block.append('  GLAS MIRROR')
        elif not is_eval:
            glas = _glas_line(row.material)
            if glas:
                block.append(glas)
        lines += block
    return '\n'.join(lines) + '\n'


# ---------- reader ----------------------------------------------------------


def _resolve_fields_with_type(deck, parsed, unit_scale):
    """Height fields need the finite object distance; angle fields don't."""
    xfln, yfln, ftype = deck['xfln'], deck['yfln'], deck['field_type']
    if not (xfln or yfln) or ftype == 0:
        return deck['fields']
    if ftype == 1:
        object_gap = parsed[0].get('disz', 0.0) if parsed else None
        if object_gap is None or not np.isfinite(object_gap):
            raise ValueError('Zemax object-height fields require a finite '
                             'object distance on SURF 0 DISZ')
        return fields_from_xy(xfln, yfln, kind='height', object_z=0.0,
                              length_scale=unit_scale)
    if ftype in (2, 3):
        raise NotImplementedError(
            'Zemax image-height fields (FTYP 2/3) are not supported by '
            'read_zmx; use angle fields or object-height fields instead')
    raise NotImplementedError(
        f'Zemax FTYP {ftype} fields are not supported by read_zmx')


def _is_flat_conic(spec):
    return (spec.kind == 'conic' and spec.params.get('c', 0.0) == 0.0
            and spec.params.get('k', 0.0) == 0.0)


def read_zmx(path_or_text, *, _is_text=False, database=None):
    """Read Zemax .zmx text into an OpticalSystem.

    database resolves real glass names (materials catalog); air, blank,
    and mirror surfaces need none.
    """
    text, path_for_meta = read_text_or_path(path_or_text, is_text=_is_text)
    header_records, surf_blocks = _tokenize_deck(text)
    deck = _digest_header(header_records)
    if not surf_blocks:
        raise ValueError('no surfaces found in .zmx text')

    parsed = [_digest_block(number, records)
              for number, records in surf_blocks]
    unit_scale = length_scale_to_mm(deck['unit'] or 'mm')
    fields = _resolve_fields_with_type(deck, parsed, unit_scale)

    def gap_of(state):
        d = state.get('disz', 0.0)
        return 0.0 if not np.isfinite(d) else scale_length_to_mm(d, unit_scale)

    def aperture_of(state):
        return aperture_kwargs_from_radii(state.get('diam'), unit_scale)

    ld = LensData()
    sys = OpticalSystem(
        ld,
        aperture=(ApertureSpec.epd(scale_length_to_mm(deck['epd'],
                                                      unit_scale))
                  if deck['epd'] is not None else None),
        fields=fields,
        wavelengths=deck['wavelengths'],
        weights=deck['weights'] or None,
        reference=deck['reference'], title=deck['title'],
        source_path=path_for_meta, source_format='zemax',
        extras=deck['extras'])

    physical = [i for i, state in enumerate(parsed)
                if not (i == 0 and state.get('idx', i) == 0)
                and state.get('type', 'STANDARD') != 'COORDBRK']
    last_physical = physical[-1] if physical else None

    n_refl = 0
    for i, state in enumerate(parsed):
        if i == 0 and state.get('idx', i) == 0:
            # OBJECT endpoint: distance + medium (inf keeps the default)
            endpoint_spec = _make_spec(state, database, unit_scale)
            object_gap = gap_of(state)
            if math.isfinite(object_gap) and object_gap != 0.0:
                ld.object_row.thickness = object_gap
            if endpoint_spec.n is not None:
                ld.object_row.material = endpoint_spec.n
            for key, val in aperture_of(state).items():
                setattr(ld.object_row, key, val)
            continue
        spec = _make_spec(state, database, unit_scale)
        if isinstance(spec, _CoordinateBreak):
            tilt, decenter = spec.tilt_decenter(unit_scale)
            ld.add_coordbreak(decenter=decenter, tilt=tilt, kind='basic',
                              thickness=fold_sign(n_refl) * gap_of(state))
            continue
        n_refl += spec.typ == 'refl'
        thickness = fold_sign(n_refl) * gap_of(state)
        # a flat trailing conic sets the auto IMAGE endpoint
        if i == last_physical and _is_flat_conic(spec):
            ld.image_row.thickness = thickness
            for key, val in aperture_of(state).items():
                setattr(ld.image_row, key, val)
            continue
        ld.add(build_shape(spec), thickness=thickness,
               material=spec.n, typ=spec.typ, **aperture_of(state))

    # translate the Zemax stop SURF number to the compiled-surface index
    if deck['stop_index_zemax'] is not None:
        from ..listings import surface_row_mappings
        sys.stop_index = next(
            (m['surface_index'] for m in surface_row_mappings(ld)
             if m['surface_index'] is not None
             and m['zemax_surface_number'] == deck['stop_index_zemax']),
            None)

    _warn_vignetting_ignored(text, 'Zemax')
    return sys
