"""Code V .seq prescription port.

Counterpart of ``prysm_tpu/x/raytracing/io/codev.py``.  Architecture:
tokenizer -> spec -> builder, mirroring the zemax port.  The text is split
into a flat command stream (semicolon/newline separated, ! comments
dropped); deck verbs and per-surface verbs are consumed by dispatch
registries over a deck dict and a per-surface state dict; a decoder
chain turns each surface state into a format-neutral SurfaceSpec (Fringe
Zernike / XY polynomial / biconic / even asphere / conic, in that
precedence); the builder folds the stream into LensData + OpticalSystem.

Sign conventions handled at this boundary: Code V alpha/beta tilts are
left-handed (ADE/BDE negate on both import and export), and post-mirror
gaps carry the negative-thickness unfolded-axis convention.
"""
import math
import re

from ... import materials as _materials
from ._indexing import fringe_to_nm, xy_j_to_mn
from ._common import (
    aperture_kwargs_from_radii, fields_from_xy, fold_sign,
    length_scale_to_mm, parse_float, read_text_or_path,
    scale_length_to_mm, writable_shape_or_raise)
from ..lensdata import LensData
from ..system import OpticalSystem, ApertureSpec, FieldSet
from ..paraxial import effective_focal_length
from ._surface_spec import (build_shape, surface_spec_factory,
                            surface_spec_from_row)

# writer emits THI 1E10 for an infinite conjugate; reads >= this are inf
_OBJECT_AT_INFINITY_MM = 1e9

_VIGNETTING_KEYS = ('vux', 'vlx', 'vuy', 'vly')


# ---------- tokenizer -------------------------------------------------------


def _command_stream(text):
    """Yield [VERB, *payload] commands; ! comments and blanks dropped."""
    for line in text.splitlines():
        bang = line.find('!')
        if bang >= 0:
            line = line[:bang]
        for piece in line.split(';'):
            tokens = piece.split()
            if tokens:
                tokens[0] = tokens[0].upper()
                yield tokens


def _strip_title_quotes(title):
    title = title.strip()
    quoted = (len(title) >= 2 and title[0] in ('"', "'")
              and title[-1] == title[0])
    return title[1:-1] if quoted else title


def _looks_numeric(token):
    token = token.strip()
    if token.upper() in ('INF', 'INFINITY'):
        return True
    try:
        float(token)
    except ValueError:
        return False
    return True


# ---------- deck verb handlers --------------------------------------------


def _float_list(target_key):
    def handler(deck, payload):
        try:
            deck[target_key] = [float(t) for t in payload]
        except ValueError:
            pass
    return handler


def _float_first(target_key):
    def handler(deck, payload):
        if payload:
            try:
                deck[target_key] = float(payload[0])
            except ValueError:
                pass
    return handler


def _hdr_dim(deck, payload):
    if payload:
        token = payload[0].upper()
        # Code V 'M' means millimeter, unlike the SI reading; 'C' and 'I'
        # are the single-letter centimeter/inch spellings
        deck['unit'] = {'M': 'mm', 'C': 'cm', 'CM': 'cm', 'I': 'in',
                        'IN': 'in', 'FT': 'ft'}.get(token, token.lower())


def _hdr_wl(deck, payload):
    # Code V wavelengths are nanometers; store microns
    try:
        deck['wavelengths'] = [float(t) * 1e-3 for t in payload]
    except ValueError:
        pass


def _hdr_ref(deck, payload):
    try:
        deck['reference_wvl_index'] = int(payload[0])
    except (IndexError, ValueError):
        pass


_HEADER_VERBS = {
    'TITLE': lambda h, a: h.__setitem__('title', _strip_title_quotes(' '.join(a))),
    'TIT': lambda h, a: h.__setitem__('title', _strip_title_quotes(' '.join(a))),
    'DIM': _hdr_dim,
    'WL': _hdr_wl,
    'WTW': _float_list('wavelength_weights'),
    'REF': _hdr_ref,
    'EPD': _float_first('epd'),
    'FNO': _float_first('fno'),
    'YAN': _float_list('yan'),
    'XAN': _float_list('xan'),
    'YIM': _float_list('yim'),
    'XIM': _float_list('xim'),
}


# ---------- surface verb handlers -------------------------------------------


def _fresh_surface():
    return {
        'rdy': None, 'cuy': None, 'rdx': None, 'cux': None,
        'thi': 0.0, 'k': 0.0, 'kx': None, 'gla': None,
        'semidiameter': None, 'inner_semidiameter': None,
        'asphere_coefs': {}, 'is_asphere': False,
        'zfr_coefs': None, 'xyp_coefs': None, 'nrr': None,
        'dec_x': 0.0, 'dec_y': 0.0, 'dec_z': 0.0,
        'ade': 0.0, 'bde': 0.0, 'cde': 0.0,
        'dar': False,
    }


def _sval(key):
    def handler(state, payload):
        if payload:
            state[key] = parse_float(payload[0])
    return handler


def _sfloats(key):
    def handler(state, payload):
        try:
            state[key] = [parse_float(t) for t in payload]
        except ValueError:
            pass
    return handler


def _s_gla(state, payload):
    state['gla'] = payload[0] if payload else None


def _s_asp(state, payload):
    state['is_asphere'] = True


def _s_dar(state, payload):
    state['dar'] = True


_SURFACE_VERBS = {
    'RDY': _sval('rdy'), 'CUY': _sval('cuy'),
    'RDX': _sval('rdx'), 'CUX': _sval('cux'),
    'THI': _sval('thi'), 'K': _sval('k'), 'KX': _sval('kx'),
    'GLA': _s_gla,
    'CAO': _sval('semidiameter'), 'CA': _sval('semidiameter'),
    'CIR': _sval('semidiameter'), 'CAI': _sval('inner_semidiameter'),
    'ASP': _s_asp,
    'ZFR': _sfloats('zfr_coefs'), 'XYP': _sfloats('xyp_coefs'),
    'NRR': _sval('nrr'), 'NRD': _sval('nrr'),
    'DAR': _s_dar,
    'XDE': _sval('dec_x'), 'YDE': _sval('dec_y'), 'ZDE': _sval('dec_z'),
    'ADE': _sval('ade'), 'BDE': _sval('bde'), 'CDE': _sval('cde'),
    'BEN': lambda state, payload: None,  # reflection direction is native
}


def _consume_asphere_letter(state, verb, payload):
    """A..H verbs carry even-asphere coefficients (A = a4, B = a6, ...)."""
    try:
        state['asphere_coefs'][ord(verb) - ord('A') + 1] = parse_float(payload[0])
        state['is_asphere'] = True
    except (IndexError, ValueError):
        pass


def _inline_surface_args(payload, state, radius_mode):
    """Positional tokens of SO / S / SI: S <rad> <thi> [gla_token]."""
    pos = 0
    if pos < len(payload) and _looks_numeric(payload[pos]):
        state['rdy' if radius_mode else 'cuy'] = parse_float(payload[pos])
        pos += 1
    if pos < len(payload) and _looks_numeric(payload[pos]):
        state['thi'] = parse_float(payload[pos])
        pos += 1
    if pos < len(payload):
        if pos == 0:
            raise ValueError('Code V surface line expects positional '
                             f'numeric data, got {payload[pos]!r}')
        state['gla'] = payload[pos]


class _DeckWalk:
    """Running parse state over the command stream."""

    def __init__(self):
        self.deck = {
            'title': None, 'unit': None,
            'wavelengths': [], 'wavelength_weights': [],
            'reference_wvl_index': None,
            'epd': None, 'fno': None,
            'yan': [], 'xan': [], 'yim': [], 'xim': [],
            'vignetting': {key: [] for key in _VIGNETTING_KEYS},
            'extras': {},
        }
        self.radius_mode = True     # RDM default; CUM flips to curvature
        self.surfaces = []
        self.current = None
        self.stop_surface = None

    def commit(self):
        if self.current is not None:
            self.surfaces.append(self.current)
            self.current = None

    def open_surface(self, payload, **flags):
        self.commit()
        self.current = _fresh_surface()
        self.current.update(flags)
        _inline_surface_args(payload, self.current, self.radius_mode)

    def feed(self, verb, payload):
        if verb == 'LEN':
            pass
        elif verb == 'RDM':
            self.radius_mode = True
        elif verb == 'CUM':
            self.radius_mode = False
        elif verb == 'STO':
            self.stop_surface = (self.current if self.current is not None
                                 else (self.surfaces[-1] if self.surfaces
                                       else None))
        elif verb in ('SO', 'S', 'SI'):
            flags = {'SO': {'_is_object': True}, 'S': {},
                     'SI': {'_is_image': True}}[verb]
            self.open_surface(payload, **flags)
        elif verb == 'GO':
            self.commit()
            return False
        elif verb in _HEADER_VERBS and (self.current is None
                                        or verb not in _SURFACE_VERBS):
            _HEADER_VERBS[verb](self.deck, payload)
        elif verb in _VIGNETTING_KEYS or verb.lower() in _VIGNETTING_KEYS:
            try:
                self.deck['vignetting'][verb.lower()] = [float(t)
                                                           for t in payload]
            except ValueError:
                pass
        elif self.current is not None and verb in _SURFACE_VERBS:
            _SURFACE_VERBS[verb](self.current, payload)
        elif (self.current is not None and len(verb) == 1
              and verb in 'ABCDEFGH'):
            _consume_asphere_letter(self.current, verb, payload)
        else:
            self.deck['extras'].setdefault(verb, []).append(' '.join(payload))
        return True


# ---------- field handling --------------------------------------------------


def _field_count(x_values, y_values):
    return max(len(x_values), len(y_values))


def _vignetting_by_field(deck, n_fields):
    def entry(i):
        return {key: (deck['vignetting'].get(key, ())[i:i + 1] or [0.0])[0]
                for key in _VIGNETTING_KEYS}

    return [entry(i) for i in range(n_fields)]


def _angle_fields_from_header(deck):
    n_fields = _field_count(deck['xan'], deck['yan'])
    if not n_fields:
        return []
    return fields_from_xy(deck['xan'], deck['yan'], kind='angle',
                          unit='deg',
                          vignetting=_vignetting_by_field(deck, n_fields))


def _image_height_fields_from_header(deck, system, to_mm):
    """Convert XIM/YIM image heights to equivalent angle fields via EFL."""
    n_fields = _field_count(deck['xim'], deck['yim'])
    if not n_fields:
        return []
    efl = abs(float(effective_focal_length(
        system.to_surfaces(), wvl=system.wavelength(None))))
    if efl <= 0.0 or not math.isfinite(efl):
        raise ValueError('Code V image-height fields (XIM/YIM) require a '
                         'finite, nonzero effective focal length')

    def angle_of(values, i):
        h = values[i] if i < len(values) else 0.0
        return math.degrees(math.atan2(scale_length_to_mm(h, to_mm),
                                       efl))

    return fields_from_xy(
        [angle_of(deck['xim'], i) for i in range(n_fields)],
        [angle_of(deck['yim'], i) for i in range(n_fields)],
        kind='angle', unit='deg',
        vignetting=_vignetting_by_field(deck, n_fields))


# ---------- surface decoding ------------------------------------------------


def _curvature_of(state, cu_key, rd_key):
    """Curvature from CUY/CUX or 1/RDY/RDX; None when an X-axis is unset."""
    if state.get(cu_key) is not None:
        return float(state[cu_key])
    if state.get(rd_key) is not None:
        radius = float(state[rd_key])
        return 1.0 / radius if math.isfinite(radius) and radius else 0.0
    return 0.0 if cu_key == 'cuy' else None


_MODEL_DOTTED = re.compile(r'^(\d{6})[.](\d{6})$')
_MODEL_CODE = re.compile(r'^\d{6}$')


def _model_glass_from_token(token):
    """Code V model gla_token from an nd/Vd token, or None.

    Spellings: nd:Vd; dotted AAAAAA.BBBBBB (nd = 1+A/1e6, Vd = B/1e4);
    six-digit NNNVVV (nd = 1+NNN/1e3, Vd = VVV/10).
    """
    if ':' in token:
        nd, _, vd = token.partition(':')
        try:
            return _materials.model_glass(float(nd), float(vd))
        except ValueError:
            return None
    dotted = _MODEL_DOTTED.match(token)
    if dotted:
        return _materials.model_glass(1.0 + int(dotted.group(1)) * 1e-6,
                                      int(dotted.group(2)) * 1e-4)
    if _MODEL_CODE.match(token):
        return _materials.model_glass(1.0 + int(token[:3]) * 1e-3,
                                      int(token[3:]) * 1e-1)
    return None


def _lookup_codev_glass(gla_token, database):
    """Resolve a GLA token GLASS_CATALOG (vendor-suffixed) or model gla_token."""
    if gla_token is None:
        return _materials.lookup(gla_token, database=database)
    as_model = _model_glass_from_token(gla_token)
    if as_model is not None:
        return as_model
    if '_' not in gla_token:
        return _materials.lookup(gla_token, database=database)
    # vendor-suffixed: a model-glass code with a redundant catalog tag
    # resolves without any database at all, so check it before lookups
    # (which may need the absent refractiveindex.info download)
    name, vendor = gla_token.rsplit('_', 1)
    as_model = _model_glass_from_token(name)
    try:
        return _materials.lookup(gla_token, database=database)
    except KeyError:
        pass
    except ImportError:
        if as_model is None:
            raise
    if as_model is not None:
        return as_model
    try:
        return _materials.lookup(name, database=database, catalog=vendor)
    except KeyError:
        return _materials.lookup(name, database=database)


def _build_spec(state, radius_mode, database=None, length_scale=1.0):
    """One parsed Code V surface state -> SurfaceSpec (no pose)."""
    c_y = _curvature_of(state, 'cuy', 'rdy')
    c_x = _curvature_of(state, 'cux', 'rdx')
    k_y = float(state.get('k', 0.0))
    k_x = state.get('kx', None)

    gla = state.get('gla')
    if gla is not None and gla.upper() in ('REFL', 'REF_S', 'REFL_FRONT'):
        medium = _materials.MIRROR
    else:
        medium = _lookup_codev_glass(gla, database)
    spec = surface_spec_factory(medium, length_scale)

    if state.get('zfr_coefs') is not None:
        coefs = state['zfr_coefs']
        return spec('zernike', dict(
            c=c_y, k=k_y,
            normalization_radius=float(state.get('nrr') or 1.0),
            nms=[fringe_to_nm(j) for j in range(1, len(coefs) + 1)],
            coefs=tuple(coefs), norm=False))

    if state.get('xyp_coefs') is not None:
        coefs = state['xyp_coefs']
        return spec('xy', dict(
            c=c_y, k=k_y,
            normalization_radius=float(state.get('nrr') or 1.0),
            mns=[xy_j_to_mn(j) for j in range(1, len(coefs) + 1)],
            coefs=tuple(coefs)))

    if not (c_x is None and k_x is None):
        return spec('biconic', dict(
            c_x=c_y if c_x is None else c_x, c_y=c_y,
            k_x=0.0 if k_x is None else float(k_x), k_y=k_y))

    if state.get('is_asphere'):
        sparse = state.get('asphere_coefs', {})
        coefs = (tuple(sparse.get(i, 0.0)
                       for i in range(1, max(sparse) + 1)) if sparse else ())
        return spec('even_asphere', dict(c=c_y, k=k_y, coefs=coefs))

    return spec('conic', dict(c=c_y, k=k_y))


def _pose_from_state(state, length_scale=1.0):
    """(tilt, decenter, kind) for one parsed surface state.

    Code V alpha/beta tilts are left-handed; invert ADE/BDE at this
    boundary only.
    """
    tilt = decenter = None
    if any(state.get(k, 0.0) for k in ('ade', 'bde', 'cde')):
        tilt = (float(state.get('cde', 0.0)),
                -float(state.get('bde', 0.0)),
                -float(state.get('ade', 0.0)))
    if any(state.get(k, 0.0) for k in ('dec_x', 'dec_y', 'dec_z')):
        decenter = tuple(
            scale_length_to_mm(state.get(k, 0.0), length_scale)
            for k in ('dec_x', 'dec_y', 'dec_z'))
    return tilt, decenter, 'dar' if state.get('dar') else 'basic'


# ---------- reader ----------------------------------------------------------


def read_seq(path_or_text, *, _is_text=False, database=None):
    """Read a Code V .seq file into an OpticalSystem."""
    text, path_for_meta = read_text_or_path(path_or_text, is_text=_is_text)
    walk = _DeckWalk()
    for verb, *payload in _command_stream(text):
        if not walk.feed(verb, payload):
            break
    walk.commit()
    if not walk.surfaces:
        raise ValueError('no surfaces found in .seq text')

    deck = walk.deck
    to_mm = length_scale_to_mm(deck['unit'] or 'mm')
    fields = _angle_fields_from_header(deck)

    ref_idx = deck['reference_wvl_index']
    reference = (ref_idx - 1 if ref_idx is not None
                 and 1 <= ref_idx <= len(deck['wavelengths']) else None)

    if deck['epd'] is not None:
        aperture = ApertureSpec.epd(scale_length_to_mm(deck['epd'],
                                                       to_mm))
    elif deck['fno'] is not None:
        aperture = ApertureSpec.fno(deck['fno'])
    else:
        aperture = None

    ld = LensData()
    sys = OpticalSystem(
        ld, aperture=aperture, fields=fields,
        wavelengths=deck['wavelengths'],
        weights=deck['wavelength_weights'] or None, reference=reference,
        title=deck['title'], source_path=path_for_meta,
        source_format='codev', extras=deck['extras'])

    n_refl = 0
    stop_row = None
    for state in walk.surfaces:
        gap = scale_length_to_mm(state.get('thi', 0.0), to_mm)
        if state.get('_is_object'):
            if (math.isfinite(gap) and gap != 0.0
                    and abs(gap) < _OBJECT_AT_INFINITY_MM):
                ld.object_row.thickness = gap
            endpoint = _build_spec(state, walk.radius_mode, database,
                                   to_mm)
            if endpoint.n is not None:
                ld.object_row.material = endpoint.n
            continue
        tilt, decenter, kind = _pose_from_state(state, to_mm)
        if tilt is not None or decenter is not None:
            ld.add_coordbreak(decenter=decenter or (0.0, 0.0, 0.0),
                              tilt=tilt or (0.0, 0.0, 0.0), kind=kind)
        ap_kwargs = aperture_kwargs_from_radii(
            state.get('semidiameter'), to_mm,
            inner_radius=state.get('inner_semidiameter'))
        if state.get('_is_image'):
            ld.image_row.thickness = fold_sign(n_refl) * gap
            for key, val in ap_kwargs.items():
                setattr(ld.image_row, key, val)
            continue
        spec = _build_spec(state, walk.radius_mode, database, to_mm)
        n_refl += spec.typ == 'refl'
        ld.add(build_shape(spec), thickness=fold_sign(n_refl) * gap,
               material=spec.n, typ=spec.typ, **ap_kwargs)
        if state is walk.stop_surface:
            stop_row = ld.rows[-2]   # surface just inserted before IMAGE

    if stop_row is not None:
        from ..listings import surface_row_mappings
        sys.stop_index = next(
            (m['surface_index'] for m in surface_row_mappings(ld)
             if m['surface_index'] is not None
             and ld.rows[m['row_index']] is stop_row), None)

    if not fields and (deck['xim'] or deck['yim']):
        sys.fields = FieldSet(_image_height_fields_from_header(
            deck, sys, to_mm))

    return sys


# ---------- writer ----------------------------------------------------------


def _glass_name(material, typ):
    """Best-effort Code V gla_token token for a LensData material."""
    from ..spencer_and_murty import STYPE_REFLECT
    from ..surfaces import _map_stype
    if _map_stype(typ) == STYPE_REFLECT:
        return 'REFL'
    if material in (None, _materials.air, _materials.vacuum):
        return None
    page_info = getattr(material, 'page_info', None)
    if page_info and page_info.get('page'):
        return page_info['page']
    return None


def _coordbreak_seq_lines(row):
    """Code V decenter/tilt commands for a LensData CoordBreak."""
    dx, dy, dz = (float(v) for v in row.decenter)
    rz, ry, rx = (float(v) for v in row.tilt)
    out = ['DAR'] if getattr(row, 'kind', 'basic') == 'dar' else []
    for label, value in (('XDE', dx), ('YDE', dy), ('ZDE', dz)):
        if value:
            out.append(f'{label} {value:g}')
    # ADE/BDE are left-handed about X/Y; invert on export
    for label, value in (('ADE', -rx), ('BDE', -ry), ('CDE', rz)):
        if value:
            out.append(f'{label} {value:g}')
    return out


def _emit_seq_header(system):
    out = ['LEN', 'CUM', 'DIM M']
    title = getattr(system, 'title', None)
    if title:
        out.append(f'TITLE "{title}"')
    def floats_of(name):
        val = getattr(system, name, None)
        return [] if val is None else [float(w) for w in val]

    wvls = floats_of('wavelengths')
    if wvls:
        out.append('WL ' + ' '.join(f'{w * 1000.0:g}' for w in wvls))
        out.append(f'REF {int(getattr(system, "reference", 0)) + 1}')
    weights = floats_of('weights')
    if weights and len(weights) == len(wvls) \
            and any(w != 1.0 for w in weights):
        out.append('WTW ' + ' '.join(f'{w:g}' for w in weights))
    epd = getattr(system, 'epd', None)
    if epd is not None:
        out.append(f'EPD {epd:g}')
    fields = getattr(system, 'fields', None) or []
    if fields:
        out.append('XAN ' + ' '.join(f'{f.hx:g}' for f in fields))
        out.append('YAN ' + ' '.join(f'{f.hy:g}' for f in fields))
        for key in _VIGNETTING_KEYS:
            column = [0.0 if f.vignetting is None
                      else float(f.vignetting.get(key, 0.0)) for f in fields]
            if any(v != 0.0 for v in column):
                out.append(key.upper() + ' '
                           + ' '.join(f'{v:g}' for v in column))
    return out


def _aperture_parts(aperture):
    from ._common import aperture_export_radii
    outer, inner = aperture_export_radii(aperture, allow_annular=True)
    parts = []
    if outer is not None:
        parts.append(f'CAO {outer:g}')
    if inner is not None:
        parts.append(f'CAI {inner:g}')
    return parts


def write_seq(system):
    """Serialize an OpticalSystem to .seq text (rot. symmetric subset).

    Writes curvature mode (CUM); wavelengths export in nanometers;
    post-mirror gaps use the Code V negative-thickness convention.
    """
    from ._common import preflight_export
    from ..lensdata import CoordBreak, SurfaceMap
    from ..spencer_and_murty import STYPE_OBJ, _is_measurement_surf
    from ..surfaces import _map_stype
    preflight_export(system, 'write_seq')

    lines = _emit_seq_header(system)

    def is_object_row(row):
        return (not isinstance(row, CoordBreak)
                and _map_stype(row.typ) == STYPE_OBJ)

    obj_row = next(filter(is_object_row, system.rows), None)
    obj_thi = (float(obj_row.thickness) if obj_row is not None
               else float('inf'))
    so_parts = ['SO',
                f'THI {obj_thi:g}' if math.isfinite(obj_thi) else 'THI 1E10']
    if obj_row is not None:
        gla_token = _glass_name(obj_row.material, obj_row.typ)
        if gla_token:
            so_parts.append(f'GLA {gla_token}')
        so_parts += _aperture_parts(obj_row.aperture)
    lines.append(' ; '.join(so_parts))

    n_refl = 0
    pending_coordbreak = None
    mapping = SurfaceMap(getattr(system, 'lens', system))
    stop_index = getattr(system, 'stop_index', None)

    def flush_coordbreak():
        nonlocal pending_coordbreak
        if pending_coordbreak is not None:
            lines.extend(_coordbreak_seq_lines(pending_coordbreak))
            pending_coordbreak = None

    for row_index, row in enumerate(system.rows):
        if isinstance(row, CoordBreak):
            if pending_coordbreak is not None:
                raise NotImplementedError(
                    'write_seq cannot export consecutive CoordBreak rows '
                    'without an intervening surface')
            pending_coordbreak = row
            continue
        stype = _map_stype(row.typ)
        if stype == STYPE_OBJ:
            continue
        is_eval = _is_measurement_surf(stype)
        writable_shape_or_raise(row.shape_kind, is_eval, 'write_seq')
        spec = surface_spec_from_row(row)
        reflective = _glass_name(row.material, row.typ) == 'REFL'
        n_refl += reflective
        if is_eval:
            lines.append(' ; '.join(['SI'] + _aperture_parts(row.aperture)))
        else:
            parts = ['S', f'CUY {spec.params.get("c", 0.0):g}',
                     f'THI {fold_sign(n_refl) * spec.thickness:g}']
            if spec.params.get('k', 0.0):
                parts.insert(2, f'K {spec.params["k"]:g}')
            gla_token = _glass_name(row.material, row.typ)
            if gla_token:
                parts.append(f'GLA {gla_token}')
            parts += _aperture_parts(row.aperture)
            lines.append(' ; '.join(parts))
        if mapping.surface_for_row(row_index) == stop_index:
            lines.append('STO')
        flush_coordbreak()
    if pending_coordbreak is not None:
        raise NotImplementedError(
            'write_seq cannot export a trailing CoordBreak with no surface')
    lines.append('GO')
    return '\n'.join(lines) + '\n'
