"""Instrument file formats: Zygo MetroPro, Code V, SigFit, MTF Mapper.

Counterpart of ``prysm_tpu/io.py``, which is plain numpy: file formats are
byte layouts, not device computation, so the port keeps its own copy of the
same host code and returns numpy arrays as it does.  A writer given the
same data writes the same bytes.

The MetroPro binary header is described by a declarative text layout
(``_ZYGO_LAYOUT``): one line per field, ``offset  kind  name [= default]``.
The byte offsets, field widths, and magic constants are fixed by the MetroPro
file format itself (see the MetroPro Reference Guide, OMP-0347); the
reader/writer are generated from the layout table.  Phase scaling follows the
format spec: ``height = raw * S * O * wavelength / R`` with R set by the
phase resolution tag.
"""
import re
import struct
import datetime
import warnings
from pathlib import Path

import numpy as np

ZYGO_INVALID_PHASE = 2147483640
ZYGO_ENC = 'utf-8'
ZYGO_PHASE_RES_FACTORS = {
    0: 4096,    # "normal" resolution, 12-bit
    1: 32768,   # "high", 15-bit
    2: 131072,  # "very high", 17-bit
}
ZYGO_DEFAULT_WVL = 6.327999813038332e-07  # HeNe, meters, as MetroPro stores it

# ---------------------------------------------------------------------------
# Zygo MetroPro binary header layout
#
# kind vocabulary:  u8, u16be/u16le, u32be/u32le, f32be/f32le, chr, sN (an
# N-byte character field).  Unlisted byte ranges are reserved/padding and are
# written as NUL.  Defaults are what MetroPro itself puts in fresh files.
# ---------------------------------------------------------------------------

_ZYGO_LAYOUT = """
0    u32be magic_number              = 0x881B036F
4    u16be header_format             = 1
6    u32be header_size               = 834
10   u16be swtype                    = 1
12   s30   swdate
42   u16be swmaj
44   u16be swmin
46   u16be swpatch
48   u16be ac_x
50   u16be ac_y
52   u16be ac_width
54   u16be ac_height
56   u16be ac_n_buckets
58   u16be ac_range
60   u32be ac_n_bytes
64   u16be cn_x
66   u16be cn_y
68   u16be cn_width
70   u16be cn_height
72   u32be cn_n_bytes
76   u32be timestamp
80   s82   comment
162  u16be source
164  f32be scale_factor              = 0.5
168  f32be wavelength                = 6.327999813038332e-07
172  f32be numerical_aperture
176  f32be obliquity_factor          = 1.0
180  f32be magnification
184  f32be lateral_resolution        = 1.0
188  u16be acq_type
190  u16be intensity_average_count
192  u16be ramp_cal
194  u16be sfac_limit                = 3
196  u16be ramp_gain                 = 1753
198  f32be part_thickness
202  u16be sw_llc                    = 1
204  f32be target_range              = 0.1
208  u16le rad_crv_measure_seq
210  u32be min_mod                   = 17
214  u32be min_mod_count             = 50
218  u16be phase_res                 = 1
220  u32be min_area                  = 20
224  u16be discontinuity_action      = 1
226  f32be discontinuity_filter      = 60.0
230  u16be connect_order
232  u16be sign
234  u16be camera_width
236  u16be camera_height
238  u16be sys_type                  = 23
240  u16be sys_board
242  u16be sys_serial
244  u16be sys_inst_id
246  s12   obj_name
258  s40   part_name
298  u16be codev_type
300  u16be phase_avg_count           = 1
302  u16be sub_sys_err
320  s40   part_sn
360  f32be refractive_index          = 1.0
364  u16be remove_tilt
366  u16be remove_fringes
368  u32be max_area                  = 9999999
372  u16be setup_type
374  u16be wrapped
376  f32be pre_connect_filter
386  f32be wavelength_in_1           = 6.327999813038332e-07
390  f32be wavelength_in_2           = 6.327999813038332e-07
394  f32be wavelength_in_3           = 6.327999813038332e-07
398  s8    wavelength_select         = '1'
406  u16be fda_res
408  s20   scan_description
428  u16be n_fiducials
430  f32be fiducial_1
434  f32be fiducial_2
438  f32be fiducial_3
442  f32be fiducial_4
446  f32be fiducial_5
450  f32be fiducial_6
454  f32be fiducial_7
458  f32be fiducial_8
462  f32be fiducial_9
466  f32be fiducial_10
470  f32be fiducial_11
474  f32be fiducial_12
478  f32be fiducial_13
482  f32be fiducial_14
486  f32be pixel_width               = 7.4e-06
490  f32be pixel_height              = 7.4e-06
494  f32be exit_pupil_diameter
498  f32be light_level_percent       = 55.0
502  u32le coords_state
506  f32le coords_x
510  f32le coords_y
514  f32le coords_z
518  f32le coords_a
522  f32le coords_b
526  f32le coords_c
530  u16le cohrence_mode
532  u16le surface_filter
534  s28   sys_err_filename
562  s8    zoom_descr                = '   1X'
570  f32le alpha_part
574  f32le beta_part
578  f32le dist_part
582  u16le cam_split_loc_x
584  u16le cam_split_loc_y
586  u16le cam_split_trans_x
588  u16le cam_split_trans_y
590  s24   material_a
614  s24   material_b
642  f32le dmi_center_x
646  f32le dmi_center_y
650  u16le sph_distortion_correction
654  f32le sph_dist_part_na
658  f32le sph_dist_part_radius
662  f32le sph_dist_cal_na
666  f32le sph_dist_cal_radius
670  u16le surface_type
672  u16le ac_surface_type
674  f32le z_pos
678  f32le power_mul
682  f32le focus_mul
686  f32le roc_focus_cal_factor
690  f32le roc_power_cal_factor
694  f32le ftp_pos_left
698  f32le ftp_pos_right
702  f32le ftp_pos_pitch
706  f32le ftp_pos_roll
710  f32le min_mod_percent           = 7.0
714  u32le max_intens
718  u16le ring_of_fire
721  chr   rc_orientation            = ' '
722  f32le rc_distance
726  f32le rc_angle
730  f32le rc_diameter
734  u16be rem_fringes_mode
737  u8    ftpsi_phase_res
738  u16le frames_acquired
740  u16le cavity_type
742  f32le cam_frame_rate
746  f32le tune_range
750  u16le cal_pix_x
752  u16le cal_pix_y
758  f32le test_cal_pts_1
762  f32le test_cal_pts_2
766  f32le test_cal_pts_3
770  f32le test_cal_pts_4
774  f32le ref_cal_pts_1
778  f32le ref_cal_pts_2
782  f32le ref_cal_pts_3
786  f32le ref_cal_pts_4
790  f32le test_cal_pix_opd
794  f32le test_ref_pix_opd
798  f32le flash_phase_cd_mask      = 9.139576869988608e-40
802  f32le flash_phase_alias_mask
806  f32le flash_phase_filter
810  u8    scan_direction
814  u16le ftpsi_res_factor
"""

_ZYGO_HEADER_LENGTH = 834

_KIND_TO_STRUCT = {
    'u8': 'B', 'chr': 'c',
    'u16be': '>H', 'u16le': '<H',
    'u32be': '>I', 'u32le': '<I',
    'f32be': '>f', 'f32le': '<f',
}


def _parse_layout(text=_ZYGO_LAYOUT):
    """layout DSL -> list of (name, offset, struct_format, is_text, default)."""
    fields = []
    for raw in text.strip().splitlines():
        body, _, dflt = raw.partition('=')
        offset_s, kind, name = body.split()
        offset = int(offset_s)
        dflt = dflt.strip()
        if kind.startswith('s') and kind not in _KIND_TO_STRUCT:
            fmt = f'<{kind[1:]}s'
            default = dflt.strip("'") if dflt else ''
            fields.append((name, offset, fmt, True, default))
        else:
            fmt = _KIND_TO_STRUCT[kind]
            is_text = kind == 'chr'
            if is_text:
                default = dflt.strip("'") if dflt else ' '
            elif not dflt:
                default = 0
            elif dflt.startswith('0x'):
                default = int(dflt, 16)
            else:
                default = float(dflt) if ('.' in dflt or 'e' in dflt) else int(dflt)
            fields.append((name, offset, fmt, is_text, default))
    return fields


_ZYGO_FIELDS = _parse_layout()


def read_zygo_metadata(file_contents):
    """Parse a MetroPro binary header into a flat dict of native values."""
    meta = {}
    for name, offset, fmt, is_text, _ in _ZYGO_FIELDS:
        value, = struct.unpack_from(fmt, file_contents, offset)
        if isinstance(value, bytes):
            value = value.decode(ZYGO_ENC).rstrip('\x00')
        meta[name] = value
    return meta


def _pack_zygo_header(overrides):
    """Build an 834-byte MetroPro header from defaults + ``overrides``."""
    buf = bytearray(_ZYGO_HEADER_LENGTH)
    for name, offset, fmt, is_text, default in _ZYGO_FIELDS:
        value = overrides.get(name, default)
        if is_text:
            width = struct.calcsize(fmt)
            value = str(value).ljust(width).encode(ZYGO_ENC)[:width]
        struct.pack_into(fmt, buf, offset, value)
    return bytes(buf)


def _zygo_phase_to_nm(raw, wavelength_m, scale, obliquity, res_tag):
    """Decode raw phase integers to nanometers of height; invalid -> NaN."""
    out = np.asarray(raw, dtype=np.float64)
    out[out >= ZYGO_INVALID_PHASE] = np.nan
    lsb_m = wavelength_m * scale * obliquity / ZYGO_PHASE_RES_FACTORS[res_tag]
    return out * (lsb_m * 1e9)


def read_zygo_dat(file, multi_intensity_action='first'):
    """Read a MetroPro binary .dat file.

    Returns a dict with 'phase' (nm, NaN where dropped out), 'intensity'
    (camera counts or None) and 'meta' (full header).  Arrays are flipped
    vertically so +y is up, matching the rest of the library.
    """
    contents = Path(file).read_bytes() if not hasattr(file, 'read') else file.read()
    meta = read_zygo_metadata(contents)

    buckets = meta['ac_n_buckets'] or 1
    i_shape = (buckets, meta['ac_height'], meta['ac_width'])
    i_count = i_shape[0] * i_shape[1] * i_shape[2]
    p_shape = (meta['cn_height'], meta['cn_width'])
    p_count = p_shape[0] * p_shape[1]

    frames = np.frombuffer(contents, np.uint16, count=i_count,
                           offset=meta['header_size']).reshape(i_shape)
    reducers = {'avg': lambda a: a.mean(axis=0),
                'first': lambda a: a[0],
                'last': lambda a: a[-1]}
    key = multi_intensity_action.lower()
    if key not in reducers:
        raise ValueError(f'multi_intensity_action {multi_intensity_action} '
                         'not among valid options of avg, first, last.')
    intensity = np.flipud(reducers[key](frames))

    phase_offset = meta['header_size'] + i_count * 2
    be_i32 = np.dtype('>i4')
    available = (len(contents) - phase_offset) // 4
    if available >= p_count:
        raw = np.frombuffer(contents, be_i32, count=p_count, offset=phase_offset)
    else:
        warnings.warn('provided file was malformed (truncated) - appending '
                      'zeros to phase data')
        raw = np.full(p_count, ZYGO_INVALID_PHASE, dtype=np.int64)
        raw[:available] = np.frombuffer(contents, be_i32, count=available,
                                        offset=phase_offset)
    phase = _zygo_phase_to_nm(np.flipud(raw.reshape(p_shape)),
                              meta['wavelength'], meta['scale_factor'],
                              meta['obliquity_factor'], meta['phase_res'])
    return {'phase': phase, 'intensity': intensity, 'meta': meta}


def write_zygo_dat(file, phase, dx, wavelength=0.6328, intensity=None):
    """Write a MetroPro binary .dat file.

    phase in nm, dx in mm, wavelength in um.  Written with unit scale and
    obliquity factors and the 15-bit phase resolution tag.
    """
    if intensity is not None:
        raise NotImplementedError('writing DAT files with intensity is not supported')
    phase = np.asarray(phase, dtype=np.float64)
    rows, cols = phase.shape
    wavelength_m = wavelength * 1e-6
    header = _pack_zygo_header({
        'scale_factor': 1.0,
        'obliquity_factor': 1.0,
        'lateral_resolution': dx * 1e-3,
        'timestamp': int(datetime.datetime.now().timestamp()),
        'cn_width': cols,
        'cn_height': rows,
        'cn_n_bytes': phase.size * 4,
        'wavelength': wavelength_m,
        'phase_res': 1,
    })
    # encode: nm -> m -> phase LSBs; dropouts carry the invalid sentinel
    lsb_m = wavelength_m / ZYGO_PHASE_RES_FACTORS[1]
    dropped = np.isnan(phase)
    counts = np.where(dropped, 0.0, phase) * (1e-9 / lsb_m)
    counts = counts.astype(np.int32)
    counts[dropped] = ZYGO_INVALID_PHASE
    payload = np.ascontiguousarray(np.flipud(counts), dtype='>i4').tobytes()

    if hasattr(file, 'write'):
        file.write(header)
        file.write(payload)
    else:
        with open(file, 'wb') as fh:
            fh.write(header)
            fh.write(payload)


def write_zygo_ascii(file, phase, dx, wavelength=0.6328, intensity=None):
    """Write a Zygo ASCII interferogram file (phase nm, dx mm, wavelength um)."""
    if intensity is not None:
        raise NotImplementedError('writing of ASCII files with nonempty intensity not yet supported.')
    now = datetime.datetime.now()
    rows, cols = phase.shape
    q = '"'
    header = [
        'Zygo ASCII Data File - Format 2',
        '0 0 0 0 ' + now.strftime('"%a %b %d %H:%M:%S %Y').ljust(30) + q,
        '0 0 0 0 0 0',
        f'0 0 {cols} {rows}',
        q + ' ' * 81 + q,
        q + ' ' * 39 + q,
        q + ' ' * 39 + q,
        f'0 0.5 {wavelength * 1e-6} 0 1 0 {dx * 1e3} {int(now.timestamp())}',
        f'{cols} {rows} 0 0 0 0 ' + q + ' ' * 9 + q,
        '0 0 0 0 0 0 0 0 0 0',
        '1 1 20 2 0 0 0 0 0',
        '0 ' + q + ' ' * 12 + q,
        '1 0',
        q + ' ' * 7 + q,
        '#',
        '#',
    ]
    # encode to phase LSBs; the 0.5 scale and wavelength^2 factors mirror the
    # inverse of MetroPro's ASCII height decoding
    lsbs = np.asarray(phase, np.float64) * (ZYGO_PHASE_RES_FACTORS[1] / wavelength / wavelength / 0.5)
    lsbs[np.isnan(lsbs)] = ZYGO_INVALID_PHASE
    flat = lsbs.astype(np.int64).ravel()
    full = flat.size - flat.size % 10
    body = [' '.join(str(v) for v in flat[i:i + 10]) + ' '
            for i in range(0, full, 10)]
    body.append(' '.join(str(v) for v in flat[full:]))
    text = '\n'.join(header + body) + '\n#\n'
    if hasattr(file, 'write'):
        file.write(text)
    else:
        Path(file).write_text(text)


def read_zygo_datx(file):
    """Read a Zygo .datx (HDF5) file -> dict(phase [nm], intensity, meta).

    Invalid pixels become NaN and arrays are flipped so +y is up.
    """
    import h5py

    def first_dataset(group):
        return group[next(iter(group))]

    with h5py.File(file, 'r') as h5:
        try:
            raw = first_dataset(h5['Data']['Intensity'])[()]
            intensity = np.flipud(raw.astype(np.uint16))
        except (KeyError, OSError):
            intensity = None

        surf = first_dataset(h5['Data']['Surface'])
        invalid = surf.attrs['No Data'][0]
        wvl_nm = surf.attrs['Wavelength'][0] * 1e9
        unit = surf.attrs['Unit'][0]
        unit = unit.decode(ZYGO_ENC) if isinstance(unit, bytes) else unit
        phase = np.flipud(surf[()]).astype(np.float64)
        phase[phase >= invalid] = np.nan
        if unit == 'Fringes':
            phase = phase * (surf.attrs['Obliquity Factor']
                             * surf.attrs['Interferometric Scale Factor'] * wvl_nm)
        elif unit != 'NanoMeters':
            raise ValueError('datx file does not use a understood phase unit')

        meta = _datx_attr_dict(h5['Attributes'])
    return {'phase': phase, 'intensity': intensity, 'meta': meta}


def _datx_attr_dict(attr_group):
    """Flatten the last Attributes subgroup of a datx file to a clean dict."""
    attrs = attr_group[list(attr_group)[-1]].attrs
    skip = {'Property Bag List', 'Group Number', 'TextCount'}
    meta = {}
    for key, value in attrs.items():
        if key.endswith('Unit'):
            continue
        for prefix in ('Data Context.', 'Data Attributes.'):
            key = key.removeprefix(prefix)
        key = key.removesuffix('Value').removesuffix(':')
        if key == 'Resolution':
            key = 'Lateral Resolution'
        if key in skip:
            continue
        if value.dtype == object:
            value = value[0]
            if isinstance(value, bytes):
                value = value.decode(ZYGO_ENC)
        elif value.dtype in ('uint8', 'int32'):
            value = int(value[0])
        elif value.dtype == 'float64':
            value = float(value[0])
        else:
            continue
        meta[key] = value
    return meta


# ---------------------------------------------------------------------------
# MTF Mapper
# ---------------------------------------------------------------------------

def read_mtfmapper_sfr_single(file, pixel_pitch=None):
    """Read an MTF Mapper raw_sfr_values.txt (-f with --single-roi).

    Returns (frequencies, mtf).  Frequencies are cy/px, or cy/mm when
    pixel_pitch (um) is given.  The first value on the line is the edge angle
    and is discarded; MTF Mapper samples SFR on a fixed 1/64 cy/px comb.
    """
    text = file.read() if hasattr(file, 'read') else Path(file).read_text()
    tokens = text.splitlines()[0].split(' ')[:-1]
    sfr = np.array([float(t) for t in tokens[1:]])
    freqs = np.arange(sfr.size) / 64
    if pixel_pitch is not None:
        freqs = freqs * (1e3 / pixel_pitch)
    return freqs, sfr


# ---------------------------------------------------------------------------
# SigFit
# ---------------------------------------------------------------------------

_SIGFIT_HEAD = re.compile(
    r'SID=\s*(?P<sid>\d+)\s+Rnorm=\s*(?P<rnorm>\S+)\s+Type', re.S)
_SIGFIT_WVL = re.compile(r'WVL=\s*(?P<wvl>\S+)\s+(?P<unit>\S+)')


def read_sigfit_zernikes(file):
    """Read Zernike coefficients from a SigFit OUTCOF3 file.

    Returns {surface id: {'type', 'normed', 'wavelength', 'coefs', 'rnorm'}},
    coefficients scaled to the file's length unit (um).
    """
    text = Path(str(file)).read_text()
    out = {}
    for section in text.split('Surface')[1:]:
        sid, payload = _sigfit_zernike_section(section)
        out[sid] = payload
    return out


def _sigfit_zernike_section(section):
    lines = section.splitlines()
    head = _SIGFIT_HEAD.search(lines[0])
    wvl_m = _SIGFIT_WVL.search(lines[0])
    unit_scale = 25.4e3 if wvl_m.group('unit').lower() == 'in' else 1e3
    wavelength = float(wvl_m.group('wvl')) * unit_scale

    coefs = []
    tail = lines[4:-1] if lines[-1].strip() == '' else lines[4:len(lines) - 1]
    for row in tail:
        cells = row.split(',')
        value = cells[1].strip() if len(cells) > 1 else ''
        coefs.append(float(value) if value else 0.0)

    return int(head.group('sid')), {
        'type': 'Noll' if 'ZEMAX' in lines[2] else 'Fringe',
        'normed': 'RMS' in lines[2],
        'wavelength': wavelength,
        'coefs': np.asarray(coefs) * wavelength,
        'rnorm': float(head.group('rnorm')) * unit_scale / 1e3,
    }


def read_sigfit_rigidbody(file):
    """Read rigid-body perturbations from a SigFit sum1.csv.

    Returns {surface id: {'dx','dy','dz','rx','ry','rz','dR'}} in mm/deg.
    """
    file = str(file)
    head = Path(file).read_text().splitlines()
    unit_scale = 25.4 if '= in' in head[4] else 1
    table = np.genfromtxt(file, skip_header=7, delimiter=',')[:, 4:12]
    table[:, 1:] *= unit_scale
    keys = ('dx', 'dy', 'dz', 'rx', 'ry', 'rz', 'dR')
    return {int(row[0]): dict(zip(keys, row[1:])) for row in table}


# ---------------------------------------------------------------------------
# Code V
# ---------------------------------------------------------------------------

def write_codev_gridint(array, filename, comment='CV GRD generated by prysm_tpu',
                        typ='SUR', nnb=False):
    """Write a Code V grid INT file.  array in nm for SUR/WFR types."""
    typ = typ.upper()
    assert typ in ('SUR', 'WFR', 'FIL'), 'typ must be one of SUR, WFR, FIL'
    um = np.flipud(np.asarray(array, dtype=np.float64)) * 1e-3  # nm -> um
    assert um.ndim == 2, 'gridint files must be 2D arrays'

    dropped = np.isnan(um)
    lo, hi = np.nanmin(um), np.nanmax(um)
    # guard the negative-branch scale when the data never goes below ~0
    if lo > 0 or abs(lo) < np.finfo(um.dtype).eps:
        lo = 1
    ssz = min(-32767 / lo, 32767 / hi)
    quantized = np.around(np.where(dropped, 0, um * ssz)).astype(np.int16)
    quantized[dropped] = -32768

    rows, cols = quantized.shape
    nnb_tag = 'NNB ' if nnb else ''
    header = (f'{comment}\n'
              f'GRD {rows} {cols} {typ} WVL 1.0 {nnb_tag}SSZ {ssz} NDA -32768\n')
    # widest row length <= 585 that evenly divides the element count
    per_line = max(w for w in range(1, 586) if quantized.size % w == 0)
    table = quantized.ravel().reshape((per_line, quantized.size // per_line))
    np.savetxt(filename, table, fmt='%d', delimiter=' ', header=header, comments='')


def write_codev_zfr_int(coefs, filename, comment='CV ZFR generated by prysm_tpu',
                        SUR=True):
    """Write a Code V INT file of Fringe Zernike coefficients, in nm."""
    kind = 'SUR' if SUR else 'WFR'
    rows = '\n'.join(f'{c:.9f}' for c in coefs)
    Path(filename).write_text(
        f'{comment}\nZFR {len(coefs)} {kind} WVL 0.001 SSZ 1\n{rows}\n')


def read_codev_gridint(file):
    """Read a Code V grid INT file -> (array [nm], meta dict)."""
    lines = Path(file).expanduser().read_text().splitlines()
    content = [ln for ln in lines if not ln.lstrip().startswith('!')]
    if len(content) < 3:
        raise ValueError('CV INT file too short: need title, header, and data')
    title, header = content[0], content[1]

    fields = {}
    tokens = iter(header.split())
    for tok in tokens:
        tok = tok.upper()
        if tok in ('WVL', 'SSZ'):
            fields[tok] = float(next(tokens))
        elif tok == 'NDA':
            fields[tok] = int(next(tokens))
        elif tok == 'GRD':
            fields['rows'] = int(next(tokens))
            fields['cols'] = int(next(tokens))
        elif tok in ('SUR', 'WFR'):
            fields['meaning'] = 'surface error' if tok == 'SUR' else 'wavefront error'
        elif tok == 'NNB':
            pass
        else:
            raise ValueError(f'parsing CV INT header: token {tok} not understood')

    for need, msg in (('WVL', 'WVL'), ('NDA', 'NDA (grid files only)'),
                      ('rows', 'GRD'), ('SSZ', 'SSZ'), ('meaning', 'SUR or WFR')):
        if need not in fields:
            raise ValueError(f'CV INT header did not contain {msg}')

    raw = np.array(' '.join(content[2:]).split(), dtype=np.int64)
    nm = raw.astype(np.float64) * (1000 * fields['WVL'] / fields['SSZ'])
    nm[raw == fields['NDA']] = np.nan
    grid = np.flipud(nm.reshape((fields['rows'], fields['cols'])))
    return grid, {'title': title, 'wavelength': fields['WVL'],
                  'data meaning': fields['meaning']}


def _advance_to(line_iter, prefix, counter):
    """Consume lines until one starts with ``prefix``; returns (line, n read)."""
    n = counter
    for line in line_iter:
        n += 1
        stripped = line.lstrip()
        if stripped.startswith(prefix):
            return stripped, n
    raise ValueError(f'expected a line starting with {prefix!r}')


def read_codev_psf(fn, sep=','):
    """Read a Code V PSF buffer dump -> (dx [um], 2D array)."""
    with open(fn, 'r') as f:
        it = iter(f)
        first, skip = _advance_to(it, 'PSF data:', 0)
        spacing, skip = _advance_to(it, 'Grid spacing:', skip)
        cells = spacing.split(',')
        step, unit = float(cells[1]), cells[2].strip()
        if unit == 'IN.':
            step *= 25.4
        elif unit != 'MM.':
            raise ValueError(f'expected unit to be other mm or in, got {unit}')
        size_line, skip = _advance_to(it, 'Array Size:', skip)
        n = int(size_line.split(',')[1])
    grid = np.genfromtxt(fn, skip_header=skip, delimiter=sep)
    assert grid.shape == (n, n), 'array size must match header'
    return step * 1e3, grid


def read_codev_bsp(fn, sep=','):
    """Read a Code V BSP buffer dump -> ((dx, dy) um, (x, y) offset, array)."""
    with open(fn, 'r') as f:
        it = iter(f)
        _, skip = _advance_to(it, 'BSP data:', 0)
        off_line, skip = _advance_to(it, 'Offset of grid center', skip)
        offsets = [float(v) for v in off_line.split(':')[1].split(',')[1:-1]]
        spacing, skip = _advance_to(it, 'Grid spacing:', skip)
        cells = spacing.split(',')
        sx, unit, sy = float(cells[1]), cells[2].strip(), float(cells[3])
        if unit == 'in':
            sx, sy = sx * 25.4, sy * 25.4
        elif unit != 'mm':
            raise ValueError(f'expected unit to be other mm or in, got {unit}')
        size_line, skip = _advance_to(it, 'Array Size:', skip)
        shape = tuple(int(v) for v in size_line.split(',')[1:])
    grid = np.genfromtxt(fn, skip_header=skip, delimiter=sep)
    assert grid.shape == shape, 'array size must match header'
    return (sx * 1e3, sy * 1e3), offsets, grid
