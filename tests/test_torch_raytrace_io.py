"""The port's Zemax / Code V prescription IO against the JAX package's.

Host text code in both packages.  Every deck below (the fixtures of
``tests/test_raytracing_io.py`` and the shape, unit, glass, field and coordinate-break
variants of ``test_raytracing_io_depth.py``) is read by both packages' readers: the
same system metadata, the same compiled surfaces (type, vertex, rotation, shape
parameters, index at each wavelength) and the same landing points of a traced bundle
within 1e-12 mm.  The writers' text is string-equal to the JAX package's for every
writable system, each package reads the other's text into the same lens, and both
refuse the same unwritable systems with the same message.  Glasses come from a
catalog built in the test (model glasses), never from a database outside the repo.
"""
import numpy as np
import pytest
import torch

import prysm_tpu.x.materials as jmat
import prysm_tpu.x.raytracing as jrt
from prysm_tpu.x.raytracing import io as jio
from prysm_tpu.x.raytracing import lensdata as jlensdata

import prysm_tpu_torch.x.materials as tmat
import prysm_tpu_torch.x.raytracing as trt
from prysm_tpu_torch import steps
from prysm_tpu_torch.conf import config
from prysm_tpu_torch.x.raytracing import io as tio
from prysm_tpu_torch.x.raytracing import lensdata as tlensdata

torch.set_num_threads(2)
LANDING_BAR = 1e-12
PACKAGES = {'jax': (jrt, jmat, jio, jlensdata), 'torch': (trt, tmat, tio, tlensdata)}


@pytest.fixture(autouse=True)
def f64_on_cpu(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


def _host(a):
    if a is None:
        return None
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def catalog(pkg):
    """The decks' glasses (the fixtures' N-BK7 / N-SF5 and cfg6's), as model glasses."""
    mat = PACKAGES[pkg][1]
    glasses = ([mat.model_glass(1.5168, 64.17, name='N-BK7'),
                mat.model_glass(1.6727, 32.2, name='N-SF5'),
                mat.model_glass(1.6779, 55.2, name='LAF3')]
               + [mat.model_glass(nd, vd, name=name) for nd, vd, name in steps.CFG6_GLASSES])
    return mat.Catalog.from_materials(glasses, namespace='SCHOTT')


ZMX = """VERS 100000 0
MODE SEQ
NAME "test doublet"
UNIT MM
ENPD 20
STOP 2
WAVM 1 0.4861 1
WAVM 2 0.5876 2
WAVM 3 0.6563 1
PWAV 2
FTYP 0
XFLN 0 0
YFLN 0 2
SURF 0
  TYPE STANDARD
  CURV 0.0
  DISZ INFINITY
SURF 1
  TYPE STANDARD
  CURV 0.01612903
  DISZ 6.0
  GLAS N-BK7
  DIAM 11
SURF 2
  TYPE EVENASPH
  CURV -0.022222
  CONI -0.5
  PARM 1 1e-06
  DISZ 3.0
  GLAS N-SF5
SURF 3
  TYPE STANDARD
  CURV -0.0078125
  DISZ 95.6
SURF 4
  TYPE STANDARD
  CURV 0.0
  DISZ 0.0
"""

SEQ = """LEN
CUM
DIM M
TITLE 'seq triplet'
WL 486.1 587.6 656.3
REF 2
EPD 20
XAN 0 0
YAN 0 2
SO ; THI 1E10
S ; CUY 0.016129 ; THI 6 ; GLA NBK7_SCHOTT ; CAO 11
STO
S ; CUY -0.022222 ; K -0.5 ; THI 3 ; GLA 673322
S ; CUY -0.0078125 ; THI 95.6
SI
GO
"""

SEQ_MIRROR = """LEN
CUM
DIM M
WL 632.8
SO ; THI 1E10
S ; CUY -0.005 ; THI -100 ; GLA REFL ; CAO 50
SI
GO
"""


def zmx_deck(surf_lines, unit='MM', header='ENPD 8\n'):
    head = f'VERS 100000 0\nMODE SEQ\nUNIT {unit}\nWAVL 0.55\n{header}'
    return (head + 'SURF 0\n  TYPE STANDARD\n  DISZ INFINITY\n' + surf_lines
            + 'SURF 99\n  TYPE STANDARD\n  DISZ 0.0\n')


def seq_deck(body, header='LEN\nCUM\nDIM M\nWL 550\nEPD 10\n', obj='SO ; THI 1E10\n'):
    return header + obj + body + 'SI\nGO\n'


DECKS = {
    'zmx-fixture': ('zmx', ZMX),
    'zmx-cm': ('zmx', zmx_deck('SURF 1\n  TYPE STANDARD\n  CURV 0.2\n  DISZ 0.5\n'
                               '  GLAS N-BK7\n  DIAM 0.8\nSURF 2\n  TYPE STANDARD\n'
                               '  CURV -0.1\n  DISZ 5\n', unit='CM', header='ENPD 1.0\n')),
    'zmx-meter': ('zmx', zmx_deck('SURF 1\n  TYPE STANDARD\n  CURV 10.0\n  DISZ 0.005\n'
                                  '  GLAS N-SF5\nSURF 2\n  TYPE STANDARD\n  DISZ 0.05\n',
                                  unit='METER', header='ENPD 0.008\n')),
    'zmx-coordbreak': ('zmx', zmx_deck(
        'SURF 1\n  TYPE STANDARD\n  CURV 0.02\n  DISZ 4\n  GLAS N-BK7\n'
        'SURF 2\n  TYPE COORDBRK\n  DISZ 0.0\n  PARM 1 0.1\n  PARM 2 -0.2\n  PARM 3 0.5\n'
        'SURF 3\n  TYPE STANDARD\n  CURV -0.02\n  DISZ 40\n')),
    'zmx-evenasph': ('zmx', zmx_deck('SURF 1\n  TYPE EVENASPH\n  CURV 0.01\n  CONI -0.5\n'
                                     '  PARM 1 1e-06\n  PARM 2 -2e-09\n  DISZ 5.0\n'
                                     '  GLAS N-BK7\nSURF 2\n  TYPE STANDARD\n  DISZ 90\n')),
    'zmx-biconic': ('zmx', zmx_deck('SURF 1\n  TYPE BICONICX\n  CURV 0.01\n  CONI -0.5\n'
                                    '  PARM 1 0.02\n  PARM 2 -1.0\n  DISZ 5.0\n  GLAS N-BK7\n'
                                    'SURF 2\n  TYPE STANDARD\n  DISZ 40\n')),
    'zmx-toroid': ('zmx', zmx_deck('SURF 1\n  TYPE TOROIDAL\n  CURV 0.01\n  CONI -0.5\n'
                                   '  PARM 1 200.0\n  DISZ 5.0\n  GLAS N-BK7\n'
                                   'SURF 2\n  TYPE STANDARD\n  DISZ 40\n')),
    'zmx-zernsag': ('zmx', zmx_deck('SURF 1\n  TYPE ZERNSAG\n  CURV 0.01\n  DISZ 5.0\n'
                                    '  PARM 1 10.0\n  XDAT 1 0.0\n  XDAT 2 0.001\n'
                                    '  XDAT 4 -0.002\n  GLAS N-BK7\n'
                                    'SURF 2\n  TYPE STANDARD\n  DISZ 40\n')),
    'zmx-xypoly': ('zmx', zmx_deck('SURF 1\n  TYPE XYPOLY\n  CURV 0.01\n  DISZ 5.0\n'
                                   '  PARM 1 10.0\n  XDAT 2 0.01\n  XDAT 5 -0.003\n'
                                   '  GLAS N-BK7\nSURF 2\n  TYPE STANDARD\n  DISZ 40\n')),
    'zmx-parabola': ('zmx', zmx_deck('SURF 1\n  TYPE STANDARD\n  CURV -0.005\n  CONI -1.0\n'
                                     '  DISZ -100.0\n  GLAS MIRROR\n')),
    'zmx-object-height': ('zmx', 'VERS 100000 0\nMODE SEQ\nUNIT MM\nWAVL 0.55\nENPD 4\n'
                          'STOP 1\n'
                          'FTYP 1 0 0 0\nXFLN 0.0 0.0\nYFLN 0.0 2.0\n'
                          'SURF 0\n  TYPE STANDARD\n  DISZ 100.0\n'
                          'SURF 1\n  TYPE STANDARD\n  CURV 0.02\n  DISZ 4\n  GLAS N-BK7\n'
                          'SURF 2\n  TYPE STANDARD\n  CURV -0.02\n  DISZ 60\n'
                          'SURF 3\n  TYPE STANDARD\n  DISZ 0.0\n'),
    'seq-fixture': ('seq', SEQ),
    'seq-mirror': ('seq', SEQ_MIRROR),
    'seq-cm': ('seq', seq_deck('S ; CUY 0.2 ; THI 0.5 ; CAO 0.2 ; GLA NBK7_SCHOTT\n'
                               'S ; CUY -0.1 ; THI 5\n',
                               header='LEN\nCUM\nDIM C\nWL 550\nEPD 0.5\n')),
    'seq-cir-sto': ('seq', seq_deck('S ; CUY 0.01 ; THI 5 ; CIR 8 ; GLA NBK7_SCHOTT\n'
                                    'STO\nS ; CUY -0.01 ; THI 50\n')),
    'seq-asphere': ('seq', seq_deck('S ; CUY 0.01 ; K -0.5 ; A 1e-6 ; B -2e-9 ; C 1e-12 ; '
                                    'THI 5 ; GLA NBK7_SCHOTT\nS ; CUY -0.01 ; THI 50\n')),
    'seq-biconic': ('seq', seq_deck('S ; CUY 0.01 ; CUX 0.02 ; K -0.5 ; KX -1.0 ; THI 5 ; '
                                    'GLA NBK7_SCHOTT\nS ; CUY -0.01 ; THI 50\n')),
    'seq-decentered': ('seq', seq_deck('S ; CUY 0.01 ; THI 5 ; XDE 0.1 ; YDE 0.2 ; '
                                       'GLA NBK7_SCHOTT\nS ; CUY -0.01 ; THI 50\n')),
    'seq-rotated': ('seq', seq_deck('S ; CUY 0.01 ; THI 5 ; ADE 1.0 ; GLA NBK7_SCHOTT\n'
                                    'S ; CUY -0.01 ; THI 50\n')),
    'seq-dar': ('seq', seq_deck('S ; CUY 0.01 ; THI 5 ; DAR ; YDE 0.5 ; GLA NBK7_SCHOTT\n'
                                'S ; CUY -0.01 ; THI 50\n')),
    'seq-positional': ('seq', seq_deck('S 100.0 5.0 NBK7_SCHOTT\nS -200.0 50.0\n')),
    'seq-six-digit-glass': ('seq', seq_deck('S ; CUY 0.01 ; THI 5 ; GLA 658327\n'
                                            'S ; CUY -0.01 ; THI 50\n')),
    'seq-dotted-glass': ('seq', seq_deck('S ; CUY 0.01 ; THI 5 ; GLA 658000.327000\n'
                                         'S ; CUY -0.01 ; THI 50\n')),
    'seq-colon-glass': ('seq', seq_deck('S ; CUY 0.01 ; THI 5 ; GLA 1.658:32.7\n'
                                        'S ; CUY -0.01 ; THI 50\n')),
    'seq-vendor-glass': ('seq', seq_deck('S ; CUY 0.01 ; THI 5 ; GLA LAF3_SCHOTT\n'
                                         'S ; CUY -0.01 ; THI 50\n')),
    'seq-fno-wtw': ('seq', seq_deck('S ; CUY 0.01 ; THI 5 ; GLA NBK7_SCHOTT\n'
                                    'S ; CUY -0.01 ; THI 50\n',
                                    header='LEN\nCUM\nDIM M\nWL 486.1 587.6\nWTW 1 3\n'
                                           'REF 2\nFNO 5\nYAN 0 1 2\n')),
    'seq-vignetting': ('seq', seq_deck('S ; CUY 0.01 ; THI 5 ; GLA NBK7_SCHOTT\n'
                                       'S ; CUY -0.01 ; THI 50\n',
                                       header='LEN\nCUM\nDIM M\nWL 550\nEPD 10\n'
                                              'YAN 0 3\nVUY 0 0.2\nVLY 0 0.1\n')),
}


def read(pkg, fmt, text):
    io = PACKAGES[pkg][2]
    reader = io.read_zmx if fmt == 'zmx' else io.read_seq
    return reader(text, _is_text=True, database=catalog(pkg))


def metadata(system):
    ap = system.aperture
    fields = [(f.hx, f.hy, f.kind, getattr(f, 'unit', None), f.object_z,
               None if f.vignetting is None else dict(f.vignetting)) for f in system.fields]
    return (system.stop_index, list(system.wavelengths), list(system.weights),
            system.reference, system.title, None if ap is None else (ap.mode, ap.value),
            fields, system.ray_aiming)


def surfaces(system):
    """(typ, P, R, shape params, index at each wavelength) of each compiled surface."""
    out = []
    for s in system.to_surfaces():
        params = {k: _host(v) for k, v in (getattr(s, 'params', None) or {}).items()}
        n = (None if s.material is None
             else [float(_host(s.material.n(w))) for w in system.wavelengths])
        out.append((s.typ, _host(s.P).astype(float), _host(s.R), params, n))
    return out


def _same_surfaces(a, b):
    assert len(a) == len(b)
    for (ta, Pa, Ra, pa, na), (tb, Pb, Rb, pb, nb) in zip(a, b):
        assert ta == tb
        np.testing.assert_allclose(Pa, Pb, rtol=0, atol=1e-14)
        assert (Ra is None) == (Rb is None)
        if Ra is not None:
            np.testing.assert_allclose(Ra, Rb, rtol=0, atol=1e-15)
        assert sorted(pa) == sorted(pb)
        for k in pa:
            np.testing.assert_allclose(np.asarray(pa[k], float), np.asarray(pb[k], float),
                                       rtol=1e-15, atol=0)
        assert na == nb


@pytest.mark.parametrize('deck', DECKS)
def test_readers_agree(deck):
    fmt, text = DECKS[deck]
    j, t = read('jax', fmt, text), read('torch', fmt, text)
    assert metadata(t) == metadata(j)
    _same_surfaces(surfaces(t), surfaces(j))
    field = j.field(len(j.fields) - 1) if len(j.fields) else jrt.Field(0.0, 0.0)
    epd = None if j.aperture is not None else 20.0
    P, S = (np.asarray(a) for a in jrt.launch(j, field, j.wavelength(), jrt.Sampling.hex(3),
                                              epd=epd))
    jl = np.asarray(jrt.raytrace(j.to_surfaces(), P, S, j.wavelength()).P[-1])
    tl = trt.raytrace(t.to_surfaces(), P, S, t.wavelength()).P[-1].numpy()
    np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))
    assert np.isfinite(jl).any() and float(np.nanmax(np.abs(tl - jl))) <= LANDING_BAR


def _cfg6(pkg, design=False):
    rt, mat, _, lensdata = PACKAGES[pkg]
    lens = rt.LensData()
    media = [mat.model_glass(nd, vd, name=name) for nd, vd, name in steps.CFG6_GLASSES]
    for c, t, m in zip(steps.CFG6_CURVATURES, steps.CFG6_THICKNESSES, media + [mat.air]):
        lens.add(rt.Sphere(c), thickness=t, material=m)
    system = rt.OpticalSystem(lens, aperture=rt.ApertureSpec.epd(steps.CFG6_EPD),
                              fields=list(steps.CFG6_FIELDS), wavelengths=[steps.WVL],
                              stop_index=steps.CFG6_STOP)
    if design:
        system.lens.rows.insert(steps.DESIGN_DECENTRE_ROW, lensdata.CoordBreak())
    return system


def _fold(pkg):
    rt, mat, _, _ = PACKAGES[pkg]
    lens = rt.LensData()
    lens.add(rt.Sphere(-1 / 200.0), thickness=100.0, material=mat.MIRROR, aperture=40.0)
    return rt.OpticalSystem(lens, aperture=60.0, wavelengths=[0.6328], stop_index=1)


def _singlet(pkg, finite=False):
    rt, mat, _, lensdata = PACKAGES[pkg]
    lens = rt.LensData()
    if finite:
        lens.object_row.thickness = 250.0
    bk7 = catalog(pkg)['N-BK7']
    lens.add(rt.Conic(1 / 50.0, -0.3), thickness=5.0, material=bk7, aperture=12.0)
    lens.add_coordbreak(decenter=(0.0, 0.2, 0.0), tilt=(0.5, 0.0, 0.0), kind='basic')
    lens.add(rt.Conic(-1 / 60.0, 0.0), thickness=70.0, material=mat.air)
    fields = ([rt.Field(0.0, 0.0, kind='height', object_z=-250.0),
               rt.Field(0.0, 2.0, kind='height', object_z=-250.0)] if finite else [0.0, 1.5])
    return rt.OpticalSystem(lens, aperture=rt.ApertureSpec.epd(10.0), fields=fields,
                            wavelengths=[0.4861, 0.5876, 0.6563], weights=[1.0, 2.0, 1.0],
                            stop_index=1, title='singlet')


SYSTEMS = {
    'cfg6': _cfg6,
    'cfg6-design': lambda pkg: _cfg6(pkg, design=True),
    'fold': _fold,
    'singlet-coordbreak': _singlet,
    'singlet-finite': lambda pkg: _singlet(pkg, finite=True),
    'zmx-cm': lambda pkg: read(pkg, *DECKS['zmx-cm']),
    'seq-cir-sto': lambda pkg: read(pkg, *DECKS['seq-cir-sto']),
}
WRITERS = ('zmx', 'seq')
# write_seq takes angle fields only
READABLE = [(name, fmt) for name in SYSTEMS for fmt in WRITERS
            if (name, fmt) != ('singlet-finite', 'seq')]


def _write(pkg, fmt, system):
    io = PACKAGES[pkg][2]
    return (io.write_zmx if fmt == 'zmx' else io.write_seq)(system)


def _outcome(pkg, fmt, system):
    try:
        return _write(pkg, fmt, system)
    except (NotImplementedError, ValueError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize('fmt', WRITERS)
@pytest.mark.parametrize('name', SYSTEMS)
def test_writers_are_string_equal(name, fmt):
    t = _outcome('torch', fmt, SYSTEMS[name]('torch'))
    j = _outcome('jax', fmt, SYSTEMS[name]('jax'))
    assert t == j


@pytest.mark.parametrize('name, fmt', READABLE)
def test_each_reads_the_others_text(name, fmt):
    texts = {pkg: _write(pkg, fmt, SYSTEMS[name](pkg)) for pkg in PACKAGES}
    by_torch = read('torch', fmt, texts['jax'])
    by_jax = read('jax', fmt, texts['torch'])
    assert metadata(by_torch) == metadata(by_jax)
    _same_surfaces(surfaces(by_torch), surfaces(by_jax))
    assert _write('torch', fmt, by_torch) == texts['jax']


@pytest.mark.parametrize('name', ('zmx-fixture', 'zmx-biconic', 'seq-asphere'))
def test_unwritable_shapes_are_refused_alike(name):
    fmt, text = DECKS[name]
    for writer in WRITERS:
        t = _outcome('torch', writer, read('torch', fmt, text))
        j = _outcome('jax', writer, read('jax', fmt, text))
        assert not isinstance(t, str) and t == j


@pytest.mark.parametrize('text, match', [
    (ZMX.replace('UNIT MM', 'UNIT FURLONG'), 'unit'),
    (zmx_deck('SURF 1\n  TYPE GRINSUR\n  DISZ 5.0\n'), None),
    (zmx_deck('SURF 1\n  TYPE STANDARD\n  DISZ 1.0\n', header='FTYP 2 0 0 0\nXFLN 1.0\n'
              'YFLN 0.0\n'), 'image-height'),
    ('', None)])
def test_zmx_reader_refuses_alike(text, match):
    errors = {}
    for pkg in PACKAGES:
        with pytest.raises((ValueError, NotImplementedError), match=match) as info:
            read(pkg, 'zmx', text)
        errors[pkg] = (type(info.value).__name__, str(info.value))
    assert errors['torch'] == errors['jax']


def test_readers_take_a_path(tmp_path):
    path = tmp_path / 'lens.zmx'
    path.write_text(DECKS['zmx-evenasph'][1])
    t = tio.read_zmx(str(path), database=catalog('torch'))
    j = jio.read_zmx(str(path), database=catalog('jax'))
    _same_surfaces(surfaces(t), surfaces(j))


def test_surface_specs_build_alike():
    from prysm_tpu.x.raytracing.io import _surface_spec as jspec
    from prysm_tpu_torch.x.raytracing.io import _surface_spec as tspec
    for kind, params in (('conic', {'c': 0.02, 'k': -1.0}),
                         ('even_asphere', {'c': 0.01, 'k': 0.0, 'coefs': (1e-6, -2e-9)}),
                         ('biconic', {'c_x': 0.01, 'c_y': 0.02, 'k_x': -0.5, 'k_y': 0.0})):
        t = tspec.build_shape(tspec.make_surface_spec(kind, 'refr', None, params, 10.0))
        j = jspec.build_shape(jspec.make_surface_spec(kind, 'refr', None, params, 10.0))
        assert type(t).__name__ == type(j).__name__
        x = np.linspace(-3.0, 3.0, 7)
        y = x[::-1].copy()
        np.testing.assert_allclose(_host(t.sag(torch.as_tensor(x), torch.as_tensor(y))),
                                   np.asarray(j.sag(x, y)), rtol=1e-14, atol=1e-16)
