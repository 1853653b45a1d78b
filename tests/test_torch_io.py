"""The port's io module against the JAX package's: the same bytes, and each reads the other's files.

Every writer is given the same data (and the same clock, frozen in both
modules) and must write the same bytes; every reader reads files written
by the other package, or fixtures written into ``tmp_path``, and must
return the same arrays (NaN where the other has NaN) and metadata.
"""
import datetime

import numpy as np
import pytest

from prysm_tpu import io as jio

from prysm_tpu_torch import io as tio

WRITE_BOTH = pytest.mark.parametrize('writer,reader', [(tio, jio), (jio, tio)],
                                     ids=['port-writes', 'jax-writes'])


class _FrozenClock:
    """Stands in for the datetime module: now() is one fixed instant."""

    class datetime:
        @staticmethod
        def now():
            return datetime.datetime(2026, 3, 4, 5, 6, 7)


@pytest.fixture(autouse=True)
def _frozen_clock(monkeypatch):
    monkeypatch.setattr(tio, 'datetime', _FrozenClock)
    monkeypatch.setattr(jio, 'datetime', _FrozenClock)


def _phase(shape=(12, 17), seed=0):
    z = np.random.default_rng(seed).normal(scale=40.0, size=shape)
    z[2, 3] = np.nan
    z[7, :4] = np.nan
    return z


def _same(a, b):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.nan_to_num(a), np.nan_to_num(b))


def test_zygo_header_layout_and_packing_match():
    assert tio._ZYGO_FIELDS == jio._ZYGO_FIELDS
    over = {'cn_width': 5, 'cn_height': 7, 'comment': 'a part', 'wavelength': 5.5e-7}
    head = tio._pack_zygo_header(over)
    assert head == jio._pack_zygo_header(over)
    assert tio.read_zygo_metadata(head) == jio.read_zygo_metadata(head)


def test_zygo_dat_writers_write_the_same_bytes(tmp_path):
    phase = _phase()
    tio.write_zygo_dat(tmp_path / 'port.dat', phase, dx=0.05, wavelength=0.6328)
    jio.write_zygo_dat(tmp_path / 'jax.dat', phase, dx=0.05, wavelength=0.6328)
    assert (tmp_path / 'port.dat').read_bytes() == (tmp_path / 'jax.dat').read_bytes()


@WRITE_BOTH
@pytest.mark.parametrize('action', ['first', 'avg', 'last'])
def test_zygo_dat_read_by_the_other(tmp_path, writer, reader, action):
    path = tmp_path / 'map.dat'
    writer.write_zygo_dat(path, _phase(seed=1), dx=0.1, wavelength=0.55)
    got = reader.read_zygo_dat(path, multi_intensity_action=action)
    ref = writer.read_zygo_dat(str(path), multi_intensity_action=action)
    _same(got['phase'], ref['phase'])
    np.testing.assert_array_equal(got['intensity'], ref['intensity'])
    assert got['meta'] == ref['meta']


def test_zygo_dat_reader_takes_a_file_object_and_rejects_a_bad_action(tmp_path):
    path = tmp_path / 'map.dat'
    tio.write_zygo_dat(path, _phase(seed=2), dx=0.1)
    with open(path, 'rb') as fh:
        got = tio.read_zygo_dat(fh)
    _same(got['phase'], jio.read_zygo_dat(path)['phase'])
    with pytest.raises(ValueError, match='multi_intensity_action'):
        tio.read_zygo_dat(path, multi_intensity_action='median')
    with pytest.raises(NotImplementedError):
        tio.write_zygo_dat(path, _phase(), dx=0.1, intensity=np.ones((2, 2)))


def test_truncated_zygo_dat_reads_alike(tmp_path):
    path = tmp_path / 'cut.dat'
    jio.write_zygo_dat(path, _phase(seed=3), dx=0.1)
    data = path.read_bytes()
    path.write_bytes(data[:-37])
    with pytest.warns(UserWarning, match='truncated'):
        got = tio.read_zygo_dat(path)
    with pytest.warns(UserWarning, match='truncated'):
        ref = jio.read_zygo_dat(path)
    _same(got['phase'], ref['phase'])
    assert np.isnan(got['phase'][0, -10:]).all()


def test_zygo_ascii_writers_write_the_same_text(tmp_path):
    phase = _phase((13, 21), seed=4) / 1e3
    tio.write_zygo_ascii(tmp_path / 'port.asc', phase, dx=0.02, wavelength=0.6328)
    jio.write_zygo_ascii(tmp_path / 'jax.asc', phase, dx=0.02, wavelength=0.6328)
    assert (tmp_path / 'port.asc').read_text() == (tmp_path / 'jax.asc').read_text()


def _write_datx(path, unit):
    h5py = pytest.importorskip('h5py')
    rng = np.random.default_rng(5)
    surf = rng.normal(size=(9, 11))
    surf[1, 2] = 1e38
    with h5py.File(path, 'w') as h5:
        inten = h5.create_group('Data/Intensity')
        inten.create_dataset('{0}', data=rng.integers(0, 4000, (9, 11)).astype(np.int32))
        ds = h5.create_group('Data/Surface').create_dataset('{1}', data=surf)
        ds.attrs['No Data'] = np.array([1e38])
        ds.attrs['Wavelength'] = np.array([632.8e-9])
        ds.attrs['Unit'] = np.array([unit.encode()], dtype=object)
        ds.attrs['Obliquity Factor'] = np.array([1.0])
        ds.attrs['Interferometric Scale Factor'] = np.array([0.5])
        grp = h5.create_group('Attributes/{2}')
        grp.attrs['Data Context.Data Attributes.Resolution:Value'] = np.array([1.2e-4])
        grp.attrs['Data Context.Data Attributes.Resolution:Unit'] = np.array([b'Meters'],
                                                                             dtype=object)
        grp.attrs['Data Context.Lens:Value'] = np.array([b'1X'], dtype=object)
        grp.attrs['Data Context.Data Attributes.Camera Width:Value'] = np.array([11],
                                                                                dtype=np.int32)
        grp.attrs['Group Number'] = np.array([3], dtype=np.int32)
        grp.attrs['Skipped'] = np.array([1.5], dtype=np.float32)


@pytest.mark.parametrize('unit', ['Fringes', 'NanoMeters'])
def test_zygo_datx_read_alike(tmp_path, unit):
    path = tmp_path / 'map.datx'
    _write_datx(path, unit)
    got, ref = tio.read_zygo_datx(path), jio.read_zygo_datx(path)
    _same(got['phase'], ref['phase'])
    np.testing.assert_array_equal(got['intensity'], ref['intensity'])
    assert got['meta'] == ref['meta']
    assert got['meta']['Lateral Resolution'] == 1.2e-4


def test_zygo_datx_rejects_an_unknown_unit(tmp_path):
    path = tmp_path / 'map.datx'
    _write_datx(path, 'Waves')
    with pytest.raises(ValueError, match='phase unit'):
        tio.read_zygo_datx(path)


def test_mtfmapper_reader_matches(tmp_path):
    path = tmp_path / 'raw_sfr_values.txt'
    values = np.linspace(1.0, 0.0, 65)
    path.write_text('4.25 ' + ' '.join(f'{v:.6f}' for v in values) + ' \n')
    for pitch in (None, 5.5):
        for a, b in zip(tio.read_mtfmapper_sfr_single(path, pitch),
                        jio.read_mtfmapper_sfr_single(path, pitch)):
            np.testing.assert_array_equal(a, b)
    with open(path) as fh:
        np.testing.assert_array_equal(tio.read_mtfmapper_sfr_single(fh)[1], values.round(6))


def _sigfit_section(sid, unit, kind, coefs):
    rows = '\n'.join(f'{i + 1:4d}, {c}' for i, c in enumerate(coefs))
    return (f'Surface  SID=  {sid}  Rnorm=  1.25  Type=  1  WVL=  6.328E-04 {unit}\n'
            '  header line\n'
            f'  {kind}\n'
            '  term, value\n'
            f'{rows}\n')


def test_sigfit_readers_match(tmp_path):
    zern = tmp_path / 'OUTCOF3'
    zern.write_text('SigFit results\n'
                    + _sigfit_section(3, 'mm', 'FRINGE RMS Zernikes', [0.1, -0.2, '', 0.05])
                    + _sigfit_section(7, 'in', 'ZEMAX standard', [1e-3, 2e-3, 3e-3]))
    got, ref = tio.read_sigfit_zernikes(zern), jio.read_sigfit_zernikes(zern)
    assert got.keys() == ref.keys() == {3, 7}
    for sid in got:
        np.testing.assert_array_equal(got[sid].pop('coefs'), ref[sid].pop('coefs'))
        assert got[sid] == ref[sid]
    rigid = tmp_path / 'sum1.csv'
    head = ['title', 'a', 'b', 'c', 'units = in', 'd', 'e']
    body = [','.join(['x'] * 4 + [str(s)] + [f'{0.1 * s + k:.3f}' for k in range(7)])
            for s in (2, 5)]
    rigid.write_text('\n'.join(head + body) + '\n')
    got, ref = tio.read_sigfit_rigidbody(rigid), jio.read_sigfit_rigidbody(rigid)
    assert got.keys() == ref.keys() == {2, 5}
    for sid in got:
        assert got[sid] == ref[sid]


@pytest.mark.parametrize('typ,nnb', [('SUR', False), ('WFR', True)])
def test_codev_gridint_writers_match_and_read_back(tmp_path, typ, nnb):
    grid = _phase((10, 12), seed=6)
    tio.write_codev_gridint(grid, tmp_path / 'port.int', typ=typ, nnb=nnb)
    jio.write_codev_gridint(grid, tmp_path / 'jax.int', typ=typ, nnb=nnb)
    assert (tmp_path / 'port.int').read_text() == (tmp_path / 'jax.int').read_text()
    got = tio.read_codev_gridint(tmp_path / 'jax.int')
    ref = jio.read_codev_gridint(tmp_path / 'port.int')
    _same(got[0], ref[0])
    assert got[1] == ref[1]


def test_codev_gridint_positive_data_and_bad_headers(tmp_path):
    grid = np.abs(_phase((8, 6), seed=7)) + 5
    tio.write_codev_gridint(grid, tmp_path / 'port.int')
    jio.write_codev_gridint(grid, tmp_path / 'jax.int')
    assert (tmp_path / 'port.int').read_text() == (tmp_path / 'jax.int').read_text()
    bad = tmp_path / 'bad.int'
    bad.write_text('title\nGRD 2 2 SUR WVL 1.0 XYZ 3\n1 2 3 4\n')
    with pytest.raises(ValueError, match='XYZ'):
        tio.read_codev_gridint(bad)
    bad.write_text('title\nGRD 2 2 SUR WVL 1.0 SSZ 3\n1 2 3 4\n')
    with pytest.raises(ValueError, match='NDA'):
        tio.read_codev_gridint(bad)


def test_codev_zfr_int_writers_match(tmp_path):
    coefs = np.random.default_rng(8).normal(size=9)
    for sur in (True, False):
        tio.write_codev_zfr_int(coefs, tmp_path / 'port.int', SUR=sur)
        jio.write_codev_zfr_int(coefs, tmp_path / 'jax.int', SUR=sur)
        assert (tmp_path / 'port.int').read_text() == (tmp_path / 'jax.int').read_text()


@pytest.mark.parametrize('unit,scale', [('MM.', 1.0), ('IN.', 25.4)])
def test_codev_psf_reader_matches(tmp_path, unit, scale):
    path = tmp_path / 'psf.txt'
    grid = np.random.default_rng(9).uniform(size=(4, 4))
    rows = '\n'.join(','.join(f'{v:.8f}' for v in row) for row in grid)
    path.write_text(f'Code V buffer\nPSF data:\nGrid spacing:, 0.0015, {unit}\n'
                    f'Array Size:, 4\n{rows}\n')
    (dx, a), (jdx, b) = tio.read_codev_psf(path), jio.read_codev_psf(path)
    assert dx == jdx == pytest.approx(1.5 * scale)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('unit', ['mm', 'in'])
def test_codev_bsp_reader_matches(tmp_path, unit):
    path = tmp_path / 'bsp.txt'
    grid = np.random.default_rng(10).uniform(size=(3, 5))
    rows = '\n'.join(','.join(f'{v:.8f}' for v in row) for row in grid)
    path.write_text(f'BSP data:\nOffset of grid center: , 0.25, -0.5,\n'
                    f'Grid spacing:, 0.002, {unit}, 0.003\nArray Size:, 3, 5\n{rows}\n')
    got, ref = tio.read_codev_bsp(path), jio.read_codev_bsp(path)
    assert got[0] == ref[0] and got[1] == ref[1] == [0.25, -0.5]
    np.testing.assert_array_equal(got[2], ref[2])
    bad = tmp_path / 'bad.txt'
    bad.write_text(path.read_text().replace(f', {unit},', ', ft,'))
    with pytest.raises(ValueError, match='unit'):
        tio.read_codev_bsp(bad)
