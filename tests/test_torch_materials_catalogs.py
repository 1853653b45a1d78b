"""The port's tabulated, CHARMS, catalog, registry, transform, infrared, AGF,
refractiveindex.info and fitted materials against the JAX package.

Host numpy (and SciPy) on both sides, so values must agree to 1e-14
relative, most of them to the last bit.  Both packages build the same
objects from the same inputs; the AGF catalogs and refractiveindex.info
databases are written into ``tmp_path`` (the JAX suite's AGF fixtures live
outside the repo), and no test reaches ``rii._fetch_database``: the default
catalog's folder is patched to a ``tmp_path`` database and the fetch to
raise.
"""
import importlib
import textwrap

import numpy as np
import pytest
import torch

import prysm_tpu.x.materials as jmat
from prysm_tpu.x.materials import rii as jrii
import prysm_tpu_torch.x.materials as tmat
from prysm_tpu_torch.conf import config
from prysm_tpu_torch.x.materials import rii as trii

# the packages export a function named like the module: import the modules by path
jlookup = importlib.import_module('prysm_tpu.x.materials.lookup')
tlookup = importlib.import_module('prysm_tpu_torch.x.materials.lookup')

BAR = 1e-14

AGF_TEXT = """! fabricated test catalog
CC test comment
NM TESTBK7 2 0 1.5168 64.17 0 0
CD 1.03961212 0.00600069867 0.231792344 0.0200179144 1.01046945 103.560653
LD 0.3 2.5
TD 1e-6 1e-8 0 0 0 0 20
NM SIMPLE 1 0 1.5 60 0 0
CD 2.25 0.0 0.01 0.0 0.0 0.0
LD 0.4 1.0
NM HIK13 13 0 1.5827 59.3 0 0
CD 2.45448839 -0.00867148963 -0.00010471524 0.0176039752 0.000154610243 0.0000559918259 -0.00000501297284 0.00000031755799 0 0
LD 0.36 1.5
"""

RII_CATALOG = """\
- SHELF: vendor
  name: vendor
  content:
    - DIVIDER: "schott"
    - BOOK: SCHOTT-optical
      content:
        - PAGE: N-BK7
          data: vendorpages/N-BK7.yml
- SHELF: generic
  content:
    - BOOK: BK7
      content:
        - PAGE: N-BK7
          data: genericbook/N-BK7.yml
- SHELF: oxides
  content:
    - BOOK: SiO2
      content:
        - PAGE: Malitson
          data: oxides/SiO2/first.yml
        - PAGE: Other
          data: oxides/SiO2/second.yml
- SHELF: composite
  content:
    - BOOK: HYBRID
      content:
        - PAGE: nk
          data: composite/HYBRID/nk.yml
    - BOOK: DOT
      content:
        - PAGE: one
          data: composite/DOT/one.yml
"""
SELLMEIER = ('0 1.03961212 0.00600069867 0.231792344 0.0200179144 1.01046945 103.560653')
RII_FILES = {
    'vendorpages/N-BK7.yml': f"""\
        DATA:
          - type: formula 2
            wavelength_range: 0.3 2.5
            coefficients: {SELLMEIER}
    """,
    'genericbook/N-BK7.yml': """\
        DATA:
          - type: tabulated n
            data: |
              0.4 1.61
              0.6 1.60
              0.8 1.59
    """,
    'oxides/SiO2/first.yml': """\
        DATA:
          - type: tabulated nk
            data: |
              0.4 1.44 0.0
              0.5 1.45 0.001
              0.6 1.46 0.002
    """,
    'oxides/SiO2/second.yml': """\
        DATA:
          - type: tabulated nk
            data: |
              0.4 1.55 0.01
              0.6 1.60 0.02
              0.8 1.65 0.03
    """,
    'composite/HYBRID/nk.yml': f"""\
        DATA:
          - type: formula 2
            wavelength_range: 0.3 2.5
            coefficients: {SELLMEIER}
          - type: tabulated k
            data: |
              0.3 0.15
              1.0 0.25
              2.5 0.35
    """,
    'composite/DOT/one.yml': """\
        DATA:
          - type: tabulated nk
            data: |
              0.55 2.0 0.01
    """,
}


@pytest.fixture(autouse=True)
def f64_on_cpu(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


@pytest.fixture
def rii_db(tmp_path):
    (tmp_path / 'catalog-nk.yml').write_text(RII_CATALOG)
    for rel, body in RII_FILES.items():
        path = tmp_path / 'data' / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(body))
    return tmp_path


@pytest.fixture
def no_download(monkeypatch):
    """Both packages' fetch raises: a test that would download fails instead."""
    def refuse(db_path):
        raise AssertionError(f'a test reached the download of {db_path}')
    monkeypatch.setattr(jrii, '_fetch_database', refuse)
    monkeypatch.setattr(trii, '_fetch_database', refuse)


def _close(a, b, bar=BAR):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= bar * scale, (a, b)


def _both(build):
    """build(package) for each package: (torch's, jax's)."""
    return build(tmat), build(jmat)


# ---------------------------------------------------------------------------
# infrared and CHARMS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('factory', ['charms_silicon', 'charms_germanium'])
def test_charms_models_match_jax(factory):
    t, j = _both(lambda m: getattr(m, factory)())
    w = np.linspace(2.0, 5.0, 9)
    for T in (40.0, 80.0, 120.0, 295.0):
        _close(t.n(w, temperature=T), j.n(w, temperature=T))
        _close(t.dn_dT(3.0, T), j.dn_dT(3.0, T))
    assert t.page_info == j.page_info and t.citation == j.citation
    for m, err in ((t, tmat.MaterialRangeError), (j, jmat.MaterialRangeError)):
        with pytest.raises(ValueError):
            m.n(3.0)
        with pytest.raises(err):
            m.n(3.0, temperature=400.0)


def test_sapphire_matches_jax():
    t, j = _both(lambda m: m.sapphire_ordinary(aliases=('AL2O3',)))
    w = np.linspace(0.3, 5.0, 11)
    _close(t.n(w), j.n(w))
    _close(t.dn_dlambda(w), j.dn_dlambda(w))
    assert t.abbe(0.4861327, 0.5875618, 0.6562725) == pytest.approx(
        j.abbe(0.4861327, 0.5875618, 0.6562725), rel=BAR)
    assert t.metadata == j.metadata


@pytest.mark.parametrize('T', [80.0, 295.0])
@pytest.mark.parametrize('token, w', [('GE', 4.0), ('GERMMW', 3.0), ('SI', 4.0),
                                      ('SILICON', 2.0), ('SAPHIR', 2.0), ('AL2O3', 1.0)])
def test_infrared_catalog_tokens_match_jax(T, token, w):
    t, j = _both(lambda m: m.infrared_catalog(T).material_for_name(token))
    assert t.name == j.name
    _close(t.n(w), j.n(w))
    _close(t.n(np.linspace(2.0, 5.0, 4)), j.n(np.linspace(2.0, 5.0, 4)))


def test_temperature_sellmeier_and_charms_containers_match_jax():
    S = [[2.0, 1e-3, 1e-7], [1.0, 0.0, 0.0], [0.5, 1e-4, 0.0]]
    L = [[0.1, 0.0, 0.0], [0.2, 1e-5, 0.0], [5.0, 0.0, 0.0]]

    def build(m):
        parent = m.TemperatureSellmeierMaterial('g', S, L, residuals=1e-5)
        pair = m.CHARMSCoefficientMaterial('p', (S, L))
        keyed = m.CHARMSCoefficientMaterial('k', {'S': S, 'lambda': L})
        table = m.CHARMSTableMaterial('tab', [1.0, 2.0, 3.0], [100.0, 200.0],
                                      [[1.5, 1.6, 1.7], [1.55, 1.65, 1.75]],
                                      layout=('temperature', 'wavelength'))
        data = m.CHARMSDataset.from_materials([pair, table])
        bound = m.IsothermalMaterial(parent, 150.0)
        return [parent.n([0.8, 1.2], temperature=150.0), pair.n(1.0, temperature=90.0),
                keyed.n(1.0, temperature=90.0), table.n(2.5, temperature=150.0),
                data.material_for_name('tab').n(1.5, temperature=120.0), bound.n(1.0),
                bound.n(1.0, temperature=200.0), parent.metadata['residuals']]

    for a, b in zip(*_both(build)):
        _close(a, b)


# ---------------------------------------------------------------------------
# tabulated
# ---------------------------------------------------------------------------

W = np.array([0.4, 0.5, 0.6, 0.8, 1.0])
N = np.array([1.53, 1.52, 1.515, 1.508, 1.505])
K = np.array([1e-6, 2e-6, 1e-6, 5e-7, 1e-7])
Q = np.array([0.45, 0.55, 0.71, 0.97])


@pytest.mark.parametrize('kwargs', [
    dict(interpolation='linear'), dict(interpolation='nearest'), dict(interpolation='pchip'),
    dict(k_interpolation='log'), dict(method='pchip', k_interpolation='pchip'),
], ids=lambda kw: '-'.join(map(str, kw.values())))
def test_tabulated_interpolation_matches_jax(kwargs):
    t, j = _both(lambda m: m.TabulatedMaterial('t', W, N, k=K, **kwargs))
    _close(t.n(Q), j.n(Q))
    _close(t.k(Q), j.k(Q))
    _close(t.nk(Q), j.nk(Q))
    _close(t.dn_dlambda(Q), j.dn_dlambda(Q), 1e-12)
    assert t.wavelength_range == j.wavelength_range and t.page_info == j.page_info


def test_tabulated_extrapolation_ranges_and_data_match_jax():
    t, j = _both(lambda m: m.TabulatedMaterial('t', W, N, extrapolate=True))
    _close(t.n(np.array([0.3, 1.2])), j.n(np.array([0.3, 1.2])))
    for m, err in ((tmat, tmat.MaterialRangeError), (jmat, jmat.MaterialRangeError)):
        with pytest.raises(err):
            m.TabulatedMaterial('t', W, N).n(1.5)
        with pytest.raises(ValueError):
            m.TabulatedMaterial('t', W[::-1], N[::-1])
    dt, dj = _both(lambda m: m.MaterialData(W, N, k=K, sigma_n=N * 1e-5, metadata={'a': 1}))
    assert dt.wavelength_range == dj.wavelength_range and dt.metadata == dj.metadata
    for name in ('wavelengths', 'n', 'k', 'sigma_n'):
        np.testing.assert_array_equal(getattr(dt, name), getattr(dj, name))


def test_tabulated_single_sample_and_dtype_follow_jax(monkeypatch):
    t, j = _both(lambda m: m.RefractiveIndexMaterial('X', [0.55], [2.0], k=[0.01]))
    for w in (0.4, 1.0):
        assert (t.n(w), t.k(w)) == (j.n(w), j.k(w))
    monkeypatch.setattr(config, '_precision', torch.float32)
    m = tmat.TabulatedMaterial('film', [0.4, 0.6, 0.8], [1.4, 1.5, 1.6])
    assert m.n([0.5]).dtype == np.float32
    assert m.n(np.array([0.5])).dtype == np.float64


def test_temperature_grid_matches_jax():
    w = np.array([1.0, 2.0, 3.0])
    T = np.array([100.0, 200.0, 250.0, 300.0])
    grid = 1.5 + 0.01 * np.arange(4)[:, None] + 0.001 * np.arange(3)[None, :]
    kgrid = 1e-4 * (1 + np.arange(12).reshape(4, 3))

    def build(m):
        g = m.TemperatureGridMaterial('g', w, T, grid, k=kgrid)
        e = m.TemperatureGridMaterial('e', w, T, grid, extrapolate=True)
        qw, qt = np.array([[1.3, 2.7], [2.2, 1.1]]), np.array([[110.0, 225.0], [300.0, 180.0]])
        return [g.n(qw, temperature=qt), g.k(qw, temperature=qt), g.dn_dT(2.0, 200.0),
                g.dn_dlambda(1.5, temperature=150.0), e.n(3.5, temperature=320.0),
                g.n_grid, g.temperature_range]

    for a, b in zip(*_both(build)):
        _close(a, b)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def test_transforms_match_jax():
    def build(m):
        base = m.sapphire_ordinary()
        grid = m.TemperatureGridMaterial('dn', [0.5, 1.0], [100, 300],
                                         [[1e-3, 2e-3], [3e-3, 4e-3]],
                                         layout=('temperature', 'wavelength'))
        flat = m.TemperatureGridMaterial('flat', [0.5, 1.0], [100, 300],
                                         [[1.5, 1.5], [1.5, 1.5]],
                                         layout=('temperature', 'wavelength'))
        outs = [m.IndexOffsetMaterial(base, 1e-4).n(1.0),
                m.IndexOffsetMaterial(base, lambda wvl: 1e-3 * wvl, k_offset=1e-6).nk(0.7),
                m.TemperatureShiftedMaterial(base, 1e-5, 293.0).n(1.0, temperature=350.0),
                m.TemperatureShiftedMaterial(flat, grid, 100).n(0.75, temperature=200),
                m.StressOpticMaterial(base, 2e-6, 10.0).n(1.0),
                m.StressOpticMaterial(base, lambda wvl, temperature: temperature * 1e-7,
                                      stress=2.0).n(0.5, temperature=300),
                m.ThicknessDependentMaterial(base, lambda d, wvl: 1e-3 / d, 0.2).n(0.6),
                m.ThicknessDependentMaterial(base, 2e-4, 0.1,
                                             thickness_range=(0.05, 1.0)).n(0.6),
                m.ProcessVariantMaterial(base, process='IBS', variant='a').n(0.8),
                m.IsothermalMaterial(m.charms_germanium(), 120.0).n(4.0)]
        chained = m.ProcessVariantMaterial(m.IndexOffsetMaterial(base, 1e-4), process='IBS')
        return outs, chained.metadata, chained.process, chained.variant

    (t, tmeta, tp, tv), (j, jmeta, jp, jv) = _both(build)
    for a, b in zip(t, j):
        _close(a, b)
    assert (tmeta, tp, tv) == (jmeta, jp, jv)
    for m in (tmat, jmat):
        with pytest.raises(ValueError, match='outside the model range'):
            m.ThicknessDependentMaterial(m.sapphire_ordinary(), 1e-4, 5.0,
                                         thickness_range=(0.05, 1.0))


# ---------------------------------------------------------------------------
# catalogs and the registry
# ---------------------------------------------------------------------------

def test_catalog_resolution_and_ambiguity_match_jax():
    def build(m):
        schott = m.Catalog.from_materials([
            m.ConstantMaterial(1.5, name='N-BK7', catalog='SCHOTT',
                               metadata={'aliases': ('BK7',)}),
            m.ConstantMaterial(1.717, name='LAF3', catalog='SCHOTT'),
            m.ConstantMaterial(1.720, name='N-LAF3', catalog='SCHOTT',
                               metadata={'aliases': ('LAF3',)})])
        ohara = m.Catalog.from_materials([
            m.ConstantMaterial(1.52, name='S-BSL7', catalog='OHARA',
                               metadata={'aliases': ('BK7',)})])
        chain = m.CatalogChain([schott, ohara])
        with pytest.raises(m.AmbiguousMaterialError):
            chain.material_for_name('BK7')
        return [chain['SCHOTT:N-BK7'].n(0.55), schott.material_for_name('LAF3').n(0.55),
                chain.material_for_name('BK7', catalog='OHARA').n(0.55),
                sorted(r.name for r in chain.search('BK7'))]

    t, j = _both(build)
    assert t == j


def test_registry_search_matches_jax():
    def build(m):
        low = m.TabulatedMaterial('low', [0.4, 0.8], [1.45, 1.46], k=[0, 0],
                                  catalog='LAB', process='IBS')
        high = m.TabulatedMaterial('high', [0.4, 0.8], [2.0, 2.1], k=[0.1, 0.1],
                                   catalog='LAB', process='ebeam')
        unknown = m.ConstantMaterial(2.0, name='X', missing_k='raise', catalog='LAB')
        agf = m.AGFCatalog.from_text('NM SCH 1\nCD 2.25 0 0 0 0 0\nLD 0.4 0.8\n',
                                     namespace='SCH')
        reg = m.MaterialRegistry.from_catalogs([m.Catalog.from_materials([low, high, unknown]),
                                                agf])
        with pytest.raises(ValueError, match='n_at criterion expects'):
            reg.search(n_at=(0.55,))
        queries = [dict(wavelength_range_contains=(0.45, 0.65), process='IBS',
                        n_at=(0.55, 1.44, 1.47), k_max=(0.55, 1e-6)),
                   dict(n_at=(0.6, 1.6, None)), dict(n_at=(0.6, None, 1.6)),
                   dict(k_max=(0.55, 1e-6)), dict(process='ibs'), dict(catalog='lab'),
                   dict(material_class='AGFMaterial'), dict(query='s c h')]
        return ([sorted(r.name for r in reg.search(**q)) for q in queries],
                reg.material_for_name('high').n(0.6), reg['SCH:SCH'].n(0.5))

    t, j = _both(build)
    assert t == j


# ---------------------------------------------------------------------------
# AGF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('encoding', ['text', 'utf-8', 'utf-16'])
def test_agf_catalog_matches_jax(tmp_path, encoding):
    def build(m):
        if encoding == 'text':
            cat = m.AGFCatalog.from_text(AGF_TEXT, namespace='SCHOTT')
        else:
            path = tmp_path / f'{encoding}.agf'
            path.write_bytes(AGF_TEXT.encode(encoding))
            cat = m.load_agf_catalog(path, namespace='SCHOTT')
        w = np.array([0.45, 0.5876, 1.2])
        bk7, hik = cat['TESTBK7'], cat.material_for_name('HIK13')
        with pytest.raises(KeyError):
            cat['NOPE']
        return ([bk7.n(w), cat['SIMPLE'].n(0.5876), hik.n(np.array([0.4, 0.5875618, 1.0])),
                 bk7.dn_dT(0.5876, 293.15), bk7.k(0.5)],
                (cat.comments, bk7.catalog, bk7.page_info, sorted(m.name for m in cat.materials)))

    (t, tmeta), (j, jmeta) = _both(build)
    for a, b in zip(t, j):
        _close(a, b)
    assert tmeta == jmeta


def test_agf_material_and_extended_metadata_match_jax(tmp_path):
    text = ('CC UTF-16 test catalog\nNM TEST 1 0 1.500000 50.0 0\nGC test glass\n'
            'CD 2.25 0 0 0 0 0\nMD 82.00 0.21 580 820.000 1.19\nBD 0.588 2.77 0.80 3.57\n'
            'LD 0.4 0.8\n')
    (tmp_path / 'ext.agf').write_bytes(text.encode('utf-16'))

    def build(m):
        ext = m.AGFCatalog.from_file(tmp_path / 'ext.agf', namespace='T').material_for_name('TEST')
        direct = m.AGFMaterial(name='SAMPLE', catalog='HIKARI', formula=13,
                               coefficients=(2.45448839, -0.00867148963, -0.00010471524,
                                             0.0176039752, 0.000154610243, 0.0000559918259,
                                             -0.00000501297284, 0.00000031755799, 0, 0))
        return [ext.n(0.55), direct.n(0.5875618)], (ext.metadata, direct.page_info)

    (t, tm), (j, jm) = _both(build)
    for a, b in zip(t, j):
        _close(a, b)
    assert tm == jm


# ---------------------------------------------------------------------------
# refractiveindex.info
# ---------------------------------------------------------------------------

def test_rii_database_matches_jax(rii_db, no_download):
    def build(m):
        cat = m.RefractiveIndexCatalog.from_database(rii_db, download=False)
        bk7 = cat.material_for_name('N-BK7')
        w = np.array([0.4, 0.5875618, 1.5])
        picks = [cat.material_for_name(*a, **kw) for a, kw in (
            (('n-bk7',), {}), (('SiO2',), {}), (('SiO2',), {'page': 'Other'}),
            (('N-BK7',), {'shelf': 'generic'}), (('HYBRID',), {}), (('DOT',), {}))]
        with pytest.raises(KeyError):
            cat.material_for_name('UNOBTAINIUM')
        with pytest.raises(m.MaterialRangeError):
            bk7.n(0.2)
        return ([bk7.n(w), bk7.k(0.5)] + [p.nk(0.55) for p in picks]
                + [picks[4].k(0.65), picks[2].n(0.7)],
                [type(p).__name__ for p in picks] + [bk7.page_info['book'],
                                                     picks[1].page_info['page']])

    (t, tnames), (j, jnames) = _both(build)
    for a, b in zip(t, j):
        _close(a, b)
    assert tnames == jnames


def test_rii_missing_database_raises_without_download(tmp_path, no_download):
    for m in (trii, jrii):
        with pytest.raises(FileNotFoundError):
            m.RefractiveIndexCatalog.from_database(tmp_path / 'nope', download=False)
    assert tmat.default_db_path() == jmat.default_db_path()


def test_default_catalog_resolves_names_like_jax(rii_db, no_download, monkeypatch):
    """``glass`` / ``lookup`` with no database go through the default catalog, whose
    folder is patched to the tmp_path database in both packages."""
    for m, look in ((trii, tlookup), (jrii, jlookup)):
        monkeypatch.setattr(m, 'default_db_path', lambda: rii_db)
        monkeypatch.setattr(look, '_SHARED_DB', [])
    t, j = _both(lambda m: m.lookup('N-BK7'))
    _close(t.n(0.5875618), j.n(0.5875618))
    assert t.page_info['book'] == j.page_info['book'] == 'SCHOTT-optical'
    t, j = _both(lambda m: m.glass('SiO2', page='Other'))
    _close(t.nk(0.7), j.nk(0.7))
    assert tlookup._default_catalog() is tlookup._default_catalog()
    assert tmat.lookup('air') is tmat.air and tmat.lookup(1.75)(0.5) == 1.75


# ---------------------------------------------------------------------------
# fitted
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kwargs', [
    dict(model='cauchy', terms=3), dict(model='cauchy'), dict(model='constant'),
    dict(model='schott'), dict(model='sellmeier1'), dict(model='cauchy', terms=2),
], ids=lambda kw: '-'.join(map(str, kw.values())))
def test_fit_material_matches_jax(kwargs):
    w = np.linspace(0.4, 1.0, 12)
    n = np.asarray(jmat.model_glass(1.52, 58.0).n(w), dtype=float)
    t, j = _both(lambda m: m.fit_material('fit', w, n, **kwargs))
    q = np.array([0.45, 0.65, 0.95])
    _close(t.n(q), j.n(q), 1e-12)
    assert t.fit_report.rms_error == pytest.approx(j.fit_report.rms_error, rel=1e-10, abs=1e-16)
    assert t.metadata['model'] == j.metadata['model']
    _close(t.coefficients, j.coefficients, 1e-10)


def test_from_samples_and_fit_validation_match_jax():
    w = np.linspace(0.45, 0.9, 8)
    n = 1.6 + 0.01 / w ** 2
    t, j = _both(lambda m: m.from_samples('tab', w, n, k=n * 1e-6))
    assert type(t).__name__ == type(j).__name__ == 'TabulatedMaterial'
    _close(t.nk(0.6), j.nk(0.6))
    t, j = _both(lambda m: m.from_samples('fit', w, n, model='cauchy', terms=2))
    _close(t.n(w), j.n(w))
    assert t.fit_report.success == j.fit_report.success and isinstance(
        t.fit_report, tmat.FitReport)
    for m in (tmat, jmat):
        with pytest.raises(ValueError):
            m.fit_material('bad', w[:2], n[:2], model='cauchy', terms=5)


def test_public_names_match_jax():
    assert sorted(tmat.__all__) == sorted(jmat.__all__)
    for name in jmat.__all__:
        assert hasattr(tmat, name), name
