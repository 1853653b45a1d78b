"""The port's glass models and tokens (``x/materials``) against the JAX package.

Host numpy on both sides, so every value must be equal to the last bit:
``model_glass`` n(λ) at 20 wavelengths, the dispersion formulas, the
constant materials, the MIRROR / air / vacuum tokens and ``resolve_index``.
"""
import numpy as np
import pytest
import torch

import prysm_tpu.x.materials as jmat
from prysm_tpu.x.materials import formulas as jform
import prysm_tpu_torch.x.materials as tmat
from prysm_tpu_torch.conf import config
from prysm_tpu_torch.x.materials import formulas as tform

WVLS = np.linspace(0.4, 1.0, 20)
GLASSES = [(1.5168, 64.17, 'BK7ish'), (1.6727, 32.2, 'SF5ish'), (1.7552, 27.58, None)]


@pytest.fixture(autouse=True)
def f64_on_cpu(monkeypatch):
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.setattr(config, '_device', 'cpu')


@pytest.mark.parametrize('nd, vd, name', GLASSES)
def test_model_glass_index_bit_equal(nd, vd, name):
    j, t = jmat.model_glass(nd, vd, name=name), tmat.model_glass(nd, vd, name=name)
    assert t.name == j.name and t.metadata == j.metadata
    assert t.coefficients == j.coefficients
    np.testing.assert_array_equal(t.n(WVLS), j.n(WVLS))
    for w in WVLS[::5]:
        assert t.n(float(w)) == j.n(float(w))
    np.testing.assert_array_equal(t.k(WVLS), j.k(WVLS))
    assert t.abbe(0.4861327, 0.5875618, 0.6562725) == j.abbe(0.4861327, 0.5875618, 0.6562725)
    np.testing.assert_array_equal(t.dn_dlambda(WVLS), j.dn_dlambda(WVLS))


@pytest.mark.parametrize('fn, args', [
    ('cauchy', (1.5, 0.004, 1e-5)),
    ('sellmeier', ([1.03961212, 0.231792344, 1.01046945], [0.00600069867, 0.0200179144, 103.560653])),
    ('sellmeier_interleaved', (1.03961212, 0.00600069867, 0.231792344, 0.0200179144)),
    ('schott', (2.27, -0.0101, 0.0105, 2.1e-4, -1.7e-5, 1.2e-6)),
    ('extended2', (2.27, -0.0101, 0.0105, 2.1e-4, -1.7e-5, 1.2e-6, 1e-7, -1e-8)),
    ('extended3', (2.27, -0.0101, 1e-4, 0.0105, 2.1e-4, -1.7e-5, 1.2e-6, 1e-7, -1e-8)),
])
def test_dispersion_formulas_bit_equal(fn, args):
    np.testing.assert_array_equal(getattr(tform, fn)(WVLS, *args),
                                  getattr(jform, fn)(WVLS, *args))


# coefficients that keep each formula real over WVLS (4 and 8 need their own)
RII_COEFS = {4: (2.0, 0.5, 2.0, 0.01, 1.0, 0.3, 2.0, 0.02, 1.0, 0.001, 1.5),
             8: (0.05, 0.2, 0.01, 0.01)}


@pytest.mark.parametrize('formula_id', range(1, 10))
def test_riinfo_formulas_bit_equal(formula_id):
    coefs = RII_COEFS.get(formula_id, (0.1, 1.03961212, 0.0774, 0.231792344, 0.1418,
                                       1.01046945, 10.17, 0.02, 2.0, 0.001, 1.5))
    got = tform.riinfo_formula(formula_id, WVLS, *coefs)
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got, jform.riinfo_formula(formula_id, WVLS, *coefs))


@pytest.mark.parametrize('fid', [1, 2, 6, 12, 13])
def test_agf_formula_bit_equal(fid):
    coefs = (1.03961212, 0.00600069867, 0.231792344, 0.0200179144, 1.01046945, 103.560653,
             0.01, 0.02, 0.001)
    np.testing.assert_array_equal(tform.agf_formula(fid, WVLS, *coefs),
                                  jform.agf_formula(fid, WVLS, *coefs))


def test_constant_material_and_tokens():
    for name in ('air', 'vacuum'):
        j, t = getattr(jmat, name), getattr(tmat, name)
        assert t.name == j.name and t.n(0.55) == j.n(0.55) == 1.0
        np.testing.assert_array_equal(t.n(WVLS), j.n(WVLS))
    assert tmat.MIRROR == jmat.MIRROR
    for token in ('MIRROR', 'mirror', ' Mirror '):
        assert tmat.resolve_index(token) == tmat.MIRROR
    for token in ('AIR', 'vacuum', ''):
        assert tmat.resolve_index(token) is tmat.air
        assert jmat.resolve_index(token) is jmat.air
    assert tmat.resolve_index(None) is None and tmat.resolve_index(tmat.MIRROR) is tmat.MIRROR
    assert tmat.resolve_index(1.7)(0.55) == jmat.resolve_index(1.7)(0.55) == 1.7
    glass = tmat.model_glass(1.5, 60.0)
    assert tmat.resolve_index(glass) is glass
    assert tmat.lookup('air') is tmat.air and tmat.lookup('MIRROR') == tmat.MIRROR
    with pytest.raises(TypeError):
        tmat.resolve_index('N-BK7')
    c = tmat.ConstantMaterial(1.45, k=1e-3)
    j = jmat.ConstantMaterial(1.45, k=1e-3)
    assert (c.name, c.n(0.5), c.k(0.5), c.nk(0.5)) == (j.name, j.n(0.5), j.k(0.5), j.nk(0.5))


def test_glass_names_need_a_catalog(tmp_path, monkeypatch):
    """A bare name resolves through the default refractiveindex.info catalog, as in the JAX
    package: here a one-page database in tmp_path stands in for its folder, and the download
    is patched to raise, so no test reaches it.  A catalog given resolves through it."""
    import importlib
    from prysm_tpu.x.materials import rii as jrii
    from prysm_tpu_torch.x.materials import rii as trii
    page = tmp_path / 'data' / 'glass' / 'BK7.yml'
    page.parent.mkdir(parents=True)
    page.write_text('DATA:\n  - type: formula 2\n    wavelength_range: 0.3 2.5\n'
                    '    coefficients: 0 1.03961212 0.00600069867 0.231792344 0.0200179144'
                    ' 1.01046945 103.560653\n')
    (tmp_path / 'catalog-nk.yml').write_text(
        '- SHELF: glass\n  content:\n    - BOOK: N-BK7\n      content:\n'
        '        - PAGE: SCHOTT\n          data: glass/BK7.yml\n')

    def refuse(db_path):
        raise AssertionError(f'the test reached the download of {db_path}')

    for rii, pkg in ((trii, 'prysm_tpu_torch'), (jrii, 'prysm_tpu')):
        monkeypatch.setattr(rii, '_fetch_database', refuse)
        monkeypatch.setattr(rii, 'default_db_path', lambda: tmp_path)
        monkeypatch.setattr(importlib.import_module(f'{pkg}.x.materials.lookup'), '_SHARED_DB', [])
    got, want = tmat.lookup('N-BK7'), jmat.lookup('N-BK7')
    np.testing.assert_array_equal(got.n(WVLS), want.n(WVLS))
    assert got.page_info == want.page_info

    class Catalog:
        def material_for_name(self, name, **qualifiers):
            return tmat.ConstantMaterial(1.5168, name=name)

    assert tmat.lookup('N-BK7', database=Catalog()).name == 'N-BK7'


def test_fill_takes_the_working_precision(monkeypatch):
    """A plain-list query lands in config.precision, mapped by table."""
    for prec, want in ((torch.float32, np.float32), (torch.float64, np.float64)):
        monkeypatch.setattr(config, '_precision', prec)
        got = tmat.ConstantMaterial(1.3).n([0.5, 0.6])
        assert got.dtype == want and np.all(got == 1.3)


def test_range_checks_match():
    t = tmat.FormulaMaterial('g', tform.cauchy, (1.5, 0.004), wavelength_range=(0.4, 0.8))
    j = jmat.FormulaMaterial('g', jform.cauchy, (1.5, 0.004), wavelength_range=(0.4, 0.8))
    assert t.n(0.5) == j.n(0.5)
    for mat, err in ((t, tmat.MaterialRangeError), (j, jmat.MaterialRangeError)):
        with pytest.raises(err):
            mat.n(0.9)
    assert t.page_info == j.page_info
