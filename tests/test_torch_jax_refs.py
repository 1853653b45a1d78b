"""The recorded JAX outputs of the port's parity tests (``tests/_jax_refs.py``).

Every record file is stamped with the tree as it stands (a stale file fails
here by name; ``python tests/record_jax_refs.py`` records it again) and stays
within the size limits; records recomputed live by the JAX package agree with
what was recorded, to 1e-14 of their peak and exactly in every integer,
string and shape; and a record answers only the call that made it.
"""
import importlib

import numpy as np
import pytest

import _jax_refs as jr

FILES = sorted(p.stem for p in jr.RECORDS.glob('*.npz'))


@pytest.mark.parametrize('module', FILES)
def test_record_file_is_stamped_with_the_tree(module):
    assert (jr.ROOT / 'tests' / f'{module}.py').exists(), f'no test module {module}'
    recorded, reads, records = jr.load(module)
    assert records
    assert recorded == jr.stamp(reads), (
        f'tests/jax_refs/{module}.npz is stale: python tests/record_jax_refs.py '
        f'tests/{module}.py')


def test_records_stay_within_their_size():
    sizes = {m: (jr.RECORDS / f'{m}.npz').stat().st_size for m in FILES}
    assert max(sizes.values()) <= 4e6 and sum(sizes.values()) <= 16e6, sizes


def _recorded(module, key, compute, inputs):
    _, _, records = jr.load(module)
    rid = f'{key}@{jr.digest(compute, inputs)[:16]}'
    assert rid in records, f'tests/jax_refs/{module}.npz holds no record {rid}'
    return jr.decode(*records[rid])


def _agree(got, want, at='value'):
    """Floats within 1e-14 of the peak; everything else equal."""
    assert type(got) is type(want), at
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), at
        for k, (g, w) in enumerate(zip(got, want)):
            _agree(g, w, f'{at}[{k}]')
    elif isinstance(want, dict):
        assert list(got) == list(want), at
        for k in want:
            _agree(got[k], want[k], f'{at}[{k!r}]')
    elif isinstance(want, (np.ndarray, np.generic, float, complex)):
        g, w = np.asarray(got), np.asarray(want)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), at
        if np.issubdtype(w.dtype, np.inexact) and w.size:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=at)
            scale = np.nanmax(np.abs(w))
            assert np.nanmax(np.abs(g - w)) <= 1e-14 * scale, at
        else:
            np.testing.assert_array_equal(g, w, err_msg=at)
    else:
        assert got == want, at


# (test module, key, its module-level compute, inputs): records that cost a second or two
FIDELITY = {
    'needle-helpers': ('test_torch_coatings_design', 'needle-helpers', '_jax_needle_helpers',
                       ()),
    'psf-sizes': ('test_torch_geometry', 'psf-sizes', '_jax_psf_sizes', ((47, 50), 'last')),
    'dls-iterates': ('test_torch_coatings_design', 'refine-lm', '_jax_lm',
                     ('ar', [1.38, 2.05, 1.6], [0.1, 0.05, 0.08], {})),
}


@pytest.mark.parametrize('case', FIDELITY)
def test_a_record_is_what_the_jax_package_computes(case):
    module, key, name, inputs = FIDELITY[case]
    compute = getattr(importlib.import_module(module), name)
    want = _recorded(module, key, compute, inputs)
    _agree(jr.decode(*jr.encode(compute(*inputs))), want)


def test_a_record_answers_only_its_own_call(tmp_path, monkeypatch):
    """A record of f(1.0) is returned for f(1.0) alone: f(2.0), and another function of
    the same key on the same input, are computed."""
    calls = []

    def f(x):
        calls.append(x)
        return {'y': np.asarray([x, 2 * x]), 'n': 3}

    def g(x):
        calls.append(-x)
        return {'y': np.asarray([x, 2 * x]), 'n': 3}

    monkeypatch.setattr(jr, 'RECORDS', tmp_path)
    monkeypatch.setattr(jr, 'CAPTURE', None)
    monkeypatch.setattr(jr, 'READ', None)
    jr._book.cache_clear()
    try:
        tree, leaves = jr.encode({'y': np.asarray([7.0, 8.0]), 'n': 4})
        jr.save(__name__, {f'f@{jr.digest(f, (1.0,))[:16]}': (tree, leaves, ())})
        got = jr.jax_ref('f', f, 1.0)
        assert calls == [] and got['n'] == 4 and got['y'].tolist() == [7.0, 8.0]
        assert jr.jax_ref('f', f, 2.0)['y'].tolist() == [2.0, 4.0] and calls == [2.0]
        assert jr.jax_ref('f', g, 1.0)['n'] == 3 and calls == [2.0, -1.0]
        assert jr.jax_ref('g', f, 1.0)['n'] == 3 and calls == [2.0, -1.0, 1.0]
    finally:
        jr._book.cache_clear()
