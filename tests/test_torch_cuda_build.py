"""The port's CUDA build keys (``prysm_tpu_torch.ops._cuda``), without nvcc.

Each ``csrc/<name>.cu`` builds into a library of its own whose file name
hashes that source and the local headers it includes, so editing one
source rebuilds that library alone, and editing a shared header rebuilds
each library that includes it.
"""
from prysm_tpu_torch.ops import _cuda


def test_each_shipped_source_is_keyed_alone():
    names = sorted(p.stem for p in _cuda.CSRC.glob('*.cu'))
    assert names == ['noise', 'warp', 'zernike']
    for name in ('noise', 'zernike'):
        # each source and the one header both share (sincos_reduced)
        assert _cuda._sources(name) == [_cuda.CSRC / f'{name}.cu', _cuda.CSRC / 'sincos.cuh']
    assert _cuda._sources('warp') == [_cuda.CSRC / 'warp.cu']  # no local header
    paths = {_cuda.library_path(n) for n in names}
    assert len(paths) == 3 and all(p.parent == _cuda.BUILD for p in paths)


def test_an_edit_rebuilds_only_its_own_library(tmp_path, monkeypatch):
    monkeypatch.setattr(_cuda, 'CSRC', tmp_path)
    (tmp_path / 'common.cuh').write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / 'inner.cuh').write_text('// inner\n')
    (tmp_path / 'a.cu').write_text('#include <cuda_runtime.h>\n#include "common.cuh"\n')
    (tmp_path / 'b.cu').write_text('#include <cuda_runtime.h>\n')
    assert sorted(p.name for p in _cuda._sources('a')) == ['a.cu', 'common.cuh', 'inner.cuh']
    a0, b0 = _cuda.library_path('a'), _cuda.library_path('b')
    assert a0.name.startswith('liba-') and b0.name.startswith('libb-')

    (tmp_path / 'b.cu').write_text('#include <cuda_runtime.h>\n// edited\n')
    assert _cuda.library_path('a') == a0 and _cuda.library_path('b') != b0
    b1 = _cuda.library_path('b')

    (tmp_path / 'inner.cuh').write_text('// inner, edited\n')
    assert _cuda.library_path('a') != a0 and _cuda.library_path('b') == b1
