"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` compiles with nvcc for ``sm_90a`` into one shared
library with a plain C interface, loaded with ctypes.  The build happens at
first use, from the sources in the package only, into
``prysm_tpu_torch/_build/``; the library's file name carries a hash of the
flags, of its own source and of the local headers that source includes
(``#include "..."``, followed through headers), so an edited source builds
anew, an unchanged one loads at once, and one source's edit leaves the
other libraries alone.  A failed build raises.
"""
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

__all__ = ['build', 'load']

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD = _PKG / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')


def _nvcc():
    candidates = [shutil.which('nvcc')]
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root:
            candidates.append(str(Path(root) / 'bin' / 'nvcc'))
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError('nvcc was not found (looked on PATH, in $CUDA_HOME/bin and '
                       '/usr/local/cuda/bin); the CUDA kernels cannot be built')


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(name):
    """``csrc/<name>.cu`` and every local header it includes, directly or not."""
    todo, seen = [CSRC / f'{name}.cu'], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo.extend(path.parent / inc.decode()
                    for inc in _LOCAL_INCLUDE.findall(path.read_bytes()))
    return seen


def library_path(name):
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for src in sorted(_sources(name)):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f'lib{name}-{h.hexdigest()[:16]}.so'


def build(name):
    """Compile ``csrc/<name>.cu`` unless its library exists.

    Returns nvcc's diagnostic output (register and shared-memory use, from
    ``-Xptxas=-v``), or None when the library was already built.
    """
    out = library_path(name)
    if out.exists():
        return None
    BUILD.mkdir(exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f'CUDA build failed: {name}.cu: nvcc exited '
                           f'{proc.returncode}\n{proc.stdout}')
    os.replace(tmp, out)
    return proc.stdout


@lru_cache(None)
def load(name):
    """The ctypes library built from ``csrc/<name>.cu``, building it if needed."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
