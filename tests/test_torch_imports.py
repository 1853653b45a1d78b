"""The port stands alone: no JAX, no prysm_tpu, and no result without a card.

``prysm_tpu_torch`` and ``chip_smoke.py`` must import neither ``jax`` nor
the JAX package, not even its pure-Python modules.  ``chip_smoke.py``
must exit nonzero and print no result where no CUDA device is present.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / 'prysm_tpu_torch').rglob('*.py')) + [ROOT / 'chip_smoke.py']


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize('path', PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_prysm_tpu_imports(path):
    for mod in _imported_modules(path):
        top = mod.split('.')[0]
        assert top not in ('jax', 'jaxlib', 'prysm_tpu'), f'{path.name} imports {mod}'


def test_port_files_found():
    assert len(PORT_FILES) > 15


# the optics-core modules of the cfg3/cfg4 slice: each is one of the files the
# import check above reads, and imports without a card
SLICE5_MODULES = ('mathops', 'coordinates', 'geometry', 'otf', 'segmented', 'fttools', 'psf',
                  'propagation.dft', 'propagation.angular_spectrum', 'propagation.wavefront',
                  'propagation.coronagraph', 'steps', 'interop')


# the polynomial families and the image-simulation modules of the freeform /
# image-chain slice
SLICE6_MODULES = tuple(f'polynomials.{m}' for m in (
    '_recurrence', '_clenshaw', 'jacobi', 'cheby', 'legendre', 'hermite', 'laguerre', 'dickson',
    'xy', 'zernike', 'fitting', 'qpoly')) + ('objects', 'degradations', 'degredations',
                                             'convolution', 'conf')


@pytest.mark.parametrize('module', SLICE5_MODULES + SLICE6_MODULES)
def test_slice_module_is_checked_and_imports(module):
    import importlib
    path = ROOT / 'prysm_tpu_torch' / (module.replace('.', '/') + '.py')
    assert path in PORT_FILES
    importlib.import_module(f'prysm_tpu_torch.{module}')


@pytest.mark.parametrize('kind', ['czt', 'fftdft'])
def test_prepare_executor_builds_the_other_kinds(kind):
    import torch
    from prysm_tpu_torch import fttools
    from prysm_tpu_torch.propagation import prepare_executor
    plan = prepare_executor(0.015625, 16, 0.5, 12, 0.5, 10.0, kind=kind, device='cpu')
    assert isinstance(plan, {'czt': fttools.CZT, 'fftdft': fttools.FFTDFT}[kind])
    assert plan(torch.ones(16, 16)).shape == (12, 12)


def _run_smoke(cwd):
    return subprocess.run([sys.executable, 'chip_smoke.py'], cwd=cwd, capture_output=True,
                          text=True, timeout=120)


def _no_result(proc):
    for line in proc.stdout.splitlines():
        try:
            assert not json.loads(line).get('ok')
        except (ValueError, AttributeError):
            pass


def test_chip_smoke_refuses_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: chip_smoke.py runs for real here')
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    _no_result(proc)
    # alone in a directory, without the package beside it
    (tmp_path / 'chip_smoke.py').write_text((ROOT / 'chip_smoke.py').read_text())
    alone = _run_smoke(tmp_path)
    assert alone.returncode != 0
    _no_result(alone)
