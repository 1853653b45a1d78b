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
