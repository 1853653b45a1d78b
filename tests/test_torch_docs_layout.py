"""The port's documentation as a whole: ``docs/torch/`` against ``docs/``, statically.

* coverage: every JAX doc (``docs/**/*.md`` outside ``docs/torch/``) has a
  twin at the same relative path under ``docs/torch/``, and every port doc
  has a JAX twin;
* the executed set: ``prysm_tpu_torch.docs.EXECUTED`` is the JAX docs
  test's table, and every executed doc names its compared results;
* imports: no block of a port doc imports ``jax`` or the JAX package, and
  every block compiles;
* links: every relative link in ``docs/torch/`` resolves;
* numbers: every figure of the scaling page's tables is a number of
  ``PERF.md`` (to 2%), beside the card's name and power limit; every
  section of a port doc that states a time, rate or memory figure names
  the card and its power limit;
* draws: ``docs.Draws`` replays what it recorded, and refuses a draw of
  another shape;
* kernels: the kernel lesson and the image-simulation tutorial launch no
  kernel on the CPU, and their frames are ``torch.uint16``.
"""
import ast
import re

import numpy as np
import pytest
import torch

import _torch_docs as td
import test_docs_snippets

from prysm_tpu_torch import docs
from prysm_tpu_torch.ops import noise as tnoise
from prysm_tpu_torch.ops import zernike as tzk

PORT_DOCS = docs.doc_paths()
JAX_DOCS = td.jax_doc_paths()
CARD = ('NVIDIA H100 80GB HBM3', '700.00 W')
_FIGURE = re.compile(r'\d\s*(ms|µs|ns|GB/s|MB|GB|frames/s|steps/s)\b')


def test_docs_found():
    assert len(JAX_DOCS) == 38 and len(PORT_DOCS) == 38


@pytest.mark.parametrize('relpath', JAX_DOCS)
def test_every_jax_doc_has_a_port_twin(relpath):
    assert relpath in PORT_DOCS, f'docs/torch/{relpath} is missing'


@pytest.mark.parametrize('relpath', PORT_DOCS)
def test_every_port_doc_has_a_jax_twin(relpath):
    assert relpath in JAX_DOCS, f'docs/{relpath} does not exist'


def test_executed_table_is_the_jax_docs_tests():
    assert docs.EXECUTED == test_docs_snippets.EXECUTABLE
    assert set(docs.RESULTS) == set(docs.EXECUTED)
    assert set(docs.REPLAYED) <= set(docs.EXECUTED) and set(docs.DRAWING) <= set(docs.EXECUTED)


@pytest.mark.parametrize('relpath', PORT_DOCS)
def test_blocks_compile_and_import_no_jax(relpath):
    for k, block in enumerate(docs.blocks(relpath)):
        tree = ast.parse(compile(block, f'{relpath}[block {k}]', 'exec',
                                 flags=ast.PyCF_ONLY_AST))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or '']
            else:
                continue
            for name in names:
                top = name.split('.')[0]
                assert top not in ('jax', 'jaxlib', 'prysm_tpu'), f'{relpath}[{k}] imports {name}'


@pytest.mark.parametrize('relpath', PORT_DOCS)
def test_relative_links_resolve(relpath):
    path = docs.DOCS / relpath
    for target in re.findall(r'\]\(([^)#]+)\)', path.read_text()):
        if not target.startswith(('http://', 'https://')):
            assert (path.parent / target).resolve().exists(), f'{relpath}: broken link {target}'


def _table_numbers(text):
    """The numbers in the table cells after each row's label, of every markdown table."""
    out = []
    for line in text.splitlines():
        cells = [c.strip() for c in line.strip().strip('|').split('|')]
        if not line.lstrip().startswith('|') or set(''.join(cells)) <= set('-: '):
            continue
        for cell in cells[1:]:
            if re.fullmatch(r'[\d,.]+', cell):
                out.append(float(cell.replace(',', '')))
    return out


def test_scaling_table_numbers_are_in_perf():
    """Every figure of the scaling page's measured tables is one of PERF.md's (to 2%, as
    the JAX page's test allows against its bench file), and the section names the card."""
    text = (docs.DOCS / 'how-tos' / 'tpu-and-scaling.md').read_text()
    section = text[text.index('## Measured numbers'):text.index('## Benchmarking')]
    assert all(part in ' '.join(section.split()) for part in CARD)
    perf = [float(m.replace(',', '')) for m in
            re.findall(r'(?<![\w.])\d[\d,]*\.\d+|(?<![\w.])\d{1,3}(?:,\d{3})+',
                       (td.ROOT / 'PERF.md').read_text())]
    numbers = _table_numbers(section)
    assert len(numbers) >= 20
    for n in numbers:
        assert any(abs(p - n) <= 0.02 * abs(n) for p in perf), f'{n} is not in PERF.md'


@pytest.mark.parametrize('relpath', PORT_DOCS)
def test_figures_stand_beside_the_card(relpath):
    """A section (between headings) that states a time, rate or memory figure names the card
    and its power limit: no figure of another machine."""
    text = (docs.DOCS / relpath).read_text()
    for section in re.split(r'\n(?=#+ )', text):
        prose = ' '.join(re.sub(r'```.*?```', '', section, flags=re.S).split())
        if _FIGURE.search(prose):
            assert all(part in prose for part in CARD), (relpath, section[:80])


def test_draws_replay_what_they_recorded():
    gen = torch.Generator().manual_seed(3)
    recorder = docs.Draws()
    with recorder.active():
        a = torch.rand((4, 5), generator=gen, dtype=torch.float64)
        b = torch.randn(3, generator=gen, dtype=torch.float64)
    replay = docs.Draws(recorder.recorded)
    with replay.active():
        a2 = torch.rand((4, 5), generator=torch.Generator(), dtype=torch.float32)
        b2 = torch.randn(3, dtype=torch.float64)
        with pytest.raises(RuntimeError, match='no recorded'):
            torch.randn(3)
    assert a2.dtype == torch.float32 and torch.equal(a2, a.float())
    assert torch.equal(b2, b)
    with docs.Draws({'rand': [np.zeros((2, 2))], 'randn': []}).active():
        with pytest.raises(RuntimeError, match='asked for'):
            torch.rand(3)
    assert torch.rand(2).shape == (2,)          # the originals are back


@pytest.mark.parametrize('relpath', ['college/102-precision-and-dispatch.md',
                                     'tutorials/05-image-simulation.md'])
def test_kernel_pages_launch_nothing_on_the_cpu(relpath, monkeypatch, tmp_path):
    """On CPU tensors the wrappers run their plain versions: every count stays 0, and the
    pages' frames come out of the ADC as uint16."""
    ns = td.run_port(relpath, monkeypatch, tmp_path)
    assert tzk.LAUNCHES == dict.fromkeys(tzk.LAUNCHES, 0) and set(tzk.LAUNCHES) == {
        'zernike_fwd', 'zernike_bwd_coefs', 'zernike_bwd_all'}
    assert tnoise.LAUNCHES == {'noise_expose': 0}
    frames = [ns[k] for k in ('frame', 'frame_fused') if k in ns]
    assert frames and all(f.dtype == torch.uint16 for f in frames)
