"""Shared by ``tests/test_torch_docs_*.py``: a JAX doc and its port twin, run and compared.

The JAX doc (``docs/<relpath>``) runs block by block in one namespace as
``tests/test_docs_snippets.py`` runs it (the CPU, x64, its block limit), with
the draws of ``jax.random.uniform`` / ``normal`` recorded; of its namespace
only the compared results and the draws are kept, and they are read from
their record (``_jax_refs``) where it is current.  The port's doc
(``docs/torch/<relpath>``) runs through ``prysm_tpu_torch.docs.run`` on the
CPU in float64 with those draws replayed into ``torch.rand`` / ``randn``.
Both run in the test's ``tmp_path``.  A port doc that replays no draws runs
once: ``run_pair`` reads the run that ``test_port_doc_executes`` made (the
phase-retrieval tutorial's run is 200 L-BFGS-B iterations).  The docs
modules give ``relpath`` module scope, so that a doc's two tests run one
after the other and one kept run waits at a time.  A result is compared by
``max |port - jax| / max |jax|`` (of the peak), or as named in the file's
table.
"""
import contextlib
import re
from pathlib import Path

import numpy as np
import torch

import jax

from _jax_refs import jax_ref
from prysm_tpu_torch import docs
from prysm_tpu_torch.conf import config
from prysm_tpu_torch.ops import noise as tnoise
from prysm_tpu_torch.ops import zernike as tzk

ROOT = Path(__file__).resolve().parent.parent
JAX_DOCS = ROOT / 'docs'
DEFAULT_BAR = 1e-10
_BLOCK = re.compile(r'```python\n(.*?)```', re.S)

torch.set_num_threads(2)


def jax_doc_paths():
    """Every JAX doc: ``docs/**/*.md`` outside ``docs/torch/``, relative to ``docs/``."""
    return sorted(p.relative_to(JAX_DOCS).as_posix() for p in JAX_DOCS.rglob('*.md')
                  if p.relative_to(JAX_DOCS).parts[0] != 'torch')


@contextlib.contextmanager
def _recording(recorded):
    """Record the draws of ``jax.random.uniform`` / ``normal`` (as 'rand' / 'randn')."""
    originals = {'uniform': jax.random.uniform, 'normal': jax.random.normal}

    def wrap(kind, fn):
        def drawn(*args, **kwargs):
            out = fn(*args, **kwargs)
            recorded[kind].append(np.asarray(out, np.float64))
            return out
        return drawn

    jax.random.uniform = wrap('rand', originals['uniform'])
    jax.random.normal = wrap('randn', originals['normal'])
    try:
        yield
    finally:
        jax.random.uniform, jax.random.normal = originals['uniform'], originals['normal']


def run_jax(relpath):
    """The JAX doc's namespace after its executed blocks, and its recorded draws.  The
    JAX package's configuration and propagation functions are restored after."""
    import prysm_tpu.propagation as jprop
    from prysm_tpu.conf import config as jconfig
    code = _BLOCK.findall((JAX_DOCS / relpath).read_text())
    limit = docs.EXECUTED[relpath]
    code = code[:limit] if limit is not None else code
    ns, recorded = {}, {'rand': [], 'randn': []}
    saved = dict(vars(jprop)), jconfig._explicit, jax.config.jax_default_matmul_precision
    try:
        with _recording(recorded):
            for k, block in enumerate(code):
                exec(compile(block, f'docs/{relpath}[block {k}]', 'exec'), ns)
    finally:
        for name, fn in saved[0].items():
            setattr(jprop, name, fn)
        jconfig._explicit = saved[1]
        jax.config.update('jax_default_matmul_precision', saved[2])
    return ns, recorded


def _jax_results(relpath, jax_fns):
    ns, recorded = run_jax(relpath)
    return {name: jax_fns[name](ns) if name in jax_fns else docs.value(ns, name)
            for name in docs.RESULTS[relpath]}, recorded


def jax_results(relpath, bars):
    """(results, draws) of the JAX doc: each name of ``docs.RESULTS[relpath]`` as its
    namespace holds it on the host, or as its ``bars`` entry's ``jax`` function reads it
    from the namespace; and the draws the doc made."""
    jax_fns = {name: entry['jax'] for name, entry in bars.items() if 'jax' in entry}
    each = {name: bars.get(name, {}).get('bar', DEFAULT_BAR) for name in docs.RESULTS[relpath]}
    return jax_ref(relpath, _jax_results, relpath, jax_fns, bar=(each, min(each.values())),
                   reads=(f'docs/{relpath}',))


_PORT_RUNS = {}


def run_port(relpath, monkeypatch, tmp_path, draws=None):
    """The port doc's namespace, run on the CPU in float64 in ``tmp_path``: every named
    result present, no drawing block skipped, no kernel launched (the wrappers take their
    plain versions on CPU tensors).  A run of a doc that ``docs.REPLAYED`` does not name
    is kept for ``run_pair``."""
    monkeypatch.setattr(config, '_device', 'cpu')
    monkeypatch.setattr(config, '_precision', torch.float64)
    monkeypatch.chdir(tmp_path)
    tzk.reset_launches()
    tnoise.reset_launches()
    ns = docs.run(relpath, draws=draws)
    assert not ns['__skipped__']
    for name in docs.RESULTS.get(relpath, ()):
        docs.value(ns, name)
    assert all(v == 0 for v in {**tzk.LAUNCHES, **tnoise.LAUNCHES}.values())
    if draws is None and relpath not in docs.REPLAYED:
        _PORT_RUNS[relpath] = ns
    return ns


def run_pair(relpath, monkeypatch, tmp_path, bars):
    """(JAX results, port namespace) of one doc, the JAX doc run in ``tmp_path`` where it
    runs (``jax_results``).  The port's runs there as ``run_port`` runs it with the JAX
    doc's draws where ``docs.REPLAYED`` says; otherwise it is the kept run, handed out
    once, or a new run where none was kept."""
    monkeypatch.chdir(tmp_path)
    results, recorded = jax_results(relpath, bars)
    if relpath in docs.REPLAYED:
        return results, run_port(relpath, monkeypatch, tmp_path, docs.Draws(recorded))
    if relpath in _PORT_RUNS:
        return results, _PORT_RUNS.pop(relpath)
    return results, run_port(relpath, monkeypatch, tmp_path)


def noise_stats(got, want):
    """Two noisy frames of one scene agree in mean to 2e-3 and in spread to 5%: their
    draws differ."""
    dmean, dspread = docs.frame_moments(got, want)
    assert dmean <= 2e-3 and dspread <= 0.05, (dmean, dspread)


def compare(relpath, results, tns, bars):
    """Every result of ``docs.RESULTS[relpath]`` within its bar.  ``bars`` maps a name to
    a dict: ``bar`` (default DEFAULT_BAR) with ``why`` where it is looser; ``jax`` a
    function of the JAX namespace giving the value compared (default the same name
    there); ``check`` a function (port value, JAX value) that asserts, in place of the bar."""
    for name in docs.RESULTS[relpath]:
        entry = bars.get(name, {})
        got = docs.value(tns, name)
        want = None if results[name] is None else docs.host(results[name])
        if 'check' in entry:
            entry['check'](got, want)
            continue
        bar = entry.get('bar', DEFAULT_BAR)
        assert bar == DEFAULT_BAR or entry.get('why'), f'{relpath}: {name} needs a why'
        err = docs.relative_error(got, want)
        assert err <= bar, f'{relpath}: {name} off by {err:.3g} > {bar:g}'
