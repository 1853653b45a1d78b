"""The port's tutorials (``docs/torch/tutorials/``) against the JAX package's, on the CPU.

Each executed tutorial but the raytracing one (``test_torch_docs_raytracing.py``)
runs through ``prysm_tpu_torch`` alone on the CPU in float64, in a
``tmp_path`` working directory, with no kernel launched; then beside its
JAX twin, whose results it must match (``_torch_docs``).  Bars (of the
peak) are 1e-10 but where ``BARS`` says otherwise and why.
"""
import pytest
import torch

import _torch_docs as td

DOCS = ['tutorials/01-first-psf.md', 'tutorials/02-phase-retrieval.md',
        'tutorials/05-image-simulation.md', 'tutorials/06-interferometry.md',
        'tutorials/07-jones-calculus.md', 'tutorials/08-fibers.md',
        'tutorials/09-double-slit.md', 'tutorials/10-lens-mtf.md']

FRAME = 'the draws differ (exact Poisson from a torch.Generator, the JAX key\'s own): ' \
        'the frames agree in mean to 2e-3 and in spread to 5%'
BARS = {
    'tutorials/02-phase-retrieval.md': {
        'recovered': {'bar': 1e-9, 'why': 'the end of 200 L-BFGS-B iterations: each one '
                                         'carries the last iterate\'s rounding forward'}},
    'tutorials/05-image-simulation.md': {
        'frame': {'check': td.noise_stats, 'why': FRAME},
        'frame_fused': {'check': td.noise_stats, 'jax': lambda ns: ns['frame'],
                        'why': 'the kernel\'s plain version (Philox, Gaussian shot noise) '
                               'against the JAX frame: ' + FRAME}},
}


@pytest.mark.parametrize('relpath', DOCS, scope='module')
def test_port_doc_executes(relpath, monkeypatch, tmp_path):
    """Block by block through the port alone, f64 on the CPU, no kernel launched."""
    td.run_port(relpath, monkeypatch, tmp_path)


@pytest.mark.parametrize('relpath', DOCS, scope='module')
def test_port_doc_matches_jax(relpath, monkeypatch, tmp_path):
    results, tns = td.run_pair(relpath, monkeypatch, tmp_path, BARS.get(relpath, {}))
    td.compare(relpath, results, tns, BARS.get(relpath, {}))
    if relpath == 'tutorials/05-image-simulation.md':
        assert tns['frame'].dtype == tns['frame_fused'].dtype == torch.uint16
        assert tns['cam'].last_expose_path == 'fused'
