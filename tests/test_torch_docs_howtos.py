"""The port's how-tos and explanations (``docs/torch/how-tos/``, ``explanation/``)
against the JAX package's, on the CPU.

Each executed page runs through ``prysm_tpu_torch`` alone on the CPU in
float64, in a ``tmp_path`` working directory, with no kernel launched; then
beside its JAX twin, whose results it must match (``_torch_docs``).  The
random draws of the telescope apertures' segment coefficients and of both
synthetic interferograms are the JAX doc's, replayed into ``torch.randn`` /
``torch.rand``.  The polychromatic page's two executed blocks (its plan and
incoherent PSF) need no process group.  Bars (of the peak) are 1e-10 but
where ``BARS`` says otherwise and why.
"""
import numpy as np
import pytest

import _torch_docs as td

DOCS = ['how-tos/telescope-apertures.md', 'how-tos/radiometry.md', 'how-tos/optimization.md',
        'how-tos/polychromatic.md', 'how-tos/polarized-propagation.md',
        'how-tos/advanced-interferogram-processing.md', 'explanation/deformable-mirrors.md',
        'explanation/segmented-systems.md', 'explanation/ins-and-outs-of-polynomials.md']

def _jax_dm(name):
    """The deformable-mirror page's results as the JAX package computes them from the
    page's influence function in float64 (the JAX page rounds it to float32, and its DM
    then computes in float32 under x64 too; the port's page builds it in the working
    dtype), made once a namespace."""
    def of(ns):
        if '_jax_dm' not in ns:
            import jax
            import jax.numpy as jnp
            from prysm_tpu.x.dm import DM
            ifn = np.exp(-(ns['X'] ** 2 + ns['Y'] ** 2) / (2 * ns['sigma'] ** 2))
            render = jax.jit(DM(ifn, Nout=64, Nact=9, sep=ns['pitch']).render_fn(wfe=True))
            acts = jnp.zeros((9, 9)).at[4, 4].set(1.0)
            target = render(acts) * 0.5

            def loss(a):
                return jnp.sum((render(a) - target) ** 2)

            a = acts
            for _ in range(20):
                a = a - 1e-3 * jax.grad(loss)(a)
            ns['_jax_dm'] = dict(sfe=render(acts), g=jax.grad(loss)(acts), a=a)
        return ns['_jax_dm'][name]
    return of


BARS = {
    'explanation/deformable-mirrors.md': {
        name: {'jax': _jax_dm(name)} for name in ('sfe', 'g', 'a')},
}


@pytest.mark.parametrize('relpath', DOCS, scope='module')
def test_port_doc_executes(relpath, monkeypatch, tmp_path):
    """Block by block through the port alone, f64 on the CPU, no kernel launched."""
    td.run_port(relpath, monkeypatch, tmp_path)


@pytest.mark.parametrize('relpath', DOCS, scope='module')
def test_port_doc_matches_jax(relpath, monkeypatch, tmp_path):
    results, tns = td.run_pair(relpath, monkeypatch, tmp_path, BARS.get(relpath, {}))
    td.compare(relpath, results, tns, BARS.get(relpath, {}))
