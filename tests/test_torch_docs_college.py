"""The port's college lessons (``docs/torch/college/``) against the JAX package's, on the CPU.

Each lesson runs through ``prysm_tpu_torch`` alone on the CPU in float64,
in a ``tmp_path`` working directory (104 writes there), with no kernel
launched; then beside its JAX twin, whose results it must match
(``_torch_docs``).  Bars (of the peak) are 1e-10 but where ``BARS`` says
otherwise and why.  The kernel lesson (102) has no JAX counterpart of its
results: its synthesis is held to the JAX package's ``zernike_sum`` on the
same grid, its frame to the noise chain's analytic moments.
"""
import math

import numpy as np
import pytest

import _torch_docs as td

DOCS = ['college/101-how-prysm-tpu-works.md', 'college/102-precision-and-dispatch.md',
        'college/103-coordinates-grids-and-units.md', 'college/104-richdata-and-io.md',
        'college/201-zernikes-on-a-circle.md', 'college/202-other-bases-and-derivatives.md',
        'college/203-orthogonalizing-arbitrary-apertures.md',
        'college/204-forbes-q-and-clenshaw.md', 'college/205-analytic-derivatives-payoff.md',
        'college/301-a-first-diffraction-model.md', 'college/302-fixed-sampling-dft.md',
        'college/303-pupils-apertures-and-the-psf.md',
        'college/304-coronagraphs-and-dark-holes.md']


def _jax_synthesis(ns):
    """102's ``W`` as the JAX package computes it on the same grid."""
    import jax.numpy as jnp
    from prysm_tpu.coordinates import make_xy_grid
    from prysm_tpu.polynomials import zernike_sum
    x, y = make_xy_grid(256, diameter=2.0)
    return zernike_sum(jnp.asarray([20.0, -10.0, 5.0, 3.0]), [(2, 0), (2, 2), (3, 1), (4, 0)],
                       x, y)


def _analytic_frame(got, want):
    """102's frame: 500 e- a pixel, 10 e- of read noise, 800 of bias, 1 e-/DN: mean 1300 DN
    and spread sqrt(500 + 10^2) DN, to five standard errors of 16,384 pixels."""
    assert want is None
    mean, std = 1300.0, math.sqrt(500.0 + 100.0)
    assert abs(np.mean(got) - mean) < 5 * std / 128
    assert abs(np.std(got) / std - 1) < 5 / math.sqrt(2 * got.size)


BARS = {
    'college/102-precision-and-dispatch.md': {
        'W': {'jax': _jax_synthesis},
        'frame': {'jax': lambda ns: None, 'check': _analytic_frame,
                  'why': 'a noise draw: held to its analytic moments'}},
}


@pytest.mark.parametrize('relpath', DOCS, scope='module')
def test_port_doc_executes(relpath, monkeypatch, tmp_path):
    """Block by block through the port alone, f64 on the CPU, no kernel launched."""
    td.run_port(relpath, monkeypatch, tmp_path)


@pytest.mark.parametrize('relpath', DOCS, scope='module')
def test_port_doc_matches_jax(relpath, monkeypatch, tmp_path):
    results, tns = td.run_pair(relpath, monkeypatch, tmp_path, BARS.get(relpath, {}))
    td.compare(relpath, results, tns, BARS.get(relpath, {}))
