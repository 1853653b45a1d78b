"""The port's raytracing tutorial (``docs/torch/tutorials/03-raytracing.md``) against the
JAX package's, on the CPU: a file of its own, the JAX side's eager design solve is the
slowest of the docs (~35 s).

The tutorial runs through ``prysm_tpu_torch`` alone on the CPU in float64
with no kernel launched, then beside its JAX twin: the traced histories,
the OPD, the spots, the Seidel sums, the solved curvatures, the sensitivity
Jacobian and the tolerance budget at 1e-10 of their peaks
(``_torch_docs``).
"""
import _torch_docs as td

DOC = 'tutorials/03-raytracing.md'


def test_port_doc_executes(monkeypatch, tmp_path):
    """Block by block through the port alone, f64 on the CPU, no kernel launched."""
    td.run_port(DOC, monkeypatch, tmp_path)


def test_port_doc_matches_jax(monkeypatch, tmp_path):
    results, tns = td.run_pair(DOC, monkeypatch, tmp_path, {})
    td.compare(DOC, results, tns, {})
