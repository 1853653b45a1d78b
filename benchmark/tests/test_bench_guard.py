"""The check that no run loads JAX or the JAX package, by whole top-level names."""
from benchmark.harness.guard import forbidden_modules


def test_port_passes():
    assert forbidden_modules(['prysm_tpu_torch', 'prysm_tpu_torch.ops.zernike', 'torch',
                              'jaxtyping', 'flaxen', 'benchmark.harness']) == []


def test_jax_and_the_package_are_found():
    found = forbidden_modules(['jax.numpy', 'jaxlib', 'flax.linen', 'prysm_tpu.ops',
                               'prysm_tpu', 'numpy'])
    assert found == ['flax', 'jax', 'jaxlib', 'prysm_tpu']


def test_harness_loads_neither():
    import sys
    import benchmark.harness.execute  # noqa: F401
    import benchmark.reference.wfc1024  # noqa: F401
    before = set(forbidden_modules(sys.modules))
    import benchmark.harness.ranks  # noqa: F401
    assert set(forbidden_modules(sys.modules)) == before
