"""The check that no run loads the JAX package or JAX: whole top-level module names."""
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'prysm_tpu')


def forbidden_modules(names):
    """The forbidden top-level names among module names (the part before the first dot,
    compared whole: ``prysm_tpu_torch`` is not ``prysm_tpu``)."""
    return sorted({str(n).split('.')[0] for n in names} & set(FORBIDDEN))
