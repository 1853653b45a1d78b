"""Multi-card parallelism: meshes and sharded propagation over torch.distributed.

Counterpart of ``prysm_tpu/parallel/``.  The natural parallel axes of
physical-optics modelling are wavelengths, field points, focal-plane tiles,
resolution levels, pupil rows and rays; they map onto the named axes of a
``DeviceMesh`` over the ranks of a process group (NCCL on the cards, gloo
on the CPU), with the collectives of ``_collectives``.

Differences from the JAX package, by design: a sharded function takes the
whole logical tensors on every rank and slices its own shard; a replicated
result comes back whole on every rank, and a row-sharded one
(``P(axis, None)`` in the JAX package: the distributed focus, the
contraction round trip, the focus-grad step's cotangents) as this rank's
block, where the JAX package returns one global sharded array.
``StackedMultiRes`` holds complex tensors.  ``overlap_evidence`` and
``interleaved_compute`` read XLA's HLO text and are not ported.
"""
from .mesh import make_mesh, make_hybrid_mesh, mesh_axes  # NOQA
from .broadband import (  # NOQA
    SpectralMDFT, plan_mdft_spectral, spectral_focus, spectral_unfocus,
    spectral_babinet,
)
from .sharding import (  # NOQA
    shard_broadband_step, broadband_psf,
)
from .coronagraph import (  # NOQA
    StackedMultiRes, stack_multiresolution, multires_roundtrip,
    shard_multires_roundtrip, shard_multires_babinet,
)
from .mdft_contraction import (  # NOQA
    shard_mdft_contraction, shard_mdft_contraction_roundtrip,
)
from .raytrace import (  # NOQA
    shard_wavefront_fit, shard_merged_trace_rate,
)
