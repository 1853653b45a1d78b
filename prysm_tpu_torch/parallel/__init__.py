"""Wavelength-stacked propagation (counterpart of ``prysm_tpu/parallel/``, its broadband part).

Only ``broadband.py`` is ported so far: it runs on one card as one batched
matmul pair per direction.  The mesh and sharding modules wait for the
port to ``torch.distributed``.
"""
from .broadband import (  # NOQA
    SpectralMDFT, plan_mdft_spectral, spectral_focus, spectral_unfocus,
    spectral_babinet,
)
