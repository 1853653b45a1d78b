"""The JAX package's multi-device ``tools/`` on the port.

``scaling_bench`` (weak scaling of the sharded broadband step) and
``profile_overlap`` (the runtime trace of the per-chunk all-reduces of
``parallel.overlap``).  Each spawns its ranks: NCCL over one card a rank,
or gloo on the CPU with ``--cpu``.  Run one with
``python -m prysm_tpu_torch.tools.<name>``.
"""
