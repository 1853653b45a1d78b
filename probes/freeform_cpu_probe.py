"""Rehearse the freeform fit's float32 errors on the CPU, and the mode norms' summation.

Run from the repository root (no card needed):

    env PYTHONPATH=. python3 probes/freeform_cpu_probe.py [N ...]

For each N (default 64 and 256) it builds ``steps.build_freeform_fit`` in
float32 and float64 on the CPU and prints, over the unit disk, the errors
that phase 3f of ``chip_smoke.py`` reads on the card (the Q2d sag against
its peak, the ``lstsq`` coefficients against the largest one), and the
float32 masked RMS of the 36 fitted modes taken two ways against
float64 (piston, whose RMS is 0, left out): by one matrix-vector product
per mean and variance, as the JAX package's ``normalize_modes`` takes it,
and by ``_mode_norms``' pairwise sums.  CPU numbers: they say how
float32 sums drift, not what the card does.
"""
import sys

import torch

from prysm_tpu_torch import steps
from prysm_tpu_torch.polynomials import zernike_nm_seq
from prysm_tpu_torch.polynomials.fitting import _mode_norms


def matvec_norms(modes, mask):
    """Each mode's masked RMS by matrix-vector products (the JAX package's form)."""
    flat = modes.reshape(modes.shape[0], -1)
    w = mask.reshape(-1).to(flat.dtype)
    n = torch.sum(w)
    mean = (flat @ w) / n
    return torch.sqrt(((flat - mean[:, None]) ** 2 @ w) / n)


def masked_rel(a, b, mask):
    a, b = a.double()[mask], b.double()[mask]
    return float((a - b).abs().max() / b.abs().max())


def main(sizes):
    for N in sizes:
        f32 = steps.build_freeform_fit(N, dtype=torch.float32, device='cpu')
        f64 = steps.build_freeform_fit(N, dtype=torch.float64, device='cpu', fused=False)
        out, ref = f32(), f64()
        raw32 = zernike_nm_seq(steps.FREEFORM_FIT_NMS, f32.u, f32.t)
        raw64 = zernike_nm_seq(steps.FREEFORM_FIT_NMS, f64.u, f64.t)
        exact = matvec_norms(raw64, f64.mask)
        keep = exact > 1e-9  # piston has no RMS to compare
        rel = lambda a: float(((a.double() - exact) / exact)[keep].abs().max())  # noqa: E731
        c = float((out['coefs'].double() - ref['coefs']).abs().max() / ref['coefs'].abs().max())
        print(f'{N}^2 on the CPU, {int(f32.mask.sum())} pixels in the disk: '
              f'sag {masked_rel(out["z"], ref["z"], f32.mask):.3e} of peak, '
              f'lstsq coefficients {c:.3e} of max |c|; f32 mode RMS by matrix-vector '
              f'products {rel(matvec_norms(raw32, f32.mask)):.3e}, by pairwise sums '
              f'{rel(_mode_norms(raw32, f32.mask)):.3e} (relative to f64)', flush=True)


if __name__ == '__main__':
    main([int(a) for a in sys.argv[1:]] or [64, 256])
