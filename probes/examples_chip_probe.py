"""Drive ``chip_smoke.py``'s phases 3q and 3r and the examples' phase-4 lines alone on the card.

Run from the repository root on a machine with one CUDA card (~75 s with the
kernels' build):

    env PYTHONPATH=. python3 probes/examples_chip_probe.py

It builds the kernels, starts the spawn worker that computes the examples' f64
CPU reference, then runs ``chip_smoke.phase_examples`` (the five examples in
f32 and f64 against their marks, the CPU and the float32 bars),
``chip_smoke.phase_card_tier`` (the card tier under pytest) and
``chip_smoke.examples_timing`` (the LOWFS frame, a dark-hole and a retrieval
evaluation, the examples' runs), with the checks and the lines those print.
"""
import multiprocessing
import time
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as cs


def main():
    from prysm_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    dev = torch.device('cuda', 0)
    smi = cs.card()
    print(f'card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}', flush=True)
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(_cuda.build, ['zernike', 'noise']))
    workers = multiprocessing.get_context('spawn').Pool(1)
    try:
        ref = workers.apply_async(cs.examples_cpu_reference)
        print(f'phase 3q [{time.perf_counter() - t0:.1f} s]', flush=True)
        cs.reset_launches()
        cs.phase_examples(dev, ref)
        cs.no_kernel_launches('examples')
        print(f'phase 3r [{time.perf_counter() - t0:.1f} s]', flush=True)
        cs.phase_card_tier()
        print(f'phase 4 [{time.perf_counter() - t0:.1f} s]', flush=True)
        cs.examples_timing(smi, dev)
        print(f'done [{time.perf_counter() - t0:.1f} s]', flush=True)
    finally:
        workers.terminate()
        workers.join()


if __name__ == '__main__':
    main()
