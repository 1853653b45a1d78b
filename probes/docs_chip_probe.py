"""Drive ``chip_smoke.py``'s phase 3s (the port's executed docs) alone on the card.

Run from the repository root on a machine with one CUDA card (~1-2 min with
the kernels' build):

    env PYTHONPATH=. python3 probes/docs_chip_probe.py

It builds the kernels, starts the spawn worker that runs the docs in f64 on
the CPU, then runs ``chip_smoke.phase_docs``: every executed doc of
``docs/torch/`` on the card in f32 and f64, the f64 runs against the CPU's,
the f32 runs against f64, the kernels' launches, each doc's wall seconds,
with the checks and the lines phase 3s prints.
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
    print(f'card: {cs.card()}; torch {torch.__version__}, CUDA {torch.version.cuda}',
          flush=True)
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(_cuda.build, ['zernike', 'noise']))
    workers = multiprocessing.get_context('spawn').Pool(1)
    try:
        ref = workers.apply_async(cs.docs_cpu_reference)
        print(f'phase 3s [{time.perf_counter() - t0:.1f} s]', flush=True)
        launches = cs.phase_docs(dev, ref)
        print(f'  launches over the phase: {launches}', flush=True)
        print(f'done [{time.perf_counter() - t0:.1f} s]', flush=True)
    finally:
        workers.terminate()
        workers.join()


if __name__ == '__main__':
    main()
