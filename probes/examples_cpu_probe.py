"""The five examples' float32 figures on the CPU: the JAX package's own and the port's.

Run from the repository root (no card needed; ~3 min):

    env PYTHONPATH=. JAX_PLATFORMS=cpu python3 probes/examples_cpu_probe.py

It runs each of the JAX package's examples (``examples/*.py``, loaded as
``tests/test_examples.py`` loads them) at its default size in float32 (x64
off) and in float64 (x64 on), and the port's (``prysm_tpu_torch.examples``)
on the CPU in both precisions.  It prints, for every quantity phase 3q of
``chip_smoke.py`` holds a float32 run to, the JAX package's float32 figure,
the port's on the CPU, and the bar: twice the JAX package's figure, or the
floor ``chip_smoke.EXAMPLE_FLOORS`` gives where that is larger.  The figures
are ``chip_smoke.example_figures``':

* LOWFS (256^2 -> 64^2): the worst estimation error (nm); the reconstructor
  R and the operating-point frame I0 against float64 (max |a - b| / max |b|);
* the dark hole (128^2 -> 64^2): the dark energy at zero and its gradient
  against float64 (relative, of the largest), and the suppression's relative
  departure from float64's;
* the retrieval (256^2 -> 96^2): the recovered coefficients' worst error (nm);
* the lens: the start merit (relative), the solved EFL's distance from 100
  (mm), and the curvature tolerances (relative, the largest);
* the coating: the start band reflectance and the refined merit (relative).

These are CPU numbers: they say how float32 rounding propagates through each
example, not what the card does.
"""
import contextlib
import runpy

import numpy as np
import torch

import jax

from chip_smoke import EXAMPLE_FLOORS, example_figures, examples_run

torch.set_num_threads(4)
jax.config.update('jax_platforms', 'cpu')


@contextlib.contextmanager
def recording(owner, name):
    """``owner.name`` wrapped for the block: a list of each call's (args, kwargs, result)."""
    original, log = getattr(owner, name), []

    def wrapped(*args, **kwargs):
        out = original(*args, **kwargs)
        log.append((args, kwargs, out))
        return out

    setattr(owner, name, wrapped)
    try:
        yield log
    finally:
        setattr(owner, name, original)


def jax_run(x64):
    """Each JAX example at its default size: what the figures need."""
    jax.config.update('jax_enable_x64', x64)
    import prysm_tpu.x.optym as jopt
    import prysm_tpu.x.raytracing as jrt
    import prysm_tpu.x.coatings as jcoat
    from prysm_tpu.x.raytracing.design import _TraceCache
    out = {}
    mod = runpy.run_path('examples/lowfs_realtime.py')
    setup = mod['build']()
    out['R'], out['I0'] = mod['reconstructor'](setup)
    out['lowfs'] = mod['main']()
    mod = runpy.run_path('examples/coronagraph_dark_hole.py')
    with recording(jopt, 'PrysmLBFGSB') as made:
        out['suppression'] = mod['main']()
    fg, x0 = made[0][0][:2]
    out['e0'], out['g0'] = fg(x0)
    out['retrieval'] = runpy.run_path('examples/phase_retrieval.py')['main']()
    mod = runpy.run_path('examples/lens_design.py')
    with recording(jrt.Problem, 'merit') as merits, \
            recording(jrt.adjoint, 'inverse_sensitivity') as tols:
        system = mod['main']()
    out['m0'], out['tol'] = merits[0][2], tols[0][2]
    out['efl'] = float(jrt.EFL()(system, _TraceCache(system)))
    mod = runpy.run_path('examples/coating_design.py')
    with recording(jcoat, 'RTA') as rtas, recording(jcoat, 'refine') as refines:
        out['R1'] = mod['main']()
    out['R0'] = float(np.asarray(rtas[0][2][0]).mean())
    out['coating_merit'] = refines[0][2].merit
    return {k: (np.asarray(v, np.float64) if k in ('R', 'I0', 'g0', 'tol') else float(v))
            for k, v in out.items()}


def main():
    jax32 = example_figures(jax_run(False), jax_run(True))
    port32 = example_figures(examples_run('cpu', torch.float32),
                             examples_run('cpu', torch.float64))
    print(f'{"quantity":18s} {"JAX f32":>11s} {"port f32":>11s} {"bar":>11s}')
    for name, value in jax32.items():
        bar = max(2 * value, EXAMPLE_FLOORS.get(name, 0.0))
        print(f'{name:18s} {value:11.3e} {port32[name]:11.3e} {bar:11.3e}')
    print('EXAMPLE_JAX_F32 = {' + ', '.join(f"'{k}': {v:.3g}" for k, v in jax32.items()) + '}')


if __name__ == '__main__':
    main()
