"""How the coating design's float32 error on the card depends on where the layer matrices are formed.

Run from the repository root on a machine with a card:

    env PYTHONPATH=. python3 probes/coating_f32_card_probe.py

For the design of ``steps.build_coating_design`` (41 layers, 1024
wavelengths x 2 angles, s and p) it prints, against the same design in
float64 on the card, the float32 merit at the start, its thickness and index
gradients and |R + T - 1| over the merit's grids, for two formations of the
per-layer matrices: in float64 rounded once to float32 (the port's,
``x.coatings.stack._layer_matrices``) and in float32 throughout (as the JAX
package forms them).  The products, fields and merit are float32 in both.
"""
import json
import subprocess

import torch

from prysm_tpu_torch import steps
from prysm_tpu_torch.x.coatings import RTA, stack


def errors(dev):
    out = {}
    for dt in (torch.float32, torch.float64):
        d = steps.build_coating_design(dtype=dt, device=dev)
        f, g = d.problem().fg(d.problem().x0())
        _, gi = d.problem(variables='index').fg(d.problem(variables='index').x0())
        energy = 0.0
        with d.configured():
            for term in d.merit:
                for pol in 'sp':
                    R, T, _ = RTA(d.stack0, term.wvl, term.theta, pol)
                    energy = max(energy, float((R.double() + T.double() - 1).abs().max()))
        out[dt] = (f, g.double(), gi.double(), energy)
    (f32, g32, i32, e32), (f64, g64, i64, _) = out[torch.float32], out[torch.float64]
    return {'merit': abs(f32 - f64) / abs(f64),
            'thickness_gradient': float((g32 - g64).abs().max() / g64.abs().max()),
            'index_gradient': float((i32 - i64).abs().max() / i64.abs().max()),
            'energy': e32}


def main():
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device('cuda', 0)
    wide = errors(dev)
    formed_wide = stack._wide
    stack._wide = lambda v: v
    try:
        narrow = errors(dev)
    finally:
        stack._wide = formed_wide
    print(json.dumps({'card': smi, 'float64-formed (the port)': wide,
                      'float32-formed (as the JAX package)': narrow}, indent=1))


if __name__ == '__main__':
    main()
