"""Rehearse the wavefront-control path's float32 errors and the instruments' checks on the CPU.

Run from the repository root (no card needed, ~1 min at 1024^2):

    env PYTHONPATH=. python3 probes/wfc_cpu_probe.py [N]

At N (default 1024) it builds ``steps.build_wavefront_control`` in float32
and, from the same grids cast, in float64 (both with float32 MDFT
products: the CPU has no TF32), and prints the float32 errors that phase 3l
of ``chip_smoke.py`` holds on the card: the OPD, the PSF, both gradients,
the loss and the Shack-Hartmann frame; beside them the frame with a
lenslet screen built on the float32 grid (the samples on two lenslets'
edges then differ), and the folded DM's ``render_adjoint`` chain against
autograd in float64.  Then, at 256^2, the PSPDI's 4-step recovery against
the true phase in float64 with the default pinhole and with phase 3m's.

The float64 reference and the PSPDI recovery are ``chip_smoke.py``'s own
(``wfc_reference``, ``pspdi_recovery``).  These are CPU numbers: they say
how float32 rounding propagates through the algorithm, not what the card
does.
"""
import math
import sys

import torch

from chip_smoke import pspdi_recovery, wfc_reference
from prysm_tpu_torch import steps
from prysm_tpu_torch.conf import precision_as
from prysm_tpu_torch.coordinates import make_xy_grid, cart_to_polar
from prysm_tpu_torch.geometry import circle_sdf, antialias
from prysm_tpu_torch.polynomials import zernike_nm_seq, sum_of_2d_modes
from prysm_tpu_torch.x import pdi, psi
from prysm_tpu_torch.x.shack_hartmann import shack_hartmann

torch.set_num_threads(4)


def rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max())


def wavefront_control(N):
    nact, fN = (steps.WFC_NACT, 256) if N == 1024 else (max(2, N * steps.WFC_NACT // 1024), 64)
    w32 = steps.build_wavefront_control(N, nact=nact, fN=fN, matmul_precision=None,
                                        dtype=torch.float32, device='cpu')
    w64 = wfc_reference(w32, fN)
    p, p64 = w32.pupil, w64.pupil
    a32, a64 = w32.dm.actuators, w64.dm.actuators
    opd32, opd64 = w32.opd(a32, p.coefs), w64.opd(a64, p64.coefs)
    out32, out64 = w32(a32, p.coefs), w64(a64, p64.coefs)
    frame32, frame64 = w32.sensor(a32, p.coefs), w64.sensor(a64, p64.coefs)
    print(f'wavefront control at {N}^2, {nact} x {nact} actuators, {fN}^2 focal samples '
          '(float32 vs float64 from the same grids):')
    for what, err in (('OPD (peak rel)', rel(opd32, opd64)),
                      ('PSF (peak rel)', rel(w32.psf(opd32), w64.psf(opd64))),
                      ('actuator gradient (rel)', rel(out32[1], out64[1])),
                      ('coefficient gradient (rel)', rel(out32[2], out64[2])),
                      ('loss (rel)', rel(out32[0], out64[0])),
                      ('Shack-Hartmann frame (peak rel)', rel(frame32, frame64))):
        print(f'  {what:34s} {err:.3e}')
    n, pitch, efl = steps.sh_geometry(N)
    x, y = make_xy_grid(N, diameter=2.2, device='cpu')
    w32.screen = shack_hartmann(pitch, n, efl, steps.WVL, x, y, shift=True)
    shared = (torch.angle(w32.screen * w64.screen.conj()).abs() > 1e-3).sum()
    print(f'  the frame with a screen built on the float32 grid: '
          f'{rel(w32.sensor(a32, p.coefs), frame64):.3e} of peak ({int(shared)} samples differ)')
    opd = w64.opd(a64, p64.coefs).detach().requires_grad_(True)
    g, = torch.autograd.grad(torch.sum((w64.psf(opd) - w64.I_ref) ** 2), opd)
    print(f'  the folded DM: render_adjoint of the OPD cotangent vs autograd (float64) '
          f'{rel(w64.dm.render_adjoint(g), out64[1]):.4e}')


def pspdi(N=256, epd=10.0, efl=100.0, wvl=0.55):
    with precision_as(torch.float64):
        x, y = make_xy_grid(N, diameter=epd * 1.1, device='cpu')
        r, t = cart_to_polar(x, y)
        amp = antialias(circle_sdf(epd / 2, r), float(x[0, 1] - x[0, 0]))
        phase = sum_of_2d_modes(
            zernike_nm_seq(((2, 0), (2, 2), (3, -1), (3, 3), (4, 0)), r / (epd / 2), t),
            torch.tensor([20.0, -15.0, 10.0, 8.0, -6.0], dtype=torch.float64)) * (
                2 * math.pi / (wvl * 1e3))
        wave = amp * torch.polar(torch.ones_like(phase), phase)
        scheme = psi.design_scheme(4, stepsize=math.pi / 2)
        inner = r < 0.9 * epd / 2
        print(f'PSPDI at {N}^2, 4 steps, phase rms {float(phase[inner].std()):.4f} rad '
              '(recovered minus the truth, piston removed, r <= 0.9):')
        for pinhole in (0.25, 3.0):
            device = pdi.PSPDI(x, y, efl, epd, wvl, pinhole_diameter=pinhole)
            _, miss = pspdi_recovery(device, wave, amp, phase, inner, scheme)
            print(f'  pinhole_diameter {pinhole:g}: {float(miss.std()):.3e} rad rms')


if __name__ == '__main__':
    wavefront_control(int(sys.argv[1]) if len(sys.argv) > 1 else 1024)
    pspdi()
