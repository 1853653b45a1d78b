"""Dig a dark hole behind a vortex Lyot coronagraph.

An aberrated pupil leaks starlight into the focal plane; Zernike-basis
wavefront control minimizes the energy in an annular dark zone with
gradients (autograd) through Babinet propagation.  Swap the mesh-sharded
variants from prysm_tpu_torch.parallel to run the level stack across cards.
"""
import numpy as np
import torch

from ..conf import config, resolve_device
from ..coordinates import make_xy_grid, cart_to_polar
from ..geometry import circle_sdf, antialias
from ..polynomials import zernike_nm_seq, sum_of_2d_modes
from ..propagation import Wavefront, prepare_executor
from ..propagation.dft import focus_dft, coordinates_for_focus
from ..propagation.coronagraph import vortex_phase_mask, babinet
from ..x import optym


def dark_hole(N=128, fN=64, wvl=0.55, efl=10.0, seed=3, device=None):
    """(dark_energy, fg, focal_intensity, nms): the dark zone's energy as a function of
    the control coefficients (nm), its value and gradient, and the focal intensity.

    The pupil, its modes, the Lyot stop, the masks and the aberration are built
    once, on ``device`` (``config.device``) in ``config.precision``.
    """
    dev = resolve_device(device)
    real, cplx = config.precision, config.precision_complex
    dx = 2.2 / N
    fdx = 0.25
    nms = [(n, m) for n in range(2, 5) for m in range(-n, n + 1, 2)]
    plan = prepare_executor(dx, (N, N), fdx, fN, wvl, efl, device=dev)

    _, _, fx, fy = coordinates_for_focus(dx, (N, N), fdx, fN, wvl, efl)
    fxx, fyy = np.meshgrid(fx * wvl * efl, fy * wvl * efl)
    fpm = torch.as_tensor(vortex_phase_mask(2)(fxx, fyy), dtype=cplx, device=dev)
    fr = np.hypot(fxx, fyy)
    dark = torch.as_tensor((fr > 1.5) & (fr < 5.5), dtype=real, device=dev)
    rng = np.random.default_rng(seed)
    aberr_coefs = torch.as_tensor(25.0 * rng.standard_normal(len(nms)), dtype=real,
                                  device=dev)

    x, y = make_xy_grid(N, diameter=2.2, device=dev)
    r, t = cart_to_polar(x, y)
    amp = antialias(circle_sdf(1.0, r), dx)
    modes = zernike_nm_seq(nms, r, t)
    lyot = antialias(circle_sdf(0.88, r), dx)
    aberration = sum_of_2d_modes(modes, aberr_coefs)

    def focal_field(c):
        opd = aberration + sum_of_2d_modes(modes, c)
        wf = Wavefront.from_amp_and_phase(amp, opd, wvl, dx)
        return focus_dft(babinet(wf.data, lyot, fpm, plan), plan)

    def focal_intensity(c):
        img = focal_field(c)
        return img.real ** 2 + img.imag ** 2

    def dark_energy(c):
        return torch.sum(focal_intensity(c) * dark)

    def fg(c):
        c = c.detach().requires_grad_(True)
        with torch.enable_grad():
            e = dark_energy(c)
        g, = torch.autograd.grad(e, c)
        return e.detach(), g

    return dark_energy, fg, focal_intensity, nms


def main(N=128, fN=64, wvl=0.55, efl=10.0, seed=3, plot=False, device=None):
    dark_energy, fg, focal_intensity, nms = dark_hole(N, fN, wvl, efl, seed, device)
    zeros = torch.zeros(len(nms), dtype=config.precision, device=resolve_device(device))
    with torch.no_grad():
        e0 = float(dark_energy(zeros))
    opt = optym.PrysmLBFGSB(fg, zeros)
    optym.run_until(opt, optym.MaxIterations(120))
    with torch.no_grad():
        e1 = float(dark_energy(opt.x))
    print(f'dark-zone energy: {e0:.3e} -> {e1:.3e} '
          f'({e0 / e1:.0f}x suppression, {len(nms)} control modes)')

    if plot:
        import matplotlib.pyplot as plt
        with torch.no_grad():
            I = focal_intensity(opt.x)
        plt.imshow(np.log10(np.maximum(I.cpu().numpy(), 1e-12)))
        plt.show()
    return e0 / e1


if __name__ == '__main__':
    main(plot=False)
