"""Focus-diverse phase retrieval with gradients through the whole model.

Builds a synthetic pupil with known Zernike aberrations, renders two
defocus-diverse focal-plane images, then recovers the coefficients with
L-BFGS-B driven by autograd through pupil synthesis + matrix DFT.  The
pupil, its modes and the plan are built once; the optimizer's small host
math reads the loss and slopes back each iteration.
"""
import numpy as np
import torch

from ..conf import config, resolve_device
from ..coordinates import make_xy_grid, cart_to_polar
from ..geometry import circle_sdf, antialias
from ..polynomials import zernike_nm_seq, sum_of_2d_modes
from ..propagation import Wavefront, prepare_executor
from ..x import optym


def retrieval(N=256, fN=96, wvl=0.55, efl=10.0, seed=0, device=None):
    """(fg, truth, nms): the two-image loss's value and gradient, and the true
    coefficients (nm), on ``device`` (``config.device``) in ``config.precision``."""
    dev = resolve_device(device)
    dx = 2.2 / N
    nms = [(2, 0), (2, 2), (2, -2), (3, 1), (3, -1), (4, 0)]
    plan = prepare_executor(dx, (N, N), 0.3, fN, wvl, efl, device=dev)

    x, y = make_xy_grid(N, diameter=2.2, device=dev)
    r, t = cart_to_polar(x, y)
    amp = antialias(circle_sdf(1.0, r), dx)
    modes = zernike_nm_seq(nms, r, t)

    def forward(coefs, sign):
        opd = sum_of_2d_modes(modes, coefs) + sign * (modes[0] * 150.0)
        wf = Wavefront.from_amp_and_phase(amp, opd, wvl, dx)
        return wf.focus_dft(plan).intensity.data

    rng = np.random.default_rng(seed)
    truth = torch.as_tensor(30.0 * rng.standard_normal(len(nms)), dtype=config.precision,
                            device=dev)
    with torch.no_grad():
        I_plus = forward(truth, +1.0)
        I_minus = forward(truth, -1.0)

    def loss(c):
        return (torch.sum((forward(c, +1.0) - I_plus) ** 2)
                + torch.sum((forward(c, -1.0) - I_minus) ** 2))

    def fg(c):
        c = c.detach().requires_grad_(True)
        with torch.enable_grad():
            f = loss(c)
        g, = torch.autograd.grad(f, c)
        return f.detach(), g

    return fg, truth, nms


def main(N=256, fN=96, wvl=0.55, efl=10.0, seed=0, device=None):
    fg, truth, nms = retrieval(N, fN, wvl, efl, seed, device)
    opt = optym.PrysmLBFGSB(fg, torch.zeros_like(truth))
    res = optym.run_until(opt, optym.AnyGovernor([
        optym.MaxIterations(60), optym.GradientTolerance(1e-12)]))
    x, truth = opt.x.cpu().numpy(), truth.cpu().numpy()
    err = np.abs(x - truth).max()
    print(f'truth      : {np.round(truth, 3)}')
    print(f'recovered  : {np.round(x, 3)}')
    print(f'iterations : {res.nit}   max |error| = {err:.2e} nm')
    return err


if __name__ == '__main__':
    main()
