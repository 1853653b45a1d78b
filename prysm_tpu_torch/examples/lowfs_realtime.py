"""Low-order wavefront sensing (LOWFS) at real-time rates.

The reference library's headline deployment is lowfssim, the NASA Roman
Coronagraph low-order wavefront sensor model, advertised at >2 kHz frame
rate.  This example builds the same shape of model on the port's API and
measures the closed-loop sensing rate on the card.

Model: an obscured pupil with a defocus bias (the LOWFS operating point),
a matrix DFT to a small focal-plane camera, a linear least-squares
reconstructor from the intensity Jacobian at the operating point, and the
estimation step

    c_hat = R @ (I_frame - I_0)

which is how real LOWFS loops run (the Jacobian and reconstructor are
computed once offline; per-frame work is one small matmul after the
optical forward model renders the frame).

main() checks estimator accuracy in the linear regime; ``python -m
prysm_tpu_torch.examples.lowfs_realtime`` times the per-frame sensing step
(render + estimate, the full loop body) in a closed loop and reports
frames/s beside the card's name and power limit.
"""
import time

import numpy as np
import torch

from ..conf import config, resolve_device
from ..coordinates import make_xy_grid, cart_to_polar
from ..geometry import annulus_sdf, spider_sdf, subtract, antialias
from ..polynomials import zernike_nm_seq, sum_of_2d_modes
from ..propagation import Wavefront, prepare_executor
from . import card_name


# low-order modes the sensor estimates: focus, astigmatisms, comas, spherical
NMS = [(2, 0), (2, 2), (2, -2), (3, 1), (3, -1), (4, 0)]
DEFOCUS_BIAS_NM = 300.0     # LOWFS operates off a deliberate defocus bias


def build(N=256, fN=64, wvl=0.55, efl=10.0, device=None):
    """Setup: pupil geometry, focal plan, bias OPD, on ``device`` (``config.device``)."""
    dev = resolve_device(device)
    dx = 2.2 / N
    x, y = make_xy_grid(N, diameter=2.2, device=dev)
    r, t = cart_to_polar(x, y)
    d = annulus_sdf(0.31, 1.0, r)                     # Roman-like obscuration
    d = subtract(d, spider_sdf(3, 0.05, x, y))
    amp = antialias(d, dx)
    modes = zernike_nm_seq(NMS, r, t)                 # (K, N, N)
    bias = DEFOCUS_BIAS_NM * modes[0]                 # defocus operating point
    # matmul_precision stays None: a 'high' plan's matmuls have no forward-mode rule
    plan = prepare_executor(dx, (N, N), 0.25, fN, wvl, efl, device=dev)
    return dict(amp=amp, modes=modes, bias=bias, plan=plan, wvl=wvl, dx=dx)


def render(coefs, amp, modes, bias, plan, wvl, dx):
    """Focal-plane frame for low-order coefficients (nm) on the bias point."""
    opd = bias + sum_of_2d_modes(modes, coefs)
    wf = Wavefront.from_amp_and_phase(amp, opd, wvl, dx)
    return wf.focus_dft(plan).intensity.data


def reconstructor(setup):
    """Linear least-squares LOWFS reconstructor R: (K, fN*fN), and the frame I0.

    Columns of the Jacobian dI/dc at the operating point by forward mode (one
    tangent per mode), pseudo-inverted.  Computed once, offline: how flight
    LOWFS tables are built.
    """
    amp = setup['amp']
    zeros = torch.zeros(len(NMS), dtype=amp.dtype, device=amp.device)

    def fwd(c):
        return render(c, **setup).ravel()

    J = torch.func.jacfwd(fwd)(zeros)                 # (fN*fN, K)
    R = torch.linalg.pinv(J)                          # (K, fN*fN)
    return R, fwd(zeros)


def sense(frame, R, I0):
    """Per-frame estimation: one small matvec."""
    return R @ (frame.ravel() - I0)


def main(N=256, fN=64, amp_nm=3.0, seed=0, device=None):
    """Accuracy check in the linear regime; returns max |error| in nm."""
    setup = build(N=N, fN=fN, device=device)
    R, I0 = reconstructor(setup)

    rng = np.random.default_rng(seed)
    worst = 0.0
    for _ in range(5):
        c_true = torch.as_tensor(rng.uniform(-amp_nm, amp_nm, len(NMS)),
                                 dtype=setup['amp'].dtype, device=setup['amp'].device)
        c_hat = sense(render(c_true, **setup), R, I0)
        worst = max(worst, float(torch.max(torch.abs(c_hat - c_true))))
    return worst


def closed_loop(setup, R, I0, c, K):
    """K closed-loop sensing steps, each estimate feeding the next stimulus, ended by
    one host read (the only synchronisation); the final coefficients' sum."""
    for _ in range(K):
        c = c + 1e-6 * sense(render(c, **setup), R, I0)   # closed-loop feedback
    return float(torch.sum(c))


def frame_seconds(setup, R, I0, K1=64, K2=1024, reps=3):
    """Seconds per closed-loop frame: the slope of the best of ``reps`` loop times
    between K1 and K2 frames, so the loop's fixed cost (the final read) drops out."""
    amp = setup['amp']
    c = torch.tensor([1.0, -0.5, 0.3, 0.2, -0.1, 0.4], dtype=amp.dtype, device=amp.device)

    def timed(K):
        closed_loop(setup, R, I0, c, K)              # warm: allocator, library handles
        best = float('inf')
        for _ in range(reps):
            t0 = time.perf_counter()
            v = closed_loop(setup, R, I0, c, K)
            best = min(best, time.perf_counter() - t0)
            assert np.isfinite(v)
        return best

    return (timed(K2) - timed(K1)) / (K2 - K1)


if __name__ == '__main__':
    setup = build()
    R, I0 = reconstructor(setup)
    per_step = frame_seconds(setup, R, I0)
    rate = 1.0 / per_step
    print(f'LOWFS sensing rate: {rate:,.0f} frames/s '
          f'({rate / 2000:.0f}x the reference lowfssim 2 kHz headline) on '
          f'{card_name(setup["amp"].device)}, {config.precision}')

    err = main()
    print(f'max estimation error at 3 nm stimulus: {err:.4f} nm')
