"""The main paths: the flagship forward, the gradient steps, and the frames and chains.

Counterparts, without any timing harness, of

* ``__graft_entry__.entry()``: Zernike modes -> anti-aliased circular
  pupil -> FFT focus (Q=2) -> PSF -> MTF at a 1024^2 pupil;
* ``bench.py`` cfg1: the same chain as an L2 PSF loss whose coefficient
  gradient comes from autograd, with the MTF as a deliverable beside the
  loss (not part of it);
* ``bench.py`` cfg2: 1024^2 pupil -> 256^2 focal grid by matrix DFT, the
  phase-retrieval gradient step.  With ``fused=True`` (the default) the
  OPD comes from ``zernike_sum_pallas``, which runs the CUDA kernels on
  the card; ``fused=False`` builds the mode stack instead, as the JAX
  step does when its Pallas kernels are off;
* ``bench.py`` cfg3: a 2-ring hexagonal segmented aperture with
  per-segment piston/tip/tilt at a 512^2 pupil -> Q=2 focus -> 1024^2 PSF
  -> encircled energy at 10 um, and its gradient with respect to the
  (19, 3) segment coefficients, a phasing user's step;
* ``bench.py`` cfg4: a 1024^2 plane-to-plane chain, angular spectrum ->
  thin lens -> angular spectrum -> intensity, with the transfer functions
  and the lens built once as plan tensors;
* ``bench.py`` cfg5: a 6-wavelength Babinet Lyot coronagraph at a 512^2
  pupil -> Q=1 focus -> RGGB mosaic -> detector exposure through the
  noise kernel -> Malvar demosaic.

``build_cfg1_step`` and ``build_cfg2_step`` return a callable that takes
the coefficients and returns the loss and its coefficient gradient (and,
for cfg1, the MTF); ``build_cfg3_step`` one that takes the segment
coefficients and returns the encircled energy, the PSF and the energy's
coefficient gradient; ``build_cfg4_chain`` one that returns the
intensity; ``build_cfg5_frame`` one that takes a seed and returns the
demosaicked frame.
"""
from dataclasses import dataclass

import numpy as np
import torch

from .bayer import composite_bayer, demosaic_malvar
from .conf import config, complex_for
from .coordinates import make_xy_grid, cart_to_polar
from .detector import Detector
from .geometry import circle_sdf, antialias
from .ops.zernike import zernike_sum_pallas
from .otf import mtf_from_psf, encircled_energy, _encircled_energy_rfft_weights
from .parallel import plan_mdft_spectral
from .polynomials import zernike_nm_seq, sum_of_2d_modes
from .propagation import (Wavefront, babinet, focus, prepare_executor,
                          angular_spectrum_transfer_function, pupil_sample_to_psf_sample)
from .segmented import CompositeHexagonalAperture

__all__ = ['NMS6', 'COEFS6', 'WVL', 'EFL', 'Pupil', 'make_pupil', 'entry',
           'build_cfg1_step', 'make_cfg2_plan', 'build_cfg2_step', 'CFG3_NMS',
           'build_cfg3_step', 'build_cfg4_chain', 'CFG5_WVLS', 'CFG5_DETECTOR',
           'build_cfg5_frame']

NMS6 = ((2, 0), (2, 2), (2, -2), (3, 1), (3, -1), (4, 0))
COEFS6 = (20.0, -10.0, 8.0, 5.0, -4.0, 3.0)
WVL, EFL = 0.55, 10.0
DIAMETER = 2.2


@dataclass(frozen=True)
class Pupil:
    """The fixed geometry and starting point of a step."""
    r: torch.Tensor
    t: torch.Tensor
    amp: torch.Tensor
    dx: float
    coefs: torch.Tensor
    nms: tuple


def make_pupil(N=1024, nms=NMS6, coefs=COEFS6, dtype=None, device=None):
    """The flagship pupil: an N^2 grid 2.2 across, a unit anti-aliased circle."""
    x, y = make_xy_grid(N, diameter=DIAMETER, dtype=dtype, device=device)
    dx = DIAMETER / N
    r, t = cart_to_polar(x, y)
    amp = antialias(circle_sdf(1.0, r), dx)
    return Pupil(r=r, t=t, amp=amp, dx=dx,
                 coefs=torch.tensor(coefs, dtype=r.dtype, device=r.device),
                 nms=tuple(nms))


def entry(N=1024, dtype=None, device=None):
    """(forward, example_args): the flagship PSF -> MTF forward, as ``entry()``."""
    x, y = make_xy_grid(N, diameter=DIAMETER, dtype=dtype, device=device)
    dx = float(x[0, 1] - x[0, 0])
    r, t = cart_to_polar(x, y)
    amp = antialias(circle_sdf(1.0, r), dx)
    coefs = torch.tensor(COEFS6, dtype=amp.dtype, device=amp.device)

    def forward(coefs, amp, r, t):
        opd = sum_of_2d_modes(zernike_nm_seq(NMS6, r, t), coefs)
        psf = Wavefront.from_amp_and_phase(amp, opd, WVL, dx).focus(EFL, Q=2).intensity
        return psf.data, mtf_from_psf(psf.data, psf.dx).data

    return forward, (coefs, amp, r, t)


def _value_and_grad(loss_fn, coefs):
    c = coefs.detach().requires_grad_(True)
    loss, *rest = loss_fn(c)
    grad, = torch.autograd.grad(loss, c)
    return (loss.detach(), grad, *rest)


def build_cfg1_step(pupil=None, *, N=1024, dtype=None, device=None):
    """cfg1: FFT focus at Q=2, L2 PSF loss at 0.9 x coefs, coefficient gradient, MTF.

    ``pupil`` defaults to ``make_pupil(N, dtype=dtype, device=device)``.
    """
    if pupil is None:
        pupil = make_pupil(N, dtype=dtype, device=device)
    modes = zernike_nm_seq(pupil.nms, pupil.r, pupil.t)

    def psf(c):
        opd = sum_of_2d_modes(modes, c)
        return Wavefront.from_amp_and_phase(pupil.amp, opd, WVL, pupil.dx) \
            .focus(EFL, Q=2).intensity

    with torch.no_grad():
        I_meas = psf(pupil.coefs).data

    def loss(c):
        I = psf(c * 0.9)
        with torch.no_grad():
            mtf = mtf_from_psf(I.data, I.dx).data
        return torch.sum((I.data - I_meas) ** 2), mtf

    def step(coefs):
        """(loss, coefficient gradient, MTF) at coefs."""
        return _value_and_grad(loss, coefs)

    return step


def make_cfg2_plan(pupil, fN=256, matmul_precision='high'):
    """cfg2's MDFT plan: the pupil's grid -> fN^2 samples 0.25 um apart."""
    N = pupil.r.shape[-1]
    return prepare_executor(pupil.dx, (N, N), 0.25, fN, WVL, EFL,
                            dtype=complex_for(pupil.r.dtype),
                            matmul_precision=matmul_precision,
                            device=pupil.r.device)


def build_cfg2_step(pupil=None, plan=None, fused=True, *, N=1024,
                    fN=256, matmul_precision='high', dtype=None, device=None):
    """cfg2: MDFT focus, L2 intensity loss against 0.5 x coefs, coefficient gradient.

    The fused OPD runs ``zernike_sum_pallas(..., grads='coefs')``: the loss
    does not depend on the grids, so the backward is the coefficient
    cotangent alone.

    ``pupil`` defaults to ``make_pupil(N, dtype=dtype, device=device)`` and
    ``plan`` to ``make_cfg2_plan(pupil, fN, matmul_precision=...)``.
    """
    if pupil is None:
        pupil = make_pupil(N, dtype=dtype, device=device)
    if plan is None:
        plan = make_cfg2_plan(pupil, fN, matmul_precision=matmul_precision)

    def intensity(c):
        if fused:
            opd = zernike_sum_pallas(c, pupil.nms, pupil.r, pupil.t, grads='coefs')
        else:
            opd = sum_of_2d_modes(zernike_nm_seq(pupil.nms, pupil.r, pupil.t), c)
        E = Wavefront.from_amp_and_phase(pupil.amp, opd, WVL, pupil.dx).focus_dft(plan)
        return E.intensity.data

    with torch.no_grad():
        I_meas = intensity(pupil.coefs * 0.5)

    def loss(c):
        return (torch.sum((intensity(c) - I_meas) ** 2),)

    def step(coefs):
        """(loss, coefficient gradient) at coefs."""
        return _value_and_grad(loss, coefs)

    return step


# bench.py cfg3: the grid's extent (mm), the aperture (rings, flat-to-flat
# segment diameter and gap, mm), the per-segment modes, and the encircled
# energy's radius (um)
CFG3_DIAMETER, CFG3_RINGS, CFG3_SEGMENT, CFG3_GAP = 2.4, 2, 0.4, 0.007
CFG3_NMS = ((0, 0), (1, -1), (1, 1))
CFG3_EE_RADIUS = 10.0


class _Cfg3Step:
    """The cfg3 phasing step; call it with the (19, 3) segment coefficients.

    Planned once: the aperture from a host grid (``aperture``, ``amp``),
    its per-segment piston/tip/tilt bases, the starting coefficients
    ``coefs`` (``np.random.default_rng(7)``, scale 20 nm, as bench.py), and
    the encircled energy's half-plane weights for the 1024^2 PSF.
    ``forward(c)`` gives (EE, PSF); calling the step gives (EE, PSF, dEE/dc).
    """

    def __init__(self, N, dtype=None, device=None):
        dtype = config.precision if dtype is None else dtype
        x, y = make_xy_grid(N, diameter=CFG3_DIAMETER, host=True, dtype=dtype)
        self.dx = CFG3_DIAMETER / N
        self.aperture = CompositeHexagonalAperture(x, y, CFG3_RINGS, CFG3_SEGMENT, CFG3_GAP,
                                                   device=device)
        self.aperture.prepare_opd_bases(zernike_nm_seq, CFG3_NMS)
        self.amp = self.aperture.amp
        nseg = len(self.aperture.segment_ids)
        coefs = np.random.default_rng(7).normal(scale=20.0, size=(nseg, len(CFG3_NMS)))
        self.coefs = torch.from_numpy(coefs.astype(np.float32)).to(self.amp.device, dtype)
        # the PSF's geometry is fixed: build the encircled energy's weights now
        M = 2 * N
        _encircled_energy_rfft_weights((M, M), pupil_sample_to_psf_sample(self.dx, M, WVL, EFL),
                                       (CFG3_EE_RADIUS,), dtype, self.amp.device)

    def forward(self, c):
        """(encircled energy at 10 um, the 1024^2 PSF) for segment coefficients c."""
        opd = self.aperture.compose_opd(c)
        I = Wavefront.from_amp_and_phase(self.amp, opd, WVL, self.dx).focus(EFL, Q=2).intensity
        return encircled_energy(I.data, I.dx, CFG3_EE_RADIUS), I.data

    def __call__(self, coefs):
        """(EE, PSF, dEE/dcoefs) at coefs."""
        c = coefs.detach().requires_grad_(True)
        ee, psf = self.forward(c)
        grad, = torch.autograd.grad(ee, c)
        return ee.detach(), psf.detach(), grad


def build_cfg3_step(N=512, dtype=None, device=None):
    """cfg3: the segmented-aperture PSF, its encircled energy at 10 um and the energy's gradient.

    A 2-ring hexagonal aperture (19 segments) of 0.4 mm segments 7 um
    apart on an N^2 grid 2.4 mm across, piston/tip/tilt per segment,
    Q=2 focus.  Returns a callable ``step(coefs)`` giving (EE, PSF,
    dEE/dcoefs); ``step.coefs`` holds the starting coefficients and
    ``step.forward(coefs)`` the forward alone.
    """
    return _Cfg3Step(N, dtype=dtype, device=device)


# bench.py cfg4: the grid's extent (mm), the aperture radius (mm), the lens's
# focal length and the two propagation distances (mm)
CFG4_DIAMETER, CFG4_RADIUS, CFG4_EFL, CFG4_Z1, CFG4_Z2 = 10.0, 4.0, 150.0, 50.0, 100.0


class _Cfg4Chain:
    """The cfg4 plane-to-plane chain; calling it gives the intensity at the last plane.

    The plan tensors are made once in ``dtype`` on the device, as bench.py
    passes them: the aperture ``amp``, the thin-lens screen ``lens`` and
    the two transfer functions ``tf1``, ``tf2``.
    """

    def __init__(self, N, dtype=None, device=None):
        dtype = config.precision if dtype is None else dtype
        self.dx = CFG4_DIAMETER / N
        x, y = make_xy_grid(N, diameter=CFG4_DIAMETER, dtype=dtype, device=device)
        r, _ = cart_to_polar(x, y)
        self.amp = antialias(circle_sdf(CFG4_RADIUS, r), self.dx)
        self.lens = Wavefront.thin_lens(CFG4_EFL, WVL, x, y, dx=self.dx).data
        self.tf1, self.tf2 = (angular_spectrum_transfer_function(
            (N, N), WVL, self.dx, z, dtype=dtype, device=x.device) for z in (CFG4_Z1, CFG4_Z2))

    def __call__(self, amp=None):
        """|E|^2 after AS(z1) -> lens -> AS(z2), from ``amp`` (default the plan's aperture)."""
        wf = Wavefront.from_amp_and_phase(self.amp if amp is None else amp, None, WVL, self.dx)
        a = wf.free_space(tf=self.tf1)
        b = Wavefront(a.data * self.lens, WVL, self.dx, a.space)
        return b.free_space(tf=self.tf2).intensity.data


def build_cfg4_chain(N=1024, dtype=None, device=None):
    """cfg4: angular spectrum 50 mm -> f = 150 mm thin lens -> angular spectrum 100 mm.

    A circle of radius 4 mm on an N^2 grid 10 mm across at 0.55 um.
    Returns a callable ``chain(amp=None)`` giving the intensity; its
    plan tensors are ``chain.amp``, ``chain.lens``, ``chain.tf1`` and
    ``chain.tf2``.
    """
    return _Cfg4Chain(N, dtype=dtype, device=device)


# bench.py cfg5: six wavelengths (um), the focal window and the detector
CFG5_WVLS = tuple(float(w) for w in np.linspace(0.50, 0.60, 6))
CFG5_WINDOW, CFG5_FOCAL_DX, CFG5_FPM_RADIUS, CFG5_LYOT_RADIUS = 32, 0.25, 2.5, 0.9
CFG5_DETECTOR = dict(dark_current=2.0, read_noise=5.0, bias=100.0, fwc=60e3,
                     conversion_gain=0.5, bits=14, exposure_time=1e-2)
# photons per unit of focal intensity, as bench.py scales the colour planes
CFG5_PHOTONS = 3e9


class _Cfg5Frame:
    """The cfg5 camera frame; call it with a seed to get one (N, N, 3) frame.

    The fixed pieces are made once: the wavelength-stacked MDFT plan to a
    32^2 window around the occulter, the occulter ``fpm`` (0 inside the
    2.5 um radius), the unit pupil ``amp``, the ``lyot`` stop of radius 0.9
    and the ``detector``.  ``mosaic()`` is the deterministic part of the
    chain (Babinet coronagraph, Q=1 focus, |E|^2 summed into R, G and B,
    RGGB mosaic) and ``focal_planes()`` its per-wavelength intensities.
    """

    def __init__(self, N, dtype=None, device=None):
        dtype = config.precision if dtype is None else dtype
        dx = DIAMETER / N
        self.N = N
        # Babinet runs on the complement 1 - fpm, zero outside the occulting
        # disk, so the focal window need only cover the disk (10 px radius)
        fw = (np.arange(CFG5_WINDOW) - CFG5_WINDOW // 2) * CFG5_FOCAL_DX
        fxw, fyw = np.meshgrid(fw, fw, indexing='xy')
        self.plan = plan_mdft_spectral(dx, (N, N), CFG5_FOCAL_DX, CFG5_WINDOW, CFG5_WVLS, EFL,
                                       dtype=complex_for(dtype), device=device)
        dev = self.plan.Ex.device
        self.fpm = torch.from_numpy(np.hypot(fxw, fyw) > CFG5_FPM_RADIUS).to(dev, dtype)
        x, y = make_xy_grid(N, diameter=DIAMETER, dtype=dtype, device=dev)
        r = torch.hypot(x, y)
        self.amp = antialias(circle_sdf(1.0, r), dx)
        self.lyot = antialias(circle_sdf(CFG5_LYOT_RADIUS, r), dx)
        self.detector = Detector(**CFG5_DETECTOR)

    def focal_planes(self):
        """(6, N, N) focal intensities behind the coronagraph, one per wavelength."""
        W = len(CFG5_WVLS)
        E = self.amp.expand(W, self.N, self.N).to(complex_for(self.amp.dtype))
        after = babinet(E, lyot=self.lyot, fpm=self.fpm, executor=self.plan)
        at_focus = focus(after, Q=1)
        return at_focus.real ** 2 + at_focus.imag ** 2

    def mosaic(self, planes=None):
        """The RGGB mosaic of the colour planes (the two longest wavelengths red)."""
        if planes is None:
            planes = self.focal_planes()
        red = planes[4:].sum(dim=0) * CFG5_PHOTONS
        grn = planes[2:4].sum(dim=0) * CFG5_PHOTONS
        blu = planes[:2].sum(dim=0) * CFG5_PHOTONS
        return composite_bayer(red, grn, grn, blu)

    def __call__(self, seed=0):
        """The demosaicked (N, N, 3) float32 frame of one exposure.

        The JAX benchmark runs this chain under jit, where the scene is a
        tracer and ``expose``'s 'auto' policy takes the fused kernel.  Here
        the scene is concrete, and 'auto' would see its photon-starved
        pixels (the occulted core) and take exact Poisson instead; the
        frame therefore asks for the kernel, as the JAX frame gets it.
        """
        frame = self.detector.expose(self.mosaic(), seed=seed, method='fused')
        return demosaic_malvar(frame.to(torch.float32))


def build_cfg5_frame(N=512, dtype=None, device=None):
    """cfg5: the coronagraph -> Bayer -> detector -> demosaic frame at an N^2 pupil.

    Returns a callable ``frame(seed=0)`` giving the demosaicked (N, N, 3)
    float32 frame; ``frame.mosaic()`` and ``frame.focal_planes()`` give the
    deterministic part of the chain, ``frame.detector`` the detector.
    """
    return _Cfg5Frame(N, dtype=dtype, device=device)
