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
  noise kernel -> Malvar demosaic;
* the freeform-surface metrology path: a Forbes Q2d surface's sag and
  slopes on a 1024^2 grid over the unit disk, a least-squares fit of the
  first 36 Noll Zernikes to the sag, its reconstruction through the fused
  Zernike sum and the masked residual RMS, with the other sag families
  that freeform raytracing evaluates (Chebyshev, XY, radial Jacobi,
  Zernike, each with its Cartesian slopes);
* the image-simulation path: a 36-spoke Siemens star convolved with the
  flagship PSF, and blurred by that PSF's OTF, a smear and a jitter;
* ``bench.py`` cfg6: a cemented doublet and a rear singlet (three
  spheres, two model glasses), 3 fields and a hexapolar pupil traced as
  one merged ray bundle, and the gradient of the image-plane RMS spot
  radius with respect to the three curvatures;
* the interferometer-analysis path: 13-frame phase-shifting
  interferometry of a 100 mm flat on a 1024^2 camera, unwrapped, masked,
  with piston, tilt and power removed and spikes clipped, then its
  statistics, PSD, band-limited RMS, azimuthal average, lowpass and slopes;
* the coating designer's path: a 41-layer (HL)^20 H edge filter with
  perturbed thicknesses refined against a reflect / transmit target over
  1024 wavelengths x 2 angles (bounded L-BFGS-B and damped least squares),
  and a broadband AR grown by needle synthesis;
* phase retrieval driven by optym's L-BFGS-B: cfg2's pupil, plan and
  intensity L2 loss as the objective of ``PrysmLBFGSB``, from 0.8 x the
  true coefficients inside a +-60 box;
* the wavefront-control path: a 36-mode aberration through the fused
  Zernike sum plus a folded 50 x 50 DM's WFE, focused by cfg2's MDFT plan,
  the intensity loss against the unaberrated PSF and its gradients with
  respect to the actuators and the coefficients; beside it a
  Shack-Hartmann frame of the same field;
* the lens designer's path on cfg6: the prescription written to Zemax
  and Code V text and read back, optimised by damped least squares over
  the curvatures and glass thicknesses with an EFL constraint, then
  toleranced (sensitivity table, Monte Carlo, wavefront differential),
  its pupil fields focused to PSFs, polarization-traced, and analysed;
* the mesh patterns of ``parallel`` at full width over the ranks of an
  initialised process group: the broadband wavelength x tile step and its
  hybrid-mesh variant, the level-sharded multi-resolution Babinet, the
  contraction-sharded MDFT, the distributed FFT and its gradient step, the
  overlapped gradient and the sharded raytrace fit and trace, each beside
  its serial counterpart.

``build_cfg1_step`` and ``build_cfg2_step`` return a callable that takes
the coefficients and returns the loss and its coefficient gradient (and,
for cfg1, the MTF); ``build_cfg3_step`` one that takes the segment
coefficients and returns the encircled energy, the PSF and the energy's
coefficient gradient; ``build_cfg4_chain`` one that returns the
intensity; ``build_cfg5_frame`` one that takes a seed and returns the
demosaicked frame; ``build_freeform_fit`` one that returns the sag, the
fit and the sag families; ``build_image_chain`` one that returns the two
blurred images; ``build_cfg6_trace`` one that returns the
``RayTraceResult`` of the merged bundle, ``build_cfg6_grad`` one that
returns the spot loss and its curvature gradient, ``build_lens_analysis``
one that returns cfg6's real-aimed Zernike fit, field PSFs and adjoint
sensitivities, ``build_lens_design`` a plan whose methods run the
designer's steps one by one, ``build_metrology`` one
that returns the analysis's results, ``build_coating_design`` one that
returns the two refinements and the synthesis, and
``build_phase_retrieval_lbfgsb`` one that returns the governed run's
result, and ``build_wavefront_control`` one that takes the actuators and
the coefficients and returns the loss and both gradients.
``build_parallel_patterns`` returns {name: ``MeshPattern``}, whose
``sharded`` and ``serial`` callables each return {output: tensor}.
"""
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from .bayer import composite_bayer, demosaic_malvar
from .conf import config, complex_for, device_as, precision_as, resolve_device
from .convolution import apply_transfer_functions, conv
from .coordinates import make_xy_grid, cart_to_polar
from .degradations import jitter_ft, smear_ft
from .detector import Detector
from .fttools import crop_center
from .geometry import circle_sdf, antialias
from .objects import siemensstar
from .ops.zernike import zernike_sum_pallas
from .otf import mtf_from_psf, encircled_energy, _encircled_energy_rfft_weights
from .parallel import plan_mdft_spectral
from .polynomials import (zernike_nm_seq, sum_of_2d_modes, zernike_sum, noll_to_nm,
                          normalize_modes, lstsq, Q2d_nm_c_to_a_b, compute_z_zprime_Q2d,
                          cheby1_2d_sum_der_xy, xy_sum_der_xy, jacobi_radial_sum_der_xy,
                          zernike_sum_der_xy)
from .polynomials.fitting import _mode_norms
from .propagation import (Wavefront, babinet, focus, prepare_executor,
                          angular_spectrum_transfer_function, pupil_sample_to_psf_sample)
from .segmented import CompositeHexagonalAperture

__all__ = ['NMS6', 'COEFS6', 'WVL', 'EFL', 'Pupil', 'make_pupil', 'entry',
           'build_cfg1_step', 'make_cfg2_plan', 'build_cfg2_step', 'CFG3_NMS',
           'build_cfg3_step', 'build_cfg4_chain', 'CFG5_WVLS', 'CFG5_DETECTOR',
           'build_cfg5_frame', 'FREEFORM_Q2D_NMS', 'FREEFORM_FIT_NMS', 'FREEFORM_FAMILIES',
           'freeform_coefficients', 'build_freeform_fit', 'build_image_chain',
           'CFG6_CURVATURES', 'CFG6_THICKNESSES', 'CFG6_GLASSES', 'CFG6_FIELDS', 'CFG6_EPD',
           'CFG6_STOP', 'CFG6_RINGS', 'cfg6_system', 'build_cfg6_trace', 'build_cfg6_grad',
           'METROLOGY_DIAMETER', 'METROLOGY_SEED', 'METROLOGY_PSD', 'METROLOGY_PSD_RMS',
           'METROLOGY_ZERNIKES', 'METROLOGY_TILT_WAVES', 'METROLOGY_CLIP', 'METROLOGY_BAND',
           'METROLOGY_LOWPASS', 'metrology_measurement', 'build_metrology',
           'COATING_WVL0', 'COATING_H', 'COATING_L', 'COATING_SUBSTRATE', 'COATING_PAIRS',
           'COATING_SEED', 'COATING_SPREAD', 'COATING_REFLECT', 'COATING_TRANSMIT', 'COATING_AOI',
           'COATING_MIN_THICKNESS', 'NEEDLE_BAND', 'NEEDLE_AOI', 'NEEDLE_MATERIALS', 'NEEDLE_START',
           'NEEDLE_SETTINGS', 'build_coating_design', 'RETRIEVAL_START', 'RETRIEVAL_BOUND',
           'RETRIEVAL_ITERS', 'build_phase_retrieval_lbfgsb', 'WFC_NMS', 'WFC_SEED', 'WFC_RMS',
           'WFC_ACT_RMS', 'WFC_NACT', 'WFC_SEP', 'WFC_ROT', 'SH_SAMPLES', 'SH_SPOT', 'wfc_state',
           'sh_geometry', 'build_wavefront_control', 'LENS_NMS', 'LENS_SPHERES',
           'LENS_THICKNESSES', 'build_lens_analysis', 'DESIGN_DECENTRE_ROW',
           'DESIGN_CURVATURE_ROWS', 'DESIGN_THICKNESS_ROWS', 'DESIGN_FOCUS_ROW', 'DESIGN_SOLVE',
           'DESIGN_SIGMAS', 'DESIGN_MC_TRIALS', 'DESIGN_FAST_MC_TRIALS', 'DESIGN_NPUPIL',
           'DESIGN_NPIX', 'DESIGN_Q', 'cfg6_design_system', 'cfg6_glass_catalog',
           'build_lens_design', 'PARALLEL_WVLS', 'PARALLEL_MR', 'PARALLEL_TRACE_RINGS',
           'MeshPattern', 'build_parallel_patterns']

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


def _cfg2_intensity(pupil, plan, fused=True):
    """cfg2's forward: coefficients -> OPD -> MDFT focus -> intensity."""
    def intensity(c):
        if fused:
            opd = zernike_sum_pallas(c, pupil.nms, pupil.r, pupil.t, grads='coefs')
        else:
            opd = sum_of_2d_modes(zernike_nm_seq(pupil.nms, pupil.r, pupil.t), c)
        E = Wavefront.from_amp_and_phase(pupil.amp, opd, WVL, pupil.dx).focus_dft(plan)
        return E.intensity.data

    return intensity


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
    intensity = _cfg2_intensity(pupil, plan, fused)

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


# the freeform-fit path: every Q2d term with 0 <= n <= 8 and -8 <= m <= 8
# (Q2d_nm_c_to_a_b takes them all), the first 36 Noll Zernikes that are
# fitted, and the other sag families that freeform raytracing evaluates,
# each with its terms; every coefficient from one generator, 1e-4 (mm) rms
FREEFORM_Q2D_NMS = tuple((n, m) for n in range(9) for m in range(-8, 9))
FREEFORM_FIT_NMS = tuple(noll_to_nm(j) for j in range(1, 37))
FREEFORM_FAMILIES = {
    'cheby1_2d_sum_der_xy': tuple((m, n) for m in range(9) for n in range(9)),
    'xy_sum_der_xy': tuple((m, n) for m in range(11) for n in range(11) if m + n <= 10),
    'jacobi_radial_sum_der_xy': tuple(range(11)),
    'zernike_sum_der_xy': tuple((n, m) for n in range(9) for m in range(-n, n + 1, 2)),
}
FREEFORM_SEED, FREEFORM_SCALE = 11, 1e-4


def freeform_coefficients():
    """{'q2d': [...], family: [...]}: the path's coefficients, host floats in drawing order."""
    rng = np.random.default_rng(FREEFORM_SEED)
    out = {'q2d': rng.normal(scale=FREEFORM_SCALE, size=len(FREEFORM_Q2D_NMS)).tolist()}
    for name, terms in FREEFORM_FAMILIES.items():
        out[name] = rng.normal(scale=FREEFORM_SCALE, size=len(terms)).tolist()
    return out


class _FreeformFit:
    """The freeform-surface metrology path; calling it gives a dict of its results.

    Planned once: the N^2 grid over the unit disk (``x``, ``y``; ``u`` = r
    and the angle ``t``; ``mask`` where r <= 1), the Q2d surface's
    (cm0, ams, bms) from ``Q2d_nm_c_to_a_b``, and the fit's basis: the
    first 36 Noll Zernikes, normalized to unit RMS over the mask
    (``modes``), with the RMS of each (``scale``).
    """

    def __init__(self, N, dtype=None, device=None, fused=True):
        dtype = config.precision if dtype is None else dtype
        self.fused = fused
        self.x, self.y = make_xy_grid(N, diameter=2.0, dtype=dtype, device=device)
        self.u, self.t = cart_to_polar(self.x, self.y)
        self.mask = self.u <= 1
        self.coefs = freeform_coefficients()
        self.cm0, self.ams, self.bms = Q2d_nm_c_to_a_b(FREEFORM_Q2D_NMS, self.coefs['q2d'])
        raw = zernike_nm_seq(FREEFORM_FIT_NMS, self.u, self.t)
        self.scale = _mode_norms(raw, self.mask)
        self.modes = normalize_modes(raw, self.mask)

    def sag(self):
        """(z, dz/du, dz/dt) of the Q2d surface."""
        return compute_z_zprime_Q2d(self.cm0, self.ams, self.bms, self.u, self.t)

    def fit(self, z):
        """(coefficients on the normalized basis, reconstruction, masked residual RMS)."""
        coefs = lstsq(self.modes, torch.where(self.mask, z, torch.full_like(z, float('nan'))))
        if self.fused:
            # the same sum on the Zernike-normed basis, by the fused synthesis
            recon = zernike_sum(coefs / self.scale, FREEFORM_FIT_NMS, self.x, self.y)
        else:
            recon = sum_of_2d_modes(self.modes, coefs)
        resid = torch.where(self.mask, z - recon, torch.zeros_like(z))
        return coefs, recon, torch.sqrt(torch.sum(resid * resid) / torch.sum(self.mask))

    def families(self):
        """{family: (z, dz/dx, dz/dy)} of the other sag families on the grid."""
        x, y, c, terms = self.x, self.y, self.coefs, FREEFORM_FAMILIES
        return {
            'cheby1_2d_sum_der_xy': cheby1_2d_sum_der_xy(
                c['cheby1_2d_sum_der_xy'], terms['cheby1_2d_sum_der_xy'], x, y),
            'xy_sum_der_xy': xy_sum_der_xy(c['xy_sum_der_xy'], terms['xy_sum_der_xy'], x, y),
            'jacobi_radial_sum_der_xy': jacobi_radial_sum_der_xy(
                c['jacobi_radial_sum_der_xy'], terms['jacobi_radial_sum_der_xy'], 0, 0, x, y, 1.0),
            'zernike_sum_der_xy': zernike_sum_der_xy(
                c['zernike_sum_der_xy'], terms['zernike_sum_der_xy'], x, y),
        }

    def __call__(self):
        """{'z', 'dr', 'dt', 'coefs', 'recon', 'residual_rms', family: (z, dz/dx, dz/dy)}."""
        z, dr, dt = self.sag()
        coefs, recon, rms = self.fit(z)
        return {'z': z, 'dr': dr, 'dt': dt, 'coefs': coefs, 'recon': recon,
                'residual_rms': rms, **self.families()}


def build_freeform_fit(N=1024, dtype=None, device=None, fused=True):
    """The freeform-surface metrology path on an N^2 grid over the unit disk.

    A Forbes Q2d surface (every term to n = 8, |m| = 8, 1e-4 mm rms
    coefficients from ``np.random.default_rng(11)``) gives its sag and
    radial and azimuthal slopes; the first 36 Noll Zernikes, normalized
    over the disk, are fitted to the sag by least squares (NaN outside the
    disk), and the fit is reconstructed through ``zernike_sum`` (the fused
    synthesis: its CUDA kernel on the card) or, with ``fused=False``, from
    the normalized mode stack; then the masked residual RMS.  The same call
    evaluates the Chebyshev, XY, radial Jacobi and Zernike sag families with
    their Cartesian slopes.  Returns a callable ``fit()`` giving a dict of
    the results.
    """
    return _FreeformFit(N, dtype=dtype, device=device, fused=fused)


# the image-simulation path: the target's spokes, and the smear (width, height)
# and jitter scale in pixels
IMAGE_SPOKES, IMAGE_SMEAR, IMAGE_JITTER = 36, (2.0, 0.0), 1.0


class _ImageChain:
    """The image-simulation path; calling it gives (conv image, transfer-function image).

    Planned once: the ``target``, a Siemens star, the flagship ``psf``
    (the central N^2 of ``entry``'s 2N^2 PSF, normalized to unit sum) and
    its ``otf`` in FFT order.  The transfer functions run in pixel units
    (dx = 1).
    """

    def __init__(self, N, dtype=None, device=None, target=None):
        dtype = config.precision if dtype is None else dtype
        if target is None:
            x, y = make_xy_grid(N, diameter=2.0, dtype=dtype, device=device)
            target = siemensstar(*cart_to_polar(x, y), IMAGE_SPOKES)
        forward, args = entry(N, dtype=dtype, device=target.device)
        with torch.no_grad():
            psf = crop_center(forward(*args)[0], (N, N))
        self.target, self.psf = target, psf / psf.sum()
        self.otf = torch.fft.fft2(torch.fft.ifftshift(self.psf, dim=(-2, -1)))
        self.tfs = [self.otf,
                    lambda fx, fy: smear_ft(fx, fy, *IMAGE_SMEAR),
                    lambda fr: jitter_ft(fr, IMAGE_JITTER)]

    def __call__(self):
        """(target * PSF, target through the OTF, smear and jitter transfer functions)."""
        return conv(self.target, self.psf), apply_transfer_functions(self.target, 1.0, self.tfs)


def build_image_chain(N=1024, dtype=None, device=None, target=None):
    """The image-simulation path at N^2: a 36-spoke Siemens star through the flagship PSF.

    ``conv`` convolves the target with the PSF; ``apply_transfer_functions``
    multiplies its spectrum by the PSF's OTF (an array), a 2-pixel smear
    (``smear_ft``) and a 1-pixel Gaussian jitter (``jitter_ft``), both
    callables.  The PSF is ``entry(N)``'s, cropped to N^2 and normalized;
    ``target`` defaults to the star on an N^2 grid over the unit disk (pass
    another N^2 scene, such as the star built in another dtype).  Returns
    a callable ``chain()`` giving the two images.
    """
    return _ImageChain(N, dtype=dtype, device=device, target=target)


# cfg6: the doublet + singlet of bench.py's cfg6, in mm: sphere curvatures,
# the gap after each, the (nd, Vd, name) of each model glass behind its
# sphere (air behind the last), the y fields in degrees, the entrance pupil
# diameter, the stop surface, and the hexapolar rings of the launch
CFG6_CURVATURES = (1 / 62.0, -1 / 45.0, -1 / 128.0)
CFG6_THICKNESSES = (6.0, 3.0, 95.0)
CFG6_GLASSES = ((1.5168, 64.17, 'BK7ish'), (1.6727, 32.2, 'SF5ish'))
CFG6_FIELDS = (0.0, 1.0, 2.0)
CFG6_EPD, CFG6_STOP, CFG6_RINGS = 20.0, 1, 64


def cfg6_system(ray_aiming='paraxial'):
    """bench.py's cfg6 OpticalSystem, built through the port's LensData (host)."""
    from .x import materials as mat, raytracing as rt
    lens = rt.LensData()
    media = [mat.model_glass(nd, vd, name=name) for nd, vd, name in CFG6_GLASSES] + [mat.air]
    for c, t, medium in zip(CFG6_CURVATURES, CFG6_THICKNESSES, media):
        lens.add(rt.Sphere(c), thickness=t, material=medium)
    return rt.OpticalSystem(lens, aperture=rt.ApertureSpec.epd(CFG6_EPD),
                            fields=list(CFG6_FIELDS), wavelengths=[WVL],
                            stop_index=CFG6_STOP, ray_aiming=ray_aiming)


class _Cfg6Trace:
    """cfg6's merged trace; calling it traces the uploaded bundle.

    Planned once on the host: the system, its compiled surfaces, and the
    paraxially aimed launch of every field (``batch._host_launches``, in
    float64), merged into one (F*N, 3) bundle and uploaded in ``dtype``.
    """

    def __init__(self, sampling=None, dtype=None, device=None):
        from .x.raytracing import Sampling
        from .x.raytracing.batch import _chief_indices, _host_launches
        self.dtype = config.precision if dtype is None else dtype
        dev = resolve_device(device)
        self.sampling = Sampling.hex(CFG6_RINGS) if sampling is None else sampling
        self.system = cfg6_system()
        self.surfaces = self.system.to_surfaces()
        P, S = _host_launches(self.system, list(self.system.fields), WVL, self.sampling, None)
        self.n_fields, self.n_rays = P.shape[:2]
        self.chiefs = _chief_indices(P)
        self.P = torch.as_tensor(P.reshape(-1, 3), dtype=self.dtype, device=dev)
        self.S = torch.as_tensor(S.reshape(-1, 3), dtype=self.dtype, device=dev)

    def trace(self, surfaces):
        """raytrace of the bundle through ``surfaces`` in this plan's dtype."""
        from .x.raytracing import raytrace
        with precision_as(self.dtype):
            return raytrace(surfaces, self.P, self.S, WVL)

    def __call__(self):
        """The RayTraceResult: P, S (n_surf+1, F*N, 3), OPL (n_surf+1, F*N), status."""
        return self.trace(self.surfaces)


def build_cfg6_trace(sampling=None, dtype=None, device=None):
    """bench.py's cfg6: the doublet + singlet, 3 fields, one merged trace.

    ``model_glass(1.5168, 64.17)`` and ``model_glass(1.6727, 32.2)`` behind
    spheres of curvature 1/62, -1/45 and -1/128 with gaps 6, 3 and 95 mm;
    EPD 20, y fields 0, 1 and 2 degrees, stop at surface 1, 0.55 um.
    ``sampling`` defaults to ``Sampling.hex(64)``: 3 x 12,481 = 37,443
    rays.  The launch is planned on the host and uploaded once to
    ``device`` (default ``config.device``) in ``dtype`` (default
    ``config.precision``); each call traces it in that dtype and returns
    the ``RayTraceResult``.
    """
    return _Cfg6Trace(sampling, dtype=dtype, device=device)


class _Cfg6Grad(_Cfg6Trace):
    """cfg6's spot loss and its gradient with respect to the three curvatures."""

    def __init__(self, sampling=None, dtype=None, device=None):
        super().__init__(sampling, dtype=dtype, device=device)
        self.curvatures = torch.tensor(CFG6_CURVATURES, dtype=self.dtype, device=self.P.device)
        self.chief_onehot = torch.zeros(self.n_fields, self.n_rays, dtype=self.dtype,
                                        device=self.P.device)
        self.chief_onehot[torch.arange(self.n_fields), torch.as_tensor(self.chiefs)] = 1.0

    def surfaces_with(self, curvatures):
        """The compiled surfaces with each sphere rebuilt as Sphere(c_k), c_k a tensor."""
        from .x.raytracing import Sphere, Surface
        out, k = [], 0
        for surf in self.surfaces:
            if surf.shape.kind == 'sphere':
                surf = Surface(Sphere(curvatures[k]), surf.typ, P=surf.P, R=surf.R,
                               material=surf.material, aperture=surf.aperture)
                k += 1
            out.append(surf)
        return out

    def loss(self, curvatures):
        """(mean over fields of the RMS spot radius about the chief, per-field radii)."""
        res = self.trace(self.surfaces_with(curvatures))
        F, N = self.n_fields, self.n_rays
        xy = res.P[-1][:, :2].reshape(F, N, 2)
        alive = (res.status.imag == 0).reshape(F, N)
        # the chief by a one-hot sum, selected before the product (dead rays hold NaN)
        chief = torch.einsum('fn,fnc->fc', self.chief_onehot,
                             torch.where(self.chief_onehot[..., None] > 0, xy, 0.0))
        r2 = torch.where(alive, ((xy - chief[:, None]) ** 2).sum(-1), 0.0)
        rms = torch.sqrt(r2.sum(-1) / alive.sum(-1))
        return rms.mean(), rms

    def __call__(self, curvatures=None):
        """(loss, d loss / d curvatures (3,), per-field RMS radii) at ``curvatures``."""
        c = self.curvatures if curvatures is None else curvatures
        c = c.detach().to(self.dtype).requires_grad_(True)
        loss, rms = self.loss(c)
        grad, = torch.autograd.grad(loss, c)
        return loss.detach(), grad, rms.detach()


def build_cfg6_grad(sampling=None, dtype=None, device=None):
    """cfg6's gradient step: d(spot loss)/d(the three sphere curvatures).

    The loss is the mean over the three fields of the image-plane RMS
    spot radius about each field's chief ray (the pupil-center ray),
    over the rays that reach the image.  The surfaces are rebuilt from
    the compiled ones' poses and materials with ``Sphere(c_k)`` shapes
    whose curvatures are tensors, and autograd gives the gradient.  The
    launch is ``build_cfg6_trace``'s.  Returns a callable
    ``step(curvatures=None)`` giving (loss, gradient, per-field radii).
    """
    return _Cfg6Grad(sampling, dtype=dtype, device=device)


# the interferometer-analysis path: a 100 mm flat on an N^2 camera, HeNe, double
# pass; the surface's mid-spatial part (abc_psd a, b, c, and its RMS in nm), its
# Fringe Zernikes Z4-Z9 in nm, and its x tilt in waves of the double-pass wavefront
METROLOGY_DIAMETER, METROLOGY_SEED = 100.0, 8
METROLOGY_PSD, METROLOGY_PSD_RMS = (1e3, 0.1, 2.5), 5.0
METROLOGY_ZERNIKES = (((2, 0), 50.0), ((2, 2), 20.0), ((2, -2), -15.0),
                      ((3, 1), 10.0), ((3, -1), -8.0), ((4, 0), 5.0))
METROLOGY_TILT_WAVES = 2.0
# the analysis: spike clip (sigma), the band of the band-limited RMS (periods,
# mm) and the lowpass cutoff (cy/mm)
METROLOGY_CLIP, METROLOGY_BAND, METROLOGY_LOWPASS = 3, (1.0, 10.0), 0.1


def _fringe_z4_z9(rho, theta):
    """The unnormalized Fringe Zernikes Z4-Z9 of METROLOGY_ZERNIKES, in its order (numpy)."""
    radial3 = 3 * rho ** 3 - 2 * rho
    return (2 * rho ** 2 - 1, rho ** 2 * np.cos(2 * theta), rho ** 2 * np.sin(2 * theta),
            radial3 * np.cos(theta), radial3 * np.sin(theta), 6 * rho ** 4 - 6 * rho ** 2 + 1)


def metrology_measurement(N=1024, seed=METROLOGY_SEED):
    """The phase-shifting measurement of the metrology path, built on the host in float64.

    Returns (frames, surface, dx): the 13 full-field frames
    1 + 0.8 cos(phi + delta_k) of ``ZYGO_THIRTEEN_FRAME``, shape (13, N, N),
    with phi = 4 pi h / lambda (double pass, HeNe), the surface h in nm
    (N, N), and the pixel pitch in mm.  h is a mid-spatial part drawn from
    ``np.random.default_rng(seed)`` under the abc PSD and scaled to
    ``METROLOGY_PSD_RMS`` nm RMS over the frame, the Fringe Zernikes of
    ``METROLOGY_ZERNIKES`` over the 100 mm aperture, and x tilt.
    """
    from .fttools import _host_fftrange
    from .wavelengths import HeNe
    from .x.psi import ZYGO_THIRTEEN_FRAME
    dx = METROLOGY_DIAMETER / N
    axis = _host_fftrange(N) * dx
    x, y = np.meshgrid(axis, axis)
    # mid-spatial part: random phase (the angle of the FFT of uniform draws)
    # under the square root of the PSD
    nu = np.fft.fftshift(np.fft.fftfreq(N, dx))
    a, b, c = METROLOGY_PSD
    psd = a / (1 + (np.hypot(*np.meshgrid(nu, nu)) / b) ** c)
    phase = np.angle(np.fft.fft2(np.random.default_rng(seed).uniform(size=(N, N))))
    mid = np.fft.ifft2(np.fft.ifftshift(np.exp(1j * phase) * np.sqrt(psd))).real
    mid = mid - mid.mean()
    mid = mid * (METROLOGY_PSD_RMS / np.sqrt(np.mean(mid * mid)))
    rho, theta = np.hypot(x, y) / (METROLOGY_DIAMETER / 2), np.arctan2(y, x)
    zern = sum(c * z for (_, c), z in zip(METROLOGY_ZERNIKES, _fringe_z4_z9(rho, theta)))
    wvl_nm = HeNe * 1e3
    tilt = METROLOGY_TILT_WAVES * wvl_nm / 2 * x / METROLOGY_DIAMETER
    h = mid + zern + tilt
    phi = 4 * np.pi * h / wvl_nm
    frames = 1 + 0.8 * np.cos(phi[None] + np.asarray(ZYGO_THIRTEEN_FRAME.shifts)[:, None, None])
    return frames, h, dx


class _Metrology:
    """The interferometer-analysis path; calling it gives a dict of its results.

    Planned once: the frames, cast from the float64 host measurement to the
    path's dtype on its device, and the circular aperture (r <= 50 mm).
    The stages are methods, so that a check can feed one stage another
    precision's result: ``wrapped`` (de Groot), ``surface`` (unwrap to nm,
    mask, piston/tilt/power removed), then ``spike_clip`` on the
    Interferogram, and ``analyze``.
    """

    def __init__(self, N, dtype=None, device=None, measurement=None):
        from .wavelengths import HeNe
        dtype = config.precision if dtype is None else dtype
        dev = resolve_device(device)
        frames, self.truth, self.dx = (metrology_measurement(N) if measurement is None
                                       else measurement)
        self.wavelength = HeNe
        self.frames = torch.as_tensor(frames, dtype=dtype, device=dev)
        x, y = make_xy_grid(N, dx=self.dx, dtype=dtype, device=dev)
        self.aperture = torch.hypot(x, y) <= METROLOGY_DIAMETER / 2

    def wrapped(self):
        """The wrapped phase of the 13 frames (rad)."""
        from .x.psi import ZYGO_THIRTEEN_FRAME, degroot_formalism_psi
        return degroot_formalism_psi(self.frames, ZYGO_THIRTEEN_FRAME)

    def surface(self, wrapped):
        """The unwrapped surface in nm as an Interferogram: masked, piston, tilt and power removed.

        ``remove_power`` subtracts only the quadratic term of its fit, so the
        piston is removed once more after it: a map left with the power
        fit's constant offset fails ``spike_clip``'s |z| > n sigma test over
        most of the aperture.
        """
        from .interferogram import Interferogram
        from .x.psi import unwrap_phase
        nm = unwrap_phase(wrapped) * (self.wavelength * 1e3 / (4 * np.pi))
        ifg = Interferogram(nm, dx=self.dx, wavelength=self.wavelength)
        ifg.mask(self.aperture).remove_piston().remove_tiptilt().remove_power()
        return ifg.remove_piston()

    def analyze(self, ifg):
        """The statistics, PSD, band-limited RMS, azimuthal average, filtered map and slopes.

        ``ifg`` is the clipped map; it is filled, filtered and left so.
        """
        from .interferogram import bandlimited_rms
        out = {'pv': ifg.pv, 'rms': ifg.rms, 'Sa': ifg.Sa, 'std': ifg.std,
               'strehl': ifg.strehl, 'pvr': ifg.pvr()}
        p = ifg.fill(0).psd()
        out['psd'] = p.data
        out['bandlimited_rms'] = bandlimited_rms(p.r, p.data, wllow=METROLOGY_BAND[0],
                                                 wlhigh=METROLOGY_BAND[1])
        out['azavg_rho'], out['azavg'] = p.slices().azavg
        out['filtered'] = ifg.filter(METROLOGY_LOWPASS, 'lowpass').data
        out['slope_x'], out['slope_y'], out['slope'] = (s.data for s in ifg.slope())
        return out

    def __call__(self):
        """{'wrapped', 'map' (clipped, nm), the statistics, 'psd', ..., 'slope'}."""
        wrapped = self.wrapped()
        ifg = self.surface(wrapped).spike_clip(METROLOGY_CLIP)
        return {'wrapped': wrapped, 'map': ifg.data, **self.analyze(ifg)}

    @staticmethod
    def fit_psd(out):
        """abc_psd fitted to the azimuthal average over its bins with f > 0 and a positive value.

        A host-bound loop of 500 steps (``interferogram.fit_psd``); returns numpy.
        """
        from .interferogram import abc_psd, fit_psd
        rho, az = out['azavg_rho'], out['azavg']
        keep = (rho > 0) & torch.isfinite(az) & (az > 0)
        return fit_psd(rho[keep], az[keep], abc_psd)


def build_metrology(N=1024, dtype=None, device=None, measurement=None):
    """The interferometer-analysis path on an N^2 camera.

    A 100 mm flat measured by 13-frame phase-shifting interferometry
    (``metrology_measurement``, or the (frames, surface, dx) given):
    de Groot's wrapped phase -> DCT least-squares unwrap -> nm ->
    ``Interferogram`` -> the 50 mm-radius aperture -> piston, tilt, power and
    piston again removed -> ``spike_clip(3)``; PV, RMS, Sa, std, Strehl and PVr; the map
    filled with 0 -> PSD -> band-limited RMS over 1-10 mm periods and the
    PSD's azimuthal average; the map lowpassed at 0.1 cy/mm -> its slopes.
    Returns a callable ``metrology()`` giving a dict of tensors; its
    ``fit_psd(out)`` fits ``abc_psd`` to the azimuthal average.
    """
    return _Metrology(N, dtype=dtype, device=device, measurement=measurement)


# the coating designer's edge filter: an (HL)^20 H quarter-wave stack at
# 0.49 um, H Ta2O5-like and L SiO2 (constant indices), on a 1.52 substrate in
# air; its thicknesses scaled by 1 + 0.05 N(0, 1) from a seeded generator;
# the merit asks R = 1 over 0.44-0.54 um and T = 1 over 0.60-0.90 um (um, um,
# samples) at 0 and 15 degrees, unpolarized
COATING_WVL0, COATING_H, COATING_L, COATING_SUBSTRATE = 0.49, 2.10, 1.46, 1.52
COATING_PAIRS, COATING_SEED, COATING_SPREAD = 20, 9, 0.05
COATING_REFLECT, COATING_TRANSMIT = (0.44, 0.54, 256), (0.60, 0.90, 768)
COATING_AOI = (0.0, 15.0)
COATING_MIN_THICKNESS = 0.005
# needle synthesis of a broadband AR for the same substrate: R = 0 over
# 0.42-0.70 um at 0, 15 and 30 degrees from two quarter-waves at 0.55 um
# (ambient side first), inserting either material
NEEDLE_BAND, NEEDLE_AOI, NEEDLE_MATERIALS = (0.42, 0.70, 256), (0.0, 15.0, 30.0), (1.38, 2.10)
NEEDLE_START = ((1.38, 2.10), (0.55 / (4 * 1.38), 0.55 / (4 * 2.10)))
NEEDLE_SETTINGS = dict(z_samples=240, max_layers=24, max_iters=12, refine_kwargs={'maxiter': 40})


def _spectral_grid(band, aoi_deg):
    """(wvl (S, 1), theta (1, A)): a band's samples meshed against the angles (radians)."""
    wvl = np.linspace(*band)[:, None]
    return wvl, np.deg2rad(np.asarray(aoi_deg, dtype=np.float64))[None, :]


class _Configured:
    """A coating problem whose calls run inside ``configured()``: its attributes pass through."""

    def __init__(self, problem, configured):
        self._problem, self._configured = problem, configured

    def __getattr__(self, name):
        attr = getattr(self._problem, name)
        if not callable(attr):
            return attr

        def call(*args, **kwargs):
            with self._configured():
                return attr(*args, **kwargs)

        return call


class _CoatingDesign:
    """The coating designer's path; calling it runs both refinements and the synthesis.

    Planned once: the perturbed start ``stack0`` and the edge filter's
    ``merit``, the needle synthesis's ``needle_start`` and ``needle_merit``,
    all in the path's dtype on its device.  Every call runs with
    ``config.precision`` and ``config.device`` set to them, so that the
    stacks the optimizers build go there too.
    """

    def __init__(self, pairs=COATING_PAIRS, samples=None, needle_samples=None,
                 needle=None, dtype=None, device=None):
        from .x.coatings import Reflectance, Stack, Transmittance
        self.dtype = config.precision if dtype is None else dtype
        self.device = resolve_device(device)
        reflect, transmit = COATING_REFLECT, COATING_TRANSMIT
        if samples is not None:
            reflect, transmit = reflect[:2] + (samples[0],), transmit[:2] + (samples[1],)
        band = NEEDLE_BAND if needle_samples is None else NEEDLE_BAND[:2] + (needle_samples,)
        self.needle = dict(NEEDLE_SETTINGS, **(needle or {}))
        indices = [COATING_H, COATING_L] * pairs + [COATING_H]
        quarter = COATING_WVL0 / (4 * np.asarray(indices))
        rng = np.random.default_rng(COATING_SEED)
        self.start = quarter * (1 + COATING_SPREAD * rng.standard_normal(len(indices)))
        with self.configured():
            self.stack0 = Stack(indices, self.start, COATING_SUBSTRATE)
            self.merit = [Reflectance(*_spectral_grid(reflect, COATING_AOI), pol='avg', target=1.0),
                          Transmittance(*_spectral_grid(transmit, COATING_AOI), pol='avg',
                                        target=1.0)]
            self.needle_start = Stack(NEEDLE_START[0], NEEDLE_START[1], COATING_SUBSTRATE)
            self.needle_merit = [Reflectance(*_spectral_grid(band, NEEDLE_AOI), pol='avg',
                                             target=0.0)]

    @contextmanager
    def configured(self):
        """A block with ``config.precision`` and ``config.device`` set to the path's."""
        with precision_as(self.dtype), device_as(self.device):
            yield

    def problem(self, **kwargs):
        """The edge filter's ``CoatingProblem`` (every thickness, or ``variables='index'``),
        whose evaluations run with the path's precision and device."""
        from .x.coatings import CoatingProblem
        with self.configured():
            return _Configured(CoatingProblem(self.stack0, self.merit, **kwargs),
                               self.configured)

    def refine(self, method='lbfgsb', maxiter=100, **kwargs):
        """``x.coatings.refine`` of the edge filter, thicknesses kept above 5 nm."""
        from .x.coatings import refine
        with self.configured():
            return refine(self.stack0, self.merit, method=method, maxiter=maxiter,
                          min_thickness=COATING_MIN_THICKNESS, **kwargs)

    def synthesize(self):
        """``x.coatings.synthesize`` of the broadband AR from its two-layer start."""
        from .x.coatings import synthesize
        with self.configured():
            return synthesize(self.needle_start, self.needle_merit, NEEDLE_MATERIALS,
                              **self.needle)

    def __call__(self):
        """{'lbfgsb': 100 iterations, 'lm': 10 iterations, 'needle': the synthesis}."""
        return {'lbfgsb': self.refine('lbfgsb', 100), 'lm': self.refine('lm', 10),
                'needle': self.synthesize()}


def build_coating_design(pairs=COATING_PAIRS, samples=None, needle_samples=None, needle=None,
                         dtype=None, device=None):
    """The coating designer's path: an edge filter refined two ways, and a needle-grown AR.

    The edge filter is a (2 ``pairs`` + 1)-layer (HL)^pairs H quarter-wave
    stack at 0.49 um with 5% seeded thickness errors; its merit asks R = 1
    over 0.44-0.54 um and T = 1 over 0.60-0.90 um (``samples`` = (R, T)
    wavelength counts, default (256, 768)) at 0 and 15 degrees, s and p
    averaged.  Calling the result runs ``refine`` by bounded L-BFGS-B (100
    iterations) and by damped least squares (10), and ``synthesize`` of a
    broadband AR (0.42-0.70 um, ``needle_samples`` wavelengths, default 256;
    0/15/30 degrees; ``needle`` overrides ``NEEDLE_SETTINGS``).
    """
    return _CoatingDesign(pairs, samples, needle_samples, needle, dtype=dtype, device=device)


# phase retrieval by optym: cfg2's problem from 0.8 x the true coefficients,
# inside a +-60 nm box, for 40 L-BFGS-B iterations
RETRIEVAL_START, RETRIEVAL_BOUND, RETRIEVAL_ITERS = 0.8, 60.0, 40


class _PhaseRetrieval:
    """cfg2's intensity L2 loss as the objective of ``PrysmLBFGSB``; call it to run.

    ``fg(c)`` is the loss and its coefficient gradient (through the fused
    Zernike kernels on the card); ``optimizer()`` a fresh ``PrysmLBFGSB``
    at the start; calling runs it under ``MaxIterations(iters)``.
    """

    def __init__(self, pupil, plan, iters, fused=True):
        self.pupil, self.plan, self.iters = pupil, plan, int(iters)
        self.intensity = _cfg2_intensity(pupil, plan, fused)
        self.truth = pupil.coefs
        with torch.no_grad():
            self.I_meas = self.intensity(self.truth)

    def fg(self, c):
        """(loss, coefficient gradient) at c."""
        c = c.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = torch.sum((self.intensity(c) - self.I_meas) ** 2)
        grad, = torch.autograd.grad(loss, c)
        return loss.detach(), grad

    def optimizer(self):
        """A ``PrysmLBFGSB`` at 0.8 x the truth with the +-60 box."""
        from .x.optym import PrysmLBFGSB
        bound = torch.full_like(self.truth, RETRIEVAL_BOUND)
        return PrysmLBFGSB(self.fg, self.truth * RETRIEVAL_START,
                           lower_bounds=-bound, upper_bounds=bound)

    def __call__(self, optimizer=None):
        """``run_until(optimizer, MaxIterations(iters))``; its OptimizationResult."""
        from .x.optym import MaxIterations, run_until
        opt = self.optimizer() if optimizer is None else optimizer
        return run_until(opt, MaxIterations(self.iters))


def build_phase_retrieval_lbfgsb(pupil=None, plan=None, *, N=1024, fN=256, iters=RETRIEVAL_ITERS,
                                 matmul_precision='high', fused=True, dtype=None, device=None):
    """Phase retrieval driven by optym's L-BFGS-B at cfg2's size.

    cfg2's pupil (``make_pupil(N)``), its TF32 MDFT plan to fN^2 and its
    intensity L2 loss against the image of the true coefficients
    (``COEFS6``); ``PrysmLBFGSB`` starts at 0.8 x the truth inside a +-60
    box and runs ``iters`` iterations.  Every objective evaluation launches
    the Zernike forward and coefficient-backward kernels on the card.
    """
    if pupil is None:
        pupil = make_pupil(N, dtype=dtype, device=device)
    if plan is None:
        plan = make_cfg2_plan(pupil, fN, matmul_precision=matmul_precision)
    return _PhaseRetrieval(pupil, plan, iters, fused=fused)


# the wavefront-control path: an adaptive-optics user's step at prysm's DM
# defaults.  36 Zernike modes (every (n, m) to n = 7) at about 50 nm rms and
# a 50 x 50 DM at 5 nm rms, both drawn from WFC_SEED; the DM's actuators 20
# samples apart with a Gaussian influence function one pitch wide (FWHM),
# folded 10 degrees about y.  The Shack-Hartmann sensor: lenslets of 32
# samples (N // 32 across, shifted to tile the grid), each spot's first zero
# 4 samples from its centre (lambda f / pitch), so f = 4 * pitch * dx / lambda
# (1.0742 mm at 1024^2, 0.55 um: Fresnel number 2.0, the lenslet phase's
# steepest step pi / 4 a sample, 4 pi at a corner)
WFC_NMS = tuple((n, m) for n in range(8) for m in range(-n, n + 1, 2))
WFC_SEED, WFC_RMS, WFC_ACT_RMS = 12, 50.0, 5.0
WFC_NACT, WFC_SEP, WFC_ROT = 50, 20, (0, 10, 0)
SH_SAMPLES, SH_SPOT = 32, 4


def wfc_state(nact=WFC_NACT):
    """(coefficients (36,), actuators (nact, nact)): the path's seeded numpy state, nm."""
    rng = np.random.default_rng(WFC_SEED)
    coefs = rng.standard_normal(len(WFC_NMS)) * (WFC_RMS / np.sqrt(len(WFC_NMS)))
    return coefs, rng.standard_normal((nact, nact)) * WFC_ACT_RMS


def sh_geometry(N):
    """(lenslets across, pitch mm, focal length mm) of the path's Shack-Hartmann sensor."""
    dx = DIAMETER / N
    pitch = SH_SAMPLES * dx
    return N // SH_SAMPLES, pitch, SH_SPOT * pitch * dx / (WVL / 1e3)


class _WavefrontControl:
    """The wavefront-control step; call it with (actuators, coefficients).

    Built once: the pupil and its mode grids, cfg2's MDFT plan, the DM and
    its render function, the unaberrated PSF, the lenslet screen and the
    sensor's angular-spectrum transfer function.
    """

    def __init__(self, N, nact, fN, matmul_precision, fused=True, pupil=None, dm=None,
                 dtype=None, device=None):
        from .geometry import gaussian
        from .propagation import angular_spectrum_transfer_function
        from .x.dm import DM
        from .x.shack_hartmann import shack_hartmann
        coefs, actuators = wfc_state(nact)
        if pupil is None:
            pupil = make_pupil(N, WFC_NMS, tuple(coefs), dtype=dtype, device=device)
        self.pupil = pupil
        r = self.pupil.r
        self.modes = None if fused else zernike_nm_seq(pupil.nms, pupil.r, pupil.t)
        self.plan = make_cfg2_plan(self.pupil, fN, matmul_precision=matmul_precision)
        x, y = make_xy_grid(N, diameter=DIAMETER, dtype=r.dtype, device=r.device)
        if dm is None:
            dm = DM(gaussian(WFC_SEP * self.pupil.dx, x, y), Nout=N, Nact=nact, sep=WFC_SEP,
                    rot=WFC_ROT)
            dm.update(torch.as_tensor(actuators, dtype=r.dtype, device=r.device))
        self.dm = dm
        self.render = dm.render_fn(wfe=True)
        with torch.no_grad():
            self.I_ref = self.psf(torch.zeros_like(r))
        # the screen is a calibration: built once in float64 and rounded, so that
        # a sample on two lenslets' edges is shared alike in every precision
        n, pitch, self.sh_efl = sh_geometry(N)
        x64, y64 = make_xy_grid(N, diameter=DIAMETER, dtype=torch.float64, device=r.device)
        self.screen = shack_hartmann(pitch, n, self.sh_efl, WVL, x64, y64,
                                     shift=True).to(complex_for(r.dtype))
        self.sensor_tf = angular_spectrum_transfer_function(N, WVL, self.pupil.dx, self.sh_efl,
                                                            dtype=r.dtype, device=r.device)

    def opd(self, actuators, coefs):
        """The Zernike sum (fused, grads='coefs'; or over the mode stack) plus the DM's
        reflected WFE, nm."""
        p = self.pupil
        if self.modes is None:
            zern = zernike_sum_pallas(coefs, p.nms, p.r, p.t, grads='coefs')
        else:
            zern = sum_of_2d_modes(self.modes, coefs)
        return zern + self.render(actuators)

    def field(self, opd):
        """The pupil field of an OPD."""
        return Wavefront.from_amp_and_phase(self.pupil.amp, opd, WVL, self.pupil.dx)

    def psf(self, opd):
        """The focal intensity through the MDFT plan."""
        return self.field(opd).focus_dft(self.plan).intensity.data

    def loss(self, actuators, coefs):
        """The intensity L2 loss against the unaberrated PSF."""
        return torch.sum((self.psf(self.opd(actuators, coefs)) - self.I_ref) ** 2)

    def __call__(self, actuators, coefs):
        """(loss, actuator gradient, coefficient gradient)."""
        a = actuators.detach().requires_grad_(True)
        c = coefs.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = self.loss(a, c)
        ga, gc = torch.autograd.grad(loss, (a, c))
        return loss.detach(), ga, gc

    @torch.no_grad()
    def sensor(self, actuators, coefs):
        """The Shack-Hartmann frame: the pupil field times the lenslet screen, by angular
        spectrum over the lenslets' focal length to an N^2 detector intensity."""
        E = self.field(self.opd(actuators, coefs)).data * self.screen
        E = torch.fft.ifft2(torch.fft.fft2(E) * self.sensor_tf)
        return E.real * E.real + E.imag * E.imag


def build_wavefront_control(N=1024, nact=WFC_NACT, fN=256, matmul_precision='high',
                            fused=True, pupil=None, dm=None, dtype=None, device=None):
    """An adaptive-optics user's wavefront-control step at full pupil width.

    An anti-aliased circular pupil on an N^2 grid (``make_pupil``) with 36
    Zernike modes (``WFC_NMS``) through ``zernike_sum_pallas(...,
    grads='coefs')``, plus the WFE of ``x.dm.DM`` (``nact`` x ``nact``
    actuators ``WFC_SEP`` samples apart, a Gaussian influence function one
    pitch wide, folded 10 degrees: ``warp`` and the obliquity are on the
    path), focused to fN^2 by cfg2's MDFT plan (TF32 with
    ``matmul_precision='high'``).  ``fused=False`` sums a mode stack
    instead of running the Zernike kernels (which compute in float32), for
    a float64 reference on the card.  Calling the result with (actuators,
    coefficients) returns the intensity L2 loss against the unaberrated
    PSF and its gradients with respect to both, by autograd; ``sensor``
    gives a Shack-Hartmann frame of the same field (N // 32 lenslets of 32
    samples across, ``sh_geometry``).  ``pupil`` and ``dm`` replace the
    pupil (``make_pupil(N, WFC_NMS, ...)``) and the DM (for ones carried
    over, ``interop.pupil_from_numpy`` and ``interop.dm_from_numpy``); the
    starting state is ``wfc_state(nact)`` (``.pupil.coefs``,
    ``.dm.actuators``).
    """
    return _WavefrontControl(N, nact, fN, matmul_precision, fused=fused, pupil=pupil,
                             dm=dm, dtype=dtype, device=device)


# the lens-analysis path: cfg6 with real aiming; its fitted wavefronts over the
# wavefront-control step's 36 modes (n <= 7); the compiled indices of its three
# spheres, and the surfaces each glass thickness moves (everything behind it)
LENS_NMS = WFC_NMS
LENS_SPHERES = (1, 2, 3)
LENS_THICKNESSES = (((2, 1), (3, 1), (4, 1)), ((3, 1), (4, 1)))


class _LensAnalysis:
    """cfg6's lens analysis; calling it fits, renders, focuses and differentiates.

    Planned once: the real-aimed system, its launches of every field
    (aimed in float64 on the device, so every dtype traces the same bundle),
    the fit's design matrices and exit pupil (``batch.plan_wavefront_fit``),
    the pupil grid and cfg2's MDFT plan.
    """

    def __init__(self, sampling, N, fN, fused, dtype, device, system=None):
        from .x.raytracing import Sampling
        from .x.raytracing.adjoint import (OplSpreadHead, RmsSpotHead, seed_curvature,
                                           seed_despace)
        from .x.raytracing.batch import plan_wavefront_fit
        self.dtype = config.precision if dtype is None else dtype
        self.device = resolve_device(device)
        self.sampling = Sampling.hex(CFG6_RINGS) if sampling is None else sampling
        if system is None:
            self.system = cfg6_system(ray_aiming='real')
        else:
            self.system = system.copy()
            self.system.ray_aiming = 'real'
        self.fields = list(self.system.fields)
        self.pupil = make_pupil(N, LENS_NMS, (0.0,) * len(LENS_NMS), dtype=self.dtype,
                                device=self.device)
        self.x, self.y = make_xy_grid(N, diameter=DIAMETER, dtype=self.dtype, device=self.device)
        self.modes = None if fused else zernike_nm_seq(LENS_NMS, self.pupil.r, self.pupil.t)
        self.plan = make_cfg2_plan(self.pupil, fN)
        with precision_as(torch.float64), device_as(self.device):
            self.fit_plan = plan_wavefront_fit(self.system, LENS_NMS, WVL, self.fields,
                                               self.sampling)
        self.P = self.fit_plan.P.reshape(-1, 3)
        self.S = self.fit_plan.S.reshape(-1, 3)
        self.seeds = ([seed_curvature(j, name=f'c{j}') for j in LENS_SPHERES]
                      + [seed_despace(moved, name=f't{k + 1}')
                         for k, moved in enumerate(LENS_THICKNESSES)])
        self.heads = [RmsSpotHead(), OplSpreadHead()]

    @contextmanager
    def configured(self):
        """A context with ``config.precision`` and ``config.device`` set to this plan's."""
        with precision_as(self.dtype), device_as(self.device):
            yield

    def fit(self):
        """(coefs (1, F, 36), residual RMS (1, F)) in mm: ``device_wavefront_fit``'s
        tensor half on the planned launches."""
        from .x.raytracing.batch import fit_planned
        with self.configured():
            c, r = fit_planned(self.system.to_surfaces(), self.fit_plan, self.device)
        return c[None], r[None]

    def opd(self, coefs):
        """(F, N, N) OPD in nm over the unit pupil from (F, 36) coefficients in mm."""
        c = (coefs * 1e6).to(self.dtype)
        if self.modes is None:
            return torch.stack([zernike_sum(ck, LENS_NMS, self.x, self.y) for ck in c])
        return torch.stack([sum_of_2d_modes(self.modes, ck) for ck in c])

    def psfs(self, opd):
        """(F, fN, fN) focal intensities through the MDFT plan."""
        return torch.stack([Wavefront.from_amp_and_phase(self.pupil.amp, o, WVL, self.pupil.dx)
                            .focus_dft(self.plan).intensity.data for o in opd])

    def sensitivities(self):
        """(grads (2, 5), values): d(RMS spot, OPL spread)/d(c1, c2, c3, t1, t2)."""
        from .x.raytracing.adjoint import adjoint_gradient_multi
        with self.configured():
            return adjoint_gradient_multi(self.system, self.P, self.S, WVL, self.seeds,
                                          self.heads)

    @torch.no_grad()
    def __call__(self):
        """(coefs, rms, psfs, grads, head values); see ``build_lens_analysis``."""
        coefs, rms = self.fit()
        psfs = self.psfs(self.opd(coefs[0]))
        with torch.enable_grad():
            grads, values = self.sensitivities()
        return coefs, rms, psfs, grads, values


def build_lens_analysis(sampling=None, N=1024, fN=256, fused=True, dtype=None, device=None,
                        system=None):
    """A lens designer's analysis of cfg6 with real ray aiming.

    ``cfg6_system(ray_aiming='real')``, or a copy of ``system`` set to
    real aiming (its surfaces must be cfg6's in number and order: the
    sensitivities' seeds name cfg6's three spheres and two glass
    gaps): 3 fields x ``sampling`` (default
    ``Sampling.hex(64)``, 37,443 rays) launched onto the real stop, planned
    once with the exit pupil (``batch.plan_wavefront_fit``, the host half of
    ``device_wavefront_fit``).  A call fits each field's wavefront by its
    tensor half (``batch.fit_planned``: one merged trace, the EIC closing
    through ``system.exit_pupil``, the masked normal equations over
    ``LENS_NMS``): coefficients (1, 3, 36) and residual RMS
    (1, 3) in mm of OPD per unit-RMS Zernike mode over each field's launch
    radius, as the JAX package's ``wavefront_zernike_fit`` gives them with
    ``output='length'``.  Each field's fit is rendered as OPD in nm (1e6 x
    mm) on an N^2 unit-disk pupil through ``polynomials.zernike_sum`` (the
    fused forward kernel, one launch a field; ``fused=False``: the f64 mode
    stack), focused by cfg2's MDFT plan to fN^2 (``make_cfg2_plan``, TF32
    products on the card) into three PSFs.  Last, the gradients of the RMS
    spot radius about the centroid and the OPL spread of the merged bundle
    with respect to the three curvatures and the two glass thicknesses,
    one reverse pass per head (``adjoint.adjoint_gradient_multi``).
    Returns a callable giving (coefs, rms, psfs, grads (2, 5), values).
    """
    return _LensAnalysis(sampling, N, fN, fused, dtype, device, system)


# the lens designer's path: cfg6 with a neutral coordinate break before its rear
# sphere (the decentre tolerance's station), its design variables by row, the image
# gap as the focus compensator, the DLS settings (sensitivity-scaled, adaptive
# damping: with the default 1e-6 identity damping the first Gauss-Newton step leaves
# the lens and the line search fails), the 1-sigma tolerances (curvature 1/mm,
# lengths mm), the Monte Carlo sizes and seeds, and the pupil-field sizes
DESIGN_DECENTRE_ROW = 3
DESIGN_CURVATURE_ROWS = (1, 2, 4)
DESIGN_THICKNESS_ROWS = (1, 2)
DESIGN_FOCUS_ROW = 4
DESIGN_SOLVE = {'maxiter': 10, 'damping_mode': 'sensitivity', 'damping': 1e-2,
                'adaptive_damping': True}
DESIGN_SIGMAS = {'curvature': 2e-5, 'thickness': 0.02, 'decenter': 0.02, 'focus': 0.05}
DESIGN_MC_TRIALS, DESIGN_MC_SEED = 100, 0
DESIGN_FAST_MC_TRIALS, DESIGN_FAST_MC_SEED = 2000, 1
DESIGN_NPUPIL, DESIGN_NPIX, DESIGN_Q = 128, 512, 2


def cfg6_glass_catalog():
    """cfg6's two model glasses as a catalog: the prescription readers' database."""
    from .x import materials as mat
    return mat.Catalog.from_materials([mat.model_glass(nd, vd, name=name)
                                       for nd, vd, name in CFG6_GLASSES])


def cfg6_design_system():
    """cfg6 with a neutral ('basic', zero) coordinate break at row
    ``DESIGN_DECENTRE_ROW``, before the rear sphere: the station of the
    designer's decentre tolerance.  It traces as cfg6 does."""
    from .x.raytracing.lensdata import CoordBreak
    system = cfg6_system()
    system.lens.rows.insert(DESIGN_DECENTRE_ROW, CoordBreak())
    return system


@dataclass
class LensTolerance:
    """The tolerancing step's results (``_LensDesign.tolerance``)."""

    table: object
    monte_carlo: object
    differential: object
    expected_rms: float
    compensator_motions: np.ndarray
    fast_monte_carlo: object


class _LensDesign:
    """The lens designer's session on cfg6, one method per step.

    ``prescription`` must run first: the system it reads from the Zemax
    text is the one every later step optimises, tolerances and analyses.
    """

    def __init__(self, sampling, npupil, npix, dtype, device):
        from .x.raytracing import Sampling
        self.dtype = config.precision if dtype is None else dtype
        self.device = resolve_device(device)
        self.sampling = Sampling.hex(CFG6_RINGS) if sampling is None else sampling
        self.npupil, self.npix = npupil, npix
        self.source = cfg6_design_system()
        self.database = cfg6_glass_catalog()
        self.system = self.efl = None

    @contextmanager
    def configured(self):
        """A context with ``config.precision`` and ``config.device`` set to this plan's."""
        with precision_as(self.dtype), device_as(self.device):
            yield

    def prescription(self):
        """Step 1: the design system written as Zemax and Code V text and read
        back: (zmx text, seq text, system read from the .zmx, system read from
        the .seq).  The .zmx system is the one the later steps work on; the EFL
        constraint's target is its starting EFL."""
        from .x.raytracing import (effective_focal_length, read_seq, read_zmx, write_seq,
                                   write_zmx)
        zmx, seq = write_zmx(self.source), write_seq(self.source)
        with self.configured():
            from_zmx = read_zmx(zmx, _is_text=True, database=self.database)
            from_seq = read_seq(seq, _is_text=True, database=self.database)
            self.efl = float(effective_focal_length(from_zmx.to_surfaces(), wvl=WVL))
        from_zmx.opt.vary('curvature', DESIGN_CURVATURE_ROWS)
        from_zmx.opt.vary('thickness', DESIGN_THICKNESS_ROWS)
        self.system = from_zmx
        return zmx, seq, from_zmx, from_seq

    def problem(self):
        """Step 2's Problem: the RMS spot radius at each field and the RMS
        wavefront error at the edge field, every bundle on ``sampling``, with
        the EFL held at its starting value; free are the three curvatures
        and the two glass thicknesses; the residual Jacobian by the differentiable
        engines (``gradient='auto'``)."""
        from .x.raytracing import EFL, Problem, RmsSpotRadius, WavefrontRMS
        fields = [self.system.field(k) for k in range(len(self.system.fields))]
        operands = ([RmsSpotRadius(f, WVL, self.sampling) for f in fields]
                    + [WavefrontRMS(fields[-1], WVL, self.sampling)])
        return Problem(self.system, operands, constraints=[EFL(WVL, target=self.efl)],
                       gradient='auto')

    def optimise(self, maxiter=DESIGN_SOLVE['maxiter'], problem=None):
        """Step 2: damped least squares (``DESIGN_SOLVE``); the lens is left at
        the result.  Returns (result, problem)."""
        problem = self.problem() if problem is None else problem
        with self.configured():
            result = problem.solve(**{**DESIGN_SOLVE, 'maxiter': maxiter})
        return result, problem

    def bundle(self, field_index):
        """(P, S) host launch of one system field over ``sampling``."""
        from .x.raytracing import launch
        with self.configured():
            return launch(self.system, self.system.field(field_index), WVL, self.sampling)

    def perturbations(self, scale=1.0):
        """The 6 tolerances, about the lens as it stands: the 3 curvatures, the
        2 glass thicknesses and the rear sphere's y decentre, in the plane of
        the fields (``DESIGN_SIGMAS``, each multiplied by ``scale``)."""
        from .x.raytracing import Perturbation
        s = {k: v * scale for k, v in DESIGN_SIGMAS.items()}
        system = self.system
        return ([Perturbation.normal(system, 'curvature', r, s['curvature'], name=f'c{r}')
                 for r in DESIGN_CURVATURE_ROWS]
                + [Perturbation.normal(system, 'thickness', r, s['thickness'], name=f't{r}')
                   for r in DESIGN_THICKNESS_ROWS]
                + [Perturbation.normal(system, 'decenter', DESIGN_DECENTRE_ROW,
                                       s['decenter'], name='dy', component=1)])

    def spot_merit(self, P, S):
        """merit(system): the RMS spot radius about the centroid of the fixed
        bundle (P, S), retraced through the system as it stands."""
        from .x.raytracing import RmsSpotRadius
        operand = RmsSpotRadius()

        def merit(system):
            return operand.value(system.trace(P, S, WVL), system, WVL)

        return merit

    def tolerance(self, trials=DESIGN_MC_TRIALS):
        """Step 3: ``sensitivity_table`` and a seeded ``monte_carlo`` of the
        edge field's spot merit, and the on-axis bundle's wavefront
        differential with the image gap as the focus compensator, its
        expected RMS, compensator motions and ``fast_monte_carlo``."""
        from .x.raytracing import Perturbation
        perts = self.perturbations()
        merit = self.spot_merit(*self.bundle(len(self.system.fields) - 1))
        P0, S0 = self.bundle(0)
        focus = Perturbation.normal(self.system, 'thickness', DESIGN_FOCUS_ROW,
                                    DESIGN_SIGMAS['focus'], name='focus')
        with self.configured():
            table = self.system.tol.sensitivity(perts, merit)
            mc = self.system.tol.monte_carlo(perts, merit, trials, seed=DESIGN_MC_SEED)
            wd = self.system.tol.wavefront(perts, P0, S0, WVL, compensators=[focus])
            fast = wd.fast_monte_carlo(perts, DESIGN_FAST_MC_TRIALS, seed=DESIGN_FAST_MC_SEED)
        return LensTolerance(table, mc, wd, wd.expected_rms(), wd.compensator_motions(), fast)

    def diffraction(self):
        """Step 4: ``pupil_field`` at each field (``npupil``^2 entrance grid) and
        its ``pupil_field_psf`` (``npix``^2, ``DESIGN_Q``), and ``raytrace_prt`` of the edge
        field's bundle: (pupil fields, [(psf, dx)], PRTResult)."""
        from .x.raytracing import pupil_field, pupil_field_psf, raytrace_prt
        P, S = self.bundle(len(self.system.fields) - 1)
        with self.configured():
            fields = [pupil_field(self.system, self.system.field(k), WVL, npupil=self.npupil)
                      for k in range(len(self.system.fields))]
            psfs = [pupil_field_psf(pf, npix=self.npix, Q=DESIGN_Q) for pf in fields]
            prt = raytrace_prt(self.system, P, S, WVL)
        return fields, psfs, prt

    def analysis(self, N=1024, fN=256):
        """Step 5: ``build_lens_analysis`` of the lens as it stands (real aiming)
        and one call of it: (plan, its outputs)."""
        la = build_lens_analysis(self.sampling, N, fN, dtype=self.dtype, device=self.device,
                                 system=self.system)
        return la, la()


def build_lens_design(sampling=None, npupil=DESIGN_NPUPIL, npix=DESIGN_NPIX, dtype=None,
                      device=None):
    """A lens designer's session on cfg6: read, optimise, tolerance, diffract, analyse.

    ``cfg6_design_system()`` (cfg6 with a neutral coordinate break before the
    rear sphere) is written by ``write_zmx`` and ``write_seq`` and read back
    with cfg6's model glasses as the database (``prescription``); the .zmx
    system is then optimised by damped least squares (``optimise``: the RMS
    spot radius at 0, 1 and 2 degrees and the edge field's RMS wavefront
    error, each on ``sampling``, default ``Sampling.hex(64)``, 12,481 rays a
    field; ``gradient='auto'``, reverse mode for the spots and forward mode
    for the wavefront; the EFL held; ``DESIGN_SOLVE``), toleranced
    (``tolerance``: 6 perturbations, a sensitivity table, a seeded Monte
    Carlo, the wavefront differential of the on-axis bundle with the image
    gap as compensator and its fast Monte Carlo), its pupil fields focused
    (``diffraction``: ``npupil``^2 grids, ``npix``^2 PSFs at ``DESIGN_Q``, and the
    polarization ray trace of the edge bundle) and analysed (``analysis``:
    ``build_lens_analysis(system=...)``, the step that launches the Zernike
    forward kernel, once a field).  Steps 1-4 run no hand-written kernel.
    Every step computes in ``dtype`` on ``device``.
    """
    return _LensDesign(sampling, npupil, npix, dtype, device)


# the mesh patterns: cfg2's pupil and focal grid over 8 wavelengths; phase 3e's
# Babinet frame with every level on one focal shape (N, focal samples, levels);
# cfg6's fit over the lens analysis's 36 modes, and its merged trace at hex(256)
PARALLEL_WVLS = tuple(float(w) for w in np.linspace(0.50, 0.60, 8))
PARALLEL_MR = (256, 96, 3)
PARALLEL_TRACE_RINGS = 256


@dataclass(frozen=True)
class MeshPattern:
    """One mesh pattern: its mesh's axes, and two callables returning {output: tensor}.

    ``sharded`` runs the ``parallel`` function; ``serial`` its single-card
    counterpart, cut to this rank's block where the sharded output is one.
    """
    axes: dict
    sharded: object
    serial: object


def _pattern_inputs(N, fN, dtype, dev):
    """cfg2's pupil, its NMS6 mode stack and field, and the 8-wavelength spectral plan."""
    from .mathops import cis
    pupil = make_pupil(N, dtype=dtype, device=dev)
    modes = zernike_nm_seq(NMS6, pupil.r, pupil.t)
    opd = sum_of_2d_modes(modes, pupil.coefs)
    field = pupil.amp * cis(opd * (2 * np.pi / (WVL * 1e3)))
    wvls = torch.tensor(PARALLEL_WVLS, dtype=dtype, device=dev)
    weights = torch.full_like(wvls, 1 / len(PARALLEL_WVLS))
    plan = plan_mdft_spectral(pupil.dx, (N, N), 0.25, fN, PARALLEL_WVLS, EFL,
                              dtype=complex_for(dtype), device=dev)
    return pupil, modes, field, wvls, weights, plan


def _grads(fn, *leaves):
    """(fn's value, its gradients) with respect to leaves (detached copies)."""
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        value = fn(*leaves)
        return value.detach(), torch.autograd.grad(value, leaves)


def _broadband_patterns(pupil, modes, wvls, weights, plan, world):
    from .mathops import cis
    from .parallel import broadband_psf, make_hybrid_mesh, make_mesh, shard_broadband_step
    from .parallel.overlap import overlapped_spectral_grad
    wl = 2 if world % 2 == 0 else 1
    amp, c = pupil.amp, pupil.coefs
    I_meas = broadband_psf(c * 0.5, amp, modes, wvls, weights, plan)

    def serial():
        loss, (grad,) = _grads(
            lambda cc: torch.sum((broadband_psf(cc, amp, modes, wvls, weights, plan)
                                  - I_meas) ** 2), c)
        return {'loss': loss, 'grad': grad}

    def sharded(mesh):
        step = shard_broadband_step(mesh, plan, amp, modes, wvls, weights, I_meas)

        def run():
            loss, grad = step(c)
            return {'loss': loss, 'grad': grad}
        return run

    def per_wavelength(cc):
        opd = torch.tensordot(cc, modes, dims=([0], [0]))
        E = plan(amp[None] * cis((2 * np.pi / (wvls * 1e3))[:, None, None] * opd[None]))
        return E.real * E.real + E.imag * E.imag

    I_pw = per_wavelength(c * 0.5)

    def overlap_serial():
        loss, (grad,) = _grads(
            lambda cc: torch.sum(weights[:, None, None] * (per_wavelength(cc) - I_pw) ** 2), c)
        return {'loss': loss, 'grad': grad}

    ov_axes = {'wl': world}
    ostep = overlapped_spectral_grad(make_mesh(ov_axes), plan, amp, modes, wvls, weights, I_pw,
                                     n_chunks=2)

    def overlap():
        loss, grad = ostep(c)
        return {'loss': loss, 'grad': grad}

    axes = {'wl': wl, 'ty': world // wl}
    return {'broadband': MeshPattern(axes, sharded(make_mesh(axes)), serial),
            'hybrid': MeshPattern(axes, sharded(make_hybrid_mesh({'wl': wl},
                                                                 {'ty': world // wl})), serial),
            'overlap': MeshPattern(ov_axes, overlap, overlap_serial)}


def _babinet_pattern(dtype, dev, world):
    from .parallel import make_mesh, shard_multires_babinet, stack_multiresolution
    from .propagation import prepare_multiresolution, to_fpm_and_back_multiresolution
    N, samples, levels = PARALLEL_MR
    pdx = DIAMETER / N
    x, y = make_xy_grid(N, diameter=DIAMETER, dtype=dtype, device=dev)
    r = torch.hypot(x, y)
    E = antialias(circle_sdf(1.0, r), pdx).to(complex_for(dtype))
    lyot = antialias(circle_sdf(0.9, r), pdx)
    lam_d = WVL * EFL / 2.0
    mre = prepare_multiresolution(pdx, (N, N), lam_d / 2, samples, WVL, EFL, num_levels=levels,
                                  fine_samples=samples, dtype=complex_for(dtype), device=dev)
    disk = lambda xf, yf: (torch.hypot(xf, yf) <= 3 * lam_d).to(xf.dtype)  # noqa: E731
    axes = {'lv': world}
    babinet = shard_multires_babinet(
        make_mesh(axes), stack_multiresolution(mre, lambda xf, yf: 1 - disk(xf, yf),
                                               babinet=True), lyot)

    def serial_babinet(a):
        return lyot * (a - to_fpm_and_back_multiresolution(a, disk, mre))

    def run(fn):
        out = fn(E)
        _, (grad,) = _grads(lambda a: torch.sum(fn(a).abs() ** 2), E)
        return {'out': out, 'grad': grad}

    return MeshPattern(axes, lambda: run(babinet), lambda: run(serial_babinet))


def _transform_patterns(pupil, field, fN, dtype, world):
    from .parallel import make_mesh, shard_mdft_contraction, shard_mdft_contraction_roundtrip
    from .parallel._collectives import shard
    from .parallel.fft import (plan_distributed_focus, plan_distributed_unfocus,
                               shard_focus_grad_step)
    from .propagation import focus, unfocus
    N = field.shape[-1]
    plan = make_cfg2_plan(pupil, fN, matmul_precision=None)
    c = torch.arange(fN, dtype=torch.float64) - (fN - 1) / 2
    yy, xx = torch.meshgrid(c, c, indexing='ij')
    vortex = torch.polar(torch.ones_like(xx), 2 * torch.atan2(yy, xx)).to(field.device,
                                                                          plan.Ex.dtype)
    ct_axes, fy_axes = {'ct': world}, {'fy': world}
    ct, fy = make_mesh(ct_axes), make_mesh(fy_axes)
    forward = shard_mdft_contraction(ct, plan)
    roundtrip = shard_mdft_contraction_roundtrip(ct, plan, focal_factor=vortex)

    def rows(x, mesh, axis):
        """This rank's rows of a serial result that the sharded path returns as a block."""
        return shard(x, mesh, axis, 0)

    def contraction_serial():
        return {'focal': plan(field),
                'roundtrip': rows(plan.adjoint(plan(field) * vortex), ct, 'ct')}

    Q = 2
    I_meas = focus(field, Q).abs() ** 2 * 0.9
    fwd = plan_distributed_focus(fy, (N, N), Q, dtype=dtype)
    inv = plan_distributed_unfocus(fy, (N, N), Q, dtype=dtype)
    gstep = shard_focus_grad_step(fy, (N, N), Q, dtype=dtype)

    def fft_sharded():
        loss, (gre, gim) = gstep(field.real, field.imag, I_meas)
        return {'focus': fwd(field), 'unfocus': inv(field), 'loss': loss, 'grad_re': gre,
                'grad_im': gim}

    def fft_loss(re, im):
        F = focus(torch.complex(re, im), Q)
        return torch.sum((F.real * F.real + F.imag * F.imag - I_meas) ** 2)

    def fft_serial():
        loss, (gre, gim) = _grads(fft_loss, field.real, field.imag)
        return {'focus': rows(focus(field, Q), fy, 'fy'),
                'unfocus': rows(unfocus(field, Q), fy, 'fy'), 'loss': loss,
                'grad_re': rows(gre, fy, 'fy'), 'grad_im': rows(gim, fy, 'fy')}

    return {'contraction': MeshPattern(ct_axes, lambda: {'focal': forward(field),
                                                         'roundtrip': roundtrip(field)},
                                       contraction_serial),
            'fft': MeshPattern(fy_axes, fft_sharded, fft_serial)}


def _raytrace_patterns(dtype, dev, world):
    from .parallel import make_mesh, shard_merged_trace_rate, shard_wavefront_fit
    from .x.raytracing import Sampling
    from .x.raytracing.batch import device_wavefront_fit, merged_trace
    system = cfg6_system()
    axes = {'rays': world}
    rays = make_mesh(axes)
    fit_rings, trace = Sampling.hex(CFG6_RINGS), Sampling.hex(PARALLEL_TRACE_RINGS)

    def configured(fn):
        def run():
            with precision_as(dtype), device_as(dev):
                return fn()
        return run

    def fit():
        coefs, rms = shard_wavefront_fit(rays, system, LENS_NMS, sampling=fit_rings)
        return {'coefs': coefs, 'rms': rms}

    def fit_serial():
        coefs, rms = device_wavefront_fit(system, LENS_NMS, sampling=fit_rings, device=dev)
        return {'coefs': coefs, 'rms': rms}

    def landed():
        return {'landed': shard_merged_trace_rate(rays, system, WVL, trace)[0]}

    def landed_serial():
        # the sharded bundle pads each field's rays to a multiple of the ranks with
        # copies of its ray 0, and sums them too
        _, (res,) = merged_trace(system, wavelengths=[WVL], sampling=trace, device=dev)
        final = torch.nan_to_num(res.P[-1]).reshape(len(system.fields), -1, 3)
        pad = -final.shape[1] % world
        return {'landed': final.sum(dim=(0, 1)) + pad * final[:, 0].sum(dim=0)}

    return {'raytrace_fit': MeshPattern(axes, configured(fit), configured(fit_serial)),
            'merged_trace': MeshPattern(axes, configured(landed), configured(landed_serial))}


def build_parallel_patterns(device='cuda', dtype=torch.float32, N=1024, fN=256):
    """Every mesh pattern of ``parallel`` at full width, beside its serial counterpart.

    Needs an initialised default process group (NCCL for a CUDA ``device``,
    gloo for the CPU) of world size w; meshes: broadband ``wl`` (2 if w is
    even, else 1) x ``ty``, its hybrid ``{'wl'} x {'ty'}``, and 1-D meshes of
    w ranks for the other patterns (a size that does not divide raises
    ValueError).  Sizes (N = 1024, fN = 256 by default): cfg2's N^2 pupil and
    NMS6 mode stack at ``COEFS6``, the 8 wavelengths of ``PARALLEL_WVLS``
    (0.50-0.60 um) with equal weights, the spectral MDFT to fN^2 at cfg2's
    0.25 um, ``I_meas`` from 0.5 x the
    coefficients (per wavelength for the overlapped gradient, 2 chunks);
    phase 3e's 256^2 Babinet frame (a 3 lambda/D occulting disk, Lyot stop
    0.9) through 3 levels of 96^2, forward and the gradient of sum |out|^2
    with respect to the field; cfg2's MDFT to fN^2 (full-precision
    products), forward and a round trip through a charge-2 vortex; the
    distributed focus and unfocus of cfg2's field at Q=2 and the focus-grad
    step against 0.9 x its PSF; cfg6's wavefront fit over ``LENS_NMS`` at 3
    fields x hex(64) and its merged trace at hex(256), traced in ``dtype``.
    Returns {name: MeshPattern}.
    """
    import torch.distributed as dist
    dev = resolve_device(device)
    world = dist.get_world_size()
    with precision_as(dtype), device_as(dev):
        pupil, modes, field, wvls, weights, plan = _pattern_inputs(N, fN, dtype, dev)
        patterns = _broadband_patterns(pupil, modes, wvls, weights, plan, world)
        patterns['babinet'] = _babinet_pattern(dtype, dev, world)
        patterns.update(_transform_patterns(pupil, field, fN, dtype, world))
        patterns.update(_raytrace_patterns(dtype, dev, world))
    return patterns
