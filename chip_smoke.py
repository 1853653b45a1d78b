"""Drive the PyTorch/CUDA port's main paths on one card and check them.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and exits nonzero, printing no result, without
one; it uses the first visible card and hides the others from itself.
Phases, each of which raises on a failed check:

1. build the CUDA kernels from ``prysm_tpu_torch/csrc/zernike.cu`` and
   ``csrc/noise.cu``, one nvcc each, started together; print the build
   times and each kernel's registers and spills;
2. hold each kernel against its plain PyTorch version on the card: the
   Zernike kernels in f32 at 1024^2, at 1023^2, on views that start off a
   16-byte boundary and with angles past sincosf's fast range, for five
   mode sets (6 modes in the 4-slot kernels; 45, and phase 3l's 36, in the
   32-slot ones; the 66 to n = 10 and 34 radial orders to n = 66, each run
   by the 32-slot kernels in two launches) and both norms, the coefficient cotangents
   also mode by mode, each against its own size, bit-identical from run
   to run (the coefficient backward's and the full backward's), one
   device kernel per call (per piece of a longer program) and no other
   device operation, counted from the nodes of a CUDA graph captured from
   the call and, where the profiler recorded a trace, from it, the blocks
   each kernel keeps resident,
   the largest |difference| for the kernels line taken over NMS6, the
   main path's plan; the noise kernel on the cfg5 mean-electron map (1 and
   16 frames, and in a view off a 16-byte boundary), on an odd 41 x 53 map
   with zero-signal pixels in 5 frames and on a 256^2 map at 1000 e- with 4
   frames (the same Philox uniforms, so the DN agree but for rare rounding
   ties), its zero-signal case, its reproducibility and its moments against
   the analytic chain;
3. the main paths, each with every launch count set to 0 just before it
   and read just after:
   a. the cfg2 phase-retrieval step (1024^2 pupil -> 256^2 focal grid by
      MDFT, ``matmul_precision='high'``, ``grads='coefs'``) for 5 gradient
      steps, the flagship ``entry()`` forward and the cfg1 step (FFT
      focus, Q=2, PSF, MTF) for 5 steps, and the public ``zernike_sum``
      with its default ``grads='all'`` backward; each result is checked
      against the same computation in f64 on the card;
   b. the cfg5 frame (6-wavelength Babinet coronagraph at 512^2 -> Q=1
      focus -> RGGB mosaic -> detector exposure through the noise kernel
      -> Malvar demosaic) for seeds 0-4, one kernel launch per frame; the
      focal intensities, mosaic and demosaic against f64 on the card, and
      the noise statistics of the frames' exposures;
   c. the cfg3 phasing step (a 2-ring, 19-segment hexagonal aperture with
      piston/tip/tilt per segment at a 512^2 pupil -> Q=2 focus -> 1024^2
      PSF -> encircled energy at 10 um, and the energy's gradient with
      respect to the (19, 3) coefficients) for 5 steps; PSF, energy and
      gradient against f64 on the card, and the encircled energy of an
      unsegmented circular pupil against the analytic curve;
   d. the cfg4 chain (1024^2: angular spectrum -> thin lens -> angular
      spectrum -> intensity) against f64 on the card, and a +z / -z
      angular-spectrum round trip at 1024^2;
   e. the executors in f32: MDFT, CZT and FFTDFT against |FFT focus| on
      the matched Q=2 grid and through their adjoint inner products, and a
      multi-resolution Babinet coronagraph frame against f64 on the card;
   f. the freeform-fit path (1024^2 grid over the unit disk: the sag and
      slopes of a Q2d surface with every term to n = 8, |m| = 8, a
      least-squares fit of 36 normalized Noll Zernikes, the reconstruction
      through ``zernike_sum``, one launch of the Zernike forward kernel,
      and the masked residual RMS; the Chebyshev, XY, radial Jacobi and
      Zernike sag families with their slopes) against the same path in f64
      on the card, with the TF32 switch off as ``set_matmul_precision``
      left it;
   g. the image chain (1024^2: a 36-spoke Siemens star convolved with the
      flagship PSF, and through its OTF, a smear and a jitter) against f64
      on the card, the star built once in f64 and cast, with the share of
      pixels whose threshold a star built in f32 would flip;
   h. cfg6 (bench.py's doublet + singlet: two model glasses, three spheres,
      EPD 20, fields 0/1/2 degrees, ``Sampling.hex(64)``: 37,443 rays in one
      merged bundle) through ``steps.build_cfg6_trace`` and
      ``build_cfg6_grad`` (the mean field RMS spot radius about each chief
      ray and its gradient with respect to the three curvatures) in f32
      against f64 on the card: every ray OK with the same status in both,
      landing points, total OPL, the EIC closing onto each field's
      chief-centered sphere through the paraxial exit pupil, and the
      gradient;
   i. the interferometer-analysis path (``steps.build_metrology``: 13
      phase-shifted frames of a 100 mm flat at 1024^2, de Groot's phase,
      the DCT least-squares unwrap, an ``Interferogram`` masked, with
      piston, tilt and power removed and spikes clipped, its statistics and
      PVr, PSD, band-limited RMS, azimuthal average, lowpass and slopes) in
      f32 against f64 on the card from the same f64 host frames: the
      wrapped phase, the map, the analysis on the f64 map cast to f32 and
      the path end to end, the f64 map against the true surface, the
      spike-clip and band-edge flips, a Zygo .dat round trip, ``fit_psd``
      on the card against the CPU, ``profiling.time_fn`` and
      ``device_memory_stats``; and a 32-layer thin-film stack over 4096
      wavelengths x 90 angles in complex64 against complex128, with its
      energy balance;
   j. the coating designer's path (``steps.build_coating_design``: a
      41-layer (HL)^20 H edge filter, 5% seeded thickness errors, R = 1 /
      T = 1 over 1024 wavelengths x 2 angles, s and p) in f32 and f64 on
      the card: at the start the merit, its thickness gradient and
      ``index_gradient``, f32 against f64; the f64 thickness gradient
      against central differences and ``needle_function`` at five depths
      against the merit's difference when a needle is inserted; ``refine``
      by ``PrysmLBFGSB`` (100 iterations) in f64 against the same run on
      the CPU (a worker process started at the top of the script: the
      first 10 iterates and the final merit) and in f32, R + T = 1 on the
      refined stacks and the merit lowered in both; ``refine`` by damped
      least squares (10 iterations); ``PrysmLBFGSB`` against the SciPy
      driver ``LBFGSB`` on a bound-active box, iterate for iterate; and
      ``synthesize`` of a broadband AR (256 wavelengths x 3 angles, 240
      depths, up to 24 layers, 12 rounds) in f64 against the CPU's: the
      same layer count and the merit close. Every iterate stays on the card;
   k. phase retrieval driven by optym (``steps.build_phase_retrieval_lbfgsb``:
      cfg2's 1024^2 pupil, TF32 MDFT to 256^2 and intensity L2 loss,
      ``PrysmLBFGSB`` from 0.8 x the truth in a +-60 box for 40
      iterations): the coefficients against the truth, and each objective
      evaluation launching exactly one Zernike forward and one coefficient
      backward kernel; beside it, the same retrieval with float32 MDFT
      products, its error printed;
   l. the wavefront-control step (``steps.build_wavefront_control``: a
      1024^2 pupil, 36 Zernike modes through the fused kernels with
      grads='coefs', plus the WFE of a 50 x 50 DM folded 10 degrees, TF32
      MDFT to 256^2, the intensity loss against the unaberrated PSF and its
      actuator and coefficient gradients) for 5 steps: the first eager,
      launching the forward and coefficient-backward kernels as often as
      the 36-mode plan's pieces, the second twice as often (once eager on a
      side stream, once into the step's CUDA graph), the rest replaying
      that graph with no launch from the host; against f64 on the card
      from the same grids (the mode stack): the OPD, the PSF with f32 and
      with TF32 products, both gradients and the loss; the step's
      Shack-Hartmann frame (32 x 32 lenslets of 32 samples, angular
      spectrum over their focal length);
      in f64 an unfolded DM's ``render_adjoint`` chain against autograd
      (the folded DM's difference printed);
   m. at 256^2: a 4-step PSPDI measurement recovered through ``x/psi``
      against the true phase, the SRI forward model and its fiber
      coupling, a charge-2 vector vortex through ``jones_adapter(focus)``
      (the four components' intensities against the scalar vortices), f32
      against f64; an MWIR germanium singlet from
      ``infrared_catalog(80.0)`` and ``(295.0)`` traced in f32 and f64: its
      EFL at each temperature and the shift, against f64 and the paraxial
      EFL;
   n. the lens-analysis path (``steps.build_lens_analysis``: cfg6 with real
      ray aiming, 3 fields x ``Sampling.hex(64)`` = 37,443 rays planned
      once in f64 with the exit pupil; a call fits each field's wavefront
      over the 36 modes to n = 7 in one merged trace, renders each fit on
      a 1024^2 pupil through the fused Zernike forward kernel, one launch
      a field, focuses it by cfg2's MDFT plan to 256^2, and takes the
      gradients of the RMS spot radius and the OPL spread with respect to
      the three curvatures and two glass thicknesses by reverse mode) in
      f32 against f64 on the card from the same launches: every ray's
      status, landing points, OPL, exit-pupil z, coefficients, residual
      RMS, the OPD, PSF with f32 products and through the step's plan from
      the same f32 coefficients against the f64 mode stack, the PSFs end to
      end, the sensitivities; beside the call ``first_order`` at each
      field, the Seidel sums, distortion and field curvature (11 samples),
      spot diagrams, OPD fans and the RMS-WFE full-field map (7 x 7), each
      against f64 at bars of twice the JAX package's f32 errors where those
      exceed the suggested ones (``probes/lens_cpu_probe.py``); in f64 the
      sensitivities against the forward tangents of the same heads and
      against central differences, ``first_order`` on axis against the
      paraxial walk; the fish-eye (``sample_rx.fisheye_system``) launched
      real-aimed at 70 degrees on ``Sampling.hex(8)``, which takes the
      continuation ladder and its parabasal pupils, on the card against
      the same launch on the CPU; exactly 3 Zernike forward launches and
      no other hand-written launch per call;
   o. the lens designer's path (``steps.build_lens_design``: cfg6 with a neutral
      coordinate break before the rear sphere), each step with the launch counts
      set to 0 before it and read after: the prescription written by
      ``write_zmx`` / ``write_seq`` and read back (both reads trace the edge
      field's bundle alike, and like the design system with its curvatures
      rounded to the writers' 6 significant digits, to 1e-12 mm in f64); the
      optimisation by damped least squares over the three curvatures and two
      glass thicknesses with the EFL held (the RMS spot radius at 0, 1 and 2
      degrees on ``Sampling.hex(64)``, 12,481 rays a field, and the edge field's
      RMS wavefront error; ``gradient='auto'``: reverse mode for the spots,
      forward mode for the wavefront), in f64: at the start the 'auto'
      Jacobian against central differences and, from the same launches, f32
      against f64, the first iterates against the same solve on the CPU (a
      worker process started at the top of the script), the EFL held and the
      merit lowered; the tolerancing of the result (6 perturbations:
      ``sensitivity_table`` against the adjoint sensitivities over its own
      truncation, a seeded 100-trial ``monte_carlo`` whose first trials the CPU
      repeats, the on-axis bundle's ``wavefront_differential`` with the image
      gap as compensator against central differences, ``expected_rms``,
      ``compensator_motions``, ``fast_monte_carlo``); the diffraction of the
      result (``pupil_field`` at each field on a 128^2 grid, ``pupil_field_psf``
      at 512^2, Q=2, and ``raytrace_prt`` of the edge bundle) in f32 against
      f64; and one call of ``build_lens_analysis`` on the result in f32, which
      launches the Zernike forward kernel 3 times and nothing else; the first
      four steps launch no hand-written kernel;
   p. the mesh patterns of ``parallel`` (``steps.build_parallel_patterns``)
      over a world-size-1 NCCL process group (a file rendezvous in a
      temporary directory, an explicit timeout; destroyed after phase 4):
      the broadband wavelength x tile phase-retrieval step and its hybrid
      (inter-host x intra-host) mesh variant (cfg2's 1024^2 pupil and NMS6
      mode stack, 8 wavelengths over 0.50-0.60 um, the spectral MDFT to
      256^2), the level-sharded multi-resolution Babinet frame (phase 3e's,
      3 levels of 96^2) and its field gradient, the contraction-sharded MDFT
      (1024^2 -> 256^2) and its round trip through a charge-2 vortex, the
      distributed FFT focus and unfocus at 1024^2, Q=2, and its gradient
      step, the overlapped per-chunk gradient (per-wavelength frames, 2
      chunks), cfg6's sharded wavefront fit (3 fields x hex(64), 36 modes)
      and its sharded merged trace at hex(256), each against its serial
      counterpart in the port in f32 (1e-5) and in f64 (1e-10) on the
      card;
   q. the five examples (``prysm_tpu_torch.examples``: the LOWFS sensor at
      256^2 -> 64^2, the dark-hole dig at 128^2 -> 64^2, the phase
      retrieval at 256^2 -> 96^2, the doublet's design and tolerances, the
      V-coat's refinement), each ``main`` at its default size in f32 and in
      f64: every run against the examples' marks (tests/test_examples.py);
      f64 against the same runs on the CPU (a spawn worker process: the
      LOWFS reconstructor and frame, the dark energy and its gradient at
      zero, the first 3 iterates of each optimizer, the lens's start merit,
      EFL and curvature tolerances, the coating's reflectance and merit) at
      1e-9; f32 against f64 at the suggested tier or twice the JAX
      package's own f32 figure (``probes/examples_cpu_probe.py``), where
      that is larger;
   r. the card tier: ``tests/test_torch_chip_*.py`` (the counterparts of
      ``tests_tpu/``'s 43 functions, 55 cases) under ``pytest --noconftest``
      in a process of its own on the card, which must exit 0 with every
      collected case passed, none failed, errored or skipped, and launch the
      Zernike forward, full backward and noise kernels it holds to their
      twins;
   s. the port's documentation (``docs/torch/`` through ``prysm_tpu_torch.docs``): every
      executed doc, block by block in a temporary working directory, at its own sizes, on
      the card in f32 and in f64; f64 against the same docs run in f64 on the CPU (a
      spawn worker process, whose random draws the card's runs replay) at 1e-9 (the
      kernel lesson's fused synthesis at the Zernike tier: the kernel computes in f32);
      f32 against f64 at the f32 tier of each result's kind, or twice the JAX package's
      own f32 error where that is larger (``probes/docs_cpu_probe.py``); frames by their
      mean and spread; the Zernike forward and noise kernels launched by the kernel
      lesson and the noise kernel by the image-simulation tutorial, in both precisions;
      each doc's wall seconds and the phase's;
   t. ``torch.func`` through the port's custom autograd Functions, f32 and f64,
      over the world-size-1 NCCL group of phase 3p: ``torch.func.grad`` of
      cfg2's TF32 loss against autograd's (one forward and one coefficient
      backward launch each), the ``jvp`` of its ``'high'`` plan against the
      plan applied to the tangent, ``torch.func.grad`` of phase 3a's 1024^2
      ``zernike_sum`` decentre loss (grads='all') against autograd's (one full
      backward launch each), ``vmap`` of ``zernike_sum`` over 4 coefficient
      vectors against 4 calls (4 forward launches each), the sharded
      broadband loss's ``torch.func.grad`` against its serial autograd
      gradient at phase 3p's bars; in f64 ``jacfwd`` of a 41-layer edge
      filter's ``stack_rt`` over its thicknesses against central differences;
      and ``python -m prysm_tpu_torch.tools.scaling_bench`` at world size 1
      (256^2, 2 wavelengths, 128^2), whose row it prints;
   the paths of c-e, g-j, m, p and q run no hand-written kernel: their launch
   counts, set to 0 before each, must read 0 after it;
4. timing with CUDA events: ms per step and per frame, in turns; device ms
   and busy share; ms per kernel call cold (inputs evicted from L2) and
   warm (inputs left in L2 by the call before), per call of its plain
   version and of the one PyTorch call that computes the same function,
   where there is one (the library yardstick); a one-element op's time
   back to back and one torch.add over the forward's bytes, for scale;
   each kernel's bound, the larger of its bytes over the HBM rate and its
   operations, counted from its SASS, over the card's rate for each pipe
   (fp32, the integer ALU, the integer multiplies);
   beyond the kernels line, the noise kernel on a 16-frame stack of the
   cfg5 map and the full backward on the 45 modes to n = 8 (the 32-slot
   kernel) and the 66 to n = 10 (two launches), each beside its bound;
   the cfg3 forward, the cfg3 forward + gradient, the cfg4 chain, the
   freeform fit, the image chain, the cfg6 trace at hex(64) and at
   hex(256) (592,131 rays), the cfg6 gradient step and the metrology call
   are timed in turns
   with the steps and the frame (the freeform fit's three parts, sag, fit
   and families, in a second round of turns), each with its device time,
   busy share, device kernels and hand-written kernel launches per call
   and longest device operations; cfg6's host launch, the metrology PSD
   fit and the thin-film stack on their own lines; the coating merit's
   objective evaluation in f32 and f64 (wall, device ms, busy share,
   device kernels), a ``PrysmLBFGSB`` iteration with its evaluations and
   host synchronisations (counted under ``torch.cuda.set_sync_debug_mode``),
   the two refinements' and the synthesis's wall times, and the phase
   retrieval's ms per iteration and per evaluation with its launches; the
   wavefront-control step, the DM render alone and the Shack-Hartmann
   frame, in turns with the steps above, each with its device time, busy
   share, device kernels and hand-written launches per call; the
   lens-analysis call and its sensitivities alone (wall, device time, busy
   share, device kernels, hand-written launches per call), ``first_order``
   at one field and the fish-eye's ladder launch on the host clock; the
   designer's DLS linearisation (residuals and 'auto' Jacobian), wavefront
   differential and one pupil-field PSF (wall, device ms, busy share, device
   kernels, hand-written launches), a Monte Carlo trial and phase 3o's solve,
   tolerancing, diffraction and analysis steps on the host clock; each mesh
   pattern in turns with its serial counterpart (wall ms, device ms, busy
   share, device kernels, the device ms in NCCL kernels, hand-written
   launches per call); the examples in f32: the LOWFS closed-loop frame
   (wall per frame by the slope between loops of 64 and 1024 frames, frames
   per second, device ms, busy share and device kernels per frame), one
   dark-hole and one retrieval evaluation (value and gradient: wall ms,
   device ms, busy share, device kernels), and on the host clock the dark
   hole's run, the retrieval example's run, the lens example's solve and
   the coating example's refinement;
5. a ``{"kernels": [...]}`` line, the card's name and power limit, and the
   last line ``{"ok": true, "device": {...}}``.
"""
import os

# one card: the first visible one, and the process sees no other
os.environ['CUDA_VISIBLE_DEVICES'] = os.environ.get('CUDA_VISIBLE_DEVICES', '0').split(',')[0]

import datetime
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import torch  # noqa: E402 (after the card is chosen)

N, FN, STEPS = 1024, 256, 5
SEED = 20260401
NMS45 = tuple((n, m) for n in range(9) for m in range(-n, n + 1, 2))
# plans longer than the largest compiled program, which run in two pieces:
# the full set to n = 10 (cut at a group start) and one radial group of 34
# orders (cut inside the group)
NMS66 = tuple((n, m) for n in range(11) for m in range(-n, n + 1, 2))
RADIAL34 = tuple((n, 0) for n in range(0, 68, 2))
N5, SEEDS5 = 512, range(5)
N3, N4 = 512, 1024
# the H100 SXM data sheet: HBM bytes/s and fp32 (non-tensor) operations/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# int32 instructions/s of each integer pipe, the ALU (adds, logic, shifts,
# compares) and the FMA pipe's multiplies (IMAD): 64 lanes per SM each (CUDA
# C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0) x 132 SMs x the 1.98 GHz that the fp32 figure implies
INT32_PIPE_OPS_PER_S = 64 * 132 * 1.98e9
PIPE_OPS_PER_S = {'fp32': FP32_OPS_PER_S, 'alu': INT32_PIPE_OPS_PER_S,
                  'imad': INT32_PIPE_OPS_PER_S}
# a cold call's inputs were last touched this many bytes of other inputs ago
COLD_BYTES = 100e6
KERNEL_ROWS = {
    # name: (source, TPU kernel it replaces, bytes moved per pixel)
    'zernike_fwd': ('zernike.cu', 'prysm_tpu/ops/zernike.py:108', 12),
    'zernike_bwd_coefs': ('zernike.cu', 'prysm_tpu/ops/zernike.py:130', 12),
    'zernike_bwd_all': ('zernike.cu', 'prysm_tpu/ops/zernike.py:165', 20),
    'noise_expose': ('noise.cu', 'prysm_tpu/ops/noise.py:68', None),
}
# operations of the noise kernel, counted from its SASS along the path every
# cell of cfg5 takes, the function's own work only (csrc/noise.cu says how):
# fp32 operations (an FFMA as two), integer ALU instructions and IMADs of a
# thread's setup, once for its NOISE_CELLS pixels and up to NOISE_FRAMES
# frames, and of each frame of them
NOISE_CELLS, NOISE_FRAMES = 4, 4
NOISE_OPS = {'setup': {'fp32': 24, 'alu': 4, 'imad': 6},
             'frame': {'fp32': 284, 'alu': 75, 'imad': 33}}
# fp32 operations per pixel of the Zernike kernels for NMS6, the plan that
# phase 4 times, counted from their SASS along the path NMS6 takes through
# one quad of the 4-slot kernels (csrc/zernike.cu says how), an FFMA as two:
# 353, 353 and 637 per quad
ZERNIKE_FP32_OPS = {'zernike_fwd': 353 / 4, 'zernike_bwd_coefs': 353 / 4,
                    'zernike_bwd_all': 637 / 4}
# fp32 operations per pixel of the 32-slot full backward
# (zernike_all_kernel<32>), counted from its SASS in the same way, per event
# of its walk: each launch's fixed part (sincos, x, the prologue's restart,
# the last fold, the products by g), a slot (a recurrence step with its
# derivative, and the uses' sums), a fold of the chain rule at a group
# start, an angle turn, a group restart, a turn and a recurrence step of the
# prologue, and a later piece's adds: 184, 88, 76, 24, 12, 28, 40 and 8 per quad
KALL32_FP32_OPS = {'launch': 46, 'slot': 22, 'fold': 19, 'turn': 6, 'restart': 3,
                   'pre_turn': 7, 'pre_step': 10, 'add': 2}
# phase 3i's bars on the float32 metrology path from the frames, against float64,
# where the suggested ones lie below what the JAX package's own float32 path gives:
# twice its error on the same 1024^2 frames on the CPU, rounded up
# (probes/metrology_cpu_probe.py: the unwrap's float32 floor, 9.6e-3 of the map's
# PV, and what it carries into each output); 'map' is of the map's PV, 'pv'
# to 'strehl', 'pvr' and 'bandlimited_rms' relative, the rest of their peak
METROLOGY_E2E_BARS = {'map': 2e-2, 'pv': 3e-2, 'rms': 5e-3, 'Sa': 6e-3, 'std': 5e-3,
                      'strehl': 2e-4, 'pvr': 2e-2, 'bandlimited_rms': 7e-3, 'psd': 5e-2,
                      'azavg': 6e-2, 'filtered': 5e-2, 'slope_x': 1e-1, 'slope_y': 3e-2,
                      'slope': 9e-2}
# the float32 azimuthal average of the float64 map's PSD: its polar sample
# points are off by up to 0.025 px (the grid step is a difference of two
# float32 frequencies near +-N/2 du); the JAX package's is 2.9e-2 of the peak
METROLOGY_AZAVG_F32_BAR = 6e-2
# phase 3j's float32 bars: twice the JAX package's own float32 errors on the
# same design at its full size on the CPU (probes/coating_cpu_probe.py): the
# merit at the start (relative; JAX 1.28e-6), its thickness and index
# gradients (of their peaks; 1.95e-5, 1.78e-5) and |R + T - 1| over the
# merit's grids (1.28e-6), rounded up
COATING_F32_BARS = {'merit': 2.6e-6, 'thickness_gradient': 3.9e-5, 'index_gradient': 3.6e-5,
                    'energy': 2.6e-6}
COATING_BAR_SOURCE = '2x the JAX package f32, probes/coating_cpu_probe.py'
# the L-BFGS-B refinement's length, its iterates compared with the CPU's, and the
# head-to-head with the SciPy driver: a box of +-2% about the quarter-wave
# thicknesses, which the perturbed start leaves 28 of 41 layers outside
COATING_LBFGSB_ITERS, COATING_LM_ITERS, COATING_COMPARED, HEAD_TO_HEAD_ITERS = 100, 10, 10, 15
HEAD_TO_HEAD_BOX = 0.02
# phase 3k's bar: twice the JAX package's own float32 error on the same
# retrieval at 1024^2 -> 256^2 on the CPU with the MDFT's products taking TF32
# operands, as the card's TF32 plan does (probes/coating_cpu_probe.py: 4.20e-5;
# with float32 products 1.91e-6, one float32 ulp of the largest coefficient; the
# port's float64 run 3.6e-15)
RETRIEVAL_TF32_BAR = 8.4e-5
RETRIEVAL_JAX_F32 = 1.91e-6
# phase 3l's bar on the TF32 PSF: the cfg2 MDFT's TF32 field is 2.3e-5 from f64 (PR 1),
# about twice that in intensity; twice again
WFC_TF32_PSF_BAR = 1e-4
# phase 3m at 256^2: the PSPDI pupil (epd mm, efl mm, um), its aberration ((n, m) and nm,
# over the pupil radius), the pinhole (the model's units: its window is this many um
# across, 0.55 lambda F#; the default 0.25 passes a reference weaker than the zero order's
# wings in the test window, which then carry the fringes); the recovery's bar, twice its
# f64 error (5.75e-3 rad rms for 0.29 rad of phase, which this phase prints; the same on
# the CPU); the MWIR germanium singlet
# (curvature 1/mm and thickness mm of each surface, 4 um, ray heights mm)
N_INSTR, INSTR_EPD, INSTR_EFL, INSTR_WVL = 256, 10.0, 100.0, 0.55
INSTR_ZERNIKES = (((2, 0), (2, 2), (3, -1), (3, 3), (4, 0)), (20.0, -15.0, 10.0, 8.0, -6.0))
INSTR_PINHOLE, INSTR_PSPDI_BAR = 3.0, 1.2e-2
INSTR_GE_LENS, INSTR_GE_WVL = ((1 / 100.0, 8.0), (1 / 150.0, 95.0)), 4.0
INSTR_GE_HEIGHTS = (0.5, 1.0, 2.0)
# the thin-film check: (HL)^16 quarter-wave at 0.55 um on glass, 4096
# wavelengths x 90 angles, s and p
FILM_INDICES, FILM_SUBSTRATE, FILM_WVL0 = (2.35, 1.46) * 16, 1.52, 0.55
FILM_WVLS, FILM_ANGLES = (0.40, 0.80, 4096), (0.0, 89.0, 90)
# phase 3n: the lens-analysis path (steps.build_lens_analysis, cfg6 with real aiming):
# the samples of distortion and field curvature and the full-field map's side beside
# the call; the first_order slots compared; the central-difference step of the f64
# sensitivity check; the fish-eye field and pupil that drive the real-aiming
# continuation ladder (its 50 degree system field lands in the first aiming pass, in
# both packages, so it never reaches the ladder)
LENS_CURVE_SAMPLES, LENS_FULL_FIELD_SAMPLES = 11, 7
LENS_FO_SLOTS = ('efl', 'bfl', 'ep_z', 'xp_z', 'fno')
LENS_FD_STEP = 1e-6
FISHEYE_DEG, FISHEYE_RINGS = 70.0, 8
# phase 3n's float32 bars, against float64 from the same launches: the suggested
# ones, or twice the JAX package's own float32 error on the same path at full size on
# the CPU (probes/lens_cpu_probe.py), rounded up, where that is larger: the
# coefficients 3.3e-2 of max |c| (JAX 1.64e-2: the fit sees the OPD through float32
# sums of 100 mm paths, whose ulp is 7.6e-6 mm), the residual RMS 3.1e-5 mm (1.52e-5;
# float64 5e-8), the OPD 1.3e-6 of its peak (6.1e-7), the PSF through the step's TF32
# plan 5.2e-4 of its peak (2.59e-4 with TF32-rounded MDFT operands: the aberrated PSF's
# peak is low against the field's TF32 rounding), first_order 3.1e-6 (1.53e-6),
# distortion 7.1e-5 percent points, field curvature 9.1e-5 mm, spots 1.4e-5 mm, OPD
# fans 4.6e-2 and the full-field map 1.3e-2 of their peaks, and 10 of the verbs' rays
# that float32 real aiming loses (the JAX package's loses 5); the Seidel sums are host
# float64 in both precisions and both packages, so 0
LENS_F32_BARS = {'landing': 1e-4, 'opl': 1e-5, 'xp_z': 1e-5, 'coefs': 3.3e-2, 'rms': 3.1e-5,
                 'opd': 1.3e-6, 'psf': 2e-5, 'psf_plan': 5.2e-4, 'grads': 1e-3,
                 'first_order': 3.1e-6, 'seidel': 0.0, 'distortion': 7.1e-5,
                 'field_curvature': 9.1e-5, 'spots': 1.4e-5, 'opd_fans': 4.6e-2,
                 'full_field': 1.3e-2, 'lost': 10}
# the f64 sensitivities against central differences: the difference's truncation
# at LENS_FD_STEP (about 1e-7 of the largest, probes/lens_cpu_probe.py), ten times
LENS_FD_BAR = 1e-6
# phase 3o: the lens designer's path (steps.build_lens_design, cfg6 with a neutral
# coordinate break before the rear sphere): the DLS iterates and the Monte Carlo trials
# that the CPU repeats (the card runs steps.DESIGN_SOLVE's 10 and DESIGN_MC_TRIALS' 100;
# one seed gives the CPU the card's first draws); the DLS's central-difference step
DESIGN_CPU_ITERATES, DESIGN_CPU_TRIALS, DESIGN_FD_STEP = 3, 10, 1e-6
# phase 3o's bars, each beside its reason; the float32 ones are the suggested ones or
# twice the JAX package's own float32 error on the same path at full size on the CPU
# (probes/design_cpu_probe.py), rounded up, where that is larger:
# - io: the .zmx and .seq reads and the design system at the written digits trace
#   alike to f64 rounding, 1e-12 mm; io_digits: the writers keep 6 significant digits
#   (format 'g'), which move 1/62 by 3.2e-8 /mm and the edge bundle's landing points by
#   1.3e-5 mm (CPU): 1e-4 mm
# - fd: the 'auto' Jacobian against Richardson-extrapolated central differences, 1e-6
#   of each column's largest (3.1e-7 on the CPU at full size)
# - residuals 1.1e-3 relative (JAX f32 5.4e-4, the port's 1.9e-4); jacobian 1e-3 of
#   each operand's largest entry (JAX 1.56e-4, the port's the same).  Column by column
#   the glass-thickness columns are 6.9x their f64 size off in both packages: their
#   launch tangents central-difference the float32 paraxial recipe at a 1e-6 step
#   (design.Problem._launch_tangent_table), printed, not held
# - iterates 1e-9, card against CPU, f64; efl 1e-9 relative; mc 1e-9 relative
# - wd_fd: the forward-mode wavefront maps against central differences, 1e-4 of each
#   column's largest: the differences' rounding, 1e-14 mm of path over their 2e-6
#   step, is 4.3e-5 of the decentre column (CPU, full size)
# - opd 0.17 um: the f32 pupil-field OPD (JAX f32 8.4e-2 um, the port's 7.0e-2: float32
#   sums of 100 mm paths); psf 0.2 and psf_axis 0.29 of peak (JAX f32 9.97e-2 and
#   0.145, the port's 0.113 and 0.141: the PSF follows the OPD's 0.15 waves; on axis
#   the symmetric sample grid's Delaunay ties add the triangulation's own flips)
# - jones 1e-5, the suggested one (JAX f32 8.5e-7, the port's 8.8e-7)
# - psf_focus 2e-5 of peak, the PSF tier: the f64 pupil fields' samples resampled and
#   focused in f32 against f64, every field (JAX f32 2.6e-6, the port's 2.5e-6)
# - card against CPU in f64, at the CPU parity tests' tier or ten times the JAX package's
#   f64 difference from the port's on the CPU (two implementations' rounding), where
#   larger: opd64 1.8e-9 um (1.7e-10: 100 mm paths); psf64 1.6e-9 of peak off axis,
#   end to end (1.6e-10: the OPD's phase; on axis 8.8e-6, the samples' Delaunay ties,
#   printed, not held); focus64 1e-10 of peak, the CPU's samples focused on the card
#   (9.5e-16); jones64 1e-12 (1.7e-15)
DESIGN_BARS = {'io': 1e-12, 'io_digits': 1e-4, 'fd': 1e-6, 'residuals': 1.1e-3,
               'jacobian': 1e-3, 'iterates': 1e-9, 'efl': 1e-9, 'wd_fd': 1e-4, 'mc': 1e-9,
               'opd': 0.17, 'psf': 0.2, 'psf_axis': 0.29, 'jones': 1e-5, 'psf_focus': 2e-5,
               'opd64': 1.8e-9, 'psf64': 1.6e-9, 'focus64': 1e-10, 'jones64': 1e-12}
# phase 3p: each mesh pattern against its serial counterpart, max |a - b| / max |b|, in
# f32 at 1e-5 and in f64 at 1e-10. The JAX package's dry-run bars (__graft_entry__.py:
# losses and fields 1e-4, gradients 1e-3) allow for 8 devices' reduction orders; at world
# size 1 the sharded and serial paths reassociate only inside autograd and the transforms,
# 2.1e-6 at most in f32 on an H100 (PERF.md), so the f32 bar is five times that
PATTERN_BAR, PATTERN_BAR64 = 1e-5, 1e-10
# phase 4: the patterns' timing runs (the raytrace patterns plan on the host per call)
PATTERN_RUNS = {'raytrace_fit': 4, 'merged_trace': 4}
# phase 3q: the five examples (prysm_tpu_torch.examples) at their default sizes. The marks
# are the f64 ones tests/test_examples.py holds the JAX package's examples to; both
# precisions on the card meet them (1 / suppression against 1 / 50)
EXAMPLE_MARKS = {'lowfs': 0.5, 'suppression': 50.0, 'retrieval': 1e-6, 'efl': 1e-5, 'R': 0.006}
# f64 on the card against the same run on the CPU: the first optimizer iterates (as phase
# 3o holds its DLS) and every compared value, 1e-9 relative
EXAMPLE_ITERATES, EXAMPLE_CARD_CPU_BAR = 3, 1e-9
# the lens's curvature tolerances; its decentre and tilt ones come from the boresight head at
# the on-axis field, whose gradient the centroid's rounding sets (ROADMAP watch-list)
EXAMPLE_CURVATURES = slice(0, 3)
# the JAX package's own f32 figure of each example at its default size on the CPU, against
# its f64 run (probes/examples_cpu_probe.py; the names say what, example_figures how)
EXAMPLE_JAX_F32 = {'lowfs_error': 0.254, 'lowfs_R': 1.58e-06, 'lowfs_I0': 7.49e-07,
                   'dark_e0': 1.88e-07, 'dark_g0': 1.09e-06, 'dark_suppression': 2.04e-06,
                   'retrieval_error': 0.0, 'lens_m0': 7.34e-05, 'lens_efl': 4.92e-09,
                   'lens_tol': 0.00399, 'coating_R0': 1.97e-07, 'coating_merit': 4.34e-07}
# phase 3q's f32 bars, as phase 3n's: the suggested tier of the quantity's kind, or twice the
# JAX package's figure where that is larger.  The tiers: the gradient tier 1e-3
# (tests/test_f32_tier.py:65-99) for the LOWFS reconstructor (the Jacobian's pseudo-inverse)
# and the dark hole's gradient; the PSF tier 2e-5 of peak (:47-62) for the LOWFS frame; the
# Babinet tier 1e-4 (:140-171) for the dark energy and the suppression (sums of a Babinet
# frame's intensities); the retrieval's f64 mark (the JAX f32 run recovers its float32 truth
# exactly, a figure of 0); phase 3o's f32 residual bar for the lens's start merit (1.1e-3);
# phase 3j's start-merit bar for the coating's reflectance and merit (2.6e-6).  The worst
# LOWFS error, the solved EFL and the lens's tolerances have no tier: twice the JAX figure
EXAMPLE_FLOORS = {'lowfs_R': 1e-3, 'lowfs_I0': 2e-5, 'dark_e0': 1e-4, 'dark_g0': 1e-3,
                  'dark_suppression': 1e-4, 'retrieval_error': 1e-6, 'lens_m0': 1.1e-3,
                  'coating_R0': 2.6e-6, 'coating_merit': 2.6e-6}
EXAMPLE_BARS = {k: max(2 * v, EXAMPLE_FLOORS.get(k, 0.0)) for k, v in EXAMPLE_JAX_F32.items()}
# phase 3r: the card tier, tests/test_torch_chip_*.py (the 7 files of tests_tpu/, 43
# functions, 55 cases), run by pytest on the card within this many seconds
TIER_FILES, TIER_MIN_CASES, TIER_TIMEOUT_S = 7, 55, 600
# phase 3s: the port's executed docs (prysm_tpu_torch.docs: docs/torch/, block by block) on
# the card in f32 and in f64.  f64 on the card against the same docs on the CPU (the spawn
# worker's f64 run, whose random draws the card's runs replay), each result at
# EXAMPLE_CARD_CPU_BAR but where DOC_CARD_CPU_BARS says otherwise and why
DOC_CARD_CPU_BARS = {
    ('college/102-precision-and-dispatch.md', 'W'):
        (1e-6, "the Zernike kernel computes in f32 on the card, the CPU's plain version in "
               'f64: the synthesis tier (tests/test_f32_tier.py:102-114)'),
}
# f32 against f64 on the card, max |f32 - f64| / max |f64|: the tier of each result's kind
# (docs.RESULTS), tests/test_f32_tier.py's where it has one: the PSF 2e-5 of peak (:47-62),
# the MTF 1e-5 (:59), the MDFT gradient 1e-3 (:65-99), the Zernike synthesis 1e-6
# (:102-114), the Babinet frame 1e-4 (:140-171), the traced OPL 1e-5 (:236), the
# interferogram statistics 1e-5 (:254); optimizer results ('design') the gradient tier
# 1e-3, least-squares fits and fiber modes the Zernike tier's ten times, 1e-5.  Where the
# JAX package's own f32 error of the result on the CPU is larger, twice that
# (DOCS_JAX_F32).  Frames ('noise') are draws: held by their mean (2e-3) and spread (5%)
DOC_TIERS = {'psf': 2e-5, 'mtf': 1e-5, 'grad': 1e-3, 'zernike': 1e-6, 'babinet': 1e-4,
             'ray': 1e-5, 'stats': 1e-5, 'design': 1e-3, 'fit': 1e-5, 'fiber': 1e-5}
# the JAX package's own f32 error of each doc result on the CPU, against its x64 run with
# the same draws, where twice it exceeds the tier ('doc::result'; probes/docs_cpu_probe.py:
# the mask edges' antialiasing ramps, the FWHM's threshold crossing, the ray OPD's sums of
# 100 mm paths, the optimizers' trajectories; the rest lie under half their tiers)
DOCS_JAX_F32 = {
    'college/101-how-prysm-tpu-works.md::amp': 1.22e-05,
    'college/104-richdata-and-io.md::v': 6.7e-07,
    'college/201-zernikes-on-a-circle.md::z22': 6.49e-07,
    'college/202-other-bases-and-derivatives.md::P': 7.54e-07,
    'college/202-other-bases-and-derivatives.md::T': 1.89e-06,
    'college/202-other-bases-and-derivatives.md::q2d': 6.6e-07,
    'college/202-other-bases-and-derivatives.md::q3': 5.26e-07,
    'college/202-other-bases-and-derivatives.md::qc': 2.94e-06,
    'college/204-forbes-q-and-clenshaw.md::dzdr': 5.74e-07,
    'college/204-forbes-q-and-clenshaw.md::dzdt': 7.46e-07,
    'college/204-forbes-q-and-clenshaw.md::z': 6.65e-07,
    'explanation/deformable-mirrors.md::sfe': 2.08e-05,
    'explanation/ins-and-outs-of-polynomials.md::T': 9.66e-07,
    'explanation/segmented-systems.md::opd': 8.9e-06,
    'how-tos/optimization.md::fk': 0.207,
    'how-tos/polychromatic.md::amp': 1.52e-05,
    'how-tos/telescope-apertures.md::hst': 3.82e-05,
    'how-tos/telescope-apertures.md::luvoir': 2.24e-05,
    'how-tos/telescope-apertures.md::opd': 4.33e-06,
    'tutorials/01-first-psf.md::amp': 2.82e-05,
    'tutorials/01-first-psf.md::w': 0.00563,
    'tutorials/03-raytracing.md::opd': 0.000109,
    'tutorials/03-raytracing.md::res.x': 0.00161,
    'tutorials/03-raytracing.md::sens.jacobian': 0.0098,
}
DOC_NOISE_MEAN, DOC_NOISE_SPREAD = 2e-3, 0.05
# each doc of the phase in which a hand-written kernel must launch, on the card in both
# precisions: the kernel lesson's synthesis and frame, the image-simulation tutorial's
# exposures (expose_fused, and 'auto' on its photon-rich f32 scene)
DOC_KERNELS = {'college/102-precision-and-dispatch.md': ('zernike_fwd', 'noise_expose'),
               'tutorials/05-image-simulation.md': ('noise_expose',)}


def doc_f32_bar(doc, name):
    """Phase 3s's f32 bar of one doc result: its kind's tier, or twice the JAX package's
    f32 error where that is larger."""
    from prysm_tpu_torch.docs import RESULTS
    return max(DOC_TIERS[RESULTS[doc][name]], 2 * DOCS_JAX_F32.get(f'{doc}::{name}', 0.0))


# cfg5's detector (bench.py cfg5)
DET5 = dict(dark_current=2.0, read_noise=5.0, bias=100.0, fwc=60e3, conversion_gain=0.5,
            bits=14, exposure_time=1e-2)


def kall_fp32_ops(nms):
    """fp32 operations per pixel that zernike_bwd_all's 32-slot launches take for nms's plan."""
    from prysm_tpu_torch.ops import zernike as zk
    prog = zk._program(zk._plan(nms, True))
    require(zk._bucket(len(prog), zk._buckets()) == zk._buckets()[-1],
            f'{len(nms)} modes do not run on the 32-slot kernel')
    ops = 0
    for i, piece in enumerate(zk._chunks(prog, zk._buckets()[-1])):
        ops += sum(KALL32_FP32_OPS[event] * n for event, n in (
            ('launch', 1), ('slot', len(piece.slots)),
            # a fold at each group start after the first slot (the last is in 'launch')
            ('fold', sum(1 for s in piece.slots[1:] if s[0] & (zk._TURN | zk._RESET))),
            ('turn', sum(1 for s in piece.slots if s[0] & zk._TURN)),
            ('restart', sum(1 for s in piece.slots if s[0] & zk._RESET)),
            ('pre_turn', piece.turns), ('pre_step', len(piece.rows)), ('add', i > 0)))
    return ops


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    from prysm_tpu_torch.examples import card_name
    return card_name(torch.device('cuda', 0))


def rel(a, b):
    """max |a - b| / max |b|, in float64 (complex128 for complex inputs)."""
    wide = torch.complex128 if a.is_complex() or b.is_complex() else torch.float64
    a, b = a.detach().to(wide), b.detach().to(wide)
    return float((a - b).abs().max() / b.abs().max())


def per_mode_rel(a, b, scale):
    """max_k |a_k - b_k| / max(|b_k|, scale_k): each mode against its own size."""
    a, b = a.detach().double(), b.detach().double()
    return float(((a - b).abs() / torch.maximum(b.abs(), scale)).max())


def require(ok, what):
    if not ok:
        raise AssertionError(what)


def run_checks(checks, width=52):
    """Print and require each (what, error, bar)."""
    for what, err, bar in checks:
        print(f'  {what:{width}s} {err:.3e} (bar {bar:g})', flush=True)
        require(math.isfinite(err) and err <= bar, f'{what}: {err} exceeds {bar}')


def synced(fn):
    out = fn()
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def misaligned(a, k):
    """A copy of ``a`` in a contiguous view k floats past a 16-byte boundary."""
    buf = torch.empty(a.numel() + k, dtype=a.dtype, device=a.device)
    view = buf[k:].view(a.shape)
    view.copy_(a)
    return view


def zernike_grids(dev):
    """(what, r, t, g): 1024^2, an odd 1023^2, 1024^2 in views off 16-byte boundaries,
    and 1024^2 with t scaled past 105615, where sincosf leaves its fast path."""
    from prysm_tpu_torch.coordinates import make_xy_grid, cart_to_polar
    gen = torch.Generator().manual_seed(SEED)
    grids = []
    for n in (N, N - 1):
        r, t = cart_to_polar(*make_xy_grid(n, diameter=2.2, device=dev))
        grids.append((f'{n}^2', r, t, torch.randn(n, n, generator=gen).to(dev)))
    _, r, t, g = grids[0]
    grids.append((f'{N}^2 r, t, g +4 B', misaligned(r, 1), misaligned(t, 1), misaligned(g, 1)))
    grids.append((f'{N}^2 r, t, g +4/+8/+12 B', misaligned(r, 1), misaligned(t, 2),
                  misaligned(g, 3)))
    grids.append((f'{N}^2 t x 40000', r, t * 40000, g))
    return grids


def kernels_per_call(fn, tries=5):
    """Names of the device kernels one fn() call runs (torch.profiler), after a warm call.

    Every call launches at least one kernel, so a trace with none lost its
    device records (the card's profiler does so at times, more than once in
    a row) and is taken again, a little later each time, up to ``tries``
    times; [] if every trace came back empty.
    """
    synced(fn)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            synced(fn)
        events = prof.events()
        # the device's side of a user annotation (a program span) is no operation
        spans = {e.name for e in events if getattr(e, 'is_user_annotation', False)}
        names = [e.name for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in spans]
        if names:
            break
        time.sleep(0.25 * (attempt + 1))
    return names


# CUgraphNodeType (cuda.h)
GRAPH_NODE_KINDS = {0: 'kernel', 1: 'memcpy', 2: 'memset', 3: 'host', 4: 'graph', 5: 'empty',
                    6: 'wait event', 7: 'event record', 8: 'semaphore signal',
                    9: 'semaphore wait', 10: 'mem alloc', 11: 'mem free', 12: 'batch mem op',
                    13: 'conditional'}


def device_ops_per_call(fn, dev):
    """The kinds of the device operations one fn() call enqueues, from the nodes of a
    CUDA graph captured from it (the driver API's cuGraphGetNodes), with no profiler.

    fn runs once on the default stream and once on the capture stream first,
    so that its caches and per-stream state (the Zernike reduction ticket)
    are made outside the capture (``steps._StepGraph`` builds the control
    step's graph in the same order). The graph is never replayed.
    """
    import ctypes
    synced(fn)
    stream = torch.cuda.Stream(dev)
    with torch.cuda.stream(stream):
        synced(fn)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    cuda = ctypes.CDLL('libcuda.so.1')
    handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    require(cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0,
            'cuGraphGetNodes failed to count the nodes')
    nodes = (ctypes.c_void_p * count.value)()
    require(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0,
            'cuGraphGetNodes failed to list the nodes')
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        require(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
                'cuGraphNodeGetType failed')
        kinds.append(GRAPH_NODE_KINDS.get(kind.value, str(kind.value)))
    del graph
    torch.cuda.synchronize()
    return [k for k in kinds if k != 'empty']


def phase_kernels(dev):
    from prysm_tpu_torch.ops import zernike as zk
    from prysm_tpu_torch.polynomials import zernike_nm_seq
    from prysm_tpu_torch.steps import NMS6, WFC_NMS

    gen = torch.Generator().manual_seed(SEED + 2)
    worst = {k: 0.0 for k in KERNEL_ROWS}
    buckets = zk._buckets()
    print(f'  compiled program sizes: {buckets}', flush=True)
    pieces = {}
    for nms, want, n_pieces in ((NMS6, buckets[0], 1), (NMS45, buckets[-1], 1),
                                (WFC_NMS, buckets[-1], 1), (NMS66, buckets[-1], 2),
                                (RADIAL34, buckets[-1], 2)):
        plan = zk._plan(nms, True)
        kmax = zk._bucket(len(zk._program(plan)), buckets)
        blobs, rows = zk._params(plan, kmax)
        pieces[nms] = len(blobs)
        require(kmax == want and len(blobs) == n_pieces,
                f'{len(nms)} modes took {len(blobs)} launches of the {kmax}-slot kernels, '
                f'not {n_pieces} of the {want}-slot ones')
        print(f'  {len(nms)} modes: {len(zk._program(plan))} slots, {len(blobs)} launches of '
              f'the {kmax}-slot kernels, {len(blobs[0])} bytes of parameters each, '
              f'{len(rows)} prologue rows', flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, mode in zk._MODES.items():
        print(f'  {name}: resident blocks of {zk._lib().prysm_zernike_block_threads()} per SM, '
              + ', '.join(f'{k}-slot {zk._resident_blocks(dev.index, mode, k) // sms}'
                          for k in buckets), flush=True)
    for what, r, t, g in zernike_grids(dev):
        head, quads, tail = zk._span(r.data_ptr(), r.numel())
        print(f'  grid {what}: head {head}, quads {quads}, tail {tail}', flush=True)
        for nms in pieces:
            for norm in (True, False):
                plan = zk._plan(nms, norm)
                c = torch.randn(len(nms), generator=gen).to(dev)
                # a mode's cotangent <w_k Z_k, g> has the size of the root sum of
                # squares of its terms; the high orders outside r=1 are far larger
                # than the low ones, so each mode is also held to its own size
                modes = zernike_nm_seq(nms, r.double(), t.double(), norm=norm)
                scale = torch.sqrt(torch.sum((modes * g.double()) ** 2, dim=(-2, -1)))
                del modes
                cases = {
                    'zernike_fwd': ([zk._launch_fwd(plan, c, r, t)],
                                    [zk.zernike_fwd_plain(plan, c, r, t)], 1e-5),
                    'zernike_bwd_coefs': ([zk._launch_bwd_coefs(plan, r, t, g)],
                                          [zk.zernike_bwd_coefs_plain(plan, r, t, g)], 1e-4),
                    'zernike_bwd_all': (zk._launch_bwd_all(plan, c, r, t, g),
                                        zk.zernike_bwd_all_plain(plan, c, r, t, g), 1e-4),
                }
                torch.cuda.synchronize()
                for name, (outs, refs, bar) in cases.items():
                    errs = [rel(o, p) for o, p in zip(outs, refs)]
                    if name != 'zernike_fwd':  # outs[0] is the (K,) coefficient cotangent
                        errs.append(per_mode_rel(outs[0], refs[0], scale))
                    if nms == NMS6:  # the main path's plan: the kernels line's max |diff|
                        worst[name] = max(worst[name], *(float((o - p).abs().max())
                                                         for o, p in zip(outs, refs)))
                    print(f'  {name:18s} K={len(nms):2d} norm={norm!s:5s} '
                          f'max rel err {max(errs):.3e} (bar {bar:g})', flush=True)
                    require(max(errs) <= bar, f'{name} disagrees with its plain version '
                                              f'on {what}')
                again = synced(lambda: zk._launch_bwd_coefs(plan, r, t, g))
                require(torch.equal(again, cases['zernike_bwd_coefs'][0][0]),
                        f'zernike_bwd_coefs is not bit-identical from run to run on {what}')
                again = synced(lambda: zk._launch_bwd_all(plan, c, r, t, g))
                require(torch.equal(again[0], cases['zernike_bwd_all'][0][0]),
                        f'zernike_bwd_all is not bit-identical from run to run on {what}')
    # one launch per call (per piece): no second reduction kernel, no fill;
    # counted from a captured CUDA graph, and from the profiler's trace
    # where the profiler recorded one
    _, r, t, g = zernike_grids(dev)[0]
    for nms in (NMS6, NMS66):
        plan, c = zk._plan(nms, True), torch.randn(len(nms), generator=gen).to(dev)
        for name, fn in (('zernike_fwd', lambda: zk._launch_fwd(plan, c, r, t)),
                         ('zernike_bwd_coefs', lambda: zk._launch_bwd_coefs(plan, r, t, g)),
                         ('zernike_bwd_all', lambda: zk._launch_bwd_all(plan, c, r, t, g))):
            ops = device_ops_per_call(fn, dev)
            names = kernels_per_call(fn)
            print(f'  {name} K={len(nms)}: device operations per call (graph) {ops}; '
                  f'device kernels per call (profiler) '
                  f'{names or "not measured: every trace came back empty"}', flush=True)
            require(ops == ['kernel'] * pieces[nms],
                    f'{name} enqueued {ops} per call for {len(nms)} modes, not '
                    f'{pieces[nms]} kernel(s)')
            require(not names or len(names) == pieces[nms],
                    f'{name} ran {len(names)} device kernels per call for {len(nms)} modes '
                    f'in the profiler\'s trace, not {pieces[nms]}')
    return worst, pieces


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def shifted_grid(dtype, dev):
    """A 1024^2 grid and a sub-pixel pupil decentre (x, y) in its units."""
    from prysm_tpu_torch.coordinates import make_xy_grid
    x, y = make_xy_grid(N, diameter=2.2, dtype=dtype, device=dev)
    shift = torch.tensor([0.37, -0.21], dtype=dtype, device=dev) * (2.2 / N)
    return x, y, shift


def zernike_fit_loss(synth, x, y, shift, coefs, amp):
    """L2 misfit of a decentred Zernike OPD against the centred one at half the coefficients."""
    opd = synth(coefs, x - shift[0], y - shift[1])
    with torch.no_grad():
        target = synth(coefs.detach() * 0.5, x, y)
    return torch.sum(amp * (opd - target) ** 2)


def references(dev):
    """The main path's results in f64 on the card, through the plain mode stack."""
    from prysm_tpu_torch.coordinates import cart_to_polar
    from prysm_tpu_torch.polynomials import zernike_nm_seq, sum_of_2d_modes
    from prysm_tpu_torch.steps import (NMS6, entry, make_pupil, make_cfg2_plan,
                                       build_cfg1_step, build_cfg2_step)

    f64 = torch.float64
    p64 = make_pupil(N, dtype=f64, device=dev)
    ref = {}
    ref['cfg2_loss'], ref['cfg2_grad'] = build_cfg2_step(
        p64, make_cfg2_plan(p64, FN, matmul_precision=None), fused=False)(p64.coefs)
    forward, args = entry(N, dtype=f64, device=dev)
    ref['psf'], ref['mtf'] = forward(*args)
    ref['cfg1_loss'], ref['cfg1_grad'], _ = build_cfg1_step(p64)(p64.coefs)

    def stack_synth(c, x, y):
        r, t = cart_to_polar(x, y)
        return sum_of_2d_modes(zernike_nm_seq(NMS6, r, t), c)

    x, y, shift = shifted_grid(f64, dev)
    shift.requires_grad_(True)
    coefs = p64.coefs.clone().requires_grad_(True)
    zernike_fit_loss(stack_synth, x, y, shift, coefs, p64.amp).backward()
    ref['fit_grad_coefs'], ref['fit_grad_shift'] = coefs.grad, shift.grad
    torch.cuda.synchronize()
    return ref


def drive_main_path(dev):
    """Run the port's main path in f32 through its entry points; return its outputs."""
    from prysm_tpu_torch.ops.zernike import LAUNCHES
    from prysm_tpu_torch.polynomials import zernike_sum
    from prysm_tpu_torch.steps import (NMS6, entry, make_pupil, make_cfg2_plan,
                                       build_cfg1_step, build_cfg2_step)

    out = {'per_step': []}
    pupil = make_pupil(N, device=dev)
    cfg2 = build_cfg2_step(pupil, make_cfg2_plan(pupil, FN, matmul_precision='high'))
    c = pupil.coefs
    for i in range(STEPS):
        before = dict(LAUNCHES)
        loss, grad = synced(lambda: cfg2(c))
        out['per_step'].append({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
        require(bool(torch.isfinite(loss)) and bool(torch.isfinite(grad).all()),
                f'cfg2 step {i}: loss or gradient is not finite')
        if i == 0:
            out['cfg2_loss'], out['cfg2_grad'] = loss, grad
        c = c - 1e-12 * grad

    forward, args = entry(N, device=dev)
    out['psf'], out['mtf'] = synced(lambda: forward(*args))
    cfg1 = build_cfg1_step(make_pupil(N, device=dev))
    c = pupil.coefs
    for i in range(STEPS):
        loss, grad, mtf = synced(lambda: cfg1(c))
        require(bool(torch.isfinite(loss)) and bool(torch.isfinite(grad).all())
                and bool(torch.isfinite(mtf).all()),
                f'cfg1 step {i}: loss, gradient or MTF is not finite')
        if i == 0:
            out['cfg1_loss'], out['cfg1_grad'] = loss, grad
        c = c - 1e-12 * grad

    x, y, shift = shifted_grid(torch.float32, dev)
    shift.requires_grad_(True)
    coefs = pupil.coefs.clone().requires_grad_(True)
    zernike_fit_loss(lambda c, x, y: zernike_sum(c, NMS6, x, y), x, y, shift, coefs,
                     pupil.amp).backward()
    torch.cuda.synchronize()
    out['fit_grad_coefs'], out['fit_grad_shift'] = coefs.grad, shift.grad
    return out


def check_main_path(out, ref, launches):
    print(f'  launches on the main path: {json.dumps(launches)}')
    print(f'  launches per cfg2 step: {json.dumps(out["per_step"])}')
    for name, n in launches.items():
        require(n > 0, f'{name} was not launched on the main path')
    for i, d in enumerate(out['per_step']):
        require(d == {'zernike_fwd': 1, 'zernike_bwd_coefs': 1, 'zernike_bwd_all': 0},
                f'cfg2 step {i} launched {d}, not one forward and one coefs backward')
    checks = [
        # (what, error, bar): f32 against f64, at the tiers of tests/test_f32_tier.py
        ('cfg2 gradient (rel, TF32 MDFT)', rel(out['cfg2_grad'], ref['cfg2_grad']), 1e-3),
        ('cfg2 loss (rel)', rel(out['cfg2_loss'], ref['cfg2_loss']), 1e-3),
        ('entry PSF (peak rel)', rel(out['psf'], ref['psf']), 2e-5),
        ('entry MTF (abs)', float((out['mtf'].double() - ref['mtf']).abs().max()), 1e-5),
        # the centre is x / x, so exactly 1 (tests/test_f32_tier.py)
        ('entry MTF centre - 1', abs(float(out['mtf'][N, N]) - 1.0), 0.0),
        ('cfg1 gradient (rel)', rel(out['cfg1_grad'], ref['cfg1_grad']), 1e-3),
        ('cfg1 loss (rel)', rel(out['cfg1_loss'], ref['cfg1_loss']), 1e-3),
        ('zernike_sum coefficient gradient (rel)',
         rel(out['fit_grad_coefs'], ref['fit_grad_coefs']), 1e-3),
        ('zernike_sum decentre gradient (rel)',
         rel(out['fit_grad_shift'], ref['fit_grad_shift']), 1e-3),
    ]
    run_checks(checks, width=40)


def noise_args(det):
    return (det.read_noise, det.bias, det.fwc, det.conversion_gain, det.bits)


def noise_agreement(out, ref, gain, what):
    """The kernel's DN against the plain version's: equal to 1e-5 relative but for ties.

    Both draw the same Philox uniforms; logf, sincosf and sqrtf may differ
    by an ulp between the kernel and torch's own kernels, which can flip a
    rounding tie of the shot count (1/gain DN) on a rare pixel.
    """
    diff = (out.double() - ref.double()).abs()
    off = diff > 1e-5 * ref.double().abs()
    share, worst = float(off.double().mean()), float(diff.max())
    print(f'  noise_expose {what}: share of pixels off by > 1e-5 rel {share:.3e} '
          f'(bar 1e-4), max |diff| {worst:.4g} DN (bar {1 / gain + 1e-3:g})', flush=True)
    require(share <= 1e-4, f'noise_expose {what}: {share} of pixels disagree')
    require(worst <= 1 / gain + 1e-3, f'noise_expose {what}: a pixel is off by {worst} DN')
    return worst


def phase_noise(dev, frame5):
    """The noise kernel against its plain version, its fixed cases and its moments."""
    from prysm_tpu_torch.detector import Detector
    from prysm_tpu_torch.ops import noise

    det = frame5.detector
    lam5 = det._mean_electrons(frame5.mosaic())
    gain = det.conversion_gain
    worst = noise_agreement(synced(lambda: noise._launch(lam5, 1, 0, *noise_args(det))),
                            noise.expose_plain(lam5, 1, 0, *noise_args(det)), gain,
                            f'cfg5 map {tuple(lam5.shape)} x 1')
    # the timed 16-frame stack; a map whose pixel count is odd (a lone last
    # pair) and not a multiple of 4 (frames off 16-byte boundaries, scalar
    # stores), in 5 frames (a last frame block of one), with zero-signal
    # pixels; and the cfg5 map in a view one float past a 16-byte boundary
    gen = torch.Generator().manual_seed(SEED + 3)
    odd = 5e4 * torch.rand(41, 53, generator=gen)
    odd.view(-1)[::7] = 0.0
    for what, lam, frames in (('cfg5 map x 16', lam5, 16), ('41x53 x 5', odd.to(dev), 5),
                              ('cfg5 map +4 B x 3', misaligned(lam5, 1), 3)):
        worst = max(worst, noise_agreement(
            synced(lambda: noise._launch(lam, frames, 0, *noise_args(det))),
            noise.expose_plain(lam, frames, 0, *noise_args(det)), gain, what))
    flat = torch.full((256, 256), 1000.0, device=dev)
    out = synced(lambda: noise._launch(flat, 4, 123, *noise_args(det)))
    worst = max(worst, noise_agreement(out, noise.expose_plain(flat, 4, 123, *noise_args(det)),
                                       gain, '256^2 at 1000 e- x 4'))
    require(torch.equal(out, synced(lambda: noise._launch(flat, 4, 123, *noise_args(det)))),
            'noise_expose: the same seed gave another frame')
    require(not torch.equal(out, synced(lambda: noise._launch(flat, 4, 124, *noise_args(det)))),
            'noise_expose: a new seed gave the same frame')
    o = out.double()
    mean, std = float(o.mean()), float(o.std(correction=0))
    want_mean, want_std = (1000.0 + det.bias) / gain, math.sqrt(1000.0 + det.read_noise ** 2) / gain
    print(f'  noise_expose 256^2 x 4 at 1000 e-: mean {mean:.3f} (want {want_mean:g} +- 2%), '
          f'std {std:.4f} (want {want_std:.4f} +- 10%)', flush=True)
    require(abs(mean - want_mean) <= 0.02 * want_mean and abs(std - want_std) <= 0.1 * want_std,
            'noise_expose: 256^2 moments off')

    zero = Detector(dark_current=0.0, read_noise=0.0, bias=150.0, fwc=120.0,
                    conversion_gain=0.5, bits=8, exposure_time=1.0)
    dn = synced(lambda: zero.expose_fused(torch.zeros(40, 52, device=dev), seed=3))
    print(f'  noise_expose zero signal 40x52: {dn.dtype}, values {torch.unique(dn).tolist()} '
          '(want uint8, [240])', flush=True)
    require(dn.dtype == torch.uint8 and dn.shape == (40, 52) and bool((dn == 240).all()),
            'noise_expose: the zero-signal frame is not 240 DN everywhere')

    rich = Detector(dark_current=10.0, read_noise=5.0, bias=200.0, fwc=90000.0,
                    conversion_gain=1.0, bits=16, exposure_time=1.0)
    o = synced(lambda: rich.expose_fused(torch.full((64, 64), 2000.0, device=dev), frames=24,
                                         seed=7)).double()
    mean, var = float(o.mean()), float(o.var(correction=0))
    want_mean, want_var = 2000.0 + 10.0 + 200.0, 2010.0 + 25.0
    print(f'  noise_expose 64^2 x 24 at 2000 e-: mean {mean:.3f} (want {want_mean:g} +- 1%), '
          f'var {var:.2f} (want {want_var:g} +- 5%)', flush=True)
    require(abs(mean - want_mean) <= 0.01 * want_mean and abs(var - want_var) <= 0.05 * want_var,
            'noise_expose: 64^2 moments off')
    return worst


def drive_cfg5(frame5):
    """The cfg5 frame for each seed through its entry point; launches per frame."""
    from prysm_tpu_torch.ops.noise import LAUNCHES
    frames, per_frame = [], []
    for seed in SEEDS5:
        before = LAUNCHES['noise_expose']
        frames.append(synced(lambda: frame5(seed)))
        per_frame.append(LAUNCHES['noise_expose'] - before)
    return frames, per_frame


def residual_stats(lam, dn, det):
    """Mean and variance of (DN gain - bias - lam) / sqrt(lam + read_noise^2), and the count.

    Over pixels with lam >= 100 where neither clip can be reached within
    five standard deviations: full well, and the ADC cap.
    """
    lam, dn = lam.double(), dn.double()
    top = det.bias + lam + 5 * torch.sqrt(lam)
    ok = (lam >= 100) & (top < det.fwc) & (top / det.conversion_gain < 2 ** det.bits - 1)
    r = ((dn * det.conversion_gain - det.bias - lam)
         / torch.sqrt(lam + det.read_noise ** 2))[..., ok]
    return float(r.mean()), float(r.var()), r.numel()


def check_cfg5(frames, per_frame, frame5, dev):
    from prysm_tpu_torch.bayer import demosaic_malvar
    from prysm_tpu_torch.ops import noise
    from prysm_tpu_torch.steps import build_cfg5_frame

    print(f'  noise_expose launches per cfg5 frame: {per_frame}')
    require(per_frame == [1] * len(SEEDS5), f'cfg5 frames launched {per_frame}, not 1 each')
    for f in frames:
        require(f.shape == (N5, N5, 3) and f.dtype == torch.float32
                and bool(torch.isfinite(f).all()), 'a cfg5 frame is not finite (512, 512, 3) f32')
    require(not torch.equal(frames[0], frames[1]), 'cfg5 frames of two seeds are equal')

    f64 = build_cfg5_frame(N5, dtype=torch.float64, device=dev)
    planes, planes64 = frame5.focal_planes(), f64.focal_planes()
    mosaic, mosaic64 = frame5.mosaic(planes), f64.mosaic(planes64)
    det = frame5.detector
    dn = det.expose(mosaic, seed=0, method='fused')
    checks = [
        # (what, error, bar): the Babinet tier of tests/test_f32_tier.py
        ('cfg5 focal intensities (peak rel)', rel(planes, planes64), 1e-4),
        ('cfg5 mosaic (peak rel)', rel(mosaic, mosaic64), 1e-4),
        ('cfg5 demosaic f32 vs f64 of one DN frame (rel)',
         rel(demosaic_malvar(dn.to(torch.float32)), demosaic_malvar(dn.to(torch.float64))), 1e-6),
        ('cfg5 frame of seed 0 vs the demosaic of its DN (rel)',
         rel(frames[0], demosaic_malvar(dn.to(torch.float32))), 1e-6),
    ]
    lam = det._mean_electrons(mosaic)
    raw = torch.cat([noise._launch(lam, 1, seed, *noise_args(det))[0] for seed in SEEDS5])
    mean, var, n = residual_stats(lam.expand(len(SEEDS5), -1, -1).reshape(raw.shape), raw, det)
    print(f'  cfg5 mean electrons: share < 20 e- {float((lam < 20).double().mean()):.4f}, '
          f'share > full well {float((lam > det.fwc).double().mean()):.4f}, '
          f'min {float(lam.min()):.4g}, max {float(lam.max()):.4g}')
    checks += [(f'cfg5 exposure residual mean ({n} px, {len(SEEDS5)} seeds)', abs(mean), 0.02),
               ('cfg5 exposure residual variance - 1', abs(var - 1), 0.03)]
    run_checks(checks)


def no_kernel_launches(what):
    """The launch counts since the last reset, all of which must be 0."""
    counts = launch_counts()
    print(f'  launches on the {what} path (no hand-written kernel): {json.dumps(counts)}')
    require(not any(counts.values()), f'the {what} path launched a kernel: {counts}')


def phase_cfg3(dev, step3):
    """cfg3 in f32 through its entry point for STEPS steps, against f64 on the card."""
    from prysm_tpu_torch.coordinates import make_xy_grid
    from prysm_tpu_torch.geometry import antialias, circle_sdf
    from prysm_tpu_torch.otf import (encircled_energy,
                                     analytical_encircled_energy_circular_aperture)
    from prysm_tpu_torch.propagation import Wavefront, pupil_sample_to_psf_sample
    from prysm_tpu_torch.steps import build_cfg3_step

    c = step3.coefs
    for i in range(STEPS):
        ee, psf, grad = synced(lambda: step3(c))
        require(bool(torch.isfinite(ee)) and bool(torch.isfinite(grad).all())
                and bool(torch.isfinite(psf).all()),
                f'cfg3 step {i}: the energy, PSF or gradient is not finite')
        if i == 0:
            first = ee, psf, grad
        c = c + 1e-3 * grad
    no_kernel_launches('cfg3')
    require(first[1].shape == (2 * N3, 2 * N3) and first[2].shape == (19, 3),
            f'cfg3: PSF {tuple(first[1].shape)}, gradient {tuple(first[2].shape)}')
    step64 = build_cfg3_step(N3, dtype=torch.float64, device=dev)
    ee64, psf64, grad64 = synced(lambda: step64(step64.coefs))
    print(f'  cfg3: {len(step3.aperture.segment_ids)} segments, EE(10 um) {float(first[0]):.6f} '
          f'(f64 {float(ee64):.6f}), |dEE/dc| max {float(grad64.abs().max()):.4e} per nm')

    # the encircled energy of an unsegmented circular pupil against the analytic
    # curve (the on-chip physics check of the JAX package): EE(4, 8 um) / EE(60 um)
    n, efl, epd, wvl, Q = 256, 10.0, 1.0, 0.5, 3
    x, y = make_xy_grid(n, diameter=epd * 1.1, device=dev)
    dx = epd * 1.1 / n
    amp = antialias(circle_sdf(epd / 2, torch.hypot(x, y)), dx)
    I = synced(lambda: Wavefront.from_amp_and_phase(amp, None, wvl, dx).focus(efl, Q=Q)
               .intensity.data)
    pdx = pupil_sample_to_psf_sample(dx, n * Q, wvl, efl)
    pts = (4.0, 8.0)
    numeric = encircled_energy(I, pdx, pts).double() / float(encircled_energy(I, pdx, 60.0))
    analytic = analytical_encircled_energy_circular_aperture(
        efl / epd, wvl, torch.tensor(pts, dtype=torch.float64, device=dev))
    run_checks([
        ('cfg3 PSF (peak rel)', rel(first[1], psf64), 2e-5),
        ('cfg3 encircled energy (rel)', rel(first[0], ee64), 1e-4),
        ('cfg3 energy gradient (rel)', rel(first[2], grad64), 1e-3),
        ('circular pupil EE(4, 8 um) / EE(60) vs analytic (rel)',
         float(((numeric - analytic) / analytic).abs().max()), 2e-2),
    ])


def phase_cfg4(dev, chain4):
    """cfg4 in f32 through its entry point, against f64 on the card; a +z / -z round trip."""
    from prysm_tpu_torch.fttools import crop_center
    from prysm_tpu_torch.propagation import angular_spectrum
    from prysm_tpu_torch.steps import build_cfg4_chain, CFG4_Z1

    I = synced(chain4)
    no_kernel_launches('cfg4')
    require(I.shape == (N4, N4) and I.dtype == torch.float32 and bool(torch.isfinite(I).all()),
            'the cfg4 intensity is not a finite (1024, 1024) f32 map')
    chain64 = build_cfg4_chain(N4, dtype=torch.float64, device=dev)
    I64 = synced(chain64)
    E = chain4.amp.to(torch.complex64)
    there = angular_spectrum(E, 0.55, chain4.dx, CFG4_Z1, Q=2)
    back = crop_center(angular_spectrum(there, 0.55, chain4.dx, -CFG4_Z1, Q=1), (N4, N4))
    phase_err = lambda a, b: float(torch.angle(a.to(b.dtype) * b.conj()).abs().max())  # noqa: E731
    print(f'  cfg4: phase error of the f32 plan tensors vs f64: lens '
          f'{phase_err(chain4.lens, chain64.lens):.3e} rad, tf1 '
          f'{phase_err(chain4.tf1, chain64.tf1):.3e} rad, tf2 '
          f'{phase_err(chain4.tf2, chain64.tf2):.3e} rad')
    run_checks([
        ('cfg4 intensity (peak rel)', rel(I, I64), 1e-3),
        ('angular spectrum +z / -z round trip (peak rel)', rel(back, E), 1e-3),
    ])


def phase_executors(dev):
    """The three executors against |FFT focus| and their adjoints in f32; a multi-resolution
    Babinet frame against f64 on the card."""
    from prysm_tpu_torch.coordinates import make_xy_grid
    from prysm_tpu_torch.geometry import antialias, circle_sdf
    from prysm_tpu_torch.propagation import (focus, prepare_executor, prepare_multiresolution,
                                             to_fpm_and_back_multiresolution)

    # the JAX package's on-chip executor checks: 128^2 at binary-exact spacings
    n, dx, wvl, efl = 128, 0.015625, 0.5, 10.0
    gen = torch.Generator().manual_seed(SEED + 5)
    rand = lambda *shape: torch.complex(torch.randn(*shape, generator=gen),  # noqa: E731
                                        torch.randn(*shape, generator=gen)).to(dev)
    a, x, y = rand(n, n), rand(n, n), rand(96, 96)
    m1 = focus(a, Q=2).abs()
    checks = []
    for kind in ('mdft', 'czt', 'fftdft'):
        plan = prepare_executor(dx, (n, n), efl * wvl / (dx * 2 * n), 2 * n, wvl, efl, kind=kind,
                                dtype=torch.complex64, device=dev)
        m2 = plan(a).abs()
        checks.append((f'{kind} vs |FFT focus| at Q=2 (peak rel)',
                       rel(m2 * (m1.max() / m2.max()), m1), 1e-4))
        plan = prepare_executor(dx, (n, n), 0.5, 96, wvl, efl, kind=kind,
                                dtype=torch.complex64, device=dev)
        lhs = torch.vdot(plan(x).ravel(), y.ravel())
        rhs = torch.vdot(x.ravel(), plan.adjoint(y).ravel())
        checks.append((f'{kind} adjoint <Ax, y> - <x, A*y> (rel)',
                       float((lhs - rhs).abs() / lhs.abs()), 1e-4))

    def frame(dtype):
        # an occulting disk of 3 lambda/D through a 3-level stack, Lyot stop 0.9,
        # Babinet form: the stack carries only the disk's complement
        N, wvl5, efl5 = 256, 0.55, 10.0
        pdx = 2.2 / N
        xg, yg = make_xy_grid(N, diameter=2.2, dtype=dtype, device=dev)
        r = torch.hypot(xg, yg)
        E = antialias(circle_sdf(1.0, r), pdx).to(dtype.to_complex())
        lyot = antialias(circle_sdf(0.9, r), pdx)
        lam_d = wvl5 * efl5 / 2.0
        mr = prepare_multiresolution(pdx, (N, N), lam_d / 2, 96, wvl5, efl5, num_levels=3,
                                     fine_samples=64, dtype=dtype.to_complex(), device=dev)
        disk = lambda xf, yf: (torch.hypot(xf, yf) <= 3 * lam_d).to(xf.dtype)  # noqa: E731
        at_lyot = E - to_fpm_and_back_multiresolution(E, disk, mr)
        final = prepare_executor(pdx, (N, N), lam_d / 4, 128, wvl5, efl5,
                                 dtype=dtype.to_complex(), device=dev)
        return final(lyot * at_lyot).abs() ** 2

    I32 = synced(lambda: frame(torch.float32))
    no_kernel_launches('executors')
    I64 = synced(lambda: frame(torch.float64))
    checks.append(('multi-resolution Babinet frame (peak rel)', rel(I32, I64), 1e-4))
    run_checks(checks)


def masked_rel(a, b, mask):
    """max |a - b| / max |b| over the mask, in float64."""
    a, b = a.detach().double()[mask], b.detach().double()[mask]
    return float((a - b).abs().max() / b.abs().max())


def q2d_worst_term(fit32, fit64):
    """The (n, m) term whose f32 sag is farthest from f64 over the disk, and that error."""
    from prysm_tpu_torch.polynomials import Q2d_nm_c_to_a_b, compute_z_Q2d
    from prysm_tpu_torch.steps import FREEFORM_Q2D_NMS
    worst = (0.0, None)
    for nm, c in zip(FREEFORM_Q2D_NMS, fit32.coefs['q2d']):
        terms = Q2d_nm_c_to_a_b([nm], [c])
        err = masked_rel(compute_z_Q2d(*terms, fit32.u, fit32.t),
                         compute_z_Q2d(*terms, fit64.u, fit64.t), fit32.mask)
        worst = max(worst, (err, nm), key=lambda w: w[0])
    return worst


def phase_freeform(dev):
    """The freeform fit in f32 through its entry point, against the same path in f64."""
    from prysm_tpu_torch.steps import FREEFORM_FAMILIES, build_freeform_fit

    # cfg2's TF32 scope must have put the switch back: lstsq's Gram matrix is full f32
    require(not torch.backends.cuda.matmul.allow_tf32,
            'TF32 is on after the cfg2 phase: set_matmul_precision left it off')
    fit32 = build_freeform_fit(N, device=dev)
    reset_launches()
    out = synced(fit32)
    counts = launch_counts()
    print(f'  launches on the freeform path: {json.dumps(counts)}')
    require(counts == {'zernike_fwd': 1, 'zernike_bwd_coefs': 0, 'zernike_bwd_all': 0,
                       'noise_expose': 0},
            f'the freeform fit launched {counts}, not one Zernike forward')
    for k, v in out.items():
        for a in (v if isinstance(v, tuple) else (v,)):
            require(a.dtype == torch.float32 and bool(torch.isfinite(a).all()),
                    f'freeform {k}: not finite float32')
    fit64 = build_freeform_fit(N, dtype=torch.float64, device=dev, fused=False)
    ref = synced(fit64)
    mask = fit32.mask
    print(f'  freeform: {len(fit32.coefs["q2d"])} Q2d terms, peak |z| on the disk '
          f'{float(ref["z"][mask].abs().max()):.4e} mm, residual RMS {float(out["residual_rms"]):.6e} '
          f'(f64 {float(ref["residual_rms"]):.6e}) mm, reconstruction vs f64 '
          f'{masked_rel(out["recon"], ref["recon"], mask):.3e} of peak')
    sag = masked_rel(out['z'], ref['z'], mask)
    if sag > 1e-5:
        err, nm = q2d_worst_term(fit32, fit64)
        print(f'  freeform: the f32 sag misses its bar; the worst single term is (n, m) = {nm} '
              f'at {err:.3e} of its peak')
    checks = [('Q2d sag (peak rel, r <= 1)', sag, 1e-5),
              ('Q2d radial slope dz/du (peak rel, r <= 1)', masked_rel(out['dr'], ref['dr'], mask),
               1e-4),
              ('Q2d azimuthal slope dz/dt (peak rel, r <= 1)',
               masked_rel(out['dt'], ref['dt'], mask), 1e-4)]
    for name in FREEFORM_FAMILIES:
        for what, a, b in zip(('z', 'dz/dx', 'dz/dy'), out[name], ref[name]):
            checks.append((f'{name} {what} (peak rel, r <= 1)', masked_rel(a, b, mask), 1e-4))
    checks += [('lstsq coefficients (rel to max |c|)', rel(out['coefs'], ref['coefs']), 1e-4),
               ('residual RMS (rel to f64)',
                abs(float(out['residual_rms']) / float(ref['residual_rms']) - 1), 1e-3)]
    run_checks(checks)
    return fit32


def phase_image_chain(dev):
    """The image chain in f32 through its entry point, against f64; the target's threshold flips."""
    from prysm_tpu_torch.coordinates import make_xy_grid, cart_to_polar
    from prysm_tpu_torch.objects import siemensstar
    from prysm_tpu_torch.steps import IMAGE_SPOKES, build_image_chain

    star = {dt: siemensstar(*cart_to_polar(*make_xy_grid(N, diameter=2.0, dtype=dt, device=dev)),
                            IMAGE_SPOKES) for dt in (torch.float32, torch.float64)}
    flips = star[torch.float32] != star[torch.float64].float()
    # cos(18 t) is 0 on the diagonals (t = 9 pi / 36 and its odd multiples): there the
    # star is 0.5 but for rounding, and each dtype rounds it to its own side
    x, y = make_xy_grid(N, diameter=2.0, dtype=torch.float64, device=dev)
    print(f'  image chain: share of target pixels a star built in f32 flips at its threshold '
          f'{float(flips.double().mean()):.3e}, {int(flips.sum())} pixels, '
          f'{int((flips & (x.abs() == y.abs())).sum())} of them on the diagonals '
          '(the chains take the f64 star, cast)')
    chain32 = build_image_chain(N, device=dev, target=star[torch.float64].float())
    reset_launches()
    img = synced(chain32)
    no_kernel_launches('image chain')
    for a in img:
        require(a.shape == (N, N) and a.dtype == torch.float32 and bool(torch.isfinite(a).all()),
                'an image-chain image is not a finite (1024, 1024) f32 map')
    img64 = synced(build_image_chain(N, dtype=torch.float64, device=dev, target=star[torch.float64]))
    run_checks([('image chain conv (peak rel)', rel(img[0], img64[0]), 1e-5),
                ('image chain transfer functions (peak rel)', rel(img[1], img64[1]), 1e-5)])
    return chain32


def phase_cfg6(dev):
    """cfg6 in f32 through its entry points, against f64 on the card."""
    from prysm_tpu_torch.steps import build_cfg6_grad, build_cfg6_trace
    from prysm_tpu_torch.x.raytracing.spencer_and_murty import eic_closing

    trace32 = build_cfg6_trace(device=dev)
    grad32 = build_cfg6_grad(device=dev)
    reset_launches()
    res = synced(trace32)
    loss32, g32, rms32 = synced(grad32)
    no_kernel_launches('cfg6')
    n_surf, rays = len(trace32.surfaces), trace32.P.shape[0]
    require(rays == 3 * 12481 and res.P.shape == (n_surf + 1, rays, 3)
            and res.OPL.shape == (n_surf + 1, rays) and res.P.dtype == torch.float32
            and res.status.dtype == torch.complex64,
            f'cfg6: P {tuple(res.P.shape)} {res.P.dtype}, OPL {tuple(res.OPL.shape)}, '
            f'status {res.status.dtype}')
    res64 = synced(build_cfg6_trace(dtype=torch.float64, device=dev))
    loss64, g64, rms64 = synced(build_cfg6_grad(dtype=torch.float64, device=dev))
    ok32, ok64 = res.status.imag == 0, res64.status.imag == 0
    require(bool(ok64.all()) and bool(ok32.all()), f'cfg6: {int((~ok32).sum())} f32 and '
            f'{int((~ok64).sum())} f64 rays of {rays} fail; every ray reaches the image')
    require(torch.equal(res.status.to(torch.complex128), res64.status),
            'cfg6: the f32 and f64 traces end with other statuses')
    require(bool(torch.isfinite(res.P[-1]).all()) and bool(torch.isfinite(g32).all()),
            'cfg6: landing points or gradient not finite')
    L32, L64 = res.OPL.sum(0), res64.OPL.sum(0)

    # EIC closing of the image-plane bundle onto each field's chief-centered
    # sphere, through the paraxial exit pupil
    fo = trace32.system._ynu_first_order()
    F, Nf = trace32.n_fields, trace32.n_rays

    def closing(r):
        P_end = r.P[-1].reshape(F, Nf, 3)
        center = P_end[torch.arange(F), torch.as_tensor(trace32.chiefs)]
        P_xp = torch.tensor([0.0, 0.0, fo.xp_z], dtype=P_end.dtype, device=dev)
        kappa = 1.0 / torch.linalg.norm(P_xp - center, dim=-1)
        return eic_closing(P_end, r.S[-1].reshape(F, Nf, 3), center[:, None], kappa[:, None])[0]

    s32, s64 = closing(res), closing(res64)
    print(f'  cfg6: {n_surf} surfaces, {rays} rays ({F} fields x {Nf}), all OK in f32 and f64; '
          f'XP z {fo.xp_z:.4f} mm; spot loss {float(loss32):.6e} (f64 {float(loss64):.6e}) mm, '
          f'field RMS radii f64 {[round(float(v), 6) for v in rms64]}; '
          f'|d loss / dc| f64 {[f"{float(v):.6g}" for v in g64]}')
    run_checks([
        ('cfg6 landing points vs f64 (mm)', float((res.P[-1].double() - res64.P[-1]).abs().max()),
         1e-4),
        ('cfg6 total OPL vs f64 (rel to max |OPL|)', rel(L32, L64), 1e-5),
        ('cfg6 EIC closing vs f64 (mm)', float((s32.double() - s64).abs().max()), 5e-5),
        ('cfg6 curvature gradient vs f64 (rel)', rel(g32, g64), 1e-3),
    ])
    return trace32, grad32


def film_stack(dtype, dev):
    """A callable giving (r_s, t_s, r_p, t_p) of the thin-film check's stack in ``dtype``.

    The inputs are made in f32 and cast, so both precisions take the same
    indices, thicknesses, wavelengths and angles.
    """
    from prysm_tpu_torch.thinfilm import multilayer_stack_rt
    n = torch.tensor(FILM_INDICES, dtype=torch.float32, device=dev)
    d = (FILM_WVL0 / (4 * n)).to(dtype)
    wvl = torch.linspace(*FILM_WVLS, device=dev).to(dtype)[:, None]
    aoi = torch.linspace(*FILM_ANGLES, device=dev).to(dtype)[None, :]
    n = n.to(dtype)
    return lambda: (*multilayer_stack_rt(n, d, wvl, 's', FILM_SUBSTRATE, aoi),
                    *multilayer_stack_rt(n, d, wvl, 'p', FILM_SUBSTRATE, aoi))


def film_energy_balance(rt, dev):
    """max |R + T - 1| over s and p: T = n_sub cos(t_sub) / cos(aoi) |t|^2 (ambient n = 1)."""
    aoi = torch.deg2rad(torch.linspace(*FILM_ANGLES, device=dev).double())[None, :]
    cos_sub = torch.sqrt(1 - (torch.sin(aoi) / FILM_SUBSTRATE) ** 2)
    return max(float(((r.abs() ** 2 + FILM_SUBSTRATE * cos_sub / torch.cos(aoi) * t.abs() ** 2)
                      .double() - 1).abs().max()) for r, t in (rt[:2], rt[2:]))


def phase_thinfilm(dev):
    """The thin-film stack in complex64 against complex128 on the card, and its energy balance."""
    stack32, stack64 = film_stack(torch.float32, dev), film_stack(torch.float64, dev)
    rt32, rt64 = synced(stack32), synced(stack64)
    require(all(a.dtype == torch.complex64 and a.shape == (FILM_WVLS[2], FILM_ANGLES[2])
                and bool(torch.isfinite(a).all()) for a in rt32),
            'thin film: r, t not finite complex64 (4096, 90) maps')
    def worst(pairs, f):
        return max(float((f(a) - f(b)).abs().max()) for a, b in pairs)

    rs, ts = list(zip(rt32[::2], rt64[::2])), list(zip(rt32[1::2], rt64[1::2]))
    as128 = lambda z: z.to(torch.complex128)  # noqa: E731
    modulus = lambda z: z.abs().double()  # noqa: E731
    print(f'  thin film: 32 layers x {FILM_WVLS[2]} wavelengths x {FILM_ANGLES[2]} angles; '
          f'largest complex |r32 - r64| {worst(rs, as128):.3e}, |t32 - t64| {worst(ts, as128):.3e}')
    run_checks([
        ('thin film |r| (s and p) vs complex128 (abs)', worst(rs, modulus), 1e-4),
        ('thin film |t| (s and p) vs complex128 (abs)', worst(ts, modulus), 1e-4),
        ('thin film |R + T - 1|, complex128', film_energy_balance(rt64, dev), 1e-4),
        ('thin film |R + T - 1|, complex64', film_energy_balance(rt32, dev), 1e-4)])
    return stack32


def frequency_radius(n, dx, dtype, dev):
    """The PSD's radial frequency grid, as Interferogram.psd builds it, in ``dtype``."""
    from prysm_tpu_torch.fttools import forward_ft_unit
    u = forward_ft_unit(dx, n, dtype=dtype, device=dev)
    return torch.hypot(u[None, :], u[:, None]), u


def phase_metrology(dev):
    """The interferometer-analysis path in f32 through its entry point, against f64 on the card."""
    import tempfile
    from prysm_tpu_torch import profiling
    from prysm_tpu_torch.coordinates import uniform_cart_to_polar
    from prysm_tpu_torch.interferogram import Interferogram, bandlimited_rms
    from prysm_tpu_torch.steps import (METROLOGY_BAND, METROLOGY_CLIP, build_metrology,
                                       metrology_measurement)

    t0 = time.perf_counter()
    measurement = metrology_measurement(N)
    print(f'  metrology: 13 frames of {N}^2 built on the host in f64 in '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    met32 = build_metrology(N, device=dev, measurement=measurement)
    met64 = build_metrology(N, dtype=torch.float64, device=dev, measurement=measurement)
    reset_launches()
    out = synced(met32)
    no_kernel_launches('metrology')
    for k, v in out.items():
        require(v.dtype == torch.float32 and (k == 'map' or bool(torch.isfinite(v).all())),
                f'metrology {k}: not a finite float32 tensor')
    ref = synced(met64)
    ap = met64.aperture
    nan = float('nan')

    # the f64 map against the true surface, both with piston, tilt, power and piston removed
    true = Interferogram(torch.as_tensor(measurement[1], device=dev), dx=met64.dx).mask(ap)
    true.remove_piston().remove_tiptilt().remove_power().remove_piston()
    s64, s32 = met64.surface(ref['wrapped']), met32.surface(out['wrapped'])
    pv_map = float(s64.data[ap].max() - s64.data[ap].min())
    truth_err = float((s64.data - true.data)[ap].abs().max())
    map_err = float((s32.data.double() - s64.data)[ap].abs().max())
    print(f'  metrology: f64 map vs the true surface {truth_err:.3e} nm (PV {pv_map:.4f} nm); '
          f'f32 map vs f64 {map_err:.3e} nm', flush=True)
    require(truth_err <= 1e-6, f'metrology: the f64 map misses the true surface by {truth_err} nm')

    # spike-clip flips: each within the f32 map's error of the threshold
    thr64, thr32 = METROLOGY_CLIP * float(s64.std), METROLOGY_CLIP * float(s32.std)
    flips = (torch.isnan(out['map']) != torch.isnan(ref['map'])) & ap
    margin = (s64.data.abs() - thr64).abs()[flips]
    tol = map_err + abs(thr32 - thr64)
    clipped = int((torch.isnan(ref['map']) & ap).sum())
    print(f'  metrology: spike_clip({METROLOGY_CLIP}) clips {clipped} of {int(ap.sum())} aperture '
          f'pixels in f64; {int(flips.sum())} flip in f32, the farthest '
          f'{float(margin.max()) if margin.numel() else 0.0:.3e} nm from the threshold '
          f'(allowed {tol:.3e} nm)', flush=True)
    require(bool((margin <= tol).all()), 'metrology: a spike-clip flip lies beyond f32 rounding')

    # the analysis on the f64 map cast to f32 (the f64 clip), and end to end over it
    cast = met32.analyze(Interferogram(ref['map'].float(), dx=met32.dx,
                                       wavelength=met32.wavelength))
    e2e = met32.analyze(Interferogram(torch.where(torch.isnan(ref['map']), nan, s32.data),
                                      dx=met32.dx, wavelength=met32.wavelength))
    # the band-limited RMS with the f64 band (the band edges, 0.1 and 1 cy/mm, fall on
    # frequency bins, which f32 rounds to either side) and the azimuthal average at the
    # f64 polar sample points: the f32 PSD's own error
    r64, u64 = frequency_radius(N, met64.dx, torch.float64, dev)
    r32, _ = frequency_radius(N, met32.dx, torch.float32, dev)
    edges = (1 / METROLOGY_BAND[1], 1 / METROLOGY_BAND[0])
    inside = [(r >= edges[0]) & (r <= edges[1]) for r in (r32, r64)]
    edge_flips = inside[0] != inside[1]
    near = (torch.minimum(*((r64[edge_flips] - e).abs() / e for e in edges))
            if edge_flips.any() else None)
    print(f'  metrology: band edges flip {int(edge_flips.sum())} PSD bins in f32, each within '
          f'{float(near.max()) if near is not None else 0.0:.2e} of an edge (relative)', flush=True)
    require(near is None or bool((near <= 4 * torch.finfo(torch.float32).eps).all()),
            'metrology: a band-edge flip lies beyond f32 rounding of the edge')
    blr_f64_band = bandlimited_rms(r64, cast['psd'].double(), *METROLOGY_BAND)
    az_f64_points = torch.nanmean(uniform_cart_to_polar(u64, u64, cast['psd'].double())[2], dim=0)

    def relerr(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    wrap_err = float(((out['wrapped'].double() - ref['wrapped'] + math.pi) % (2 * math.pi)
                      - math.pi).abs().max())
    checks = [('wrapped phase, wrap(f32 - f64) (rad)', wrap_err, 1e-5),
              ('unwrapped map over the aperture (of PV)', map_err / pv_map,
               METROLOGY_E2E_BARS['map'])]
    for k in ('pv', 'rms', 'Sa', 'std', 'strehl', 'pvr'):
        checks.append((f'cast f64 map: {k} (rel)', relerr(cast[k], ref[k]), 1e-5))
    checks += [('cast f64 map: PSD (of peak)', relerr(cast['psd'], ref['psd']), 1e-4),
               ('cast f64 map: band-limited RMS, f64 band (rel)',
                relerr(blr_f64_band, ref['bandlimited_rms']), 1e-4),
               ('cast f64 map: azavg at f64 points (of peak)', relerr(az_f64_points, ref['azavg']),
                1e-4),
               ('cast f64 map: azavg, f32 points (of peak)', relerr(cast['azavg'], ref['azavg']),
                METROLOGY_AZAVG_F32_BAR)]
    for k in ('filtered', 'slope_x', 'slope_y', 'slope'):
        checks.append((f'cast f64 map: {k} (of peak)', relerr(cast[k], ref[k]), 1e-4))
    for k, bar in METROLOGY_E2E_BARS.items():
        if k != 'map':
            checks.append((f'end to end f32: {k}', relerr(e2e[k], ref[k]), bar))
    # the Zygo .dat round trip of the f32 map: the NaNs, and within one count
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'map.dat')
        Interferogram(out['map'], dx=met32.dx, wavelength=met32.wavelength).save_zygo_dat(path)
        back = Interferogram.from_zygo_dat(path)
    count_nm = back.meta['wavelength'] * 1e9 / 32768
    require(back.data.shape == out['map'].shape and back.data.device == out['map'].device
            and torch.equal(torch.isnan(back.data), torch.isnan(out['map'])),
            'metrology: the Zygo .dat round trip changed the NaN pattern or the device')
    fin = torch.isfinite(out['map'])
    checks.append(('Zygo .dat round trip (counts of 15-bit phase)',
                   float((back.data.double() - out['map'].double())[fin].abs().max()) / count_nm,
                   1.001))
    # fit_psd on the card (f64 azimuthal average) against the same fit on the CPU
    fit_card = met64.fit_psd(ref)
    fit_cpu = met64.fit_psd({k: ref[k].cpu() for k in ('azavg_rho', 'azavg')})
    print(f'  metrology: abc_psd fit a, b, c = {[f"{v:.6g}" for v in fit_card]}', flush=True)
    checks.append(('fit_psd on the card vs the CPU, f64 (rel)',
                   float(max(abs(fit_card / fit_cpu - 1))), 1e-6))
    run_checks(checks, width=60)

    timing = profiling.time_fn(met32, iters=3, warmup=1)
    stats = profiling.device_memory_stats(dev)
    require(bool(stats), 'profiling.device_memory_stats gave nothing on the card')
    peak_mb = stats.get('allocated_bytes.all.peak', 0) / 1e6
    print(f'  profiling.time_fn(metrology): {timing!r}; device_memory_stats: {len(stats)} keys, '
          f'allocated.all.peak {peak_mb:.1f} MB', flush=True)
    return met32, ref


# ---------------------------------------------------------------------------
# phases 3j-3k: the coating designer's path and the optym phase retrieval
# ---------------------------------------------------------------------------

def coating_cpu_reference():
    """The f64 coating design on the host's CPU, run in a worker process: the
    L-BFGS-B refinement's first iterates and final merit, and the synthesis."""
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    from prysm_tpu_torch.steps import build_coating_design
    from prysm_tpu_torch.x.optym.problem import to_host
    design = build_coating_design(dtype=torch.float64, device='cpu')
    t0 = time.perf_counter()
    res = design.refine('lbfgsb', COATING_LBFGSB_ITERS)
    refine_s = time.perf_counter() - t0
    syn = design.synthesize()
    return {'iterates': [to_host(r.x_next) for r in res.optimizer_result.records],
            'merits': [r.metadata['f_next'] for r in res.optimizer_result.records],
            'merit': res.merit, 'nit': res.nit, 'needle_layers': syn.n_layers,
            'needle_merit': syn.merit, 'refine_s': refine_s,
            'seconds': time.perf_counter() - t0}


def on_card(x, dev, dtype, what):
    require(torch.is_tensor(x) and x.device == dev and x.dtype == dtype,
            f'{what} left the card or its dtype: '
            f'{getattr(x, "device", type(x))} {getattr(x, "dtype", "")}')


def energy_balance(design, stack):
    """max |R + T - 1| over the design's merit grids, s and p (a lossless stack)."""
    from prysm_tpu_torch.x.coatings import RTA
    worst = 0.0
    with design.configured():
        for term in design.merit:
            for pol in 'sp':
                R, T, _ = RTA(stack, term.wvl, term.theta, pol)
                worst = max(worst, float((R.double() + T.double() - 1).abs().max()))
    return worst


def phase_coating(dev, cpu_ref):
    """The coating design in f32 and f64 on the card; returns what phase 4 times."""
    from prysm_tpu_torch.steps import COATING_WVL0, NEEDLE_MATERIALS, build_coating_design
    from prysm_tpu_torch.x.coatings import insert_needle, needle_function
    from prysm_tpu_torch.x.optym import LBFGSB, PrysmLBFGSB

    f32, f64 = torch.float32, torch.float64
    designs = {dt: build_coating_design(dtype=dt, device=dev) for dt in (f32, f64)}
    start = {}
    for dt, d in designs.items():
        value, grad = d.problem().fg(d.problem().x0())
        _, index_grad = d.problem(variables='index').fg(d.problem(variables='index').x0())
        for x, what in ((grad, 'thickness gradient'), (index_grad, 'index gradient')):
            on_card(x, dev, dt, what)
            require(bool(torch.isfinite(x).all()), f'the {what} is not finite')
        start[dt] = (value, grad, index_grad)
    (v32, g32, n32), (v64, g64, n64) = start[f32], start[f64]
    print(f'  coating: {len(designs[f64].stack0)} layers; merit at the start {v64:.6f} (f64), '
          f'{v32:.6f} (f32)', flush=True)
    src = COATING_BAR_SOURCE
    checks = [(f'merit at the start, f32 vs f64 (rel; {src})', abs(v32 - v64) / abs(v64),
               COATING_F32_BARS['merit']),
              (f'thickness gradient, f32 vs f64 (of peak; {src})', rel(g32, g64),
               COATING_F32_BARS['thickness_gradient']),
              (f'index_gradient, f32 vs f64 (of peak; {src})', rel(n32, n64),
               COATING_F32_BARS['index_gradient'])]

    d64 = designs[f64]
    with d64.configured():
        # the f64 thickness gradient against central differences of the merit
        p64 = d64.problem()
        x0, h = p64.x0(), 1e-6
        merit = p64.merit.value
        fd = torch.tensor([(merit(p64.stack_from_x(x0 + h * e)) - merit(p64.stack_from_x(x0 - h * e)))
                           / (2 * h) for e in torch.eye(x0.numel(), dtype=f64, device=dev)],
                          dtype=f64, device=dev)
        checks.append(('thickness gradient f64 vs central difference, h = 1e-6 um (of peak; '
                       'new: the truncation, h^2 f\'\'\'/6, is 1.6e-7 on the CPU)', rel(g64, fd),
                       1e-6))
        # needle_function at five depths against the merit's forward difference
        # when a 1e-7 um needle of the low-index material is inserted there
        stack = d64.stack0
        depth = float(stack.thicknesses.sum())
        z = depth * torch.tensor([0.1, 0.3, 0.5, 0.7, 0.9], dtype=f64)
        P = needle_function(stack, d64.merit, NEEDLE_MATERIALS[0], z.numpy())
        on_card(P, dev, f64, 'needle_function')
        base, dn = p64.merit.value(stack), 1e-7
        fd_needle = torch.tensor([(p64.merit.value(insert_needle(stack, float(zk),
                                                                 NEEDLE_MATERIALS[0], dn))
                                   - base) / dn for zk in z])
        needle_err = float(((P.cpu() - fd_needle).abs() / fd_needle.abs().clamp(min=1e-6)).max())
        print(f'  needle_function at {[round(float(v), 4) for v in z]} um: '
              f'{[float(f"{v:.6g}") for v in P.cpu()]}', flush=True)
        checks.append(('needle_function f64 vs difference of an inserted needle (rel; '
                       'tests/test_coatings_depth.py:399)', needle_err, 3e-3))
    run_checks(checks, width=96)

    # the refinements, each with its wall time
    walls, refined = {}, {}
    for dt, d in designs.items():
        t0 = time.perf_counter()
        res = synced(lambda: d.refine('lbfgsb', COATING_LBFGSB_ITERS))
        walls[f'refine_lbfgsb_{str(dt)[6:]}'] = time.perf_counter() - t0
        on_card(res.x, dev, dt, f'the {dt} L-BFGS-B iterate')
        for r in res.optimizer_result.records:
            on_card(r.x_next, dev, dt, f'the {dt} L-BFGS-B iterate {r.iteration}')
        refined[dt] = res
    t0 = time.perf_counter()
    lm = d64.refine('lm', COATING_LM_ITERS)
    walls['refine_lm_float64'] = time.perf_counter() - t0
    evals = lm.optimizer_result.nfev
    print(f'  refine lbfgsb: merit {refined[f64].merit:.6g} (f64, {refined[f64].nit} iterations, '
          f'{walls["refine_lbfgsb_float64"]:.2f} s), {refined[f32].merit:.6g} (f32, '
          f'{refined[f32].nit} iterations, {walls["refine_lbfgsb_float32"]:.2f} s); refine lm: '
          f'merit {lm.merit:.6g} (f64, {lm.nit} iterations, {evals} residual evaluations, '
          f'{walls["refine_lm_float64"]:.2f} s)', flush=True)

    # PrysmLBFGSB against the SciPy driver on a bound-active box, iterate for iterate
    with d64.configured():
        p64 = d64.problem()
        x0 = p64.x0()
        quarter = COATING_WVL0 / (4 * torch.tensor(d64.stack0.indices, dtype=f64, device=dev))
        lo, hi = (1 - HEAD_TO_HEAD_BOX) * quarter, (1 + HEAD_TO_HEAD_BOX) * quarter
        active = int(((x0 <= lo) | (x0 >= hi)).sum())
        prysm, scipy = PrysmLBFGSB(p64.fg, x0, lower_bounds=lo, upper_bounds=hi), \
            LBFGSB(p64.fg, x0, lower_bounds=lo, upper_bounds=hi)
        steps_x, steps_f = [], []
        for _ in range(HEAD_TO_HEAD_ITERS):
            try:
                prysm.step()
                scipy.step()
            except StopIteration:
                break
            on_card(prysm.x, dev, f64, 'the PrysmLBFGSB iterate')
            steps_x.append(float((prysm.x.cpu() - torch.from_numpy(scipy.x)).abs().max()))
            f_p, f_s = prysm.last_step_metadata['f_next'], float(scipy._f)
            steps_f.append(abs(f_p - f_s) / abs(f_s))
    print(f'  PrysmLBFGSB vs LBFGSB (SciPy): {active} of {x0.numel()} layers outside the box at '
          f'the start; {len(steps_x)} iterations; |x - x_scipy| per iterate '
          f'{[float(f"{v:.2e}") for v in steps_x]}', flush=True)
    require(len(steps_x) >= 5, 'the head-to-head stopped before 5 iterations')

    t0 = time.perf_counter()
    syn64 = d64.synthesize()
    walls['synthesize_float64'] = time.perf_counter() - t0
    with d64.configured():
        needle0 = d64.needle_merit[0].value(d64.needle_start)
    print(f'  synthesize: {syn64.n_layers} layers, merit {syn64.merit:.6g} from {needle0:.6g}, '
          f'{syn64.iterations} rounds (f64, {walls["synthesize_float64"]:.2f} s)', flush=True)

    t0 = time.perf_counter()
    cpu = cpu_ref.get(timeout=600)
    print(f'  CPU reference (worker process): waited {time.perf_counter() - t0:.1f} s; its refine '
          f'{cpu["refine_s"]:.1f} s, all {cpu["seconds"]:.1f} s; synthesis {cpu["needle_layers"]} '
          f'layers, merit {cpu["needle_merit"]:.6g}', flush=True)
    card_records = refined[f64].optimizer_result.records
    parted = [float(abs(a.x_next.cpu().numpy() - b).max() / abs(b).max())
              for a, b in zip(card_records, cpu['iterates'])]
    merits = [(a.metadata['f_next'], b) for a, b in zip(card_records, cpu['merits'])]
    print('  refine lbfgsb f64, card vs CPU, |x - x_cpu| / max|x_cpu| at iterations '
          + ', '.join(f'{k + 1}: {parted[k]:.1e}' for k in range(0, len(parted), 10))
          + f'; merits at the last common iteration {merits[-1][0]:.6g} (card), '
          f'{merits[-1][1]:.6g} (CPU)', flush=True)
    require(len(parted) >= COATING_COMPARED, 'fewer than 10 L-BFGS-B iterates to compare')
    iterate_err = max(parted[:COATING_COMPARED])
    checks = [
        ('refine lbfgsb f64, card vs CPU: first 10 iterates (rel; new: f64 rounding grown '
         'through 10 steps)', iterate_err, 1e-9),
        # the two runs part by f64 rounding, about 10x per 10 iterations (printed above): after
        # 100 they are two paths into the same valley, both about 7e4 times below the start
        ('refine lbfgsb f64, card vs CPU: final merit (rel; new: the paths part by rounding)',
         abs(refined[f64].merit - cpu['merit']) / cpu['merit'], 0.25),
        ('refine lbfgsb: merit lowered from the start, f64 (final / start)',
         refined[f64].merit / v64, 1.0 - 1e-3),
        ('refine lbfgsb: merit lowered from the start, f32 (final / start)',
         refined[f32].merit / v32, 1.0 - 1e-3),
        ('refine lm: merit lowered from the start, f64 (final / start)', lm.merit / v64,
         1.0 - 1e-3),
        ('R + T = 1 on the refined lossless stack, f64 (abs; new: f64 rounding)',
         energy_balance(d64, refined[f64].stack), 1e-12),
        (f'R + T = 1 on the refined lossless stack, f32 (abs; {src})',
         energy_balance(designs[f32], refined[f32].stack), COATING_F32_BARS['energy']),
        ('PrysmLBFGSB vs LBFGSB: first iterate |x - x_scipy| (um; new: the same Cauchy step '
         'and unit step, 3.1e-9 on the CPU)', steps_x[0], 1e-7),
        ('PrysmLBFGSB vs LBFGSB: merit at each iterate (rel; new: the two line searches, '
         '<= 1.5e-3 on the CPU)', max(steps_f), 1e-2),
        ('synthesize f64, card vs CPU: layer count difference', abs(syn64.n_layers
                                                                    - cpu['needle_layers']), 0),
        ('synthesize f64, card vs CPU: merit (rel; new)',
         abs(syn64.merit - cpu['needle_merit']) / cpu['needle_merit'], 1e-6),
        ('synthesize: merit lowered from the start (final / start)',
         syn64.merit / needle0, 0.5)]
    run_checks(checks, width=96)
    return designs, walls


def phase_retrieval(dev):
    """The optym phase retrieval in f32 through its entry point; returns it and its run."""
    from prysm_tpu_torch.ops import zernike as zk
    from prysm_tpu_torch.steps import build_phase_retrieval_lbfgsb

    pr = build_phase_retrieval_lbfgsb(N=N, fN=FN, device=dev)
    per_fg, fg = [], pr.fg

    def counted(c):
        before = dict(zk.LAUNCHES)
        out = fg(c)
        per_fg.append({k: zk.LAUNCHES[k] - before[k] for k in zk.LAUNCHES})
        return out

    pr.fg = counted
    reset_launches()
    t0 = time.perf_counter()
    res = synced(pr)
    wall = time.perf_counter() - t0
    pr.fg = fg
    launches = launch_counts()
    on_card(res.x, dev, torch.float32, 'the retrieval iterate')
    err = float((res.x - pr.truth).abs().max())
    print(f'  retrieval: {res.nit} iterations ({res.message}), {len(per_fg)} objective '
          f'evaluations, {wall:.3f} s; launches {json.dumps(launches)}; coefficients '
          f'{[round(float(v), 6) for v in res.x]}', flush=True)
    require(all(d == {'zernike_fwd': 1, 'zernike_bwd_coefs': 1, 'zernike_bwd_all': 0}
                for d in per_fg),
            f'an objective evaluation did not launch one forward and one coefficient backward: '
            f'{[d for d in per_fg if d != per_fg[0]][:3] or per_fg[:1]}')
    require(launches['zernike_fwd'] == launches['zernike_bwd_coefs'] == len(per_fg)
            and not launches['noise_expose'] and not launches['zernike_bwd_all'],
            f'the retrieval launched {launches} for {len(per_fg)} evaluations')
    run_checks([('retrieval coefficients vs the truth (abs; 2x the JAX package f32 with TF32 '
                 'products, probes/coating_cpu_probe.py)', err, RETRIEVAL_TF32_BAR),
                ('hand-written launches per objective evaluation - 2', max(
                    abs(sum(d.values()) - 2) for d in per_fg), 0)], width=96)
    # beside it, the same retrieval with float32 products (TF32 off)
    exact = build_phase_retrieval_lbfgsb(pr.pupil, matmul_precision=None)
    res32 = exact()
    print(f'  retrieval with float32 MDFT products: {res32.nit} iterations ({res32.message}), '
          f'coefficients {float((res32.x - pr.truth).abs().max()):.3e} from the truth (the JAX '
          f'package f32 {RETRIEVAL_JAX_F32:.2e})', flush=True)
    return pr, res, wall, len(per_fg)


def wfc_reference(wfc, fN, dm=None):
    """The wavefront-control step in f64, on wfc's device, from wfc's pupil grids (cast),
    through the mode stack (the kernels compute in f32) and with f64 MDFT products to fN^2;
    ``dm`` replaces the step's DM."""
    import dataclasses
    from prysm_tpu_torch.steps import build_wavefront_control
    p = wfc.pupil
    p64 = dataclasses.replace(p, r=p.r.double(), t=p.t.double(), amp=p.amp.double(),
                              coefs=p.coefs.double())
    return build_wavefront_control(p.r.shape[-1], nact=wfc.dm.actuators.shape[-1], fN=fN,
                                   matmul_precision=None, fused=False, pupil=p64, dm=dm,
                                   dtype=torch.float64, device=p.r.device)


def opd_cotangent(w, acts, coefs):
    """The loss's gradient with respect to the OPD, by autograd from the OPD on."""
    opd = w.opd(acts, coefs).detach().requires_grad_(True)
    loss = torch.sum((w.psf(opd) - w.I_ref) ** 2)
    return torch.autograd.grad(loss, opd)[0]


def phase_wavefront_control(dev, pieces):
    """The wavefront-control step in f32 (TF32 MDFT) through its entry point for STEPS steps,
    against f64 on the card; its Shack-Hartmann frame; the hand-written adjoint chain in f64;
    the DM fold's warp_bwd kernel against its plain version, in f32 and f64.
    ``pieces``: the launches of each Zernike kernel that the 36-mode plan takes (phase 2)."""
    from prysm_tpu_torch.ops import warp as warp_op
    from prysm_tpu_torch.steps import (WFC_NACT, WFC_NMS, build_wavefront_control,
                                       make_cfg2_plan, sh_geometry)
    from prysm_tpu_torch.x.dm import DM

    want = {'zernike_fwd': pieces, 'zernike_bwd_coefs': pieces, 'zernike_bwd_all': 0,
            'noise_expose': 0}
    print(f'  {len(WFC_NMS)} modes: {pieces} launch(es) in each direction per step', flush=True)
    wfc = build_wavefront_control(N, fN=FN, device=dev)
    a, c = wfc.dm.actuators, wfc.pupil.coefs
    reset_launches()
    per_step, warp_steps = [], []
    for i in range(STEPS):
        before, warp_before = launch_counts(), warp_op.LAUNCHES['warp_bwd']
        loss, ga, gc = synced(lambda: wfc(a, c))
        per_step.append({k: v - before[k] for k, v in launch_counts().items()})
        warp_steps.append(warp_op.LAUNCHES['warp_bwd'] - warp_before)
        require(bool(torch.isfinite(loss)) and bool(torch.isfinite(ga).all())
                and bool(torch.isfinite(gc).all()), f'wavefront-control step {i}: not finite')
        if i == 0:
            out = {'loss': loss, 'ga': ga, 'gc': gc}
        a, c = a - 1e-12 * ga, c - 1e-12 * gc
    print(f'  launches per wavefront-control step: {json.dumps(per_step)}', flush=True)
    # the signature's first call runs eager, its second warms up on a side stream and
    # captures the step's CUDA graph, the later calls replay it
    wants = ([want, {k: 2 * v for k, v in want.items()}]
             + [dict.fromkeys(want, 0)] * (STEPS - 2))
    require(per_step == wants,
            f'the wavefront-control steps did not launch {wants}: {per_step}')
    # the fold's backward: one launch eager, two in the capture's step, none replayed (on
    # the CPU the plain version, no launch)
    want_warp = [1, 2] + [0] * (STEPS - 2) if torch.device(dev).type == 'cuda' else [0] * STEPS
    print(f'  warp_bwd launches per wavefront-control step: {warp_steps}', flush=True)
    require(warp_steps == want_warp,
            f'the wavefront-control steps did not launch warp_bwd {want_warp}: {warp_steps}')
    require(ga.shape == (WFC_NACT, WFC_NACT) and gc.shape == (len(WFC_NMS),)
            and ga.dtype == gc.dtype == torch.float32, 'wavefront-control gradients: shape/dtype')
    a, c = wfc.dm.actuators, wfc.pupil.coefs
    with torch.no_grad():
        opd = wfc.opd(a, c)
        psf = wfc.psf(opd)
        frame = wfc.sensor(a, c)
    with torch.no_grad():
        exact = make_cfg2_plan(wfc.pupil, FN, matmul_precision=None)
        psf_f32 = wfc.field(opd).focus_dft(exact).intensity.data
    ref = wfc_reference(wfc, FN)
    a64, c64 = ref.dm.actuators, ref.pupil.coefs
    loss64, ga64, gc64 = synced(lambda: ref(a64, c64))
    with torch.no_grad():
        opd64 = ref.opd(a64, c64)
        psf64 = ref.psf(opd64)
        frame64 = ref.sensor(a64, c64)
    n, pitch, efl = sh_geometry(N)
    # an f32 lenslet screen would share other edge samples than the f64 one: the
    # step builds its screen in f64 and casts it (steps.py)
    from prysm_tpu_torch.coordinates import make_xy_grid
    from prysm_tpu_torch.x.shack_hartmann import shack_hartmann
    from prysm_tpu_torch.steps import WVL
    x32, y32 = make_xy_grid(N, diameter=2.2, device=dev)
    screen32 = shack_hartmann(pitch, n, efl, WVL, x32, y32, shift=True)
    off = (torch.angle(screen32 * wfc.screen.conj()).abs() > 1e-3).sum()
    print(f'  wavefront control: loss {float(out["loss"]):.6e} (f64 {float(loss64):.6e}), OPD peak '
          f'{float(opd64.abs().max()):.4e} nm on the grid, in the pupil '
          f'{float(opd64[ref.pupil.amp > 0].abs().max()):.4e}; Shack-Hartmann {n} x {n} lenslets, '
          f'pitch {pitch:.6f} mm, f {efl:.6f} mm, {WVL} um; samples an f32-built screen '
          f'shares otherwise: {int(off)}', flush=True)
    # the hand-written chain, in f64: autograd's actuator gradient against DM.render_adjoint
    # of the OPD cotangent; exact for an unfolded DM, while for the folded one the
    # adjoint pulls through the inverse projection (no Jacobian, other weights)
    unfolded = DM(ref.dm.ifn, N, Nact=ref.dm.Nact, sep=ref.dm.sep)
    flat = wfc_reference(wfc, FN, dm=unfolded)
    _, ga_flat, _ = flat(a64, c64)
    chain_flat = rel(unfolded.render_adjoint(opd_cotangent(flat, a64, c64)), ga_flat)
    chain_fold = rel(ref.dm.render_adjoint(opd_cotangent(ref, a64, c64)), ga64)
    print(f'  folded DM (10 degrees): DM.render_adjoint of the OPD cotangent vs autograd '
          f'{chain_fold:.4e} (rel; 1 - cos 10 deg = {1 - math.cos(math.radians(10)):.4e})',
          flush=True)
    # the fold's backward kernel against its plain version, on the step's plan (f32) and
    # the f64 reference's: samples that differ
    warp_diff = []
    for plan in (wfc.dm.warp_plan, ref.dm.warp_plan):
        gen = torch.Generator(device=dev).manual_seed(22)
        cot = torch.randn(plan.out_shape, generator=gen, device=dev, dtype=plan.dtype)
        kern, plain = warp_op.warp_bwd(plan, cot), warp_op.warp_bwd_plain(plan, cot)
        warp_diff.append(float((kern != plain).sum()))
    run_checks([
        ('DM fold warp_bwd kernel vs plain, f32 (samples that differ)', warp_diff[0], 0),
        ('DM fold warp_bwd kernel vs plain, f64 (samples that differ)', warp_diff[1], 0),
        ('OPD, fused f32 vs f64 mode stack (peak rel, same grids)', rel(opd, opd64), 1e-6),
        ('PSF, f32 MDFT products (peak rel)', rel(psf_f32, psf64), 2e-5),
        ('PSF, TF32 MDFT (peak rel)', rel(psf, psf64), WFC_TF32_PSF_BAR),
        ('actuator gradient, TF32 (rel)', rel(out['ga'], ga64), 1e-3),
        ('coefficient gradient, TF32 (rel)', rel(out['gc'], gc64), 1e-3),
        ('loss, TF32 (rel)', rel(out['loss'], loss64), 1e-3),
        ('Shack-Hartmann frame (peak rel)', rel(frame, frame64), 1e-4),
        ('f64 unfolded DM: render_adjoint chain vs autograd (rel)', chain_flat, 1e-10),
    ], width=60)
    return wfc


def pspdi_recovery(interferometer, wave, amp, phase, inner, scheme):
    """(wrapped, miss): the phase a PSPDI measures of ``wave`` by x/psi's de Groot PSI over
    ``scheme``'s shifts, less its measurement of the unaberrated ``amp``, wrapped to
    [-pi, pi); and the measurement plus the true ``phase`` over ``inner``, piston removed."""
    from prysm_tpu_torch.x import psi

    def measure(w):
        frames = [interferometer.forward_model(w, phase_shift=float(s)).data
                  for s in scheme.shifts]
        return psi.degroot_formalism_psi(frames, scheme)

    wrapped = measure(wave) - measure(amp.to(wave.dtype))
    wrapped = torch.remainder(wrapped + math.pi, 2 * math.pi) - math.pi
    miss = (wrapped + phase)[inner]
    return wrapped, miss - miss.mean()


def phase_instruments(dev):
    """Phase 3m at 256^2: a 4-step PSPDI measurement through x/psi, the SRI with its fiber
    mode, a charge-2 vector vortex through jones_adapter(focus), and an MWIR germanium
    singlet at 80 K and 295 K through the raytracer; f32 against f64 on the card."""
    from prysm_tpu_torch.conf import precision_as
    from prysm_tpu_torch.coordinates import make_xy_grid, cart_to_polar
    from prysm_tpu_torch.geometry import circle_sdf, antialias
    from prysm_tpu_torch.polynomials import zernike_nm_seq, sum_of_2d_modes
    from prysm_tpu_torch.propagation import Wavefront, focus
    from prysm_tpu_torch.x import fibers, pdi, psi, sri
    from prysm_tpu_torch.x import polarization as pol

    scheme = psi.design_scheme(4, stepsize=math.pi / 2)
    out = {}
    for dt in (torch.float32, torch.float64):
        with precision_as(dt):
            x, y = make_xy_grid(N_INSTR, diameter=INSTR_EPD * 1.1, dtype=dt, device=dev)
            r, t = cart_to_polar(x, y)
            dx = float(x[0, 1] - x[0, 0])
            amp = antialias(circle_sdf(INSTR_EPD / 2, r), dx)
            coefs = torch.tensor(INSTR_ZERNIKES[1], dtype=dt, device=dev)
            phase = sum_of_2d_modes(zernike_nm_seq(INSTR_ZERNIKES[0], r / (INSTR_EPD / 2), t),
                                    coefs) * (2 * math.pi / (INSTR_WVL * 1e3))
            wave = amp * torch.polar(torch.ones_like(phase), phase)
            dev_pdi = pdi.PSPDI(x, y, INSTR_EFL, INSTR_EPD, INSTR_WVL,
                                pinhole_diameter=INSTR_PINHOLE)

            inner = r < 0.9 * INSTR_EPD / 2
            wrapped, miss = pspdi_recovery(dev_pdi, wave, amp, phase, inner, scheme)
            interferometer = sri.SelfReferencedInterferometer(x, y, INSTR_EFL, INSTR_EPD,
                                                              INSTR_WVL, fiber_samples=N_INSTR)
            I_sri = interferometer.forward_model(wave, phase_shift=0.7).data
            wf = Wavefront(wave, INSTR_WVL, dx)
            _, at_fib, _, eta = sri.to_photonic_fiber_and_back(
                wf, INSTR_EFL, interferometer.Efib, interferometer.dxfib,
                interferometer.Ifibsum, return_more=True)
            eta2 = fibers.mode_overlap_integral(at_fib.data, interferometer.Efib)
            field = pol.apply_polarization_optic(amp.to(wave.dtype),
                                                 pol.vector_vortex_retarder(2, t))
            I_vvr = (pol.jones_adapter(focus)(field, 2).abs() ** 2).sum(dim=(-2, -1))
            I_scalar = sum(focus(amp * torch.polar(torch.ones_like(t), k * t), 2).abs() ** 2
                           for k in (2, -2))
            out[dt] = dict(phase=phase, wrapped=wrapped, inner=inner, miss=miss, I_sri=I_sri,
                           eta=eta, eta2=eta2, efib=float((interferometer.Efib ** 2).sum()),
                           I_vvr=I_vvr, I_scalar=I_scalar, ge=germanium_singlet(dt, dev))
    o32, o64 = out[torch.float32], out[torch.float64]
    for k in ('I_sri', 'I_vvr', 'wrapped'):
        require(o32[k].dtype == torch.float32 and bool(torch.isfinite(o32[k]).all()),
                f'phase 3m: {k} is not finite float32')
    ge32, ge64 = o32['ge'], o64['ge']
    shift = {k: g[295.0]['efl'] - g[80.0]['efl'] for k, g in (('f32', ge32), ('f64', ge64))}
    paraxial = ge64[295.0]['paraxial'] - ge64[80.0]['paraxial']
    print(f'  PSPDI: phase rms {float(o64["phase"][o64["inner"]].std()):.4f} rad, recovered '
          f'rms miss f64 {float(o64["miss"].std()):.3e} f32 {float(o32["miss"].std()):.3e} rad; '
          f'SRI coupling {float(o64["eta"]):.6f}; germanium n(4 um) '
          f'{ge64[80.0]["n"]:.6f} at 80 K, {ge64[295.0]["n"]:.6f} at 295 K; EFL '
          f'{[round(float(v), 6) for v in ge64[80.0]["efl"]]} -> '
          f'{[round(float(v), 6) for v in ge64[295.0]["efl"]]} mm (paraxial '
          f'{ge64[80.0]["paraxial"]:.6f} -> {ge64[295.0]["paraxial"]:.6f})', flush=True)
    checks = [
        ('PSPDI recovered phase vs truth, f64 (rms rad, r <= 0.9)', float(o64['miss'].std()),
         INSTR_PSPDI_BAR),
        ('PSPDI recovered phase vs truth, f32 (rms rad, r <= 0.9)', float(o32['miss'].std()),
         INSTR_PSPDI_BAR),
        ('PSPDI wrapped phase f32 vs f64 (rad, r <= 0.9)', float(
            (o32['wrapped'].double() - o64['wrapped'])[o64['inner']].abs().max()), 1e-4),
        ('SRI intensity f32 vs f64 (peak rel)', rel(o32['I_sri'], o64['I_sri']), 1e-4),
        ('SRI coupling vs fibers.mode_overlap_integral, f32 (rel)',
         abs(float(o32['eta']) / float(o32['eta2']) - 1), 1e-6),
        ('SRI fiber mode energy - 1, f32', abs(o32['efib'] - 1), 1e-6),
        ('vector vortex: sum of Jones intensities vs scalar, f32 (peak rel)',
         rel(o32['I_vvr'], o32['I_scalar']), 2e-5),
        ('vector vortex f32 vs f64 (peak rel)', rel(o32['I_vvr'], o64['I_vvr']), 2e-5),
    ]
    for T in (80.0, 295.0):
        checks.append((f'germanium singlet EFL at {T:g} K, f32 vs f64 (rel)',
                       rel(ge32[T]['efl'], ge64[T]['efl']), 1e-5))
    checks += [('germanium EFL shift 80 -> 295 K, f32 vs f64 (rel)',
                rel(shift['f32'], shift['f64']), 1e-3),
               ('germanium EFL shift, f64 trace vs paraxial (rel)',
                float((shift['f64'] / paraxial - 1).abs().max()), 1e-3)]
    run_checks(checks, width=64)


def germanium_singlet(dtype, dev):
    """{T: n, paraxial EFL, traced EFL of rays at INSTR_GE_HEIGHTS} of the MWIR germanium
    singlet, its glass from infrared_catalog(T); every ray OK."""
    from prysm_tpu_torch.conf import precision_as
    from prysm_tpu_torch.x import materials as mat, raytracing as rt
    from prysm_tpu_torch.x.raytracing import paraxial
    from prysm_tpu_torch.x.raytracing.spencer_and_murty import raytrace

    out = {}
    h = torch.tensor(INSTR_GE_HEIGHTS, dtype=torch.float64)
    for T in (80.0, 295.0):
        ge = mat.infrared_catalog(T).material_for_name('GE')
        lens = rt.LensData()
        (c1, t1), (c2, t2) = INSTR_GE_LENS
        lens.add(rt.Sphere(c1), thickness=t1, material=ge)
        lens.add(rt.Sphere(c2), thickness=t2, material=mat.air)
        surfaces = lens.to_surfaces()
        P = torch.stack([torch.zeros_like(h), h, torch.full_like(h, -1.0)], 1)
        S = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64).expand(len(h), 3)
        with precision_as(dtype):
            res = raytrace(surfaces, P.to(dev), S.to(dev), INSTR_GE_WVL)
        require(res.P.dtype == dtype and bool((res.status.imag == 0).all()),
                f'germanium singlet at {T} K, {dtype}: a ray failed')
        Sy, Sz = res.S[-1, :, 1].double(), res.S[-1, :, 2].double()
        out[T] = {'n': float(ge.n(INSTR_GE_WVL)), 'efl': -h.to(dev) * Sz / Sy,
                  'paraxial': paraxial.effective_focal_length(surfaces, INSTR_GE_WVL)}
    return out


def count_syncs(fn):
    """(fn's result, the host synchronisations it made), counted by torch's sync debug mode."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum('synchroniz' in str(w.message) for w in caught)


def design_timing(smi, designs, walls, retrieval):
    """Phase 4's lines for the coating design and the phase retrieval."""
    from prysm_tpu_torch.x.optym import PrysmLBFGSB
    fgs = {}
    for dt, d in designs.items():
        with d.configured():
            p = d.problem()
            x = p.x0()
            fgs[f'coating_fg_ms_{str(dt)[6:]}'] = lambda p=p, x=x, d=d: p.fg(x)
    pr, res, wall, evals = retrieval
    c = pr.truth * 0.9
    fgs['retrieval_fg_ms'] = lambda: pr.fg(c)
    timing = step_ms(fgs, runs=20, warmup=3)
    for key, ms in timing.items():
        breakdown = device_breakdown(fgs[key], steps=3)
        if breakdown is None:
            print(f'{smi} | {key} {ms:.4f}; device ms per fg not measured (every profiler '
                  'trace came back empty)', flush=True)
            continue
        busy, kernels_per, top = breakdown
        print(f'{smi} | {key} {ms:.4f}; device ms per fg {busy:.4f} busy share {busy / ms:.3f}; '
              f'device kernels per fg {kernels_per:.0f}; top: '
              + '; '.join(f'{k} {v:.4f}' for k, v in top), flush=True)
    # PrysmLBFGSB iterations on the f32 design from its start, with the host syncs they make
    d32 = designs[torch.float32]
    with d32.configured():
        p = d32.problem()
        opt = PrysmLBFGSB(p.fg, p.x0())
        synced(opt.step)
        n, nfev0 = 10, opt.nfev
        t0 = time.perf_counter()
        _, syncs = count_syncs(lambda: synced(lambda: [opt.step() for _ in range(n)]))
        it_ms = (time.perf_counter() - t0) * 1e3 / n
    per_it = (opt.nfev - nfev0) / n
    print(f'{smi} | coating_lbfgsb_iteration_ms_float32 {it_ms:.4f} (host wall, iterations 2-11); '
          f'objective evaluations per iteration {per_it:.2f}; host syncs per iteration '
          f'{syncs / n:.1f} ({syncs / n / per_it:.1f} per evaluation)', flush=True)
    print(f'{smi} | ' + '; '.join(f'{k}_s {v:.3f}' for k, v in walls.items())
          + ' (host wall, phase 3j runs)', flush=True)
    print(f'{smi} | retrieval_iteration_ms {wall * 1e3 / max(res.nit, 1):.4f} (host wall, '
          f'{res.nit} iterations, {evals} evaluations, {evals / max(res.nit, 1):.2f} per '
          f'iteration); hand-written launches per fg 2', flush=True)


# ---------------------------------------------------------------------------
# phase 3n: the lens-analysis path
# ---------------------------------------------------------------------------

def np_rel(a, b, what=''):
    """max |a - b| / max |b| of host arrays, NaN where both are NaN."""
    import numpy as np
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    require(bool(np.array_equal(np.isnan(a), np.isnan(b))),
            f'{what}: the NaN patterns differ ({int(np.isnan(a).sum())} against '
            f'{int(np.isnan(b).sum())})')
    return float(np.nanmax(np.abs(a - b)) / np.nanmax(np.abs(b)))


def lens_quantities(la):
    """What phase 3n compares across precisions, from the lens-analysis plan ``la`` in
    its dtype on its device: the merged trace of its launches, one call's outputs, and
    beside the call ``first_order`` at each field, the Seidel sums, distortion, field
    curvature, spot diagrams, OPD fans and the RMS-WFE full-field map (their launches
    real-aimed in ``la``'s dtype).  Host numpy, the call's outputs as it returns them."""
    import numpy as np
    from prysm_tpu_torch.steps import WVL
    from prysm_tpu_torch.x.raytracing import raytrace, seidel_aberrations
    from prysm_tpu_torch.x.raytracing.spencer_and_murty import to_host
    system = la.system
    with la.configured():
        res = raytrace(system.to_surfaces(), la.P, la.S, WVL)
        coefs, rms, psfs, grads, values = la()
        fo = [system.first_order(field=k) for k in range(len(la.fields))]
        seidel = seidel_aberrations(system)
        curvature = system.analysis.field_curvature(samples=LENS_CURVE_SAMPLES)
        spots = system.analysis.spot_diagrams()
        fans = system.analysis.opd_fans()
        return {
            'status': to_host(res.status), 'landing': to_host(res.P[-1]),
            'opl': to_host(res.OPL.sum(0)), 'xp_z': float(system.exit_pupil(WVL)[2]),
            'coefs': coefs, 'rms': rms, 'psfs': psfs, 'grads': grads,
            'values': np.asarray(values),
            'first_order': np.array([[getattr(f, s) for s in LENS_FO_SLOTS] for f in fo], float),
            'seidel': np.array([seidel.sums[k] for k in sorted(seidel.sums)]),
            'distortion': system.analysis.distortion(samples=LENS_CURVE_SAMPLES).percent,
            'field_curvature': np.stack([curvature.x_fan_z, curvature.y_fan_z]),
            'spots': np.stack([spots.x, spots.y]), 'opd_fans': np.stack([fans.x, fans.y]),
            'full_field': system.analysis.full_field(
                'rms wfe', samples=LENS_FULL_FIELD_SAMPLES).data}


def lens_errors(q, ref):
    """Phase 3n's error of each quantity of ``q`` against ``ref`` (lens_quantities'
    layout): mm for the landing points, the residual RMS, field curvature and spots,
    percent points for distortion; relative to the largest magnitude for the rest, the
    sensitivities head by head and first_order slot by slot and field by field.  The
    verbs' rays are compared where both precisions aimed them; 'lost' counts the rays
    (of the spot diagrams and OPD fans) aimed in one precision and lost in the other."""
    import numpy as np

    def host(a):
        return a.detach().cpu().double().numpy() if torch.is_tensor(a) else np.asarray(a, float)

    def pair(k):
        a, b = host(q[k]), host(ref[k])
        both = np.isfinite(a) & np.isfinite(b)
        return a[both], b[both], int((np.isfinite(a) != np.isfinite(b)).sum())

    out, lost = {}, 0
    for k in ('landing', 'rms', 'field_curvature', 'spots', 'distortion'):
        a, b, n = pair(k)
        out[k], lost = float(np.abs(a - b).max()), lost + n
    for k in ('opl', 'coefs', 'psfs', 'seidel', 'opd_fans', 'full_field'):
        a, b, n = pair(k)
        out[k], lost = np_rel(a, b, k), lost + n
    out['lost'] = lost
    out['xp_z'] = abs(q['xp_z'] - ref['xp_z']) / abs(ref['xp_z'])
    out['grads'] = max(np_rel(a, b) for a, b in zip(host(q['grads']), host(ref['grads'])))
    # each slot against its largest magnitude over the fields and sections
    fo, fo_ref = host(q['first_order']), host(ref['first_order'])
    scale = np.abs(fo_ref).max(axis=(0, 2), keepdims=True)
    out['first_order'] = float(np.max(np.abs(fo - fo_ref) / np.where(scale > 0, scale, 1.0)))
    return out


def lens_same_coefficients(la, coefs, fN):
    """The rendered OPD, its PSF with f32 MDFT products and its PSF through ``la``'s own
    plan, from ``coefs`` (1, F, K), against f64 from the same coefficients cast: the mode
    stack on ``la``'s grids cast and an f64 MDFT.  Each of its peak, the worst field."""
    import dataclasses
    from prysm_tpu_torch.polynomials import zernike_nm_seq
    from prysm_tpu_torch.propagation import Wavefront
    from prysm_tpu_torch.steps import LENS_NMS, WVL, make_cfg2_plan
    p = la.pupil
    p64 = dataclasses.replace(p, r=p.r.double(), t=p.t.double(), amp=p.amp.double())
    x64, y64 = la.x.double(), la.y.double()
    stack = zernike_nm_seq(LENS_NMS, torch.hypot(x64, y64), torch.atan2(y64, x64))
    plan64 = make_cfg2_plan(p64, fN, matmul_precision=None)
    exact = make_cfg2_plan(p, fN, matmul_precision=None)
    opd = la.opd(coefs[0])
    err = {'opd': 0.0, 'psf': 0.0, 'psf_plan': 0.0}
    for k, c in enumerate(coefs[0]):
        opd64 = torch.tensordot(c.double() * 1e6, stack, dims=1)
        psf64 = (Wavefront.from_amp_and_phase(p64.amp, opd64, WVL, p.dx)
                 .focus_dft(plan64).intensity.data)
        psf32 = (Wavefront.from_amp_and_phase(p.amp, opd[k], WVL, p.dx)
                 .focus_dft(exact).intensity.data)
        err['opd'] = max(err['opd'], rel(opd[k], opd64))
        err['psf'] = max(err['psf'], rel(psf32, psf64))
        err['psf_plan'] = max(err['psf_plan'], rel(la.psfs(opd[k:k + 1])[0], psf64))
    return err


def lens_f64_checks(la):
    """In ``la``'s dtype (f64): its sensitivities against the forward tangents of the same
    heads (``raytrace_with_tangents`` and a jvp of each head) and against central
    differences of the seeded trace at steps h and 2h (the truncation estimated from the
    two); ``first_order`` on axis against the paraxial walk.  Returns the errors."""
    import numpy as np
    from prysm_tpu_torch.steps import WVL
    from prysm_tpu_torch.x.raytracing._diff_raytrace import raytrace_with_tangents
    from prysm_tpu_torch.x.raytracing.adjoint.engine import _trace_fn
    with la.configured():
        grads, _ = la.sensitivities()
        surfaces = la.system.to_surfaces()
        tan = raytrace_with_tangents(surfaces, la.P, la.S, WVL, la.seeds)
        hist = (tan.P, tan.S, tan.OPL)
        fwd = np.array([[float(torch.func.jvp(
            head, hist, tuple(torch.as_tensor(d[..., k], device=tan.P.device)
                              for d in (tan.Pdot, tan.Sdot, tan.Ldot)))[1])
            for k in range(len(la.seeds))] for head in la.heads])
        f = _trace_fn(surfaces, la.seeds, la.P, la.S, WVL, None)

        def central(h):
            out = np.zeros_like(fwd)
            for k in range(len(la.seeds)):
                e = torch.zeros(len(la.seeds), dtype=la.dtype, device=la.device)
                e[k] = h
                plus, minus = f(e), f(-e)
                for m, head in enumerate(la.heads):
                    out[m, k] = (float(head(*plus)) - float(head(*minus))) / (2 * h)
            return out

        fd_h, fd_2h = central(LENS_FD_STEP), central(2 * LENS_FD_STEP)
        fo, ynu = la.system.first_order(field=0), la.system._ynu_first_order()
    scale = np.abs(grads).max(axis=1, keepdims=True)
    return {'forward': float((np.abs(grads - fwd) / scale).max()),
            'fd': float((np.abs(grads - fd_h) / scale).max()),
            'truncation': float((np.abs(fd_2h - fd_h) / 3 / scale).max()),
            'efl': max(abs(v - ynu.efl) / abs(ynu.efl) for v in fo.efl),
            'bfl': max(abs(v - ynu.bfl) / abs(ynu.bfl) for v in fo.bfl)}


def fisheye_ladder(device):
    """The fish-eye (``sample_rx.fisheye_system``, real aiming) launched at FISHEYE_DEG
    on ``Sampling.hex(FISHEYE_RINGS)`` in f64 on ``device``: (P, S, the rays aimed, the
    ladder's rungs, host wall seconds)."""
    import importlib
    import numpy as np
    from prysm_tpu_torch.conf import device_as, precision_as
    from prysm_tpu_torch.x.raytracing import Field, Sampling, launch, sample_rx
    tlaunch = importlib.import_module('prysm_tpu_torch.x.raytracing.launch')
    inner, rungs = tlaunch._parabasal_ep_z, []

    def counted(system, field, wvl):
        rungs.append(field.hy)
        return inner(system, field, wvl)

    tlaunch._parabasal_ep_z = counted
    try:
        with precision_as(torch.float64), device_as(device):
            system = sample_rx.fisheye_system()
            system.ray_aiming = 'real'
            t0 = time.perf_counter()
            P, S = launch(system, Field(0.0, FISHEYE_DEG, unit='deg'), system.wavelength(),
                          Sampling.hex(FISHEYE_RINGS))
            wall = time.perf_counter() - t0
    finally:
        tlaunch._parabasal_ep_z = inner
    return P, S, np.isfinite(S).all(axis=1), len(rungs), wall


def phase_lens_analysis(dev, pieces):
    """The lens-analysis path in f32 through its entry point, against f64 on the card from
    the same launches (the f64 rendering through the mode stack: the kernel computes in
    f32); the f64 sensitivities against forward tangents and central differences;
    ``first_order`` on axis against the paraxial walk; the fish-eye's ladder on the card
    against the same launch on the CPU.  ``pieces``: the launches of the Zernike forward
    that the 36-mode plan takes (phase 2).  Returns what phase 4 times."""
    import numpy as np
    from prysm_tpu_torch.steps import CFG6_RINGS, build_lens_analysis

    want = {'zernike_fwd': 3 * pieces, 'zernike_bwd_coefs': 0, 'zernike_bwd_all': 0,
            'noise_expose': 0}
    t0 = time.perf_counter()
    la32 = build_lens_analysis(N=N, fN=FN, device=dev)
    la64 = build_lens_analysis(N=N, fN=FN, fused=False, dtype=torch.float64, device=dev)
    plan_s = time.perf_counter() - t0
    rays = 3 * (3 * CFG6_RINGS * (CFG6_RINGS + 1) + 1)
    require(la32.P.shape == (rays, 3) and np.array_equal(la32.P, la64.P)
            and np.array_equal(la32.S, la64.S) and bool(np.isfinite(la32.S).all()),
            'lens analysis: the f32 and f64 plans launched other bundles, or lost rays')
    reset_launches()
    coefs, rms, psfs, grads, values = synced(la32)
    launches = launch_counts()
    print(f'  launches per lens-analysis call: {json.dumps(launches)}', flush=True)
    require(launches == want, f'the lens-analysis call did not launch {want}: {launches}')
    require(coefs.shape == (1, 3, 36) and rms.shape == (1, 3) and psfs.shape == (3, FN, FN)
            and grads.shape == (2, 5) and coefs.dtype == psfs.dtype == torch.float32
            and bool(torch.isfinite(coefs).all()) and bool(torch.isfinite(psfs).all())
            and bool(np.isfinite(grads).all()), 'lens analysis: outputs')
    same = lens_same_coefficients(la32, coefs, FN)
    q32, q64 = lens_quantities(la32), lens_quantities(la64)
    require(bool(np.array_equal(q32['status'], q64['status']))
            and bool((q64['status'].imag == 0).all()),
            'lens analysis: a ray fails, or the f32 and f64 traces end with other statuses')
    err = lens_errors(q32, q64)
    f64 = lens_f64_checks(la64)
    # the PSFs end to end carry the coefficients' float32 error (the JAX package's 3.9e-2
    # of peak on the CPU, the port's 7.3e-2): printed, held by the checks above instead
    print(f'  PSFs end to end, f32 vs f64: {err["psfs"]:.3e} of peak', flush=True)
    print(f'  lens analysis: {rays} rays, planned in {plan_s:.1f} s (real aiming, f64, both '
          f'precisions); XP z {q64["xp_z"]:.6f} mm; residual RMS f64 '
          f'{[f"{float(v):.3e}" for v in q64["rms"][0]]} mm, f32 '
          f'{[f"{float(v):.3e}" for v in q32["rms"][0]]} mm; d(RMS spot, OPL spread)/d(c1, '
          f'c2, c3, t1, t2) f64 {np.array2string(q64["grads"], precision=5)}; truncation '
          f'of the central difference (h = {LENS_FD_STEP:g}) {f64["truncation"]:.2e}; EFL '
          f'at each field f64 {q64["first_order"][:, 0].tolist()}', flush=True)

    cpu = fisheye_ladder('cpu')
    card_run = fisheye_ladder(dev)
    lost = cpu[2] & ~card_run[2]
    print(f'  fish-eye at {FISHEYE_DEG:g} deg, hex({FISHEYE_RINGS}): {int(card_run[2].sum())} '
          f'of {card_run[2].size} rays aimed on the card, {int(cpu[2].sum())} on the CPU; '
          f'{card_run[3]} ladder rungs on the card, {cpu[3]} on the CPU; host wall '
          f'{card_run[4]:.2f} s (card), {cpu[4]:.2f} s (CPU); launch card vs CPU '
          f'{float(np.nanmax(np.abs(card_run[1] - cpu[1]))):.2e}', flush=True)
    require(card_run[3] > 0, 'the fish-eye launch did not reach the continuation ladder')
    require(not lost.any(), f'the card loses {int(lost.sum())} rays that the CPU aims')

    bars = LENS_F32_BARS
    run_checks([
        ('landing points vs f64 (mm)', err['landing'], bars['landing']),
        ('total OPL vs f64 (rel to max |OPL|)', err['opl'], bars['opl']),
        ('exit-pupil z vs f64 (rel)', err['xp_z'], bars['xp_z']),
        ('fitted coefficients vs f64 (rel to max |c|)', err['coefs'], bars['coefs']),
        ('residual RMS vs f64 (mm)', err['rms'], bars['rms']),
        ('OPD from the f32 coefficients, fused vs f64 stack', same['opd'], bars['opd']),
        ('PSF from them, f32 MDFT products (peak rel)', same['psf'], bars['psf']),
        ('PSF from them, the step\'s TF32 plan (peak rel)', same['psf_plan'], bars['psf_plan']),
        ('adjoint sensitivities vs f64 (rel, per head)', err['grads'], bars['grads']),
        ('first_order at each field vs f64 (rel)', err['first_order'], bars['first_order']),
        ('Seidel sums vs f64 (rel)', err['seidel'], bars['seidel']),
        ('distortion vs f64 (percent points)', err['distortion'], bars['distortion']),
        ('field curvature vs f64 (mm)', err['field_curvature'], bars['field_curvature']),
        ('spot diagrams vs f64 (mm)', err['spots'], bars['spots']),
        ('OPD fans vs f64 (rel)', err['opd_fans'], bars['opd_fans']),
        ('full-field RMS WFE vs f64 (rel)', err['full_field'], bars['full_field']),
        ('verbs\' rays f32 aiming loses (count)', err['lost'], bars['lost']),
        ('f64 sensitivities vs forward tangents (rel)', f64['forward'], 1e-6),
        ('f64 sensitivities vs central differences (rel)', f64['fd'], LENS_FD_BAR),
        ('f64 first_order on axis vs paraxial EFL (rel)', f64['efl'], 1e-9),
        ('f64 first_order on axis vs paraxial BFL (rel)', f64['bfl'], 1e-9),
    ], width=60)
    return la32, card_run[4]


def lens_timing(smi, la32, fisheye_s):
    """Phase 4's lines for the lens-analysis path: the call and the sensitivities alone
    (wall, device ms, busy share, device kernels, hand-written launches per call),
    ``first_order`` at one field and the fish-eye's ladder launch on the host clock."""
    from prysm_tpu_torch.x.raytracing.parabasal import first_order
    timed_lines(smi, {'lens_analysis': la32, 'lens_sensitivity': la32.sensitivities},
                runs=10, warmup=2, steps=3)
    host = []
    with la32.configured():
        for _ in range(5):
            t0 = time.perf_counter()
            first_order(la32.system, field=2)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
    print(f'{smi} | lens_first_order_ms {statistics.median(host):.4f} (host wall, field 2, '
          f'real-aimed chief, 4 tangent sweeps); fisheye_ladder_launch_ms '
          f'{fisheye_s * 1e3:.4f} (host wall, one launch at {FISHEYE_DEG:g} deg, '
          f'hex({FISHEYE_RINGS}), f64)', flush=True)


def design_cpu_reference():
    """The f64 designer's optimisation on the host's CPU, run in a worker process: the
    prescription read back and DESIGN_CPU_ITERATES damped-least-squares iterations from
    the same start as the card's; their iterates and costs."""
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    from prysm_tpu_torch.steps import build_lens_design
    design = build_lens_design(dtype=torch.float64, device='cpu')
    design.prescription()
    t0 = time.perf_counter()
    res, _ = design.optimise(DESIGN_CPU_ITERATES)
    return {'iterates': [h['x'] for h in res.history], 'costs': [h['cost'] for h in res.history],
            'seconds': time.perf_counter() - t0}


def count_fd_rows(problem):
    """A list that collects the operand rows that ``problem``'s 'auto' residual Jacobian
    central-differences from now on (``Problem._fd_fill``): the JAX package's fallback,
    kept by the port, for an operand with no reverse-mode head and for one whose
    forward-mode row raises.  Every operand of phase 3o has an engine, so the list must
    stay empty: a wavefront row that fell back would otherwise pass the check against
    central differences unseen."""
    rows = []
    fill = problem._fd_fill

    def counted(J, which, x, step):
        rows.extend(which)
        return fill(J, which, x, step)

    problem._fd_fill = counted
    return rows


def design_start(design):
    """What phase 3o compares across precisions at the start, from the design plan
    ``design`` in its dtype on its device: the prescription read back, its residuals and
    'auto' residual Jacobian (host float64), and the Jacobian's central-differenced rows
    (``count_fd_rows``)."""
    design.prescription()
    problem = design.problem()
    fd_rows = count_fd_rows(problem)
    x0 = problem.x0()
    with design.configured():
        return {'r': problem.residuals(x0), 'J': problem.residual_jacobian(x0),
                'fd_rows': fd_rows}


def design_diffraction(design, x):
    """What phase 3o compares after the optimisation: with the plan's lens at ``x`` (the
    optimised free vector), each field's pupil field (host samples), its OPD and PSF, and
    the edge bundle's PRT Jones matrices (host numpy)."""
    import numpy as np
    design.system.opt.update(x)
    fields, psfs, prt = design.diffraction()
    return {'fields': fields, 'opd': [np.asarray(pf.opd, float) for pf in fields],
            'psfs': [np.asarray(p, float) for p, _ in psfs], 'jones': prt.P_matrix}


def design_diffraction_cpu(x):
    """design_diffraction in f64 on the CPU, at the card's sizes, with the lens at x."""
    from prysm_tpu_torch.steps import build_lens_design
    design = build_lens_design(dtype=torch.float64, device='cpu')
    design.prescription()
    return design_diffraction(design, x)


def design_refocus(design, fields):
    """``pupil_field_psf`` of the pupil fields ``fields`` (host samples) in the plan's
    dtype on its device: the resampling (host float64) and the focus alone, so that two
    precisions or two devices are compared on the same samples."""
    import numpy as np
    from prysm_tpu_torch.steps import DESIGN_Q
    from prysm_tpu_torch.x.raytracing import pupil_field_psf
    with design.configured():
        return [np.asarray(pupil_field_psf(pf, npix=design.npix, Q=DESIGN_Q)[0], float)
                for pf in fields]


def peak_errors(psfs, refs):
    """Each PSF's largest difference from its reference, relative to the reference's peak."""
    import numpy as np
    return [float(np.abs(a - b).max() / b.max()) for a, b in zip(psfs, refs)]


def design_errors(q, ref):
    """Phase 3o's float32 errors of ``q`` against ``ref`` (design_start's and
    design_diffraction's outputs together): the
    residuals relative to the largest; the Jacobian operand by operand (row by row)
    relative to each row's largest, and column by column ('jacobian_columns', printed:
    the glass-thickness columns carry the launch tangents' central difference of a
    float32 paraxial recipe, in both packages); the pupil-field OPD in um, the worst
    field; each field's PSF relative to its peak
    (the worst of the fields off axis, and on axis apart: there the sine-space samples
    form a symmetric grid that SciPy's Delaunay triangulation splits by rounding); the
    Jones matrices absolute."""
    import numpy as np
    J, Jr = np.asarray(q['J'], float), np.asarray(ref['J'], float)
    psf = peak_errors(q['psfs'], ref['psfs'])
    return {'opd': max(float(np.abs(a - b).max()) for a, b in zip(q['opd'], ref['opd'])),
            'residuals': float(np.abs(q['r'] - ref['r']).max() / np.abs(ref['r']).max()),
            'jacobian': float((np.abs(J - Jr).max(axis=1) / np.abs(Jr).max(axis=1)).max()),
            'jacobian_columns': float((np.abs(J - Jr).max(axis=0)
                                       / np.abs(Jr).max(axis=0)).max()),
            'psf_axis': psf[0], 'psf': max(psf[1:]),
            'jones': float(np.abs(np.asarray(q['jones']) - ref['jones']).max())}


def design_fd_jacobian(problem, x, h):
    """Central differences of the weighted residuals (``problem.residuals``) at steps h and
    2h (each times max(1, |x_k|); h is the DLS's 1e-6), Richardson-extrapolated: at h
    alone the curvature columns' truncation is 5e-6 of their largest entry, at h / 10 the
    wavefront row's rounding (its OPD is a difference of 100 mm paths) is 3e-6 of the
    thickness columns.  The lens is left at x."""
    import numpy as np

    def central(step):
        J = np.zeros((len(problem.operands), x.size))
        for k in range(x.size):
            d = step * max(1.0, abs(x[k]))
            hi, lo = x.copy(), x.copy()
            hi[k], lo[k] = x[k] + d, x[k] - d
            J[:, k] = (problem.residuals(hi) - problem.residuals(lo)) / (2 * d)
        return J

    J = (4 * central(h) - central(2 * h)) / 3
    problem.residuals(x)
    return J


def design_io(design, from_zmx, from_seq):
    """(zmx vs seq, read vs the written digits, read vs cfg6 unrounded) max landing-point
    differences in mm of the edge field's bundle, traced in the plan's dtype on its
    device: the written digits are the design system with each curvature rounded to the
    writers' 6 significant digits (``format(c, 'g')``)."""
    import numpy as np
    from prysm_tpu_torch.steps import WVL, cfg6_design_system
    from prysm_tpu_torch.x.raytracing import raytrace
    from prysm_tpu_torch.x.raytracing.spencer_and_murty import to_host
    exact, digits = cfg6_design_system(), cfg6_design_system()
    digits.opt.vary('curvature')
    digits.opt.update([float(format(c, 'g')) for c in digits.opt.pack()])
    P, S = design.bundle(len(design.system.fields) - 1)
    with design.configured():
        land = [to_host(raytrace(s.to_surfaces(), P, S, WVL).P[-1])
                for s in (from_zmx, from_seq, digits, exact)]
    return tuple(float(np.abs(land[0] - other).max()) for other in land[1:])


def design_monte_carlo_cpu(x, trials):
    """The first ``trials`` Monte Carlo merits of the tolerancing step with the lens at x,
    f64 on the CPU (the same seed, so the card's first ``trials`` draws)."""
    from prysm_tpu_torch.steps import DESIGN_MC_SEED, build_lens_design
    design = build_lens_design(dtype=torch.float64, device='cpu')
    design.prescription()
    design.system.opt.update(x)
    merit = design.spot_merit(*design.bundle(len(design.system.fields) - 1))
    with design.configured():
        return design.system.tol.monte_carlo(design.perturbations(), merit, trials,
                                             seed=DESIGN_MC_SEED).merits


def reset_launches():
    """Set every hand-written kernel's launch count to 0."""
    from prysm_tpu_torch.ops import noise
    from prysm_tpu_torch.ops import zernike as zk
    zk.reset_launches()
    noise.reset_launches()


def launch_counts():
    """Every hand-written kernel's launches since the last reset, by name."""
    from prysm_tpu_torch.ops import noise
    from prysm_tpu_torch.ops import zernike as zk
    return {**zk.LAUNCHES, **noise.LAUNCHES}


def launch_total():
    """The hand-written kernels' launches since the last reset."""
    return sum(launch_counts().values())


def phase_lens_design(dev, design_ref, pieces, N=N, FN=FN):
    """The lens designer's path through its entry point (``steps.build_lens_design``), f64
    on the card (f32 beside it where the checks compare precisions), each step with every
    launch count set to 0 before it and read after: the prescription's IO round trip;
    the 'auto' Jacobian at the start against central differences (with the rows it
    central-differenced counted, at the start and through the solve), f32 against f64,
    and the optimisation's first iterates against the CPU's (``design_ref``, the worker's);
    the tolerancing's sensitivity table against the adjoint, its wavefront differential
    against central differences and its Monte Carlo against the CPU's; the diffraction
    in f32 against f64 (end to end, and the focus alone on the f64 samples) and in f64
    against the CPU's; one lens-analysis call on the optimised lens (``pieces``: the
    Zernike forward's launches a field).  Returns what phase 4 times."""
    import numpy as np
    from prysm_tpu_torch.steps import DESIGN_SOLVE, WVL, build_lens_design
    from prysm_tpu_torch.x.raytracing import effective_focal_length
    from prysm_tpu_torch.x.raytracing.adjoint import RmsSpotHead

    t0 = time.perf_counter()
    d64 = build_lens_design(dtype=torch.float64, device=dev)
    d32 = build_lens_design(dtype=torch.float32, device=dev)
    seconds = {}

    print('  step 1: prescription (write_zmx / write_seq, read back)', flush=True)
    reset_launches()
    zmx, seq, from_zmx, from_seq = d64.prescription()
    io = design_io(d64, from_zmx, from_seq)
    no_kernel_launches('prescription')

    print('  step 2: optimisation (DLS, gradient=\'auto\')', flush=True)
    reset_launches()
    problem = d64.problem()
    fd_rows = count_fd_rows(problem)
    x0 = problem.x0()
    with d64.configured():
        merit0 = problem.merit(x0)
        r64, J64 = problem.residuals(x0), problem.residual_jacobian(x0)
        fd = design_fd_jacobian(problem, x0, DESIGN_FD_STEP)
    q32 = design_start(d32)
    t1 = time.perf_counter()
    res, problem = d64.optimise(problem=problem)
    seconds['solve'] = time.perf_counter() - t1
    with d64.configured():
        efl = float(effective_focal_length(d64.system.to_surfaces(), wvl=WVL))
        merit = problem.merit(res.x)
    no_kernel_launches('optimisation')
    cpu = design_ref.get()
    card_iterates = [h['x'] for h in res.history[:DESIGN_CPU_ITERATES]]
    iterate_err = max(float(np.abs(a - b).max() / np.abs(b).max())
                      for a, b in zip(card_iterates, cpu['iterates']))
    require(len(cpu['iterates']) == DESIGN_CPU_ITERATES == len(card_iterates),
            'the CPU or the card took fewer DLS iterations than compared')

    print('  step 3: tolerancing (sensitivity table, Monte Carlo, wavefront differential)',
          flush=True)
    reset_launches()
    t1 = time.perf_counter()
    tol = d64.tolerance()
    seconds['tolerance'] = time.perf_counter() - t1
    edge = len(d64.system.fields) - 1
    P2, S2 = d64.bundle(edge)
    P0, S0 = d64.bundle(0)
    merit_fn = d64.spot_merit(P2, S2)
    perts = d64.perturbations()
    with d64.configured():
        half = d64.system.tol.sensitivity(d64.perturbations(0.5), merit_fn).sensitivities()
        exact = d64.system.tol.adjoint_sensitivity(perts, [RmsSpotHead()], P2, S2).jacobian[0]
        tangent = d64.system.tol.wavefront(perts, P0, S0, WVL).dW
        central = d64.system.tol.wavefront(perts, P0, S0, WVL, method='fd').dW
    no_kernel_launches('tolerancing')
    table = tol.table.sensitivities()
    floor = 1e-9 * np.abs(exact).max()
    trunc = float((np.abs(table - exact) / (4 / 3 * np.abs(table - half) + floor)).max())
    wd_err = float((np.abs(tangent - central).max(axis=0) / np.abs(central).max(axis=0)).max())
    mc_cpu = design_monte_carlo_cpu(res.x, DESIGN_CPU_TRIALS)
    mc_err = float(np.abs(tol.monte_carlo.merits[:DESIGN_CPU_TRIALS] - mc_cpu).max()
                   / np.abs(mc_cpu).max())

    print('  step 4: diffraction (pupil fields and PSFs, f32 and f64, the CPU\'s; PRT)',
          flush=True)
    reset_launches()
    t1 = time.perf_counter()
    q64 = {'r': r64, 'J': J64, **design_diffraction(d64, res.x)}
    seconds['diffraction'] = time.perf_counter() - t1
    q32.update(design_diffraction(d32, res.x))
    focus32 = peak_errors(design_refocus(d32, q64['fields']), q64['psfs'])
    cpu64 = design_diffraction_cpu(res.x)
    same64 = peak_errors(design_refocus(d64, cpu64['fields']), cpu64['psfs'])
    no_kernel_launches('diffraction')
    err = design_errors(q32, q64)
    card64 = {'opd': max(float(np.abs(a - b).max()) for a, b in zip(q64['opd'], cpu64['opd'])),
              'psf': peak_errors(q64['psfs'], cpu64['psfs']),
              'jones': float(np.abs(np.asarray(q64['jones']) - cpu64['jones']).max())}

    print('  step 5: analysis (build_lens_analysis on the optimised lens, f32)', flush=True)
    d32.system.opt.update(res.x)
    reset_launches()
    t1 = time.perf_counter()
    _, (coefs, rms, psfs, grads, values) = d32.analysis(N, FN)
    torch.cuda.synchronize()
    seconds['analysis'] = time.perf_counter() - t1
    launches = launch_counts()
    want = {'zernike_fwd': 3 * pieces, 'zernike_bwd_coefs': 0, 'zernike_bwd_all': 0,
            'noise_expose': 0}
    print(f'  launches in the analysis step: {json.dumps(launches)}', flush=True)
    require(launches == want, f'the analysis step did not launch {want}: {launches}')
    require(coefs.shape == (1, 3, 36) and psfs.shape == (3, FN, FN)
            and bool(torch.isfinite(coefs).all()) and bool(torch.isfinite(psfs).all())
            and bool(np.isfinite(grads).all()), 'the analysis step\'s outputs')
    finite = (all(np.isfinite(p).all() for p in q64['psfs'])
              and np.isfinite(tol.monte_carlo.merits).all()
              and np.isfinite(tol.fast_monte_carlo.merits).all()
              and np.isfinite(tol.compensator_motions).all())
    require(finite and res.nit == DESIGN_SOLVE['maxiter'], 'design outputs')
    print(f'  f32 auto Jacobian vs f64, column by column (not held): '
          f'{err["jacobian_columns"]:.3e}; f64 PSF on axis, card vs CPU end to end (not '
          f'held: the samples\' Delaunay ties) {card64["psf"][0]:.3e}; f32 focus of the f64 '
          f'pupil fields by field {", ".join(f"{e:.3e}" for e in focus32)}', flush=True)

    print(f'  design: {len(P2)} rays a field; merit {merit0:.6e} -> {merit:.6e} in {res.nit} '
          f'iterations ({res.nfev} evaluations, {seconds["solve"]:.1f} s; the CPU\'s '
          f'{DESIGN_CPU_ITERATES} took {cpu["seconds"]:.1f} s); x {np.array2string(res.x, precision=8)}; '
          f'EFL {efl:.9f} (held {problem.equality_constraints[0].target:.9f}); expected RMS '
          f'{tol.expected_rms:.4e} mm, nominal {tol.differential.rms_nominal:.4e}; Monte Carlo '
          f'mean {tol.monte_carlo.summary()["mean"]:.4e} mm, fast {tol.fast_monte_carlo.summary()["mean"]:.4e} '
          f'mm; compensator motions {np.array2string(tol.compensator_motions, precision=4)}; '
          f'IO: the read lens vs cfg6 unrounded {io[2]:.3e} mm; seconds {json.dumps({k: round(v, 2) for k, v in seconds.items()})}; '
          f'the phase {time.perf_counter() - t0:.1f} s', flush=True)
    bars = DESIGN_BARS
    run_checks([
        ('IO: .zmx read vs .seq read, landing (mm, f64)', io[0], bars['io']),
        ('IO: read vs the written digits, landing (mm, f64)', io[1], bars['io']),
        ('IO: read vs cfg6 unrounded, landing (mm, f64)', io[2], bars['io_digits']),
        ('f64 auto Jacobian vs central differences (per column)',
         float((np.abs(J64 - fd).max(axis=0) / np.abs(J64).max(axis=0)).max()), bars['fd']),
        ('auto Jacobian rows central-differenced (start, solve, f32)',
         len(fd_rows) + len(q32['fd_rows']), 0),
        ('f32 residuals vs f64 at the start (rel)', err['residuals'], bars['residuals']),
        ('f32 auto Jacobian vs f64 at the start (per operand)', err['jacobian'],
         bars['jacobian']),
        (f'f64 DLS iterates 1-{DESIGN_CPU_ITERATES}, card vs CPU (rel)', iterate_err,
         bars['iterates']),
        ('EFL held by the optimisation (rel)', abs(efl - problem.equality_constraints[0].target)
         / abs(efl), bars['efl']),
        ('merit lowered (final / start - 1)', merit / merit0 - 1, 0.0),
        ('sensitivity table vs adjoint (over its truncation est.)', trunc, 1.5),
        ('wavefront differential, tangent vs FD (per column)', wd_err, bars['wd_fd']),
        (f'Monte Carlo merits 1-{DESIGN_CPU_TRIALS}, card vs CPU (rel)', mc_err, bars['mc']),
        ('f32 pupil-field OPD vs f64 (um)', err['opd'], bars['opd']),
        ('f32 pupil-field PSFs off axis vs f64 (peak rel)', err['psf'], bars['psf']),
        ('f32 pupil-field PSF on axis vs f64 (peak rel)', err['psf_axis'], bars['psf_axis']),
        ('f32 PRT Jones matrices vs f64 (abs)', err['jones'], bars['jones']),
        ('f32 focus of f64 pupil fields vs f64 (peak rel, all fields)', max(focus32),
         bars['psf_focus']),
        ('f64 pupil-field OPD, card vs CPU (um)', card64['opd'], bars['opd64']),
        ('f64 PSFs off axis, card vs CPU (peak rel)', max(card64['psf'][1:]), bars['psf64']),
        ('f64 focus of the CPU\'s pupil fields, card vs CPU (peak rel)', max(same64),
         bars['focus64']),
        ('f64 PRT Jones matrices, card vs CPU (abs)', card64['jones'], bars['jones64']),
    ], width=60)
    return d64, problem, res, perts, (P0, S0), merit_fn, seconds


def design_timing_lines(smi, design, problem, res, perts, bundle0, merit_fn, seconds):
    """Phase 4's lines for the lens designer's path, f64 on the card, each with the card:
    one DLS iteration's linearisation (the residuals and the 'auto' Jacobian at the
    optimised lens: wall, device ms, busy share, device kernels, hand-written launches),
    the wavefront differential of the on-axis bundle and one pupil field with its PSF
    (the same), a Monte Carlo trial on the host's clock (median of 10), and the whole
    solve, tolerancing and diffraction steps of phase 3o on the host's clock."""
    import numpy as np
    from prysm_tpu_torch.steps import DESIGN_Q, WVL
    from prysm_tpu_torch.x.raytracing import pupil_field, pupil_field_psf
    system = design.system
    edge = system.field(len(system.fields) - 1)

    def iteration():
        return problem.residuals(res.x), problem.residual_jacobian(res.x)

    def differential():
        return system.tol.wavefront(perts, *bundle0, WVL)

    def psf():
        return pupil_field_psf(pupil_field(system, edge, WVL, npupil=design.npupil),
                               npix=design.npix, Q=DESIGN_Q)

    with design.configured():
        timed_lines(smi, {'design_dls_iteration': iteration,
                          'design_wavefront_differential': differential,
                          'design_pupil_field_psf': psf}, runs=5, warmup=1, steps=2)
        rng = np.random.default_rng(0)
        trials = []
        try:
            for _ in range(10):
                t0 = time.perf_counter()
                for p in perts:
                    p.set(p.sample(rng))
                merit_fn(system)
                torch.cuda.synchronize()
                trials.append((time.perf_counter() - t0) * 1e3)
        finally:
            for p in perts:
                p.reset()
    print(f'{smi} | design_monte_carlo_trial_ms {statistics.median(trials):.4f} (host wall, '
          f'6 perturbations set and one spot merit traced, 12,481 rays, f64); phase 3o host '
          f'wall: the solve ({res.nit} iterations, {res.nfev} evaluations) '
          f'{seconds["solve"] * 1e3:.1f} ms, tolerancing {seconds["tolerance"] * 1e3:.1f} ms, '
          f'diffraction (3 fields) {seconds["diffraction"] * 1e3:.1f} ms, analysis (planned '
          f'and called) {seconds["analysis"] * 1e3:.1f} ms', flush=True)


# ---------------------------------------------------------------------------
# phase 3q: the five examples, the port's user entry points
# ---------------------------------------------------------------------------

def examples_run(dev, dtype):
    """Each example (``prysm_tpu_torch.examples``) at its default size on ``dev`` in
    ``dtype``: its ``main``'s result and wall time, and what phase 3q compares besides:
    the LOWFS reconstructor and frame, the dark energy and its gradient at zero, the first
    optimizer iterates of the dark hole, the retrieval, the lens solve and the coating
    refinement, the lens's start merit, solved EFL and tolerances, and the coating's start
    reflectance and refined merit.  Host numpy and floats."""
    import numpy as np
    from prysm_tpu_torch.conf import device_as, precision_as
    from prysm_tpu_torch.examples import (coating_design, coronagraph_dark_hole, lens_design,
                                          lowfs_realtime, phase_retrieval)
    from prysm_tpu_torch.x import optym
    from prysm_tpu_torch.x import raytracing as rt
    from prysm_tpu_torch.x.optym.problem import to_host
    from prysm_tpu_torch.x.raytracing.design import _TraceCache

    def first_iterates(fg, x0):
        res = optym.run_until(optym.PrysmLBFGSB(fg, x0), optym.MaxIterations(EXAMPLE_ITERATES))
        return [to_host(r.x_next) for r in res.records]

    out, walls = {}, {}

    def main_of(name, module):
        t0 = time.perf_counter()
        value = module.main(device=dev)
        if torch.device(dev).type == 'cuda':
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return value

    with precision_as(dtype), device_as(dev):
        out['lowfs'] = main_of('lowfs', lowfs_realtime)
        R, I0 = lowfs_realtime.reconstructor(lowfs_realtime.build(device=dev))
        out['R'], out['I0'] = to_host(R), to_host(I0)

        out['suppression'] = main_of('dark_hole', coronagraph_dark_hole)
        _, fg, _, nms = coronagraph_dark_hole.dark_hole(device=dev)
        zeros = torch.zeros(len(nms), dtype=dtype, device=dev)
        e0, g0 = fg(zeros)
        out['e0'], out['g0'] = float(e0), to_host(g0)
        out['dark_iterates'] = first_iterates(fg, zeros)

        out['retrieval'] = float(main_of('retrieval', phase_retrieval))
        fg, truth, _ = phase_retrieval.retrieval(device=dev)
        out['retrieval_iterates'] = first_iterates(fg, torch.zeros_like(truth))

        system = main_of('lens', lens_design)
        out['efl'] = float(rt.EFL()(system, _TraceCache(system)))
        system = lens_design.doublet()
        _, out['m0'], res = lens_design.optimize(system)
        out['lens_iterates'] = [np.asarray(h['x'], np.float64)
                                for h in res.history[:EXAMPLE_ITERATES]]
        out['tol'] = np.asarray(lens_design.tolerances(system)[1], np.float64)

        out['R1'] = float(main_of('coating', coating_design))
        out['R0'] = float(coating_design.band_reflectance(coating_design.v_coat()))
        res = coating_design.refine(coating_design.v_coat())
        out['coating_merit'] = res.merit
        out['coating_iterates'] = [to_host(r.x_next)
                                   for r in res.optimizer_result.records[:EXAMPLE_ITERATES]]
    out['walls'] = walls
    return out


def examples_cpu_reference():
    """The five examples in f64 on the host's CPU, run in a worker process (their prints
    kept out of the script's output): what phase 3q holds the card's f64 runs to."""
    import contextlib
    import io
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    with contextlib.redirect_stdout(io.StringIO()):
        return examples_run('cpu', torch.float64)


def example_figures(f32, f64):
    """An f32 run's figures against the f64 run of the same package, by EXAMPLE_JAX_F32's
    names (``probes/examples_cpu_probe.py`` computes the JAX package's the same way)."""
    return {
        'lowfs_error': f32['lowfs'],
        'lowfs_R': np_rel(f32['R'], f64['R']),
        'lowfs_I0': np_rel(f32['I0'], f64['I0']),
        'dark_e0': np_rel(f32['e0'], f64['e0']),
        'dark_g0': np_rel(f32['g0'], f64['g0']),
        'dark_suppression': abs(f32['suppression'] / f64['suppression'] - 1),
        'retrieval_error': f32['retrieval'],
        'lens_m0': np_rel(f32['m0'], f64['m0']),
        'lens_efl': abs(f32['efl'] - 100.0),
        'lens_tol': np_rel(f32['tol'][EXAMPLE_CURVATURES], f64['tol'][EXAMPLE_CURVATURES]),
        'coating_R0': np_rel(f32['R0'], f64['R0']),
        'coating_merit': np_rel(f32['coating_merit'], f64['coating_merit']),
    }


def phase_examples(dev, cpu_ref):
    """The five examples on the card at their default sizes, f32 and f64: the f64 runs
    against the examples' marks and against the same runs on the CPU (the worker's), the
    f32 runs against the marks and against f64 at twice the JAX package's f32 figures."""
    t0 = time.perf_counter()
    runs = {}
    for dtype in (torch.float32, torch.float64):
        print(f'  {str(dtype)[6:]}:', flush=True)
        runs[dtype] = examples_run(dev, dtype)
    r32, r64 = runs[torch.float32], runs[torch.float64]
    cpu = cpu_ref.get(timeout=600)
    for dtype, run in runs.items():
        print(f'  {str(dtype)[6:]} mains (host wall s): '
              + ', '.join(f'{k} {v:.2f}' for k, v in run['walls'].items()), flush=True)
    print(f'  the CPU reference (f64, worker) mains (host wall s): '
          + ', '.join(f'{k} {v:.2f}' for k, v in cpu['walls'].items()), flush=True)
    checks = []
    for tag, run in (('f64', r64), ('f32', r32)):
        checks += [
            (f'LOWFS worst error {tag} (nm, mark)', run['lowfs'], EXAMPLE_MARKS['lowfs']),
            (f'dark hole 1 / suppression {tag} (mark 1/50)', 1 / run['suppression'],
             1 / EXAMPLE_MARKS['suppression']),
            (f'retrieval error {tag} (nm, mark)', run['retrieval'], EXAMPLE_MARKS['retrieval']),
            (f'lens |EFL - 100| {tag} (mm, mark)', abs(run['efl'] - 100.0),
             EXAMPLE_MARKS['efl']),
            (f'coating band R {tag} (mark)', run['R1'], EXAMPLE_MARKS['R']),
        ]
    iterates = EXAMPLE_CARD_CPU_BAR
    checks += [
        ('f64 card vs CPU: LOWFS R (rel)', np_rel(r64['R'], cpu['R']), iterates),
        ('f64 card vs CPU: LOWFS I0 (rel)', np_rel(r64['I0'], cpu['I0']), iterates),
        ('f64 card vs CPU: LOWFS worst error (rel)', np_rel(r64['lowfs'], cpu['lowfs']),
         iterates),
        ('f64 card vs CPU: dark energy at zero (rel)', np_rel(r64['e0'], cpu['e0']), iterates),
        ('f64 card vs CPU: its gradient (rel)', np_rel(r64['g0'], cpu['g0']), iterates),
        (f'f64 card vs CPU: dark hole iterates 1-{EXAMPLE_ITERATES} (rel)',
         np_rel(r64['dark_iterates'], cpu['dark_iterates']), iterates),
        (f'f64 card vs CPU: retrieval iterates 1-{EXAMPLE_ITERATES} (rel)',
         np_rel(r64['retrieval_iterates'], cpu['retrieval_iterates']), iterates),
        ('f64 card vs CPU: lens start merit (rel)', np_rel(r64['m0'], cpu['m0']), iterates),
        (f'f64 card vs CPU: lens DLS iterates 1-{EXAMPLE_ITERATES} (rel)',
         np_rel(r64['lens_iterates'], cpu['lens_iterates']), iterates),
        ('f64 card vs CPU: lens EFL (rel)', np_rel(r64['efl'], cpu['efl']), iterates),
        ('f64 card vs CPU: lens curvature tolerances (rel)',
         np_rel(r64['tol'][EXAMPLE_CURVATURES], cpu['tol'][EXAMPLE_CURVATURES]), iterates),
        ('f64 card vs CPU: coating start R (rel)', np_rel(r64['R0'], cpu['R0']), iterates),
        (f'f64 card vs CPU: coating iterates 1-{EXAMPLE_ITERATES} (rel)',
         np_rel(r64['coating_iterates'], cpu['coating_iterates']), iterates),
        ('f64 card vs CPU: coating refined merit (rel)',
         np_rel(r64['coating_merit'], cpu['coating_merit']), iterates),
    ]
    figures = example_figures(r32, r64)
    checks += [(f'f32 vs f64 {name} (JAX f32 {EXAMPLE_JAX_F32[name]:.3g})', figures[name],
                EXAMPLE_BARS[name]) for name in EXAMPLE_JAX_F32]
    run_checks(checks, width=66)
    print(f'  lens decentre / tilt tolerances (the boresight head at the on-axis field, set '
          f'by the centroid\'s rounding; printed, not held): f64 {r64["tol"][3:]}, f32 '
          f'{r32["tol"][3:]}, CPU {cpu["tol"][3:]}', flush=True)
    print(f'  phase 3q took {time.perf_counter() - t0:.1f} s', flush=True)


def examples_timing(smi, dev):
    """Phase 4's lines for the examples in f32 at their default sizes: the LOWFS closed-loop
    frame (wall by the slope, frames/s, device ms, busy share, device kernels per frame),
    one dark-hole and one retrieval evaluation (value and gradient), and on the host clock
    the dark hole's 120 iterations, the retrieval example's run, the lens example's solve
    and the coating example's refine."""
    from prysm_tpu_torch.conf import device_as, precision_as
    from prysm_tpu_torch.examples import (coating_design, coronagraph_dark_hole, lens_design,
                                          lowfs_realtime, phase_retrieval)
    from prysm_tpu_torch.x import optym
    with precision_as(torch.float32), device_as(dev):
        setup = lowfs_realtime.build(device=dev)
        R, I0 = lowfs_realtime.reconstructor(setup)
        per_frame = lowfs_realtime.frame_seconds(setup, R, I0)
        c = torch.tensor([1.0, -0.5, 0.3, 0.2, -0.1, 0.4], device=dev)
        device_line(smi, f'lowfs_frame_us {per_frame * 1e6:.3f} (host wall, the slope of the '
                    f'best of 3 closed loops of 64 and 1024 frames); '
                    f'lowfs_frames_per_s {1 / per_frame:.1f}; device_ms_per_frame',
                    lambda: c + 1e-6 * lowfs_realtime.sense(
                        lowfs_realtime.render(c, **setup), R, I0),
                    per_frame * 1e3, steps=20, unit='frame')

        _, dark_fg, _, nms = coronagraph_dark_hole.dark_hole(device=dev)
        zeros = torch.zeros(len(nms), device=dev)
        retrieval_fg, truth, _ = phase_retrieval.retrieval(device=dev)
        timed_lines(smi, {'dark_hole_fg': lambda: dark_fg(zeros),
                          'retrieval_fg': lambda: retrieval_fg(torch.zeros_like(truth))},
                    runs=20, warmup=3, steps=5)

        def host_s(fn):
            t0 = time.perf_counter()
            out = synced(fn)
            return out, time.perf_counter() - t0

        opt = optym.PrysmLBFGSB(dark_fg, zeros)
        res, dark_s = host_s(lambda: optym.run_until(opt, optym.MaxIterations(120)))
        print(f'{smi} | dark_hole_run_s {dark_s:.3f} (host wall; {res.nit} iterations of at '
              f'most 120, {dark_s / max(res.nit, 1) * 1e3:.2f} ms an iteration, {opt.nfev} '
              f'evaluations)', flush=True)
        opt = optym.PrysmLBFGSB(retrieval_fg, torch.zeros_like(truth))
        res, retrieval_s = host_s(lambda: optym.run_until(opt, optym.AnyGovernor([
            optym.MaxIterations(60), optym.GradientTolerance(1e-12)])))
        (_, _, lens), lens_s = host_s(lambda: lens_design.optimize(lens_design.doublet()))
        coat, coat_s = host_s(lambda: coating_design.refine(coating_design.v_coat()))
        print(f'{smi} | retrieval_run_s {retrieval_s:.3f} ({res.nit} iterations, {opt.nfev} '
              f'evaluations); lens_solve_s {lens_s:.3f} ({lens.nit} DLS iterations, setup '
              f'included); coating_refine_s {coat_s:.3f} ({coat.nit} L-BFGS-B iterations) '
              f'(host wall, f32)', flush=True)


# ---------------------------------------------------------------------------
# phase 3r: the card tier, tests/test_torch_chip_*.py on the card
# ---------------------------------------------------------------------------

def phase_card_tier():
    """Run the card tier in a pytest process on the card; fail unless it exits 0 with every
    collected case passed (at least TIER_MIN_CASES) and none failed, errored or skipped, and
    unless it launched every kernel it tests.  Returns the kernels' launches in its run."""
    import glob
    import tempfile
    import xml.etree.ElementTree as ET
    root = os.path.dirname(os.path.abspath(__file__))
    files = sorted(glob.glob(os.path.join(root, 'tests', 'test_torch_chip_*.py')))
    require(len(files) == TIER_FILES, f'the card tier has {len(files)} files, not {TIER_FILES}')
    with tempfile.TemporaryDirectory() as tmp:
        report, log = os.path.join(tmp, 'tier.xml'), os.path.join(tmp, 'launches.jsonl')
        env = {**os.environ, 'PRYSM_TORCH_TIER_DEVICE': 'cuda',
               'PRYSM_TORCH_TIER_LAUNCHES': log}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, '-m', 'pytest', '--noconftest', '-p',
                               'no:cacheprovider', '-q', f'--junitxml={report}', *files],
                              cwd=root, env=env, capture_output=True, text=True,
                              timeout=TIER_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0 or not os.path.exists(report):
            print(proc.stdout[-6000:], proc.stderr[-3000:], sep='\n', flush=True)
        require(os.path.exists(report), f'the card tier wrote no report (exit {proc.returncode})')
        suite = ET.parse(report).getroot()
        suite = suite if suite.tag == 'testsuite' else suite.find('testsuite')
        counts = {k: int(suite.get(k, 0)) for k in ('tests', 'failures', 'errors', 'skipped')}
        launches = {}
        if os.path.exists(log):
            with open(log) as f:
                launches = json.loads(f.read().splitlines()[-1])
    passed = counts['tests'] - counts['failures'] - counts['errors'] - counts['skipped']
    print(f'  card tier: {passed} passed of {counts["tests"]} collected, {counts["failures"]} '
          f'failed, {counts["errors"]} errors, {counts["skipped"]} skipped, exit '
          f'{proc.returncode}, in {seconds:.1f} s; hand-written launches '
          f'{json.dumps(launches)}', flush=True)
    require(proc.returncode == 0, f'the card tier exited {proc.returncode}')
    require(counts['failures'] == counts['errors'] == counts['skipped'] == 0,
            f'the card tier did not pass whole: {counts}')
    require(passed == counts['tests'] >= TIER_MIN_CASES,
            f'the card tier passed {passed} of {counts["tests"]}, fewer than {TIER_MIN_CASES}')
    require(all(launches.get(k, 0) > 0 for k in ('zernike_fwd', 'zernike_bwd_all',
                                                  'noise_expose')),
            f'the card tier did not launch every kernel it tests: {launches}')
    return launches


# ---------------------------------------------------------------------------
# phase 3s: the port's docs on the card
# ---------------------------------------------------------------------------

def docs_run(dev, dtype, draws=None):
    """Every executed port doc (``prysm_tpu_torch.docs.EXECUTED``) on ``dev`` in ``dtype``,
    each in a fresh temporary working directory: its results (``docs.RESULTS``) on the host,
    its wall seconds, its hand-written launches, the drawing blocks skipped (no matplotlib),
    the error that stopped it, if any, and the random draws of the docs ``docs.REPLAYED``
    names, replayed from ``draws`` where given, else recorded."""
    import tempfile
    import traceback
    from prysm_tpu_torch import docs
    from prysm_tpu_torch.conf import device_as, precision_as
    run = {k: {} for k in ('values', 'walls', 'launches', 'skipped', 'errors', 'draws')}
    cuda = torch.device(dev).type == 'cuda'
    for doc in sorted(docs.EXECUTED):
        record = docs.Draws(draws.get(doc) if draws else None) \
            if doc in docs.REPLAYED else None
        reset_launches()
        with tempfile.TemporaryDirectory() as tmp, docs.in_directory(tmp), \
                precision_as(dtype), device_as(dev):
            t0 = time.perf_counter()
            try:
                ns = docs.run(doc, draws=record)
                if cuda:
                    torch.cuda.synchronize()
                run['values'][doc] = {name: docs.value(ns, name) for name in docs.RESULTS[doc]}
                run['skipped'][doc] = ns['__skipped__']
            except Exception as e:  # every doc runs; phase 3s fails after on any error
                run['errors'][doc] = f'{type(e).__name__}: {e}'[:1500]
                traceback.print_exc()
            run['walls'][doc] = time.perf_counter() - t0
        run['launches'][doc] = launch_counts()
        if record is not None and not record.replaying:
            run['draws'][doc] = record.recorded
    return run


def docs_cpu_reference():
    """The executed port docs in f64 on the host's CPU, run in a worker process (their
    prints kept out of the script's output): what phase 3s holds the card's f64 runs to,
    and the draws its runs replay."""
    import contextlib
    import io
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    with contextlib.redirect_stdout(io.StringIO()):
        return docs_run('cpu', torch.float64)


def phase_docs(dev, cpu_ref):
    """Every executed port doc on the card in f32 and in f64 (``docs_run``): f64 against the
    CPU's f64 run at EXAMPLE_CARD_CPU_BAR (or DOC_CARD_CPU_BARS), f32 against f64 at
    ``doc_f32_bar``, frames by their moments; the kernels of DOC_KERNELS launched in both
    precisions.  Prints one line a doc (its walls and worst errors) and the phase's total;
    fails after every doc has run, naming every check missed.  Returns the launches of the
    two card runs, summed by kernel."""
    from prysm_tpu_torch import docs
    t0 = time.perf_counter()
    cpu = cpu_ref.get(timeout=900)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        runs[dtype] = docs_run(dev, dtype, cpu['draws'])
    r32, r64 = runs[torch.float32], runs[torch.float64]
    failures = [f'{doc} on the {where}: {err}' for where, run in
                (('card, f32', r32), ('card, f64', r64), ('CPU', cpu))
                for doc, err in run['errors'].items()]
    for doc in sorted(docs.EXECUTED):
        short = doc.rsplit('/', 1)[-1][:-3]
        if any(doc in run['errors'] for run in (r32, r64, cpu)):
            print(f'  {short}: failed', flush=True)
            continue
        worst = dict.fromkeys(('f64 card vs CPU', 'f32 vs f64'), (0.0, ''))
        for name, tier in docs.RESULTS[doc].items():
            a32, a64, c64 = (run['values'][doc][name] for run in (r32, r64, cpu))
            if tier == 'noise':
                for tag, (x, y) in (('f64 card vs CPU', (a64, c64)), ('f32 vs f64', (a32, a64))):
                    dm, ds = docs.frame_moments(x, y)
                    if not (dm <= DOC_NOISE_MEAN and ds <= DOC_NOISE_SPREAD):
                        failures.append(f'{doc} {name} {tag}: means {dm:.3g} apart (bar '
                                        f'{DOC_NOISE_MEAN:g}), spreads {ds:.3g} (bar '
                                        f'{DOC_NOISE_SPREAD:g})')
                continue
            bar64 = DOC_CARD_CPU_BARS.get((doc, name), (EXAMPLE_CARD_CPU_BAR,))[0]
            for tag, (x, y), bar in (('f64 card vs CPU', (a64, c64), bar64),
                                     ('f32 vs f64', (a32, a64), doc_f32_bar(doc, name))):
                try:
                    err = docs.relative_error(x, y)
                except ValueError as e:
                    failures.append(f'{doc} {name} {tag}: {e}')
                    continue
                if not err <= bar:
                    failures.append(f'{doc} {name} {tag}: {err:.3e} exceeds {bar:g}')
                worst[tag] = max(worst[tag], (err / bar, f'{name} {err:.2e}'))
        launched = {k: n for k in r32['launches'][doc]
                    if (n := r32['launches'][doc][k] + r64['launches'][doc][k])}
        for kernel in DOC_KERNELS.get(doc, ()):
            for tag, run in (('f32', r32), ('f64', r64)):
                if run['launches'][doc][kernel] < 1:
                    failures.append(f'{doc}: {kernel} was not launched on the card in {tag}')
        skipped = r32['skipped'][doc] or r64['skipped'][doc]
        print(f'  {short}: card f32 {r32["walls"][doc]:.2f} s, f64 {r64["walls"][doc]:.2f} s '
              f'(CPU f64 {cpu["walls"][doc]:.2f} s); worst (of its bar) '
              + ', '.join(f'{tag} {text}' for tag, (_, text) in worst.items())
              + (f'; launches {launched}' if launched else '')
              + (f'; drawing blocks {skipped} skipped (no matplotlib)' if skipped else ''),
              flush=True)
    for failure in failures:
        print(f'  FAILED {failure}', flush=True)
    print(f'  phase 3s: {len(docs.EXECUTED)} docs, card f32 {sum(r32["walls"].values()):.1f} s, '
          f'f64 {sum(r64["walls"].values()):.1f} s (CPU f64 in the worker '
          f'{sum(cpu["walls"].values()):.1f} s); the phase took {time.perf_counter() - t0:.1f} s',
          flush=True)
    require(not failures, f'phase 3s: {len(failures)} checks failed')
    return {k: sum(run['launches'][doc][k] for run in (r32, r64) for doc in docs.EXECUTED)
            for k in launch_counts()}


# ---------------------------------------------------------------------------
# phase 4: timing
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 3t: torch.func through the port's custom autograd Functions
# ---------------------------------------------------------------------------

# a transform against autograd or the plain call: the same operations, so
# the suggested 1e-6 relative in f32 (and 1e-12 in f64)
TRANSFORM_BAR, TRANSFORM_BAR64 = 1e-6, 1e-12
# jacfwd of stack_rt against central differences at h = 1e-6: the truncation,
# ~h^2 times the third derivative, is 5.9e-7 of the peak for the edge filter
# below (1e-7 gives 5.9e-9: it goes as h^2; jacfwd meets jacrev at 6e-15),
# the rounding ~eps / h 1e-10
STACK_FD_STEP, STACK_FD_BAR = 1e-6, 1e-6
STACK_LAYERS, STACK_WVLS = 41, 256
VMAP_BATCH = 4
SCALING_ARGS, SCALING_TIMEOUT_S = ('256', '2', '128'), 300


def counted(fn):
    """(fn() synchronised, the hand-written launches it made, those not 0)."""
    reset_launches()
    out = synced(fn)
    return out, {k: v for k, v in launch_counts().items() if v}


def transform_bar(dtype):
    return TRANSFORM_BAR64 if dtype == torch.float64 else TRANSFORM_BAR


def edge_filter(dtype, dev):
    """A 41-layer (HL)^20 H edge filter at 0.55 um with 5% seeded errors, and its
    256 wavelengths over 0.45-0.65 um at 0 and 0.3 rad."""
    import numpy as np
    quarter = [0.55 / (4 * n) for n in (2.35, 1.38)]
    errors = np.random.default_rng(SEED).normal(scale=0.05, size=STACK_LAYERS)
    d = torch.tensor([quarter[k % 2] * (1 + e) for k, e in enumerate(errors)], dtype=dtype,
                     device=dev)
    wvl = torch.linspace(0.45, 0.65, STACK_WVLS, dtype=dtype, device=dev)[:, None]
    theta = torch.tensor([0.0, 0.3], dtype=dtype, device=dev)[None, :]
    return [2.35, 1.38] * (STACK_LAYERS // 2) + [2.35], d, wvl, theta


def add_launches(launches, counts):
    for k, v in counts.items():
        launches[k] += v


def transforms_cfg2(dev, dtype, checks, launches):
    """torch.func.grad of cfg2's TF32 loss against autograd's, launch for launch, and the
    jvp of its 'high' plan against the plan applied to the tangent."""
    from prysm_tpu_torch.steps import _cfg2_intensity, make_cfg2_plan, make_pupil
    tag = str(dtype)[6:]
    pupil = make_pupil(N, dtype=dtype, device=dev)
    plan = make_cfg2_plan(pupil, FN, matmul_precision='high')
    intensity = _cfg2_intensity(pupil, plan, fused=True)
    with torch.no_grad():
        I_meas = intensity(pupil.coefs * 0.5)

    def loss(c):
        return torch.sum((intensity(c) - I_meas) ** 2)

    c = pupil.coefs
    got, n_func = counted(lambda: torch.func.grad(loss)(c))
    leaf = c.clone().requires_grad_(True)
    want, n_auto = counted(lambda: torch.autograd.grad(loss(leaf), leaf)[0])
    for name, n in (('torch.func.grad', n_func), ('autograd', n_auto)):
        require(n == {'zernike_fwd': 1, 'zernike_bwd_coefs': 1},
                f'cfg2 {tag} {name} launched {n}, not one forward and one coefs backward')
        add_launches(launches, n)
    checks.append((f'cfg2 TF32 torch.func.grad vs autograd {tag}', rel(got, want),
                   TRANSFORM_BAR))
    field = torch.polar(pupil.amp, pupil.r * 3.0).to(plan.Ex.dtype)
    tangent = torch.polar(pupil.amp, pupil.t).to(plan.Ex.dtype)
    _, dout = synced(lambda: torch.func.jvp(plan, (field,), (tangent,)))
    checks.append((f"'high' plan jvp vs the plan of the tangent {tag}",
                   rel(dout, synced(lambda: plan(tangent))), transform_bar(dtype)))


def transforms_zernike(dev, dtype, checks, launches):
    """torch.func.grad of a 1024^2 zernike_sum loss (grads='all') against autograd's, with
    one full-backward launch; vmap over VMAP_BATCH coefficient vectors against as many
    calls, with as many forward launches."""
    from prysm_tpu_torch.polynomials import zernike_sum
    from prysm_tpu_torch.steps import NMS6, make_pupil
    tag = str(dtype)[6:]
    pupil = make_pupil(N, dtype=dtype, device=dev)
    x, y, shift = shifted_grid(dtype, dev)

    def loss(c, s):
        return zernike_fit_loss(lambda c, x, y: zernike_sum(c, NMS6, x, y), x, y, s, c,
                                pupil.amp)

    c = pupil.coefs
    got, n_func = counted(lambda: torch.func.grad(loss, argnums=(0, 1))(c, shift))
    leaves = (c.clone().requires_grad_(True), shift.clone().requires_grad_(True))
    want, n_auto = counted(lambda: torch.autograd.grad(loss(*leaves), leaves))
    # the loss's target is one more forward call, under no_grad
    for name, n in (('torch.func.grad', n_func), ('autograd', n_auto)):
        require(n == {'zernike_fwd': 2, 'zernike_bwd_all': 1},
                f'zernike_sum {tag} {name} launched {n}, not two forwards and one full '
                'backward')
        add_launches(launches, n)
    for what, a, b in zip(('coefficient', 'decentre'), got, want):
        checks.append((f'zernike_sum torch.func.grad vs autograd, {what} {tag}', rel(a, b),
                       TRANSFORM_BAR))
    gen = torch.Generator().manual_seed(SEED)
    batch = (torch.randn(VMAP_BATCH, len(NMS6), generator=gen, dtype=dtype) * 10).to(dev)

    def opd(cc):
        return zernike_sum(cc, NMS6, x, y)

    got, n_vmap = counted(lambda: torch.func.vmap(opd)(batch))
    want, n_calls = counted(lambda: torch.stack([opd(cc) for cc in batch]))
    for name, n in (('vmap', n_vmap), ('calls', n_calls)):
        require(n == {'zernike_fwd': VMAP_BATCH},
                f'{VMAP_BATCH} coefficient vectors by {name} launched {n}')
        add_launches(launches, n)
    checks.append((f'zernike_sum vmap x{VMAP_BATCH} vs {VMAP_BATCH} calls {tag}',
                   rel(got, want), TRANSFORM_BAR))


def transforms_stack(dev, checks):
    """jacfwd of stack_rt (|r|^2, s) with respect to the 41 thicknesses, f64, against
    central differences (the coatings modules work in ``config.precision``)."""
    from prysm_tpu_torch.conf import precision_as
    from prysm_tpu_torch.x import coatings
    ns, d, wvl, theta = edge_filter(torch.float64, dev)

    def R(d):
        with precision_as(torch.float64):
            r, _ = coatings.stack_rt(coatings.Stack(ns, d, 1.52), wvl, theta, 's')
        return r.real ** 2 + r.imag ** 2

    got = synced(lambda: torch.func.jacfwd(R)(d))
    eye = torch.eye(STACK_LAYERS, dtype=d.dtype, device=dev)
    fd = synced(lambda: torch.stack([(R(d + STACK_FD_STEP * e) - R(d - STACK_FD_STEP * e))
                                     / (2 * STACK_FD_STEP) for e in eye], dim=-1))
    checks.append((f'stack_rt jacfwd vs central differences f64 ({STACK_LAYERS} layers)',
                   rel(got, fd), STACK_FD_BAR))


def transforms_broadband(dev, dtype, checks):
    """torch.func.grad of the sharded broadband loss over the NCCL group against autograd
    of its serial counterpart, at phase 3p's bars."""
    from prysm_tpu_torch.parallel import broadband_psf, make_mesh
    from prysm_tpu_torch.parallel.sharding import _shard_broadband_loss
    from prysm_tpu_torch.steps import _pattern_inputs
    tag = str(dtype)[6:]
    pupil, modes, _, wvls, weights, plan = _pattern_inputs(N, FN, dtype, dev)
    c = pupil.coefs
    I_meas = broadband_psf(c * 0.5, pupil.amp, modes, wvls, weights, plan)
    loss = _shard_broadband_loss(make_mesh({'wl': 1, 'ty': 1}), plan, pupil.amp, modes,
                                 wvls, weights, I_meas)
    leaf = c.clone().requires_grad_(True)
    serial = torch.sum((broadband_psf(leaf, pupil.amp, modes, wvls, weights, plan)
                        - I_meas) ** 2)
    want = synced(lambda: torch.autograd.grad(serial, leaf)[0])
    got = synced(lambda: torch.func.grad(loss)(c))
    checks.append((f'broadband torch.func.grad (NCCL, world 1) vs serial {tag}',
                   rel(got, want), PATTERN_BAR64 if dtype == torch.float64 else PATTERN_BAR))


def scaling_row():
    """The scaling harness at world size 1, in a process of its own: its row."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, '-m', 'prysm_tpu_torch.tools.scaling_bench',
                           *SCALING_ARGS, '--ranks', '1'], cwd=root, capture_output=True,
                          text=True, timeout=SCALING_TIMEOUT_S)
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-3000:], sep='\n', flush=True)
    require(proc.returncode == 0, f'the scaling harness exited {proc.returncode}')
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith('{')]
    row = lines[0]
    print(f'  scaling harness at world size 1 (N, W a card, fN = {", ".join(SCALING_ARGS)}):'
          f' {json.dumps(row)}; {lines[-1].get("card")}', flush=True)
    require(set(row) == {'devices', 'wavelengths', 'step_ms', 'wl_per_s',
                         'weak_scaling_efficiency'} and row['devices'] == 1
            and row['weak_scaling_efficiency'] == 1.0 and row['step_ms'] > 0,
            f'the scaling harness row is not a world-size-1 row: {row}')


def phase_transforms(dev):
    """torch.func through the port's six custom Functions on the card (phase 3t of the
    module's docstring); returns the hand-written launches, by kernel."""
    import torch.distributed as dist
    require(dist.get_backend() == 'nccl' and dist.get_world_size() == 1,
            'phase 3t runs on a world-size-1 NCCL group')
    checks, launches = [], dict.fromkeys(launch_counts(), 0)
    for dtype in (torch.float32, torch.float64):
        transforms_cfg2(dev, dtype, checks, launches)
        transforms_zernike(dev, dtype, checks, launches)
        transforms_broadband(dev, dtype, checks)
    transforms_stack(dev, checks)
    run_checks(checks, width=64)
    print(f'  hand-written launches in phase 3t: {json.dumps(launches)}', flush=True)
    scaling_row()
    return launches


@contextmanager
def nccl_group():
    """A world-size-1 NCCL process group over a file rendezvous, destroyed on exit."""
    import tempfile
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group('nccl', init_method=f'file://{tmp}/rendezvous', rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            yield
        finally:
            dist.destroy_process_group()


def phase_parallel(dev):
    """Every mesh pattern of ``parallel`` at full width over the NCCL group
    (``steps.build_parallel_patterns``), against its serial counterpart in f32 and in f64
    on the card, with no hand-written launch; returns the f32 patterns for phase 4."""
    import torch.distributed as dist
    from prysm_tpu_torch.steps import build_parallel_patterns
    require(dist.get_backend() == 'nccl' and dist.get_world_size() == 1,
            'phase 3p runs on a world-size-1 NCCL group')
    built, checks = {}, []
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype)[6:]
        patterns = build_parallel_patterns(dev, dtype)
        reset_launches()
        for name, pattern in patterns.items():
            got, want = synced(pattern.sharded), synced(pattern.serial)
            require(set(got) == set(want), f'{name}: outputs {sorted(got)} vs {sorted(want)}')
            for key in want:
                require(got[key].device == dev and got[key].shape == want[key].shape,
                        f'{name} {key}: {got[key].device} {tuple(got[key].shape)}')
                checks.append((f'{name} {json.dumps(pattern.axes)} {key} {tag}',
                               rel(got[key], want[key]),
                               PATTERN_BAR64 if dtype == torch.float64 else PATTERN_BAR))
        no_kernel_launches(f'{tag} mesh patterns')
        built[dtype] = patterns
    run_checks(checks, width=58)
    return built[torch.float32]


def parallel_timing(smi, patterns):
    """Phase 4's lines for the mesh patterns at world size 1: each pattern in turns with its
    serial counterpart, wall ms, device ms, busy share, device kernels, the device ms in
    NCCL kernels and the hand-written launches per call."""
    for name, pattern in patterns.items():
        runs = PATTERN_RUNS.get(name, 20)
        calls = {f'{name}_sharded': pattern.sharded, f'{name}_serial': pattern.serial}
        timing = step_ms(calls, runs=runs, warmup=min(runs, 3))
        for key, fn in calls.items():
            breakdown = device_breakdown(fn, steps=min(runs, 5), match='nccl')
            reset_launches()
            synced(fn)
            launched = launch_total()
            if breakdown is None:
                print(f'{smi} | pattern {key}_ms {timing[key]:.4f}; device ms not measured '
                      f'(every profiler trace came back empty); hand-written {launched}',
                      flush=True)
                continue
            busy, kernels_per, top, nccl = breakdown
            print(f'{smi} | pattern {key}_ms {timing[key]:.4f}; device_ms_per_call {busy:.4f} '
                  f'busy share {busy / timing[key]:.3f}; device kernels per call '
                  f'{kernels_per:.0f}, nccl device ms {nccl:.4f}, hand-written {launched}; '
                  'top: ' + '; '.join(f'{k} {v:.4f}' for k, v in top[:3]), flush=True)


def device_ms(calls, runs=25):
    """Median device time of one call, in ms, over runs of ``calls`` back to back.

    A sleep kernel ahead of each run holds the card while the host
    enqueues the run, so the events bracket back-to-back device work and
    not the host's launch rate.
    """
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fn in calls:
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(min(max(4 * host_s, 2e-3), 0.5) * 2e9)
    times = []
    for _ in range(runs):
        torch.cuda._sleep(cycles)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for fn in calls:
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / len(calls))
    return statistics.median(times)


def warm_ms(fn, inner=10):
    """fn's time with its inputs left in L2 by the call before."""
    return device_ms([fn] * inner)


def cold_ms(fn, tensors):
    """fn(*tensors)'s time with its inputs evicted from L2 before each call.

    The calls rotate over copies of ``tensors`` that hold more than 100 MB
    in all, twice the H100's 50 MB L2: each copy was last touched that far
    back, so each call reads its inputs from HBM.
    """
    size = sum(x.numel() * x.element_size() for x in tensors)
    sets = [tuple(x.clone() for x in tensors) for _ in range(int(COLD_BYTES // size) + 1)]
    return device_ms([lambda s=s: fn(*s) for s in sets])


def step_ms(fns, runs=40, warmup=5):
    """Median wall time of one step on the card's stream (host work included), in ms.

    ``fns`` maps names to steps; they run in turns, one call each per
    round, so host noise falls on all of them alike.
    """
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times[name].append(e0.elapsed_time(e1))
    return {name: statistics.median(t) for name, t in times.items()}


def device_breakdown(fn, steps=10, top=5, tries=3, match=None):
    """(device ms per step, device kernels per step, the kernels that take the most) from
    torch.profiler; None if every trace lost its device records (see kernels_per_call).
    With ``match``, a fourth value: the device ms per step of the kernels whose names hold
    it (case ignored)."""
    synced(fn)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        # device-side events only: a CPU op's own device time repeats its kernels', and
        # the device's side of a user annotation (a program span) covers them
        spans = {e.name for e in prof.events() if getattr(e, 'is_user_annotation', False)}
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in spans]
        if events:
            break
        time.sleep(0.25 * (attempt + 1))
    else:
        return None
    total_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    out = total_ms, sum(e.count for e in events) / steps, [
        (e.key[:72], e.self_device_time_total / 1e3 / steps) for e in events[:top]]
    if match is None:
        return out
    return *out, sum(e.self_device_time_total for e in events
                     if match in e.key.lower()) / 1e3 / steps


def device_line(smi, label, fn, wall, steps, unit='call'):
    """Print phase 4's device line for ``fn``: ``label`` (ending in its device-time key),
    the device ms per ``unit`` over ``steps`` profiled calls and the busy share against
    ``wall`` (its wall ms), the device kernels per ``unit``, the hand-written launches of
    one call and the kernels that take the most."""
    breakdown = device_breakdown(fn, steps=steps)
    reset_launches()
    synced(fn)
    launched = launch_total()
    if breakdown is None:
        print(f'{smi} | {label} not measured (every profiler trace came back empty); '
              f'hand-written {launched}', flush=True)
        return
    busy, kernels_per, top = breakdown
    print(f'{smi} | {label} {busy:.4f} busy share {busy / wall:.3f}; device kernels per '
          f'{unit} {kernels_per:.0f}, hand-written {launched}; top: '
          + '; '.join(f'{k} {v:.4f}' for k, v in top), flush=True)


def timed_lines(smi, calls, runs, warmup, steps):
    """Phase 4's lines for ``calls`` (name -> call), timed in turns (``step_ms``): each
    call's wall ms and its ``device_line``."""
    timing = step_ms(calls, runs=runs, warmup=warmup)
    for name, fn in calls.items():
        device_line(smi, f'{name}_ms {timing[name]:.4f}; device_ms_per_call', fn,
                    timing[name], steps)


def phase_timing(dev, smi, frame5, step3, chain4, fit, image, trace6, grad6, metrology, film,
                 wfc):
    from prysm_tpu_torch.coordinates import make_xy_grid, cart_to_polar
    from prysm_tpu_torch.ops import noise
    from prysm_tpu_torch.ops import zernike as zk
    from prysm_tpu_torch.polynomials import zernike_nm_seq
    from prysm_tpu_torch.steps import (NMS6, make_pupil, make_cfg2_plan,
                                       build_cfg1_step, build_cfg2_step)

    pupil = make_pupil(N, device=dev)
    steps = {f'cfg2_step_ms_{prec or "fp32"}': build_cfg2_step(
                 pupil, make_cfg2_plan(pupil, FN, matmul_precision=prec))
             for prec in ('high', None)}
    steps['cfg1_step_ms'] = build_cfg1_step(pupil)
    calls = {k: (lambda s=s: s(pupil.coefs)) for k, s in steps.items()}
    calls['cfg5_frame_ms'] = lambda: frame5(0)
    calls['cfg3_forward_ms'] = lambda: step3.forward(step3.coefs)
    calls['cfg3_step_ms'] = lambda: step3(step3.coefs)
    calls['cfg4_chain_ms'] = chain4
    calls['freeform_fit_ms'] = fit
    calls['image_chain_ms'] = image
    # cfg6 at the checked hex(64) and, for the card's own time beside the
    # launch overhead, the same system at hex(256): 3 x 197,377 rays
    from prysm_tpu_torch.steps import build_cfg6_trace
    from prysm_tpu_torch.x.raytracing import Sampling
    trace256 = build_cfg6_trace(Sampling.hex(256), device=dev)
    calls['cfg6_trace_ms'] = trace6
    calls['cfg6_trace_hex256_ms'] = trace256
    calls['cfg6_grad_ms'] = grad6
    met32, ref64 = metrology
    calls['metrology_ms'] = met32
    acts, coefs = wfc.dm.actuators, wfc.pupil.coefs
    calls['wfc_step_ms'] = lambda: wfc(acts, coefs)
    calls['dm_render_ms'] = lambda: wfc.render(acts)
    calls['sh_frame_ms'] = lambda: wfc.sensor(acts, coefs)
    timing = step_ms(calls)
    for k, v in timing.items():
        print(f'{smi} | {k} {v:.4f}', flush=True)
    # the freeform fit's parts, in turns: the Q2d sag, the fit (lstsq, the
    # fused reconstruction, the residual) and the other sag families
    z = fit.sag()[0]
    parts = {'freeform_sag_ms': fit.sag, 'freeform_lstsq_recon_ms': lambda: fit.fit(z),
             'freeform_families_ms': fit.families}
    timing.update(step_ms(parts, runs=20))
    calls.update(parts)
    for k in parts:
        print(f'{smi} | {k} {timing[k]:.4f}', flush=True)
    for name, key, unit, steps in (('cfg2', 'cfg2_step_ms_high', 'step', 10),
                                   ('cfg1', 'cfg1_step_ms', 'step', 10),
                                   ('cfg5', 'cfg5_frame_ms', 'frame', 10),
                                   ('cfg3_forward', 'cfg3_forward_ms', 'call', 10),
                                   ('cfg3', 'cfg3_step_ms', 'step', 10),
                                   ('cfg4', 'cfg4_chain_ms', 'chain', 10),
                                   ('freeform_fit', 'freeform_fit_ms', 'call', 3),
                                   ('freeform_sag', 'freeform_sag_ms', 'call', 2),
                                   ('freeform_lstsq_recon', 'freeform_lstsq_recon_ms', 'call', 2),
                                   ('freeform_families', 'freeform_families_ms', 'call', 2),
                                   ('image_chain', 'image_chain_ms', 'call', 10),
                                   ('cfg6_trace', 'cfg6_trace_ms', 'call', 10),
                                   ('cfg6_trace_hex256', 'cfg6_trace_hex256_ms', 'call', 5),
                                   ('cfg6_grad', 'cfg6_grad_ms', 'step', 5),
                                   ('metrology', 'metrology_ms', 'call', 5),
                                   ('wfc', 'wfc_step_ms', 'step', 10),
                                   ('dm_render', 'dm_render_ms', 'call', 10),
                                   ('sh_frame', 'sh_frame_ms', 'frame', 10)):
        device_line(smi, f'{name}_device_ms_per_{unit}', calls[key], timing[key], steps, unit)

    # cfg6's host launch (paraxial aiming, 3 fields of hex(64)) on its own
    from prysm_tpu_torch.x.raytracing.batch import _host_launches
    system6 = trace6.system
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        _host_launches(system6, list(system6.fields), 0.55, trace6.sampling, None)
        host.append((time.perf_counter() - t0) * 1e3)
    print(f'{smi} | cfg6_host_launch_ms {statistics.median(host):.4f} (host wall, '
          f'{trace6.P.shape[0]} rays)', flush=True)

    # the metrology path's host-bound PSD fit (500 Adam steps on the card, f64) and the
    # thin-film stack (f32, s and p), on the host's clock
    t0 = time.perf_counter()
    met32.fit_psd(ref64)
    fit_ms = (time.perf_counter() - t0) * 1e3
    film_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        synced(film)
        film_ms.append((time.perf_counter() - t0) * 1e3)
    print(f'{smi} | metrology_fit_psd_ms {fit_ms:.4f} (host wall, 500 steps); '
          f'thinfilm_stack_ms {statistics.median(film_ms):.4f} (host wall, 32 layers, '
          f'{FILM_WVLS[2]} x {FILM_ANGLES[2]}, s and p)', flush=True)

    # the cfg2 MDFT alone: does cuBLAS take TF32 for complex64?
    gen = torch.Generator().manual_seed(SEED + 1)
    field = torch.polar(torch.ones(N, N), torch.randn(N, N, generator=gen))
    p64 = make_pupil(N, dtype=torch.float64, device=dev)
    exact = make_cfg2_plan(p64, FN, matmul_precision=None)(field.to(dev, torch.complex128))
    for prec in ('high', None):
        plan = make_cfg2_plan(pupil, FN, matmul_precision=prec)
        a = field.to(dev, torch.complex64)
        print(f'{smi} | mdft_fwd_{prec or "fp32"}_ms {warm_ms(lambda: plan(a)):.4f} '
              f'rel_err {rel(plan(a), exact):.3e}', flush=True)

    x, y = make_xy_grid(N, diameter=2.2, device=dev)
    r, t = cart_to_polar(x, y)
    g = torch.randn(N, N, generator=gen).to(dev)
    # what any call costs here: a one-element op back to back, and one
    # PyTorch pass over the forward's 12.6 MB (read r and t, write a map)
    tiny, out = torch.zeros(1, device=dev), torch.empty_like(r)
    copy = lambda r, t: torch.add(r, t, out=out)  # noqa: E731
    print(f'{smi} | launch_floor_ms {warm_ms(lambda: tiny.add_(1)):.5f}; '
          f'add_r_t_ms cold {cold_ms(copy, (r, t)):.5f} warm {warm_ms(lambda: copy(r, t)):.5f}',
          flush=True)
    plan = zk._plan(NMS6, True)
    c = pupil.coefs
    # the library yardstick: one tensordot over the f32 (K, N, N) mode stack
    # that the port's mode-stack path builds (polynomials/fitting.py); the
    # port never calls it on the kernels' path
    stack = zernike_nm_seq(NMS6, r, t)
    library = {
        'zernike_fwd': (lambda s, g: torch.tensordot(c, s, dims=([0], [0])), 1e-5),
        'zernike_bwd_coefs': (lambda s, g: torch.tensordot(s, g, dims=([1, 2], [0, 1])), 1e-4),
    }
    calls = {
        # name: (kernel(*inputs), plain(*inputs), inputs)
        'zernike_fwd': (lambda r, t: zk._launch_fwd(plan, c, r, t),
                        lambda r, t: zk.zernike_fwd_plain(plan, c, r, t), (r, t)),
        'zernike_bwd_coefs': (lambda r, t, g: zk._launch_bwd_coefs(plan, r, t, g),
                              lambda r, t, g: zk.zernike_bwd_coefs_plain(plan, r, t, g),
                              (r, t, g)),
        'zernike_bwd_all': (lambda r, t, g: zk._launch_bwd_all(plan, c, r, t, g),
                            lambda r, t, g: zk.zernike_bwd_all_plain(plan, c, r, t, g),
                            (r, t, g)),
    }
    work = {name: (KERNEL_ROWS[name][2] * N * N,
                   ZERNIKE_FP32_OPS[name] * N * N / FP32_OPS_PER_S)
            for name in calls}
    # the noise kernel at cfg5's shape: the 512^2 mean-electron map, one frame
    det = frame5.detector
    lam5 = det._mean_electrons(frame5.mosaic())
    calls['noise_expose'] = (lambda lam: noise._launch(lam, 1, 0, *noise_args(det)),
                             lambda lam: noise.expose_plain(lam, 1, 0, *noise_args(det)),
                             (lam5,))
    work['noise_expose'] = noise_work(lam5.numel(), 1)
    kernels = {}
    for name, (kernel, plain, args) in calls.items():
        bound, bound_by = bound_ms(*work[name])
        k = kernels[name] = {
            'ms': cold_ms(kernel, args), 'warm_ms': warm_ms(lambda: kernel(*args)),
            'plain_ms': device_ms([lambda: plain(*args)] * 2),
            'bound_ms': bound[bound_by], 'bound_by': bound_by,
            'library_ms': None, 'library_warm_ms': None}
        line = (f'{smi} | {name} cold {k["ms"]:.5f} warm {k["warm_ms"]:.5f} ms/call, '
                f'plain {k["plain_ms"]:.4f} ms, bound {k["bound_ms"]:.5f} ms ({bound_by}; '
                f'bytes {bound["bytes"]:.5f} ms, operations {bound["operations"]:.5f} ms)')
        if name in library:
            fn, bar = library[name]
            err = rel(fn(stack, g), kernel(*args))
            require(err <= bar, f'the library yardstick of {name} computes another function '
                                f'({err:.3e})')
            k['library_ms'] = cold_ms(fn, (stack, g))
            k['library_warm_ms'] = warm_ms(lambda: fn(stack, g))
            line += (f'; library cold {k["library_ms"]:.5f} warm {k["library_warm_ms"]:.5f} ms '
                     f'(rel diff {err:.2e})')
        print(line, flush=True)

    # beyond the kernels line: the noise kernel on a 16-frame stack of the
    # cfg5 map, and the full backward on longer plans, in one launch and in two
    extra = {'noise_expose 512^2 x 16': (lambda lam: noise._launch(lam, 16, 0, *noise_args(det)),
                                         (lam5,), noise_work(lam5.numel(), 16))}
    for nms, what in ((NMS45, '45 modes, 1 launch'), (NMS66, '66 modes, 2 launches')):
        plan_k = zk._plan(nms, True)
        c_k = torch.randn(len(nms), generator=gen).to(dev)
        extra[f'zernike_bwd_all {what}'] = (
            lambda r, t, g, plan_k=plan_k, c_k=c_k: zk._launch_bwd_all(plan_k, c_k, r, t, g),
            (r, t, g), (20 * N * N, kall_fp32_ops(nms) * N * N / FP32_OPS_PER_S))
    for what, (kernel, args, w) in extra.items():
        bound, bound_by = bound_ms(*w)
        cold = cold_ms(kernel, args)
        print(f'{smi} | {what} cold {cold:.5f} warm {warm_ms(lambda: kernel(*args)):.5f} '
              f'ms/call, bound {bound[bound_by]:.5f} ms ({bound_by}; bytes {bound["bytes"]:.5f} '
              f'ms, operations {bound["operations"]:.5f} ms), cold / bound '
              f'{cold / bound[bound_by]:.2f}', flush=True)
    return kernels


def noise_work(cells, frames):
    """(bytes, operations' seconds) of the noise kernel: the map read once, each frame written."""
    threads = -(-cells // NOISE_CELLS)
    setups, frame_runs = threads * -(-frames // NOISE_FRAMES), threads * frames
    return 4 * cells + 4 * cells * frames, max(
        (NOISE_OPS['setup'][pipe] * setups + NOISE_OPS['frame'][pipe] * frame_runs) / rate
        for pipe, rate in PIPE_OPS_PER_S.items())


def bound_ms(bytes_moved, ops_s):
    """({'bytes': ms, 'operations': ms}, the larger's name): the card's least time."""
    bound = {'bytes': bytes_moved / HBM_BYTES_PER_S * 1e3, 'operations': ops_s * 1e3}
    return bound, max(bound, key=bound.get)


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available; nothing was run', file=sys.stderr)
        return 1
    import prysm_tpu_torch.steps  # noqa: F401 (fails here, before any worker, without the package)

    start = time.perf_counter()

    def stamp():
        return f'[{time.perf_counter() - start:.1f} s]'

    # phases 3j's and 3o's f64 CPU references run in a worker process from here on
    import multiprocessing
    workers = multiprocessing.get_context('spawn').Pool(1)
    try:
        cpu_ref = workers.apply_async(coating_cpu_reference)
        design_ref = workers.apply_async(design_cpu_reference)
        examples_ref = workers.apply_async(examples_cpu_reference)
        docs_ref = workers.apply_async(docs_cpu_reference)
        return run(start, stamp, cpu_ref, design_ref, examples_ref, docs_ref)
    finally:
        workers.terminate()
        workers.join()


def run(start, stamp, cpu_ref, design_ref, examples_ref, docs_ref):
    from prysm_tpu_torch.ops import _cuda, noise
    from prysm_tpu_torch.ops import zernike as zk
    from prysm_tpu_torch.steps import (WFC_NMS, build_cfg3_step, build_cfg4_chain,
                                       build_cfg5_frame)

    dev = torch.device('cuda', 0)
    smi = card()
    print(f'card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}', flush=True)

    print(f'phase 1: build (one nvcc per source, together) {stamp()}', flush=True)
    sources = sorted({src[:-3] for src, _, _ in KERNEL_ROWS.values()})

    def timed_build(name):
        t0 = time.perf_counter()
        return _cuda.build(name), time.perf_counter() - t0

    with ThreadPoolExecutor(len(sources)) as pool:
        builds = dict(zip(sources, pool.map(timed_build, sources)))
    for name, (log, seconds) in builds.items():
        print(f'  {name}.cu: {"built" if log is not None else "up to date"} in {seconds:.2f} s',
              flush=True)
        for line in (log or '').splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling entry' in line:
                print(f'  {name}: {line.strip()}')

    print('phase 2: kernels against their plain versions (f32; Zernike at 1024^2, '
          f'noise at cfg5 512^2 and 256^2) {stamp()}', flush=True)
    worst, pieces = phase_kernels(dev)
    frame5 = build_cfg5_frame(N5, device=dev)
    worst['noise_expose'] = phase_noise(dev, frame5)
    torch.cuda.synchronize()

    print(f'phase 3a: main path (cfg2 x5, entry + cfg1 x5, zernike_sum grads=all) {stamp()}',
          flush=True)
    ref = references(dev)
    reset_launches()
    out = drive_main_path(dev)
    launches = dict(zk.LAUNCHES)
    check_main_path(out, ref, launches)
    torch.cuda.synchronize()

    print(f'phase 3b: main path (cfg5 frame at {N5}^2, seeds {list(SEEDS5)}) {stamp()}',
          flush=True)
    reset_launches()
    frames, per_frame = drive_cfg5(frame5)
    launches['noise_expose'] = noise.LAUNCHES['noise_expose']
    require(launches['noise_expose'] > 0, 'noise_expose was not launched on the cfg5 path')
    check_cfg5(frames, per_frame, frame5, dev)
    torch.cuda.synchronize()

    print(f'phase 3c: cfg3 (19-segment aperture at {N3}^2, PSF {2 * N3}^2, encircled energy '
          f'and its gradient) x{STEPS} {stamp()}', flush=True)
    step3 = build_cfg3_step(N3, device=dev)
    reset_launches()
    phase_cfg3(dev, step3)
    print(f'phase 3d: cfg4 (angular spectrum -> lens -> angular spectrum at {N4}^2) {stamp()}',
          flush=True)
    chain4 = build_cfg4_chain(N4, device=dev)
    reset_launches()
    phase_cfg4(dev, chain4)
    print(f'phase 3e: executors (MDFT, CZT, FFTDFT; multi-resolution Babinet) {stamp()}',
          flush=True)
    reset_launches()
    phase_executors(dev)
    torch.cuda.synchronize()
    print(f'phase 3f: freeform fit (Q2d sag and slopes, 36-mode Zernike fit, sag families at '
          f'{N}^2) {stamp()}', flush=True)
    fit = phase_freeform(dev)
    torch.cuda.synchronize()
    print(f'phase 3g: image chain (Siemens star through the flagship PSF, OTF, smear, jitter at '
          f'{N}^2) {stamp()}', flush=True)
    image = phase_image_chain(dev)
    torch.cuda.synchronize()
    print(f'phase 3h: cfg6 (doublet + singlet, 3 fields x hex(64) = 37,443 rays, merged trace '
          f'and curvature gradient) {stamp()}', flush=True)
    trace6, grad6 = phase_cfg6(dev)
    torch.cuda.synchronize()
    print(f'phase 3i: metrology (13-frame PSI of a 100 mm flat at {N}^2, unwrap, Interferogram '
          f'analysis; a 32-layer thin-film stack) {stamp()}', flush=True)
    metrology = phase_metrology(dev)
    film = phase_thinfilm(dev)
    torch.cuda.synchronize()
    print(f'phase 3j: coating design (41-layer edge filter, 1024 wavelengths x 2 angles, s and '
          f'p; refine by L-BFGS-B and DLS; needle synthesis) {stamp()}', flush=True)
    reset_launches()
    designs, walls = phase_coating(dev, cpu_ref)
    no_kernel_launches('coating design')
    torch.cuda.synchronize()
    print(f'phase 3k: phase retrieval by PrysmLBFGSB (cfg2 at {N}^2 -> {FN}^2, 40 iterations) '
          f'{stamp()}', flush=True)
    retrieval = phase_retrieval(dev)
    torch.cuda.synchronize()
    print(f'phase 3l: wavefront control ({N}^2 pupil, 36 Zernike modes, 50 x 50 DM folded 10 '
          f'degrees, TF32 MDFT to {FN}^2, 32 x 32 lenslets) x{STEPS} {stamp()}', flush=True)
    wfc = phase_wavefront_control(dev, pieces[WFC_NMS])
    torch.cuda.synchronize()
    print(f'phase 3m: instruments at {N_INSTR}^2 (4-step PSPDI, SRI, vector vortex; germanium '
          f'singlet at 80 and 295 K) {stamp()}', flush=True)
    reset_launches()
    phase_instruments(dev)
    no_kernel_launches('instruments')
    torch.cuda.synchronize()
    print(f'phase 3n: lens analysis (cfg6 real-aimed, 3 fields x hex(64), 36-mode fit, {N}^2 '
          f'PSFs through the MDFT to {FN}^2, adjoint sensitivities; first order, Seidel, '
          f'distortion, field curvature, spots, OPD fans, full field; the fish-eye ladder at '
          f'{FISHEYE_DEG:g} degrees) {stamp()}', flush=True)
    lens = phase_lens_analysis(dev, pieces[WFC_NMS])
    torch.cuda.synchronize()
    print(f'phase 3o: lens design (cfg6 read from .zmx / .seq; DLS over 3 curvatures and 2 '
          f'thicknesses on 3 fields x hex(64) with an EFL constraint; sensitivity table, '
          f'Monte Carlo, wavefront differential; pupil fields at 128^2 -> 512^2 PSFs, PRT; '
          f'the lens analysis of the result) {stamp()}', flush=True)
    design = phase_lens_design(dev, design_ref, pieces[WFC_NMS])
    torch.cuda.synchronize()
    with nccl_group():
        print(f'phase 3p: mesh patterns over NCCL at world size 1 (broadband wl x ty and '
              f'hybrid, multi-resolution Babinet, contraction MDFT, distributed FFT, '
              f'overlapped gradient, raytrace fit and trace) {stamp()}', flush=True)
        patterns = phase_parallel(dev)
        torch.cuda.synchronize()
        print(f'phase 3q: the five examples at their default sizes, f32 and f64 (LOWFS '
              f'256^2 -> 64^2, dark hole 128^2 -> 64^2, retrieval 256^2 -> 96^2, the doublet, '
              f'the V-coat) {stamp()}', flush=True)
        reset_launches()
        phase_examples(dev, examples_ref)
        no_kernel_launches('examples')
        torch.cuda.synchronize()
        print(f'phase 3r: the card tier (tests/test_torch_chip_*.py under pytest on the card) '
              f'{stamp()}', flush=True)
        phase_card_tier()
        print(f'phase 3s: the port\'s executed docs on the card, f32 and f64 (docs/torch/, '
              f'against the CPU\'s f64 run) {stamp()}', flush=True)
        for name, count in phase_docs(dev, docs_ref).items():
            launches[name] += count
        torch.cuda.synchronize()
        print(f'phase 3t: torch.func through the custom Functions, f32 and f64 (cfg2\'s TF32 '
              f'step and plan, zernike_sum at {N}^2, stack_rt, the broadband loss over NCCL; '
              f'the scaling harness at world size 1) {stamp()}', flush=True)
        for name, count in phase_transforms(dev).items():
            launches[name] += count
        torch.cuda.synchronize()

        print(f'phase 4: timing (medians; steps in turns) {stamp()}', flush=True)
        kernels = phase_timing(dev, smi, frame5, step3, chain4, fit, image, trace6, grad6,
                               metrology, film, wfc)
        design_timing(smi, designs, walls, retrieval)
        lens_timing(smi, *lens)
        design_timing_lines(smi, *design)
        parallel_timing(smi, patterns)
        examples_timing(smi, dev)
        torch.cuda.synchronize()
    print(f'phase 5: results {stamp()}', flush=True)

    rows = [{'name': name, 'route': 'cuda', 'source': f'prysm_tpu_torch/csrc/{src}',
             'replaces': replaces, 'launches': launches[name],
             'max_abs_err': worst[name], **kernels[name]}
            for name, (src, replaces, _) in KERNEL_ROWS.items()]
    print(json.dumps({'kernels': rows}))
    print(smi)
    # the process sees one card (CUDA_VISIBLE_DEVICES, set at the top): the count is 1
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
