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
   Zernike kernels in f32 at 1024^2, for two mode sets and both norms,
   the coefficient cotangents also mode by mode, each against its own
   size; the noise kernel on the cfg5 mean-electron map and on a 256^2
   map at 1000 e- with 4 frames (the same Philox uniforms, so the DN agree
   but for rare rounding ties), its zero-signal case, its reproducibility
   and its moments against the analytic chain;
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
4. timing with CUDA events: ms per step and per frame, in turns; device ms
   and busy share; ms per kernel call and per call of its plain version,
   each kernel's bound;
5. a ``{"kernels": [...]}`` line, the card's name and power limit, and the
   last line ``{"ok": true, "device": {...}}``.
"""
import os

# one card: the first visible one, and the process sees no other
os.environ['CUDA_VISIBLE_DEVICES'] = os.environ.get('CUDA_VISIBLE_DEVICES', '0').split(',')[0]

import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch  # noqa: E402 (after the card is chosen)

N, FN, STEPS = 1024, 256, 5
SEED = 20260401
NMS45 = tuple((n, m) for n in range(9) for m in range(-n, n + 1, 2))
N5, SEEDS5 = 512, range(5)
# the H100 SXM data sheet: HBM bytes/s and fp32 (non-tensor) operations/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# int32 operations/s: 64 INT32 lanes per SM (Hopper architecture white
# paper) x 132 SMs x the 1.98 GHz that the fp32 figure implies
INT32_OPS_PER_S = 64 * 132 * 1.98e9
KERNEL_ROWS = {
    # name: (source, TPU kernel it replaces, bytes moved per pixel)
    'zernike_fwd': ('zernike.cu', 'prysm_tpu/ops/zernike.py:108', 12),
    'zernike_bwd_coefs': ('zernike.cu', 'prysm_tpu/ops/zernike.py:130', 12),
    'zernike_bwd_all': ('zernike.cu', 'prysm_tpu/ops/zernike.py:165', 20),
    'noise_expose': ('noise.cu', 'prysm_tpu/ops/noise.py:68', None),
}
# operations per (frame, pixel) cell of the noise kernel, counted from its
# SASS along the path every cell takes (csrc/noise.cu says how): int32
# instructions, and fp32 operations with an FFMA as two
NOISE_INT_OPS, NOISE_FP32_OPS = 70, 80
# cfg5's detector (bench.py cfg5)
DET5 = dict(dark_current=2.0, read_noise=5.0, bias=100.0, fwc=60e3, conversion_gain=0.5,
            bits=14, exposure_time=1e-2)


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(['nvidia-smi', f'--id={os.environ["CUDA_VISIBLE_DEVICES"]}',
                          '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def synced(fn):
    out = fn()
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels(dev):
    from prysm_tpu_torch.coordinates import make_xy_grid, cart_to_polar
    from prysm_tpu_torch.ops import zernike as zk
    from prysm_tpu_torch.polynomials import zernike_nm_seq
    from prysm_tpu_torch.steps import NMS6

    gen = torch.Generator().manual_seed(SEED)
    x, y = make_xy_grid(N, diameter=2.2, device=dev)
    r, t = cart_to_polar(x, y)
    g = torch.randn(N, N, generator=gen).to(dev)
    worst = {k: 0.0 for k in KERNEL_ROWS}
    for nms in (NMS6, NMS45):
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
                worst[name] = max(worst[name], *(float((o - p).abs().max())
                                                 for o, p in zip(outs, refs)))
                print(f'  {name:18s} K={len(nms):2d} norm={norm!s:5s} '
                      f'max rel err {max(errs):.3e} (bar {bar:g})', flush=True)
                require(max(errs) <= bar, f'{name} disagrees with its plain version')
            again = synced(lambda: zk._launch_bwd_coefs(plan, r, t, g))
            require(torch.equal(again, cases['zernike_bwd_coefs'][0][0]),
                    'zernike_bwd_coefs is not bit-identical from run to run')
    return worst


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
    for what, err, bar in checks:
        print(f'  {what:40s} {err:.3e} (bar {bar:g})', flush=True)
        require(math.isfinite(err) and err <= bar, f'{what}: {err} exceeds {bar}')


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
    for what, err, bar in checks:
        print(f'  {what:52s} {err:.3e} (bar {bar:g})', flush=True)
        require(math.isfinite(err) and err <= bar, f'{what}: {err} exceeds {bar}')


# ---------------------------------------------------------------------------
# phase 4: timing
# ---------------------------------------------------------------------------

def device_ms(fn, runs=25, inner=10):
    """Median device time of one fn() call, in ms.

    A sleep kernel ahead of each run holds the card while the host
    enqueues the run, so the events bracket back-to-back device work and
    not the host's launch rate.
    """
    synced(fn)
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(min(max(4 * host_s, 2e-3), 0.5) * 2e9)
    times = []
    for _ in range(runs):
        torch.cuda._sleep(cycles)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


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


def device_breakdown(fn, steps=10, top=5):
    """Device ms per step from torch.profiler, and the kernels that take the most."""
    synced(fn)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    # device-side events only: a CPU op's own device time repeats its kernels'
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return total_ms, [(e.key[:48], e.self_device_time_total / 1e3 / steps)
                      for e in events[:top]]


def ops_per_pixel(plan, name):
    """fp32 operations one pixel costs, counted from csrc/zernike.cu (FMA = 2)."""
    groups, K = plan.groups, len(plan.modes)
    am_steps = max(am for am, *_ in groups)
    rec_steps = sum(nmax for _, nmax, *_ in groups)
    setup = 4 + 20 + 7 * am_steps          # x, 4r, sincosf (~20), angle/r^m steps
    if name == 'zernike_fwd':
        return setup + 5 * rec_steps + 4 * K
    if name == 'zernike_bwd_coefs':
        return setup + 5 * rec_steps + 3 * K + 5 * K / 32 + 8 * K / 256
    return setup + 11 * rec_steps + 20 * K + 5 * K / 32 + 8 * K / 256


def phase_timing(dev, smi, frame5):
    from prysm_tpu_torch.coordinates import make_xy_grid, cart_to_polar
    from prysm_tpu_torch.ops import noise
    from prysm_tpu_torch.ops import zernike as zk
    from prysm_tpu_torch.steps import (NMS6, make_pupil, make_cfg2_plan,
                                       build_cfg1_step, build_cfg2_step)

    pupil = make_pupil(N, device=dev)
    steps = {f'cfg2_step_ms_{prec or "fp32"}': build_cfg2_step(
                 pupil, make_cfg2_plan(pupil, FN, matmul_precision=prec))
             for prec in ('high', None)}
    steps['cfg1_step_ms'] = build_cfg1_step(pupil)
    calls = {k: (lambda s=s: s(pupil.coefs)) for k, s in steps.items()}
    calls['cfg5_frame_ms'] = lambda: frame5(0)
    timing = step_ms(calls)
    for k, v in timing.items():
        print(f'{smi} | {k} {v:.4f}', flush=True)
    for name, key, unit in (('cfg2', 'cfg2_step_ms_high', 'step'),
                            ('cfg1', 'cfg1_step_ms', 'step'),
                            ('cfg5', 'cfg5_frame_ms', 'frame')):
        wall = timing[key]
        busy, top = device_breakdown(calls[key])
        print(f'{smi} | {name}_device_ms_per_{unit} {busy:.4f} busy share '
              f'{busy / wall:.3f}; top: ' + '; '.join(f'{k} {v:.4f}' for k, v in top),
              flush=True)

    # the cfg2 MDFT alone: does cuBLAS take TF32 for complex64?
    gen = torch.Generator().manual_seed(SEED + 1)
    field = torch.polar(torch.ones(N, N), torch.randn(N, N, generator=gen))
    p64 = make_pupil(N, dtype=torch.float64, device=dev)
    exact = make_cfg2_plan(p64, FN, matmul_precision=None)(field.to(dev, torch.complex128))
    for prec in ('high', None):
        plan = make_cfg2_plan(pupil, FN, matmul_precision=prec)
        a = field.to(dev, torch.complex64)
        print(f'{smi} | mdft_fwd_{prec or "fp32"}_ms {device_ms(lambda: plan(a)):.4f} '
              f'rel_err {rel(plan(a), exact):.3e}', flush=True)

    x, y = make_xy_grid(N, diameter=2.2, device=dev)
    r, t = cart_to_polar(x, y)
    g = torch.randn(N, N, generator=gen).to(dev)
    plan = zk._plan(NMS6, True)
    c = pupil.coefs
    calls = {
        'zernike_fwd': (lambda: zk._launch_fwd(plan, c, r, t),
                        lambda: zk.zernike_fwd_plain(plan, c, r, t)),
        'zernike_bwd_coefs': (lambda: zk._launch_bwd_coefs(plan, r, t, g),
                              lambda: zk.zernike_bwd_coefs_plain(plan, r, t, g)),
        'zernike_bwd_all': (lambda: zk._launch_bwd_all(plan, c, r, t, g),
                            lambda: zk.zernike_bwd_all_plain(plan, c, r, t, g)),
    }
    work = {name: (KERNEL_ROWS[name][2] * N * N,
                   ops_per_pixel(plan, name) * N * N / FP32_OPS_PER_S)
            for name in calls}
    # the noise kernel at cfg5's shape: the 512^2 mean-electron map, one frame
    det = frame5.detector
    lam5 = det._mean_electrons(frame5.mosaic())
    calls['noise_expose'] = (lambda: noise._launch(lam5, 1, 0, *noise_args(det)),
                             lambda: noise.expose_plain(lam5, 1, 0, *noise_args(det)))
    cells = lam5.numel()
    work['noise_expose'] = (8 * cells, max(NOISE_INT_OPS * cells / INT32_OPS_PER_S,
                                           NOISE_FP32_OPS * cells / FP32_OPS_PER_S))
    kernels = {}
    for name, (kernel, plain) in calls.items():
        bytes_moved, ops_s = work[name]
        bound = {'bytes': bytes_moved / HBM_BYTES_PER_S * 1e3, 'operations': ops_s * 1e3}
        bound_by = max(bound, key=bound.get)
        kernels[name] = {'ms': device_ms(kernel), 'plain_ms': device_ms(plain, inner=2),
                         'bound_ms': bound[bound_by], 'bound_by': bound_by}
        k = kernels[name]
        print(f'{smi} | {name} {k["ms"]:.5f} ms/call, plain {k["plain_ms"]:.4f} ms, '
              f'bound {k["bound_ms"]:.5f} ms ({bound_by}; bytes {bound["bytes"]:.5f} ms, '
              f'operations {bound["operations"]:.5f} ms)', flush=True)
    return kernels


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available; nothing was run', file=sys.stderr)
        return 1
    from prysm_tpu_torch.ops import _cuda, noise
    from prysm_tpu_torch.ops import zernike as zk
    from prysm_tpu_torch.steps import build_cfg5_frame

    start = time.perf_counter()

    def stamp():
        return f'[{time.perf_counter() - start:.1f} s]'

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
    worst = phase_kernels(dev)
    frame5 = build_cfg5_frame(N5, device=dev)
    worst['noise_expose'] = phase_noise(dev, frame5)
    torch.cuda.synchronize()

    print(f'phase 3a: main path (cfg2 x5, entry + cfg1 x5, zernike_sum grads=all) {stamp()}',
          flush=True)
    ref = references(dev)
    zk.reset_launches()
    noise.reset_launches()
    out = drive_main_path(dev)
    launches = dict(zk.LAUNCHES)
    check_main_path(out, ref, launches)
    torch.cuda.synchronize()

    print(f'phase 3b: main path (cfg5 frame at {N5}^2, seeds {list(SEEDS5)}) {stamp()}',
          flush=True)
    zk.reset_launches()
    noise.reset_launches()
    frames, per_frame = drive_cfg5(frame5)
    launches['noise_expose'] = noise.LAUNCHES['noise_expose']
    require(launches['noise_expose'] > 0, 'noise_expose was not launched on the cfg5 path')
    check_cfg5(frames, per_frame, frame5, dev)
    torch.cuda.synchronize()

    print(f'phase 4: timing (medians; steps in turns) {stamp()}', flush=True)
    kernels = phase_timing(dev, smi, frame5)
    torch.cuda.synchronize()
    print(f'phase 5: results {stamp()}', flush=True)

    rows = [{'name': name, 'route': 'cuda', 'source': f'prysm_tpu_torch/csrc/{src}',
             'replaces': replaces, 'launches': launches[name],
             'max_abs_err': worst[name], **kernels[name], 'library_ms': None}
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
