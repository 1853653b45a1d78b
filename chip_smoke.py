"""Drive the PyTorch/CUDA port's main path on one card and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and exits nonzero, printing no result, without
one.  Phases, each of which raises on a failed check:

1. build the CUDA kernels from ``prysm_tpu_torch/csrc/zernike.cu`` and
   print the build time;
2. hold each kernel against its plain PyTorch version on the card, in
   f32 at 1024^2, for two mode sets and both norms; the coefficient
   cotangents also mode by mode, each against its own size;
3. the main path, with every launch count set to 0 just before it and
   read just after: the cfg2 phase-retrieval step (1024^2 pupil -> 256^2
   focal grid by MDFT, ``matmul_precision='high'``, ``grads='coefs'``)
   for 5 gradient steps, the flagship ``entry()`` forward and the cfg1
   step (FFT focus, Q=2, PSF, MTF) for 5 steps, and the public
   ``zernike_sum`` with its default ``grads='all'`` backward; each result
   is checked against the same computation in f64 on the card;
4. timing with CUDA events: ms per step, ms per kernel call and per call
   of its plain version, each kernel's bound;
5. a ``{"kernels": [...]}`` line, the card's name and power limit, and the
   last line ``{"ok": true, "device": {...}}``.
"""
import json
import math
import statistics
import subprocess
import sys
import time

import torch

N, FN, STEPS = 1024, 256, 5
SEED = 20260401
NMS45 = tuple((n, m) for n in range(9) for m in range(-n, n + 1, 2))
# the H100 SXM data sheet: HBM bytes/s and fp32 (non-tensor) operations/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
KERNEL_ROWS = {
    # name: (TPU kernel it replaces, bytes moved per pixel)
    'zernike_fwd': ('prysm_tpu/ops/zernike.py:108', 12),
    'zernike_bwd_coefs': ('prysm_tpu/ops/zernike.py:130', 12),
    'zernike_bwd_all': ('prysm_tpu/ops/zernike.py:165', 20),
}


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True, timeout=60)
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


def phase_timing(dev, smi):
    from prysm_tpu_torch.coordinates import make_xy_grid, cart_to_polar
    from prysm_tpu_torch.ops import zernike as zk
    from prysm_tpu_torch.steps import (NMS6, make_pupil, make_cfg2_plan,
                                       build_cfg1_step, build_cfg2_step)

    pupil = make_pupil(N, device=dev)
    steps = {f'cfg2_step_ms_{prec or "fp32"}': build_cfg2_step(
                 pupil, make_cfg2_plan(pupil, FN, matmul_precision=prec))
             for prec in ('high', None)}
    steps['cfg1_step_ms'] = build_cfg1_step(pupil)
    timing = step_ms({k: (lambda s=s: s(pupil.coefs)) for k, s in steps.items()})
    for k, v in timing.items():
        print(f'{smi} | {k} {v:.4f}', flush=True)
    for name, key in (('cfg2', 'cfg2_step_ms_high'), ('cfg1', 'cfg1_step_ms')):
        wall = timing[key]
        busy, top = device_breakdown(lambda: steps[key](pupil.coefs))
        print(f'{smi} | {name}_device_ms_per_step {busy:.4f} busy share '
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
    kernels = {}
    for name, (kernel, plain) in calls.items():
        bytes_moved = KERNEL_ROWS[name][1] * N * N
        ops = ops_per_pixel(plan, name) * N * N
        bound = {'bytes': bytes_moved / HBM_BYTES_PER_S * 1e3,
                 'operations': ops / FP32_OPS_PER_S * 1e3}
        bound_by = max(bound, key=bound.get)
        kernels[name] = {'ms': device_ms(kernel), 'plain_ms': device_ms(plain, inner=2),
                         'bound_ms': bound[bound_by], 'bound_by': bound_by}
        k = kernels[name]
        print(f'{smi} | {name} {k["ms"]:.4f} ms/call, plain {k["plain_ms"]:.4f} ms, '
              f'bound {k["bound_ms"]:.4f} ms ({bound_by}: {bytes_moved} B, {ops:.3g} ops)',
              flush=True)
    return kernels


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available; nothing was run', file=sys.stderr)
        return 1
    from prysm_tpu_torch.ops import _cuda
    from prysm_tpu_torch.ops import zernike as zk

    dev = torch.device('cuda', 0)
    smi = card()
    print(f'card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}', flush=True)

    print('phase 1: build', flush=True)
    t0 = time.perf_counter()
    log = _cuda.build('zernike')
    print(f'  built {"zernike.cu" if log is not None else "nothing (up to date)"} in '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    for line in (log or '').splitlines():
        if 'registers' in line or 'spill' in line:
            print(f'  zernike: {line.strip()}')

    print('phase 2: kernels against their plain versions (f32, 1024^2)', flush=True)
    worst = phase_kernels(dev)
    torch.cuda.synchronize()

    print('phase 3: main path (cfg2 x5, entry + cfg1 x5, zernike_sum grads=all)', flush=True)
    ref = references(dev)
    zk.reset_launches()
    out = drive_main_path(dev)
    launches = dict(zk.LAUNCHES)
    check_main_path(out, ref, launches)
    torch.cuda.synchronize()

    print('phase 4: timing (medians; steps in turns)', flush=True)
    kernels = phase_timing(dev, smi)
    torch.cuda.synchronize()

    rows = [{'name': name, 'route': 'cuda', 'source': 'prysm_tpu_torch/csrc/zernike.cu',
             'replaces': KERNEL_ROWS[name][0], 'launches': launches[name],
             'max_abs_err': worst[name], **kernels[name], 'library_ms': None}
            for name in KERNEL_ROWS]
    print(json.dumps({'kernels': rows}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
