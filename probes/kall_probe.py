"""Time variants of csrc/zernike.cu's full backward (kAll), on one card.

    env PYTHONPATH=. python3 probes/kall_probe.py [PARENT_CSRC_DIR]

Builds ``zernike.cu`` as it is, the variants in ``VARIANTS`` (text
substitutions of its constants) and, where given, the ``zernike.cu`` in
PARENT_CSRC_DIR, each with the flags of ``ops/_cuda.py`` into
``_probe/kall/``, and prints each build's registers.  For each library in
turn it holds ``zernike_bwd_all`` against the plain version at 1024^2 for
NMS6 and the 45 modes to n = 8, then times, cold and warm with
``chip_smoke.py``'s timers, ``zernike_bwd_all`` for NMS6, the 45 modes and
the 66 modes to n = 10 (two launches), and ``zernike_fwd`` and
``zernike_bwd_coefs`` for NMS6, then the three kernels for NMS6 on a 64^2
grid, where a launch and the backwards' reduction tail are most of the
time; the libraries run in order, then in the reverse order.  Each line
carries the card's name and power limit.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from prysm_tpu_torch.coordinates import cart_to_polar, make_xy_grid
from prysm_tpu_torch.ops import _cuda
from prysm_tpu_torch.ops import zernike as zk
from prysm_tpu_torch.steps import NMS6

OUT = Path('_probe/kall')
# name: ((old, new), ...) applied to zernike.cu
VARIANTS = {
    # the radial group walked and folded as any other, in both kernels
    'no_radial_case': (('constexpr bool kRadialCase = KMAX != kGeneral;',
                        'constexpr bool kRadialCase = false;'),),
    # the radial group's branch in the 32-slot kernel too
    'radial_case_32': (('constexpr bool kRadialCase = KMAX != kGeneral;',
                        'constexpr bool kRadialCase = true;'),),
    # the reduction's ticket taken as before: a sequentially consistent
    # __threadfence by each writer of a partial and by the last block
    'sc_fences': (
        ('''    partial[static_cast<long long>(blockIdx.x) * n + threadIdx.x] = mine;
  }''', '''    partial[static_cast<long long>(blockIdx.x) * n + threadIdx.x] = mine;
    __threadfence();
  }'''),
        ('''    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(before) : "l"(ticket) : "memory");''',
         '    before = atomicAdd(ticket, 1u);'),
        ('  if (!last) return;', '  if (!last) return;\n  __threadfence();')),
}
SIGNATURES = {
    'prysm_zernike_block_threads': ([], ctypes.c_int),
    'prysm_zernike_buckets': ([ctypes.POINTER(ctypes.c_int), ctypes.c_int], ctypes.c_int),
    'prysm_zernike_resident_blocks': ([ctypes.c_int] * 3, ctypes.c_int),
    'prysm_zernike_launch': ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 11], ctypes.c_int),
}


def build(name, src, include):
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f'zernike_{name}.cu', OUT / f'libzernike_{name}.so'
    cu.write_text(src)
    log = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, '-I', str(include), '-o', str(so),
                          str(cu)], capture_output=True, text=True, check=True)
    regs = [line.split('Used')[1].split(',')[0].strip() for line in
            (log.stdout + log.stderr).splitlines() if 'Used' in line]
    spills = sorted({line.strip() for line in (log.stdout + log.stderr).splitlines()
                     if 'spill' in line and not line.strip().startswith('0 bytes stack')})
    print(f'{name}: registers by kernel in build order {regs}; {spills}', flush=True)
    lib = ctypes.CDLL(str(so.resolve()))
    for fn, (argtypes, restype) in SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def use(lib):
    zk._lib = lambda: lib
    zk._buckets.cache_clear()
    zk._resident_blocks.cache_clear()


def main(parent=None):
    smi = chip_smoke.card()
    here = _cuda.CSRC / 'zernike.cu'
    libs = {}
    if parent:
        libs['parent'] = build('parent', (Path(parent) / 'zernike.cu').read_text(), parent)
    libs['this'] = build('this', here.read_text(), _cuda.CSRC)
    for name, subs in VARIANTS.items():
        src = here.read_text()
        for old, new in subs:
            assert src.count(old) == 1, (name, old)
            src = src.replace(old, new)
        libs[name] = build(name, src, _cuda.CSRC)

    dev = torch.device('cuda', 0)
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    r, t = cart_to_polar(*make_xy_grid(chip_smoke.N, diameter=2.2, device=dev))
    g = torch.randn(chip_smoke.N, chip_smoke.N, generator=gen).to(dev)
    plans = {what: (zk._plan(nms, True), torch.randn(len(nms), generator=gen).to(dev))
             for what, nms in (('NMS6', NMS6), ('45 modes', chip_smoke.NMS45),
                               ('66 modes', chip_smoke.NMS66))}
    for name, lib in libs.items():
        use(lib)
        for what in ('NMS6', '45 modes'):
            plan, c = plans[what]
            out = zk._launch_bwd_all(plan, c, r, t, g)
            ref = zk.zernike_bwd_all_plain(plan, c, r, t, g)
            err = max(chip_smoke.rel(o, p) for o, p in zip(out, ref))
            chip_smoke.require(err <= 1e-4, f'{name} {what}: {err}')
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        print(f'{name}: resident blocks per SM (kAll 4, 32 slots) '
              f'{[zk._resident_blocks(0, 2, k) // sms for k in zk._buckets()]}', flush=True)
    order = list(libs) + list(libs)[::-1]
    for name in order:
        use(libs[name])
        times = []
        for what, (plan, c) in plans.items():
            fn = lambda r, t, g, plan=plan, c=c: zk._launch_bwd_all(plan, c, r, t, g)  # noqa: E731
            times.append(f'all {what} {chip_smoke.cold_ms(fn, (r, t, g)):.5f} / '
                         f'{chip_smoke.warm_ms(lambda: fn(r, t, g)):.5f}')
        plan, c = plans['NMS6']
        for kind, fn in (('fwd', lambda r, t, g: zk._launch_fwd(plan, c, r, t)),
                         ('coefs', lambda r, t, g: zk._launch_bwd_coefs(plan, r, t, g))):
            times.append(f'{kind} NMS6 {chip_smoke.cold_ms(fn, (r, t, g)):.5f} / '
                         f'{chip_smoke.warm_ms(lambda: fn(r, t, g)):.5f}')
        print(f'{smi} | {name}: ms cold / warm: ' + '; '.join(times), flush=True)
    # a 64^2 grid: the body is a few thousand pixels, so what is left is the
    # launch and, for the backwards, the coefficient reduction's tail
    rs, ts, gs = r[:64, :64].contiguous(), t[:64, :64].contiguous(), g[:64, :64].contiguous()
    plan, c = plans['NMS6']
    for name in order:
        use(libs[name])
        times = {kind: chip_smoke.warm_ms(fn) for kind, fn in (
            ('fwd', lambda: zk._launch_fwd(plan, c, rs, ts)),
            ('coefs', lambda: zk._launch_bwd_coefs(plan, rs, ts, gs)),
            ('all', lambda: zk._launch_bwd_all(plan, c, rs, ts, gs)))}
        print(f'{smi} | {name}: NMS6 at 64^2, ms warm: '
              + '; '.join(f'{k} {v:.5f}' for k, v in times.items()), flush=True)


if __name__ == '__main__':
    main(*sys.argv[1:2])
