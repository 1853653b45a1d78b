"""Time variants of csrc/noise.cu's design choices, on one card.

    env PYTHONPATH=. python3 probes/noise_probe.py

Builds ``noise.cu`` as it is and the variants in ``VARIANTS`` (each one
choice changed: 2 pixels a thread, one Philox call, instead of 4; 1 or
8 frames a thread instead of 4; the registers capped for 6 or 8 resident
blocks; the store; the frame loop unrolled; the library's logf in place of
the fast path written out in the source) with the flags of
``ops/_cuda.py`` into ``_probe/noise/``, one nvcc each, started together;
holds each against the plain version on a 512^2 map, then times each at
512^2 x 1 and 512^2 x 16, cold and warm, in turns (in order, then in the
reverse order), with ``chip_smoke.py``'s timers.  Prints one line per time
with the card's name and power limit.  The variants are substitutions of
the source's text: a variant whose text is gone from the source fails its
build with the pattern it missed.
"""
import ctypes
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke
from prysm_tpu_torch.ops import _cuda, noise

OUT = Path('_probe/noise')
ARGS = (5.0, 100.0, 60e3, 0.5, 14)  # cfg5's read noise, bias, full well, gain, bits
# the store of 2 pixels in one access, for the 2-pixels variant
VEC2 = '''template <>
struct Vec<2> {
  using T = float2;
  __device__ static float2 of(const float* v) { return make_float2(v[0], v[1]); }
};
using VecT'''
# name: ((pattern, replacement), ...) applied to noise.cu
VARIANTS = {
    'as built': (),
    '2 pixels a thread': ((r'constexpr int kCells = \d+;', 'constexpr int kCells = 2;'),
                          (r'using VecT', VEC2)),
    '1 frame a thread': ((r'constexpr int kFrames = \d+;', 'constexpr int kFrames = 1;'),),
    '8 frames a thread': ((r'constexpr int kFrames = \d+;', 'constexpr int kFrames = 8;'),),
    '6 blocks an SM': ((r'__launch_bounds__\(kThreads\)', '__launch_bounds__(kThreads, 6)'),),
    '8 blocks an SM': ((r'__launch_bounds__\(kThreads\)', '__launch_bounds__(kThreads, 8)'),),
    'plain store': ((r'__stcg\(reinterpret_cast<VecT\*>\(dst\), Vec<kCells>::of\(dn\)\);',
                     '*reinterpret_cast<VecT*>(dst) = Vec<kCells>::of(dn);'),),
    'streaming store': ((r'__stcg\(', '__stcs('),),
    'frames unrolled by 2': ((r'#pragma unroll 1\n  for \(uint32_t frame',
                              '#pragma unroll 2\n  for (uint32_t frame'),),
    'library logf': ((r'log_uniform\(u1\[k\]\)', 'logf(u1[k])'),),
}


def stem(name):
    return re.sub(r'\W+', '_', name)


def build(name, subs):
    src = (_cuda.CSRC / 'noise.cu').read_text()
    for pattern, value in subs:
        src, n = re.subn(pattern, value, src, flags=re.S)
        assert n == 1, f'{name}: {pattern} not found in noise.cu'
    cu, so = OUT / f'noise_{stem(name)}.cu', OUT / f'libnoise_{stem(name)}.so'
    cu.write_text(src)
    log = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, '-I', str(_cuda.CSRC), '-o', str(so),
                          str(cu)], capture_output=True, text=True, check=True)
    return so, ' '.join(line.strip() for line in (log.stdout + log.stderr).splitlines()
                        if 'registers' in line or 'spill' in line)


def load(so):
    lib = ctypes.CDLL(str(so.resolve()))
    lib.prysm_noise_expose.argtypes = noise._lib().prysm_noise_expose.argtypes
    lib.prysm_noise_expose.restype = ctypes.c_int
    return lib


def expose(lib, lam, frames, seed=0):
    out = torch.empty((frames, *lam.shape), dtype=torch.float32, device=lam.device)
    rc = lib.prysm_noise_expose(lam.data_ptr(), out.data_ptr(), lam.numel(), frames, seed,
                                *noise._chain_args(*ARGS),
                                torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out


def main():
    smi = chip_smoke.card()
    dev = torch.device('cuda', 0)
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    lam = (20.0 + 5e4 * torch.rand(512, 512, generator=gen)).to(dev)
    OUT.mkdir(parents=True, exist_ok=True)
    noise._lib()  # the shipped library, built once before the variants
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        builds = dict(zip(VARIANTS, pool.map(build, VARIANTS, VARIANTS.values())))
    libs = {}
    for name, (so, log) in builds.items():
        print(f'{name}: {log}', flush=True)
        libs[name] = load(so)
    for name, lib in libs.items():
        for frames in (1, 4):
            chip_smoke.noise_agreement(expose(lib, lam, frames), noise.expose_plain(
                lam, frames, 0, *ARGS), 0.5, f'{name} 512^2 x {frames}')
    for frames in (1, 16):
        for name in list(libs) + list(libs)[::-1]:
            fn = lambda lam, lib=libs[name]: expose(lib, lam, frames)  # noqa: E731
            print(f'{smi} | noise {name} 512^2 x {frames}: cold '
                  f'{chip_smoke.cold_ms(fn, (lam,)):.5f} warm '
                  f'{chip_smoke.warm_ms(lambda: fn(lam)):.5f} ms', flush=True)


if __name__ == '__main__':
    main()
