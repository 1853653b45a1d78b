// Transpose of a planned bilinear warp, for Hopper (sm_90a).
//
//   warp_bwd_kernel  replaces no Pallas kernel: the JAX package leaves this
//                    transpose to XLA.
//
// Why it exists.  The DM's 10-degree fold (x/dm.py) pulls each output sample
// from four source samples.  Autograd's backward of those four gathers is a
// deterministic index_put with accumulation: linear indices, a radix sort of
// 1024^2 of them and a scatter, four times a step, 1.53 of the wavefront-control
// step's 2.28 ms of device time on an H100 (PERF.md).  The DM's grids are fixed,
// so ops/warp.py WarpPlan builds the transpose once: per source sample j, the
// taps that read it, in ascending (output, corner) order, as padded ELL
// table[k * nsrc + j] (k < K) holding 4 * output + corner, then -1.
//
// Design.  One thread per source sample walks its column and gathers: no
// atomics, no sort, one fixed order of summation, so the result is the same
// bits from run to run.  A padding slot ends the walk (padding is at the end of
// a column); a real tap whose weight is 0 is multiplied like any other, as
// autograd does, so a NaN cotangent reaches what it reaches there.  Neighbouring
// threads read neighbouring table entries (coalesced), and the cotangent and
// fractions of nearby output samples, which the fold keeps within a few rows.
//
// Arithmetic.  Corner c of output i contributes (g[i] * wr) * wc, where wr is
// fr[i] for the lower rows (c & 2) and 1 - fr[i] otherwise, and wc is fc[i] for
// the right columns (c & 1) and 1 - fc[i] otherwise: autograd's products in
// autograd's order.  The sum starts at 0 and adds in column order.  Every
// operation is an explicit round-to-nearest intrinsic, so nvcc contracts
// nothing into an FMA and the kernel equals the plain version in ops/warp.py
// (warp_bwd_plain) bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s): each real tap's 4-byte entry, the
// cotangent and the two fractions of each output sample, one write of each
// source sample.  At the fold's 1024^2 in float32 (about 4 million taps): 16 +
// 12 + 4 MB, about 10 us.  It is bytes-bound: two multiplies and an add a tap.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_bwd_kernel(const int32_t* __restrict__ table, int depth, long long nsrc,
                const T* __restrict__ g, const T* __restrict__ fr, const T* __restrict__ fc,
                T* __restrict__ out) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= nsrc) return;
  T acc = T(0);
  for (int k = 0; k < depth; ++k) {
    const int32_t e = __ldg(table + k * nsrc + j);
    if (e < 0) break;
    const int32_t i = e >> 2;
    const T r = __ldg(fr + i);
    const T c = __ldg(fc + i);
    const T wr = (e & 2) ? r : sub_rn(T(1), r);
    const T wc = (e & 1) ? c : sub_rn(T(1), c);
    acc = add_rn(acc, mul_rn(mul_rn(__ldg(g + i), wr), wc));
  }
  out[j] = acc;
}

template <typename T>
int launch(const int32_t* table, int depth, long long nsrc, const void* g, const void* fr,
           const void* fc, void* out, cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((nsrc + kThreads - 1) / kThreads);
  warp_bwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
      table, depth, nsrc, static_cast<const T*>(g), static_cast<const T*>(fr),
      static_cast<const T*>(fc), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64.  table: (depth, nsrc) int32; g, fr, fc: the
// output samples' cotangent and fractions; out: (nsrc,).  The wrapper checks
// that taps and source samples fit 32 bits.
int prysm_warp_bwd(int dtype, const void* table, int depth, long long nsrc, const void* g,
                   const void* fr, const void* fc, void* out, void* stream) {
  if (nsrc == 0) return 0;
  const auto* t = static_cast<const int32_t*>(table);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(t, depth, nsrc, g, fr, fc, out, s);
  if (dtype == 1) return launch<double>(t, depth, nsrc, g, fr, fc, out, s);
  return -1;
}

}  // extern "C"
