// QPSK256 nearest-neighbour demodulator for Hopper (sm_90a), float32.
//
// Replaces gsdr_tpu/kernels/qpsk256_pallas.py::_demod_kernel (entry
// qpsk256_demodulate_pallas). For every sample x it searches all 256 points
// of a table and writes the index of the lowest score
//   s_i = |c_i|^2 - 2 (c_i.re x.re + c_i.im x.im)
// (argmin_i |x - c_i|^2), the lowest index winning ties: a thread keeps a
// running (best score, best index) and replaces it only on a strict <, with
// the points in ascending order, as the original CUDA library's per-sample
// loop does and torch.argmin does.
//
// Rounding: the score is fmaf(-2, fmaf(c.im, x.im, c.re * x.re), |c|^2).
// 2 * cross is exact, so only the cross term rounds differently from the
// plain version's matmul; decisions agree bit for bit except on exact
// Voronoi boundaries, where both points are nearest and the card check
// holds the chosen point's distance to the best distance instead.
//
// |c|^2 is formed per block as __fadd_rn(__fmul_rn(re, re), __fmul_rn(im,
// im)): the plain version's float32 re*re + im*im, bit for bit, from the
// same table planes.
//
// What bounds it on the card: operations, 4 FLOP per (sample, point) score
// plus a compare and two selects (2^19 samples x 256 points: ~537 MFLOP,
// ~8 us at the FP32 peak, against ~2 us of HBM traffic). What the design
// does about that: the table lives in shared memory as (re, im, |c|^2, 0)
// float4, read as a broadcast (every thread reads the same point at the
// same step), one 16-byte load per point shared by kPerThread samples held
// in registers; the samples are strided by the block so loads and stores
// coalesce.

#include <cuda_runtime.h>

namespace {

constexpr int kPoints = 256;
constexpr int kThreads = 256;
constexpr int kPerThread = 4;

__device__ __forceinline__ float score(float4 c, float xr, float xi) {
  return fmaf(-2.f, fmaf(c.y, xi, c.x * xr), c.z);
}

__global__ void __launch_bounds__(kThreads) qpsk256_demod(
    const float* __restrict__ x_re, const float* __restrict__ x_im,
    const float* __restrict__ c_re, const float* __restrict__ c_im, long n,
    int* __restrict__ out) {
  __shared__ float4 tab[kPoints];
  for (int p = threadIdx.x; p < kPoints; p += kThreads) {
    const float r = c_re[p], i = c_im[p];
    tab[p] = make_float4(r, i, __fadd_rn(__fmul_rn(r, r), __fmul_rn(i, i)),
                         0.f);
  }
  __syncthreads();
  const long base = (long)blockIdx.x * kThreads * kPerThread + threadIdx.x;
  float xr[kPerThread], xi[kPerThread], best[kPerThread];
  int idx[kPerThread];
  const float4 c0 = tab[0];
#pragma unroll
  for (int s = 0; s < kPerThread; ++s) {
    const long i = base + (long)s * kThreads;
    xr[s] = i < n ? x_re[i] : 0.f;
    xi[s] = i < n ? x_im[i] : 0.f;
    best[s] = score(c0, xr[s], xi[s]);
    idx[s] = 0;
  }
#pragma unroll 4
  for (int p = 1; p < kPoints; ++p) {
    const float4 c = tab[p];
#pragma unroll
    for (int s = 0; s < kPerThread; ++s) {
      const float sc = score(c, xr[s], xi[s]);
      if (sc < best[s]) {
        best[s] = sc;
        idx[s] = p;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kPerThread; ++s) {
    const long i = base + (long)s * kThreads;
    if (i < n) out[i] = idx[s];
  }
}

}  // namespace

extern "C" const char* qpsk256_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shapes: x planes (n,), table planes (256,), out (n,) int32. Returns 0
// or the CUDA error code.
extern "C" int qpsk256_launch(const void* x_re, const void* x_im,
                              const void* c_re, const void* c_im, void* out,
                              long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long per_block = (long)kThreads * kPerThread;
  const long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  qpsk256_demod<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x_re, (const float*)x_im, (const float*)c_re,
      (const float*)c_im, n, (int*)out);
  return (int)cudaGetLastError();
}
