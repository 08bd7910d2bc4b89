// The two fronts of the fused channelizer chains, as device functions
// shared by the FM chain (fm_chain.cu) and the AM chain (am_chain.cu).
//
// A front computes, for one block of kTile threads and a group of kCG
// channels c0..c0+kCG-1, the un-rotated filtered sample
//   y[c, j] = sum_t x[j*D + t] * g_c[t]
// of the output whose window starts at sample g0 + threadIdx.x * D, into
// the thread's registers acc_re[kCG], acc_im[kCG]. Samples outside
// [0, nb) read as zeros.
//
//  - toeplitz_front: the dense complex tap bank, C*T complex MACs per
//    output (gsdr_tpu/kernels/fm_chain_pallas.py, _window_dot).
//  - pfb_front: channels on the uniform grid f_c = g_c * Fs / K with D | K
//    (gsdr_tpu/kernels/fm_chain_pallas.py, _pfb_fold_dot): the polyphase
//    fold a[v] = sum_u hp[u, v] * x[j*D + v + u*K] (Q = ceil(T/K) taps per
//    lane v, shared by all channels), then the (2C, 2K) DFT-bank product
//    y_re[c] = sum_v G[c, v] a_re[v] + G[c, K+v] a_im[v]
//    y_im[c] = sum_v G[C+c, v] a_re[v] + G[C+c, K+v] a_im[v].
//    The TPU kernel's lane roll with wrapped lanes from the next row is a
//    layout device of the TPU; here each thread indexes its window
//    directly, and each thread's fold feeds only its own output, so the
//    fold never leaves registers.
//
// Both fronts stage the block's input window in shared memory in
// polyphase order, xp[p][k] = x[g0 + k*D + p], so neighbouring threads
// (neighbouring outputs, D samples apart) read neighbouring words. The
// PFB front stages kPhaseChunk phases at a time, which bounds its shared
// memory for any D; its tap and bank tables are read as broadcasts.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace gsdr {

constexpr int kTile = 256;        // threads per block, one output each
constexpr int kCG = 16;           // channels per block (grid.y covers C)
constexpr int kPhaseChunk = 16;   // PFB front: input phases staged at once

// Dynamic shared memory of each front, in bytes.
__host__ __device__ inline size_t toeplitz_smem_bytes(int T, int D) {
  const size_t kr = kTile + (T - 1) / D;
  return sizeof(float) * ((size_t)T * kCG * 2 + 2 * (size_t)D * kr);
}

__host__ __device__ inline size_t pfb_smem_bytes(int K, int Q, int D) {
  const size_t dc = D < kPhaseChunk ? D : kPhaseChunk;
  const size_t kr = kTile + ((size_t)Q * K - 1) / D;
  return sizeof(float) * ((size_t)K * kCG * 4 + (size_t)Q * K + 2 * dc * kr);
}

// Sets *fits to 1 when a block of `kernel` with `dynamic` bytes of dynamic
// shared memory fits the current device: the kernel's static shared memory
// plus the dynamic size against the per-block opt-in limit. Returns 0 or
// the CUDA error. The libraries export it as <library>_fits, the check the
// Python side makes before a launch.
inline cudaError_t block_fits(const void* kernel, size_t dynamic, int* fits) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    *fits = attr.sharedSizeBytes + dynamic <= (size_t)optin ? 1 : 0;
  return err;
}

// Dense front. bank: (2C, 2, T) from make_complex_tap_bank; row 4c holds
// gr_c (applied to x_re), row 4c+2 holds gi_c. Shared memory: taps
// [T][kCG][2] as (re, im) pairs read as float4 broadcasts, then the
// window [D][Kr] for each plane.
__device__ __forceinline__ void toeplitz_front(
    float* smem, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb, const float* __restrict__ bank,
    int C, int T, int D, int c0, long g0, float (&acc_re)[kCG],
    float (&acc_im)[kCG]) {
  const int tid = threadIdx.x;
  float* taps = smem;
  const int Kr = kTile + (T - 1) / D;
  float* xp_re = taps + T * kCG * 2;
  float* xp_im = xp_re + D * Kr;
  for (int idx = tid; idx < T * kCG; idx += kTile) {
    const int t = idx / kCG, c = idx % kCG, cg = c0 + c;
    taps[2 * idx] = cg < C ? bank[(4 * cg) * T + t] : 0.f;           // gr
    taps[2 * idx + 1] = cg < C ? bank[(4 * cg + 2) * T + t] : 0.f;   // gi
  }
  for (int l = tid; l < D * Kr; l += kTile) {
    const long g = g0 + l;
    const bool in = g >= 0 && g < nb;
    const int s = (l % D) * Kr + l / D;
    xp_re[s] = in ? buf_re[g] : 0.f;
    xp_im[s] = in ? buf_im[g] : 0.f;
  }
  __syncthreads();

#pragma unroll
  for (int c = 0; c < kCG; ++c) acc_re[c] = acc_im[c] = 0.f;
  const float4* taps4 = reinterpret_cast<const float4*>(taps);
  int p = 0, q = 0;
  for (int t = 0; t < T; ++t) {
    const float xr = xp_re[p * Kr + tid + q];
    const float xi = xp_im[p * Kr + tid + q];
#pragma unroll
    for (int c2 = 0; c2 < kCG / 2; ++c2) {
      const float4 g = taps4[t * (kCG / 2) + c2];
      acc_re[2 * c2] = fmaf(xr, g.x, fmaf(-xi, g.y, acc_re[2 * c2]));
      acc_im[2 * c2] = fmaf(xr, g.y, fmaf(xi, g.x, acc_im[2 * c2]));
      acc_re[2 * c2 + 1] = fmaf(xr, g.z, fmaf(-xi, g.w, acc_re[2 * c2 + 1]));
      acc_im[2 * c2 + 1] = fmaf(xr, g.w, fmaf(xi, g.z, acc_im[2 * c2 + 1]));
    }
    if (++p == D) {
      p = 0;
      ++q;
    }
  }
}

// PFB front. hp: (Q, K) zero-padded polyphase taps hp[u, v] = h[v + K u];
// bank: planes-major (2C, 2K) DFT bank. Shared memory: the bank slice
// [K][kCG] as float4 (G[c, v], G[c, K+v], G[C+c, v], G[C+c, K+v]), the
// taps [Q][K], then kPhaseChunk phases of the window [Dc][Kr] per plane.
// Output phase p of lane v = p + s*D reads xp[p][tid + s + u*P], P = K/D.
__device__ __forceinline__ void pfb_front(
    float* smem, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb, const float* __restrict__ hp,
    const float* __restrict__ bank, int C, int K, int Q, int D, int c0,
    long g0, float (&acc_re)[kCG], float (&acc_im)[kCG]) {
  const int tid = threadIdx.x;
  float4* gb = reinterpret_cast<float4*>(smem);
  float* hps = smem + 4 * K * kCG;
  const int Dc = D < kPhaseChunk ? D : kPhaseChunk;
  const int Kr = kTile + (Q * K - 1) / D;
  float* xp_re = hps + Q * K;
  float* xp_im = xp_re + Dc * Kr;
  const int P = K / D;
  for (int idx = tid; idx < K * kCG; idx += kTile) {
    const int v = idx / kCG, cg = c0 + idx % kCG;
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
    if (cg < C) {
      const float* re_row = bank + (long)cg * 2 * K;
      const float* im_row = bank + (long)(C + cg) * 2 * K;
      g = make_float4(re_row[v], re_row[K + v], im_row[v], im_row[K + v]);
    }
    gb[idx] = g;
  }
  for (int idx = tid; idx < Q * K; idx += kTile) hps[idx] = hp[idx];

#pragma unroll
  for (int c = 0; c < kCG; ++c) acc_re[c] = acc_im[c] = 0.f;
  for (int p0 = 0; p0 < D; p0 += Dc) {
    const int np = D - p0 < Dc ? D - p0 : Dc;
    __syncthreads();   // the previous chunk's readers are done
    for (int l = tid; l < np * Kr; l += kTile) {
      const int pl = l % np, k = l / np;
      const long g = g0 + (long)k * D + p0 + pl;
      const bool in = g >= 0 && g < nb;
      xp_re[pl * Kr + k] = in ? buf_re[g] : 0.f;
      xp_im[pl * Kr + k] = in ? buf_im[g] : 0.f;
    }
    __syncthreads();
    for (int pl = 0; pl < np; ++pl) {
      const float* xr = xp_re + pl * Kr + tid;
      const float* xi = xp_im + pl * Kr + tid;
      for (int s = 0; s < P; ++s) {
        const int v = p0 + pl + s * D;
        float ar = 0.f, ai = 0.f;
        for (int u = 0; u < Q; ++u) {
          const float h = hps[u * K + v];
          ar = fmaf(h, xr[s + u * P], ar);
          ai = fmaf(h, xi[s + u * P], ai);
        }
        const float4* g = gb + v * kCG;
#pragma unroll
        for (int c = 0; c < kCG; ++c) {
          const float4 w = g[c];
          acc_re[c] = fmaf(w.x, ar, fmaf(w.y, ai, acc_re[c]));
          acc_im[c] = fmaf(w.z, ar, fmaf(w.w, ai, acc_im[c]));
        }
      }
    }
  }
}

}  // namespace gsdr
