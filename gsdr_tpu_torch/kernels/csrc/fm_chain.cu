// Fused C-channel FM receive chain for Hopper (sm_90a), float32 grade.
//
// Replaces gsdr_tpu/kernels/fm_chain_pallas.py::_fm_chain_kernel with its
// dense (toeplitz) front. Per decimated output j and channel c it computes
//   y[c,j]  = sum_t x[j*D + t] * g_c[t]               complex tap bank
//   f[c,j]  = y[c,j] * e^{i 2 pi frac(f_c (n0 + j D) / Fs)}   LO rotor
//   d[c,j]  = gain * atan2(f[c,j] * conj(f[c,j-1]))   discriminator
//   z[c,j]  = cc*d[c,j] + a*z[c,j-1],  out[c,j] = b0*d[c,j] + z[c,j-1]
// with f[c,-1] and z[c,-1] carried in from the previous block and the
// carries exported at j = M-1.
//
// What bounds it on the card: the contraction is C*T*8/D FP32 operations
// per input sample (2048 at the flagship 16 channels, 64 taps, D=4: 2.15
// GFLOP per 2^20-sample step) against about 25 MB of HBM traffic, so it is
// bound by non-tensor FP32 FMA, not by memory.
//
// What the design does about that:
//  - one thread per decimated output accumulates all CG=16 channels in
//    registers, so every input sample loaded is reused for 16 channels;
//  - the tap bank sits in shared memory interleaved as (re, im) pairs per
//    tap, read as float4 broadcasts: 8 vector loads feed 64 FMAs per tap;
//  - the block's input window sits in shared memory in polyphase order,
//    xp[p][k] = x[k*D + p], so x[j*D + t] = xp[t % D][j + t / D] and
//    neighbouring threads read neighbouring words (no D-strided conflicts);
//  - the rotor uses the exact digit-table phase with the same float32
//    operation order as the plain chain, then one sincosf per output;
//  - the discriminator takes f[j-1] from the neighbouring lane by shuffle
//    (shared memory at warp edges); thread 0 of every block recomputes the
//    previous block's last output, so blocks need no ordering;
//  - the de-emphasis is linear, so blocks scan their tile from z = 0
//    (launch 1), a small scan over tiles finds every tile's true start
//    state (launch 2), and a last pass adds a^(j-j0) * z_start (launch 3).
// Moving the contraction onto the tensor cores is the next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;            // threads per block, one output each
constexpr int kOut = kTile - 1;       // new outputs per block
constexpr int kCG = 16;               // channels per block (grid.y covers C)
constexpr int kWarps = kTile / 32;
constexpr int kScan = 1024;           // threads of the tile-scan block
constexpr float kTwoPi = 6.283185307179586f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float ipow(float a, int k) {
  float r = 1.f, b = a;
  while (k) {
    if (k & 1) r *= b;
    b *= b;
    k >>= 1;
  }
  return r;
}

// Launch 1: contraction, rotor, discriminator and the zero-state
// de-emphasis of one tile of kOut outputs for kCG channels.
__global__ void __launch_bounds__(kTile) fm_chain_tile(
    const float* __restrict__ buf_re, const float* __restrict__ buf_im,
    int nb, const float* __restrict__ bank, int C, int T, int D, int M,
    int ntiles, const float* __restrict__ table,
    const int* __restrict__ n0_rot, const float* __restrict__ coef,
    float gain, const float* __restrict__ cf_re_in,
    const float* __restrict__ cf_im_in, float* __restrict__ audio,
    float* __restrict__ cf_re_out, float* __restrict__ cf_im_out,
    float* __restrict__ zend) {
  extern __shared__ float4 smem4[];
  float* taps = reinterpret_cast<float*>(smem4);   // [T][kCG][2]
  float* tab = taps + T * kCG * 2;                 // [kCG][4]
  const int K = kTile + (T - 1) / D;               // polyphase row length
  float* xp_re = tab + kCG * 4;                    // [D][K]
  float* xp_im = xp_re + D * K;                    // [D][K]
  __shared__ float y_edge[kWarps][kCG][2];
  __shared__ float z_edge[kWarps][kCG];
  __shared__ float z_last[kWarps][kCG];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int c0 = blockIdx.y * kCG;
  const int j0 = tile * kOut;
  const int j = j0 - 1 + tid;                      // this thread's output

  for (int idx = tid; idx < T * kCG; idx += kTile) {
    const int t = idx / kCG, c = idx % kCG, cg = c0 + c;
    taps[2 * idx] = cg < C ? bank[(4 * cg) * T + t] : 0.f;           // gr
    taps[2 * idx + 1] = cg < C ? bank[(4 * cg + 2) * T + t] : 0.f;   // gi
  }
  for (int idx = tid; idx < kCG * 4; idx += kTile) {
    const int cg = c0 + idx / 4;
    tab[idx] = cg < C ? table[cg * 4 + idx % 4] : 0.f;
  }
  const long g0 = (long)(j0 - 1) * D;
  for (int l = tid; l < D * K; l += kTile) {
    const long g = g0 + l;
    const bool in = g >= 0 && g < nb;
    const int s = (l % D) * K + l / D;
    xp_re[s] = in ? buf_re[g] : 0.f;
    xp_im[s] = in ? buf_im[g] : 0.f;
  }
  __syncthreads();

  // ---- 1) tap-bank contraction ------------------------------------------
  float acc_re[kCG], acc_im[kCG];
#pragma unroll
  for (int c = 0; c < kCG; ++c) acc_re[c] = acc_im[c] = 0.f;
  const float4* taps4 = reinterpret_cast<const float4*>(taps);
  int p = 0, q = 0;
  for (int t = 0; t < T; ++t) {
    const float xr = xp_re[p * K + tid + q];
    const float xi = xp_im[p * K + tid + q];
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

  // ---- 2) LO rotor from the digit table ---------------------------------
  const int idx = n0_rot[0] + j * D;
  float fdig[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) fdig[d] = (float)((idx >> (8 * d)) & 255);
#pragma unroll
  for (int c = 0; c < kCG; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < 4; ++d)
      acc = __fadd_rn(acc, __fmul_rn(fdig[d], tab[c * 4 + d]));
    const float frac = __fsub_rn(acc, floorf(acc));
    float s, co;
    sincosf(__fmul_rn(kTwoPi, frac), &s, &co);
    const float yr = acc_re[c], yi = acc_im[c];
    acc_re[c] = yr * co - yi * s;
    acc_im[c] = yr * s + yi * co;
  }
  if (j < 0) {   // block 0, thread 0: the carried previous sample
#pragma unroll
    for (int c = 0; c < kCG; ++c) {
      acc_re[c] = c0 + c < C ? cf_re_in[c0 + c] : 0.f;
      acc_im[c] = c0 + c < C ? cf_im_in[c0 + c] : 0.f;
    }
  }
  if (j == M - 1) {
#pragma unroll
    for (int c = 0; c < kCG; ++c) {
      if (c0 + c < C) {
        cf_re_out[c0 + c] = acc_re[c];
        cf_im_out[c0 + c] = acc_im[c];
      }
    }
  }

  // ---- 3) discriminator: f[j] * conj(f[j-1]) -------------------------------
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < kCG; ++c) {
      y_edge[warp][c][0] = acc_re[c];
      y_edge[warp][c][1] = acc_im[c];
    }
  }
  __syncthreads();
  const bool real = tid > 0 && j < M;   // an output this block writes
  float dsc[kCG];
#pragma unroll
  for (int c = 0; c < kCG; ++c) {
    float pr = __shfl_up_sync(kFull, acc_re[c], 1);
    float pi = __shfl_up_sync(kFull, acc_im[c], 1);
    if (lane == 0 && warp > 0) {
      pr = y_edge[warp - 1][c][0];
      pi = y_edge[warp - 1][c][1];
    }
    const float fr = acc_re[c], fi = acc_im[c];
    const float m_re = fr * pr + fi * pi;
    const float m_im = fi * pr - fr * pi;
    // a zero product (the zero-primed first output) reads 0, as the TPU
    // kernel's polynomial atan2 does, not atan2f(+-0, -0) = +-pi
    const bool zero = m_re == 0.f && m_im == 0.f;
    dsc[c] = real && !zero ? gain * atan2f(m_im, m_re) : 0.f;
  }

  // ---- 4) de-emphasis from z = 0 at the tile start -------------------------
  const float b0 = coef[0], cc = coef[1], a = coef[2];
  float z[kCG];
#pragma unroll
  for (int c = 0; c < kCG; ++c) z[c] = cc * dsc[c];
  float as = a;   // a^s
  for (int s = 1; s < 32; s <<= 1) {
#pragma unroll
    for (int c = 0; c < kCG; ++c) {
      const float v = __shfl_up_sync(kFull, z[c], s);
      if (lane >= s) z[c] = fmaf(as, v, z[c]);
    }
    as *= as;
  }
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < kCG; ++c) z_edge[warp][c] = z[c];
  }
  __syncthreads();
  const float a32 = as;            // a^32
  const float a_lane = ipow(a, lane + 1);
#pragma unroll
  for (int c = 0; c < kCG; ++c) {
    float sprev = 0.f;             // state at the end of the previous warp
    for (int w = 0; w < warp; ++w) sprev = fmaf(a32, sprev, z_edge[w][c]);
    z[c] = fmaf(a_lane, sprev, z[c]);
  }
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < kCG; ++c) z_last[warp][c] = z[c];
  }
  __syncthreads();
  const int n_real = min(kOut, M - j0);   // outputs of this tile
#pragma unroll
  for (int c = 0; c < kCG; ++c) {
    float zp = __shfl_up_sync(kFull, z[c], 1);
    if (lane == 0 && warp > 0) zp = z_last[warp - 1][c];
    if (c0 + c < C) {
      if (real) audio[(long)(c0 + c) * M + j] = fmaf(b0, dsc[c], zp);
      if (tid == n_real) zend[(long)(c0 + c) * ntiles + tile] = z[c];
    }
  }
}

// Launch 2: per channel, the true start state of every tile,
// z_start[k+1] = a^L_k * z_start[k] + zend[k], from z_start[0] = zi.
__global__ void __launch_bounds__(kScan) fm_chain_tile_scan(
    const float* __restrict__ zend, const float* __restrict__ zi,
    const float* __restrict__ coef, int M, int ntiles,
    float* __restrict__ zstart, float* __restrict__ zf) {
  __shared__ float w_a[kScan / 32], w_u[kScan / 32];
  __shared__ float chunk_end;
  const int c = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const float a = coef[2];
  const float* ze = zend + (long)c * ntiles;
  float* zs = zstart + (long)c * ntiles;
  float carry = zi[c];
  if (tid == 0) zs[0] = carry;
  for (int base = 0; base < ntiles; base += kScan) {
    const int k = base + tid;
    float A = 1.f, u = 0.f;        // the affine map of tile k
    if (k < ntiles) {
      A = ipow(a, min(kOut, M - k * kOut));
      u = ze[k];
    }
    for (int s = 1; s < 32; s <<= 1) {
      const float ap = __shfl_up_sync(kFull, A, s);
      const float up = __shfl_up_sync(kFull, u, s);
      if (lane >= s) {
        u = fmaf(A, up, u);
        A *= ap;
      }
    }
    if (lane == 31) {
      w_a[warp] = A;
      w_u[warp] = u;
    }
    __syncthreads();
    if (warp == 0) {               // scan of the warp totals
      float wa = w_a[lane], wu = w_u[lane];
      for (int s = 1; s < 32; s <<= 1) {
        const float ap = __shfl_up_sync(kFull, wa, s);
        const float up = __shfl_up_sync(kFull, wu, s);
        if (lane >= s) {
          wu = fmaf(wa, up, wu);
          wa *= ap;
        }
      }
      __syncwarp();
      w_a[lane] = wa;
      w_u[lane] = wu;
    }
    __syncthreads();
    if (warp > 0) {                // compose after the previous warps
      u = fmaf(A, w_u[warp - 1], u);
      A *= w_a[warp - 1];
    }
    const float z_after = fmaf(A, carry, u);
    if (k < ntiles) {
      if (k + 1 < ntiles) zs[k + 1] = z_after;
      else zf[c] = z_after;
    }
    if (tid == kScan - 1) chunk_end = z_after;
    __syncthreads();
    carry = chunk_end;
    __syncthreads();
  }
}

// Launch 3: out[c, j] += a^(j - j0) * z_start[c, tile(j)].
__global__ void fm_chain_inject(float* __restrict__ audio,
                                const float* __restrict__ zstart,
                                const float* __restrict__ coef, int C, int M,
                                int ntiles) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)C * M) return;
  const int c = (int)(i / M), j = (int)(i % M);
  const int k = j / kOut;
  audio[i] = fmaf(ipow(coef[2], j - k * kOut), zstart[(long)c * ntiles + k],
                  audio[i]);
}

}  // namespace

extern "C" int fm_chain_tile_outputs() { return kOut; }

extern "C" const char* fm_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Runs the chain on `stream`; returns 0 or the first CUDA error code.
// Shapes: buf planes (nb,), bank (2C, 2, T), table (C, 4), n0_rot (1,) int32,
// coef (3,) = (b0, cc, a), carries (C,), audio (C, M), zend/zstart
// (C, ntiles) scratch.
extern "C" int fm_chain_launch(
    const void* buf_re, const void* buf_im, const void* bank,
    const void* table, const void* n0_rot, const void* coef,
    const void* cf_re_in, const void* cf_im_in, const void* cz_in,
    void* audio, void* cf_re_out, void* cf_im_out, void* cz_out, void* zend,
    void* zstart, int nb, int C, int T, int D, int M, int ntiles, float gain,
    void* stream) {
  if (C < 1 || T < 1 || D < 1 || M < 1 || M != (nb - T) / D + 1 ||
      ntiles != (M + kOut - 1) / kOut)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int K = kTile + (T - 1) / D;
  const size_t smem = sizeof(float) * ((size_t)T * kCG * 2 + kCG * 4 +
                                       2 * (size_t)D * K);
  cudaError_t err = cudaFuncSetAttribute(
      fm_chain_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(ntiles, (C + kCG - 1) / kCG);
  fm_chain_tile<<<grid, kTile, smem, st>>>(
      (const float*)buf_re, (const float*)buf_im, nb, (const float*)bank, C,
      T, D, M, ntiles, (const float*)table, (const int*)n0_rot,
      (const float*)coef, gain, (const float*)cf_re_in,
      (const float*)cf_im_in, (float*)audio, (float*)cf_re_out,
      (float*)cf_im_out, (float*)zend);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fm_chain_tile_scan<<<C, kScan, 0, st>>>(
      (const float*)zend, (const float*)cz_in, (const float*)coef, M, ntiles,
      (float*)zstart, (float*)cz_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long total = (long)C * M;
  fm_chain_inject<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      (float*)audio, (const float*)zstart, (const float*)coef, C, M, ntiles);
  return (int)cudaGetLastError();
}
