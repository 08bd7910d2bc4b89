// Exact IIR filter of order 1-8 with distinct poles for Hopper (sm_90a),
// float32: the pole-diagonalized scan.
//
// Replaces gsdr_tpu/kernels/iir_pallas.py::_iir_kernel (entry iir_pallas).
// With the transposed-DF-II state matrix M = Q diag(p) Q^-1, each pole
// representative k (one per conjugate pair, weight 2; real poles weight 1;
// at most 4) runs an independent complex first-order scan
//   s_k[n] = p_k s_k[n-1] + w_k x[n],        s_k[-1] = (Q^-1 zi)_k
//   y[n]   = b0 x[n] + sum_k wgt_k Re(q_k s_k[n-1])
//   zf     = sum_k wgt_k Re(Qcol_k s_k[N-1])
// (w = Q^-1 c, q = Q[0, :]). The host (kernels/iir.py) diagonalizes in
// float64 and hands over one float32 table ("coef", layout below) with
// every constant and the powers p^(kSpan*j), j = 0..kThreads, also formed
// in float64: no power of a pole is built by repeated float32 products
// except inside the tile-start scan of launch 2, where each start state
// multiplies at most log2(1024) products of p^kTile.
//
// One launch of iir_launch filters R rows (grid.y), so a planar signal is
// one call of two rows. Three grid launches, each a tile of kTile = kSpan *
// kThreads samples per block, kSpan consecutive samples per thread:
//  1. iir_tile_reduce: the zero-state state at the end of every tile, per
//     pole: each thread runs the recurrence over its kSpan samples, the
//     block sums the thread results weighted by p^(kSpan*(threads after it)).
//  2. iir_tile_scan: per row, one block scans the tile end states from s0
//     = Q^-1 zi with the multiplier p^kTile (affine-pair scan, warp
//     shuffles, 1024 tiles per chunk) and writes every tile's start state.
//  3. iir_tile_apply: every tile reruns its zero-state thread scans, finds
//     each thread's start state from the tile's with a weighted prefix scan
//     over the threads (multipliers p^(kSpan*d) from the table), replays its
//     samples from there writing y, and the thread holding sample N-1
//     writes zf from the state after it. Samples past N read as 0 and are
//     not written, so any N >= 1 works.
//
// What bounds it on the card: bytes. One float32 read and one write per
// sample (8 B) against ~10 FLOP per pole pair per sample for the state
// update, ~4 for the output and 2 for b0*x: 58 FLOP per sample at order 8
// is 0.9 us per 2^20 samples at the FP32 peak, under the 2.5 us of HBM
// traffic. What the design does about that: the signal is read twice
// (launches 1 and 3, 12 B per sample, the second read often from L2) and
// written once; launch 2 touches only the per-tile states. A single pass
// with a decoupled look-back would read it once; that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSpan = 16;                  // consecutive samples per thread
constexpr int kThreads = 256;              // threads of a tile block
constexpr int kTile = kSpan * kThreads;    // samples per tile
constexpr int kWarps = kThreads / 32;
constexpr int kScan = 1024;                // tiles per chunk of launch 2
constexpr int kMaxPairs = 4;
constexpr int kMaxOrder = 8;
constexpr int kMaxRows = 8;
constexpr unsigned kFull = 0xffffffffu;

// coef layout, float32, complex values as (re, im) at even offsets:
//   kB0            b0
//   kPole + 2k     p_k
//   kW + 2k        w_k
//   kQ + 2k        wgt_k * q_k
//   kQcol + 2(kMaxOrder k + i)   wgt_k * Q[i, k]      (i < order)
//   kQinv + 2(kMaxOrder k + j)   Q^-1[k, j]           (j < order)
//   kPow + 2(kPowLen k + j)      p_k^(kSpan j)        (j = 0..kThreads)
// Mirrored by kernels/iir.py::coef_table.
constexpr int kB0 = 0;
constexpr int kPole = 2;
constexpr int kW = kPole + 2 * kMaxPairs;
constexpr int kQ = kW + 2 * kMaxPairs;
constexpr int kQcol = kQ + 2 * kMaxPairs;
constexpr int kQinv = kQcol + 2 * kMaxPairs * kMaxOrder;
constexpr int kPow = kQinv + 2 * kMaxPairs * kMaxOrder;
constexpr int kPowLen = kThreads + 1;
constexpr int kCoefLen = kPow + 2 * kMaxPairs * kPowLen;

struct Rows {
  const float* x[kMaxRows];
  float* y[kMaxRows];
  const float* zi[kMaxRows];   // null: zero initial state
  float* zf[kMaxRows];
};

__device__ __forceinline__ float2 ld2(const float* __restrict__ coef,
                                      int off) {
  return __ldg(reinterpret_cast<const float2*>(coef + off));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// a * b + c
__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 c) {
  return make_float2(fmaf(a.x, b.x, fmaf(-a.y, b.y, c.x)),
                     fmaf(a.x, b.y, fmaf(a.y, b.x, c.y)));
}

// p * s + w * x, the per-sample update
__device__ __forceinline__ float2 step(float2 p, float2 s, float2 w,
                                       float x) {
  return make_float2(fmaf(p.x, s.x, fmaf(-p.y, s.y, w.x * x)),
                     fmaf(p.x, s.y, fmaf(p.y, s.x, w.y * x)));
}

__device__ __forceinline__ float2 shfl_up2(float2 v, int d) {
  return make_float2(__shfl_up_sync(kFull, v.x, d),
                     __shfl_up_sync(kFull, v.y, d));
}

__device__ __forceinline__ float2 shfl_xor2(float2 v, int d) {
  return make_float2(__shfl_xor_sync(kFull, v.x, d),
                     __shfl_xor_sync(kFull, v.y, d));
}

// The kSpan samples of one thread from base, 0 past n.
__device__ __forceinline__ void load_span(const float* __restrict__ x,
                                          long base, long n,
                                          float (&v)[kSpan]) {
  if (base + kSpan <= n && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
#pragma unroll
    for (int j = 0; j < kSpan; j += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(x + base + j));
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSpan; ++j) v[j] = base + j < n ? __ldg(x + base + j)
                                                        : 0.f;
  }
}

// Launch 1: tile_end[r, tile, k] = zero-state s_k after the tile.
template <int P>
__global__ void __launch_bounds__(kThreads) iir_tile_reduce(
    Rows rows, const float* __restrict__ coef, long n, int ntiles,
    float2* __restrict__ tile_end) {
  __shared__ float2 part[P][kWarps];
  const int tile = blockIdx.x, r = blockIdx.y, tid = threadIdx.x,
            lane = tid & 31, warp = tid >> 5;
  float xv[kSpan];
  load_span(rows.x[r], (long)tile * kTile + (long)tid * kSpan, n, xv);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float2 p = ld2(coef, kPole + 2 * k), w = ld2(coef, kW + 2 * k);
    float2 u = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kSpan; ++j) u = step(p, u, w, xv[j]);
    // carried through the spans of the threads after this one
    u = cmul(ld2(coef, kPow + 2 * (kPowLen * k + kThreads - 1 - tid)), u);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const float2 o = shfl_xor2(u, d);
      u.x += o.x;
      u.y += o.y;
    }
    if (lane == 0) part[k][warp] = u;
  }
  __syncthreads();
  if (tid < P) {
    float2 sum = part[tid][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      sum.x += part[tid][w].x;
      sum.y += part[tid][w].y;
    }
    tile_end[((long)r * ntiles + tile) * P + tid] = sum;
  }
}

// Launch 2, one block per row: tile_start[r, i, k] from s0 = Q^-1 zi and
// the recurrence S[i+1] = p^kTile S[i] + tile_end[i].
template <int P>
__global__ void __launch_bounds__(kScan) iir_tile_scan(
    Rows rows, const float* __restrict__ coef, int order, int ntiles,
    const float2* __restrict__ tile_end, float2* __restrict__ tile_start) {
  __shared__ float2 w_a[kScan / 32], w_u[kScan / 32];
  __shared__ float2 chunk_end;
  const int r = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const float* zi = rows.zi[r];
  const float2* te = tile_end + (long)r * ntiles * P;
  float2* ts = tile_start + (long)r * ntiles * P;
  for (int k = 0; k < P; ++k) {
    float2 carry = make_float2(0.f, 0.f);
    if (zi != nullptr) {
      for (int j = 0; j < order; ++j) {
        const float2 qi = ld2(coef, kQinv + 2 * (kMaxOrder * k + j));
        const float z = __ldg(zi + j);
        carry.x = fmaf(qi.x, z, carry.x);
        carry.y = fmaf(qi.y, z, carry.y);
      }
    }
    const float2 pt = ld2(coef, kPow + 2 * (kPowLen * k + kThreads));
    if (tid == 0) ts[k] = carry;
    for (int base = 0; base < ntiles; base += kScan) {
      const int i = base + tid;
      float2 A = make_float2(1.f, 0.f), u = make_float2(0.f, 0.f);
      if (i < ntiles) {
        A = pt;
        u = te[(long)i * P + k];
      }
      // inclusive scan of the affine maps s -> A s + u, earliest first
      for (int s = 1; s < 32; s <<= 1) {
        const float2 ap = shfl_up2(A, s), up = shfl_up2(u, s);
        if (lane >= s) {
          u = cfma(A, up, u);
          A = cmul(A, ap);
        }
      }
      if (lane == 31) {
        w_a[warp] = A;
        w_u[warp] = u;
      }
      __syncthreads();
      if (warp == 0) {
        float2 wa = w_a[lane], wu = w_u[lane];
        for (int s = 1; s < 32; s <<= 1) {
          const float2 ap = shfl_up2(wa, s), up = shfl_up2(wu, s);
          if (lane >= s) {
            wu = cfma(wa, up, wu);
            wa = cmul(wa, ap);
          }
        }
        __syncwarp();
        w_a[lane] = wa;
        w_u[lane] = wu;
      }
      __syncthreads();
      if (warp > 0) {
        u = cfma(A, w_u[warp - 1], u);
        A = cmul(A, w_a[warp - 1]);
      }
      const float2 e = cfma(A, carry, u);   // the state after tile i
      if (i + 1 < ntiles) ts[(long)(i + 1) * P + k] = e;
      if (tid == kScan - 1) chunk_end = e;
      __syncthreads();
      carry = chunk_end;
      __syncthreads();
    }
  }
}

// Launch 3: y of every sample from the true start states; zf at N-1.
template <int P>
__global__ void __launch_bounds__(kThreads) iir_tile_apply(
    Rows rows, const float* __restrict__ coef, int order, long n,
    int ntiles, const float2* __restrict__ tile_start) {
  __shared__ float2 wtot[P][kWarps];
  const int tile = blockIdx.x, r = blockIdx.y, tid = threadIdx.x,
            lane = tid & 31, warp = tid >> 5;
  const long base = (long)tile * kTile + (long)tid * kSpan;
  float xv[kSpan];
  load_span(rows.x[r], base, n, xv);
  // per pole, the weighted inclusive prefix over the threads of the warp,
  // v_t = sum_{t' <= t in the warp} p^(kSpan (t - t')) u_t'
  float2 v[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float2 p = ld2(coef, kPole + 2 * k), w = ld2(coef, kW + 2 * k);
    const int pw = kPow + 2 * kPowLen * k;
    float2 u = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kSpan; ++j) u = step(p, u, w, xv[j]);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float2 o = shfl_up2(u, d);
      if (lane >= d) u = cfma(ld2(coef, pw + 2 * d), o, u);
    }
    v[k] = u;
    if (lane == 31) wtot[k][warp] = u;
  }
  __syncthreads();

  const float b0 = __ldg(coef + kB0);
  float yv[kSpan];
#pragma unroll
  for (int j = 0; j < kSpan; ++j) yv[j] = b0 * xv[j];
  const long last = n - 1;
  const bool owns_last = last >= base && last < base + kSpan;
  const int jl = (int)(last - base);
  float2 s_last[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float2 p = ld2(coef, kPole + 2 * k), w = ld2(coef, kW + 2 * k),
                 qw = ld2(coef, kQ + 2 * k);
    const int pw = kPow + 2 * kPowLen * k;
    // the prefix of the earlier warps, at the end of warp - 1
    const float2 p32 = ld2(coef, pw + 2 * 32);
    float2 wp = make_float2(0.f, 0.f);
    for (int q = 0; q < warp; ++q) wp = cfma(p32, wp, wtot[k][q]);
    // the state after this thread's span, from a zero tile start, and the
    // one before it
    const float2 incl = cfma(ld2(coef, pw + 2 * (lane + 1)), wp, v[k]);
    float2 before = shfl_up2(incl, 1);
    if (lane == 0) before = wp;
    float2 s = cfma(ld2(coef, pw + 2 * tid),
                    tile_start[((long)r * ntiles + tile) * P + k], before);
    s_last[k] = s;
#pragma unroll
    for (int j = 0; j < kSpan; ++j) {
      yv[j] = fmaf(qw.x, s.x, fmaf(-qw.y, s.y, yv[j]));
      s = step(p, s, w, xv[j]);
      if (j == jl) s_last[k] = s;
    }
  }

  float* y = rows.y[r];
  if (base + kSpan <= n && (reinterpret_cast<uintptr_t>(y) & 15) == 0) {
#pragma unroll
    for (int j = 0; j < kSpan; j += 4)
      *reinterpret_cast<float4*>(y + base + j) =
          make_float4(yv[j], yv[j + 1], yv[j + 2], yv[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kSpan; ++j)
      if (base + j < n) y[base + j] = yv[j];
  }
  if (owns_last) {
    float* zf = rows.zf[r];
    for (int i = 0; i < order; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float2 qc = ld2(coef, kQcol + 2 * (kMaxOrder * k + i));
        acc = fmaf(qc.x, s_last[k].x, fmaf(-qc.y, s_last[k].y, acc));
      }
      zf[i] = acc;
    }
  }
}

template <int P>
int run(const Rows& rows, const float* coef, int order, long n, int ntiles,
        int nrows, float2* tile_end, float2* tile_start, cudaStream_t st) {
  const dim3 grid((unsigned)ntiles, (unsigned)nrows);
  iir_tile_reduce<P><<<grid, kThreads, 0, st>>>(rows, coef, n, ntiles,
                                                 tile_end);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  iir_tile_scan<P><<<nrows, kScan, 0, st>>>(rows, coef, order, ntiles,
                                             tile_end, tile_start);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  iir_tile_apply<P><<<grid, kThreads, 0, st>>>(rows, coef, order, n, ntiles,
                                                tile_start);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* iir_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The geometry the host builds the power table for: samples per thread,
// threads per tile block, and the float count of coef.
extern "C" void iir_geometry(int* span, int* threads, int* coef_len) {
  *span = kSpan;
  *threads = kThreads;
  *coef_len = kCoefLen;
}

// Filters `rows` float32 rows of n samples each: x[r] (n,) -> y[r] (n,),
// from zi[r] (order,) (null: zero state) to zf[r] (order,). coef: the
// table above, on the device. scratch: 4 * rows * ceil(n / kTile) * poles
// floats. Returns 0 or the CUDA error code.
extern "C" int iir_launch(int nrows, const void* const* x, void* const* y,
                          const void* const* zi, void* const* zf,
                          const void* coef, int poles, int order, long n,
                          void* scratch, void* stream) {
  if (nrows < 1 || nrows > kMaxRows || poles < 1 || poles > kMaxPairs ||
      order < 1 || order > kMaxOrder || n < 1)
    return (int)cudaErrorInvalidValue;
  const long ntiles = (n + kTile - 1) / kTile;
  if (ntiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  Rows rows;
  for (int r = 0; r < kMaxRows; ++r) {
    const bool used = r < nrows;
    rows.x[r] = used ? (const float*)x[r] : nullptr;
    rows.y[r] = used ? (float*)y[r] : nullptr;
    rows.zi[r] = used ? (const float*)zi[r] : nullptr;
    rows.zf[r] = used ? (float*)zf[r] : nullptr;
  }
  float2* tile_end = (float2*)scratch;
  float2* tile_start = tile_end + (long)nrows * ntiles * poles;
  const float* c = (const float*)coef;
  cudaStream_t st = (cudaStream_t)stream;
  switch (poles) {
    case 1: return run<1>(rows, c, order, n, (int)ntiles, nrows, tile_end,
                          tile_start, st);
    case 2: return run<2>(rows, c, order, n, (int)ntiles, nrows, tile_end,
                          tile_start, st);
    case 3: return run<3>(rows, c, order, n, (int)ntiles, nrows, tile_end,
                          tile_start, st);
    default: return run<4>(rows, c, order, n, (int)ntiles, nrows, tile_end,
                           tile_start, st);
  }
}
