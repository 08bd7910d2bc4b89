// Exact IIR filter of order 1-8 with distinct poles for Hopper (sm_90a),
// float32: the pole-diagonalized scan, one launch, one read of the signal.
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
// every constant and the powers p^(kSpan j) and p^(kTile e), also
// formed in float64.
//
// One launch of iir_launch filters R rows, so a planar signal is one call
// of two rows. It is a single-pass chained scan with a decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA 2016). A block of kThreads compute threads (and, at
// one or two poles, a look-back warp, see Block) takes a tile of kTile
// samples, kSpan consecutive samples per compute thread:
//  1. its tile is the next ticket of an atomic counter over (row, tile),
//     so every tile it waits for belongs to a block already running;
//  2. the compute warps load their samples into registers, once, and form
//     per pole the zero-state state at every thread's end (a weighted warp
//     scan with the multipliers p^(kSpan d)) and at the tile's end, the
//     aggregate, which they publish at once;
//  3. the look-back warp, from the ticket on (at three or four poles,
//     compute warp 0 once the aggregate is out), polls kWindow
//     predecessors at a time, kLook a lane, and sums their published
//     states weighted by p^(kTile e) (table powers) up to the nearest one
//     whose inclusive state (its end state from the true start) is out,
//     the row's start s0 = Q^-1 zi standing for tile -1; a window with
//     none multiplies the rest by p^(kTile kWindow) and goes one window
//     further back. It reads no further back than the host's horizon,
//     where every pole's p^(kTile e) has fallen under 2^-48: for the
//     filters of the main paths (|p| <= 0.95, p^kTile < 1e-22) that is the
//     one tile before, so no tile waits for another's look-back;
//  4. at one or two poles the compute warps form each sample's output
//     from a zero tile start while the look-back warp waits, and once it
//     has the start state S add its share, Re(q p^t S) at the tile's
//     sample t (linearity); at three or four they replay their spans from
//     S. Each writes y, the thread holding sample N-1 writes zf from the
//     state after it, and thread 0 publishes the tile's inclusive state.
//     Samples past N read as 0 and are not written, so any N >= 1 works.
// Every published float carries the call's epoch, so the scratch needs no
// reset between calls, and a reader needs no fence; the epoch and the
// ticket count live in the scratch's header, on the device, so a launch
// captured in a CUDA graph is a new call at every replay (lookback.cuh,
// the machinery B5 shares with the FM chain's de-emphasis).
//
// What bounds it on the card: bytes. One float32 read and one write per
// sample (8 B) against ~10 FLOP per pole pair per sample for the state
// update, ~4 for the output and 2 for b0*x: 58 FLOP per sample at order 8
// is 0.9 us per 2^20 samples at the FP32 peak, under the 2.5 us of HBM
// traffic. What the design does about that: x is read once and y written
// once, in 16-byte accesses; the recurrence runs twice per sample from
// registers; between tiles only 2 x 2P stamped words per tile cross the
// L2, with no fence on either side; the look-back waits on the L2 while
// the compute warps work, and it stops at its horizon, so tiles do not
// wait in a chain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

using gsdr::lookback::epoch_of;
using gsdr::lookback::kHeader;
using gsdr::lookback::kTicketMask;
using gsdr::lookback::ld_relaxed;
using gsdr::lookback::st_relaxed;

// One geometry serves both main-path sizes: 256 tiles at stream_fm's 2^18
// samples (two per SM of an H100), 1024 at bench_iir's 2^20 (all resident
// at once at one or two poles). Tiles of 2048 and 4096 samples measured
// slower at both sizes (tools/probe_grades.py b5b6).
constexpr int kSpan = 8;                   // consecutive samples per thread
constexpr int kThreads = 128;              // threads of a tile block
constexpr int kTile = kSpan * kThreads;    // samples per tile
constexpr int kWarps = kThreads / 32;      // compute warps

// At one or two pole representatives a block adds a look-back warp to its
// compute warps (160 threads, <= 56 registers: 1024 tiles resident at
// once); at three or four the extra warp would cost a wave at 2^20 (72
// registers x 160 threads), so compute warp 0 looks back there.
// kMinBlocks holds a block's registers to what keeps that many blocks on
// an SM (48, 56, 72 and 96 at one to four poles): eight 160-thread blocks
// an SM at one pole put all of bench_iir's 1024 tiles on the card at once.
template <int P>
struct Block {
  static constexpr bool kLookWarp = P <= 2;
  static constexpr int kSize = kThreads + (kLookWarp ? 32 : 0);
  static constexpr int kMinBlocks = P == 1 ? 8 : P == 4 ? 5 : 7;
};
constexpr int kLook = 2;                   // predecessors per lane
constexpr int kWindow = 32 * kLook;        // predecessors per look-back step
constexpr int kMaxPairs = 4;
constexpr int kMaxOrder = 8;
constexpr int kMaxRows = 8;
constexpr unsigned kFull = 0xffffffffu;

// coef layout, float32, complex values as (re, im) at even offsets:
//   kB0            b0
//   kPole + 2k     p_k
//   kW + 2k        w_k
//   kQ + 2k        wgt_k * q_k
//   kQcol + 2(kMaxOrder k + i)    wgt_k * Q[i, k]      (i < order)
//   kQinv + 2(kMaxOrder k + j)    Q^-1[k, j]           (j < order)
//   kPow + 2(kPowLen k + j)       p_k^(kSpan j)        (j = 0..kThreads)
//   kLookPow + 2(kLookLen k + e)  p_k^(kTile e)        (e = 0..kWindow)
// Mirrored by kernels/iir.py::coef_table.
constexpr int kB0 = 0;
constexpr int kPole = 2;
constexpr int kW = kPole + 2 * kMaxPairs;
constexpr int kQ = kW + 2 * kMaxPairs;
constexpr int kQcol = kQ + 2 * kMaxPairs;
constexpr int kQinv = kQcol + 2 * kMaxPairs * kMaxOrder;
constexpr int kPow = kQinv + 2 * kMaxPairs * kMaxOrder;
constexpr int kPowLen = kThreads + 1;
constexpr int kLookPow = kPow + 2 * kMaxPairs * kPowLen;
constexpr int kLookLen = kWindow + 1;
constexpr int kCoefLen = kLookPow + 2 * kMaxPairs * kLookLen;

// scratch layout (lookback.cuh): the 64-byte header, then per slot (row *
// ntiles + tile) the aggregate, then per slot the inclusive state, each
// kSlotWords words (see put_slot). The block of a call's first ticket
// refreshes slot h mod slots: all of it outside the grid, its words past
// the call's P poles inside.
constexpr int kSlotWords = 2 * kMaxPairs;

struct Rows {
  const float* x[kMaxRows];
  float* y[kMaxRows];
  const float* zi[kMaxRows];   // null: zero initial state
  float* zf[kMaxRows];
};

struct Scratch {
  unsigned long long* head;    // epoch index << 32 | tickets taken
  long slots;                  // slots of the scratch
  unsigned long long* agg;     // kSlotWords per slot
  unsigned long long* incl;    // kSlotWords per slot
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

// P complex values to a slot, each float stamped with the epoch
template <int P>
__device__ __forceinline__ void put_slot(unsigned long long* dst,
                                         const float2 (&v)[P],
                                         unsigned epoch) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    st_relaxed(dst + 2 * k, gsdr::lookback::stamp(v[k].x, epoch));
    st_relaxed(dst + 2 * k + 1, gsdr::lookback::stamp(v[k].y, epoch));
  }
}

// The ticket of a block (lookback.cuh); the block of the call's first
// ticket refreshes slot h mod slots.
template <int P>
__device__ __forceinline__ unsigned long long take_ticket(const Scratch& sc) {
  return gsdr::lookback::take_ticket(
      sc.head, gridDim.x, [=](unsigned long long h) {
        // a slot outside the grid is read by no block of this call;
        // inside, its words past the P poles are read and written by none
        const long c = (long)((unsigned)h % (unsigned)sc.slots);
        const int first = c >= (long)gridDim.x ? 0 : 2 * P;
        const unsigned long long zero = h + 1;   // 0.f stamped with the epoch
#pragma unroll
        for (int w = 0; w < kSlotWords; ++w) {
          if (w < first) continue;
          st_relaxed(sc.agg + kSlotWords * c + w, zero);
          st_relaxed(sc.incl + kSlotWords * c + w, zero);
        }
      });
}

// A slot's P complex values; true when every word is of this epoch
template <int P>
__device__ __forceinline__ bool get_slot(const unsigned long long* src,
                                         unsigned epoch, float2 (&v)[P]) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const unsigned long long re = ld_relaxed(src + 2 * k),
                             im = ld_relaxed(src + 2 * k + 1);
    ok &= (unsigned)re == epoch && (unsigned)im == epoch;
    v[k] = make_float2(__uint_as_float((unsigned)(re >> 32)),
                       __uint_as_float((unsigned)(im >> 32)));
  }
  return ok;
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

// Warp 0 of a tile: the exclusive prefix (the state at the tile's start)
// from the look-back, per pole, in every lane. Predecessor e (tile - 1 -
// e) is carried to this tile's start by p^(kTile e); one at e >= horizon
// would enter through p^(kTile horizon) <= 2^-48 (the host's bound, far
// under float32's 2^-24) and is left out, so the look-back also ends at
// e = horizon - 1 on an aggregate.
template <int P>
__device__ __forceinline__ void look_back(
    const Scratch& sc, const float* __restrict__ coef, const float* zi,
    int order, long slot0, long tile, long horizon,
    const volatile unsigned long long& head,
    float2 (&excl)[P]) {
  const int lane = threadIdx.x & 31;
  float2 mult[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    excl[k] = make_float2(0.f, 0.f);
    mult[k] = make_float2(1.f, 0.f);
  }
  for (long look = tile;; look -= kWindow) {
    // lane's predecessors: look - 1 - e, e = lane * kLook + q
    float2 val[kLook][P];
    bool term[kLook];
    bool pending;
    long spins = 0;
    do {
      pending = false;
#pragma unroll
      for (int q = 0; q < kLook; ++q) {
        const int e = lane * kLook + q;
        const long idx = look - 1 - e;
        term[q] = true;
#pragma unroll
        for (int k = 0; k < P; ++k) val[q][k] = make_float2(0.f, 0.f);
        if (idx < -1 || tile - 1 - idx >= horizon) continue;   // left out
        if (idx == -1) {
          // the row's start, s0 = Q^-1 zi
#pragma unroll
          for (int k = 0; k < P; ++k) {
            float2 s0 = make_float2(0.f, 0.f);
            if (zi != nullptr) {
              for (int j = 0; j < order; ++j) {
                const float2 qi = ld2(coef, kQinv + 2 * (kMaxOrder * k + j));
                const float z = __ldg(zi + j);
                s0.x = fmaf(qi.x, z, s0.x);
                s0.y = fmaf(qi.y, z, s0.y);
              }
            }
            val[q][k] = s0;
          }
          continue;
        }
        float2 inc[P], agg[P];
        const bool has_inc = get_slot<P>(sc.incl + kSlotWords * (slot0 + idx),
                                         epoch_of(head), inc);
        const bool has_agg = get_slot<P>(sc.agg + kSlotWords * (slot0 + idx),
                                         epoch_of(head), agg);
#pragma unroll
        for (int k = 0; k < P; ++k) val[q][k] = has_inc ? inc[k] : agg[k];
        term[q] = has_inc || tile - 1 - idx == horizon - 1;
        pending |= !has_inc && !has_agg;
      }
      if (!__any_sync(kFull, pending)) break;
      gsdr::lookback::spin(spins);
    } while (true);
    int first = kWindow;   // e of the nearest terminal predecessor
#pragma unroll
    for (int q = kLook - 1; q >= 0; --q)
      if (term[q]) first = lane * kLook + q;
    first = __reduce_min_sync(kFull, first);

    float2 sum[P];
#pragma unroll
    for (int k = 0; k < P; ++k) sum[k] = make_float2(0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kLook; ++q) {
      const int e = lane * kLook + q;
      if (e > first) continue;
#pragma unroll
      for (int k = 0; k < P; ++k)
        sum[k] = cfma(ld2(coef, kLookPow + 2 * (kLookLen * k + e)),
                      val[q][k], sum[k]);
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const float2 o = shfl_xor2(sum[k], d);
        sum[k].x += o.x;
        sum[k].y += o.y;
      }
      excl[k] = cfma(mult[k], sum[k], excl[k]);
    }
    if (first < kWindow) return;
#pragma unroll
    for (int k = 0; k < P; ++k)
      mult[k] = cmul(mult[k],
                     ld2(coef, kLookPow + 2 * (kLookLen * k + kWindow)));
  }
}

// Each compute thread's outputs over its span, added to yv, and its state
// after sample jl in s_last: from the tile start state start[k] (or, with
// kZeroStart, a zero start), the warp's zero-start prefix wexc and the
// thread's weighted warp scan v.
template <int P, bool kZeroStart>
__device__ __forceinline__ void replay(
    const float* __restrict__ coef, const float2 (&v)[P],
    const float2 (&wexc)[P][kWarps], const float2 (&start)[P],
    const float (&xv)[kSpan], int jl, float (&yv)[kSpan],
    float2 (&s_last)[P]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float2 p = ld2(coef, kPole + 2 * k), w = ld2(coef, kW + 2 * k),
                 qw = ld2(coef, kQ + 2 * k);
    const int pw = kPow + 2 * kPowLen * k;
    const float2 wp = wexc[k][warp];
    // the state after this thread's span, from a zero tile start, and the
    // one before it
    const float2 incl = cfma(ld2(coef, pw + 2 * (lane + 1)), wp, v[k]);
    float2 s = shfl_up2(incl, 1);
    if (lane == 0) s = wp;
    if (!kZeroStart) s = cfma(ld2(coef, pw + 2 * tid), start[k], s);
    s_last[k] = s;
#pragma unroll
    for (int j = 0; j < kSpan; ++j) {
      yv[j] = fmaf(qw.x, s.x, fmaf(-qw.y, s.y, yv[j]));
      s = step(p, s, w, xv[j]);
      if (j == jl) s_last[k] = s;
    }
  }
}

__device__ __forceinline__ void compute_sync() {
  // the compute warps alone (barrier 1); the look-back warp is not held
  asm volatile("bar.sync 1, %0;" :: "n"(kThreads) : "memory");
}

template <int P>
__device__ __forceinline__ void start_sync() {
  // the whole block (barrier 2): the start state is in start_s
  asm volatile("bar.sync 2, %0;" :: "n"(Block<P>::kSize) : "memory");
}

template <int P>
__global__ void __launch_bounds__(Block<P>::kSize, Block<P>::kMinBlocks)
iir_chained(
    Rows rows, const float* __restrict__ coef, int order, long n, long ntiles,
    long horizon, Scratch sc) {
  __shared__ float2 wtot[P][kWarps];   // zero-state state after each warp
  __shared__ float2 wexc[P][kWarps];   // ... and before it
  __shared__ float2 agg_s[P], start_s[P];
  __shared__ unsigned long long head_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == (Block<P>::kLookWarp ? kThreads : 0))
    head_s = take_ticket<P>(sc);
  __syncthreads();
  const long slot = (long)(head_s & kTicketMask);
  // a ticket past the grid: a call on this scratch from another stream
  if (slot >= (long)gridDim.x) __trap();
  const int r = (int)(slot / ntiles);
  const long tile = slot - (long)r * ntiles;

  if (Block<P>::kLookWarp && warp == kWarps) {
    // the look-back warp: polls the predecessors from the start, while
    // the compute warps load, scan and form their zero-state outputs
    float2 excl[P];
    look_back<P>(sc, coef, rows.zi[r], order, (long)r * ntiles, tile,
                 horizon, head_s, excl);
    if (lane < P) start_s[lane] = excl[lane];
    start_sync<P>();
    return;
  }

  const long base = tile * (long)kTile + (long)tid * kSpan;
  float xv[kSpan];
  load_span(rows.x[r], base, n, xv);

  // 1) per pole, the zero-state state after this thread's span, scanned
  // over the warp: v = sum_{t' <= t in the warp} p^(kSpan (t - t')) u_t'
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
  compute_sync();

  // 2) the aggregate, published at once; each warp's zero-state prefix
  if (tid < P) {
    const float2 p32 = ld2(coef, kPow + 2 * (kPowLen * tid + 32));
    float2 acc = make_float2(0.f, 0.f);
    for (int q = 0; q < kWarps; ++q) {
      wexc[tid][q] = acc;
      acc = cfma(p32, acc, wtot[tid][q]);
    }
    agg_s[tid] = acc;
  }
  compute_sync();
  if (tid == 0) {
    float2 agg[P];
#pragma unroll
    for (int k = 0; k < P; ++k) agg[k] = agg_s[k];
    put_slot<P>(sc.agg + kSlotWords * slot, agg, epoch_of(head_s));
  }

  float yv[kSpan];   // b0 x, then the pole terms
  const long last = n - 1;
  const bool owns_last = last >= base && last < base + kSpan;
  const int jl = (int)(last - base);
  float2 s_last[P];
  if constexpr (Block<P>::kLookWarp) {
    // 3) y from a zero tile start while the look-back warp waits
#pragma unroll
    for (int j = 0; j < kSpan; ++j) yv[j] = __ldg(coef + kB0) * xv[j];
    replay<P, true>(coef, v, wexc, start_s, xv, jl, yv, s_last);
  } else if (warp == 0) {
    // 3) compute warp 0 looks back
    float2 excl[P];
    look_back<P>(sc, coef, rows.zi[r], order, (long)r * ntiles, tile,
                 horizon, head_s, excl);
    if (lane < P) start_s[lane] = excl[lane];
  }

  // 4) the tile's start state S: thread 0 publishes the inclusive state;
  // at one or two poles S adds Re(q p^t S) at the tile's sample t
  // (linearity), at three or four the spans replay from S
  start_sync<P>();
  if (tid == 0) {
    float2 incl[P];
#pragma unroll
    for (int k = 0; k < P; ++k)
      incl[k] = cfma(ld2(coef, kLookPow + 2 * (kLookLen * k + 1)),
                     start_s[k], agg_s[k]);
    put_slot<P>(sc.incl + kSlotWords * slot, incl, epoch_of(head_s));
  }
  if constexpr (Block<P>::kLookWarp) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float2 p = ld2(coef, kPole + 2 * k), qw = ld2(coef, kQ + 2 * k);
      float2 c = cmul(ld2(coef, kPow + 2 * (kPowLen * k + tid)), start_s[k]);
#pragma unroll
      for (int j = 0; j < kSpan; ++j) {
        yv[j] = fmaf(qw.x, c.x, fmaf(-qw.y, c.y, yv[j]));
        c = cmul(p, c);
        if (j == jl) {
          s_last[k].x += c.x;
          s_last[k].y += c.y;
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSpan; ++j) yv[j] = __ldg(coef + kB0) * xv[j];
    replay<P, false>(coef, v, wexc, start_s, xv, jl, yv, s_last);
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
int run(const Rows& rows, const float* coef, int order, long n, long ntiles,
        long horizon, int nrows, const Scratch& sc, cudaStream_t st) {
  iir_chained<P><<<(unsigned)(ntiles * nrows), Block<P>::kSize, 0, st>>>(
      rows, coef, order, n, ntiles, horizon, sc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* iir_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The geometry the host builds the table for: samples per thread,
// threads per tile block, tiles of one look-back step, and the float count
// of coef.
extern "C" void iir_geometry(int* span, int* threads, int* window,
                             int* coef_len) {
  *span = kSpan;
  *threads = kThreads;
  *window = kWindow;
  *coef_len = kCoefLen;
}

// Bytes of scratch for `slots` tiles (rows times tiles of a call).
extern "C" long iir_scratch_bytes(long slots) {
  return kHeader + slots * 2 * kSlotWords * 8;
}

// Filters `rows` float32 rows of n samples each: x[r] (n,) -> y[r] (n,),
// from zi[r] (order,) (null: zero state) to zf[r] (order,). coef: the
// table above, on the device. horizon: the predecessor tiles a look-back
// reads at most (>= 1), the host's bound where every pole's p^(kTile
// horizon) <= 2^-48. scratch: iir_scratch_bytes(slots) bytes, zeroed
// once when allocated and then kept by the caller for the calls of one
// stream (eager or replayed from a CUDA graph, in any order; the header
// counts them). Returns 0 or the CUDA error code.
extern "C" int iir_launch(int nrows, const void* const* x, void* const* y,
                          const void* const* zi, void* const* zf,
                          const void* coef, int poles, int order, long n,
                          long horizon, void* scratch, long slots,
                          void* stream) {
  if (nrows < 1 || nrows > kMaxRows || poles < 1 || poles > kMaxPairs ||
      order < 1 || order > kMaxOrder || n < 1 || horizon < 1)
    return (int)cudaErrorInvalidValue;
  const long ntiles = (n + kTile - 1) / kTile;
  // slots under kStampPeriod: the header's refresh argument
  if (slots > 0x7fffffffL || ntiles * nrows > slots)
    return (int)cudaErrorInvalidValue;
  Rows rows;
  for (int r = 0; r < kMaxRows; ++r) {
    const bool used = r < nrows;
    rows.x[r] = used ? (const float*)x[r] : nullptr;
    rows.y[r] = used ? (float*)y[r] : nullptr;
    rows.zi[r] = used ? (const float*)zi[r] : nullptr;
    rows.zf[r] = used ? (float*)zf[r] : nullptr;
  }
  char* s = (char*)scratch;
  Scratch sc;
  sc.head = (unsigned long long*)s;
  sc.slots = slots;
  sc.agg = (unsigned long long*)(s + kHeader);
  sc.incl = sc.agg + kSlotWords * slots;
  const float* c = (const float*)coef;
  cudaStream_t st = (cudaStream_t)stream;
  switch (poles) {
    case 1: return run<1>(rows, c, order, n, ntiles, horizon,
                                  nrows, sc, st);
    case 2: return run<2>(rows, c, order, n, ntiles, horizon,
                                  nrows, sc, st);
    case 3: return run<3>(rows, c, order, n, ntiles, horizon,
                                  nrows, sc, st);
    default: return run<4>(rows, c, order, n, ntiles,
                                   horizon, nrows, sc, st);
  }
}
