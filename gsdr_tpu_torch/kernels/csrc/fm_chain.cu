// Fused C-channel FM receive chain for Hopper (sm_90a), at three grades of
// either front: f32 (FP32 FMA), bf16x3 and bf16x2 (tensor cores).
//
// Replaces gsdr_tpu/kernels/fm_chain_pallas.py::_fm_chain_kernel with both
// of its fronts (fronts.cuh): fm_chain_launch runs the dense (toeplitz)
// front, pfb_fm_chain_launch the uniform-grid PFB front (_pfb_fold_dot
// with its grade arm _nt_grade_dot), each at the grade asked for. Per
// decimated output j and channel c it computes
//   y[c,j]  = sum_t x[j*D + t] * g_c[t]               front
//   f[c,j]  = y[c,j] * e^{i 2 pi frac(f_c (n0 + j D) / Fs)}   LO rotor
//   d[c,j]  = gain * atan2(f[c,j] * conj(f[c,j-1]))   discriminator
//   z[c,j]  = cc*d[c,j] + a*z[c,j-1],  out[c,j] = b0*d[c,j] + z[c,j-1]
// with f[c,-1] and z[c,-1] carried in from the previous block and the
// carries exported at j = M-1. One grid launch a call, at every grade and
// front, one chunk or chunked.
//
// What bounds it on the card, by grade. The f32 dense front issues
// C*T*8/D FP32 operations per input sample (2048 at the flagship 16
// channels, 64 taps, D=4: 2.15 GFLOP per 2^20-sample step, 32 us at the
// 67-TFLOP/s FP32 peak, against about 25 MB of HBM traffic, 7.5 us). At
// bf16x3 the same product is 3 tensor-core passes, 6.4 GFLOP at 989
// TFLOP/s, 6.5 us (bf16x2: 2 passes, 4.3 us): the function is then bound by
// its bytes, and the back end (sincos, atan2 and the de-emphasis scan, ~16
// FP32 operations per output and channel besides) is what remains. The
// PFB front issues (4T + 8CK)/D (544
// at 64 channels on the Fs/64 grid, 512 taps, D=64: 0.57 GFLOP per step,
// 94% of it the dense DFT-bank product); at bf16x3 that product is 3
// tensor-core passes, 1.6 GFLOP, ~1.6 us, and the ~13 MB of HBM traffic
// (3.8 us) bound the function at every grade.
//
// What the design does about that:
//  - one thread per decimated output holds 16 channels (4 or 8 in a block
//    of 4 or 8) in registers for the back end, so that it walks only the
//    channels that exist. The f32 dense front multiplies 8,
//    16 or 32 channels a block (by C) in register tiles of 4 rows x 4
//    channels on every thread (one chunk: the back end keeps its
//    occupancy) or 4 x 8 on half of them (chunked: a long bank's FMAs,
//    the product unrolled by 4), its taps staged
//    from a contiguous table with cp.async, the next chunk in flight while
//    it multiplies one (fronts.cuh, toeplitz_front, fm_dense_cols); the
//    bf16 dense front runs as one GEMM per block on
//    mma.sync (toeplitz_front_mma over 4, 8 or 16 channels by C,
//    one_chunk_channels; in chunks,
//    toeplitz_front_mma_chunked over 4, 8 or 16 by C and the grid, its
//    chunks double-buffered: the narrowband scanner's 33 tiles of 16
//    channels take 132 blocks of 4); the PFB front at
//    every grade makes the fold once for 32 channels (pfb_front_mma on
//    mma.sync, pfb_front in FP32 register tiles). The f32 fronts hand the
//    outputs to the threads through a shared tile, so their registers are
//    dead before the back end starts, which walks a block of 32 channels
//    as two groups of 16 over that tile;
//  - the rotor uses the exact digit-table phase with the same float32
//    operation order as the plain chain, then one sincosf per output;
//  - the discriminator takes f[j-1] from the neighbouring lane by shuffle
//    (shared memory at warp edges); thread 0 of every block recomputes the
//    previous block's last output (one extra window, or one extra fold and
//    bank row with the PFB front: row 0 of the block's GEMM), so blocks
//    need no ordering;
//  - the de-emphasis is linear, so a block scans its tile from z = 0,
//    publishes the tile's zero-state end (its aggregate), finds its true
//    start state by a decoupled look-back over the tiles before it in its
//    channel group (the words of 16-64 tiles polled by the whole block at
//    once, then a thread a channel walks them, start_state; lookback.cuh:
//    tickets, so that every tile it waits for is running, and stamped
//    words in a per-stream scratch that no call resets), adds
//    a^(j-j0) * z_start to each output in registers before it stores it,
//    and publishes its inclusive end state. The audio crosses the card's
//    memory once, in one launch a call. What that costs: a block idles
//    while the tiles before finish their scans (a fifth of a flagship
//    block's time; tools/back_end_timeline.py measures it), so the
//    one-chunk dense blocks are bound to 1024 threads a SM (64
//    registers), and a thread holds only its outputs from a zero tile
//    start while it waits; heavy blocks (the 2049-tap filter) wait longer
//    than the launches they replace took.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fronts.cuh"
#include "lookback.cuh"

namespace {

using gsdr::kCG;
using gsdr::kTile;
using gsdr::lookback::epoch_of;
using gsdr::lookback::kTicketMask;
using gsdr::lookback::ld_relaxed;
using gsdr::lookback::st_relaxed;
using gsdr::lookback::stamp;
using gsdr::lookback::unstamp;
// new outputs per block of kTile rows (the dense and one-chunk blocks';
// the chunked bf16 PFB block of kRows rows makes kRows - 1)
constexpr int kOut = kTile - 1;
constexpr float kTwoPi = 6.283185307179586f;
constexpr unsigned kFull = 0xffffffffu;

// The channels of the one-chunk bf16 dense block for C channels: the
// fewest of 4, 8 and kCG that hold C (C < 1: any C, kCG), so that the
// front and the back end walk only the channels that exist. Each output
// column's sum on the tensor cores is independent of the others, so the
// outputs do not depend on the block.
__host__ __device__ constexpr int one_chunk_channels(int C) {
  return C >= 1 && C <= 4 ? 4 : C >= 1 && C <= 8 ? 8 : kCG;
}

// The de-emphasis scratch of a (device, stream) (lookback.cuh): after the
// header, one stamped word a slot for the aggregates (each tile's
// zero-state end), then one a slot for the inclusive states (each tile's
// end from its true start); slot k*C + c for tile k of channel c.
struct Scratch {
  unsigned long long* head;
  long slots;
  unsigned long long* agg;
  unsigned long long* incl;
};

__device__ __forceinline__ float ipow(float a, int k) {
  float r = 1.f, b = a;
  while (k) {
    if (k & 1) r *= b;
    b *= b;
    k >>= 1;
  }
  return r;
}

// The de-emphasis state of channel c at the start of `tile`, z_start[tile],
// where z_start[0] = zi and z_start[k+1] = fmaf(A, z_start[k], zend[k])
// with A = a^kNew, kNew a tile's new outputs (every predecessor is a whole
// tile). The look-back reads
// the tiles before, nearest first: it stops at the first whose inclusive
// state (z_start[i+1]) is published, at tile -1 (zi), or at the first i
// where the composed power A^(tile - i), the weight of z_start[i], is
// exactly 0 in float32, beyond which nothing can add a bit (a de-emphasis
// at a = 0, or one that decays in a few tiles, ends there at once). It
// takes the words of the kW tiles nearest from the block's window (win:
// the inclusive word of tile - m at (m - 1)*kCh + cl, its aggregate kW*kCh
// words on; polled by the whole block at once), reads further tiles from
// the scratch, and polls again only the words of a tile that had
// published neither state. Then it composes forward from that state with
// the aggregates, in the order of the recursion. Where kCount, the
// thread's clocks in the poll loop (the block's longest, clocks.cuh
// kPollClocks) and its polls go into clk.
template <int kW, int kCh, int kNew, bool kCount = false>
__device__ __forceinline__ float start_state(
    const Scratch& sc, unsigned long long* win, int cl, int c, int C,
    int tile, float a, float zi, unsigned epoch,
    unsigned long long* clk = nullptr) {
  unsigned long long* inc = win + cl;
  unsigned long long* agg = win + kW * kCh + cl;
  const float A = ipow(a, kNew);
  const long long t0 = clock64();
  [[maybe_unused]] unsigned long long polled = 0, polls = 0;
  float P = 1.f, z = 0.f, v;
  int from = 0;      // the farthest tile distance composed forward
  for (int m = 1;; ++m) {
    const int i = tile - m;
    if (i < 0) {
      z = zi;
      from = m - 1;
      break;
    }
    P *= A;
    const long s = (long)i * C + c;
    const bool near = m <= kW;
    unsigned long long wi = near ? inc[(m - 1) * kCh] : ld_relaxed(sc.incl + s);
    unsigned long long wa = near ? agg[(m - 1) * kCh] : ld_relaxed(sc.agg + s);
    // z_start[i] weighs nothing where P is 0: its aggregate is enough
    if constexpr (kCount) polled -= gsdr::clocks::now();
    while (!unstamp(wa, epoch, v) && (P == 0.f || !unstamp(wi, epoch, v))) {
      if constexpr (kCount) ++polls;
      gsdr::lookback::spin_since(t0);
      wi = ld_relaxed(sc.incl + s);
      wa = ld_relaxed(sc.agg + s);
    }
    if constexpr (kCount) polled += gsdr::clocks::now();
    if (near) agg[(m - 1) * kCh] = wa;
    if (P == 0.f) {   // start from 0 before tile i
      from = m;
      break;
    }
    if (unstamp(wi, epoch, v)) {
      z = v;
      from = m - 1;
      break;
    }
  }
  for (int m = from; m >= 1; --m) {
    unstamp(m <= kW ? agg[(m - 1) * kCh]
                    : ld_relaxed(sc.agg + (long)(tile - m) * C + c),
            epoch, v);
    z = fmaf(A, z, v);
  }
  if constexpr (kCount) {   // the block's words, warp 0's slots
    atomicMax(clk + gsdr::clocks::kPollClocks * gsdr::clocks::kWarps,
              polled);
    atomicAdd(clk + gsdr::clocks::kPolls * gsdr::clocks::kWarps, polls);
  }
  return z;
}

__device__ __forceinline__ int shared_int(const int& v) {
  return *reinterpret_cast<const volatile int*>(&v);
}

// One tile of kRows - 1 new outputs for kCh channels, in one pass: front,
// rotor, discriminator and de-emphasis; a block of 32 channels (the PFB
// front at every grade, the dense front at f32 where C > 16) has two
// threads per output, one for each group of kCG channels, reading the
// front's output tile, as the f32 dense front's blocks of 8 and 16 do; the
// chunked bf16 PFB front's blocks of 128 or 64 rows (fronts.cuh,
// pfb_mma_rows) keep its 512 threads, 4 or 8 an output of 8 or 4 channels
// each. Every other block takes kTile rows.
// A block's tile and channel group come from its ticket t (lookback.cuh):
// tile t / groups, group t % groups, so that tile k - 1 of a group always
// holds a lower ticket than tile k (some blocks hold 100-210 KB of shared
// memory, one a SM: a spin never waits on a block that is not running).
// kPfb selects the front: the dense one reads ftab (dense_f32_tables) at
// f32, or btab (dense_mma_tables) at bf16x3 and bf16x2, in chunks of Tc
// taps where kChunked (fronts.cuh, dense_chunk, use_chunked_kernel), else
// all T at once; the PFB one reads hp (Q, K) and
// btab (pfb_f32_tables at f32, pfb_mma_tables at the bf16 grades), in
// chunks of Tc lanes and u-ranges of Uc fold taps where kChunked
// (fronts.cuh, pfb_chunk, use_chunked_pfb; at the bf16 grades hp and btab
// are then pfb_chunk_taps and pfb_mma_chunk_tables), else all at once.
// fm_chain_tile runs it; fm_chain_tile_counted, where kCount, also adds
// its clocks into clk (clocks.cuh: the front's, its warps' waits, the
// look-back's polls).
template <bool kPfb, int kGrade, bool kChunked, int kCh, int kRows,
          bool kCount>
__device__ __forceinline__ void fm_chain_run(
    const float* __restrict__ buf_re, const float* __restrict__ buf_im,
    int nb, const float* __restrict__ ftab, const float* __restrict__ hp,
    const uint2* __restrict__ btab, int C, int T, int Tc, int K, int Q, int D,
    int M, int ntiles, const float* __restrict__ table,
    const int* __restrict__ n0_rot,
    const float* __restrict__ coef, float gain,
    const float* __restrict__ cf_re_in, const float* __restrict__ cf_im_in,
    const float* __restrict__ cz_in, float* __restrict__ audio,
    float* __restrict__ cf_re_out, float* __restrict__ cf_im_out,
    float* __restrict__ cz_out, Scratch sc, int Uc,
    unsigned long long* clk) {
  static_assert(!kCount || (kPfb && kChunked),
                "counters in the chunked PFB front's kernel only");
  static_assert(kRows == kTile ||
                    (kPfb && kChunked && kGrade != gsdr::kGradeF32),
                "fewer rows only in the bf16 PFB front's chunked kernel");
  constexpr int kNew = kRows - 1;                  // new outputs a block
  constexpr int kWarps = kRows / 32;               // warps of rows
  constexpr int kThreads = gsdr::back_threads(kCh);
  constexpr int kPar = kThreads / kRows;           // groups side by side
  constexpr int kBe = kCh / kPar;                  // channels a thread
  constexpr int kOS = 2 * kCh + 1;   // the f32 and PFB fronts' tile stride
  constexpr bool kTileOut = kPfb || kGrade == gsdr::kGradeF32;
  static_assert(kCh == kPar * kBe, "one group of kBe channels a thread");
  static_assert(kTileOut || kCh == 4 || kCh == 8 || kCh == kCG,
                "the bf16 dense front: 4, 8 or 16 channels a block");
  constexpr int kCols = gsdr::fm_dense_cols(kChunked);   // f32 dense tiles
  constexpr int kUnroll = gsdr::fm_dense_unroll(kChunked);
  static_assert(kPfb || kGrade != gsdr::kGradeF32 ||
                    gsdr::dense_f32_threads(kCh, kCols) <= kThreads,
                "the f32 dense front's tiles within the block");
  extern __shared__ float4 smem4[];
  __shared__ float tab[kCh * 4];
  __shared__ float y_edge[kPar][kWarps][kBe][2];
  __shared__ float z_edge[kPar][kWarps][kBe];
  __shared__ float z_last[kPar][kWarps][kBe];
  __shared__ float z_start[kCh];
  __shared__ float zend_s[kCh];      // the tile's zero-state ends
  // the ticket's head, tile and channel group, read from shared memory
  // where they are used (shared_int), so that no register holds them
  // across the front and the rotor
  __shared__ unsigned long long head_s;
  __shared__ int tile_s, group_s;

  const int tid = threadIdx.x;
  if (tid == 0) {
    const unsigned long long head = gsdr::lookback::take_ticket(
        sc.head, gridDim.x, [=](unsigned long long h) {
          // a slot past this call's tiles is read and written by none of
          // its blocks
          const long s = (long)((unsigned)h % (unsigned)sc.slots);
          if (s >= (long)ntiles * C) {
            const unsigned long long zero = h + 1;   // 0.f, this epoch
            st_relaxed(sc.agg + s, zero);
            st_relaxed(sc.incl + s, zero);
          }
        });
    const int ticket = (int)(head & kTicketMask);
    // a ticket past the grid: a call on this scratch from another stream
    if (ticket >= (int)gridDim.x) __trap();
    const int groups = (C + kCh - 1) / kCh;
    head_s = head;
    tile_s = ticket / groups;
    group_s = ticket % groups;
  }
  __syncthreads();
  const int row = tid % kRows;                     // output row of the tile
  const int grp = tid / kRows;                     // channel group
  const int lane = row & 31;
  const int warp = row >> 5;

  // read after the front's __syncthreads
  for (int idx = tid; idx < kCh * 4; idx += kThreads) {
    const int cg = shared_int(group_s) * kCh + idx / 4;
    tab[idx] = cg < C ? table[cg * 4 + idx % 4] : 0.f;
  }

  // ---- 1) front ------------------------------------------------------------
  float acc_re[kBe], acc_im[kBe];
  const float* out = nullptr;
  const int group = shared_int(group_s);
  const long g0 = (long)(shared_int(tile_s) * kNew - 1) * D;
  unsigned char* sbytes = reinterpret_cast<unsigned char*>(smem4);
  if constexpr (kPfb && kGrade == gsdr::kGradeF32 && kChunked) {
    out = gsdr::pfb_front_chunked(sbytes, buf_re, buf_im, nb, hp,
                                  reinterpret_cast<const float*>(btab), K, Q,
                                  D, group, g0, Tc, Uc);
  } else if constexpr (kPfb && kGrade == gsdr::kGradeF32) {
    out = gsdr::pfb_front(sbytes, buf_re, buf_im, nb, hp,
                          reinterpret_cast<const float*>(btab), K, Q, D,
                          group, g0);
  } else if constexpr (kPfb && kChunked) {
    if constexpr (kCount) gsdr::clocks::block_open(clk, gsdr::clocks::kFront);
    out = gsdr::pfb_front_mma_chunked<kGrade, gsdr::kPfbNT, kRows, kCount>(
        sbytes, buf_re, buf_im, nb, hp,
        reinterpret_cast<const uint32_t*>(btab), C, K, Q, D, group, g0, Tc,
        Uc, clk);
    if constexpr (kCount) gsdr::clocks::block_close(clk, gsdr::clocks::kFront);
  } else if constexpr (kPfb) {
    out = gsdr::pfb_front_mma<kGrade, gsdr::kPfbNT>(
        sbytes, buf_re, buf_im, nb, hp,
        reinterpret_cast<const uint32_t*>(btab), C, K, Q, D, group, g0);
  } else if constexpr (kGrade == gsdr::kGradeF32) {
    out = gsdr::toeplitz_front<kChunked, kCh, kCols, kUnroll>(
        sbytes, buf_re, buf_im, nb, ftab, C, T, Tc, D, group, g0);
  } else if constexpr (kChunked) {
    gsdr::toeplitz_front_mma_chunked<kGrade, kCh / 4>(
        sbytes, buf_re, buf_im, nb, btab, C, T, Tc, D, group, g0, acc_re,
        acc_im);
  } else {
    gsdr::toeplitz_front_mma<kGrade, kCh / 4>(sbytes, buf_re, buf_im, nb,
                                              btab, C, T, D, group, g0,
                                              acc_re, acc_im);
  }

  // the back end, for this thread's group of kBe channels
  const float* gtab = tab + grp * kBe * 4;
  if constexpr (kTileOut) {
#pragma unroll
    for (int c = 0; c < kBe; ++c) {
      acc_re[c] = out[row * kOS + 2 * (grp * kBe + c)];
      acc_im[c] = out[row * kOS + 2 * (grp * kBe + c) + 1];
    }
  }
  const int idx = n0_rot[0] + (shared_int(tile_s) * kNew - 1 + row) * D;
  float fdig[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) fdig[d] = (float)((idx >> (8 * d)) & 255);

  // ---- 2) LO rotor from the digit table ------------------------------------
#pragma unroll
  for (int c = 0; c < kBe; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < 4; ++d)
      acc = __fadd_rn(acc, __fmul_rn(fdig[d], gtab[c * 4 + d]));
    const float frac = __fsub_rn(acc, floorf(acc));
    float s, co;
    sincosf(__fmul_rn(kTwoPi, frac), &s, &co);
    const float yr = acc_re[c], yi = acc_im[c];
    acc_re[c] = yr * co - yi * s;
    acc_im[c] = yr * s + yi * co;
  }
  const int tile = shared_int(tile_s);
  const int j0 = tile * kNew;
  const int j = j0 - 1 + row;                      // this thread's output
  const int c0 = shared_int(group_s) * kCh + grp * kBe;
  const bool real = row > 0 && j < M;   // an output this block writes
  const int n_real = min(kNew, M - j0);   // outputs of this tile
  if (j < 0) {   // block 0, thread 0: the carried previous sample
#pragma unroll
    for (int c = 0; c < kBe; ++c) {
      acc_re[c] = c0 + c < C ? cf_re_in[c0 + c] : 0.f;
      acc_im[c] = c0 + c < C ? cf_im_in[c0 + c] : 0.f;
    }
  }
  if (j == M - 1) {
#pragma unroll
    for (int c = 0; c < kBe; ++c) {
      if (c0 + c < C) {
        cf_re_out[c0 + c] = acc_re[c];
        cf_im_out[c0 + c] = acc_im[c];
      }
    }
  }

  // ---- 3) discriminator: f[j] * conj(f[j-1]) -------------------------------
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < kBe; ++c) {
      y_edge[grp][warp][c][0] = acc_re[c];
      y_edge[grp][warp][c][1] = acc_im[c];
    }
  }
  __syncthreads();
  float dsc[kBe];
#pragma unroll
  for (int c = 0; c < kBe; ++c) {
    float pr = __shfl_up_sync(kFull, acc_re[c], 1);
    float pi = __shfl_up_sync(kFull, acc_im[c], 1);
    if (lane == 0 && warp > 0) {
      pr = y_edge[grp][warp - 1][c][0];
      pi = y_edge[grp][warp - 1][c][1];
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
  const float cc = coef[1], a = coef[2];
  float z[kBe];
#pragma unroll
  for (int c = 0; c < kBe; ++c) z[c] = cc * dsc[c];
  float as = a;   // a^s
  for (int s = 1; s < 32; s <<= 1) {
#pragma unroll
    for (int c = 0; c < kBe; ++c) {
      const float v = __shfl_up_sync(kFull, z[c], s);
      if (lane >= s) z[c] = fmaf(as, v, z[c]);
    }
    as *= as;
  }
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < kBe; ++c) z_edge[grp][warp][c] = z[c];
  }
  __syncthreads();
  const float a32 = as;            // a^32
  const float a_lane = ipow(a, lane + 1);
#pragma unroll
  for (int c = 0; c < kBe; ++c) {
    float sprev = 0.f;             // state at the end of the previous warp
    for (int w = 0; w < warp; ++w)
      sprev = fmaf(a32, sprev, z_edge[grp][w][c]);
    z[c] = fmaf(a_lane, sprev, z[c]);
  }
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < kBe; ++c) z_last[grp][warp][c] = z[c];
  }
  __syncthreads();

  // ---- 5) the tile's start state by the look-back, then the outputs ------
  const unsigned epoch = epoch_of(head_s);
  if (row == n_real) {   // the aggregate: the tile's zero-state end
#pragma unroll
    for (int c = 0; c < kBe; ++c) {
      zend_s[grp * kBe + c] = z[c];
      if (c0 + c < C)
        st_relaxed(sc.agg + (long)tile * C + c0 + c, stamp(z[c], epoch));
    }
  }
  // the outputs from a zero tile start, b0*d[j] + z[j-1], the only values
  // a thread holds while the block looks back
  const float b0 = coef[0];
  float y0[kBe];
#pragma unroll
  for (int c = 0; c < kBe; ++c) {
    float zp = __shfl_up_sync(kFull, z[c], 1);
    if (lane == 0 && warp > 0) zp = z_last[grp][warp - 1][c];
    y0[c] = fmaf(b0, dsc[c], zp);
  }
  {
    // the look-back: the words of the kW tiles before this one, for every
    // channel of the block, polled at once (a thread a word pair, into the
    // front's shared memory, free now: 16 bytes a thread, under every
    // front's output tile), then a thread a channel walks them
    constexpr int kW = kThreads / kCh;
    unsigned long long* win = reinterpret_cast<unsigned long long*>(smem4);
    const int cg = shared_int(group_s) * kCh;
    const int m = tid / kCh + 1, c = cg + tid % kCh;
    const long slot = (long)(tile - m) * C + c;
    const bool polled = tile - m >= 0 && c < C;
    win[tid] = polled ? ld_relaxed(sc.incl + slot) : 0ull;
    win[kThreads + tid] = polled ? ld_relaxed(sc.agg + slot) : 0ull;
    __syncthreads();
    if (tid < kCh) {
      z_start[tid] = cg + tid < C
                         ? start_state<kW, kCh, kNew, kCount>(
                               sc, win, tid, cg + tid, C, tile, a,
                               cz_in[cg + tid], epoch, clk)
                         : 0.f;
    }
  }
  const float a_row = row > 0 ? ipow(a, row - 1) : 0.f;   // a^(j - j0)
  __syncthreads();
  const float a_tile = ipow(a, n_real);
#pragma unroll
  for (int c = 0; c < kBe; ++c) {
    if (c0 + c < C) {
      const float zs = z_start[grp * kBe + c];
      if (real) audio[(long)(c0 + c) * M + j] = fmaf(a_row, zs, y0[c]);
      if (row == n_real) {   // the inclusive state; the last tile's is zf
        const float incl = fmaf(a_tile, zs, zend_s[grp * kBe + c]);
        st_relaxed(sc.incl + (long)tile * C + c0 + c, stamp(incl, epoch));
        if (tile == ntiles - 1) cz_out[c0 + c] = incl;
      }
    }
  }
}

// The FM chain's tile kernel (fm_chain_run, above).
template <bool kPfb, int kGrade, bool kChunked = false,
          int kCh = gsdr::block_channels<kPfb>(), int kRows = kTile>
__global__ void __launch_bounds__(
    gsdr::back_threads(kCh),
    !kPfb && !kChunked ? 1024 / gsdr::back_threads(kCh) : 1)
fm_chain_tile(
    const float* __restrict__ buf_re, const float* __restrict__ buf_im,
    int nb, const float* __restrict__ ftab, const float* __restrict__ hp,
    const uint2* __restrict__ btab, int C, int T, int Tc, int K, int Q, int D,
    int M, int ntiles, const float* __restrict__ table,
    const int* __restrict__ n0_rot,
    const float* __restrict__ coef, float gain,
    const float* __restrict__ cf_re_in, const float* __restrict__ cf_im_in,
    const float* __restrict__ cz_in, float* __restrict__ audio,
    float* __restrict__ cf_re_out, float* __restrict__ cf_im_out,
    float* __restrict__ cz_out, Scratch sc, int Uc) {
  fm_chain_run<kPfb, kGrade, kChunked, kCh, kRows, false>(
      buf_re, buf_im, nb, ftab, hp, btab, C, T, Tc, K, Q, D, M, ntiles, table,
      n0_rot, coef, gain, cf_re_in, cf_im_in, cz_in, audio, cf_re_out,
      cf_im_out, cz_out, sc, Uc, nullptr);
}

// fm_chain_tile of the chunked PFB front with its clock counters
// (clocks.cuh), added into `counters` at each block's end.
template <int kGrade, int kRows, int kCh = gsdr::block_channels<true>()>
__global__ void __launch_bounds__(gsdr::back_threads(kCh), 1)
fm_chain_tile_counted(
    const float* __restrict__ buf_re, const float* __restrict__ buf_im,
    int nb, const float* __restrict__ ftab, const float* __restrict__ hp,
    const uint2* __restrict__ btab, int C, int T, int Tc, int K, int Q, int D,
    int M, int ntiles, const float* __restrict__ table,
    const int* __restrict__ n0_rot,
    const float* __restrict__ coef, float gain,
    const float* __restrict__ cf_re_in, const float* __restrict__ cf_im_in,
    const float* __restrict__ cz_in, float* __restrict__ audio,
    float* __restrict__ cf_re_out, float* __restrict__ cf_im_out,
    float* __restrict__ cz_out, Scratch sc, int Uc,
    unsigned long long* __restrict__ counters) {
  static_assert(gsdr::back_threads(kCh) <= 32 * gsdr::clocks::kWarps,
                "a counter slot a warp");
  __shared__ unsigned long long clk[gsdr::clocks::kSlots];
  gsdr::clocks::block_start(clk);
  fm_chain_run<true, kGrade, true, kCh, kRows, true>(
      buf_re, buf_im, nb, ftab, hp, btab, C, T, Tc, K, Q, D, M, ntiles, table,
      n0_rot, coef, gain, cf_re_in, cf_im_in, cz_in, audio, cf_re_out,
      cf_im_out, cz_out, sc, Uc, clk);
  gsdr::clocks::block_end(clk, counters);
}

// The one launch of a chain call, its blocks of kRows rows (where kCount,
// fm_chain_tile_counted's, adding into `counters`); returns 0 or the CUDA
// error.
template <bool kPfb, int kGrade, bool kChunked,
          int kCh = gsdr::block_channels<kPfb>(), int kRows = kTile,
          bool kCount = false>
int run_chain(const void* buf_re, const void* buf_im, const void* ftab,
              const void* hp, const void* btab, const void* table,
              const void* n0_rot, const void* coef, const void* cf_re_in,
              const void* cf_im_in, const void* cz_in, void* audio,
              void* cf_re_out, void* cf_im_out, void* cz_out,
              const Scratch& sc, int nb, int C, int T, int Tc, int K, int Q,
              int D, int M, int ntiles, float gain, size_t smem, void* stream,
              int Uc = 0, void* counters = nullptr) {
  const unsigned blocks = (unsigned)ntiles * ((C + kCh - 1) / kCh);
  if constexpr (kCount) {
    const cudaError_t err = cudaFuncSetAttribute(
        fm_chain_tile_counted<kGrade, kRows, kCh>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fm_chain_tile_counted<kGrade, kRows, kCh>
        <<<blocks, gsdr::back_threads(kCh), smem, (cudaStream_t)stream>>>(
        (const float*)buf_re, (const float*)buf_im, nb, (const float*)ftab,
        (const float*)hp, (const uint2*)btab, C, T, Tc, K, Q, D, M, ntiles,
        (const float*)table, (const int*)n0_rot, (const float*)coef, gain,
        (const float*)cf_re_in, (const float*)cf_im_in, (const float*)cz_in,
        (float*)audio, (float*)cf_re_out, (float*)cf_im_out, (float*)cz_out,
        sc, Uc, (unsigned long long*)counters);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      fm_chain_tile<kPfb, kGrade, kChunked, kCh, kRows>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fm_chain_tile<kPfb, kGrade, kChunked, kCh, kRows>
      <<<blocks, gsdr::back_threads(kCh), smem, (cudaStream_t)stream>>>(
      (const float*)buf_re, (const float*)buf_im, nb, (const float*)ftab,
      (const float*)hp, (const uint2*)btab, C, T, Tc, K, Q, D, M, ntiles,
      (const float*)table, (const int*)n0_rot, (const float*)coef, gain,
      (const float*)cf_re_in, (const float*)cf_im_in, (const float*)cz_in,
      (float*)audio, (float*)cf_re_out, (float*)cf_im_out, (float*)cz_out,
      sc, Uc);
  return (int)cudaGetLastError();
}

// The scratch at `scratch` of `slots` slots, or false where a call of
// ntiles tiles of C channels does not fit it.
bool scratch_at(void* scratch, long slots, int ntiles, int C, Scratch* sc) {
  // slots under the header's refresh argument, and every slot of the call
  if (scratch == nullptr || slots > 0x7fffffffL || (long)ntiles * C > slots)
    return false;
  char* s = (char*)scratch;
  sc->head = (unsigned long long*)s;
  sc->slots = slots;
  sc->agg = (unsigned long long*)(s + gsdr::lookback::kHeader);
  sc->incl = sc->agg + slots;
  return true;
}

}  // namespace

// New outputs a block of `rows` rows makes (rows - 1, its first row the
// previous block's last output): a call of M outputs takes ceil(M /
// fm_chain_tile_outputs(rows)) row tiles, and as many look-back slots a
// channel. rows: the block's (fm_chain_fits' plan[2]; kTile but for the
// chunked bf16 PFB front).
extern "C" int fm_chain_tile_outputs(int rows) { return rows - 1; }

// The slots of the counted kernel's counter buffer (clocks.cuh).
extern "C" int fm_chain_counter_slots() { return gsdr::clocks::kCounters; }

// Bytes of de-emphasis scratch for `slots` slots (tiles times channels of
// a call).
extern "C" long fm_chain_scratch_bytes(long slots) {
  return gsdr::lookback::kHeader + slots * 2 * 8;
}

namespace {

// The dense tile kernel of a grade for kCh channels a block, one chunk or
// chunked.
template <int kGrade, int kCh = kCG>
const void* dense_tile(bool chunked) {
  return chunked ? (const void*)fm_chain_tile<false, kGrade, true, kCh>
                 : (const void*)fm_chain_tile<false, kGrade, false, kCh>;
}

// The PFB tile kernel of a grade with its dynamic shared memory for
// (K, Q, D) and the plan of Tc lanes and Uc fold taps a chunk (the chunked
// kernel where use_chunked_pfb, at the bf16 grades in blocks of `rows`
// rows; every other block kTile: gsdr::with_pfb_tile), or nullptr for a
// grade the library lacks.
const void* pfb_kernel(int grade, int Tc, int K, int Q, int D, size_t* smem,
                       int Uc, int rows = kTile) {
  const bool ch = gsdr::use_chunked_pfb(Tc, Uc, K, Q);
  switch (grade) {
    case gsdr::kGradeF32:
      *smem = ch ? gsdr::pfb_chunk_bytes(K, Q, D, Tc, Uc)
                 : gsdr::pfb_smem_bytes(K, Q, D);
      break;
    case gsdr::kGradeBf16x2:
    case gsdr::kGradeBf16x3:
      *smem = ch ? gsdr::pfb_mma_chunk_bytes(gsdr::kPfbNT, K, Q, D, Tc, Uc,
                                             rows)
                 : gsdr::pfb_mma_smem_bytes(gsdr::kPfbNT, K, Q, D);
      break;
    default:
      return nullptr;
  }
  return gsdr::with_pfb_tile(grade, ch, rows, [](auto g, auto c, auto r) {
    return (const void*)fm_chain_tile<true, decltype(g)::value,
                                      decltype(c)::value, gsdr::kPfbCh,
                                      decltype(r)::value>;
  });
}

// The rows of the chunked PFB block at `grade` for C channels and M
// outputs: at the bf16 grades gsdr::pfb_mma_rows, its tiles overlapping by
// the one output whose sample the discriminator carries; at f32 kTile.
int pfb_rows(int grade, int C, int M) {
  return grade == gsdr::kGradeF32 ? kTile
                                  : gsdr::pfb_mma_rows(C, M, kTile - kOut);
}

// The bf16 chunked kernel's block for C channels and M outputs (M < 1:
// any M): 4, 8 or 16 channels, kTile rows (the dense front's blocks keep
// them; gsdr::mma_chunk_block).
gsdr::MmaBlock mma_block(int C, int M) {
  return gsdr::mma_chunk_block(C, M, kCG, kTile, kTile - kOut);
}

// The bf16 chunked tile kernel of a grade for a block of kCh channels.
template <int kGrade>
struct MmaTile {
  template <int kCh, int kRows>
  const void* run() const {
    return (const void*)fm_chain_tile<false, kGrade, true, kCh>;
  }
};

// The channels of the bf16 dense block for C channels and M outputs: `ch`
// where a caller forces it (4, 8 or 16; 0: planned), else the chunked
// kernel's mma_block(C, M) or the one-chunk kernel's
// one_chunk_channels(C). Each output column's sum is independent of the
// others, so the outputs do not depend on the block.
int mma_channels(int C, int M, bool chunked, int ch) {
  return ch > 0 ? ch : chunked ? mma_block(C, M).ch : one_chunk_channels(C);
}

// The dense tile kernel of a grade for C channels and M outputs (at f32 in
// blocks of dense_f32_channels(C); at the bf16 grades in blocks of
// mma_channels(C, M, chunked, ch)), one chunk or `chunked`, with its
// dynamic shared memory for a chunk of Tc of T taps at D, or nullptr for a
// grade the library lacks.
const void* dense_kernel(int grade, int C, int T, int Tc, int D, int M,
                         size_t* smem, bool chunked, int ch = 0) {
  switch (grade) {
    case gsdr::kGradeF32: {
      const int fch = gsdr::dense_f32_channels(C);
      *smem = gsdr::toeplitz_smem_bytes(fch, Tc, T, D);
      return fch == 8    ? dense_tile<gsdr::kGradeF32, 8>(chunked)
             : fch == 16 ? dense_tile<gsdr::kGradeF32, 16>(chunked)
                         : dense_tile<gsdr::kGradeF32, 32>(chunked);
    }
    case gsdr::kGradeBf16x2:
    case gsdr::kGradeBf16x3: {
      const gsdr::MmaBlock b{mma_channels(C, M, chunked, ch), kTile};
      *smem = chunked
                  ? gsdr::mma_chunked_smem_bytes(b.ch / 4, kTile, Tc, T, D)
                  : gsdr::mma_smem_bytes(grade, b.ch / 4, Tc, D);
      if (chunked)
        return grade == gsdr::kGradeBf16x2
                   ? gsdr::with_mma_block<kCG, kTile>(
                         b, MmaTile<gsdr::kGradeBf16x2>{})
                   : gsdr::with_mma_block<kCG, kTile>(
                         b, MmaTile<gsdr::kGradeBf16x3>{});
      const bool x2 = grade == gsdr::kGradeBf16x2;
      return b.ch == 4   ? (x2 ? dense_tile<gsdr::kGradeBf16x2, 4>(false)
                               : dense_tile<gsdr::kGradeBf16x3, 4>(false))
             : b.ch == 8 ? (x2 ? dense_tile<gsdr::kGradeBf16x2, 8>(false)
                               : dense_tile<gsdr::kGradeBf16x3, 8>(false))
                         : (x2 ? dense_tile<gsdr::kGradeBf16x2>(false)
                               : dense_tile<gsdr::kGradeBf16x3>(false));
    }
  }
  return nullptr;
}

}  // namespace

// The block plan of the front at `grade` (0 f32, 2 bf16x2, 3 bf16x3) on
// the current device, for any channel count C (the grid covers the
// channels): for the dense front (pfb = 0, with T and D, C and M, on which
// the block depends; C < 1: any C, M < 1: any M, the widest block)
// plan[0] = the taps a block stages at once (gsdr::dense_chunk: T in one
// chunk where the whole bank fits; else chunks whose two buffers let two
// blocks share a SM where such a chunk spans D taps, else the largest that
// fits; 0 only where not even 8 taps fit), plan[1] and plan[2] the
// channels and rows of the block that launch takes (at the bf16 grades
// mma_channels: one_chunk_channels(C) for one chunk, mma_block(C, M) for
// the chunked kernel); for the PFB front (pfb = 1, with K, Q and D, and C
// and M, on which the chunked block's rows depend) plan[2] = the rows of
// the block (pfb_rows for the chunked kernel, else kTile) and plan[0..1] =
// the lanes and fold taps a chunk of that block takes (gsdr::pfb_chunk:
// (K, Q) where one chunk fits, (0, 0) where nothing fits). Returns 0 or the
// CUDA error; an unknown grade is an invalid value.
extern "C" int fm_chain_fits(int pfb, int grade, int C, int T, int K, int Q,
                             int D, int M, int* plan) {
  if (T < 1 || D < 1 || (pfb && (K < 1 || Q < 1 || K % D != 0)))
    return (int)cudaErrorInvalidValue;
  size_t smem = 0, b = 0;
  if (pfb) {
    const void* one = pfb_kernel(grade, K, K, Q, D, &smem, Q);
    if (one == nullptr) return (int)cudaErrorInvalidValue;
    // the chunked block's rows, then its chunks for that block's bytes
    const int rows = pfb_rows(grade, C, M);
    const cudaError_t err = gsdr::pfb_chunk(
        one, smem, pfb_kernel(grade, 8, K, Q, D, &b, 1, rows), K, Q, D,
        [=](int lanes, int uc) {
          size_t bytes = 0;
          pfb_kernel(grade, lanes, K, Q, D, &bytes, uc, rows);
          return bytes;
        },
        plan, rows);
    plan[2] = gsdr::use_chunked_pfb(plan[0], plan[1], K, Q) ? rows : kTile;
    return (int)err;
  }
  const void* one = dense_kernel(grade, C, T, T, D, M, &smem, false);
  if (one == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = gsdr::dense_chunk(
      one, dense_kernel(grade, C, T, T, D, M, &b, true), T,
      [=](int tc) {
        size_t bytes = 0;
        dense_kernel(grade, C, T, tc, D, M, &bytes,
                     gsdr::use_chunked_kernel(tc, T, D));
        return bytes;
      },
      plan, D);
  plan[1] = grade == gsdr::kGradeF32
                ? gsdr::dense_f32_channels(C)
                : mma_channels(C, M, gsdr::use_chunked_kernel(plan[0], T, D),
                               0);
  plan[2] = kTile;
  return (int)err;
}

extern "C" const char* fm_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dense front at `grade` (as fm_chain_fits), Tc taps a block stages at
// once (fm_chain_fits' plan, or any chunk gsdr::valid_chunk takes whose
// block fits), ch channels a bf16 block (4, 8 or 16 to force one; 0: the
// plan's; 0 at f32). Shapes: buf planes (nb,), ftab dense_f32_tables'
// (ceil(C/8), T, 8, 2) float32 read at f32, btab dense_mma_tables' (2,
// ceil(T/8), ceil(C/4), 16, 2) int32 read at bf16x3 and bf16x2, table (C,
// 4), n0_rot (1,) int32, coef (3,) = (b0, cc, a), carries (C,), audio (C,
// M). scratch: fm_chain_scratch_bytes(slots) bytes, slots >= C *
// ceil(M / fm_chain_tile_outputs()), zeroed once when allocated and then
// kept by the caller for the calls of one stream (eager or replayed from a
// CUDA graph, in any order; lookback.cuh).
extern "C" int fm_chain_launch(
    const void* buf_re, const void* buf_im, const void* ftab,
    const void* btab, const void* table, const void* n0_rot,
    const void* coef, const void* cf_re_in, const void* cf_im_in,
    const void* cz_in, void* audio, void* cf_re_out, void* cf_im_out,
    void* cz_out, void* scratch, long slots, int nb, int C, int T, int Tc,
    int D, int M, int ch, int grade, float gain, void* stream) {
  const int ntiles = M > 0 ? (M + kOut - 1) / kOut : 0;
  Scratch sc;
  if (C < 1 || T < 1 || D < 1 || M < 1 || M != (nb - T) / D + 1 ||
      !gsdr::valid_chunk(Tc, T) ||
      !(ch == 0 || (grade != gsdr::kGradeF32 &&
                    (ch == 4 || ch == 8 || ch == kCG))) ||
      !scratch_at(scratch, slots, ntiles, C, &sc))
    return (int)cudaErrorInvalidValue;
  Tc = Tc < T ? Tc : T;
  const bool chunked = gsdr::use_chunked_kernel(Tc, T, D);
  size_t smem = 0;
  if (dense_kernel(grade, C, T, Tc, D, M, &smem, chunked, ch) == nullptr)
    return (int)cudaErrorInvalidValue;
#define GSDR_DENSE_CHAIN_AT(G, CHUNKED, CH)                                  \
  run_chain<false, G, CHUNKED, CH>(                                         \
      buf_re, buf_im, ftab, nullptr, btab, table, n0_rot, coef, cf_re_in,   \
      cf_im_in, cz_in, audio, cf_re_out, cf_im_out, cz_out, sc, nb, C, T,   \
      Tc, 0, 0, D, M, ntiles, gain, smem, stream)
#define GSDR_DENSE_CHAIN(G, CH)                \
  (chunked ? GSDR_DENSE_CHAIN_AT(G, true, CH)  \
           : GSDR_DENSE_CHAIN_AT(G, false, CH))
#define GSDR_MMA_CHAIN(G)                       \
  (bch == 4   ? GSDR_DENSE_CHAIN(G, 4)           \
   : bch == 8 ? GSDR_DENSE_CHAIN(G, 8)           \
              : GSDR_DENSE_CHAIN(G, kCG))
  const int bch = mma_channels(C, M, chunked, ch);
  switch (grade) {
    case gsdr::kGradeBf16x2:
      return GSDR_MMA_CHAIN(gsdr::kGradeBf16x2);
    case gsdr::kGradeBf16x3:
      return GSDR_MMA_CHAIN(gsdr::kGradeBf16x3);
  }
  switch (gsdr::dense_f32_channels(C)) {
    case 8:
      return GSDR_DENSE_CHAIN(gsdr::kGradeF32, 8);
    case 16:
      return GSDR_DENSE_CHAIN(gsdr::kGradeF32, 16);
    default:
      return GSDR_DENSE_CHAIN(gsdr::kGradeF32, 32);
  }
#undef GSDR_MMA_CHAIN
#undef GSDR_DENSE_CHAIN
#undef GSDR_DENSE_CHAIN_AT
}

// PFB front at `grade`: channels on the Fs/K grid, D | K. hp (Q, K)
// polyphase taps; btab the DFT bank's table: pfb_f32_tables' (ceil(C/32),
// K, 32, 2) float32 at f32, pfb_mma_tables' (2, ceil(K/8), ceil(C/4), 16,
// 2) int32 at bf16x3 and bf16x2. T is the prototype's tap count (Q*K >=
// T), which sets M.
// (lanes, uc) is the plan (fm_chain_fits', or any gsdr::valid_pfb_plan):
// (K, Q) the one-chunk kernel, else the chunked one, which at bf16x3 and
// bf16x2 reads both tables in its lane order (kernels/chain.py,
// pfb_chunk_taps' (Q, 8*KBg) and pfb_mma_chunk_tables' (2, KBg,
// ceil(C/4), 32, 2), KBg blocks of 8 lanes). rows: the block's output rows,
// fm_chain_fits' plan[2]: kTile, or for the chunked kernel at bf16x3 and
// bf16x2 any of gsdr::valid_pfb_rows (its front's outputs and the
// discriminator's are the same at every row count; the de-emphasis start
// states are composed over other tile edges). A plan whose block does not
// fit the card is refused before launch (too many resources). counters:
// null, or an int64 buffer of fm_chain_counter_slots() slots that the
// counted kernel adds into (clocks.cuh), which only the chunked plan at
// bf16x3 has (else an invalid value). Other shapes and the scratch as
// fm_chain_launch, its slots >= C * ceil(M / fm_chain_tile_outputs(rows)).
extern "C" int pfb_fm_chain_launch(
    const void* buf_re, const void* buf_im, const void* hp, const void* btab,
    const void* table, const void* n0_rot, const void* coef,
    const void* cf_re_in, const void* cf_im_in, const void* cz_in,
    void* audio, void* cf_re_out, void* cf_im_out, void* cz_out,
    void* scratch, long slots, int nb, int C, int T, int K, int Q, int D,
    int M, int lanes, int uc, int rows, int grade, float gain, void* stream,
    void* counters) {
  const bool chunked = gsdr::use_chunked_pfb(lanes, uc, K, Q);
  const bool mma = chunked && grade != gsdr::kGradeF32;
  Scratch sc;
  if (C < 1 || T < 1 || D < 1 || K < 1 || K % D != 0 || Q < 1 ||
      Q * K < T || M < 1 || M != (nb - T) / D + 1 ||
      !gsdr::valid_pfb_plan(lanes, uc, K, Q) ||
      !(rows == kTile || (mma && gsdr::valid_pfb_rows(rows))))
    return (int)cudaErrorInvalidValue;
  const int ntiles = (M + rows - 2) / (rows - 1);
  if (!scratch_at(scratch, slots, ntiles, C, &sc))
    return (int)cudaErrorInvalidValue;
  if (counters != nullptr && !(chunked && grade == gsdr::kGradeBf16x3))
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  const void* kernel = pfb_kernel(grade, lanes, K, Q, D, &smem, uc, rows);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (counters != nullptr)   // its own static shared memory: the clocks
    kernel = gsdr::with_pfb_tile<true>(
        grade, chunked, rows, [](auto, auto, auto r) {
          return (const void*)fm_chain_tile_counted<gsdr::kGradeBf16x3,
                                                    decltype(r)::value>;
        });
  int fits = 0;
  const cudaError_t err = gsdr::block_fits(kernel, smem, &fits);
  if (err != cudaSuccess) return (int)err;
  if (!fits) return (int)cudaErrorLaunchOutOfResources;
  // the launch of the kernel pfb_kernel took, where `count` the counted one
  auto launch = [&](auto count, auto g, auto c, auto r) {
    return run_chain<true, decltype(g)::value, decltype(c)::value,
                     gsdr::kPfbCh, decltype(r)::value, decltype(count)::value>(
        buf_re, buf_im, nullptr, hp, btab, table, n0_rot, coef, cf_re_in,
        cf_im_in, cz_in, audio, cf_re_out, cf_im_out, cz_out, sc, nb, C, T,
        lanes, K, Q, D, M, ntiles, gain, smem, stream, uc, counters);
  };
  if (counters != nullptr)
    return gsdr::with_pfb_tile<true>(grade, chunked, rows, [&](auto... k) {
      return launch(std::true_type{}, k...);
    });
  return gsdr::with_pfb_tile(grade, chunked, rows, [&](auto... k) {
    return launch(std::false_type{}, k...);
  });
}
