// The two fronts of the fused channelizer chains, as device functions
// shared by the FM chain (fm_chain.cu) and the AM chain (am_chain.cu).
//
// A front computes, for one block of kTile output rows and a group of
// channels, the un-rotated filtered sample
//   y[c, j] = sum_t x[j*D + t] * g_c[t]
// of the output whose window starts at sample g0 + row * D. Samples
// outside [0, nb) read as zeros.
//
//  - toeplitz_front: the dense complex tap bank at f32, C*T complex MACs
//    per output (gsdr_tpu/kernels/fm_chain_pallas.py, _window_dot), 8, 16
//    or 32 channels a block, in register tiles of rows x channels, into a
//    shared output tile (see "The dense front at f32" below).
//  - pfb_front: channels on the uniform grid f_c = g_c * Fs / K with D | K
//    (gsdr_tpu/kernels/fm_chain_pallas.py, _pfb_fold_dot) at f32: the
//    polyphase fold a[v] = sum_u hp[u, v] * x[j*D + v + u*K] (Q = ceil(T/K)
//    taps per lane v, shared by all channels), then the (2C, 2K) DFT-bank
//    product
//    y_re[c] = sum_v G[c, v] a_re[v] + G[c, K+v] a_im[v]
//    y_im[c] = sum_v G[C+c, v] a_re[v] + G[C+c, K+v] a_im[v],
//    4*kPfbNT channels a block of kPfbThreads threads; the block folds each
//    lane once into a shared A tile and multiplies it in register tiles
//    (see below). The TPU kernel's lane roll with wrapped lanes from the
//    next row is a layout device of the TPU; here the fold indexes its
//    window directly.
//
//  - toeplitz_front_mma<kGrade, kNT>: the dense front on the tensor cores,
//    at the JAX package's bf16x3 (kGrade 3) or bf16x2 (kGrade 2) grade
//    (fm_chain_pallas.py, _window_dot's grade arm), and
//    toeplitz_front_mma_chunked, the same over chunks of taps, double
//    buffered, in blocks of 4-32 channels and 64-256 rows. See below.
//
//  - pfb_front_mma<kGrade, kNT>: the PFB front on the tensor cores at
//    bf16x3 or bf16x2 (fm_chain_pallas.py, _pfb_fold_dot with its grade
//    arm _nt_grade_dot), and pfb_front_mma_chunked, the same over chunks
//    of lanes and fold taps, its warps split into producers that stage
//    and fold and consumers that multiply. See below.
//
// The dense fronts stage the block's input window in shared memory in
// polyphase order, xp[p][k] = x[g0 + k*D + p], so neighbouring threads
// (neighbouring outputs, D samples apart) read neighbouring words (the
// chunked tensor-core front frame-major, so that it stages with 16-byte
// copies, at a frame stride that keeps its A loads on 32 banks). The
// dense fronts walk the taps in ascending chunks of Tc (dense_chunk): a
// chunk stages its own taps and its own window,
// the min(Tc, D) phases of samples g0 + t0 + [0, (kTile-1)*D + Tc) it
// touches, and the sums carry across chunks in registers (or mma.sync
// accumulators) in the order of one pass over all T taps, so a chunked
// launch equals a one-chunk launch bit for bit. Tc = T, one chunk, where
// the whole bank and window fit the block; else the largest multiple of 8
// that does in two staging buffers (with two blocks a SM where such a
// chunk spans D taps), which bounds their shared memory for any T and D.
// Each dense
// front is two kernels (use_chunked_kernel): a one-chunk kernel for
// Tc = T >= D, which stages every phase before its sums start, and a
// chunked kernel for Tc < T or T < D, which stages only the phases a chunk
// touches, the next chunk while it multiplies one; its accumulators stay
// live through the staging, which takes more registers than the one-chunk
// kernel (B1 at bf16x3: 111 against 72 on the H100). The PFB
// fronts stage kPhaseChunk phases at a time, which bounds their shared
// memory for any D; pfb_front_mma keeps each chunk frame-major, so that it
// stages with 16-byte copies, pfb_front phase-major, so that its fold
// reads 32 rows of one lane from 32 banks. Tap tables are read as
// broadcasts.
//
// What bounds the dense front on the card, by grade: in f32, the FP32
// FMAs, 8*C*T FLOP per output at 67 TFLOP/s (the PFB front's product
// 8*C*K); in bf16x3 and bf16x2, 3 or 2
// tensor-core passes of the same 8*C*T at 989 TFLOP/s, 15-22x less time,
// so the grade is bound by the bytes of the function (the window read
// once, the outputs written once) unless the block's own staging and
// shared-memory traffic hold it. What toeplitz_front_mma does about it:
// the product is one real GEMM per block, rows the block's 256 outputs,
// K = 2T (tap, plane) and N = 2 * channels, on mma.sync m16n8k16 bf16
// with f32 accumulators. A comes from registers: each 32-bit A register
// is the (re, im) bf16 pair of one sample, read with one shared load from
// the polyphase window, so a Toeplitz operand whose rows overlap needs no
// dense copy. The window is split while it is staged, hi = bf16(x),
// lo = bf16(x - hi), as JAX's (w - wh.astype(f32)).astype(bf16). B, the
// complex tap bank split into bf16 hi and lo on the host
// (kernels/chain.py, dense_mma_tables), holds only the bank's even
// columns, (gr, -gi): an odd column (gi, gr) is its even neighbour with
// the halves swapped and one sign flipped, formed in registers, so B's
// shared copy is half of the GEMM's B. bf16x3 runs Ah*Bh + Ah*Bl + Al*Bh,
// bf16x2 Ah*Bh + Ah*Bl; every product of two bf16 values is exact in f32,
// so the grade equals JAX's up to summation order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "clocks.cuh"

namespace gsdr {

constexpr int kTile = 256;        // output rows a block
constexpr int kCG = 16;           // channels a bf16 dense block, or a thread's
constexpr int kDenseRows = 4;     // f32 dense front: rows of a tile, 32 apart
constexpr int kPhaseChunk = 16;   // PFB front: input phases staged at once
constexpr int kPfbNT = 8;         // PFB fronts: n-tiles of 4, 32 channels
constexpr int kPfbThreads = 512;  // PFB fronts: threads a block
constexpr int kPfbCh = 4 * kPfbNT;      // PFB fronts: channels a block
constexpr int kPfbFoldLanes = 16;  // pfb_front: lanes an A tile folds
constexpr int kPfbRows = 4;        // pfb_front: rows of a register tile
constexpr int kPfbCols = 4;        // PFB f32 fronts: channels of a tile
constexpr int kPfbWideRows = 8;    // pfb_front_chunked: rows of a tile
constexpr int kPfbConsumers = 256;  // pfb_front_chunked: threads multiplying
constexpr int kMmaStages = 2;   // toeplitz_front_mma_chunked: chunks a ring
// pfb_front_mma_chunked: words of an 8-lane block's A tile for a block of
// `rows` output rows, the bf16 hi and lo words of the rows/16 m-tiles'
// fragments, four a thread
__host__ __device__ constexpr int pfb_a_block_words(int rows) {
  return 2 * (rows / 16) * 32 * 4;
}
// pfb_front_mma_chunked: warps of each role that share an m-tile pair in a
// block of `rows` rows (kPfbConsumers / 32 warps over rows / 32 pairs): 1
// at 256 rows, 2 at 128, 4 at 64
__host__ __device__ constexpr int pfb_mma_split(int rows) {
  return kPfbConsumers / rows;
}
// Grades of the dense front: the number of tensor-core passes; 0 is the
// FP32-FMA front, toeplitz_front.
constexpr int kGradeF32 = 0;
constexpr int kGradeBf16x2 = 2;
constexpr int kGradeBf16x3 = 3;

// Phases of the window that a chunk of Tc taps touches.
__host__ __device__ inline int chunk_phases(int Tc, int D) {
  return Tc < D ? Tc : D;
}

// Channels a block of the f32 dense front takes for a bank of C channels:
// 8, 16 or 32 (C < 1 stands for any C: 32, the widest block).
__host__ __device__ constexpr int dense_f32_channels(int C) {
  return C >= 1 && C <= 8 ? 8 : C >= 1 && C <= 16 ? 16 : 32;
}

// Threads of the f32 dense front that hold a register tile of `cols`
// channels (4 or 8), for ch channels a block: kTile / (32 * kDenseRows)
// warps of rows for each `cols` channels.
__host__ __device__ constexpr int dense_f32_threads(int ch, int cols) {
  return kTile / kDenseRows * (ch / cols);
}

// The tile widths and product unrolls the launchers take (H100, PR 15:
// each the fastest of the variants timed there): the FM chain's one-chunk
// kernel 4 channels (its 256 threads all hold tiles, and its back end
// keeps four blocks a SM at 64 registers), its chunked kernel 8 unrolled
// by 4 (a long bank's FMAs on the four warps of a block that hold tiles:
// 1625 us at the 2049-tap filter against 1720 unrolled by 2, 1880 by 1);
// the AM chain and the channelizer 4 for a block of 8 channels (128
// threads: a large D leaves few blocks), else 8; unrolled by 1 but for
// the FM chunked kernel (fewer registers, more blocks a SM: the transmux
// 52 us against 57.5 unrolled by 2).
__host__ __device__ constexpr int fm_dense_cols(bool chunked) {
  return chunked ? 8 : 4;
}

__host__ __device__ constexpr int fm_dense_unroll(bool chunked) {
  return chunked ? 4 : 1;
}

__host__ __device__ constexpr int dense_cols(int ch) {
  return ch == 8 ? 4 : 8;
}

// Pairs between two phases of the f32 dense front's window for a chunk
// of Tc taps: Kr = kTile + (Tc - 1)/D frames, made odd, so that a warp's
// staging copies to neighbouring phases fall on different banks (Kr = 256,
// a chunk shorter than D, would put them all on one).
__host__ __device__ inline int dense_phase_stride(int Tc, int D) {
  return (kTile + (Tc - 1) / D) | 1;
}

// Floats of one staging buffer of the f32 dense front: a chunk of Tc taps
// of ch/8 groups [ch/8][Tc][8][2], then its window [Dc][Ks] of (re, im)
// pairs, Dc = chunk_phases(Tc, D), Ks = dense_phase_stride(Tc, D); padded
// to 16 bytes.
__host__ __device__ inline size_t dense_f32_buffer_floats(int ch, int Tc,
                                                          int D) {
  return ((size_t)16 * (ch / 8) * Tc + 2 * (size_t)chunk_phases(Tc, D) *
                                           dense_phase_stride(Tc, D) +
          3) / 4 * 4;
}

// The f32 dense front's dynamic shared memory for ch channels a block and
// a chunk of Tc <= T taps: one staging buffer for one chunk, two where
// Tc < T; the kTile x (2*ch + 1) output tile reuses the space.
__host__ __device__ inline size_t toeplitz_smem_bytes(int ch, int Tc, int T,
                                                      int D) {
  const size_t all = (Tc < T ? 2 : 1) * dense_f32_buffer_floats(ch, Tc, D);
  const size_t out = (size_t)kTile * (2 * ch + 1);
  return sizeof(float) * (all > out ? all : out);
}

// Words per phase of the tensor-core front's window: the Kr = kTile +
// (Tp - 1)/D words a phase needs, padded to 8 mod 32, so that the four
// taps of an A register group (four phases for D >= 4) fall on four
// different 8-bank groups.
__host__ __device__ inline int mma_phase_stride(int Tp, int D) {
  const int kr = kTile + (Tp - 1) / D;
  return kr + ((8 - kr % 32) + 32) % 32;
}

// toeplitz_front_mma's dynamic shared memory for a chunk of Tc taps
// (padded to whole blocks of 8): the chunk's B, hi and lo parts, the tap
// offsets, then the chunk's window (hi, and lo at bf16x3), whose space the
// kTile x (8*kNT + 1) output tile reuses after the product.
__host__ __device__ inline size_t mma_smem_bytes(int grade, int nt, int Tc,
                                                 int D) {
  const size_t kb = (Tc + 7) / 8, tp = 8 * kb;
  const size_t b = 2 * kb * nt * 16 * sizeof(uint2);
  const size_t win = (grade == kGradeBf16x3 ? 2 : 1) *
                     (size_t)chunk_phases((int)tp, D) *
                     mma_phase_stride((int)tp, D) * sizeof(uint32_t);
  const size_t out = (size_t)kTile * (8 * nt + 1) * sizeof(float);
  return b + tp * sizeof(int) + (win > out ? win : out);
}

// The geometry of toeplitz_front_mma_chunked for a block of nt n-tiles
// (4*nt channels) and `rows` output rows, a chunk of Tc of T taps at D:
// KBc blocks of 8 taps a chunk (all KB = ceil(T/8) where Tc >= T), Tcp =
// 8*KBc taps; the window's Kr = rows + (Tcp - 1)/D frames of Dc =
// chunk_phases(Tcp, D) phases, frame-major at Lp words a frame (Dc padded
// to 4 mod 8, so that the 8 rows x 4 taps of an A fragment fall on 32
// banks and a frame's run of samples is whole 16-byte copies); nch chunks
// in a ring of nbuf = min(nch, kMmaStages) staging buffers.
// Shared memory: the tap offsets (Tcp ints, padded to 16 bytes, at 0),
// then each buffer of `buf` bytes at boff + b*buf: the chunk's B
// [2][KBc][nt][16] uint2 (bbytes), then its window, two planes of Kr*Lp
// words.
struct MmaChunkGeom {
  int KBc, Tcp, Dc, Kr, Lp, nch, nbuf;
  size_t boff, bbytes, buf;
};

__host__ __device__ inline MmaChunkGeom mma_chunk_geom(int nt, int rows,
                                                       int Tc, int T, int D) {
  MmaChunkGeom g;
  const int kb = (T + 7) / 8;
  g.KBc = Tc >= T ? kb : Tc / 8;
  g.Tcp = 8 * g.KBc;
  g.Dc = chunk_phases(g.Tcp, D);
  g.Kr = rows + (g.Tcp - 1) / D;
  g.Lp = g.Dc + (12 - g.Dc % 8) % 8;
  g.nch = (kb + g.KBc - 1) / g.KBc;
  g.nbuf = g.nch < kMmaStages ? g.nch : kMmaStages;
  g.boff = ((size_t)g.Tcp * sizeof(int) + 15) / 16 * 16;
  g.bbytes = 2 * (size_t)g.KBc * nt * 16 * sizeof(uint2);
  g.buf = g.bbytes + 2 * (size_t)g.Kr * g.Lp * sizeof(uint32_t);
  return g;
}

// toeplitz_front_mma_chunked's dynamic shared memory: the offsets and the
// staging buffers (mma_chunk_geom); the rows x (8*nt + 1) output tile
// reuses the space after the product.
__host__ __device__ inline size_t mma_chunked_smem_bytes(int nt, int rows,
                                                         int Tc, int T,
                                                         int D) {
  const MmaChunkGeom g = mma_chunk_geom(nt, rows, Tc, T, D);
  const size_t all = g.boff + g.nbuf * g.buf;
  const size_t out = (size_t)rows * (8 * nt + 1) * sizeof(float);
  return all > out ? all : out;
}

// pfb_front's A tile of `lanes` lanes, [lanes][2][kTile] floats.
__host__ __device__ inline size_t pfb_a_bytes(int lanes) {
  return (size_t)lanes * 2 * kTile * sizeof(float);
}

// The PFB fronts' output tile, kTile x (8*kPfbNT + 1) floats.
__host__ __device__ inline size_t pfb_out_bytes() {
  return (size_t)kTile * (8 * kPfbNT + 1) * sizeof(float);
}

// pfb_front's dynamic shared memory: the bank rows [K][kPfbCh] as float2
// in lane order (pfb_f32_tables), two A tiles of kPfbFoldLanes lanes, the
// taps (Q, K) padded to 16 bytes, then one or two (D > kPhaseChunk) window
// buffers of Dc phases x Kr = kTile + Q*P - 1 frames a plane; the output
// tile reuses the space after the product.
__host__ __device__ inline size_t pfb_smem_bytes(int K, int Q, int D) {
  const size_t dc = D < kPhaseChunk ? D : kPhaseChunk;
  const size_t kr = kTile + (size_t)Q * (K / D) - 1;
  const size_t nbuf = D > kPhaseChunk ? 2 : 1;
  const size_t all = (size_t)K * kPfbCh * sizeof(float2) +
                     2 * pfb_a_bytes(kPfbFoldLanes) +
                     ((size_t)Q * K * sizeof(float) + 15) / 16 * 16 +
                     nbuf * 2 * dc * kr * sizeof(float);
  return all > pfb_out_bytes() ? all : pfb_out_bytes();
}

// The tensor-core PFB front's geometry for (K, Q, D), D | K. Lanes run in
// phase-major order kappa = p*P + s (lane v = p + s*D, P = K/D), so that
// the lanes of nch chunks of Dc phases each read only their own phases of
// the window; each chunk's Dc*P lanes are padded to KB0 blocks of 8 (the
// last chunk's to its own count), KBg blocks in all. A chunk's window is
// two planes of Kr frames, frame k holding samples g0 + k*D + p0 + pl of
// its phases pl in Ls = 4 mod 8 words (4 samples of a plane are one
// 16-byte copy, and the 8 frames x 4 phases an A fragment reads fall on
// 32 different banks); nbuf window buffers, two when there is a next
// chunk to stage.
struct PfbMmaGeom {
  int P, Dc, nch, KB0, KBg, Kr, Ls, nbuf;
};

__host__ __device__ inline PfbMmaGeom pfb_mma_geom(int K, int Q, int D) {
  PfbMmaGeom g;
  g.P = K / D;
  g.Dc = D < kPhaseChunk ? D : kPhaseChunk;
  g.nch = (D + g.Dc - 1) / g.Dc;
  g.KB0 = (g.Dc * g.P + 7) / 8;
  g.KBg = (g.nch - 1) * g.KB0 + ((D - (g.nch - 1) * g.Dc) * g.P + 7) / 8;
  g.Kr = kTile + Q * g.P - 1;
  g.Ls = (g.Dc + 3) / 4 * 4;
  if (g.Ls % 8 == 0) g.Ls += 4;
  g.nbuf = g.nch > 1 ? 2 : 1;
  return g;
}

// pfb_front_mma's dynamic shared memory: B's hi and lo parts in lane
// order, the taps (Q, K) padded to 16 bytes, then the window buffers,
// whose space the kTile x (8*kNT + 1) output tile reuses after the product.
__host__ __device__ inline size_t pfb_mma_taps_bytes(int K, int Q) {
  return ((size_t)Q * K * sizeof(float) + 15) / 16 * 16;
}

__host__ __device__ inline size_t pfb_mma_smem_bytes(int nt, int K, int Q,
                                                     int D) {
  const PfbMmaGeom g = pfb_mma_geom(K, Q, D);
  const size_t b = 2 * (size_t)g.KBg * nt * 16 * sizeof(uint2);
  const size_t win = (size_t)g.nbuf * 2 * g.Kr * g.Ls * sizeof(float);
  const size_t out = (size_t)kTile * (8 * nt + 1) * sizeof(float);
  return b + pfb_mma_taps_bytes(K, Q) + (win > out ? win : out);
}

// The PFB fronts in chunks (pfb_front_chunked, pfb_front_mma_chunked), for
// a grid whose bank, taps or window outgrow one block. The lanes keep the
// one-chunk order: groups of Dc = min(D, kPhaseChunk) phases, a group's
// lanes kappa = p*P + s in 8-lane blocks (padded per group, as
// pfb_mma_geom pads them); a chunk is up to `lanes`/8 consecutive blocks
// of one group, and a block stages only its chunk's B rows or bank rows,
// tap columns and window phases. Its fold taps u run in u-ranges of `uc`
// taps each, one window of frames [u0*P + s_lo, (u1-1)*P + s_hi + kTile)
// a range, s_lo..s_hi the chunk's lanes' s; where there is more than one
// range, every fold partial waits in the chunk's A tile between ranges
// (at the bf16 grades as float32 in the words of its fragments), summed
// in ascending u as one pass sums it.
// A plan (lanes >= K, uc >= Q) is the one-chunk kernel (pfb_front,
// pfb_front_mma): the chunked kernel is another instantiation
// (use_chunked_pfb). Chunk boundaries always fall on the one-chunk
// kernel's 8-lane blocks, so a chunked launch equals the one-chunk launch
// bit for bit at every grade.
__host__ __device__ inline bool use_chunked_pfb(int lanes, int uc, int K,
                                                int Q) {
  return lanes < K || uc < Q;
}

// A plan a launch may take: the one-chunk plan, or chunks of a positive
// multiple of 8 lanes (or the whole group, lanes >= K) and uc >= 1.
__host__ __device__ inline bool valid_pfb_plan(int lanes, int uc, int K,
                                               int Q) {
  return uc >= 1 && (lanes >= K || (lanes >= 8 && lanes % 8 == 0));
}

// Blocks of 8 lanes a chunk takes: lanes/8, at most a group's KB0.
__host__ __device__ inline int pfb_chunk_blocks(int K, int D, int lanes) {
  const int dc = D < kPhaseChunk ? D : kPhaseChunk;
  const int kb0 = (dc * (K / D) + 7) / 8, nkb = (lanes + 7) / 8;
  return nkb < kb0 ? nkb : kb0;
}

// The most frames a chunk of nkb blocks stages for a u-range of uc taps
// and a block of `rows` output rows: (uc - 1)*P + the span of its lanes'
// s + rows. A chunk may take the last lanes of one phase and the first of
// the next (span P - 1) unless the group is one phase (D = 1), whose
// chunks span 8*nkb - 1 at most.
__host__ __device__ inline int pfb_chunk_frames(int K, int D, int nkb,
                                                int uc, int rows) {
  const int P = K / D;
  const int span = D == 1 && 8 * nkb < P ? 8 * nkb - 1 : P - 1;
  return (uc - 1) * P + span + rows;
}

// Lanes of a chunk of pfb_front_chunked: 8*nkb, at most a group's.
__host__ __device__ inline int pfb_chunk_lanes(int K, int D, int lanes) {
  const int dc = D < kPhaseChunk ? D : kPhaseChunk;
  const int l = 8 * pfb_chunk_blocks(K, D, lanes);
  return l < dc * (K / D) ? l : dc * (K / D);
}

// The most phases a chunk of L consecutive lanes kappa = pl*P + s touches:
// ceil((L - 1)/P) + 1, at most a group's.
__host__ __device__ inline int pfb_chunk_phases(int K, int D, int L) {
  const int dc = D < kPhaseChunk ? D : kPhaseChunk, P = K / D;
  const int n = (L + P - 2) / P + 1;
  return n < dc ? n : dc;
}

// Floats of one staging buffer of pfb_front_chunked: a u-range's taps
// [uc][L] padded to 4, then its window, two planes of at most
// pfb_chunk_phases x pfb_chunk_frames.
__host__ __device__ inline size_t pfb_chunk_stage_floats(int K, int Q, int D,
                                                         int lanes, int uc) {
  const int L = pfb_chunk_lanes(K, D, lanes);
  if (uc > Q) uc = Q;
  return ((size_t)uc * L + 3) / 4 * 4 +
         2 * (size_t)pfb_chunk_phases(K, D, L) *
             pfb_chunk_frames(K, D, pfb_chunk_blocks(K, D, lanes), uc,
                              kTile);
}

// pfb_front_chunked's dynamic shared memory: two buffers of a chunk's bank
// rows [L][kPfbCh] as float2 (L = its lanes, at most a group's), two A
// tiles of L lanes, then two staging buffers (pfb_chunk_stage_floats); the
// output tile reuses the space after the product.
__host__ __device__ inline size_t pfb_chunk_bytes(int K, int Q, int D,
                                                  int lanes, int uc) {
  const size_t L = pfb_chunk_lanes(K, D, lanes);
  const size_t all = 2 * L * kPfbCh * sizeof(float2) +
                     2 * pfb_a_bytes((int)L) +
                     2 * pfb_chunk_stage_floats(K, Q, D, lanes, uc) *
                         sizeof(float);
  return all > pfb_out_bytes() ? all : pfb_out_bytes();
}

// Frames a phase pair of pfb_front_mma_chunked's window holds for nfr
// frames (two words a frame, the pair's phases side by side): nfr padded
// to 8 mod 16, so that two neighbouring pairs are 16 mod 32 words apart
// and a fold load whose lanes span them falls on different banks.
__host__ __device__ inline int pfb_mma_pair_stride(int nfr) {
  return nfr + (24 - nfr % 16) % 16;
}

// pfb_front_mma_chunked's geometry for the plan (lanes, uc), nt n-tiles
// and `rows` output rows: chunks of nkb 8-lane blocks (L lanes at most) and
// u-ranges of uc fold taps; per block of 8 lanes, its A tile of
// pfb_a_block_words(rows) words; a
// staging buffer holds a u-range's taps [uc][8*nkb] and its window, two
// planes of at most np2 = ceil(npc/2) phase pairs of 2*Lf words (Lf the
// pair stride of the most frames a u-range stages). Bytes of one A tile,
// one B buffer [2][nkb][nt][32] uint2 (a fragment a lane) and one staging
// buffer; the block holds two of each.
struct PfbMmaChunkGeom {
  int nkb, L, uc, npc, Lf;
  size_t abytes, bbytes, sbytes;
};

__host__ __device__ inline PfbMmaChunkGeom pfb_mma_chunk_geom(
    int nt, int K, int Q, int D, int lanes, int uc, int rows) {
  PfbMmaChunkGeom g;
  g.nkb = pfb_chunk_blocks(K, D, lanes);
  g.L = pfb_chunk_lanes(K, D, lanes);
  g.uc = uc < Q ? uc : Q;
  g.npc = pfb_chunk_phases(K, D, g.L);
  g.Lf = pfb_mma_pair_stride(pfb_chunk_frames(K, D, g.nkb, g.uc, rows));
  g.abytes = (size_t)g.nkb * pfb_a_block_words(rows) * sizeof(uint32_t);
  g.bbytes = 2 * (size_t)g.nkb * nt * 32 * sizeof(uint2);
  g.sbytes = ((size_t)g.uc * 8 * g.nkb +
              4 * (size_t)((g.npc + 1) / 2) * g.Lf) * sizeof(float);
  return g;
}

// pfb_front_mma_chunked's dynamic shared memory for a block of `rows`
// output rows: two A tiles, two B buffers and two staging buffers
// (pfb_mma_chunk_geom); the rows x (8*nt + 1) output tile reuses the space
// after the product.
__host__ __device__ inline size_t pfb_mma_chunk_bytes(int nt, int K, int Q,
                                                      int D, int lanes,
                                                      int uc, int rows) {
  const PfbMmaChunkGeom g = pfb_mma_chunk_geom(nt, K, Q, D, lanes, uc, rows);
  const size_t all = 2 * (g.abytes + g.bbytes + g.sbytes);
  const size_t out = (size_t)rows * (8 * nt + 1) * sizeof(float);
  return all > out ? all : out;
}

// Channels and threads per block of a tile kernel: the PFB fronts cover
// kPfbCh channels with one fold, and their block has two threads per
// output row, so that its back end takes the two groups of kCG channels
// side by side; the bf16 dense fronts kCG channels, one thread a row (the
// chunked one: mma_chunk_block; the f32 dense front: dense_f32_channels,
// back_threads).
template <bool kPfb>
__host__ __device__ constexpr int block_channels() {
  return kPfb ? kPfbCh : kCG;
}

template <bool kPfb>
__host__ __device__ constexpr int block_threads() {
  return kPfb ? kPfbThreads : kTile;
}

// The channels a thread of a back end that takes one output row a thread
// (the FM chain's) holds for ch channels a block: kCG, or all of an
// 8-channel block; and that block's threads, one a row and group.
__host__ __device__ constexpr int back_channels(int ch) {
  return ch < kCG ? ch : kCG;
}

__host__ __device__ constexpr int back_threads(int ch) {
  return kTile * (ch / back_channels(ch));
}

// Sets *room to the dynamic shared memory a block of `kernel` may take on
// the current device: the per-block opt-in limit less the kernel's static
// shared memory (0 when that alone exceeds it). Returns 0 or the CUDA
// error.
inline cudaError_t block_room(const void* kernel, size_t* room) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    *room = attr.sharedSizeBytes < (size_t)optin
                ? (size_t)optin - attr.sharedSizeBytes
                : 0;
  return err;
}

// Sets *fits to 1 when a block of `kernel` with `dynamic` bytes of dynamic
// shared memory fits the current device (block_room), else 0. Returns 0 or
// the CUDA error. The libraries answer <library>_fits with it for the PFB
// front, the check the Python side makes before a launch.
inline cudaError_t block_fits(const void* kernel, size_t dynamic, int* fits) {
  size_t room = 0;
  const cudaError_t err = block_room(kernel, &room);
  if (err == cudaSuccess) *fits = dynamic <= room ? 1 : 0;
  return err;
}

// Sets *room to the dynamic shared memory a block of `kernel` may take so
// that two of its blocks share a SM on the current device: half the SM's
// shared memory less a block's reservation and the kernel's static shared
// memory (0 where that leaves nothing). Returns 0 or the CUDA error.
inline cudaError_t pair_room(const void* kernel, size_t* room) {
  int dev = 0, per_sm = 0, reserved = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    const size_t used = (size_t)reserved + attr.sharedSizeBytes;
    *room = (size_t)per_sm / 2 > used ? (size_t)per_sm / 2 - used : 0;
  }
  return err;
}

// Streaming multiprocessors of the current device, 0 where it cannot be
// read.
inline int device_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

// The block of the bf16 chunked kernels: the dense front's
// (toeplitz_front_mma_chunked), `ch` channels (4, 8, 16 or 32: 4*kNT), or
// the PFB front's (pfb_front_mma_chunked), kPfbCh; and `rows` output rows
// (kTile, or 128 or 64 where the launcher takes them).
struct MmaBlock {
  int ch, rows;
};

constexpr int kMmaMinRows = 64;   // the fewest rows of a chunked bf16 block

// The chunked bf16 block for C channels and M outputs on the current
// device: the fewest channels of min_ch, 2*min_ch, ... up to max_ch (4, 8,
// 16, 32 for the dense front; the PFB front's kPfbCh alone, min_ch =
// max_ch) that hold C, so that no block multiplies more than 3 zero
// channels (am_d128's 8 took a block of 16 before), and kTile rows; then,
// while the grid with half the rows (down to min_rows) still fits one wave
// of the card's SMs, half the rows, and after that, while it does with half
// the channels (down to min_ch), half the channels. A block of rows r makes
// ceil(M / (r - overlap)) row tiles (the FM chain's tiles overlap by one
// output). Each n-tile's and each row's sums are independent of the
// others, so the outputs do not depend on the block. M < 1: any M, the
// widest block (the most shared memory).
inline MmaBlock mma_chunk_block(int C, int M, int max_ch, int min_rows,
                                int overlap, int min_ch = 4) {
  MmaBlock b{min_ch, kTile};
  while (b.ch < C && b.ch < max_ch) b.ch *= 2;
  const int sms = M >= 1 ? device_sms() : 0;
  if (sms < 1) return b;
  auto blocks = [&](int ch, int rows) {
    const long out = rows - overlap;
    return (M + out - 1) / out * ((C + ch - 1) / ch);
  };
  while (b.rows > min_rows && blocks(b.ch, b.rows / 2) <= sms) b.rows /= 2;
  while (b.ch > min_ch && blocks(b.ch / 2, b.rows) <= sms) b.ch /= 2;
  return b;
}

// The rows of the chunked bf16 PFB front's block (pfb_front_mma_chunked)
// for C channels and M outputs on the current device: mma_chunk_block's
// rule with the channels held at kPfbCh, so 256 rows, or 128 or 64 where
// the grid of ceil(M / (rows - overlap)) row tiles x ceil(C / kPfbCh)
// channel groups at half the rows still fits one wave (a 20-ms block of
// the land-mobile NFM raster: 128 rows, 80 blocks on 132 SMs, where 256
// rows took 40). Every row's fold and every column's sum run over the
// same lanes in the same order whatever the rows, so the front's outputs
// do not depend on them. C < 1 or M < 1: any C or M, kTile.
inline int pfb_mma_rows(int C, int M, int overlap) {
  return C < 1 ? kTile
               : mma_chunk_block(C, M, kPfbCh, kMmaMinRows, overlap, kPfbCh)
                     .rows;
}

// The rows a chunked bf16 PFB block may take, the choices of pfb_mma_rows
// (and kernels/chain.py's PFB_ROWS): f(std::integral_constant<int, r>{})
// for rows r of kTile, kTile / 2 or kMmaMinRows, anything else kTile, one
// instantiation each.
template <class F>
auto with_pfb_rows(int rows, const F& f) {
  if (rows == kMmaMinRows)
    return f(std::integral_constant<int, kMmaMinRows>{});
  if (rows == kTile / 2) return f(std::integral_constant<int, kTile / 2>{});
  return f(std::integral_constant<int, kTile>{});
}

// A row count a chunked bf16 PFB launch may take: one of with_pfb_rows'.
inline bool valid_pfb_rows(int rows) {
  return with_pfb_rows(rows, [](auto r) { return decltype(r)::value; }) ==
         rows;
}

// f(grade, chunked, rows), each a std::integral_constant, for the PFB tile
// kernel of a launch at `grade` (f32, bf16x2 or bf16x3) whose plan runs
// the chunked kernel or not (use_chunked_pfb), in blocks of `rows` rows:
// the chunked kernel at the bf16 grades with_pfb_rows', every other
// kTile; where kCounted, the counted kernel's (the chunked one at bf16x3,
// which the caller checks). The launchers' one path into their PFB tile
// kernels.
template <bool kCounted = false, class F>
auto with_pfb_tile(int grade, bool chunked, int rows, const F& f) {
  using X3 = std::integral_constant<int, kGradeBf16x3>;
  using X2 = std::integral_constant<int, kGradeBf16x2>;
  using F32 = std::integral_constant<int, kGradeF32>;
  using Tile = std::integral_constant<int, kTile>;
  if constexpr (kCounted) {
    return with_pfb_rows(
        rows, [&](auto r) { return f(X3{}, std::true_type{}, r); });
  } else {
    if (grade == kGradeF32)
      return chunked ? f(F32{}, std::true_type{}, Tile{})
                     : f(F32{}, std::false_type{}, Tile{});
    if (!chunked)
      return grade == kGradeBf16x2 ? f(X2{}, std::false_type{}, Tile{})
                                   : f(X3{}, std::false_type{}, Tile{});
    return with_pfb_rows(rows, [&](auto r) {
      return grade == kGradeBf16x2 ? f(X2{}, std::true_type{}, r)
                                   : f(X3{}, std::true_type{}, r);
    });
  }
}

// f.template run<kCh, kRows>() for the block b of a launcher whose blocks
// take at most kMaxCh channels and at least kMinRows rows (one
// instantiation each).
template <int kMaxCh, int kRows, class F>
auto with_mma_channels(int ch, const F& f) {
  if constexpr (kMaxCh >= 32) {
    if (ch == 32) return f.template run<32, kRows>();
  }
  if (ch == 4) return f.template run<4, kRows>();
  if (ch == 8) return f.template run<8, kRows>();
  return f.template run<16, kRows>();
}

template <int kMaxCh, int kMinRows, class F>
auto with_mma_block(const MmaBlock& b, const F& f) {
  if constexpr (kMinRows <= 64) {
    if (b.rows == 64) return with_mma_channels<kMaxCh, 64>(b.ch, f);
  }
  if constexpr (kMinRows <= 128) {
    if (b.rows == 128) return with_mma_channels<kMaxCh, 128>(b.ch, f);
  }
  return with_mma_channels<kMaxCh, kTile>(b.ch, f);
}

// The dense fronts' chunk plan: sets *chunk to the taps a block stages at
// once on the current device, T where the whole bank and window fit a
// block, else the largest multiple of 8 below T that fits, or 0 where not
// even 8 taps do; a block of either kernel of the front, `one` (one
// chunk) and `chunked`, whose static shared memory may differ. bytes(Tc)
// is the block's dynamic shared memory for a chunk of Tc taps,
// non-decreasing in Tc below T. Where pair_span > 0 (pair_span = D: every
// chunked kernel stages the next chunk while it multiplies one), a
// chunk below T is the largest whose block lets two blocks share a SM
// (pair_room) where that chunk spans pair_span taps or more, so that a
// chunk stages one window of all D phases; else, where two blocks would
// take chunks shorter than D, each restaging its phases' window (the
// transmux at Q=127 on the H100: 1267 us in chunks of 24 of D=32 taps
// against 869 in the one-block chunks of 192, at f32), the largest that
// fits. Returns 0 or the CUDA error. The libraries answer <library>_fits
// with it for the dense front.
template <class Bytes>
cudaError_t dense_chunk(const void* one, const void* chunked, int T,
                        Bytes bytes, int* chunk, int pair_span = 0) {
  size_t room = 0, room_chunked = 0, room_pair = 0;
  cudaError_t err = block_room(one, &room);
  if (err == cudaSuccess) err = block_room(chunked, &room_chunked);
  if (err == cudaSuccess && pair_span > 0)
    err = pair_room(chunked, &room_pair);
  if (err != cudaSuccess) return err;
  if (room_chunked < room) room = room_chunked;
  if (bytes(T) <= room) {
    *chunk = T;
    return cudaSuccess;
  }
  // the largest chunk of 8*m taps, 1 <= m < T/8, whose block takes at
  // most `lim` bytes; 0 where none does
  auto largest = [&](size_t lim) {
    int lo = 0, hi = (T - 1) / 8;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (bytes(8 * mid) <= lim) lo = mid;
      else hi = mid - 1;
    }
    return 8 * lo;
  };
  *chunk = pair_span > 0 ? largest(room_pair < room ? room_pair : room) : 0;
  if (*chunk < pair_span || *chunk == 0) *chunk = largest(room);
  return cudaSuccess;
}

// The PFB fronts' chunk plan: sets plan[0..1] to (lanes, uc), the lanes a
// chunk takes and the fold taps a u-range takes, on the current device:
// (K, Q), one chunk, where the one-chunk kernel's block fits (`one`, whose
// dynamic shared memory is one_bytes); else the plan of the chunked
// kernel (`chunked`, bytes(lanes, uc) dynamic bytes) that stages the
// fewest windows: for each chunk of 8*nkb lanes (nkb up to a group's) the
// most taps a u-range can take (all Q where the block fits), the plan with
// the fewest chunks x u-ranges, the larger chunk on a tie; but for a
// chunked block of fewer than kTile rows (`rows`), on a tie the one with
// the most taps a u-range (the sliding fold takes all Q at once), then
// the smallest chunk (the most even chunks: the 128-row block of the NFM
// and airband grids takes chunks of 4 and 4 blocks, where 7 and 1 also
// fit; its warps split a chunk's blocks between them). (0, 0) where
// nothing fits, which does not happen for P = K/D up to a few hundred.
// Returns 0 or the CUDA error. The libraries answer <library>_fits with it
// for the PFB front.
template <class Bytes>
cudaError_t pfb_chunk(const void* one, size_t one_bytes, const void* chunked,
                      int K, int Q, int D, Bytes bytes, int* plan,
                      int rows = kTile) {
  size_t room = 0;
  cudaError_t err = block_room(one, &room);
  if (err != cudaSuccess) return err;
  plan[0] = plan[1] = 0;
  if (one_bytes <= room) {
    plan[0] = K;
    plan[1] = Q;
    return cudaSuccess;
  }
  if ((err = block_room(chunked, &room)) != cudaSuccess) return err;
  const int P = K / D, dc = D < kPhaseChunk ? D : kPhaseChunk;
  long best = -1;
  for (int nkb = pfb_chunk_blocks(K, D, K); nkb >= 1; --nkb) {
    int uc = Q;
    if (bytes(8 * nkb, Q) > room) {
      int lo = 0, hi = Q - 1;   // the most taps below Q whose block fits
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (bytes(8 * nkb, mid) <= room) lo = mid;
        else hi = mid - 1;
      }
      if (lo == 0) continue;
      uc = lo;
    }
    if (!use_chunked_pfb(8 * nkb, uc, K, Q)) continue;   // the one chunk
    long chunks = 0;   // chunks a block walks, over every group
    for (int p0 = 0; p0 < D; p0 += dc) {
      const int np = D - p0 < dc ? D - p0 : dc;
      chunks += ((np * P + 7) / 8 + nkb - 1) / nkb;
    }
    const long cost = chunks * ((Q + uc - 1) / uc);
    if (best < 0 || cost < best ||
        (rows < kTile && cost == best && uc >= plan[1])) {
      best = cost;
      plan[0] = 8 * nkb;
      plan[1] = uc;
    }
  }
  return cudaSuccess;
}

// A chunk of Tc taps a launch may take for a bank of T taps: T or more (one
// chunk), or a positive multiple of 8 (one tensor-core block of taps).
__host__ __device__ inline bool valid_chunk(int Tc, int T) {
  return Tc >= T || (Tc >= 8 && Tc % 8 == 0);
}

// Whether a launch of Tc <= T taps at D runs the dense front's chunked
// kernel: for chunks, and for a bank shorter than D, whose window the
// one-chunk kernel would stage at all D phases.
__host__ __device__ inline bool use_chunked_kernel(int Tc, int T, int D) {
  return Tc < T || T < D;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b on the tensor cores: one m16n8k16 bf16 product, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 4-byte asynchronous copy from global to shared memory, zero-filled
// when `valid` is false (src-size 0: nothing is read from src).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One 8-byte asynchronous copy from global to shared memory; both
// addresses 8-byte aligned.
__device__ __forceinline__ void cp_async_8(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// One 16-byte asynchronous copy from global to shared memory; both
// addresses 16-byte aligned.
__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Starts the copies of one chunk of toeplitz_front_mma_chunked into a
// staging buffer of geometry g (mma_chunk_geom), by the block's nth
// threads: B's blocks kb0..kb0+nkb-1 of 8 taps for the group's kNT
// n-tiles, 16-byte copies of the table's contiguous (part, kb) rows into
// bs [2][KBc][kNT][16] (an n-tile past NT as zeros); and the raw window,
// re of sample g0 + 8*kb0 + k*D + p (p < Dc, k < Kr) into word k*Lp + p of
// plane 0 and im into plane 1, samples outside [0, nb) zero-filled:
// neighbouring threads copy neighbouring samples of a frame's run, four a
// 16-byte copy where the runs start 16-byte aligned (vec), else one.
template <int kNT>
__device__ __forceinline__ void mma_chunk_stage(
    unsigned char* buf, const MmaChunkGeom& g,
    const float* __restrict__ buf_re, const float* __restrict__ buf_im,
    int nb, const uint2* __restrict__ btab, int KB, int NT, int D,
    int group, long g0, int kb0, int nkb, int nth, bool vec) {
  const int tid = threadIdx.x;
  uint2* bs = reinterpret_cast<uint2*>(buf);
  constexpr int kPer = kNT * 8;   // 16-byte copies of a (part, kb) row
  const int nkp = nkb * kPer;
  for (int i = tid; i < 2 * nkp; i += nth) {
    const int part = i / nkp, r = i - part * nkp;
    const int kb = r / kPer, e = r - kb * kPer;
    float* dst = reinterpret_cast<float*>(
        bs + ((size_t)(part * g.KBc + kb) * kNT) * 16 + 2 * e);
    if (group * kNT + e / 8 < NT)
      cp_async_16(dst, reinterpret_cast<const float*>(
                           btab + ((long)(part * KB + kb0 + kb) * NT +
                                   group * kNT) * 16 + 2 * e));
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float* w0 = reinterpret_cast<float*>(buf + g.bbytes);
  float* w1 = w0 + (size_t)g.Kr * g.Lp;
  const long gc = g0 + 8L * kb0;
  const int w = vec ? 4 : 1;           // samples a copy
  const int nq = g.Dc / w;             // copies a frame
  for (int i = tid; i < g.Kr * nq; i += nth) {
    const int k = i / nq, p = (i - k * nq) * w;
    const long s = gc + (long)k * D + p;
    float* d0 = w0 + k * g.Lp + p;
    float* d1 = w1 + k * g.Lp + p;
    if (vec && s >= 0 && s + 4 <= nb) {
      cp_async_16(d0, buf_re + s);
      cp_async_16(d1, buf_im + s);
    } else {
      for (int j = 0; j < w; ++j) {
        const bool in = s + j >= 0 && s + j < nb;
        cp_async_f32(d0 + j, buf_re + (in ? s + j : 0), in);
        cp_async_f32(d1 + j, buf_im + (in ? s + j : 0), in);
      }
    }
  }
}

// Splits a staged raw window in place, by the block's nth threads: each
// (re, im) of planes 0 and 1 (`words` words a plane, a multiple of 4)
// becomes the bf16 pair hi = bf16(x) in plane 0 and, at bf16x3, lo =
// bf16(x - hi) in plane 1, as JAX's (w - wh.astype(f32)).astype(bf16).
template <int kGrade>
__device__ __forceinline__ void mma_chunk_split(float* w0, int words,
                                                int nth) {
  float4* p0 = reinterpret_cast<float4*>(w0);
  float4* p1 = reinterpret_cast<float4*>(w0 + words);
  for (int i = threadIdx.x; i < words / 4; i += nth) {
    const float4 re = p0[i], im = p1[i];
    const float xr[4] = {re.x, re.y, re.z, re.w};
    const float xi[4] = {im.x, im.y, im.z, im.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(xr[j], xi[j]);
      hi[j] = bf16x2_bits(h);
      lo[j] = bf16x2_bits(__floats2bfloat162_rn(xr[j] - __low2float(h),
                                                xi[j] - __high2float(h)));
    }
    reinterpret_cast<uint4*>(p0)[i] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    if constexpr (kGrade == kGradeBf16x3)
      reinterpret_cast<uint4*>(p1)[i] =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// d += the products of one staged and split chunk of nkb blocks of 8 taps
// (mma_chunk_stage, mma_chunk_split), in ascending kb: warp rows r0 and
// r0 + 16, lane (gid, tig); A of row r and tap tl at word off[tl] + r*Lp of
// the hi plane (lo `plane` words on). Each accumulator takes, for each
// block of 8 taps, Ah*Bh, then Ah*Bl, then (bf16x3) Al*Bh, as
// toeplitz_front_mma's; the passes run over all the warp's accumulators in
// turn, so that no mma waits on the one before it. The loop is unrolled by
// 2 but in blocks of 16 channels (H100, tools/dense_variants.py: Q=127's
// 32 channels 5% and am_d128's 8 9% faster unrolled, the long filter's 16
// 2% slower, and blocks of 16 channels and fewer rows spilled).
template <int kGrade, int kNT>
__device__ __forceinline__ void mma_product(
    float (&d)[2][kNT][4], const uint2* bs, const uint32_t* win,
    const int* off, int nkb, int KBc, int plane, int Lp, int r0, int gid,
    int tig) {
  // an odd GEMM column (gi, gr) from its even neighbour (gr, -gi)
  const uint32_t sel = (gid & 1) ? 0x1032u : 0x3210u;
  const uint32_t flip = (gid & 1) ? 0x8000u : 0u;
  const uint2* bl = bs + 4 * (gid >> 1) + tig;
  const uint32_t* wl = win + plane;   // the lo part at bf16x3
  const int rr = r0 * Lp, r8 = 8 * Lp;
  constexpr int kUnroll = kNT == 4 ? 1 : 2;
#pragma unroll(kUnroll)
  for (int kb = 0; kb < nkb; ++kb) {
    const int o0 = off[8 * kb + tig] + rr, o1 = off[8 * kb + tig + 4] + rr;
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m = 2 * mt * r8;
      ah[mt][0] = win[o0 + m];
      ah[mt][1] = win[o0 + m + r8];
      ah[mt][2] = win[o1 + m];
      ah[mt][3] = win[o1 + m + r8];
      if constexpr (kGrade == kGradeBf16x3) {
        al[mt][0] = wl[o0 + m];
        al[mt][1] = wl[o0 + m + r8];
        al[mt][2] = wl[o1 + m];
        al[mt][3] = wl[o1 + m + r8];
      }
    }
    uint32_t bh[kNT][2], blo[kNT][2];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const uint2 h = bl[(kb * kNT + nt) * 16];
      const uint2 l = bl[((KBc + kb) * kNT + nt) * 16];
      bh[nt][0] = __byte_perm(h.x, 0u, sel) ^ flip;
      bh[nt][1] = __byte_perm(h.y, 0u, sel) ^ flip;
      blo[nt][0] = __byte_perm(l.x, 0u, sel) ^ flip;
      blo[nt][1] = __byte_perm(l.y, 0u, sel) ^ flip;
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma_bf16(d[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma_bf16(d[mt][nt], ah[mt], blo[nt][0], blo[nt][1]);
    if constexpr (kGrade == kGradeBf16x3) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_bf16(d[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
    }
  }
}

// Tensor-core dense front, grade kGrade (kGradeBf16x3 or kGradeBf16x2),
// for the 4*kNT channels of channel group `group`: the same contract as
// toeplitz_front, y[c, j] of the block's kTile outputs, window of output
// row r starting at g0 + r*D, into acc_re / acc_im[4*kNT].
//
// btab: dense_mma_tables' int32 (2, KB, NT, 16, 2) B operand, KB =
// ceil(T/8) blocks of 8 taps, NT = ceil(C/4) tiles of 4 channels; entry
// [part][kb][nt][4*cl + q][i] is the bf16 (gr, -gi) pair of channel
// 4*nt + cl at tap 8*kb + q + 4*i, plane 0 in the low half, part 0 hi and
// 1 lo, zero past T and C. One m16n8k16 B fragment of an n-tile (8 GEMM
// columns, 4 channels) for lane (gid, tig) is entry 4*(gid/2) + tig, the
// odd gid taking the odd column.
//
// Shared memory: B for the group [2][KB][kNT][16] uint2, the offsets of
// the taps in the window, off[t] = (t % D)*Ks + t/D, then the window
// [parts][D][Ks] of (re, im) bf16 pairs, word (t % D)*Ks + r + t/D for
// output row r and tap t. Eight warps each take 32 rows (two m-tiles)
// against all kNT n-tiles.
template <int kGrade, int kNT>
__device__ __forceinline__ void toeplitz_front_mma(
    unsigned char* smem, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb,
    const uint2* __restrict__ btab, int C, int T, int D, int group, long g0,
    float (&acc_re)[4 * kNT], float (&acc_im)[4 * kNT]) {
  static_assert(kGrade == kGradeBf16x3 || kGrade == kGradeBf16x2,
                "tensor-core grades are bf16x3 and bf16x2");
  constexpr int kOS = 8 * kNT + 1;   // output tile row stride, in floats
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int KB = (T + 7) / 8, Tp = 8 * KB, NT = (C + 3) / 4;
  const int Ks = mma_phase_stride(Tp, D);
  uint2* bs = reinterpret_cast<uint2*>(smem);
  int* off = reinterpret_cast<int*>(bs + 2 * KB * kNT * 16);
  uint32_t* win = reinterpret_cast<uint32_t*>(off + Tp);
  float* out = reinterpret_cast<float*>(win);

  const int nbs = KB * kNT * 16;   // uint2 per part in shared memory
  for (int i = tid; i < 2 * nbs; i += kTile) {
    const int part = i / nbs, kb = (i % nbs) / (kNT * 16);
    const int nt = (i / 16) % kNT, e = i % 16;
    const int ntg = group * kNT + nt;
    bs[i] = ntg < NT ? btab[((long)(part * KB + kb) * NT + ntg) * 16 + e]
                     : make_uint2(0u, 0u);
  }
  for (int t = tid; t < Tp; t += kTile) off[t] = (t % D) * Ks + t / D;
  const int Kr = kTile + (Tp - 1) / D;
  for (int l = tid; l < D * Kr; l += kTile) {
    const long g = g0 + l;
    const bool in = g >= 0 && g < nb;
    const float xr = in ? buf_re[g] : 0.f, xi = in ? buf_im[g] : 0.f;
    const __nv_bfloat162 hi = __floats2bfloat162_rn(xr, xi);
    const int s = (l % D) * Ks + l / D;
    win[s] = bf16x2_bits(hi);
    if constexpr (kGrade == kGradeBf16x3) {
      win[D * Ks + s] = bf16x2_bits(__floats2bfloat162_rn(
          xr - __low2float(hi), xi - __high2float(hi)));
    }
  }
  __syncthreads();

  const int gid = lane >> 2, tig = lane & 3;
  // an odd GEMM column (gi, gr) from its even neighbour (gr, -gi)
  const uint32_t sel = (gid & 1) ? 0x1032u : 0x3210u;
  const uint32_t flip = (gid & 1) ? 0x8000u : 0u;
  const uint2* bl = bs + 4 * (gid >> 1) + tig;
  const int r0 = warp * 32 + gid;
  float d[2][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[mt][nt][i] = 0.f;

  for (int kb = 0; kb < KB; ++kb) {
    const int o0 = off[8 * kb + tig], o1 = off[8 * kb + tig + 4];
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = r0 + 16 * mt;
      ah[mt][0] = win[o0 + r];
      ah[mt][1] = win[o0 + r + 8];
      ah[mt][2] = win[o1 + r];
      ah[mt][3] = win[o1 + r + 8];
      if constexpr (kGrade == kGradeBf16x3) {
        const uint32_t* wl = win + D * Ks;
        al[mt][0] = wl[o0 + r];
        al[mt][1] = wl[o0 + r + 8];
        al[mt][2] = wl[o1 + r];
        al[mt][3] = wl[o1 + r + 8];
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const uint2 h = bl[(kb * kNT + nt) * 16];
      const uint2 l = bl[((KB + kb) * kNT + nt) * 16];
      const uint32_t h0 = __byte_perm(h.x, 0u, sel) ^ flip;
      const uint32_t h1 = __byte_perm(h.y, 0u, sel) ^ flip;
      const uint32_t l0 = __byte_perm(l.x, 0u, sel) ^ flip;
      const uint32_t l1 = __byte_perm(l.y, 0u, sel) ^ flip;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(d[mt][nt], ah[mt], h0, h1);
        mma_bf16(d[mt][nt], ah[mt], l0, l1);
        if constexpr (kGrade == kGradeBf16x3)
          mma_bf16(d[mt][nt], al[mt], h0, h1);
      }
    }
  }
  __syncthreads();   // every warp is done with the window: the tile reuses it

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = r0 + 16 * mt;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = 8 * nt + 2 * tig;
      out[r * kOS + col] = d[mt][nt][0];
      out[r * kOS + col + 1] = d[mt][nt][1];
      out[(r + 8) * kOS + col] = d[mt][nt][2];
      out[(r + 8) * kOS + col + 1] = d[mt][nt][3];
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 4 * kNT; ++c) {
    acc_re[c] = out[tid * kOS + 2 * c];
    acc_im[c] = out[tid * kOS + 2 * c + 1];
  }
}

// toeplitz_front_mma over the taps in chunks of KBc = Tc/8 blocks of 8
// (Tc < T, or T < D: every chunk stages only the min(Tc, D) phases it
// touches), for a block of kRows output rows (kRows/32 warps, each 32 rows
// against all kNT n-tiles; one thread a row reads its 4*kNT channels back)
// and the 4*kNT channels of channel group `group`; the same contract as
// toeplitz_front_mma, and the same sums in the same order: each output's
// accumulators take the same m16n8k16 A and B fragments in ascending
// blocks of 8 taps across chunks, so a chunked launch equals a one-chunk
// launch bit for bit at any block shape.
//
// The design: chunks c + 1 .. c + kMmaStages - 1 are copied
// (cp.async, mma_chunk_stage) into the other buffers of a ring while
// chunk c is split and multiplied; a chunk's window lands raw,
// frame-major, and is split into
// bf16 hi and lo in place (mma_chunk_split) just before its product.
// Shared memory (mma_chunk_geom): off[tl] = (tl / D)*Lp + tl % D for tl <
// Tcp, then the buffers; word off[tl] + r*Lp of a buffer's window is
// sample g0 + 8*kb0 + r*D + tl of output row r and tap 8*kb0 + tl.
template <int kGrade, int kNT, int kRows = kTile>
__device__ __forceinline__ void toeplitz_front_mma_chunked(
    unsigned char* smem, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb,
    const uint2* __restrict__ btab, int C, int T, int Tc, int D, int group,
    long g0, float (&acc_re)[4 * kNT], float (&acc_im)[4 * kNT]) {
  static_assert(kGrade == kGradeBf16x3 || kGrade == kGradeBf16x2,
                "tensor-core grades are bf16x3 and bf16x2");
  static_assert(kRows % 32 == 0 && kRows <= kTile, "whole warps of rows");
  constexpr int kOS = 8 * kNT + 1;   // output tile row stride, in floats
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int KB = (T + 7) / 8, NT = (C + 3) / 4;
  const MmaChunkGeom g = mma_chunk_geom(kNT, kRows, Tc, T, D);
  int* off = reinterpret_cast<int*>(smem);
  unsigned char* bufs = smem + g.boff;
  float* out = reinterpret_cast<float*>(smem);
  for (int t = tid; t < g.Tcp; t += kRows) off[t] = (t / D) * g.Lp + t % D;
  // 16-byte copies where every frame's run starts 16-byte aligned
  const bool vec = D % 4 == 0 && g.Dc % 4 == 0 && g0 % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(buf_re) |
                     reinterpret_cast<uintptr_t>(buf_im)) & 15) == 0;

  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = warp * 32 + gid;
  float d[2][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[mt][nt][i] = 0.f;

  // chunks 0 .. kMmaStages - 2 in flight; a group committed for every
  // chunk slot, empty past the last chunk, so that wait_group counts
  // chunks
#pragma unroll
  for (int c = 0; c < kMmaStages - 1; ++c) {
    const int kb1 = c * g.KBc;
    if (kb1 < KB)
      mma_chunk_stage<kNT>(bufs + c * g.buf, g, buf_re, buf_im, nb, btab, KB,
                           NT, D, group, g0, kb1,
                           KB - kb1 < g.KBc ? KB - kb1 : g.KBc, kRows, vec);
    cp_async_commit();
  }
  for (int c = 0, kb0 = 0; kb0 < KB; ++c, kb0 += g.KBc) {
    const int nkb = KB - kb0 < g.KBc ? KB - kb0 : g.KBc;
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();   // chunk c is in; every warp is done with chunk c - 1
    const int kb1 = kb0 + (kMmaStages - 1) * g.KBc;
    if (kb1 < KB)      // chunk c + kMmaStages - 1, into chunk c - 1's buffer
      mma_chunk_stage<kNT>(bufs + ((c + kMmaStages - 1) % kMmaStages) * g.buf,
                           g, buf_re, buf_im, nb, btab, KB, NT, D, group, g0,
                           kb1, KB - kb1 < g.KBc ? KB - kb1 : g.KBc, kRows,
                           vec);
    cp_async_commit();
    unsigned char* cur = bufs + (c % kMmaStages) * g.buf;
    uint32_t* win = reinterpret_cast<uint32_t*>(cur + g.bbytes);
    mma_chunk_split<kGrade>(reinterpret_cast<float*>(win), g.Kr * g.Lp,
                            kRows);
    __syncthreads();   // chunk c's window is split
    mma_product<kGrade, kNT>(d, reinterpret_cast<const uint2*>(cur), win,
                             off, nkb, g.KBc, g.Kr * g.Lp, g.Lp, r0, gid,
                             tig);
  }
  __syncthreads();   // every warp is done with the buffers: the tile reuses them

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = r0 + 16 * mt;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = 8 * nt + 2 * tig;
      out[r * kOS + col] = d[mt][nt][0];
      out[r * kOS + col + 1] = d[mt][nt][1];
      out[(r + 8) * kOS + col] = d[mt][nt][2];
      out[(r + 8) * kOS + col + 1] = d[mt][nt][3];
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 4 * kNT; ++c) {
    acc_re[c] = out[tid * kOS + 2 * c];
    acc_im[c] = out[tid * kOS + 2 * c + 1];
  }
}

// Starts the copies of phases p0..p0+np-1 of the block's window into the
// planes xr and xi = xr + Kr*Ls: xr[k*Ls + pl] = x_re[g0 + k*D + p0 + pl]
// for k < Kr, samples outside [0, nb) as zeros. Where every frame's run
// of samples starts 16-byte aligned (vec), four samples of a plane are
// one 16-byte copy (the four 4-byte ones at the buffer's ends); else one
// 4-byte copy a sample. Neighbouring threads copy neighbouring samples.
__device__ __forceinline__ void pfb_stage_phases(
    float* xr, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb, long g0, int D, int p0, int np,
    int Kr, int Ls, bool vec) {
  float* xi = xr + Kr * Ls;
  const int w = vec ? 4 : 1;            // samples a copy
  const int nw = np / w;                 // copies a frame and plane
  // item l = k*nw + q, stepped by kPfbThreads without a division
  const int dk = kPfbThreads / nw, dq = kPfbThreads % nw;
  for (int q = threadIdx.x % nw, k = threadIdx.x / nw; k < Kr;) {
    const int pl = q * w;
    const long g = g0 + (long)k * D + p0 + pl;
    float* dr = xr + k * Ls + pl;
    float* di = xi + k * Ls + pl;
    if (vec && g >= 0 && g + 4 <= nb) {
      cp_async_16(dr, buf_re + g);
      cp_async_16(di, buf_im + g);
    } else {
      for (int i = 0; i < w; ++i) {
        const bool in = g + i >= 0 && g + i < nb;
        cp_async_f32(dr + i, buf_re + (in ? g + i : 0), in);
        cp_async_f32(di + i, buf_im + (in ? g + i : 0), in);
      }
    }
    q += dq;
    k += dk;
    if (q >= nw) {
      q -= nw;
      ++k;
    }
  }
}

// Tensor-core PFB front, grade kGrade (kGradeBf16x3 or kGradeBf16x2), for
// the 4*kNT channels of channel group `group`: output row r of the block
// (window start g0 + r*D, kTile rows) gets
//   y[c, r] = sum_v G[c, v] A_re[r, v] + G[c, K+v] A_im[r, v]   (re)
//           + the same with rows C+c of G                       (im)
// over the fold A[r, v] = sum_u hp[u, v] * x[g0 + r*D + v + u*K],
// computed in float32 as the plain version computes it (graded_uniform_
// front): hp[0]*x first, then + hp[u]*x for ascending u, each product and
// sum rounded on its own (__fmul_rn, __fadd_rn), so that both split the
// same value. The split is JAX's, hi = bf16(A), lo = bf16(A - hi); the
// product is one real GEMM per block, rows the kTile outputs, K = 2K
// (lane, plane), N = 8*kNT columns (re, im of each channel), on mma.sync
// m16n8k16 bf16 with f32 sums: bf16x3 = Ah*Bh + Ah*Bl + Al*Bh, bf16x2 the
// first two (_nt_grade_dot). Each thread folds the (re, im) pair of the
// two lanes and two rows of its A fragment straight into registers: the
// fold never leaves them, and each fold value is made once per block.
//
// btab: pfb_mma_tables' int32 (2, ceil(K/8), ceil(C/4), 16, 2), the
// dense_mma_tables layout over lanes v in place of taps: the bf16 pair
// (G[c, v], G[c, K+v]) of the bank's re rows; the im rows are the same
// values with the halves swapped and one sign flipped, formed in
// registers as in toeplitz_front_mma. The block gathers the table into
// shared memory in its own lane order, chunk by chunk (pfb_mma_geom).
//
// The window is staged Dc phases at a time with cp.async (16-byte copies
// where aligned), the next chunk in flight while the current one is folded
// and multiplied. The block has
// kPfbThreads threads: sixteen warps each take 16 rows (one m-tile)
// against all kNT n-tiles, and each thread folds its four values per
// plane with the Q taps unrolled, so that the loads of several taps are
// in flight at once (the sums stay in ascending u). Returns the kTile x
// (8*kNT + 1) output tile in shared memory: row r, column 2c (re) and
// 2c + 1 (im) of channel c of the group; it stays valid until the
// caller's next write to dynamic shared memory.
template <int kGrade, int kNT>
__device__ __forceinline__ const float* pfb_front_mma(
    unsigned char* smem, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb, const float* __restrict__ hp,
    const uint32_t* __restrict__ btab, int C, int K, int Q, int D, int group,
    long g0) {
  static_assert(kGrade == kGradeBf16x3 || kGrade == kGradeBf16x2,
                "tensor-core grades are bf16x3 and bf16x2");
  static_assert(kPfbThreads == 2 * kTile, "16 warps of 16 rows");
  constexpr int kOS = 8 * kNT + 1;   // output tile row stride, in floats
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const PfbMmaGeom geo = pfb_mma_geom(K, Q, D);
  const int P = geo.P, NT = (C + 3) / 4, KBt = (K + 7) / 8;
  uint2* bs = reinterpret_cast<uint2*>(smem);
  const size_t b_bytes = 2 * (size_t)geo.KBg * kNT * 16 * sizeof(uint2);
  float* hps = reinterpret_cast<float*>(smem + b_bytes);
  float* win = reinterpret_cast<float*>(smem + b_bytes +
                                        pfb_mma_taps_bytes(K, Q));
  float* out = win;
  const int Ls = geo.Ls, wsize = 2 * geo.Kr * Ls;   // floats per buffer
  // 16-byte copies where every frame's run of samples is 16-byte aligned
  const bool vec = geo.Dc % 4 == 0 && D % 4 == 0 && g0 % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(buf_re) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(buf_im) % 16 == 0;

  pfb_stage_phases(win, buf_re, buf_im, nb, g0, D, 0, geo.Dc, geo.Kr, Ls,
                   vec);
  cp_async_commit();

  // B in the block's lane order: word iw of entry [part][kbg][nt][e] is the
  // pair of lane kappa = 8*kbl + (e & 3) + 4*iw of chunk kbg / KB0. A warp
  // takes one (part, kbg) at a time, a thread one word of its kNT entries.
  uint32_t* bw = reinterpret_cast<uint32_t*>(bs);
  for (int pk = warp; pk < 2 * geo.KBg; pk += kPfbThreads / 32) {
    const int part = pk / geo.KBg, kbg = pk - part * geo.KBg;
    const int ch = kbg / geo.KB0, kbl = kbg - ch * geo.KB0;
    const int p0 = ch * geo.Dc, np = min(geo.Dc, D - p0);
    const int e = lane >> 1, kap = 8 * kbl + (e & 3) + 4 * (lane & 1);
    const bool ok = kap < np * P;
    const int v = ok ? p0 + kap / P + (kap % P) * D : 0, vq = v & 7;
    const uint32_t* src = btab + ((long)part * KBt + (v >> 3)) * NT * 32 +
                          (4 * (e >> 2) + (vq & 3)) * 2 + (vq >> 2);
    uint32_t* dst = bw + (long)pk * kNT * 32 + lane;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int ntg = group * kNT + nt;
      dst[nt * 32] = ok && ntg < NT ? src[(long)ntg * 32] : 0u;
    }
  }
  for (int i = tid; i < Q * K; i += kPfbThreads) hps[i] = hp[i];

  const int gid = lane >> 2, tig = lane & 3;
  // an odd GEMM column (wi, wr) from its even neighbour (wr, -wi)
  const uint32_t sel = (gid & 1) ? 0x1032u : 0x3210u;
  const uint32_t flip = (gid & 1) ? 0x8000u : 0u;
  const uint2* bl = bs + 4 * (gid >> 1) + tig;
  const int r0 = warp * 16 + gid;
  float d[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[nt][i] = 0.f;

  for (int ch = 0; ch < geo.nch; ++ch) {
    const int p0 = ch * geo.Dc, np = min(geo.Dc, D - p0);
    if (ch + 1 < geo.nch) {
      const int p1 = p0 + geo.Dc;
      pfb_stage_phases(win + ((ch + 1) & 1) * wsize, buf_re, buf_im, nb, g0,
                       D, p1, min(geo.Dc, D - p1), geo.Kr, Ls, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // chunk ch (and, the first time, B and the taps)
    const float* xr = win + (ch & 1) * wsize + r0 * Ls;
    const float* xi = xr + geo.Kr * Ls;
    const int lanes = np * P, kbc = (lanes + 7) / 8;
    for (int kbl = 0; kbl < kbc; ++kbl) {
      // the fold of lanes kappa = 8*kbl + tig (h = 0) and + 4 (h = 1) at
      // rows r0 and r0 + 8 (rr); a lane past the chunk's folds to zero
      int off[2];
      const float* tp[2];
      bool ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kap = 8 * kbl + tig + 4 * h;
        const int pl = kap / P, s = kap % P;
        ok[h] = kap < lanes;
        off[h] = ok[h] ? s * Ls + pl : 0;
        tp[h] = hps + (ok[h] ? p0 + pl + s * D : 0);
      }
      float fr[2][2], fi[2][2];
      const int us = P * Ls;   // one fold tap further: P frames
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float h0 = ok[h] ? tp[h][0] : 0.f;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int o = off[h] + 8 * rr * Ls;
          fr[h][rr] = __fmul_rn(xr[o], h0);
          fi[h][rr] = __fmul_rn(xi[o], h0);
        }
      }
#pragma unroll 4
      for (int u = 1; u < Q; ++u) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float hu = ok[h] ? tp[h][u * K] : 0.f;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int o = off[h] + 8 * rr * Ls + u * us;
            fr[h][rr] = __fadd_rn(fr[h][rr], __fmul_rn(xr[o], hu));
            fi[h][rr] = __fadd_rn(fi[h][rr], __fmul_rn(xi[o], hu));
          }
        }
      }
      // A fragment: register q holds lane h = q / 2 at row r0 + 8*(q % 2)
      uint32_t ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float ar = fr[q >> 1][q & 1], ai = fi[q >> 1][q & 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(ar, ai);
        ah[q] = bf16x2_bits(hi);
        if constexpr (kGrade == kGradeBf16x3) {
          al[q] = bf16x2_bits(__floats2bfloat162_rn(
              __fsub_rn(ar, __low2float(hi)), __fsub_rn(ai, __high2float(hi))));
        }
      }
      const int kbg = ch * geo.KB0 + kbl;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const uint2 h = bl[(kbg * kNT + nt) * 16];
        const uint2 l = bl[((geo.KBg + kbg) * kNT + nt) * 16];
        const uint32_t h0 = __byte_perm(h.x, 0u, sel) ^ flip;
        const uint32_t h1 = __byte_perm(h.y, 0u, sel) ^ flip;
        const uint32_t l0 = __byte_perm(l.x, 0u, sel) ^ flip;
        const uint32_t l1 = __byte_perm(l.y, 0u, sel) ^ flip;
        mma_bf16(d[nt], ah, h0, h1);
        mma_bf16(d[nt], ah, l0, l1);
        if constexpr (kGrade == kGradeBf16x3) mma_bf16(d[nt], al, h0, h1);
      }
    }
    __syncthreads();   // every warp is done with this buffer
  }

  // the fragments to the output tile, in the window's space
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = 8 * nt + 2 * tig;
    out[r0 * kOS + col] = d[nt][0];
    out[r0 * kOS + col + 1] = d[nt][1];
    out[(r0 + 8) * kOS + col] = d[nt][2];
    out[(r0 + 8) * kOS + col + 1] = d[nt][3];
  }
  __syncthreads();
  return out;
}

// ---- The PFB front at f32 ------------------------------------------------
//
// pfb_front and pfb_front_chunked compute, for the block's kTile output
// rows (window start g0 + r*D) and its kPfbCh channels c0 = group*kPfbCh
// on, exactly the sums of one pass over the lanes: the fold
//   A[r, v] = fmaf(hp[Q-1, v], x[.. + (Q-1)K], ... fmaf(hp[0, v], x, 0))
// in ascending u from 0, then per output, lane after lane in the one-chunk
// order (groups of Dc = min(D, kPhaseChunk) phases, a group's lanes kappa =
// pl*P + s ascending, lane v = p0 + pl + s*D),
//   y_re = fmaf(G[c, v], A_re, fmaf(G[c, K+v], A_im, y_re)),
//   y_im = fmaf(G[C+c, v], A_re, fmaf(G[C+c, K+v], A_im, y_im)),
// so that every plan gives every output the same sequence of roundings.
//
// What bounds it: the product's FP32 FMAs, 8*kPfbCh*K FLOP a row, against
// 4*Q*K of fold, and the shared-memory loads that feed them (a 16-byte
// load of a warp takes four wavefronts, one a quarter-warp). The block
// folds each lane once for all its channels into a shared A tile,
// a[lane][plane][row], and multiplies it in register tiles: thread (warp
// w, lane l) owns rows 32*(w % 8) + 4*(l % 8) + i, i < kPfbRows, and two
// pairs of neighbouring channels, 16*(w / 8) + 2*(l / 8) + {0, 1, 8, 9};
// for each lane it reads its rows' (A_re, A_im) as two float4 (eight
// distinct float4 a warp, consecutive) and its channels' (G[c, v],
// G[c, K+v]) as two float4 (a broadcast in each quarter-warp), each
// reused across the tile: 4 shared loads, 16 wavefronts a warp, for 64
// FMAs, which keeps the loads level with the FMA pipe. The im row of a
// DFT bank is its re row's halves swapped, one negated (pfb_f32_tables),
// so (-G[c, K+v], G[c, v]) stand for (G[C+c, v], G[C+c, K+v]) with the
// same bits. The fold gives each warp one lane and each thread eight rows
// 32 apart, so a warp reads 32 consecutive words of the window (staged
// phase-major: plane, phase, frame) and writes 32 of the A tile; its tap
// is a broadcast. Staging is asynchronous (cp.async): the next step's
// window, taps and bank rows are in flight while the block folds and
// multiplies the current one. A lane's bank row is 256 contiguous bytes
// of the table, copied 16 bytes a thread; window samples are 4-byte
// copies, zero-filled outside [0, nb), neighbouring threads on
// neighbouring phases (consecutive samples), stepped without divisions.
//
// pfb_front (one chunk) stages the taps (Q, K) and the first group's
// window, then the bank rows [K][kPfbCh] in lane order (which land while
// the first lanes fold), then the window one group at a time (two buffers
// where D > Dc), and folds and multiplies kPfbFoldLanes lanes a step in two
// A tiles: one __syncthreads a step. pfb_front_chunked walks the chunks of
// the plan (lanes, uc) with its warps specialised: producers stage each
// chunk's bank rows (two buffers) and per u-range its taps and window (two
// buffers) and fold it into its A tile (two), carrying the partials across
// u-ranges; consumers multiply the previous chunk meanwhile, in 8 x 4
// register tiles.

// Starts the copies of a window of npc phases from p_first and nfr frames
// from f0 into xw[(plane*npc + pl)*nfr + k] = x[g0 + (f0 + k)*D + p_first
// + pl], zeros outside [0, nb), by threads tid = 0..nt-1 (here and in
// pfb_stage_lanes: the staging threads, numbered from 0).
__device__ __forceinline__ void pfb_stage_window(
    float* xw, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb, long g0, int D, int f0,
    int p_first, int npc, int nfr, int tid, int nt) {
  const int n = npc * nfr;
  // item l = k*npc + pl of thread tid of nt, stepped without a division
  const int dpl = nt % npc, dk = nt / npc;
  for (int pl = tid % npc, k = tid / npc; k < nfr;) {
    const long g = g0 + (long)(f0 + k) * D + p_first + pl;
    const bool in = g >= 0 && g < nb;
    float* d = xw + pl * nfr + k;
    cp_async_f32(d, buf_re + (in ? g : 0), in);
    cp_async_f32(d + n, buf_im + (in ? g : 0), in);
    pl += dpl;
    k += dk;
    if (pl >= npc) {
      pl -= npc;
      ++k;
    }
  }
}

// The phases pa..pb and the s range s_lo..s_hi that lanes [ka, kz) of a
// group touch (all P where they span phases).
struct PfbSpan {
  int pa, pb, s_lo, s_hi;
};

__device__ __forceinline__ PfbSpan pfb_span(int P, int ka, int kz) {
  PfbSpan r;
  r.pa = ka / P;
  r.pb = (kz - 1) / P;
  r.s_lo = r.pa == r.pb ? ka % P : 0;
  r.s_hi = r.pa == r.pb ? (kz - 1) % P : P - 1;
  return r;
}

// Starts the copies of the bank rows of lanes [ka, kz) of the group at p0
// (kappa = pl*P + s, lane v = p0 + pl + s*D) from channel group `group` of
// ftab (pfb_f32_tables: (ceil(C/32), K, kPfbCh, 2), zeros past C) into
// gb[(kappa - ka)*kPfbCh + cl] = (G[c, v], G[c, K+v]), 16-byte copies, a
// lane's row of 256 bytes by neighbouring threads; and, where hs, of their
// taps u0..u1-1 into hs[(u - u0)*L + kappa - ka].
__device__ __forceinline__ void pfb_stage_lanes(
    float* gb, float* hs, int L, const float* __restrict__ ftab,
    const float* __restrict__ hp, int K, int D, int group, int p0, int ka,
    int kz, int u0, int u1, int tid, int nt) {
  constexpr int kRow = kPfbCh * 2 / 4;   // 16-byte copies a lane's row
  const int P = K / D, nl = kz - ka;
  if (gb) {
    const float* src = ftab + (size_t)group * K * kPfbCh * 2;
    for (int i = tid; i < nl * kRow; i += nt) {
      const int kap = ka + i / kRow, q = i % kRow;
      const int v = p0 + kap / P + (kap % P) * D;
      cp_async_16(gb + (size_t)(kap - ka) * kPfbCh * 2 + 4 * q,
                  src + (size_t)v * kPfbCh * 2 + 4 * q);
    }
  }
  if (hs) {
    for (int i = tid; i < (u1 - u0) * nl; i += nt) {
      const int u = u0 + i / nl, kap = ka + i % nl;
      cp_async_f32(hs + (u - u0) * L + kap - ka,
                   hp + (long)u * K + p0 + kap / P + (kap % P) * D, true);
    }
  }
}

// Folds lanes ka..ka+nl-1 of the group at p0, fold taps u0..u1-1, into the
// A tile a[j][plane][row] (j = kappa - ka): from zero where u0 == 0, else
// on from the partials there. The window xw holds phases from p0 + pa,
// frames from u0*P + s_lo, nfr frames a phase, planes `plane` floats
// apart; the tap of lane j at u is taps[tap(j) + (u - u0)*tstride], tap(j)
// = v (kByV: the taps (Q, K) as they are) or j + ka - kbase (a chunk's
// staged taps from lane kbase). Folding warp w of nw takes lanes w, w +
// nw, ..., each thread the rows lane + 32*i.
template <bool kByV>
__device__ __forceinline__ void pfb_fold(float* a, const float* xw, int plane,
                                         int nfr, const float* taps,
                                         int tstride, int P, int D, int p0,
                                         int ka, int nl, int kbase,
                                         PfbSpan sp, int u0, int u1, int w,
                                         int nw) {
  constexpr int kR = kTile / 32;
  const int lane = threadIdx.x & 31;
  for (int j = w; j < nl; j += nw) {
    const int kap = ka + j, pl = kap / P, s = kap % P;
    const float* xr = xw + (pl - sp.pa) * nfr + (s - sp.s_lo) + lane;
    const float* xi = xr + plane;
    const float* h = taps + (kByV ? p0 + pl + s * D : kap - kbase);
    float* at = a + j * 2 * kTile + lane;
    float fr[kR], fi[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      fr[i] = u0 == 0 ? 0.f : at[32 * i];
      fi[i] = u0 == 0 ? 0.f : at[kTile + 32 * i];
    }
    for (int u = 0; u < u1 - u0; ++u) {
      const float hu = h[u * tstride];
      const int o = u * P;
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        fr[i] = fmaf(hu, xr[o + 32 * i], fr[i]);
        fi[i] = fmaf(hu, xi[o + 32 * i], fi[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      at[32 * i] = fr[i];
      at[kTile + 32 * i] = fi[i];
    }
  }
}

// A thread's register tile of kRows rows and kPfbCols channels: rows r0 +
// i, channels cb + (c & 1) + 2*kRows*(c >> 1), two pairs of neighbouring
// channels (one float4 of bank each). kRows = 4: all kPfbThreads threads,
// a warp 32 rows x 16 channels; kRows = 8: the first kPfbConsumers
// threads, a warp 32 rows x 32 channels.
template <int kRows>
struct PfbTile {
  int r0, cb;
  float re[kRows][kPfbCols], im[kRows][kPfbCols];
};

template <int kRows>
__device__ __forceinline__ int pfb_tile_channel(const PfbTile<kRows>& t,
                                                int c) {
  return t.cb + (c & 1) + 2 * kRows * (c >> 1);
}

template <int kRows>
__device__ __forceinline__ void pfb_tile_init(PfbTile<kRows>& t) {
  static_assert(kPfbCols == 4 && (kRows == kPfbRows || kRows == kPfbWideRows)
                    && kPfbThreads * kPfbRows * kPfbCols == kTile * kPfbCh &&
                    kPfbConsumers * kPfbWideRows * kPfbCols == kTile * kPfbCh,
                "tiles of 4 x 4 (every thread) or 8 x 4 (the consumers)");
  constexpr int kGroups = 32 / kRows;   // row groups a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  t.r0 = 32 * (warp % 8) + kRows * (lane % kGroups);
  t.cb = 16 * (warp / 8) + 2 * (lane / kGroups);
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kPfbCols; ++c) t.re[i][c] = t.im[i][c] = 0.f;
}

// t += the products of lanes j < nl of the A tile a with their bank rows
// gb[j][kPfbCh] (float2 (G[c, v], G[c, K+v]); the im row's (G[C+c, v],
// G[C+c, K+v]) is (-G[c, K+v], G[c, v]) of a DFT bank), lane after lane.
template <int kRows>
__device__ __forceinline__ void pfb_product(PfbTile<kRows>& t, const float* a,
                                            const float* gb, int nl) {
  const float4* g4 = reinterpret_cast<const float4*>(gb) + t.cb / 2;
  // unrolled where the registers allow it (an 8 x 4 tile spills at 2)
#pragma unroll(kRows == kPfbRows ? 4 : 1)
  for (int j = 0; j < nl; ++j) {
    float ar[kRows], ai[kRows];
#pragma unroll
    for (int i = 0; i < kRows; i += 4) {
      const float4 xr = *reinterpret_cast<const float4*>(
          a + j * 2 * kTile + t.r0 + i);
      const float4 xi = *reinterpret_cast<const float4*>(
          a + j * 2 * kTile + kTile + t.r0 + i);
      ar[i] = xr.x, ar[i + 1] = xr.y, ar[i + 2] = xr.z, ar[i + 3] = xr.w;
      ai[i] = xi.x, ai[i + 1] = xi.y, ai[i + 2] = xi.z, ai[i + 3] = xi.w;
    }
    const float4 p0 = g4[j * kPfbCh / 2], p1 = g4[j * kPfbCh / 2 + kRows];
    const float gr[kPfbCols] = {p0.x, p0.z, p1.x, p1.z};   // G[c, v]
    const float gi[kPfbCols] = {p0.y, p0.w, p1.y, p1.w};   // G[c, K+v]
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kPfbCols; ++c) {
        t.re[i][c] = fmaf(gr[c], ar[i], fmaf(gi[c], ai[i], t.re[i][c]));
        t.im[i][c] = fmaf(-gi[c], ar[i], fmaf(gr[c], ai[i], t.im[i][c]));
      }
  }
}

// The register tiles to the output tile at the start of dynamic shared
// memory (row r, column 2c re and 2c + 1 im of the block's channel c),
// after every thread is done with the space; a thread that holds no tile
// (holds false) only takes the barriers.
template <int kRows>
__device__ __forceinline__ const float* pfb_tile_out(
    unsigned char* smem, const PfbTile<kRows>& t, bool holds = true) {
  constexpr int kOS = 8 * kPfbNT + 1;
  float* out = reinterpret_cast<float*>(smem);
  __syncthreads();
  if (holds) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kPfbCols; ++c) {
        const int col = 2 * pfb_tile_channel(t, c);
        out[(t.r0 + i) * kOS + col] = t.re[i][c];
        out[(t.r0 + i) * kOS + col + 1] = t.im[i][c];
      }
  }
  __syncthreads();
  return out;
}

// PFB front at f32 in one chunk (plan (K, Q)). hp: (Q, K) zero-padded
// polyphase taps hp[u, v] = h[v + K u]; ftab: pfb_f32_tables of the DFT
// bank. Shared memory (pfb_smem_bytes): the bank rows [K][kPfbCh] float2
// in lane order, two A tiles of kPfbFoldLanes lanes, the taps, the window
// buffers. Returns the kTile x (8*kPfbNT + 1) output tile, as
// pfb_front_mma; it stays valid until the caller's next write to dynamic
// shared memory.
__device__ __forceinline__ const float* pfb_front(
    unsigned char* smem, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb, const float* __restrict__ hp,
    const float* __restrict__ ftab, int K, int Q, int D, int group,
    long g0) {
  const int P = K / D, Dc = D < kPhaseChunk ? D : kPhaseChunk;
  const int Kr = kTile + Q * P - 1, wsize = 2 * Dc * Kr;
  float* gb = reinterpret_cast<float*>(smem);
  float* a = gb + (size_t)K * kPfbCh * 2;
  float* hps = a + 2 * kPfbFoldLanes * 2 * kTile;
  float* win = hps + (Q * K + 3) / 4 * 4;

  // two copy groups: the taps and the first window, which the first fold
  // reads, then the bank, which lands while it folds
  for (int i = threadIdx.x; i < Q * K; i += kPfbThreads)
    cp_async_f32(hps + i, hp + i, true);
  pfb_stage_window(win, buf_re, buf_im, nb, g0, D, 0, 0, Dc, Kr,
                   threadIdx.x, kPfbThreads);
  cp_async_commit();
  for (int p0 = 0; p0 < D; p0 += Dc)
    pfb_stage_lanes(gb + (size_t)p0 * P * kPfbCh * 2, nullptr, 0, ftab, hp,
                    K, D, group, p0, 0, min(Dc, D - p0) * P, 0, 0,
                    threadIdx.x, kPfbThreads);
  cp_async_commit();

  PfbTile<kPfbRows> t;
  pfb_tile_init(t);
  const PfbSpan whole = {0, 0, 0, 0};
  int step = 0;
  for (int p0 = 0; p0 < D; p0 += Dc) {
    const int np = min(Dc, D - p0), glanes = np * P;
    if (p0 == 0) cp_async_wait<1>();   // the taps and this window
    else cp_async_wait<0>();
    __syncthreads();   // this group's window in; its readers' buffer free
    if (p0 + Dc < D) {   // the next group's window, into the other buffer
      pfb_stage_window(win + ((p0 / Dc + 1) & 1) * wsize, buf_re, buf_im, nb,
                       g0, D, 0, p0 + Dc, min(Dc, D - p0 - Dc), Kr,
                       threadIdx.x, kPfbThreads);
      cp_async_commit();
    }
    const float* xw = win + ((p0 / Dc) & 1) * wsize;
    for (int ka = 0; ka < glanes; ka += kPfbFoldLanes, ++step) {
      const int nl = min(kPfbFoldLanes, glanes - ka);
      float* at = a + (step & 1) * kPfbFoldLanes * 2 * kTile;
      pfb_fold<true>(at, xw, np * Kr, Kr, hps, K, P, D, p0, ka, nl, 0, whole,
                     0, Q, threadIdx.x >> 5, kPfbThreads / 32);
      if (step == 0) {   // the bank, before the first product
        if (p0 + Dc < D) cp_async_wait<1>();
        else cp_async_wait<0>();
      }
      __syncthreads();   // the tile is folded; the other one is free
      pfb_product(t, at, gb + (size_t)(p0 * P + ka) * kPfbCh * 2, nl);
    }
  }
  return pfb_tile_out(smem, t);
}

// One step of pfb_front_chunked: lanes [ka, kz) of the group at p0 (of
// glanes lanes), fold taps u0..u1-1; valid while p0 < D.
struct PfbStep {
  int p0, glanes, ka, kz, u0, u1;
};

// The step after s for chunks of L lanes and u-ranges of uc taps: the next
// u-range, else the chunk's next, else the next group's first.
__device__ __forceinline__ void pfb_next_step(PfbStep& s, int D, int P,
                                              int Q, int L, int uc) {
  const int Dc = D < kPhaseChunk ? D : kPhaseChunk;
  if (s.u1 < Q) {
    s.u0 = s.u1;
    s.u1 = min(Q, s.u0 + uc);
    return;
  }
  s.u0 = 0;
  s.u1 = min(Q, uc);
  s.ka = s.kz;
  if (s.ka >= s.glanes) {
    s.p0 += Dc;
    s.glanes = min(Dc, D - s.p0) * P;
    s.ka = 0;
  }
  s.kz = min(s.ka + L, s.glanes);
}

// Named barriers of the chunked PFB fronts (0 is __syncthreads): a chunk's
// A tile (and, at f32, bank rows) full (two, by chunk parity) and free
// (two), the producers' own and (pfb_front_mma_chunked) the consumers'.
constexpr int kBarFull = 1, kBarFree = 3, kBarProducers = 5;
constexpr int kBarConsumers = 6;

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// pfb_front_chunked's producers (the threads from kPfbConsumers on): step
// after step, stage the next u-range's window and taps and each chunk's
// bank rows, fold, and hand each whole chunk to the consumers.
__device__ __forceinline__ void pfb_produce(
    float* gb, float* a, float* stage, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb, const float* __restrict__ hp,
    const float* __restrict__ ftab, int K, int Q, int D, int group, long g0,
    int L, int uc, size_t ssize, size_t gsize, size_t asize) {
  constexpr int kProducers = kPfbThreads - kPfbConsumers;
  const int P = K / D, tsize = (uc * L + 3) / 4 * 4;
  const int tid = threadIdx.x - kPfbConsumers;
  // starts step s's window and taps into staging buffer sb
  auto issue = [&](const PfbStep& s, int sb) {
    const PfbSpan sp = pfb_span(P, s.ka, s.kz);
    float* st = stage + sb * ssize;
    pfb_stage_lanes(nullptr, st, L, ftab, hp, K, D, group, s.p0, s.ka, s.kz,
                    s.u0, s.u1, tid, kProducers);
    pfb_stage_window(st + tsize, buf_re, buf_im, nb, g0, D,
                     s.u0 * P + sp.s_lo, s.p0 + sp.pa, sp.pb - sp.pa + 1,
                     (s.u1 - 1 - s.u0) * P + sp.s_hi - sp.s_lo + kTile, tid,
                     kProducers);
    cp_async_commit();
  };

  PfbStep cur = {0, min(D, kPhaseChunk) * P, 0, 0, 0, min(Q, uc)};
  cur.kz = min(L, cur.glanes);
  issue(cur, 0);
  for (int si = 0, c = 0; cur.p0 < D; ++si) {
    const bool first = cur.u0 == 0;
    if (first) {   // chunk c's buffers: free once chunk c - 2 is multiplied
      if (c >= 2) named_sync(kBarFree + (c & 1), kPfbThreads);
      pfb_stage_lanes(gb + (c & 1) * gsize, nullptr, 0, ftab, hp, K, D, group,
                      cur.p0, cur.ka, cur.kz, 0, 0, tid, kProducers);
      cp_async_commit();
      cp_async_wait<1>();   // this step's window and taps
    } else {
      cp_async_wait<0>();
    }
    named_sync(kBarProducers, kProducers);   // in; the other buffer free
    PfbStep nxt = cur;
    pfb_next_step(nxt, D, P, Q, L, uc);
    if (nxt.p0 < D) issue(nxt, (si + 1) & 1);
    const PfbSpan sp = pfb_span(P, cur.ka, cur.kz);
    const int nfr = (cur.u1 - 1 - cur.u0) * P + sp.s_hi - sp.s_lo + kTile;
    const float* st = stage + (si & 1) * ssize;
    pfb_fold<false>(a + (c & 1) * asize, st + tsize,
                    (sp.pb - sp.pa + 1) * nfr, nfr, st, L, P, D, cur.p0,
                    cur.ka, cur.kz - cur.ka, cur.ka, sp, cur.u0, cur.u1,
                    (threadIdx.x >> 5) - kPfbConsumers / 32, kProducers / 32);
    if (cur.u1 == Q) {   // chunk c is folded: hand it over with its bank
      if (nxt.p0 < D) cp_async_wait<1>();
      else cp_async_wait<0>();
      named_arrive(kBarFull + (c & 1), kPfbThreads);
      ++c;
    }
    cur = nxt;
  }
}

// pfb_front in chunks of `lanes` lanes and u-ranges of `uc` fold taps (the
// plan, pfb_chunk): the same contract, sums and order, with its warps
// specialised. The first kPfbConsumers threads (consumers) multiply, each
// holding an 8 x 4 register tile (PfbTile<kPfbWideRows>: 8 row loads and
// 2 bank loads a lane for 128 FMAs, which the FMA pipe, not the shared
// loads, bounds); the other warps (producers) stage and fold. Chunk c's
// bank rows and A tile live in buffer c & 1: the producers fold chunk c
// while the consumers multiply chunk c - 1, and hand it over through the
// named barriers (full, then free after its product). Shared memory
// (pfb_chunk_bytes): two buffers of bank rows, two A tiles, two staging
// buffers of a u-range's taps hs[u - u0][kappa - ka] and window (phases
// pa..pb of its lanes, frames f0 = u0*P + s_lo on: output row r reads
// frame r + (s - s_lo) + (u - u0)*P), the next u-range's in flight while
// the producers fold the current one. Returns the output tile, as
// pfb_front.
__device__ __forceinline__ const float* pfb_front_chunked(
    unsigned char* smem, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb, const float* __restrict__ hp,
    const float* __restrict__ ftab, int K, int Q, int D, int group, long g0,
    int lanes, int uc) {
  const int P = K / D, L = pfb_chunk_lanes(K, D, lanes);
  uc = min(uc, Q);
  const size_t ssize = pfb_chunk_stage_floats(K, Q, D, lanes, uc);
  float* gb = reinterpret_cast<float*>(smem);
  float* a = gb + 2 * (size_t)L * kPfbCh * 2;
  float* stage = a + 2 * (size_t)L * 2 * kTile;
  const size_t gsize = (size_t)L * kPfbCh * 2, asize = (size_t)L * 2 * kTile;
  const int Dc = D < kPhaseChunk ? D : kPhaseChunk;
  int nchunks = 0;
  for (int p0 = 0; p0 < D; p0 += Dc)
    nchunks += (min(Dc, D - p0) * P + L - 1) / L;

  const bool consumer = threadIdx.x < kPfbConsumers;
  PfbTile<kPfbWideRows> t;
  if (consumer) {   // multiply chunk after chunk
    pfb_tile_init(t);
    int c = 0;
    for (int p0 = 0; p0 < D; p0 += Dc) {
      const int glanes = min(Dc, D - p0) * P;
      for (int ka = 0; ka < glanes; ka += L, ++c) {
        named_sync(kBarFull + (c & 1), kPfbThreads);
        pfb_product(t, a + (c & 1) * asize, gb + (c & 1) * gsize,
                    min(L, glanes - ka));
        if (c + 2 < nchunks) named_arrive(kBarFree + (c & 1), kPfbThreads);
      }
    }
  } else {
    pfb_produce(gb, a, stage, buf_re, buf_im, nb, hp, ftab, K, Q, D, group,
                g0, L, uc, ssize, gsize, asize);
  }
  return pfb_tile_out(smem, t, consumer);
}

// ---- The bf16 PFB front in chunks ---------------------------------------
//
// pfb_front_mma_chunked is pfb_front_mma in chunks of `lanes` lanes and
// u-ranges of `uc` fold taps (the plan, pfb_chunk), for a grid whose B
// table, taps or window outgrow one block: the same contract, values and
// order. A chunk is up to nkb consecutive 8-lane blocks of one group, in
// pfb_front_mma's lane order; every fold value is made as there, __fmul_rn
// at u = 0, then __fadd_rn(acc, __fmul_rn(x, hp[u])) in ascending u across
// u-ranges, split hi/lo after the last, and every accumulator takes the
// same m16n8k16 fragments, block after block, Ah*Bh, Ah*Bl, then (bf16x3)
// Al*Bh: a chunked launch equals the one-chunk launch bit for bit.
//
// What bounds it on the card: per chunk, the product (3 or 2 tensor-core
// passes of 8*C*8 FLOP a row and 8-lane block) and the fold (2*Q shared
// loads and roundings a value, two planes, for all 32 channels). The first
// chunked kernel ran them one after the other on the same 16 warps, each
// accumulator's three passes back to back, behind a staging of each chunk
// that nothing overlapped, from a frame-major window where a fold load's
// frames 8 apart shared a bank. What the design does about it:
//  - warps specialised, as pfb_front_chunked: the first kPfbConsumers
//    threads (8 warps, at 256 rows each 32 rows: two m-tiles against the
//    kNT n-tiles) multiply; the other 8 warps (producers) stage and fold.
//    Chunk c's fold goes into A tile c & 1, the bf16 hi and lo words in
//    fragment order, [block][hi, lo][m-tile][lane][4] (pfb_a_block_words
//    a block), so that a consumer loads each fragment with one 16-byte
//    load; the producers fold chunk c + 1 while the consumers multiply
//    chunk c, handed over through the named barriers full and free.
//  - producer thread (gid, tig) of the warp of m-tile pair mp folds what
//    consumer thread (gid, tig) of that pair reads: lanes tig and tig + 4
//    of each block, rows gid and gid + 8 of m-tiles 2*mp and 2*mp + 1,
//    both planes. Between u-ranges its partials wait as float32 in its own
//    fragment's words of the A tile; after the last it writes the split
//    there.
//  - a block takes 256, 128 or 64 rows (pfb_mma_rows: fewer where a short
//    call's grid would leave most of the card's SMs idle) on the same 16
//    warps, so that a smaller block's SM keeps as many warps in flight and
//    each does less: at rows r, the r/32 m-tile pairs are each shared by
//    256/r warps of each role (pfb_mma_split), the consumers splitting the
//    kNT n-tiles and the producers the 8-lane blocks of a step (block kb
//    to the warp of residue kb mod 256/r). Every accumulator still takes
//    its fragments in ascending block and every fold sums in ascending u,
//    so every row tile gives the 256-row block's values bit for bit.
//  - the window is staged in phase pairs, frames contiguous
//    (pfb_mma_stage_window: a frame's pair one 8-byte cp.async where D
//    is even, pairs pfb_mma_pair_stride frames apart), so a warp's fold
//    load reads frames gid + s of its 8 rows and 4 lanes on distinct
//    banks; at P = 4, Q = 4 (the NFM and airband grids) a block's lanes
//    tig and tig + 4 are one pair, read by one 8-byte load, and rows 8
//    apart share frames, so 10 loads a plane serve a thread's 32 products
//    (pfb_mma_fold_slide), where the first design loaded each. The host
//    lays the taps and B out in the chunks' lane order (kernels/chain.py,
//    pfb_chunk_taps and pfb_mma_chunk_tables: groups of Dc phases, kappa =
//    pl*P + s, padded per group to 8-lane blocks, zeros there), so a
//    u-range's taps are one contiguous run of each row, 16-byte copies,
//    and a chunk's B rows too. Step s + 1 (a u-range of a chunk) is in
//    flight into the other of two staging buffers while the producers fold
//    step s.
//  - the consumers stage each chunk's B rows themselves, into the other of
//    two B buffers while they multiply the current chunk, and per 8-lane
//    block run each pass over all 2*kNT accumulators in turn, so that no
//    mma waits on the one before it.

// Starts the copies of a window of npc phases from p_first and nfr frames
// from f0, x[g0 + (f0 + k)*D + p_first + pl], into pfb_front_mma_chunked's
// layout: the phases in pairs, phase pl of frame k at word (pl/2*lf + k)*2
// + pl%2 of plane 0 (re) and `plane` words on (im); zeros outside [0, nb)
// and past the window's phases. Where vec (every pair 8-byte aligned in
// the buffers), a pair of a frame is one 8-byte copy, else two of 4 bytes;
// neighbouring threads copy neighbouring pairs, by threads tid of nt.
__device__ __forceinline__ void pfb_mma_stage_window(
    float* xw, int plane, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb, long g0, int D, int f0,
    int p_first, int npc, int nfr, int lf, bool vec, int tid, int nt) {
  const int np2 = (npc + 1) / 2;
  // item l = k*np2 + pp of thread tid of nt, stepped without a division
  const int dpp = nt % np2, dk = nt / np2;
  for (int pp = tid % np2, k = tid / np2; k < nfr;) {
    const long g = g0 + (long)(f0 + k) * D + p_first + 2 * pp;
    const bool two = 2 * pp + 1 < npc;   // the pair's second phase is in
    float* d = xw + 2 * (pp * lf + k);
    if (vec && two && g >= 0 && g + 2 <= nb) {
      cp_async_8(d, buf_re + g);
      cp_async_8(d + plane, buf_im + g);
    } else {
      for (int e = 0; e < 2; ++e) {
        const bool in = (e == 0 || two) && g + e >= 0 && g + e < nb;
        cp_async_f32(d + e, buf_re + (in ? g + e : 0), in);
        cp_async_f32(d + plane + e, buf_im + (in ? g + e : 0), in);
      }
    }
    pp += dpp;
    k += dk;
    if (pp >= np2) {
      pp -= np2;
      ++k;
    }
  }
}

// Starts the copies of the B rows of blocks kbg0..kbg0+nk-1 of
// pfb_mma_chunk_tables (KBg blocks, NT n-tiles) for the group's kNT
// n-tiles into bs [2][nkb][kNT][32] uint2: 16-byte copies of contiguous
// rows (an n-tile past NT as zeros), by threads tid of nth.
template <int kNT>
__device__ __forceinline__ void pfb_mma_stage_b(
    uint2* bs, const uint2* __restrict__ btab, int KBg, int NT, int group,
    int kbg0, int nk, int nkb, int tid, int nth) {
  constexpr int kPer = kNT * 16;   // 16-byte copies of a (part, block) row
  const int n = nk * kPer;
  for (int i = tid; i < 2 * n; i += nth) {
    const int part = i / n, r = i - part * n;
    const int kb = r / kPer, e = r - kb * kPer;
    float* dst = reinterpret_cast<float*>(
        bs + (size_t)(part * nkb + kb) * kNT * 32 + 2 * e);
    if (group * kNT + e / 16 < NT)
      cp_async_16(dst, reinterpret_cast<const float*>(
                           btab + ((long)(part * KBg + kbg0 + kb) * NT +
                                   group * kNT) * 32 + 2 * e));
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The warps of pfb_front_mma_chunked in a block of kRows rows: warp w of
// either role takes m-tile pair pfb_mma_pair(w) = w % (kRows/32), and is
// the pfb_mma_share(w) = w / (kRows/32)-th of the pfb_mma_split(kRows)
// warps of its role on that pair: a consumer multiplies that share of the
// n-tiles, a producer folds the 8-lane blocks of that residue.
template <int kRows>
__device__ __forceinline__ int pfb_mma_pair(int w) {
  return pfb_mma_split(kRows) == 1 ? w : w % (kRows / 32);
}

template <int kRows>
__device__ __forceinline__ int pfb_mma_share(int w) {
  return pfb_mma_split(kRows) == 1 ? 0 : w / (kRows / 32);
}

// d += the products of 8-lane block kb of a chunk of nkb blocks, for kNw
// of the block's kNT n-tiles: the consumer warp of m-tile pair mp takes
// m-tiles 2*mp and 2*mp + 1 (rows 32*mp + 16*mt + gid and + 8) of a block
// of kRows rows, its A fragments the 16-byte words [kb][part][mt][lane] of
// the A tile `at`, its B fragments the words [part][kb][nt][lane] of bl,
// the thread's words of its n-tiles in bs [2][nkb][kNT][32]; the values
// pfb_front_mma forms in registers.
template <int kGrade, int kNT, int kNw, int kRows>
__device__ __forceinline__ void pfb_mma_block_product(float (&d)[2][kNw][4],
                                                      const uint4* at,
                                                      const uint2* bl, int kb,
                                                      int nkb, int mp,
                                                      int lane) {
  constexpr int kMt = kRows / 16;
  const uint4* af = at + ((size_t)kb * 2 * kMt + 2 * mp) * 32 + lane;
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const uint4 h = af[mt * 32];
    ah[mt][0] = h.x, ah[mt][1] = h.y, ah[mt][2] = h.z, ah[mt][3] = h.w;
    if constexpr (kGrade == kGradeBf16x3) {
      const uint4 l = af[(kMt + mt) * 32];
      al[mt][0] = l.x, al[mt][1] = l.y, al[mt][2] = l.z, al[mt][3] = l.w;
    }
  }
  uint32_t bh[kNw][2];
#pragma unroll
  for (int nt = 0; nt < kNw; ++nt) {
    const uint2 h = bl[(kb * kNT + nt) * 32];
    bh[nt][0] = h.x;
    bh[nt][1] = h.y;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      mma_bf16(d[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
  }
#pragma unroll
  for (int nt = 0; nt < kNw; ++nt) {
    const uint2 l = bl[((nkb + kb) * kNT + nt) * 32];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_bf16(d[mt][nt], ah[mt], l.x, l.y);
  }
  if constexpr (kGrade == kGradeBf16x3) {
#pragma unroll
    for (int nt = 0; nt < kNw; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma_bf16(d[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
  }
}

// d += the products of one chunk's nk blocks of 8 lanes, in ascending
// block (pfb_mma_block_product), for kNw of the block's kNT n-tiles from
// n0. Below kTile rows a warp's fewer products a block leave its fragment
// loads exposed, so it takes two blocks at once (the airband's 128-row
// block 3% faster on the H100); the 256-row block's loop is left to the
// compiler.
template <int kGrade, int kNT, int kNw, int kRows>
__device__ __forceinline__ void pfb_mma_product(float (&d)[2][kNw][4],
                                                const uint4* at,
                                                const uint2* bs, int nk,
                                                int nkb, int mp, int n0,
                                                int lane) {
  const uint2* bl = bs + n0 * 32 + lane;
  if constexpr (kRows < kTile) {
#pragma unroll 2
    for (int kb = 0; kb < nk; ++kb)
      pfb_mma_block_product<kGrade, kNT, kNw, kRows>(d, at, bl, kb, nkb, mp,
                                                     lane);
  } else {
    for (int kb = 0; kb < nk; ++kb)
      pfb_mma_block_product<kGrade, kNT, kNw, kRows>(d, at, bl, kb, nkb, mp,
                                                     lane);
  }
}

// The fold of one whole 8-lane block over a step of all kQ taps at P = 4
// (the NFM and airband grids: Q = 4): its lanes tig and tig + 4 are
// phases 2i and 2i + 1 of the window at one s, one pair, so one 8-byte
// load reads both; and a thread's rows gid + 8*j (j = 2*mt + rr) read
// frame gid + 8*j + 4*u at tap u, so 6 + kQ loads of a plane serve its
// 2*4*kQ products, where pfb_mma_fold's loop loads each; every sum is the
// same, in ascending u.
template <int kQ>
__device__ __forceinline__ void pfb_mma_fold_slide(float (&fr)[2][4],
                                                   float (&fi)[2][4],
                                                   const float* xp,
                                                   int plane,
                                                   const float* tp, int tl) {
  constexpr int kN = 6 + kQ;
  float t[2][kQ];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int u = 0; u < kQ; ++u) t[h][u] = tp[u * tl + 4 * h];
#pragma unroll
  for (int pn = 0; pn < 2; ++pn) {
    const float2* x = reinterpret_cast<const float2*>(xp + pn * plane);
    float2 w[kN];
#pragma unroll
    for (int m = 0; m < kN; ++m) w[m] = x[4 * m];   // frames 4 apart
    float(&f)[2][4] = pn ? fi : fr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float a0 = __fmul_rn(w[2 * j].x, t[0][0]);
      float a1 = __fmul_rn(w[2 * j].y, t[1][0]);
#pragma unroll
      for (int u = 1; u < kQ; ++u) {
        a0 = __fadd_rn(a0, __fmul_rn(w[2 * j + u].x, t[0][u]));
        a1 = __fadd_rn(a1, __fmul_rn(w[2 * j + u].y, t[1][u]));
      }
      f[j >> 1][j & 1] = a0;         // lane tig, q = rr
      f[j >> 1][2 + (j & 1)] = a1;   // lane tig + 4, q = 2 + rr
    }
  }
}

// Folds step s (lanes [ka, kz) of a group, fold taps u0..u1-1) into the A
// tile `at` of a block of kRows rows: the producer warp of m-tile pair mp
// and 8-lane blocks kb = kb0 mod kSplit of the step, thread (gid, tig), the
// values of lanes ka + 8*kb + tig + 4*h at rows 32*mp + 16*mt + gid + 8*rr,
// register q = 2*h + rr of m-tile mt's fragments. The window xw holds the
// step's phases pa..
// of the group from frame u0*P + s_lo in pairs (pfb_mma_stage_window, lf
// frames a pair), plane 1 `plane` words on: row r of lane (pl, s) reads
// frame r + s - s_lo + (u - u0)*P of phase pl - pa; the taps
// hs[(u - u0)*tl + kappa - ka], zeros past
// kz, where a lane folds phase pa at s_lo with zero taps (so its values,
// zeros of either sign, are those a chunked launch always gave it).
template <int kGrade, int kRows, int kSplit>
__device__ __forceinline__ void pfb_mma_fold(uint4* at, const float* xw,
                                             int plane, int lf,
                                             const float* hs, int tl, int P,
                                             int Q, const PfbSpan& sp,
                                             const PfbStep& s, int mp,
                                             int kb0, int lane) {
  constexpr int kMt = kRows / 16;
  const int gid = lane >> 2, tig = lane & 3, nu = s.u1 - s.u0;
  const float* xr = xw + 2 * (32 * mp + gid);
  for (int kb = kb0; kb < tl / 8; kb += kSplit) {
    const float* tp = hs + 8 * kb + tig;   // lane h's tap at tp[4*h]
    uint4* slot = at + ((size_t)kb * 2 * kMt + 2 * mp) * 32 + lane;
    float fr[2][4], fi[2][4];   // [mt][q]
    int u = 0;
    // the main paths' grids, a whole block of lanes: the sliding fold
    const bool slide =
        P == 4 && Q == 4 && nu == 4 && s.ka + 8 * kb + 8 <= s.kz;
    int xo[2] = {0, 0};   // lane h's word in the window, frame s - s_lo
    if (slide) {          // lanes of phases 2i and 2i + 1 at s = kappa % 4
      const int kap = s.ka + 8 * kb + tig;
      xo[0] = 2 * ((((kap >> 2) - sp.pa) >> 1) * lf + (kap & 3) - sp.s_lo);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kap = s.ka + 8 * kb + tig + 4 * h;
        const int pl = kap / P - sp.pa;
        if (kap < s.kz)
          xo[h] = 2 * ((pl >> 1) * lf + kap % P - sp.s_lo) + (pl & 1);
      }
    }
    if (slide) {
      pfb_mma_fold_slide<4>(fr, fi, xr + xo[0], plane, tp, tl);
      u = nu;
    } else if (s.u0 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float h0 = tp[4 * h];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int o = xo[h] + 2 * (16 * mt + 8 * rr);
            fr[mt][2 * h + rr] = __fmul_rn(xr[o], h0);
            fi[mt][2 * h + rr] = __fmul_rn(xr[plane + o], h0);
          }
      }
      u = 1;
    } else {   // the partials of the u-ranges before
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint4 pr = slot[mt * 32], pi = slot[(kMt + mt) * 32];
        fr[mt][0] = __uint_as_float(pr.x), fr[mt][1] = __uint_as_float(pr.y);
        fr[mt][2] = __uint_as_float(pr.z), fr[mt][3] = __uint_as_float(pr.w);
        fi[mt][0] = __uint_as_float(pi.x), fi[mt][1] = __uint_as_float(pi.y);
        fi[mt][2] = __uint_as_float(pi.z), fi[mt][3] = __uint_as_float(pi.w);
      }
    }
#pragma unroll 1
    for (; u < nu; ++u) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float hu = tp[u * tl + 4 * h];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int o = xo[h] + 2 * (16 * mt + 8 * rr + u * P);
            const int q = 2 * h + rr;
            fr[mt][q] = __fadd_rn(fr[mt][q], __fmul_rn(xr[o], hu));
            fi[mt][q] = __fadd_rn(fi[mt][q], __fmul_rn(xr[plane + o], hu));
          }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (s.u1 < Q) {   // the fold waits for the next u-range
        slot[mt * 32] = make_uint4(
            __float_as_uint(fr[mt][0]), __float_as_uint(fr[mt][1]),
            __float_as_uint(fr[mt][2]), __float_as_uint(fr[mt][3]));
        slot[(kMt + mt) * 32] = make_uint4(
            __float_as_uint(fi[mt][0]), __float_as_uint(fi[mt][1]),
            __float_as_uint(fi[mt][2]), __float_as_uint(fi[mt][3]));
        continue;
      }
      uint32_t ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float ar = fr[mt][q], ai = fi[mt][q];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(ar, ai);
        ah[q] = bf16x2_bits(hi);
        al[q] = bf16x2_bits(__floats2bfloat162_rn(
            __fsub_rn(ar, __low2float(hi)), __fsub_rn(ai, __high2float(hi))));
      }
      slot[mt * 32] = make_uint4(ah[0], ah[1], ah[2], ah[3]);
      if constexpr (kGrade == kGradeBf16x3)
        slot[(kMt + mt) * 32] = make_uint4(al[0], al[1], al[2], al[3]);
    }
  }
}

// pfb_front_mma_chunked's producers (the threads from kPfbConsumers on):
// step after step, stage the next step's taps and window and fold the
// current one into its chunk's A tile, handing each folded chunk over; in a
// block of kRows rows each warp its m-tile pair's 8-lane blocks of its
// residue (pfb_mma_pair, pfb_mma_share).
// hq: pfb_chunk_taps (Q, 8*KBg). Where kCount, each warp adds its front
// clocks and its waits for its staging and for a free A tile into clk
// (clocks.cuh).
template <int kGrade, int kRows, bool kCount = false>
__device__ __forceinline__ void pfb_mma_produce(
    uint4* a, float* stage, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb, const float* __restrict__ hq,
    int K, int Q, int D, long g0, const PfbMmaGeom& geo,
    const PfbMmaChunkGeom& g, unsigned long long* clk = nullptr) {
  constexpr int kProducers = kPfbThreads - kPfbConsumers;
  constexpr int kSplit = pfb_mma_split(kRows);
  const int P = geo.P, tq = 8 * geo.KBg, tsize = g.uc * 8 * g.nkb;
  const int tid = threadIdx.x - kPfbConsumers;
  const size_t atile = g.abytes / sizeof(uint4);
  const size_t ssize = g.sbytes / sizeof(float);
  // 8-byte copies of phase pairs where D keeps every pair's parity
  const bool vec = D % 2 == 0 &&
                   ((reinterpret_cast<uintptr_t>(buf_re) |
                     reinterpret_cast<uintptr_t>(buf_im)) & 7) == 0;
  // the window's frames of a step, and its phase stride
  auto frames = [&](const PfbStep& s, const PfbSpan& sp) {
    return (s.u1 - 1 - s.u0) * P + sp.s_hi - sp.s_lo + kRows;
  };
  // starts step s's taps and window into staging buffer sb
  auto issue = [&](const PfbStep& s, int sb) {
    const PfbSpan sp = pfb_span(P, s.ka, s.kz);
    float* st = stage + sb * ssize;
    const int tl = 8 * ((s.kz - s.ka + 7) / 8), n4 = tl / 4;
    const float* src =
        hq + (long)s.u0 * tq + 8 * (s.p0 / geo.Dc) * geo.KB0 + s.ka;
    for (int i = tid; i < (s.u1 - s.u0) * n4; i += kProducers) {
      const int u = i / n4, e = i - u * n4;
      cp_async_16(st + u * tl + 4 * e, src + (long)u * tq + 4 * e);
    }
    const int nfr = frames(s, sp), lf = pfb_mma_pair_stride(nfr);
    const int npc = sp.pb - sp.pa + 1, f0 = s.u0 * P + sp.s_lo;
    const int p_first = s.p0 + sp.pa;
    pfb_mma_stage_window(st + tsize, 2 * ((npc + 1) / 2) * lf, buf_re,
                         buf_im, nb, g0, D, f0, p_first, npc, nfr, lf,
                         vec && (g0 + (long)f0 * D + p_first) % 2 == 0, tid,
                         kProducers);
    cp_async_commit();
  };

  if constexpr (kCount) clocks::warp_open(clk, clocks::kProducerFront);
  PfbStep cur = {0, geo.Dc * P, 0, 0, 0, g.uc};
  cur.kz = min(g.L, cur.glanes);
  issue(cur, 0);
  for (int si = 0, c = 0; cur.p0 < D; ++si) {
    if constexpr (kCount) clocks::warp_open(clk, clocks::kStageWait);
    cp_async_wait<0>();
    if constexpr (kCount) clocks::warp_close(clk, clocks::kStageWait);
    named_sync(kBarProducers, kProducers);   // step si in; the other free
    PfbStep nxt = cur;
    pfb_next_step(nxt, D, P, Q, g.L, g.uc);
    if (nxt.p0 < D) issue(nxt, (si + 1) & 1);
    // chunk c's A tile: free once chunk c - 2 is multiplied
    if (cur.u0 == 0 && c >= 2) {
      if constexpr (kCount) clocks::warp_open(clk, clocks::kFreeWait);
      named_sync(kBarFree + (c & 1), kPfbThreads);
      if constexpr (kCount) clocks::warp_close(clk, clocks::kFreeWait);
    }
    const PfbSpan sp = pfb_span(P, cur.ka, cur.kz);
    const int lf = pfb_mma_pair_stride(frames(cur, sp));
    const float* st = stage + (si & 1) * ssize;
    pfb_mma_fold<kGrade, kRows, kSplit>(
        a + (c & 1) * atile, st + tsize,
        2 * ((sp.pb - sp.pa + 2) / 2) * lf, lf, st,
        8 * ((cur.kz - cur.ka + 7) / 8), P, Q, sp, cur,
        pfb_mma_pair<kRows>(tid >> 5), pfb_mma_share<kRows>(tid >> 5),
        tid & 31);
    if (cur.u1 == Q) {   // chunk c is folded: hand it over
      named_arrive(kBarFull + (c & 1), kPfbThreads);
      ++c;
    }
    cur = nxt;
  }
  if constexpr (kCount) clocks::warp_close(clk, clocks::kProducerFront);
}

// pfb_front_mma_chunked's consumers (the first kPfbConsumers threads):
// chunk after chunk, stage the next chunk's B rows and multiply the
// current one from its A tile, each warp its m-tile pair's kNw n-tiles of
// its share (pfb_mma_pair, pfb_mma_share). btab: pfb_mma_chunk_tables (2,
// KBg, NT, 32, 2). Where kCount, each warp adds its front clocks and its
// waits for a folded chunk into clk (clocks.cuh).
template <int kGrade, int kNT, int kNw, int kRows, bool kCount = false>
__device__ __forceinline__ void pfb_mma_consume(
    float (&d)[2][kNw][4], const uint4* a, uint2* bs,
    const uint2* __restrict__ btab, int NT, int Q, int D, int group,
    const PfbMmaGeom& geo, const PfbMmaChunkGeom& g,
    unsigned long long* clk = nullptr) {
  if constexpr (kCount) clocks::warp_open(clk, clocks::kConsumerFront);
  const int tid = threadIdx.x, P = geo.P;
  const size_t atile = g.abytes / sizeof(uint4);
  const size_t bsize = g.bbytes / sizeof(uint2);
  int nchunks = 0;
  for (int p0 = 0; p0 < D; p0 += geo.Dc)
    nchunks += (min(geo.Dc, D - p0) * P + g.L - 1) / g.L;
  // starts chunk s's B rows into B buffer b
  auto stage_b = [&](const PfbStep& s, int b) {
    pfb_mma_stage_b<kNT>(bs + b * bsize, btab, geo.KBg, NT, group,
                         (s.p0 / geo.Dc) * geo.KB0 + s.ka / 8,
                         (s.kz - s.ka + 7) / 8, g.nkb, tid, kPfbConsumers);
    cp_async_commit();
  };
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNw; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[mt][nt][i] = 0.f;

  PfbStep cur = {0, geo.Dc * P, 0, 0, 0, Q};
  cur.kz = min(g.L, cur.glanes);
  stage_b(cur, 0);
  for (int c = 0; c < nchunks; ++c) {
    PfbStep nxt = cur;
    pfb_next_step(nxt, D, P, Q, g.L, Q);
    cp_async_wait<0>();
    // chunk c's B in; every consumer is done with chunk c - 1's buffer
    named_sync(kBarConsumers, kPfbConsumers);
    if (c + 1 < nchunks) stage_b(nxt, (c + 1) & 1);
    if constexpr (kCount) clocks::warp_open(clk, clocks::kFullWait);
    named_sync(kBarFull + (c & 1), kPfbThreads);   // chunk c is folded
    if constexpr (kCount) clocks::warp_close(clk, clocks::kFullWait);
    pfb_mma_product<kGrade, kNT, kNw, kRows>(
        d, a + (c & 1) * atile, bs + (c & 1) * bsize,
        (cur.kz - cur.ka + 7) / 8, g.nkb, pfb_mma_pair<kRows>(tid >> 5),
        pfb_mma_share<kRows>(tid >> 5) * kNw, tid & 31);
    if (c + 2 < nchunks) named_arrive(kBarFree + (c & 1), kPfbThreads);
    cur = nxt;
  }
  if constexpr (kCount) clocks::warp_close(clk, clocks::kConsumerFront);
}

// The bf16 PFB front in chunks (above), for the 4*kNT channels of channel
// group `group`, grade kGrade, the plan (lanes, uc), and the kRows output
// rows (window start g0 + r*D) of the block (256, 128 or 64:
// pfb_mma_rows). hq: pfb_chunk_taps (Q, 8*KBg), btab: pfb_mma_chunk_tables
// (2, KBg, ceil(C/4), 32, 2), both in the chunks' lane order. Shared memory
// (pfb_mma_chunk_bytes): two A tiles, two B buffers, two staging buffers.
// Returns the kRows x (8*kNT + 1) output tile, as pfb_front_mma. Where
// kCount, the warps add their front clocks and waits into clk (clocks.cuh).
template <int kGrade, int kNT, int kRows, bool kCount = false>
__device__ __forceinline__ const float* pfb_front_mma_chunked(
    unsigned char* smem, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb, const float* __restrict__ hq,
    const uint32_t* __restrict__ btab, int C, int K, int Q, int D, int group,
    long g0, int lanes, int uc, unsigned long long* clk = nullptr) {
  static_assert(kGrade == kGradeBf16x3 || kGrade == kGradeBf16x2,
                "tensor-core grades are bf16x3 and bf16x2");
  static_assert(kPfbConsumers == kTile &&
                    kPfbThreads - kPfbConsumers == kTile,
                "8 consumer warps and 8 producer warps");
  constexpr int kSplit = pfb_mma_split(kRows);
  static_assert(kRows % 32 == 0 && kSplit >= 1 && kSplit * kRows ==
                    kPfbConsumers && kNT % kSplit == 0,
                "each m-tile pair shared by kSplit warps of each role");
  constexpr int kNw = kNT / kSplit;  // n-tiles a consumer warp multiplies
  constexpr int kOS = 8 * kNT + 1;   // output tile row stride, in floats
  const PfbMmaGeom geo = pfb_mma_geom(K, Q, D);
  const PfbMmaChunkGeom g =
      pfb_mma_chunk_geom(kNT, K, Q, D, lanes, uc, kRows);
  uint4* a = reinterpret_cast<uint4*>(smem);
  uint2* bs = reinterpret_cast<uint2*>(smem + 2 * g.abytes);
  float* stage = reinterpret_cast<float*>(smem + 2 * (g.abytes + g.bbytes));
  float* out = reinterpret_cast<float*>(smem);
  const bool consumer = threadIdx.x < kPfbConsumers;
  float d[2][kNw][4];
  if (consumer)
    pfb_mma_consume<kGrade, kNT, kNw, kRows, kCount>(
        d, a, bs, reinterpret_cast<const uint2*>(btab), (C + 3) / 4, Q, D,
        group, geo, g, clk);
  else
    pfb_mma_produce<kGrade, kRows, kCount>(a, stage, buf_re, buf_im, nb, hq,
                                           K, Q, D, g0, geo, g, clk);
  __syncthreads();   // every warp is done: the output tile reuses the space
  if (consumer) {
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
    const int n0 = pfb_mma_share<kRows>(threadIdx.x >> 5) * kNw;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = 32 * pfb_mma_pair<kRows>(threadIdx.x >> 5) + 16 * mt + gid;
#pragma unroll
      for (int nt = 0; nt < kNw; ++nt) {
        const int col = 8 * (n0 + nt) + 2 * tig;
        out[r * kOS + col] = d[mt][nt][0];
        out[r * kOS + col + 1] = d[mt][nt][1];
        out[(r + 8) * kOS + col] = d[mt][nt][2];
        out[(r + 8) * kOS + col + 1] = d[mt][nt][3];
      }
    }
  }
  __syncthreads();
  return out;
}

// ---- The dense front at f32 ----------------------------------------------
//
// toeplitz_front<kChunked, kCh, kCols> computes, for the block's kTile
// output rows (window start g0 + r*D) and its kCh channels (the 8-channel
// groups group*kCh/8 on of dense_f32_tables), per output from zero, tap
// after tap in ascending t,
//   re = fmaf(xr, gr, fmaf(-xi, gi, re)),  im = fmaf(xr, gi, fmaf(xi, gr, im)),
// (xr, xi) = x[g0 + r*D + t] and (gr, gi) the channel's tap t: one chunk
// or across chunks, the same sequence of roundings, so that every plan
// gives every output the same bits (and PR 1-3's one-thread-a-row loop
// gave the same).
//
// What bounds it: the FP32 FMAs, 8 FLOP a tap, channel and row, and the
// shared-memory loads that feed them (a warp's 16-byte broadcast takes
// four wavefronts, one a quarter-warp; its 8-byte load of 32 neighbouring
// pairs two). A thread holds a register tile of kDenseRows rows, r0 + 32*i,
// and kCols channels of one group of the table: per tap it reads its rows'
// (xr, xi) as four float2 (32 consecutive pairs a warp) and its channels'
// (gr, gi) as kCols/2 float4 broadcasts: at 8 channels 8 + 16 = 24
// wavefronts a warp for 128 FMAs, at 4 16 for 64, where one thread a row
// with 16 channels took 2 + 32 for 64. Warp w takes rows 128*(w % 2) on
// and channels kCols*(w / 2) on; the block's first
// dense_f32_threads(kCh, kCols) threads hold tiles, and any others (the
// FM chain's back end takes one thread a row and 16 channels) only stage.
// The widths trade the shared pipe against registers: 64 accumulators at
// 8 channels take ~110-125 registers, 32 at 4 ~55-65 (fm_dense_cols,
// dense_cols). Staging is asynchronous (cp.async): a chunk's taps are one
// contiguous range of the table a group, copied 16 bytes a thread, its
// window 4-byte copies of neighbouring samples by neighbouring threads,
// zero-filled outside [0, nb), the phases an odd number of pairs apart
// (dense_phase_stride). The one-chunk kernel stages all T taps and then
// multiplies; the chunked kernel stages chunk i + 1 into the other of two
// buffers while it multiplies chunk i. The tiles end in the kTile x
// (2*kCh + 1) output tile, which reuses the staging space: row r, column
// 2c (re) and 2c + 1 (im) of the block's channel c.

template <int kCols>
struct DenseTile {
  int r0, grp;   // first row; its kCols channels' place in the block
  float re[kDenseRows][kCols], im[kDenseRows][kCols];
};

template <int kCols>
__device__ __forceinline__ void dense_tile_init(DenseTile<kCols>& t) {
  static_assert(kTile == 2 * 32 * kDenseRows && (kCols == 4 || kCols == 8),
                "two warps of rows for each 4 or 8 channels");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  t.r0 = (kTile / 2) * (warp & 1) + lane;
  t.grp = warp >> 1;
#pragma unroll
  for (int i = 0; i < kDenseRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) t.re[i][c] = t.im[i][c] = 0.f;
}

// The offset of a tile's first (gr, gi) in a staging buffer's taps of Tc
// taps a group.
template <int kCols>
__device__ __forceinline__ size_t dense_tile_taps(const DenseTile<kCols>& t,
                                                  int Tc) {
  const int c = kCols * t.grp;   // the tile's first channel
  return (size_t)(c / 8) * Tc * 16 + 2 * (c % 8);
}

// t += the products of taps 0..nt-1 of a staged chunk, in ascending t: gt
// is the tile's first channel's (gr, gi) in its group's taps [Tc][8][2]
// (dense_tile_taps), xw the window [Dc][Ks] of (re, im) pairs; row r
// reads pair (t % D)*Ks + r + t/D at tap t; the loop unrolled kUnroll
// times.
template <int kCols, int kUnroll>
__device__ __forceinline__ void dense_product(DenseTile<kCols>& t,
                                              const float* gt,
                                              const float2* xw, int nt,
                                              int D, int Ks) {
  const float2* xr = xw + t.r0;
  int p = 0, q = 0;   // tap q*D + p
#pragma unroll(kUnroll)
  for (int tl = 0; tl < nt; ++tl) {
    const float2* xs = xr + p * Ks + q;
    float2 x[kDenseRows];
#pragma unroll
    for (int i = 0; i < kDenseRows; ++i) x[i] = xs[32 * i];
    const float4* g4 = reinterpret_cast<const float4*>(gt + 16 * tl);
    float gr[kCols], gi[kCols];
#pragma unroll
    for (int j = 0; j < kCols / 2; ++j) {
      const float4 g = g4[j];
      gr[2 * j] = g.x;
      gi[2 * j] = g.y;
      gr[2 * j + 1] = g.z;
      gi[2 * j + 1] = g.w;
    }
#pragma unroll
    for (int i = 0; i < kDenseRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        t.re[i][c] = fmaf(x[i].x, gr[c], fmaf(-x[i].y, gi[c], t.re[i][c]));
        t.im[i][c] = fmaf(x[i].x, gi[c], fmaf(x[i].y, gr[c], t.im[i][c]));
      }
    if (++p == D) {
      p = 0;
      ++q;
    }
  }
}

// Starts the copies of taps t0..t0+nt-1 of the block's kCh/8 groups, from
// group gb on of ftab (dense_f32_tables, (G, T, 8, 2)), into st[s][tl][8][2]
// (Tc taps a group; a group past G as zeros), and of the window of samples
// g0 + t0 + k*D + p, p < Dc, k < kTile + (Tc - 1)/D, into the (re, im)
// pairs after them, pair p*Ks + k, samples outside [0, nb) as zeros; by
// all the block's threads.
template <int kCh>
__device__ __forceinline__ void dense_stage(
    float* st, const float* __restrict__ ftab, int G, int T, int gb, int t0,
    int nt, int Tc, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb, long g0, int D, int Dc,
    int Ks) {
  constexpr int kGroups = kCh / 8;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int n4 = 4 * nt;   // 16-byte copies of a group's taps
  for (int i = tid; i < kGroups * n4; i += nth) {
    const int s = i / n4, e = i - s * n4;
    float* d = st + (size_t)s * Tc * 16 + 4 * e;
    if (gb + s < G)
      cp_async_16(d, ftab + ((size_t)(gb + s) * T + t0) * 16 + 4 * e);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float* xw = st + (size_t)kGroups * Tc * 16;
  const long gw = g0 + t0;
  const int kr = kTile + (Tc - 1) / D;
  for (int l = tid; l < Dc * kr; l += nth) {
    const int p = l % Dc, k = l / Dc;
    const long g = gw + (long)k * D + p;
    const bool in = g >= 0 && g < nb;
    float* d = xw + 2 * (p * Ks + k);
    cp_async_f32(d, buf_re + (in ? g : 0), in);
    cp_async_f32(d + 1, buf_im + (in ? g : 0), in);
  }
}

// The register tiles to the output tile at the start of dynamic shared
// memory, after every thread is done with the space; a thread that holds
// no tile only takes the barriers.
template <int kCh, int kCols>
__device__ __forceinline__ const float* dense_tile_out(
    unsigned char* smem, const DenseTile<kCols>& t, bool holds) {
  constexpr int kOS = 2 * kCh + 1;
  float* out = reinterpret_cast<float*>(smem);
  __syncthreads();
  if (holds) {
#pragma unroll
    for (int i = 0; i < kDenseRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int o = (t.r0 + 32 * i) * kOS + 2 * (kCols * t.grp + c);
        out[o] = t.re[i][c];
        out[o + 1] = t.im[i][c];
      }
  }
  __syncthreads();
  return out;
}

// Dense front at f32 for the kCh channels of channel block `group` (see
// above), in register tiles of kCols channels, the product's loop unrolled
// kUnroll times. ftab: dense_f32_tables of
// the (2C, 2, T) bank. kChunked = false: one chunk, Tc = T (>= D);
// kChunked: chunks of Tc taps (Tc < T, or T < D with Tc = T), each with
// its own window of chunk_phases(Tc, D) phases, in two staging buffers
// (toeplitz_smem_bytes). Returns the output tile; it stays valid until the
// caller's next write to dynamic shared memory.
template <bool kChunked, int kCh, int kCols, int kUnroll>
__device__ __forceinline__ const float* toeplitz_front(
    unsigned char* smem, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb, const float* __restrict__ ftab,
    int C, int T, int Tc, int D, int group, long g0) {
  static_assert(kCh % 8 == 0 && kCh % kCols == 0,
                "whole groups of 8 channels, whole tiles");
  if constexpr (!kChunked) Tc = T;
  const int Dc = chunk_phases(Tc, D), Ks = dense_phase_stride(Tc, D);
  const int G = (C + 7) / 8, gb = group * (kCh / 8);
  const size_t tsize = (size_t)(kCh / 8) * Tc * 16;   // taps of a buffer
  const size_t bsize = dense_f32_buffer_floats(kCh, Tc, D);
  float* st = reinterpret_cast<float*>(smem);
  const bool holds = threadIdx.x < dense_f32_threads(kCh, kCols);
  DenseTile<kCols> t;
  dense_tile_init(t);
  const size_t gt = dense_tile_taps(t, Tc);
  if constexpr (!kChunked) {
    dense_stage<kCh>(st, ftab, G, T, gb, 0, T, T, buf_re, buf_im, nb, g0, D,
                     Dc, Ks);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (holds)
      dense_product<kCols, kUnroll>(
          t, st + gt, reinterpret_cast<const float2*>(st + tsize), T, D, Ks);
  } else {
    const int nch = (T + Tc - 1) / Tc;
    dense_stage<kCh>(st, ftab, G, T, gb, 0, min(Tc, T), Tc, buf_re, buf_im,
                     nb, g0, D, Dc, Ks);
    cp_async_commit();
    for (int c = 0; c < nch; ++c) {
      const float* cur = st + (c & 1) * bsize;
      if (c + 1 < nch) {   // the next chunk, into the other buffer
        const int t1 = (c + 1) * Tc;
        dense_stage<kCh>(st + ((c + 1) & 1) * bsize, ftab, G, T, gb, t1,
                         min(Tc, T - t1), Tc, buf_re, buf_im, nb, g0, D, Dc,
                         Ks);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();   // chunk c is in for every thread
      if (holds)
        dense_product<kCols, kUnroll>(
            t, cur + gt, reinterpret_cast<const float2*>(cur + tsize),
            min(Tc, T - c * Tc), D, Ks);
      if (c + 2 < nch) __syncthreads();   // its buffer is free for c + 2
    }
  }
  return dense_tile_out<kCh>(smem, t, holds);
}

}  // namespace gsdr
