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
//  - toeplitz_front_mma<kGrade, kNT>: the dense front on the tensor cores,
//    at the JAX package's bf16x3 (kGrade 3) or bf16x2 (kGrade 2) grade
//    (fm_chain_pallas.py, _window_dot's grade arm), and
//    toeplitz_front_mma_chunked, the same over chunks of taps. See below.
//
//  - pfb_front_mma<kGrade, kNT>: the PFB front on the tensor cores at
//    bf16x3 or bf16x2 (fm_chain_pallas.py, _pfb_fold_dot with its grade
//    arm _nt_grade_dot). See below.
//
// The f32 fronts and toeplitz_front_mma stage the block's input window in
// shared memory in polyphase order, xp[p][k] = x[g0 + k*D + p], so
// neighbouring threads (neighbouring outputs, D samples apart) read
// neighbouring words. The dense fronts walk the taps in ascending chunks
// of Tc (dense_chunk): a chunk stages its own taps and its own window,
// the min(Tc, D) phases of samples g0 + t0 + [0, (kTile-1)*D + Tc) it
// touches, and the sums carry across chunks in registers (or mma.sync
// accumulators) in the order of one pass over all T taps, so a chunked
// launch equals a one-chunk launch bit for bit. Tc = T, one chunk, where
// the whole bank and window fit the block; else the largest multiple of 8
// that does, which bounds their shared memory for any T and D. Each dense
// front is two kernels (use_chunked_kernel): a one-chunk kernel for
// Tc = T >= D, which stages every phase before its sums start, and a
// chunked kernel for Tc < T or T < D, which stages only the phases a chunk
// touches; its accumulators stay live through each chunk's staging, which
// takes more registers (B1 at bf16x3 108 against 72 on the H100), and so
// fewer blocks a SM than the one-chunk kernel needs. The PFB
// fronts stage kPhaseChunk phases at a time, which bounds their shared
// memory for any D; pfb_front_mma keeps each chunk frame-major, so that it
// stages with 16-byte copies. Tap and bank tables are read as broadcasts.
//
// What bounds the dense front on the card, by grade: in f32, the FP32
// FMAs, 8*C*T FLOP per output at 67 TFLOP/s; in bf16x3 and bf16x2, 3 or 2
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

namespace gsdr {

constexpr int kTile = 256;        // threads per block, one output each
constexpr int kCG = 16;           // channels per block (grid.y covers C)
constexpr int kPhaseChunk = 16;   // PFB front: input phases staged at once
constexpr int kPfbNT = 8;         // pfb_front_mma: n-tiles, 32 channels
constexpr int kPfbThreads = 512;  // pfb_front_mma: 16 warps of 16 rows
// Grades of the dense front: the number of tensor-core passes; 0 is the
// FP32-FMA front, toeplitz_front.
constexpr int kGradeF32 = 0;
constexpr int kGradeBf16x2 = 2;
constexpr int kGradeBf16x3 = 3;

// Phases of the window that a chunk of Tc taps touches.
__host__ __device__ inline int chunk_phases(int Tc, int D) {
  return Tc < D ? Tc : D;
}

// Dynamic shared memory of each front, in bytes; the dense fronts' for a
// chunk of Tc taps.
__host__ __device__ inline size_t toeplitz_smem_bytes(int Tc, int D) {
  const size_t kr = kTile + (Tc - 1) / D;
  return sizeof(float) * ((size_t)Tc * kCG * 2 +
                          2 * (size_t)chunk_phases(Tc, D) * kr);
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

__host__ __device__ inline size_t pfb_smem_bytes(int K, int Q, int D) {
  const size_t dc = D < kPhaseChunk ? D : kPhaseChunk;
  const size_t kr = kTile + ((size_t)Q * K - 1) / D;
  return sizeof(float) * ((size_t)K * kCG * 4 + (size_t)Q * K + 2 * dc * kr);
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
// range, every fold partial waits in a shared fold tile between ranges,
// summed in ascending u as one pass sums it. A plan (lanes >= K, uc >= Q)
// is the one-chunk kernel (pfb_front, pfb_front_mma), which stays as it
// was: the chunked kernel is another instantiation (use_chunked_pfb).
// Chunk boundaries always fall on the one-chunk kernel's 8-lane blocks,
// so a chunked launch equals the one-chunk launch bit for bit at every
// grade.
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

// The most frames a chunk of nkb blocks stages for a u-range of uc taps:
// (uc - 1)*P + the span of its lanes' s + kTile. A chunk may take the
// last lanes of one phase and the first of the next (span P - 1) unless
// the group is one phase (D = 1), whose chunks span 8*nkb - 1 at most.
__host__ __device__ inline int pfb_chunk_frames(int K, int D, int nkb,
                                                int uc) {
  const int P = K / D;
  const int span = D == 1 && 8 * nkb < P ? 8 * nkb - 1 : P - 1;
  return (uc - 1) * P + span + kTile;
}

// pfb_front_chunked's dynamic shared memory: the chunk's bank rows [L][kCG]
// as float4 (L = its lanes, at most a group's), its taps [uc][L] padded to
// 16 bytes, the fold tile [L][2][kTile] where uc < Q, then the window of
// at most Dc phases per plane.
__host__ __device__ inline size_t pfb_chunk_bytes(int K, int Q, int D,
                                                  int lanes, int uc) {
  const int dc = D < kPhaseChunk ? D : kPhaseChunk;
  const int nkb = pfb_chunk_blocks(K, D, lanes);
  const size_t L = 8 * nkb < dc * (K / D) ? 8 * nkb : dc * (K / D);
  if (uc > Q) uc = Q;
  const size_t taps = ((size_t)uc * L * sizeof(float) + 15) / 16 * 16;
  const size_t fold = uc < Q ? 2 * L * kTile * sizeof(float) : 0;
  return L * kCG * sizeof(float4) + taps + fold +
         2 * (size_t)dc * pfb_chunk_frames(K, D, nkb, uc) * sizeof(float);
}

// pfb_front_mma_chunked's dynamic shared memory: the chunk's B, hi and lo
// parts [2][nkb][nt][16] uint2, its taps [uc][8*nkb] padded to 16 bytes,
// the fold tile [nkb][8][kPfbThreads] where uc < Q (each thread's eight
// fold partials of a block), then one window buffer of Ls words a frame;
// the kTile x (8*nt + 1) output tile reuses all of it after the product.
__host__ __device__ inline size_t pfb_mma_chunk_bytes(int nt, int K, int Q,
                                                      int D, int lanes,
                                                      int uc) {
  const PfbMmaGeom g = pfb_mma_geom(K, Q, D);
  const int nkb = pfb_chunk_blocks(K, D, lanes);
  if (uc > Q) uc = Q;
  const size_t b = 2 * (size_t)nkb * nt * 16 * sizeof(uint2);
  const size_t taps = ((size_t)uc * 8 * nkb * sizeof(float) + 15) / 16 * 16;
  const size_t fold =
      uc < Q ? (size_t)nkb * 8 * kPfbThreads * sizeof(float) : 0;
  const size_t win =
      2 * (size_t)pfb_chunk_frames(K, D, nkb, uc) * g.Ls * sizeof(float);
  const size_t all = b + taps + fold + win;
  const size_t out = (size_t)kTile * (8 * nt + 1) * sizeof(float);
  return all > out ? all : out;
}

// Channels and threads per block of a tile kernel: the tensor-core PFB
// front covers 32 channels with one fold, and its block has two threads
// per output row, so that its back end takes the two groups of kCG
// channels side by side; the other fronts kCG channels, one thread a row.
template <bool kPfb, int kGrade>
__host__ __device__ constexpr int block_channels() {
  return kPfb && kGrade != kGradeF32 ? 4 * kPfbNT : kCG;
}

template <bool kPfb, int kGrade>
__host__ __device__ constexpr int block_threads() {
  return kPfb && kGrade != kGradeF32 ? kPfbThreads : kTile;
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

// The dense fronts' chunk plan: sets *chunk to the taps a block stages at
// once on the current device, T where the whole bank and window fit a
// block, else the largest multiple of 8 below T that fits, or 0 where not
// even 8 taps do; a block of either kernel of the front, `one` (one
// chunk) and `chunked`, whose static shared memory may differ. bytes(Tc)
// is the block's dynamic shared memory for a chunk of Tc taps,
// non-decreasing in Tc. Returns 0 or the CUDA error. The libraries answer
// <library>_fits with it for the dense front.
template <class Bytes>
cudaError_t dense_chunk(const void* one, const void* chunked, int T,
                        Bytes bytes, int* chunk) {
  size_t room = 0, room_chunked = 0;
  cudaError_t err = block_room(one, &room);
  if (err == cudaSuccess) err = block_room(chunked, &room_chunked);
  if (err != cudaSuccess) return err;
  if (room_chunked < room) room = room_chunked;
  if (bytes(T) <= room) {
    *chunk = T;
    return cudaSuccess;
  }
  int lo = 0, hi = (T - 1) / 8;   // chunks of 8*m taps, 1 <= m <= hi
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (bytes(8 * mid) <= room) lo = mid;
    else hi = mid - 1;
  }
  *chunk = 8 * lo;
  return cudaSuccess;
}

// The PFB fronts' chunk plan: sets plan[0..1] to (lanes, uc), the lanes a
// chunk takes and the fold taps a u-range takes, on the current device:
// (K, Q), one chunk, where the one-chunk kernel's block fits (`one`, whose
// dynamic shared memory is one_bytes); else the plan of the chunked
// kernel (`chunked`, bytes(lanes, uc) dynamic bytes) that stages the
// fewest windows: a u-range of all Q taps where its block fits at some
// chunk of lanes, else for each chunk of 8*nkb lanes (nkb <= max_blocks,
// a group's) the most taps a u-range can take, the plan with the fewest
// chunks x u-ranges, the larger chunk on a tie. (0, 0) where nothing
// fits, which does not happen for P = K/D up to a few hundred. Returns 0
// or the CUDA error. The libraries answer <library>_fits with it for the
// PFB front.
template <class Bytes>
cudaError_t pfb_chunk(const void* one, size_t one_bytes, const void* chunked,
                      int K, int Q, int D, Bytes bytes, int* plan) {
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
    if (best < 0 || cost < best) {
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

// Stages taps t0..t0+nt-1 of the dense front's f32 bank for channels
// c0..c0+kCG-1 as (re, im) pairs, taps[(t - t0)*kCG + c], and the window
// of samples g0 + t0 + k*D + p, p < Dc, k < Kr, in polyphase order
// xp[p*Kr + k] for each plane; samples outside [0, nb) as zeros.
__device__ __forceinline__ void toeplitz_stage(
    float* taps, float* xp_re, float* xp_im,
    const float* __restrict__ buf_re, const float* __restrict__ buf_im,
    int nb, const float* __restrict__ bank, int C, int T, int D, int c0,
    long g0, int t0, int nt, int Dc, int Kr) {
  const int tid = threadIdx.x;
  for (int idx = tid; idx < nt * kCG; idx += kTile) {
    const int t = t0 + idx / kCG, cg = c0 + idx % kCG;
    taps[2 * idx] = cg < C ? bank[(4L * cg) * T + t] : 0.f;           // gr
    taps[2 * idx + 1] = cg < C ? bank[(4L * cg + 2) * T + t] : 0.f;   // gi
  }
  for (int l = tid; l < Dc * Kr; l += kTile) {
    const int p = l % Dc, k = l / Dc;
    const long g = g0 + t0 + (long)k * D + p;
    const bool in = g >= 0 && g < nb;
    xp_re[p * Kr + k] = in ? buf_re[g] : 0.f;
    xp_im[p * Kr + k] = in ? buf_im[g] : 0.f;
  }
}

// acc += the products of one staged chunk of nt taps (toeplitz_stage), in
// ascending t, with fmaf.
__device__ __forceinline__ void toeplitz_product(
    const float* taps, const float* xp_re, const float* xp_im, int nt,
    int D, int Kr, float (&acc_re)[kCG], float (&acc_im)[kCG]) {
  const int tid = threadIdx.x;
  const float4* taps4 = reinterpret_cast<const float4*>(taps);
  int p = 0, q = 0;
  for (int t = 0; t < nt; ++t) {
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

// Dense front. bank: (2C, 2, T) from make_complex_tap_bank; row 4c holds
// gr_c (applied to x_re), row 4c+2 holds gi_c. Shared memory: a chunk's
// taps [Tc][kCG][2] as (re, im) pairs read as float4 broadcasts, then its
// window [Dc][Kr] for each plane, Dc = chunk_phases(Tc, D), Kr = kTile +
// (Tc - 1)/D: xp[p][k] = x[g0 + t0 + k*D + p]. Each output sums its taps
// in ascending t with fmaf. kChunked = false: one chunk, Tc = T, staged
// before the sums start, so that no accumulator is live while it stages;
// kChunked: chunks of Tc taps, the sums carried across them in registers.
template <bool kChunked>
__device__ __forceinline__ void toeplitz_front(
    float* smem, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb, const float* __restrict__ bank,
    int C, int T, int Tc, int D, int c0, long g0, float (&acc_re)[kCG],
    float (&acc_im)[kCG]) {
  if constexpr (!kChunked) Tc = T;
  const int Dc = chunk_phases(Tc, D), Kr = kTile + (Tc - 1) / D;
  float* taps = smem;
  float* xp_re = taps + Tc * kCG * 2;
  float* xp_im = xp_re + Dc * Kr;
  if constexpr (!kChunked) {
    toeplitz_stage(taps, xp_re, xp_im, buf_re, buf_im, nb, bank, C, T, D, c0,
                   g0, 0, T, Dc, Kr);
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < kCG; ++c) acc_re[c] = acc_im[c] = 0.f;
  if constexpr (!kChunked) {
    toeplitz_product(taps, xp_re, xp_im, T, D, Kr, acc_re, acc_im);
  } else {
    for (int t0 = 0; t0 < T; t0 += Tc) {
      const int nt = T - t0 < Tc ? T - t0 : Tc;
      if (t0 > 0) __syncthreads();   // the previous chunk's readers are done
      toeplitz_stage(taps, xp_re, xp_im, buf_re, buf_im, nb, bank, C, T, D,
                     c0, g0, t0, nt, Dc, Kr);
      __syncthreads();
      toeplitz_product(taps, xp_re, xp_im, nt, D, Kr, acc_re, acc_im);
    }
  }
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

// Splits one window sample (xr, xi) into bf16 hi at word s (and lo at
// bf16x3, lo_at words on).
template <int kGrade>
__device__ __forceinline__ void mma_put(uint32_t* win, int s, int lo_at,
                                        float xr, float xi) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(xr, xi);
  win[s] = bf16x2_bits(hi);
  if constexpr (kGrade == kGradeBf16x3) {
    win[lo_at + s] = bf16x2_bits(__floats2bfloat162_rn(
        xr - __low2float(hi), xi - __high2float(hi)));
  }
}

// Stages one chunk of toeplitz_front_mma: B's blocks kb0..kb0+nkb-1 of
// 8 taps for the group's n-tiles into bs [2][KBc][kNT][16] (zeros past
// nkb and NT), and the window of samples g0 + 8*kb0 + k*D + p, p < Dc,
// k < Kr, split into bf16 hi (and lo at bf16x3, Dc*Ks words on) at word
// p*Ks + k; samples outside [0, nb) as zeros. Where the chunk touches
// all D phases, sample l of the window is simply g0 + 8*kb0 + l, read in
// one contiguous sweep.
template <int kGrade, int kNT>
__device__ __forceinline__ void mma_stage(
    uint2* bs, uint32_t* win, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb,
    const uint2* __restrict__ btab, int KB, int NT, int D, int group,
    long g0, int kb0, int nkb, int KBc, int Dc, int Ks, int Kr) {
  const int tid = threadIdx.x;
  const int nbs = KBc * kNT * 16;   // uint2 per part in shared memory
  for (int i = tid; i < 2 * nbs; i += kTile) {
    const int part = i / nbs, kb = (i % nbs) / (kNT * 16);
    const int nt = (i / 16) % kNT, e = i % 16;
    const int ntg = group * kNT + nt;
    bs[i] = ntg < NT && kb < nkb
                ? btab[((long)(part * KB + kb0 + kb) * NT + ntg) * 16 + e]
                : make_uint2(0u, 0u);
  }
  const long gc = g0 + 8L * kb0;
  if (Dc == D) {
    for (int l = tid; l < D * Kr; l += kTile) {
      const long g = gc + l;
      const bool in = g >= 0 && g < nb;
      mma_put<kGrade>(win, (l % D) * Ks + l / D, D * Ks,
                      in ? buf_re[g] : 0.f, in ? buf_im[g] : 0.f);
    }
    return;
  }
  for (int l = tid; l < Dc * Kr; l += kTile) {
    const int p = l % Dc, k = l / Dc;
    const long g = gc + (long)k * D + p;
    const bool in = g >= 0 && g < nb;
    mma_put<kGrade>(win, p * Ks + k, Dc * Ks, in ? buf_re[g] : 0.f,
                    in ? buf_im[g] : 0.f);
  }
}

// d += the products of one staged chunk of nkb blocks of 8 taps
// (mma_stage), in ascending kb: warp rows r0 and r0 + 16, lane (gid, tig).
template <int kGrade, int kNT>
__device__ __forceinline__ void mma_product(
    float (&d)[2][kNT][4], const uint2* bs, const uint32_t* win,
    const int* off, int nkb, int KBc, int Dc, int Ks, int r0, int gid,
    int tig) {
  // an odd GEMM column (gi, gr) from its even neighbour (gr, -gi)
  const uint32_t sel = (gid & 1) ? 0x1032u : 0x3210u;
  const uint32_t flip = (gid & 1) ? 0x8000u : 0u;
  const uint2* bl = bs + 4 * (gid >> 1) + tig;
  const uint32_t* wl = win + Dc * Ks;   // the lo part at bf16x3
  for (int kb = 0; kb < nkb; ++kb) {
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
        al[mt][0] = wl[o0 + r];
        al[mt][1] = wl[o0 + r + 8];
        al[mt][2] = wl[o1 + r];
        al[mt][3] = wl[o1 + r + 8];
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const uint2 h = bl[(kb * kNT + nt) * 16];
      const uint2 l = bl[((KBc + kb) * kNT + nt) * 16];
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
// touches), t0 = 8*kb0; the same contract, sums and order. Shared memory:
// the chunk's B [2][KBc][kNT][16] uint2, the offsets of its taps in its
// window, off[tl] = (tl % D)*Ks + tl/D for tl < Tcp = 8*KBc, then the
// window [parts][Dc][Ks] of (re, im) bf16 pairs, Dc = chunk_phases(Tcp,
// D), word (tl % D)*Ks + r + tl/D for output row r and tap t0 + tl, i.e.
// sample g0 + t0 + r*D + tl (mma_stage). The accumulators take the blocks
// of 8 taps in ascending kb across chunks, so a chunked launch equals a
// one-chunk launch bit for bit.
template <int kGrade, int kNT>
__device__ __forceinline__ void toeplitz_front_mma_chunked(
    unsigned char* smem, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb,
    const uint2* __restrict__ btab, int C, int T, int Tc, int D, int group,
    long g0, float (&acc_re)[4 * kNT], float (&acc_im)[4 * kNT]) {
  static_assert(kGrade == kGradeBf16x3 || kGrade == kGradeBf16x2,
                "tensor-core grades are bf16x3 and bf16x2");
  constexpr int kOS = 8 * kNT + 1;   // output tile row stride, in floats
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int KB = (T + 7) / 8, NT = (C + 3) / 4;
  const int KBc = Tc >= T ? KB : Tc / 8, Tcp = 8 * KBc;
  const int Dc = chunk_phases(Tcp, D), Ks = mma_phase_stride(Tcp, D);
  const int Kr = kTile + (Tcp - 1) / D;
  uint2* bs = reinterpret_cast<uint2*>(smem);
  int* off = reinterpret_cast<int*>(bs + 2 * KBc * kNT * 16);
  uint32_t* win = reinterpret_cast<uint32_t*>(off + Tcp);
  float* out = reinterpret_cast<float*>(win);
  for (int t = tid; t < Tcp; t += kTile) off[t] = (t % D) * Ks + t / D;

  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = warp * 32 + gid;
  float d[2][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[mt][nt][i] = 0.f;

  for (int kb0 = 0; kb0 < KB; kb0 += KBc) {
    const int nkb = KB - kb0 < KBc ? KB - kb0 : KBc;
    if (kb0 > 0) __syncthreads();   // the previous chunk's readers are done
    mma_stage<kGrade, kNT>(bs, win, buf_re, buf_im, nb, btab, KB, NT, D,
                           group, g0, kb0, nkb, KBc, Dc, Ks, Kr);
    __syncthreads();
    mma_product<kGrade, kNT>(d, bs, win, off, nkb, KBc, Dc, Ks, r0, gid,
                             tig);
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

// pfb_front in chunks of `lanes` lanes and u-ranges of `uc` fold taps (the
// plan, pfb_chunk): the same contract, sums and order. A chunk takes the
// lanes kappa in [ka, kz) of its group of Dc phases (kappa = pl*P + s,
// lane v = p0 + pl + s*D) and stages their bank rows gb[kappa - ka][kCG]
// (float4, as pfb_front), their taps hs[u - u0][kappa - ka] and, per
// u-range, the window of its phases pa..pb, frames f0 + k of each plane
// at xp[pl*nfr + k], f0 = u0*P + s_lo: output row r reads frame
// r + (s - s_lo) + (u - u0)*P. Each lane's fold runs fmaf in ascending u
// from 0 as pfb_front's; between u-ranges it waits in the fold tile
// ft[kappa - ka][plane][row]; after the last, the lane's products join
// the sums in ascending kappa. So a chunked launch equals the one-chunk
// launch bit for bit.
__device__ __forceinline__ void pfb_front_chunked(
    float* smem, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb, const float* __restrict__ hp,
    const float* __restrict__ bank, int C, int K, int Q, int D, int c0,
    long g0, int lanes, int uc, float (&acc_re)[kCG],
    float (&acc_im)[kCG]) {
  const int tid = threadIdx.x;
  const int P = K / D, Dc = D < kPhaseChunk ? D : kPhaseChunk;
  const int L = min(8 * pfb_chunk_blocks(K, D, lanes), Dc * P);
  uc = min(uc, Q);
  float4* gb = reinterpret_cast<float4*>(smem);
  float* hs = smem + 4 * L * kCG;
  float* ft = hs + (uc * L + 3) / 4 * 4;
  float* xp = ft + (uc < Q ? 2 * L * kTile : 0);
#pragma unroll
  for (int c = 0; c < kCG; ++c) acc_re[c] = acc_im[c] = 0.f;
  for (int p0 = 0; p0 < D; p0 += Dc) {
    const int glanes = min(Dc, D - p0) * P;
    for (int ka = 0; ka < glanes; ka += L) {
      const int kz = min(ka + L, glanes), nl = kz - ka;
      const int pa = ka / P, pb = (kz - 1) / P, npc = pb - pa + 1;
      const int s_lo = pa == pb ? ka % P : 0;
      const int s_hi = pa == pb ? (kz - 1) % P : P - 1;
      __syncthreads();   // the previous chunk's readers are done
      for (int idx = tid; idx < nl * kCG; idx += kTile) {
        const int kap = ka + idx / kCG, cg = c0 + idx % kCG;
        const int v = p0 + kap / P + (kap % P) * D;
        float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
        if (cg < C) {
          const float* re_row = bank + (long)cg * 2 * K;
          const float* im_row = bank + (long)(C + cg) * 2 * K;
          g = make_float4(re_row[v], re_row[K + v], im_row[v], im_row[K + v]);
        }
        gb[idx] = g;
      }
      for (int u0 = 0; u0 < Q; u0 += uc) {
        const int u1 = min(Q, u0 + uc), f0 = u0 * P + s_lo;
        const int nfr = (u1 - 1 - u0) * P + s_hi - s_lo + kTile;
        if (u0 > 0) __syncthreads();   // the last u-range's readers are done
        for (int idx = tid; idx < (u1 - u0) * nl; idx += kTile) {
          const int u = u0 + idx / nl, kap = ka + idx % nl;
          hs[(u - u0) * L + kap - ka] =
              hp[(long)u * K + p0 + kap / P + (kap % P) * D];
        }
        for (int l = tid; l < npc * nfr; l += kTile) {
          const int pl = l % npc, k = l / npc;
          const long g = g0 + (long)(f0 + k) * D + p0 + pa + pl;
          const bool in = g >= 0 && g < nb;
          xp[pl * nfr + k] = in ? buf_re[g] : 0.f;
          xp[(npc + pl) * nfr + k] = in ? buf_im[g] : 0.f;
        }
        __syncthreads();
        for (int kap = ka; kap < kz; ++kap) {
          const int s = kap % P;
          const float* xr = xp + (kap / P - pa) * nfr + tid + s - s_lo;
          const float* xi = xr + npc * nfr;
          const float* h = hs + kap - ka;
          float* f = ft + (kap - ka) * 2 * kTile + tid;
          float ar = 0.f, ai = 0.f;
          if (u0 > 0) {
            ar = f[0];
            ai = f[kTile];
          }
          for (int u = 0; u < u1 - u0; ++u) {
            const float hu = h[u * L];
            ar = fmaf(hu, xr[u * P], ar);
            ai = fmaf(hu, xi[u * P], ai);
          }
          if (u1 < Q) {   // the fold waits for the next u-range
            f[0] = ar;
            f[kTile] = ai;
            continue;
          }
          const float4* g = gb + (kap - ka) * kCG;
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

// One 16-byte asynchronous copy from global to shared memory; both
// addresses 16-byte aligned.
__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
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

// pfb_front_mma in chunks of `lanes` lanes and u-ranges of `uc` fold taps
// (the plan, pfb_chunk): the same contract, values and order. A chunk is
// nk <= nkb consecutive 8-lane blocks kb0.. of group ch (lanes kappa in
// [ka, kz) of its Dc phases, as pfb_front_mma numbers them); it gathers
// their B rows into bs [2][nkb][kNT][16] as pfb_front_mma does, and per
// u-range its taps hs[u - u0][kappa - ka] and, with cp.async, the window
// of its phases pa..pb, frames f0 + k at word k*Ls + pl of each plane,
// f0 = u0*P + s_lo: output row r reads frame r + (s - s_lo) + (u - u0)*P.
// Each thread folds its fragment's lanes and rows as pfb_front_mma does,
// __fmul_rn at u = 0 and __fadd_rn(__fmul_rn) on in ascending u; between
// u-ranges its eight partials of a block wait in the fold tile
// ft[kbl][q][tid]; after the last range the whole fold is split, hi and
// lo, and multiplied. The blocks run in pfb_front_mma's order, with the
// same A and B fragments, so a chunked launch equals the one-chunk launch
// bit for bit. Returns the output tile as pfb_front_mma, at the start of
// dynamic shared memory.
template <int kGrade, int kNT>
__device__ __forceinline__ const float* pfb_front_mma_chunked(
    unsigned char* smem, const float* __restrict__ buf_re,
    const float* __restrict__ buf_im, int nb, const float* __restrict__ hp,
    const uint32_t* __restrict__ btab, int C, int K, int Q, int D, int group,
    long g0, int lanes, int uc) {
  static_assert(kGrade == kGradeBf16x3 || kGrade == kGradeBf16x2,
                "tensor-core grades are bf16x3 and bf16x2");
  static_assert(kPfbThreads == 2 * kTile, "16 warps of 16 rows");
  constexpr int kOS = 8 * kNT + 1;   // output tile row stride, in floats
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const PfbMmaGeom geo = pfb_mma_geom(K, Q, D);
  const int P = geo.P, Ls = geo.Ls, NT = (C + 3) / 4, KBt = (K + 7) / 8;
  const int nkb = pfb_chunk_blocks(K, D, lanes);
  uc = min(uc, Q);
  uint2* bs = reinterpret_cast<uint2*>(smem);
  uint32_t* bw = reinterpret_cast<uint32_t*>(bs);
  float* hs = reinterpret_cast<float*>(bs + 2 * nkb * kNT * 16);
  float* ft = hs + (uc * 8 * nkb + 3) / 4 * 4;
  float* win = ft + (uc < Q ? nkb * 8 * kPfbThreads : 0);
  float* out = reinterpret_cast<float*>(smem);
  // 16-byte copies where every frame's run of samples can be 16-byte aligned
  const bool vec_ok = D % 4 == 0 && g0 % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(buf_re) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(buf_im) % 16 == 0;

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
    const int p0 = ch * geo.Dc;
    const int glanes = min(geo.Dc, D - p0) * P, kbc = (glanes + 7) / 8;
    for (int kb0 = 0; kb0 < kbc; kb0 += nkb) {
      const int nk = min(nkb, kbc - kb0), tl = 8 * nk;
      const int ka = 8 * kb0, kz = min(ka + tl, glanes);
      const int pa = ka / P, pb = (kz - 1) / P, npc = pb - pa + 1;
      const int s_lo = pa == pb ? ka % P : 0;
      const int s_hi = pa == pb ? (kz - 1) % P : P - 1;
      __syncthreads();   // the previous chunk's readers are done
      // B in the block's lane order, as pfb_front_mma gathers it
      for (int pk = warp; pk < 2 * nk; pk += kPfbThreads / 32) {
        const int part = pk / nk, i = pk - part * nk;
        const int e = lane >> 1;
        const int kap = ka + 8 * i + (e & 3) + 4 * (lane & 1);
        const bool ok = kap < glanes;
        const int v = ok ? p0 + kap / P + (kap % P) * D : 0, vq = v & 7;
        const uint32_t* src = btab + ((long)part * KBt + (v >> 3)) * NT * 32 +
                              (4 * (e >> 2) + (vq & 3)) * 2 + (vq >> 2);
        uint32_t* dst = bw + (long)(part * nkb + i) * kNT * 32 + lane;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int ntg = group * kNT + nt;
          dst[nt * 32] = ok && ntg < NT ? src[(long)ntg * 32] : 0u;
        }
      }
      for (int u0 = 0; u0 < Q; u0 += uc) {
        const int u1 = min(Q, u0 + uc), f0 = u0 * P + s_lo;
        const int nfr = (u1 - 1 - u0) * P + s_hi - s_lo + kTile;
        if (u0 > 0) __syncthreads();   // the last u-range's readers are done
        for (int i = tid; i < (u1 - u0) * tl; i += kPfbThreads) {
          const int kap = ka + i % tl;
          hs[i] = kap < kz ? hp[(long)(u0 + i / tl) * K + p0 + kap / P +
                                (kap % P) * D]
                           : 0.f;
        }
        pfb_stage_phases(win, buf_re, buf_im, nb, g0 + (long)f0 * D, D,
                         p0 + pa, npc, nfr, Ls,
                         vec_ok && (p0 + pa) % 4 == 0 && npc % 4 == 0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        const float* xr = win + r0 * Ls;
        const float* xi = xr + nfr * Ls;
        for (int kbl = 0; kbl < nk; ++kbl) {
          // the fold of lanes kappa = ka + 8*kbl + tig (h = 0) and + 4
          // (h = 1) at rows r0 and r0 + 8 (rr); a lane past the chunk's
          // folds to zero
          int off[2];
          const float* tp[2];
          bool ok[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kap = ka + 8 * kbl + tig + 4 * h;
            ok[h] = kap < kz;
            off[h] = ok[h] ? (kap % P - s_lo) * Ls + kap / P - pa : 0;
            tp[h] = hs + (ok[h] ? kap - ka : 0);
          }
          float fr[2][2], fi[2][2];
          float* fo = ft + kbl * 8 * kPfbThreads + tid;
          const int us = P * Ls;   // one fold tap further: P frames
          int u = 0;
          if (u0 == 0) {
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
            u = 1;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              fr[q >> 1][q & 1] = fo[q * kPfbThreads];
              fi[q >> 1][q & 1] = fo[(4 + q) * kPfbThreads];
            }
          }
          for (; u < u1 - u0; ++u) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float hu = ok[h] ? tp[h][u * tl] : 0.f;
#pragma unroll
              for (int rr = 0; rr < 2; ++rr) {
                const int o = off[h] + 8 * rr * Ls + u * us;
                fr[h][rr] = __fadd_rn(fr[h][rr], __fmul_rn(xr[o], hu));
                fi[h][rr] = __fadd_rn(fi[h][rr], __fmul_rn(xi[o], hu));
              }
            }
          }
          if (u1 < Q) {   // the fold waits for the next u-range
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              fo[q * kPfbThreads] = fr[q >> 1][q & 1];
              fo[(4 + q) * kPfbThreads] = fi[q >> 1][q & 1];
            }
            continue;
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
                  __fsub_rn(ar, __low2float(hi)),
                  __fsub_rn(ai, __high2float(hi))));
            }
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const uint2 h = bl[(kbl * kNT + nt) * 16];
            const uint2 l = bl[((nkb + kbl) * kNT + nt) * 16];
            const uint32_t h0 = __byte_perm(h.x, 0u, sel) ^ flip;
            const uint32_t h1 = __byte_perm(h.y, 0u, sel) ^ flip;
            const uint32_t l0 = __byte_perm(l.x, 0u, sel) ^ flip;
            const uint32_t l1 = __byte_perm(l.y, 0u, sel) ^ flip;
            mma_bf16(d[nt], ah, h0, h1);
            mma_bf16(d[nt], ah, l0, l1);
            if constexpr (kGrade == kGradeBf16x3) mma_bf16(d[nt], al, h0, h1);
          }
        }
      }
    }
  }
  __syncthreads();   // every warp is done: the output tile reuses the space

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

}  // namespace gsdr
