// Fused C-channel AM envelope chain for Hopper (sm_90a), at three grades of
// either front: f32 (FP32 FMA), bf16x3 and bf16x2 (tensor cores).
//
// Replaces gsdr_tpu/kernels/fm_chain_pallas.py::_am_chain_kernel with both
// of its fronts (fronts.cuh): am_chain_launch runs the dense (toeplitz)
// front (_window_dot with its grade arm), pfb_am_chain_launch the
// uniform-grid PFB front (_pfb_fold_dot with _nt_grade_dot), each at the
// grade asked for. Per decimated output j and channel c it computes
//   y[c,j]   = sum_t x[j*D + t] * g_c[t]                front
//   out[c,j] = 2 * clip(|y[c,j]|, 0, 1) - 1              envelope
// The LO rotor of the plain chain is a unit phasor and the envelope reads
// only the magnitude, so the kernel leaves the rotor out, as the TPU kernel
// does. Outputs are independent: no carries, one launch per call.
//
// What bounds it on the card: at f32 the front's FP32 FMAs, exactly as in
// the FM chain (fm_chain.cu); at bf16x3 and bf16x2 the front's product
// runs on the tensor cores at 15-22x the FP32 rate, and the function's
// bytes (the window read once, the envelopes written once) bound it. The
// envelope adds a few operations per output. What the design does about
// that: the fronts of fronts.cuh; the bf16 dense front holds 16 channels
// per block, one thread per output (in chunks 4, 8 or 16 channels by C
// and 256, 128 or 64 rows, so that a large D fills the card: am_d128's 8
// channels, 32 row tiles of 256, take 128 blocks of 64 rows and multiply
// no zero channel, mma_chunk_block); the f32 dense front 8, 16 or 32 (by
// C: am_d's 8 multiplies no zero channel) in register tiles of 4 rows x 8
// channels (4 x 4 in a block of 8: twice the warps where a large D leaves
// few blocks), a thread per tile; the PFB fronts (every
// grade) 32, handed through their shared tile to two threads per output,
// 16 channels each; the f32 fronts' tiles are read back a channel's rows
// at a time; the envelope is applied in registers and written once,
// coalesced along j.

#include <cuda_runtime.h>
#include <math.h>

#include "fronts.cuh"

namespace {

using gsdr::kCG;
using gsdr::kTile;

__device__ __forceinline__ float envelope(float re, float im) {
  const float mag = sqrtf(re * re + im * im);
  return 2.f * fminf(fmaxf(mag, 0.f), 1.f) - 1.f;
}

// Threads of a block of the front (kPfb) and grade for kCh channels and
// kRows rows a block: the PFB fronts' kPfbThreads, the bf16 dense front's
// one a row, the f32 dense front's tile holders.
template <bool kPfb, int kGrade, int kCh, int kRows = kTile>
constexpr int am_threads() {
  return kPfb                        ? gsdr::block_threads<kPfb>()
         : kGrade == gsdr::kGradeF32 ? gsdr::dense_f32_threads(
                                           kCh, gsdr::dense_cols(kCh))
                                     : kRows;
}

// The least resident blocks a SM that a tile kernel's launch bounds ask
// for: 1 for the chunked bf16 PFB front's blocks of fewer than kTile rows,
// so that ptxas gives their 512 threads the registers they need (with the
// threads alone it fit two blocks a SM, 64 registers, and spilled at 64
// rows); 0, none asked, for every other kernel.
template <bool kPfb, int kRows>
constexpr int am_min_blocks() {
  return kPfb && kRows < kTile ? 1 : 0;
}

// btab: dense_mma_tables (dense front) or pfb_mma_tables (PFB front; in
// chunks, with hp, pfb_mma_chunk_tables and pfb_chunk_taps), read
// at bf16x3 and bf16x2, and at f32 ftab, dense_f32_tables (dense front,
// kCh channels a block), or btab, pfb_f32_tables (PFB front); where
// kChunked, the dense front stages Tc taps at a time (use_chunked_kernel)
// and the PFB front chunks of Tc lanes and u-ranges of Uc fold taps
// (use_chunked_pfb), else each stages all at once. A block takes kTile
// output rows, but for the bf16 chunked kernels, which take kRows: the
// dense front's (gsdr::mma_chunk_block: 4, 8 or 16 channels and 256, 128
// or 64 rows, to fill the card where a large D leaves few blocks) and the
// PFB front's (gsdr::pfb_mma_rows: 32 channels and 256, 128 or 64 rows, to
// fill it where a short call leaves few, its 512 threads then 4 or 8 an
// output of 8 or 4 channels each).
// am_chain_tile runs it; am_chain_tile_counted, where kCount, also adds
// its front's clocks into clk (clocks.cuh).
template <bool kPfb, int kGrade, bool kChunked, int kCh, int kRows,
          bool kCount>
__device__ __forceinline__ void am_chain_run(
    const float* __restrict__ buf_re, const float* __restrict__ buf_im,
    int nb, const float* __restrict__ ftab, const float* __restrict__ hp,
    const uint2* __restrict__ btab, int C, int T, int Tc, int K, int Q, int D,
    int M, float* __restrict__ audio, int Uc, unsigned long long* clk) {
  static_assert(!kCount || (kPfb && kChunked),
                "counters in the chunked PFB front's kernel only");
  static_assert(kRows == kTile || (kGrade != gsdr::kGradeF32 && kChunked),
                "fewer rows only in the bf16 fronts' chunked kernels");
  extern __shared__ float4 smem4[];
  unsigned char* sbytes = reinterpret_cast<unsigned char*>(smem4);
  const int j0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * kCh;
  const long g0 = (long)j0 * D;
  if constexpr (kPfb) {
    // kPfbThreads / kRows threads per output row (two at kTile rows), each
    // with one group of kBe channels
    constexpr int kOS = 8 * gsdr::kPfbNT + 1;
    constexpr int kBe = gsdr::kPfbCh * kRows / gsdr::kPfbThreads;
    const float* out;
    if constexpr (kGrade == gsdr::kGradeF32 && kChunked) {
      out = gsdr::pfb_front_chunked(sbytes, buf_re, buf_im, nb, hp,
                                    reinterpret_cast<const float*>(btab), K,
                                    Q, D, blockIdx.y, g0, Tc, Uc);
    } else if constexpr (kGrade == gsdr::kGradeF32) {
      out = gsdr::pfb_front(sbytes, buf_re, buf_im, nb, hp,
                            reinterpret_cast<const float*>(btab), K, Q, D,
                            blockIdx.y, g0);
    } else if constexpr (kChunked) {
      if constexpr (kCount)
        gsdr::clocks::block_open(clk, gsdr::clocks::kFront);
      out = gsdr::pfb_front_mma_chunked<kGrade, gsdr::kPfbNT, kRows, kCount>(
          sbytes, buf_re, buf_im, nb, hp,
          reinterpret_cast<const uint32_t*>(btab), C, K, Q, D, blockIdx.y,
          g0, Tc, Uc, clk);
      if constexpr (kCount)
        gsdr::clocks::block_close(clk, gsdr::clocks::kFront);
    } else {
      out = gsdr::pfb_front_mma<kGrade, gsdr::kPfbNT>(
          sbytes, buf_re, buf_im, nb, hp,
          reinterpret_cast<const uint32_t*>(btab), C, K, Q, D, blockIdx.y,
          g0);
    }
    const int row = threadIdx.x % kRows, cl0 = threadIdx.x / kRows * kBe;
    const int j = j0 + row;
    if (j >= M) return;
#pragma unroll
    for (int c = cl0; c < cl0 + kBe; ++c) {
      if (c0 + c < C)
        audio[(long)(c0 + c) * M + j] =
            envelope(out[row * kOS + 2 * c], out[row * kOS + 2 * c + 1]);
    }
  } else if constexpr (kGrade == gsdr::kGradeF32) {
    // a channel's rows at a time from the front's tile, coalesced along j
    constexpr int kOS = 2 * kCh + 1;
    const float* out =
        gsdr::toeplitz_front<kChunked, kCh, gsdr::dense_cols(kCh), 1>(
            sbytes, buf_re, buf_im, nb, ftab, C, T, Tc, D, blockIdx.y, g0);
    for (int i = threadIdx.x; i < kCh * kTile; i += blockDim.x) {
      const int c = i / kTile, row = i % kTile, j = j0 + row;
      if (j < M && c0 + c < C)
        audio[(long)(c0 + c) * M + j] =
            envelope(out[row * kOS + 2 * c], out[row * kOS + 2 * c + 1]);
    }
  } else {
    const int j = j0 + threadIdx.x;
    float acc_re[kCh], acc_im[kCh];
    if constexpr (kChunked) {
      gsdr::toeplitz_front_mma_chunked<kGrade, kCh / 4, kRows>(
          sbytes, buf_re, buf_im, nb, btab, C, T, Tc, D, blockIdx.y, g0,
          acc_re, acc_im);
    } else {
      static_assert(kCh == kCG, "the one-chunk bf16 block: 16 channels");
      gsdr::toeplitz_front_mma<kGrade, kCG / 4>(sbytes, buf_re, buf_im, nb,
                                                btab, C, T, D, blockIdx.y, g0,
                                                acc_re, acc_im);
    }
    if (j >= M) return;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      if (c0 + c < C)
        audio[(long)(c0 + c) * M + j] = envelope(acc_re[c], acc_im[c]);
    }
  }
}

// The AM chain's tile kernel (am_chain_run, above).
template <bool kPfb, int kGrade, bool kChunked = false,
          int kCh = gsdr::block_channels<kPfb>(), int kRows = kTile>
__global__ void __launch_bounds__(am_threads<kPfb, kGrade, kCh, kRows>(),
                                  am_min_blocks<kPfb, kRows>())
am_chain_tile(
    const float* __restrict__ buf_re, const float* __restrict__ buf_im,
    int nb, const float* __restrict__ ftab, const float* __restrict__ hp,
    const uint2* __restrict__ btab, int C, int T, int Tc, int K, int Q, int D,
    int M, float* __restrict__ audio, int Uc) {
  am_chain_run<kPfb, kGrade, kChunked, kCh, kRows, false>(
      buf_re, buf_im, nb, ftab, hp, btab, C, T, Tc, K, Q, D, M, audio, Uc,
      nullptr);
}

// am_chain_tile of the chunked PFB front with its clock counters
// (clocks.cuh), added into `counters` at each block's end.
template <int kGrade, int kRows>
__global__ void __launch_bounds__(gsdr::block_threads<true>(),
                                  am_min_blocks<true, kRows>())
am_chain_tile_counted(
    const float* __restrict__ buf_re, const float* __restrict__ buf_im,
    int nb, const float* __restrict__ hp, const uint2* __restrict__ btab,
    int C, int T, int Tc, int K, int Q, int D, int M,
    float* __restrict__ audio, int Uc,
    unsigned long long* __restrict__ counters) {
  static_assert(gsdr::block_threads<true>() <= 32 * gsdr::clocks::kWarps,
                "a counter slot a warp");
  __shared__ unsigned long long clk[gsdr::clocks::kSlots];
  gsdr::clocks::block_start(clk);
  am_chain_run<true, kGrade, true, gsdr::block_channels<true>(), kRows,
               true>(buf_re, buf_im, nb, nullptr, hp, btab, C, T, Tc, K, Q,
                     D, M, audio, Uc, clk);
  gsdr::clocks::block_end(clk, counters);
}

// The dense front's tile kernel of a grade for kCh channels a block, one
// chunk or chunked (the PFB front's: gsdr::with_pfb_tile).
template <int kGrade, int kCh = kCG>
const void* front_tile(bool chunked) {
  return chunked ? (const void*)am_chain_tile<false, kGrade, true, kCh>
                 : (const void*)am_chain_tile<false, kGrade, false, kCh>;
}

// The bf16 chunked kernel's block for C channels and M outputs (M < 1:
// any M; gsdr::mma_chunk_block): 4, 8 or 16 channels, 256, 128 or 64 rows.
gsdr::MmaBlock mma_block(int C, int M) {
  return gsdr::mma_chunk_block(C, M, kCG, gsdr::kMmaMinRows, 0);
}

// The bf16 chunked tile kernel of a grade for a block of kCh channels and
// kRows rows.
template <int kGrade>
struct MmaTile {
  template <int kCh, int kRows>
  const void* run() const {
    return (const void*)am_chain_tile<false, kGrade, true, kCh, kRows>;
  }
};

// The rows of the chunked PFB block at `grade` for C channels and M
// outputs: at the bf16 grades gsdr::pfb_mma_rows (tiles that do not
// overlap), at f32 kTile.
int pfb_rows(int grade, int C, int M) {
  return grade == gsdr::kGradeF32 ? kTile : gsdr::pfb_mma_rows(C, M, 0);
}

// The tile kernel of a front (pfb) and grade with its dynamic shared memory
// for C channels and a chunk of Tc of T taps at D (dense, at f32 in blocks
// of dense_f32_channels(C), the bf16 chunked kernel in blocks of
// mma_block(C, M); `chunked` picks the kernel that walks chunks) or for
// (K, Q, D) and the plan of Tc lanes and Uc fold taps a chunk (PFB; the
// chunked kernel where use_chunked_pfb, at the bf16 grades in blocks of
// `rows` rows; every other PFB block kTile), or nullptr for a grade the
// library lacks.
const void* tile_kernel(bool pfb, int grade, int C, int T, int Tc, int K,
                        int Q, int D, size_t* smem, bool chunked = false,
                        int Uc = 0, int M = 0, int rows = kTile) {
  if (pfb) {
    const bool ch = gsdr::use_chunked_pfb(Tc, Uc, K, Q);
    switch (grade) {
      case gsdr::kGradeF32:
        *smem = ch ? gsdr::pfb_chunk_bytes(K, Q, D, Tc, Uc)
                   : gsdr::pfb_smem_bytes(K, Q, D);
        break;
      case gsdr::kGradeBf16x2:
      case gsdr::kGradeBf16x3:
        *smem = ch ? gsdr::pfb_mma_chunk_bytes(gsdr::kPfbNT, K, Q, D, Tc,
                                               Uc, rows)
                   : gsdr::pfb_mma_smem_bytes(gsdr::kPfbNT, K, Q, D);
        break;
      default:
        return nullptr;
    }
    return gsdr::with_pfb_tile(grade, ch, rows, [](auto g, auto c, auto r) {
      return (const void*)am_chain_tile<true, decltype(g)::value,
                                        decltype(c)::value, gsdr::kPfbCh,
                                        decltype(r)::value>;
    });
  }
  switch (grade) {
    case gsdr::kGradeF32: {
      const int ch = gsdr::dense_f32_channels(C);
      *smem = gsdr::toeplitz_smem_bytes(ch, Tc, T, D);
      return ch == 8    ? front_tile<gsdr::kGradeF32, 8>(chunked)
             : ch == 16 ? front_tile<gsdr::kGradeF32, 16>(chunked)
                        : front_tile<gsdr::kGradeF32, 32>(chunked);
    }
    case gsdr::kGradeBf16x2:
    case gsdr::kGradeBf16x3: {
      if (!chunked) {
        *smem = gsdr::mma_smem_bytes(grade, kCG / 4, Tc, D);
        return grade == gsdr::kGradeBf16x2
                   ? front_tile<gsdr::kGradeBf16x2>(false)
                   : front_tile<gsdr::kGradeBf16x3>(false);
      }
      const gsdr::MmaBlock b = mma_block(C, M);
      *smem = gsdr::mma_chunked_smem_bytes(b.ch / 4, b.rows, Tc, T, D);
      return grade == gsdr::kGradeBf16x2
                 ? gsdr::with_mma_block<kCG, gsdr::kMmaMinRows>(
                       b, MmaTile<gsdr::kGradeBf16x2>{})
                 : gsdr::with_mma_block<kCG, gsdr::kMmaMinRows>(
                       b, MmaTile<gsdr::kGradeBf16x3>{});
    }
  }
  return nullptr;
}

// The launch of a tile kernel (where kCount, am_chain_tile_counted's,
// adding into `counters`); returns 0 or the CUDA error.
template <bool kPfb, int kGrade, bool kChunked, int kCh, int kRows = kTile,
          bool kCount = false>
int run_am(const void* buf_re, const void* buf_im, const void* ftab,
           const void* hp, const void* btab, void* audio, int nb, int C,
           int T, int Tc, int K, int Q, int D, int M, int Uc, size_t smem,
           void* stream, void* counters = nullptr) {
  if constexpr (kCount) {
    const cudaError_t err = cudaFuncSetAttribute(
        am_chain_tile_counted<kGrade, kRows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((M + kRows - 1) / kRows, (C + kCh - 1) / kCh);
    am_chain_tile_counted<kGrade, kRows>
        <<<grid, gsdr::block_threads<true>(), smem, (cudaStream_t)stream>>>(
        (const float*)buf_re, (const float*)buf_im, nb, (const float*)hp,
        (const uint2*)btab, C, T, Tc, K, Q, D, M, (float*)audio, Uc,
        (unsigned long long*)counters);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      am_chain_tile<kPfb, kGrade, kChunked, kCh, kRows>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + kRows - 1) / kRows, (C + kCh - 1) / kCh);
  am_chain_tile<kPfb, kGrade, kChunked, kCh, kRows>
      <<<grid, am_threads<kPfb, kGrade, kCh, kRows>(), smem,
         (cudaStream_t)stream>>>(
      (const float*)buf_re, (const float*)buf_im, nb, (const float*)ftab,
      (const float*)hp, (const uint2*)btab, C, T, Tc, K, Q, D, M,
      (float*)audio, Uc);
  return (int)cudaGetLastError();
}

// run_am of the dense front's kernel, the chunked one where `chunked`.
template <int kGrade, int kCh, class... Args>
int run_front(bool chunked, Args... args) {
  if (chunked) return run_am<false, kGrade, true, kCh>(args...);
  return run_am<false, kGrade, false, kCh>(args...);
}

// run_am of the bf16 chunked kernel of a grade for a block of kCh
// channels and kRows rows.
template <int kGrade>
struct MmaRun {
  const void *buf_re, *buf_im, *btab;
  void* audio;
  int nb, C, T, Tc, D, M;
  size_t smem;
  void* stream;
  template <int kCh, int kRows>
  int run() const {
    return run_am<false, kGrade, true, kCh, kRows>(
        buf_re, buf_im, nullptr, nullptr, btab, audio, nb, C, T, Tc, 0, 0, D,
        M, 0, smem, stream);
  }
};

// One call of the front (pfb) at `grade`, its geometry checked by the
// caller; the dense front stages Tc <= T taps at a time, the PFB front
// takes the plan (Tc lanes, Uc fold taps) a chunk, whose block must fit
// the card (else too many resources, before launch), the chunked kernel at
// the bf16 grades in blocks of `rows` rows (gsdr::valid_pfb_rows; every
// other PFB block kTile). Where kCount, the counted kernel of the chunked
// PFB plan at bf16x3 (the caller checks both), adding into `counters`.
template <bool kPfb, bool kCount = false>
int run_graded(int grade, const void* buf_re, const void* buf_im,
               const void* ftab, const void* hp, const void* btab,
               void* audio, int nb, int C, int T, int Tc, int K, int Q, int D,
               int M, int Uc, void* stream, void* counters = nullptr,
               int rows = kTile) {
  static_assert(!kCount || kPfb, "counters in the PFB front's kernel only");
  size_t smem = 0;
  const bool chunked = kPfb ? gsdr::use_chunked_pfb(Tc, Uc, K, Q)
                            : gsdr::use_chunked_kernel(Tc, T, D);
  const void* kernel = tile_kernel(kPfb, grade, C, T, Tc, K, Q, D, &smem,
                                   chunked, Uc, M, rows);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if constexpr (kPfb) {
    if constexpr (kCount)   // its own static shared memory: the clocks
      kernel = gsdr::with_pfb_tile<true>(
          grade, chunked, rows, [](auto, auto, auto r) {
            return (const void*)am_chain_tile_counted<gsdr::kGradeBf16x3,
                                                      decltype(r)::value>;
          });
    int fits = 0;
    const cudaError_t err = gsdr::block_fits(kernel, smem, &fits);
    if (err != cudaSuccess) return (int)err;
    if (!fits) return (int)cudaErrorLaunchOutOfResources;
    return gsdr::with_pfb_tile<kCount>(
        grade, chunked, rows, [&](auto g, auto c, auto r) {
          return run_am<true, decltype(g)::value, decltype(c)::value,
                        gsdr::kPfbCh, decltype(r)::value, kCount>(
              buf_re, buf_im, ftab, hp, btab, audio, nb, C, T, Tc, K, Q, D,
              M, Uc, smem, stream, counters);
        });
  } else {
    if (chunked && grade != gsdr::kGradeF32) {
      const gsdr::MmaBlock b = mma_block(C, M);
      return grade == gsdr::kGradeBf16x2
                 ? gsdr::with_mma_block<kCG, gsdr::kMmaMinRows>(
                       b, MmaRun<gsdr::kGradeBf16x2>{buf_re, buf_im, btab,
                                                    audio, nb, C, T, Tc, D,
                                                    M, smem, stream})
                 : gsdr::with_mma_block<kCG, gsdr::kMmaMinRows>(
                       b, MmaRun<gsdr::kGradeBf16x3>{buf_re, buf_im, btab,
                                                    audio, nb, C, T, Tc, D,
                                                    M, smem, stream});
    }
#define GSDR_AM(G, CH)                                                       \
  run_front<G, CH>(chunked, buf_re, buf_im, ftab, hp, btab, audio, nb, C, T, \
                   Tc, K, Q, D, M, Uc, smem, stream)
    switch (grade) {
      case gsdr::kGradeBf16x2:
        return GSDR_AM(gsdr::kGradeBf16x2, kCG);
      case gsdr::kGradeBf16x3:
        return GSDR_AM(gsdr::kGradeBf16x3, kCG);
    }
    switch (gsdr::dense_f32_channels(C)) {
      case 8:
        return GSDR_AM(gsdr::kGradeF32, 8);
      case 16:
        return GSDR_AM(gsdr::kGradeF32, 16);
      default:
        return GSDR_AM(gsdr::kGradeF32, 32);
    }
#undef GSDR_AM
  }
}

}  // namespace

extern "C" const char* am_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The slots of the counted kernel's counter buffer (clocks.cuh).
extern "C" int am_chain_counter_slots() { return gsdr::clocks::kCounters; }

// The block plan of the front at `grade` (0 f32, 2 bf16x2, 3 bf16x3) on
// the current device, for any channel count C, as fm_chain_fits: the
// dense front's chunk of taps in plan[0] and its block's channels and rows
// in plan[1..2] (pfb = 0, T and D, and C and M, on which the block
// depends; 0 only where not even 8 taps fit), or the PFB front's (lanes,
// fold taps) a chunk in plan[0..1] and its block's rows in plan[2] (pfb =
// 1, K, Q and D, and C and M, on which the chunked block's rows depend;
// gsdr::pfb_chunk for a block of pfb_rows(grade, C, M) rows).
// An unknown grade is an invalid value. Returns 0 or the CUDA error.
extern "C" int am_chain_fits(int pfb, int grade, int C, int T, int K, int Q,
                             int D, int M, int* plan) {
  if (T < 1 || D < 1 || (pfb && (K < 1 || Q < 1 || K % D != 0)))
    return (int)cudaErrorInvalidValue;
  size_t smem = 0, b = 0;
  if (pfb) {
    const void* one =
        tile_kernel(true, grade, C, T, K, K, Q, D, &smem, false, Q);
    if (one == nullptr) return (int)cudaErrorInvalidValue;
    // the chunked block's rows, then its chunks for that block's bytes
    const int rows = pfb_rows(grade, C, M);
    const cudaError_t err = gsdr::pfb_chunk(
        one, smem,
        tile_kernel(true, grade, C, T, 8, K, Q, D, &b, true, 1, M, rows), K,
        Q, D,
        [=](int lanes, int uc) {
          size_t bytes = 0;
          tile_kernel(true, grade, C, T, lanes, K, Q, D, &bytes, true, uc, M,
                      rows);
          return bytes;
        },
        plan, rows);
    plan[2] = gsdr::use_chunked_pfb(plan[0], plan[1], K, Q) ? rows : kTile;
    return (int)err;
  }
  const void* one = tile_kernel(false, grade, C, T, T, 0, 0, D, &smem);
  if (one == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = gsdr::dense_chunk(
      one, tile_kernel(false, grade, C, T, T, 0, 0, D, &b, true, 0, M), T,
      [=](int tc) {
        size_t bytes = 0;
        tile_kernel(false, grade, C, T, tc, 0, 0, D, &bytes,
                    gsdr::use_chunked_kernel(tc, T, D), 0, M);
        return bytes;
      },
      plan, D);
  const bool mma = grade != gsdr::kGradeF32 &&
                   gsdr::use_chunked_kernel(plan[0], T, D);
  const gsdr::MmaBlock blk = mma_block(C, M);
  plan[1] = grade == gsdr::kGradeF32 ? gsdr::dense_f32_channels(C)
            : mma                    ? blk.ch
                                     : kCG;
  plan[2] = mma ? blk.rows : kTile;
  return (int)err;
}

// Dense front at `grade`, Tc taps a block stages at once (am_chain_fits'
// plan, or any chunk gsdr::valid_chunk takes whose block fits). Shapes:
// buf planes (nb,), ftab dense_f32_tables' (ceil(C/8), T, 8, 2) float32
// read at f32, btab dense_mma_tables' (2, ceil(T/8), ceil(C/4), 16, 2)
// int32 read at bf16x3 and bf16x2, audio (C, M) with M = (nb - T)/D + 1.
// Returns 0 or the CUDA error code.
extern "C" int am_chain_launch(const void* buf_re, const void* buf_im,
                               const void* ftab, const void* btab,
                               void* audio, int nb, int C, int T, int Tc,
                               int D, int M, int grade, void* stream) {
  if (C < 1 || T < 1 || D < 1 || M < 1 || M != (nb - T) / D + 1 ||
      !gsdr::valid_chunk(Tc, T))
    return (int)cudaErrorInvalidValue;
  return run_graded<false>(grade, buf_re, buf_im, ftab, nullptr, btab, audio,
                           nb, C, T, Tc < T ? Tc : T, 0, 0, D, M, 0, stream);
}

// PFB front at `grade`: channels on the Fs/K grid, D | K. hp (Q, K)
// polyphase taps, btab the DFT bank's table (pfb_f32_tables' (ceil(C/32),
// K, 32, 2) float32 at f32, pfb_mma_tables' (2, ceil(K/8), ceil(C/4), 16,
// 2) int32 at bf16x3 and bf16x2), T the prototype's tap count (Q*K >= T).
// (lanes, uc) is the plan (am_chain_fits', or any gsdr::valid_pfb_plan):
// (K, Q) the one-chunk kernel, else the chunked one, which at bf16x3 and
// bf16x2 reads hp and btab in its lane order (pfb_chunk_taps,
// pfb_mma_chunk_tables; as pfb_fm_chain_launch). rows: the block's output
// rows, am_chain_fits' plan[2]: kTile, or for the chunked kernel at bf16x3
// and bf16x2 any of gsdr::valid_pfb_rows (the same audio at every row
// count). counters: null, or an int64 buffer of am_chain_counter_slots()
// slots that the counted kernel adds into (clocks.cuh), which only the
// chunked plan at bf16x3 has (else an invalid value).
extern "C" int pfb_am_chain_launch(const void* buf_re, const void* buf_im,
                                   const void* hp, const void* btab,
                                   void* audio, int nb,
                                   int C, int T, int K, int Q, int D, int M,
                                   int lanes, int uc, int rows, int grade,
                                   void* stream, void* counters) {
  const bool chunked = gsdr::use_chunked_pfb(lanes, uc, K, Q);
  if (C < 1 || T < 1 || D < 1 || K < 1 || K % D != 0 || Q < 1 ||
      Q * K < T || M < 1 || M != (nb - T) / D + 1 ||
      !gsdr::valid_pfb_plan(lanes, uc, K, Q) ||
      !(rows == kTile || (chunked && grade != gsdr::kGradeF32 &&
                          gsdr::valid_pfb_rows(rows))))
    return (int)cudaErrorInvalidValue;
  if (counters != nullptr) {
    if (!chunked || grade != gsdr::kGradeBf16x3)
      return (int)cudaErrorInvalidValue;
    return run_graded<true, true>(grade, buf_re, buf_im, nullptr, hp, btab,
                                  audio, nb, C, T, lanes, K, Q, D, M, uc,
                                  stream, counters, rows);
  }
  return run_graded<true>(grade, buf_re, buf_im, nullptr, hp, btab, audio,
                          nb, C, T, lanes, K, Q, D, M, uc, stream, nullptr,
                          rows);
}
