// Standalone complex-tap-bank channelizer for Hopper (sm_90a), at three
// grades: f32 (FP32 FMA), bf16x3 and bf16x2 (tensor cores).
//
// Replaces gsdr_tpu/kernels/channelize_pallas.py::_channelize_kernel (entry
// mix_fir_decimate_bank_pallas, whose default grade is bf16x3). Per
// decimated output j and channel c it computes the un-rotated mix + FIR +
// decimate
//   y[c, j] = sum_t x[j*D + t] * g_c[t]
// over the (2C, 2, T) bank of make_complex_tap_bank, and stores it to planar
// (C, M), M = (nb - T)/D + 1. No rotor, no state: one launch per call.
//
// The contraction is the dense front of the fused chains (fronts.cuh), not
// a second copy: the tile kernel is templated on the front and the grade
// as fm_chain.cu is, and its back end is a plain store. Only the dense
// front is instantiated. pfb_channelize reaches this kernel with the
// uniform grid written as a dense bank, 8*C*T FLOP per frame; the PFB
// front would issue 4T + 8CK (ROADMAP B4).
//
// What bounds it on the card, by grade: at f32 the dense front's FP32 FMAs,
// 8*C*T FLOP per output (2.1 GFLOP at K=32, T=256, 2^20 samples: ~32 us at
// the FP32 peak, against ~5 us of HBM traffic for the function); at bf16x3
// the same product as 3 tensor-core passes, 6.4 GFLOP, 6.5 us at 989
// TFLOP/s, and at bf16x2 4.3 us, so at both the bytes bound the function,
// and the block's own staging, which no second block hides at 134 KB of
// shared memory, holds the kernel. What
// the design does about that: at f32, the dense front's register tiles of
// 4 rows x 8 channels (4 x 4 in a block of 8) over 8, 16 or 32 channels a
// block (by C), so that
// the transmux's 32 channels stage their window once, its taps from a
// contiguous table with cp.async (fronts.cuh, toeplitz_front); at bf16x3
// and bf16x2, one mma.sync GEMM per block (toeplitz_front_mma) over up to
// 32 channels, likewise. At the transmux (K = 32, 2^20 samples) a block of
// 256 rows makes 128 blocks for 132 SMs: fewer rows a block would not
// shorten the busiest SM's share (128*k blocks of 1/k the work still put
// k on some SM), so the block keeps its 256 rows. In chunks
// (toeplitz_front_mma_chunked, double-buffered) a block takes 4-32
// channels by C and, where the grid leaves SMs idle, fewer rows
// (mma_block). The stores coalesce along j for each channel.

#include <cuda_runtime.h>

#include "fronts.cuh"

namespace {

using gsdr::kTile;

// Channels per block at the bf16 grades: 16 (4 n-tiles of 4) for a bank
// of at most 16 channels, else 32, so that the transmux's 32 channels
// stage their window once. A 32-channel block at C <= 16 multiplies 16
// zero channels and holds twice the shared memory: on the H100 it took
// 1.6-2.0x as long at K=16, C=5 and the flagship's bank
// (tools/probe_grades.py b4). C < 1 stands for any C: the wider block,
// which needs more shared memory.
inline int mma_block_channels(int C) { return C >= 1 && C <= 16 ? 16 : 32; }

// The bf16 chunked kernel's block for C channels and M outputs (M < 1:
// any M; gsdr::mma_chunk_block): 4, 8, 16 or 32 channels, 256, 128 or 64
// rows. Its rows are independent, so a large D that leaves few row tiles
// takes fewer rows a block (am_d128-like banks), and a bank of C <= 8 no
// block of 16 zero-padded channels.
inline gsdr::MmaBlock mma_block(int C, int M) {
  return gsdr::mma_chunk_block(C, M, 32, gsdr::kMmaMinRows, 0);
}

// Threads of a block at a grade for kCh channels and kRows rows: one a row
// at the bf16 grades, the f32 dense front's tile holders at f32.
template <int kGrade, int kCh, int kRows = kTile>
constexpr int tile_threads() {
  return kGrade == gsdr::kGradeF32
             ? gsdr::dense_f32_threads(kCh, gsdr::dense_cols(kCh))
             : kRows;
}

// kCh channels per block: 8, 16 or 32 at f32 (gsdr::dense_f32_channels),
// 16 or 32 at the bf16 grades in one chunk, mma_block's 4-32 in chunks;
// the dense front in chunks of Tc taps where kChunked
// (use_chunked_kernel), else all T at once; kTile rows a block but for the
// bf16 chunked kernel's kRows. ftab is dense_f32_tables' table (f32), btab
// dense_mma_tables' (bf16 grades).
template <bool kPfb, int kGrade, int kCh, bool kChunked = false,
          int kRows = kTile>
__global__ void __launch_bounds__(tile_threads<kGrade, kCh, kRows>())
channelize_tile(
    const float* __restrict__ x_re, const float* __restrict__ x_im, int nb,
    const float* __restrict__ ftab, const float* __restrict__ hp,
    const uint2* __restrict__ btab, int C, int T, int Tc, int K, int Q, int D,
    int M, float* __restrict__ y_re, float* __restrict__ y_im) {
  static_assert(kRows == kTile || (kGrade != gsdr::kGradeF32 && kChunked),
                "fewer rows only in the bf16 dense front's chunked kernel");
  extern __shared__ float4 smem4[];
  const int j0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * kCh;
  const int j = j0 + threadIdx.x;
  const long g0 = (long)j0 * D;
  static_assert(!kPfb, "B4 runs the dense front; channelize_fits refuses "
                "the PFB front, whose block takes 512 threads and 32 "
                "channels (fronts.cuh, block_threads)");
  if constexpr (kGrade == gsdr::kGradeF32) {
    // a channel's rows at a time from the front's tile, coalesced along j
    constexpr int kOS = 2 * kCh + 1;
    const float* out =
        gsdr::toeplitz_front<kChunked, kCh, gsdr::dense_cols(kCh), 1>(
            reinterpret_cast<unsigned char*>(smem4), x_re, x_im, nb, ftab, C,
            T, Tc, D, blockIdx.y, g0);
    for (int i = threadIdx.x; i < kCh * kTile; i += blockDim.x) {
      const int c = i / kTile, row = i % kTile;
      if (j0 + row < M && c0 + c < C) {
        y_re[(long)(c0 + c) * M + j0 + row] = out[row * kOS + 2 * c];
        y_im[(long)(c0 + c) * M + j0 + row] = out[row * kOS + 2 * c + 1];
      }
    }
  } else {
    float acc_re[kCh], acc_im[kCh];
    if constexpr (kChunked) {
      gsdr::toeplitz_front_mma_chunked<kGrade, kCh / 4, kRows>(
          reinterpret_cast<unsigned char*>(smem4), x_re, x_im, nb, btab, C,
          T, Tc, D, blockIdx.y, g0, acc_re, acc_im);
    } else {
      gsdr::toeplitz_front_mma<kGrade, kCh / 4>(
          reinterpret_cast<unsigned char*>(smem4), x_re, x_im, nb, btab, C,
          T, D, blockIdx.y, g0, acc_re, acc_im);
    }
    if (j >= M) return;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      if (c0 + c < C) {
        y_re[(long)(c0 + c) * M + j] = acc_re[c];
        y_im[(long)(c0 + c) * M + j] = acc_im[c];
      }
    }
  }
}

// The dense tile kernel of a grade for kCh channels and kRows rows per
// block, one chunk or chunked, and its dynamic shared memory for a chunk of
// Tc of T taps.
template <int kGrade, int kCh, bool kChunked, int kRows = kTile>
const void* dense_tile(int Tc, int T, int D, size_t* smem) {
  if constexpr (kGrade == gsdr::kGradeF32) {
    *smem = gsdr::toeplitz_smem_bytes(kCh, Tc, T, D);
  } else {
    *smem = kChunked
                ? gsdr::mma_chunked_smem_bytes(kCh / 4, kRows, Tc, T, D)
                : gsdr::mma_smem_bytes(kGrade, kCh / 4, Tc, D);
  }
  return (const void*)channelize_tile<false, kGrade, kCh, kChunked, kRows>;
}

// The bf16 chunked tile kernel of a grade for a block of kCh channels and
// kRows rows, with its dynamic shared memory for a chunk of tc of T taps.
template <int kGrade>
struct MmaTile {
  int T, D;
  size_t* smem;
  int tc;
  template <int kCh, int kRows>
  const void* run() const {
    return dense_tile<kGrade, kCh, true, kRows>(tc, T, D, smem);
  }
};

// dense_tile's chunk plan for a bank of T taps (gsdr::dense_chunk: two
// buffers, and two blocks a SM where such a chunk spans D taps), the
// one-chunk kernel of kCh channels against the chunked kernel of the block
// `mma` (at f32 the same kCh).
template <int kGrade, int kCh>
cudaError_t plan_tile(int T, int D, gsdr::MmaBlock mma, int* chunk) {
  if constexpr (kGrade == gsdr::kGradeF32) mma = gsdr::MmaBlock{kCh, kTile};
  auto chunked = [=](int tc, size_t* smem) {
    if constexpr (kGrade == gsdr::kGradeF32) {
      return dense_tile<kGrade, kCh, true>(tc, T, D, smem);
    } else {
      return gsdr::with_mma_block<32, gsdr::kMmaMinRows>(
          mma, MmaTile<kGrade>{T, D, smem, tc});
    }
  };
  size_t smem = 0;
  return gsdr::dense_chunk(
      dense_tile<kGrade, kCh, false>(T, T, D, &smem), chunked(T, &smem), T,
      [=](int tc) {
        size_t b = 0;
        if (gsdr::use_chunked_kernel(tc, T, D)) chunked(tc, &b);
        else dense_tile<kGrade, kCh, false>(tc, T, D, &b);
        return b;
      },
      chunk, D);
}

template <int kGrade, int kCh, bool kChunked, int kRows = kTile>
cudaError_t run_tile(const void* x_re, const void* x_im, const void* ftab,
                     const void* btab, void* y_re, void* y_im, int nb, int C,
                     int T, int Tc, int D, int M, cudaStream_t stream) {
  size_t smem = 0;
  const void* kernel =
      dense_tile<kGrade, kCh, kChunked, kRows>(Tc, T, D, &smem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + kRows - 1) / kRows, (C + kCh - 1) / kCh);
  channelize_tile<false, kGrade, kCh, kChunked, kRows>
      <<<grid, tile_threads<kGrade, kCh, kRows>(), smem, stream>>>(
      (const float*)x_re, (const float*)x_im, nb, (const float*)ftab, nullptr,
      (const uint2*)btab, C, T, Tc, 0, 0, D, M, (float*)y_re, (float*)y_im);
  return cudaGetLastError();
}

// run_tile of the bf16 chunked kernel of a grade for a block of kCh
// channels and kRows rows.
template <int kGrade>
struct MmaRun {
  const void *x_re, *x_im, *btab;
  void *y_re, *y_im;
  int nb, C, T, Tc, D, M;
  cudaStream_t stream;
  template <int kCh, int kRows>
  cudaError_t run() const {
    return run_tile<kGrade, kCh, true, kRows>(x_re, x_im, nullptr, btab, y_re,
                                             y_im, nb, C, T, Tc, D, M,
                                             stream);
  }
};

}  // namespace

extern "C" const char* channelize_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// plan[0] = the taps the block channelize_launch launches for C channels
// and M outputs (C < 1: any C, M < 1: any M, the widest block) and (T, D)
// at `grade` (0 f32, 2 bf16x2, 3 bf16x3) stages at once on the current
// device (gsdr::dense_chunk: T in one chunk where the whole bank fits; 0
// only where not even 8 taps fit), plan[1] and plan[2] the channels and
// rows of that block. Only the dense front is built: pfb != 0 is refused,
// as is an unknown grade. Returns 0 or the CUDA error.
extern "C" int channelize_fits(int pfb, int grade, int C, int T, int K, int Q,
                               int D, int M, int* plan) {
  (void)K;
  (void)Q;
  if (pfb || T < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const bool wide = mma_block_channels(C) == 32;
  const gsdr::MmaBlock mma = mma_block(C, M);
  cudaError_t err = cudaErrorInvalidValue;
  switch (grade) {
    case gsdr::kGradeF32:
      switch (gsdr::dense_f32_channels(C)) {
        case 8:
          err = plan_tile<gsdr::kGradeF32, 8>(T, D, mma, plan);
          break;
        case 16:
          err = plan_tile<gsdr::kGradeF32, 16>(T, D, mma, plan);
          break;
        default:
          err = plan_tile<gsdr::kGradeF32, 32>(T, D, mma, plan);
      }
      plan[1] = gsdr::dense_f32_channels(C);
      plan[2] = kTile;
      return (int)err;
    case gsdr::kGradeBf16x2:
      err = wide ? plan_tile<gsdr::kGradeBf16x2, 32>(T, D, mma, plan)
                 : plan_tile<gsdr::kGradeBf16x2, 16>(T, D, mma, plan);
      break;
    case gsdr::kGradeBf16x3:
      err = wide ? plan_tile<gsdr::kGradeBf16x3, 32>(T, D, mma, plan)
                 : plan_tile<gsdr::kGradeBf16x3, 16>(T, D, mma, plan);
      break;
    default:
      return (int)err;
  }
  const bool chunked = gsdr::use_chunked_kernel(plan[0], T, D);
  plan[1] = chunked ? mma.ch : wide ? 32 : 16;
  plan[2] = chunked ? mma.rows : kTile;
  return (int)err;
}

// Shapes: x planes (nb,), ftab dense_f32_tables' (ceil(C/8), T, 8, 2)
// float32 read at f32, btab
// dense_mma_tables' (2, ceil(T/8), ceil(C/4), 16, 2) int32 read at bf16x3
// and bf16x2, y planes (C, M) with M = (nb - T)/D + 1; grade as
// channelize_fits, Tc taps a block stages at once (channelize_fits' plan,
// or any chunk gsdr::valid_chunk takes whose block fits). Returns 0 or the
// CUDA error code.
extern "C" int channelize_launch(const void* x_re, const void* x_im,
                                 const void* ftab, const void* btab,
                                 void* y_re, void* y_im, int nb, int C, int T,
                                 int Tc, int D, int M, int grade,
                                 void* stream) {
  if (C < 1 || T < 1 || D < 1 || M < 1 || M != (nb - T) / D + 1 ||
      !gsdr::valid_chunk(Tc, T))
    return (int)cudaErrorInvalidValue;
  Tc = Tc < T ? Tc : T;
  cudaStream_t st = (cudaStream_t)stream;
  const bool wide = mma_block_channels(C) == 32;
  if (grade != gsdr::kGradeF32 && gsdr::use_chunked_kernel(Tc, T, D)) {
    const gsdr::MmaBlock b = mma_block(C, M);
    if (grade == gsdr::kGradeBf16x2)
      return (int)gsdr::with_mma_block<32, gsdr::kMmaMinRows>(
          b, MmaRun<gsdr::kGradeBf16x2>{x_re, x_im, btab, y_re, y_im, nb, C,
                                        T, Tc, D, M, st});
    if (grade == gsdr::kGradeBf16x3)
      return (int)gsdr::with_mma_block<32, gsdr::kMmaMinRows>(
          b, MmaRun<gsdr::kGradeBf16x3>{x_re, x_im, btab, y_re, y_im, nb, C,
                                        T, Tc, D, M, st});
  }
#define GSDR_TILE_AT(G, CH, CHUNKED)                                   \
  run_tile<G, CH, CHUNKED>(x_re, x_im, ftab, btab, y_re, y_im, nb, C, T, \
                           Tc, D, M, st)
#define GSDR_TILE(G, CH)                                          \
  (gsdr::use_chunked_kernel(Tc, T, D) ? GSDR_TILE_AT(G, CH, true) \
                                      : GSDR_TILE_AT(G, CH, false))
  switch (grade) {   // at the bf16 grades, the one chunk
    case gsdr::kGradeF32:
      switch (gsdr::dense_f32_channels(C)) {
        case 8:
          return (int)GSDR_TILE(gsdr::kGradeF32, 8);
        case 16:
          return (int)GSDR_TILE(gsdr::kGradeF32, 16);
      }
      return (int)GSDR_TILE(gsdr::kGradeF32, 32);
    case gsdr::kGradeBf16x2:
      return (int)(wide ? GSDR_TILE_AT(gsdr::kGradeBf16x2, 32, false)
                        : GSDR_TILE_AT(gsdr::kGradeBf16x2, 16, false));
    case gsdr::kGradeBf16x3:
      return (int)(wide ? GSDR_TILE_AT(gsdr::kGradeBf16x3, 32, false)
                        : GSDR_TILE_AT(gsdr::kGradeBf16x3, 16, false));
  }
#undef GSDR_TILE
#undef GSDR_TILE_AT
  return (int)cudaErrorInvalidValue;
}
