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
// the design does about that: at f32, one thread per output with 16
// channels in registers, the taps read as float4 shared-memory broadcasts
// and the window staged once per block in polyphase order (conflict-free
// for any D); at bf16x3 and bf16x2, one mma.sync GEMM per block
// (toeplitz_front_mma) over up to 32 channels, so that the transmux's 32
// channels stage their window once and not once per 16. The stores
// coalesce along j for each channel.

#include <cuda_runtime.h>

#include "fronts.cuh"

namespace {

using gsdr::kCG;
using gsdr::kTile;

// Channels per block at the bf16 grades: 16 (4 n-tiles of 4) for a bank
// of at most 16 channels, else 32, so that the transmux's 32 channels
// stage their window once. A 32-channel block at C <= 16 multiplies 16
// zero channels and holds twice the shared memory: on the H100 it took
// 1.6-2.0x as long at K=16, C=5 and the flagship's bank
// (tools/probe_grades.py b4). C < 1 stands for any C: the wider block,
// which needs more shared memory.
inline int mma_block_channels(int C) { return C >= 1 && C <= 16 ? 16 : 32; }

// kCh channels per block: kCG at f32, 16 or 32 at the bf16 grades.
template <bool kPfb, int kGrade, int kCh>
__global__ void __launch_bounds__(kTile) channelize_tile(
    const float* __restrict__ x_re, const float* __restrict__ x_im, int nb,
    const float* __restrict__ bank, const float* __restrict__ hp,
    const uint2* __restrict__ btab, int C, int T, int K, int Q, int D, int M,
    float* __restrict__ y_re, float* __restrict__ y_im) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int j0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * kCh;
  const int j = j0 + threadIdx.x;
  const long g0 = (long)j0 * D;
  float acc_re[kCh], acc_im[kCh];
  if constexpr (kPfb) {
    gsdr::pfb_front(smem, x_re, x_im, nb, hp, bank, C, K, Q, D, c0, g0,
                    acc_re, acc_im);
  } else if constexpr (kGrade == gsdr::kGradeF32) {
    gsdr::toeplitz_front(smem, x_re, x_im, nb, bank, C, T, D, c0, g0, acc_re,
                         acc_im);
  } else {
    gsdr::toeplitz_front_mma<kGrade, kCh / 4>(
        reinterpret_cast<unsigned char*>(smem4), x_re, x_im, nb, btab, C, T,
        D, blockIdx.y, g0, acc_re, acc_im);
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

// The dense tile kernel of a grade for kCh channels per block and its
// dynamic shared memory.
template <int kGrade, int kCh>
const void* dense_tile(int T, int D, size_t* smem) {
  *smem = kGrade == gsdr::kGradeF32
              ? gsdr::toeplitz_smem_bytes(T, D)
              : gsdr::mma_smem_bytes(kGrade, kCh / 4, T, D);
  return (const void*)channelize_tile<false, kGrade, kCh>;
}

template <int kGrade, int kCh>
cudaError_t run_tile(const void* x_re, const void* x_im, const void* bank,
                     const void* btab, void* y_re, void* y_im, int nb, int C,
                     int T, int D, int M, cudaStream_t stream) {
  size_t smem = 0;
  const void* kernel = dense_tile<kGrade, kCh>(T, D, &smem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + kTile - 1) / kTile, (C + kCh - 1) / kCh);
  channelize_tile<false, kGrade, kCh><<<grid, kTile, smem, stream>>>(
      (const float*)x_re, (const float*)x_im, nb, (const float*)bank, nullptr,
      (const uint2*)btab, C, T, 0, 0, D, M, (float*)y_re, (float*)y_im);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* channelize_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// *fits = 1 when the block channelize_launch launches for C channels (C < 1:
// any C) and (T, D) at `grade` (0 f32, 2 bf16x2, 3 bf16x3) fits the
// current device's shared memory, static plus dynamic. Only the dense
// front is built: pfb != 0 is refused, as is an unknown grade. Returns 0
// or the CUDA error.
extern "C" int channelize_fits(int pfb, int grade, int C, int T, int K, int Q,
                               int D, int* fits) {
  (void)K;
  (void)Q;
  if (pfb || T < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const bool wide = mma_block_channels(C) == 32;
  size_t smem = 0;
  const void* kernel = nullptr;
  switch (grade) {
    case gsdr::kGradeF32:
      kernel = dense_tile<gsdr::kGradeF32, kCG>(T, D, &smem);
      break;
    case gsdr::kGradeBf16x2:
      kernel = wide ? dense_tile<gsdr::kGradeBf16x2, 32>(T, D, &smem)
                    : dense_tile<gsdr::kGradeBf16x2, 16>(T, D, &smem);
      break;
    case gsdr::kGradeBf16x3:
      kernel = wide ? dense_tile<gsdr::kGradeBf16x3, 32>(T, D, &smem)
                    : dense_tile<gsdr::kGradeBf16x3, 16>(T, D, &smem);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)gsdr::block_fits(kernel, smem, fits);
}

// Shapes: x planes (nb,), bank (2C, 2, T) read at f32, btab
// dense_mma_tables' (2, ceil(T/8), ceil(C/4), 16, 2) int32 read at bf16x3
// and bf16x2, y planes (C, M) with M = (nb - T)/D + 1; grade as
// channelize_fits. Returns 0 or the CUDA error code.
extern "C" int channelize_launch(const void* x_re, const void* x_im,
                                 const void* bank, const void* btab,
                                 void* y_re, void* y_im, int nb, int C, int T,
                                 int D, int M, int grade, void* stream) {
  if (C < 1 || T < 1 || D < 1 || M < 1 || M != (nb - T) / D + 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool wide = mma_block_channels(C) == 32;
#define GSDR_TILE(G, CH) \
  run_tile<G, CH>(x_re, x_im, bank, btab, y_re, y_im, nb, C, T, D, M, st)
  switch (grade) {
    case gsdr::kGradeF32:
      return (int)GSDR_TILE(gsdr::kGradeF32, kCG);
    case gsdr::kGradeBf16x2:
      return (int)(wide ? GSDR_TILE(gsdr::kGradeBf16x2, 32)
                        : GSDR_TILE(gsdr::kGradeBf16x2, 16));
    case gsdr::kGradeBf16x3:
      return (int)(wide ? GSDR_TILE(gsdr::kGradeBf16x3, 32)
                        : GSDR_TILE(gsdr::kGradeBf16x3, 16));
  }
#undef GSDR_TILE
  return (int)cudaErrorInvalidValue;
}
