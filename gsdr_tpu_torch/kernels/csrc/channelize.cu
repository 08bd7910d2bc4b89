// Standalone complex-tap-bank channelizer for Hopper (sm_90a), float32.
//
// Replaces gsdr_tpu/kernels/channelize_pallas.py::_channelize_kernel (entry
// mix_fir_decimate_bank_pallas). Per decimated output j and channel c it
// computes the un-rotated mix + FIR + decimate
//   y[c, j] = sum_t x[j*D + t] * g_c[t]
// over the (2C, 2, T) bank of make_complex_tap_bank, and stores it to planar
// (C, M), M = (nb - T)/D + 1. No rotor, no state: one launch per call.
//
// The contraction is the dense front of the fused chains (fronts.cuh,
// toeplitz_front), not a second copy: the tile kernel is templated on the
// front as fm_chain.cu and am_chain.cu are, and its back end is a plain
// store. Only the dense front is instantiated. pfb_channelize reaches this
// kernel with the uniform grid written as a dense bank, 8*C*T FLOP per
// frame; the PFB front would issue 4T + 8CK (ROADMAP B4).
//
// What bounds it on the card: the dense front's FP32 FMAs, 8*C*T FLOP per
// output (2.1 GFLOP at K=32, T=256, 2^20 samples: ~32 us at the FP32 peak,
// against ~5 us of HBM traffic for the function). What the design does
// about that: one thread per output with 16 channels in registers, the
// taps read as float4 shared-memory broadcasts and the window staged once
// per block in polyphase order (conflict-free for any D); the stores
// coalesce along j for each channel.

#include <cuda_runtime.h>

#include "fronts.cuh"

namespace {

using gsdr::kCG;
using gsdr::kTile;

template <bool kPfb>
__global__ void __launch_bounds__(kTile) channelize_tile(
    const float* __restrict__ x_re, const float* __restrict__ x_im, int nb,
    const float* __restrict__ bank, const float* __restrict__ hp, int C,
    int T, int K, int Q, int D, int M, float* __restrict__ y_re,
    float* __restrict__ y_im) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int j0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * kCG;
  const int j = j0 + threadIdx.x;
  const long g0 = (long)j0 * D;
  float acc_re[kCG], acc_im[kCG];
  if constexpr (kPfb) {
    gsdr::pfb_front(smem, x_re, x_im, nb, hp, bank, C, K, Q, D, c0, g0,
                    acc_re, acc_im);
  } else {
    gsdr::toeplitz_front(smem, x_re, x_im, nb, bank, C, T, D, c0, g0, acc_re,
                         acc_im);
  }
  if (j >= M) return;
#pragma unroll
  for (int c = 0; c < kCG; ++c) {
    if (c0 + c < C) {
      y_re[(long)(c0 + c) * M + j] = acc_re[c];
      y_im[(long)(c0 + c) * M + j] = acc_im[c];
    }
  }
}

}  // namespace

extern "C" const char* channelize_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// *fits = 1 when a block of the dense front for (T, D) fits the current
// device's shared memory, static plus dynamic. Only the dense front is
// built: pfb != 0 is refused. Returns 0 or the CUDA error.
extern "C" int channelize_fits(int pfb, int T, int K, int Q, int D,
                               int* fits) {
  (void)K;
  (void)Q;
  if (pfb || T < 1 || D < 1) return (int)cudaErrorInvalidValue;
  return (int)gsdr::block_fits((const void*)channelize_tile<false>,
                               gsdr::toeplitz_smem_bytes(T, D), fits);
}

// Shapes: x planes (nb,), bank (2C, 2, T), y planes (C, M) with
// M = (nb - T)/D + 1. Returns 0 or the CUDA error code.
extern "C" int channelize_launch(const void* x_re, const void* x_im,
                                 const void* bank, void* y_re, void* y_im,
                                 int nb, int C, int T, int D, int M,
                                 void* stream) {
  if (C < 1 || T < 1 || D < 1 || M < 1 || M != (nb - T) / D + 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = gsdr::toeplitz_smem_bytes(T, D);
  cudaError_t err = cudaFuncSetAttribute(
      channelize_tile<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + kTile - 1) / kTile, (C + kCG - 1) / kCG);
  channelize_tile<false><<<grid, kTile, smem, (cudaStream_t)stream>>>(
      (const float*)x_re, (const float*)x_im, nb, (const float*)bank, nullptr,
      C, T, 0, 0, D, M, (float*)y_re, (float*)y_im);
  return (int)cudaGetLastError();
}
