// Fused C-channel AM envelope chain for Hopper (sm_90a), float32 grade.
//
// Replaces gsdr_tpu/kernels/fm_chain_pallas.py::_am_chain_kernel with both
// of its fronts (fronts.cuh): am_chain_launch runs the dense (toeplitz)
// front, pfb_am_chain_launch the uniform-grid PFB front. Per decimated
// output j and channel c it computes
//   y[c,j]   = sum_t x[j*D + t] * g_c[t]                front
//   out[c,j] = 2 * clip(|y[c,j]|, 0, 1) - 1              envelope
// The LO rotor of the plain chain is a unit phasor and the envelope reads
// only the magnitude, so the kernel leaves the rotor out, as the TPU kernel
// does. Outputs are independent: no carries, one launch per call.
//
// What bounds it on the card: the front's FP32 FMA, exactly as in the FM
// chain (fm_chain.cu); the envelope adds a few operations per output.
// What the design does about that: the fronts of fronts.cuh, one thread
// per output and 16 channels per block in registers; the envelope is
// applied in registers and written once, coalesced along j.

#include <cuda_runtime.h>
#include <math.h>

#include "fronts.cuh"

namespace {

using gsdr::kCG;
using gsdr::kTile;

template <bool kPfb>
__global__ void __launch_bounds__(kTile) am_chain_tile(
    const float* __restrict__ buf_re, const float* __restrict__ buf_im,
    int nb, const float* __restrict__ bank, const float* __restrict__ hp,
    int C, int T, int K, int Q, int D, int M, float* __restrict__ audio) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int j0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * kCG;
  const int j = j0 + threadIdx.x;
  const long g0 = (long)j0 * D;
  float acc_re[kCG], acc_im[kCG];
  if constexpr (kPfb) {
    gsdr::pfb_front(smem, buf_re, buf_im, nb, hp, bank, C, K, Q, D, c0, g0,
                    acc_re, acc_im);
  } else {
    gsdr::toeplitz_front(smem, buf_re, buf_im, nb, bank, C, T, D, c0, g0,
                         acc_re, acc_im);
  }
  if (j >= M) return;
#pragma unroll
  for (int c = 0; c < kCG; ++c) {
    if (c0 + c < C) {
      const float mag =
          sqrtf(acc_re[c] * acc_re[c] + acc_im[c] * acc_im[c]);
      audio[(long)(c0 + c) * M + j] =
          2.f * fminf(fmaxf(mag, 0.f), 1.f) - 1.f;
    }
  }
}

template <bool kPfb>
int run_am(const void* buf_re, const void* buf_im, const void* bank,
           const void* hp, void* audio, int nb, int C, int T, int K, int Q,
           int D, int M, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      am_chain_tile<kPfb>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + kTile - 1) / kTile, (C + kCG - 1) / kCG);
  am_chain_tile<kPfb><<<grid, kTile, smem, (cudaStream_t)stream>>>(
      (const float*)buf_re, (const float*)buf_im, nb, (const float*)bank,
      (const float*)hp, C, T, K, Q, D, M, (float*)audio);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* am_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// *fits = 1 when a block of the front (pfb = 0: dense, T and D; pfb = 1:
// PFB, K, Q and D) fits the current device's shared memory, for any
// channel count C. The AM chain has the f32 grade only: any other grade is
// an invalid value. Returns 0 or the CUDA error.
extern "C" int am_chain_fits(int pfb, int grade, int C, int T, int K, int Q,
                             int D, int* fits) {
  (void)C;
  if (grade != gsdr::kGradeF32 || T < 1 || D < 1 || (pfb && (K < 1 || Q < 1)))
    return (int)cudaErrorInvalidValue;
  return pfb ? (int)gsdr::block_fits((const void*)am_chain_tile<true>,
                                     gsdr::pfb_smem_bytes(K, Q, D), fits)
             : (int)gsdr::block_fits((const void*)am_chain_tile<false>,
                                     gsdr::toeplitz_smem_bytes(T, D), fits);
}

// Dense front. Shapes: buf planes (nb,), bank (2C, 2, T), audio (C, M) with
// M = (nb - T)/D + 1. Returns 0 or the CUDA error code.
extern "C" int am_chain_launch(const void* buf_re, const void* buf_im,
                               const void* bank, void* audio, int nb, int C,
                               int T, int D, int M, void* stream) {
  if (C < 1 || T < 1 || D < 1 || M < 1 || M != (nb - T) / D + 1)
    return (int)cudaErrorInvalidValue;
  return run_am<false>(buf_re, buf_im, bank, nullptr, audio, nb, C, T, 0, 0,
                       D, M, gsdr::toeplitz_smem_bytes(T, D), stream);
}

// PFB front: channels on the Fs/K grid, D | K. hp (Q, K) polyphase taps,
// bank planes-major (2C, 2K), T the prototype's tap count (Q*K >= T).
extern "C" int pfb_am_chain_launch(const void* buf_re, const void* buf_im,
                                   const void* hp, const void* bank,
                                   void* audio, int nb, int C, int T, int K,
                                   int Q, int D, int M, void* stream) {
  if (C < 1 || T < 1 || D < 1 || K < 1 || K % D != 0 || Q < 1 ||
      Q * K < T || M < 1 || M != (nb - T) / D + 1)
    return (int)cudaErrorInvalidValue;
  return run_am<true>(buf_re, buf_im, bank, hp, audio, nb, C, T, K, Q, D, M,
                      gsdr::pfb_smem_bytes(K, Q, D), stream);
}
