// QPSK256 nearest-neighbour demodulator for Hopper (sm_90a), float32.
//
// Replaces gsdr_tpu/kernels/qpsk256_pallas.py::_demod_kernel (entry
// qpsk256_demodulate_pallas). For every sample x it writes the index of
// the lowest score over the 256 points of any table
//   s_i = |c_i|^2 - 2 (c_i.re x.re + c_i.im x.im)
// (argmin_i |x - c_i|^2), the lowest index winning ties, as uint8 or int32.
//
// The candidate grid. The host (kernels/qpsk256.py::candidate_grid)
// covers the table's bounding box, plus a margin, with G x G square cells
// and keeps for each cell the ascending list of the points that can have
// the lowest float32 score anywhere in it (with its rounding); a point
// left out is farther than some kept point by more than two scores'
// rounding error everywhere in the cell. A sample inside the box scores
// only its cell's list, in ascending index, with the same score and the
// same strict <, so its decision is the exhaustive search's: every point
// of the lowest score is on the list, the lowest index first. A sample
// outside the box, or not finite, runs the exhaustive loop over all 256.
//
// Rounding: the score is fmaf(-2, fmaf(c.im, x.im, c.re * x.re), |c|^2).
// 2 * cross is exact, so only the cross term rounds differently from the
// plain version's matmul; decisions agree bit for bit except on exact
// Voronoi boundaries, where both points are nearest. |c|^2 is formed per
// block as __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)): the plain
// version's float32 re*re + im*im, bit for bit, from the same table
// planes. The cell index is (x - x0) * inv_cell in float32 with each
// operation rounded on its own; the host builds each cell's list for the
// cell widened by 1e-3 of its side, far beyond that rounding.
//
// What bounds it on the card: bytes, once the search is down to a few
// candidates: 8 B read and 1 B (or 4) written per sample, 4.7 MB at 2^19
// samples and uint8 out, 1.4 us at the HBM rate. The exhaustive search
// would be bound by its 4 FLOP per (sample, point) score, ~8 us. What the
// design does: the table (as (re, im, |c|^2, 0) float4), the cell offsets
// (uint16) and the candidate lists (uint8) sit in shared memory, 20-22 KB
// at G = 64 for the modem's tables; a sample costs a cell lookup and ~2 scores
// on average; blocks stride over the samples so the staging is paid once
// per block, and loads and stores coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPoints = 256;
constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kMaxGrid = 64;           // cells per side, at most
constexpr int kMaxCandidates = 32768;  // list entries of a grid, at most
constexpr int kBlobAlign = 16;         // the blob is copied in float4

__device__ __forceinline__ float score(float4 c, float xr, float xi) {
  return fmaf(-2.f, fmaf(c.y, xi, c.x * xr), c.z);
}

// The exhaustive search, ascending, strict <.
__device__ __forceinline__ int search_all(const float4* tab, float xr,
                                          float xi) {
  float best = score(tab[0], xr, xi);
  int idx = 0;
#pragma unroll 8
  for (int p = 1; p < kPoints; ++p) {
    const float sc = score(tab[p], xr, xi);
    if (sc < best) {
      best = sc;
      idx = p;
    }
  }
  return idx;
}

// blob: the cell offsets, (G*G + 1) uint16 (the list of cell gx*G + gy is
// entries off[cell]..off[cell+1]-1), then the uint8 point indices, padded
// to kBlobAlign bytes. G = 0: no grid, every sample searches all points.
template <typename Out>
__global__ void __launch_bounds__(kThreads) qpsk256_demod(
    const float* __restrict__ x_re, const float* __restrict__ x_im,
    const float* __restrict__ c_re, const float* __restrict__ c_im, long n,
    const float4* __restrict__ blob, int blob_words, int G, float x0,
    float y0, float inv_cell, Out* __restrict__ out) {
  extern __shared__ float4 smem[];
  float4* tab = smem;
  float4* grid = smem + kPoints;
  for (int p = threadIdx.x; p < kPoints; p += kThreads) {
    const float r = c_re[p], i = c_im[p];
    tab[p] = make_float4(r, i, __fadd_rn(__fmul_rn(r, r), __fmul_rn(i, i)),
                         0.f);
  }
  for (int w = threadIdx.x; w < blob_words; w += kThreads)
    grid[w] = __ldg(blob + w);
  __syncthreads();
  const uint16_t* off = reinterpret_cast<const uint16_t*>(grid);
  const uint8_t* cand = reinterpret_cast<const uint8_t*>(off + G * G + 1);
  const float fg = (float)G;

  const long chunk = (long)kThreads * kPerThread;
  for (long base = (long)blockIdx.x * chunk + threadIdx.x; base < n;
       base += (long)gridDim.x * chunk) {
    float xr[kPerThread], xi[kPerThread];
#pragma unroll
    for (int s = 0; s < kPerThread; ++s) {
      const long i = base + (long)s * kThreads;
      xr[s] = i < n ? x_re[i] : 0.f;
      xi[s] = i < n ? x_im[i] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < kPerThread; ++s) {
      const long i = base + (long)s * kThreads;
      if (i >= n) break;
      const float fx = __fmul_rn(__fsub_rn(xr[s], x0), inv_cell);
      const float fy = __fmul_rn(__fsub_rn(xi[s], y0), inv_cell);
      int idx;
      // false for NaN as well
      if (fx >= 0.f && fx < fg && fy >= 0.f && fy < fg) {
        const int cell = (int)fx * G + (int)fy;
        const int e = off[cell + 1];
        int j = off[cell];
        idx = cand[j];
        float best = score(tab[idx], xr[s], xi[s]);
        for (++j; j < e; ++j) {
          const int p = cand[j];
          const float sc = score(tab[p], xr[s], xi[s]);
          if (sc < best) {
            best = sc;
            idx = p;
          }
        }
      } else {
        idx = search_all(tab, xr[s], xi[s]);
      }
      out[i] = (Out)idx;
    }
  }
}

}  // namespace

extern "C" const char* qpsk256_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shapes: x planes (n,), table planes (256,), out (n,) of out_bytes (1:
// uint8, 4: int32). blob: blob_bytes (a multiple of 16) of the G x G grid
// (G = 0: none, blob unused), over the square cells of side 1/inv_cell
// from (x0, y0). max_blocks: the grid's block count at most (the blocks
// stride over the samples). Returns 0 or the CUDA error code.
extern "C" int qpsk256_launch(const void* x_re, const void* x_im,
                              const void* c_re, const void* c_im, void* out,
                              int out_bytes, long n, const void* blob,
                              int blob_bytes, int G, float x0, float y0,
                              float inv_cell, int max_blocks, void* stream) {
  if (n < 1 || (out_bytes != 1 && out_bytes != 4) || G < 0 ||
      G > kMaxGrid || blob_bytes < 0 || blob_bytes % kBlobAlign != 0 ||
      blob_bytes > 2 * (kMaxGrid * kMaxGrid + 1) + kMaxCandidates
                       + kBlobAlign ||
      (G > 0 && blob_bytes < 2 * (G * G + 1) + 1) || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const long per_block = (long)kThreads * kPerThread;
  long blocks = (n + per_block - 1) / per_block;
  if (blocks > max_blocks) blocks = max_blocks;
  const int words = G > 0 ? blob_bytes / kBlobAlign : 0;
  const size_t smem = (size_t)(kPoints + words) * sizeof(float4);
  cudaStream_t st = (cudaStream_t)stream;
  const float4* b = (const float4*)blob;
  if (out_bytes == 1)
    qpsk256_demod<uint8_t><<<(unsigned)blocks, kThreads, smem, st>>>(
        (const float*)x_re, (const float*)x_im, (const float*)c_re,
        (const float*)c_im, n, b, words, G, x0, y0, inv_cell,
        (uint8_t*)out);
  else
    qpsk256_demod<int><<<(unsigned)blocks, kThreads, smem, st>>>(
        (const float*)x_re, (const float*)x_im, (const float*)c_re,
        (const float*)c_im, n, b, words, G, x0, y0, inv_cell, (int*)out);
  return (int)cudaGetLastError();
}
