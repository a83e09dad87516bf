// Kernel K5: the StereoBM left-right check (cv::validateDisparity) on
// Hopper.
//
// Replaces the Pallas TPU kernel
//   tpuslam/kernels/stereo_bm_pallas.py:_lr_kernel (driver
//   _lr_consistency_pallas)
// and is bit-equal to the plain PyTorch version
//   tpuslam_torch/kernels/stereo_bm.py:_lr_consistency
// (itself bit-equal to tpuslam.kernels.stereo_bm._lr_consistency).  Input:
// K1's int16 disparity (x16, `filtered` = (mindisp - 1) * 16 where
// invalid) and int32 per-pixel minimum SAD, (B, H, W).  Output: the
// disparity with the inconsistent pixels set to `filtered`.
//
// A pixel x participates when it is valid and x >= mindisp + ndisp.
// Pass 1 (projection): each participating x offers the key
// minsad * 4096 + (d - mindisp * 16) to the right pixel
// x2 = x - ((d + 8) >> 4); each right pixel keeps the least key.  The TPU
// kernel computes the same minimum over 65 statically shifted slices; here
// each x does a shared-memory atomicMin.  A minimum of integers does not
// depend on the order it is taken in, so the atomics give the TPU's value.
// Two candidates for one x2 also have different round(d/16), hence
// different d and different keys (d - mindisp * 16 < 4096), so the winner
// is unique as well, as on the TPU.  Pass 2 (check): x is invalidated
// when both its floor projection x - (d >> 4) and its ceil projection
// x - ((d + 15) >> 4) hold a winner d2 >= 0 with |d2 - d| > md16.
// Arithmetic is signed 32-bit throughout: `filtered` is -16 for
// mindisp = 0, and >> of a negative value is the arithmetic shift the
// plain version uses.
//
// What bounds it on this card: bytes.  It reads an int16 and an int32
// input and writes one int16 output per pixel (8 bytes, ~112 MB for a
// 30-frame 1241x376 chunk, ~33 us at 3.35 TB/s); the work per pixel is a
// few integer ops.  The key minsad * 4096 + dv stays below 2^31: K1's
// costs are at most 65535.
// Design: one block per (frame, row), the row's disparity and the
// right-image winners in shared memory (8 bytes per column), so both
// passes touch device memory once per input and output.  A row is
// independent of every other row, so no block waits on another.  Simple
// and right first; fusing it into K1's epilogue needs whole rows in one
// K1 block, which K1's 32x8 tiles do not have.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int INF = 0x7fffffff;

__global__ void __launch_bounds__(NT)
lr_kernel(const int16_t* __restrict__ disp, const int* __restrict__ minsad,
          int16_t* __restrict__ out, int W, int mindisp, int ndisp,
          int md16) {
  extern __shared__ int sm[];
  int* best = sm;                  // right-image winner key, then disp2
  int* d_s = sm + W;               // the row's disparity
  const long base = (long)blockIdx.x * W;
  const int filtered = (mindisp - 1) * 16;
  const int min_x1 = max(mindisp + ndisp, 0);
  const int kmin = mindisp, kmax = mindisp + ndisp;

  for (int x = threadIdx.x; x < W; x += NT) {
    best[x] = INF;
    d_s[x] = (int)disp[base + x];
  }
  __syncthreads();

  // pass 1: scatter-min of the keys onto the right-image pixels
  for (int x = threadIdx.x; x < W; x += NT) {
    const int d = d_s[x];
    if (d == filtered || x < min_x1) continue;
    const int dint = (d + 8) >> 4;                 // round(d/16)
    if (dint < kmin || dint > kmax) continue;      // outside the 65 shifts
    const int x2 = x - dint;
    if (x2 < 0 || x2 >= W) continue;
    atomicMin(&best[x2], minsad[base + x] * 4096 + (d - mindisp * 16));
  }
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += NT) {
    const int b = best[x];
    int m = b % 4096;                              // floor modulo
    if (m < 0) m += 4096;
    best[x] = (b != INF) ? m + mindisp * 16 : filtered;
  }
  __syncthreads();

  // pass 2: floor and ceil projections must both disagree to invalidate
  for (int x = threadIdx.x; x < W; x += NT) {
    const int d = d_s[x];
    int res = d;
    if (d != filtered && x >= min_x1) {
      bool bad = true;
      for (int c = 0; c < 2 && bad; ++c) {
        const int s = c ? (d + 15) >> 4 : d >> 4;
        const int xp = x - s;
        const bool inb = xp >= 0 && xp < W;
        int d2 = 0;                                // the reference's default
        if (s >= kmin && s <= kmax) d2 = inb ? best[xp] : filtered;
        bad = inb && d2 >= 0 && abs(d2 - d) > md16;
      }
      if (bad) res = filtered;
    }
    out[base + x] = (int16_t)res;
  }
}

}  // namespace

extern "C" int tpuslam_lr_check(const void* disp, const void* minsad,
                                void* out, int B, int H, int W, int mindisp,
                                int ndisp, int md16, void* stream) {
  if (B < 1 || H < 1 || W < 1) return -1;
  const size_t smem = 2 * sizeof(int) * (size_t)W;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = (cudaStream_t)stream;
  lr_kernel<<<B * H, NT, smem, s>>>((const int16_t*)disp,
                                    (const int*)minsad, (int16_t*)out,
                                    W, mindisp, ndisp, md16);
  return (int)cudaGetLastError();
}
