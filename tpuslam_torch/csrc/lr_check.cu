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
// x - ((d + 15) >> 4) hold a winner d2 >= 0 with |d2 - d| > md16; a
// winner's d2 is its key's floor modulo 4096 (the low 12 bits).
// Arithmetic is signed 32-bit throughout: `filtered` is -16 for
// mindisp = 0, and >> of a negative value is the arithmetic shift the
// plain version uses.  The key minsad * 4096 + dv stays below 2^31 for
// K1's costs, which are at most 65535.
//
// What bounds it on this card: bytes and integer issue, about equally.
// It reads an int16 and an int32 input and writes one int16 output per
// pixel (8 bytes, ~112 MB for a 30-frame 1241x376 chunk, ~33 us at 3.35
// TB/s); the work is ~50 integer instructions per pixel, and the card
// issues integer instructions at half its f32 rate (16 lanes per clock
// per scheduler).  Design: a warp takes one image row and needs no block
// barrier; lane l takes columns l, l + 32, l + 64, ..., so that every
// load, store and shared-memory access of the warp is to 32 consecutive
// elements (coalesced, and on 32 distinct banks).  The warp loads PIX
// columns per lane of disparity and min-SAD, all independent, before
// anything waits on them, and keeps them in registers.  The row's table
// (W ints of shared memory, with kmax sentinels before and -kmin after)
// is set to +inf, __syncwarp, the scatter-min from the registers (every
// pixel offers a key, +inf where it does not participate, so no lane
// branches), __syncwarp, the winners decoded in place, __syncwarp, and the
// check.  A disparity inside [mindisp, mindisp + ndisp) * 16 (every valid
// output of K1) projects inside the 65 shifts both ways, so its check
// skips the range tests, and a projection outside the row reads a
// sentinel (-1, which never invalidates) instead of testing the bounds;
// any other disparity but `filtered` takes the general path.  A pass
// covers PIX x 32 columns (416: a row of 1241 pixels takes 3), the last
// pass's disparities staying in registers for the check; fewer registers
// per lane keep more warps resident, which the measured shapes favour
// over one pass per row.  On an H100 SXM a 30-frame 1241x376 chunk takes
// ~0.062 ms, 54 % of its byte bound.  Rows per block (warps) and columns
// per lane are measured with tools/shape_sweep.py (-DLR_ROWS, -DLR_PIX).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef LR_ROWS
#define LR_ROWS 4
#endif
#ifndef LR_PIX
#define LR_PIX 13
#endif
constexpr int ROWS = LR_ROWS, PIX = LR_PIX;
constexpr int INF = 0x7fffffff;
constexpr int SENTINEL = -1;           // a projection outside the row
constexpr int SMEM_CAP = 200 * 1024;   // shared bytes a block may take
static_assert(ROWS >= 1 && ROWS <= 32 && PIX >= 1, "block shape");

struct Params {
  int W, mindisp, ndisp, md16;
  int lpad, rpad;               // sentinels before and after the row
  long rows;                    // image rows in the tensor, B * H
};

// shared ints that a row's table takes
__host__ __device__ inline int row_words(const Params& P) {
  return P.lpad + P.W + P.rpad;
}

__global__ void __launch_bounds__(ROWS * 32)
lr_kernel(const int16_t* __restrict__ disp, const int* __restrict__ minsad,
          int16_t* __restrict__ out, Params P) {
  extern __shared__ int tables[];
  const int W = P.W, lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long row = (long)blockIdx.x * (blockDim.x >> 5) + wid;
  if (row >= P.rows) return;                  // whole warps only
  // tab[x] holds column x's winner key, then its disparity; tab[-lpad ..
  // -1] and tab[W .. W+rpad-1] hold sentinels
  int* tab = tables + wid * row_words(P) + P.lpad;
  const int16_t* rd = disp + row * W + lane;  // column lane + 32j of the row
  const int* rs = minsad + row * W + lane;
  int16_t* ro = out + row * W + lane;
  const int npass = (W + 32 * PIX - 1) / (32 * PIX);
  const int filtered = (P.mindisp - 1) * 16, base = P.mindisp * 16;
  const int min_x1 = max(P.mindisp + P.ndisp, 0);
  const int kmin = P.mindisp, kmax = P.mindisp + P.ndisp;
  const unsigned nd16 = 16u * P.ndisp;
  const unsigned cols = W > min_x1 ? (unsigned)(W - min_x1) : 0u;
  int d[PIX], ms[PIX];

  // the first pass's pixels, before anything waits on them
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const bool in = lane + 32 * j < W;
    d[j] = in ? __ldg(rd + 32 * j) : filtered;
    ms[j] = in ? __ldg(rs + 32 * j) : 0;
  }
  for (int x = lane - P.lpad; x < W + P.rpad; x += 32)
    tab[x] = x >= 0 && x < W ? INF : SENTINEL;
  __syncwarp();

  // pass 1: scatter-min of the keys onto the right-image pixels; a pixel
  // that offers nothing offers +inf to column 0
  for (int pass = 0; pass < npass; ++pass) {
    const int c0 = 32 * PIX * pass;
    if (pass > 0) {
#pragma unroll
      for (int j = 0; j < PIX; ++j) {
        const bool in = c0 + lane + 32 * j < W;
        d[j] = in ? __ldg(rd + c0 + 32 * j) : filtered;
        ms[j] = in ? __ldg(rs + c0 + 32 * j) : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      const int x = c0 + lane + 32 * j;
      const int dint = (d[j] + 8) >> 4;            // round(d/16)
      const int x2 = x - dint;
      const bool offer = (unsigned)(x - min_x1) < cols && d[j] != filtered &&
                         dint >= kmin && dint <= kmax &&
                         (unsigned)x2 < (unsigned)W;
      atomicMin(&tab[offer ? x2 : 0],
                offer ? ms[j] * 4096 + (d[j] - base) : INF);
    }
  }
  __syncwarp();
  // each winner's disparity: its key's floor modulo 4096
  for (int x = lane; x < W; x += 32) {
    const int b = tab[x];
    tab[x] = b != INF ? (b & 4095) + base : filtered;
  }
  __syncwarp();

  // pass 2: floor and ceil projections must both disagree to invalidate;
  // the last pass's disparities are still in registers
  for (int pass = npass - 1; pass >= 0; --pass) {
    const int c0 = 32 * PIX * pass;
    if (pass != npass - 1) {
#pragma unroll
      for (int j = 0; j < PIX; ++j)
        d[j] = c0 + lane + 32 * j < W ? __ldg(rd + c0 + 32 * j) : filtered;
    }
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      const int x = c0 + lane + 32 * j, dj = d[j];
      const bool part = (unsigned)(x - min_x1) < cols;
      const bool inr = (unsigned)(dj - base) < nd16;
      // inside the range both projections lie in [x - kmax, x - kmin]:
      // in the table, a sentinel outside the row
      const int df = tab[inr ? x - (dj >> 4) : 0];
      const int dc = tab[inr ? x - ((dj + 15) >> 4) : 0];
      bool bad = part && inr && df >= 0 && abs(df - dj) > P.md16 &&
                 dc >= 0 && abs(dc - dj) > P.md16;
      if (part && !inr && dj != filtered) {         // the general path
        bad = true;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int s = c ? (dj + 15) >> 4 : dj >> 4;
          const int xp = x - s;
          const bool inb = (unsigned)xp < (unsigned)W;
          int d2 = 0;                               // the reference's
          if (s >= kmin && s <= kmax) d2 = inb ? tab[xp] : filtered;
          bad = bad && inb && d2 >= 0 && abs(d2 - dj) > P.md16;
        }
      }
      if (x < W) ro[c0 + 32 * j] = (int16_t)(bad ? filtered : dj);
    }
  }
}

// rows (warps) per block: ROWS, fewer where their tables would pass
// SMEM_CAP bytes; 0 where one row's would
int rows_for(const Params& P) {
  const long cap = SMEM_CAP / (4L * row_words(P));
  return (int)(cap < ROWS ? cap : ROWS);
}

Params params(int W, int mindisp, int ndisp, int md16) {
  Params P;
  P.W = W;
  P.mindisp = mindisp;
  P.ndisp = ndisp;
  P.md16 = md16;
  P.lpad = mindisp + ndisp > 0 ? mindisp + ndisp : 0;
  P.rpad = mindisp < 0 ? -mindisp : 0;
  P.rows = 0;
  return P;
}

}  // namespace

extern "C" int tpuslam_lr_check(const void* disp, const void* minsad,
                                void* out, int B, int H, int W, int mindisp,
                                int ndisp, int md16, void* stream) {
  if (B < 1 || H < 1 || W < 1 || ndisp < 1) return -1;
  Params P = params(W, mindisp, ndisp, md16);
  const int rows = rows_for(P);
  if (rows < 1) return -1;
  const int smem = 4 * rows * row_words(P);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  P.rows = (long)B * H;
  const long blocks = (P.rows + rows - 1) / rows;
  lr_kernel<<<(unsigned)blocks, 32 * rows, smem, (cudaStream_t)stream>>>(
      (const int16_t*)disp, (const int*)minsad, (int16_t*)out, P);
  return (int)cudaGetLastError();
}

// Registers, static shared memory (and, at width W with 64 disparities
// from 0, dynamic) and local memory per thread of the kernel, its rows per
// block there, its threads per block there and its columns per lane and
// pass (out[0..5]).
extern "C" int tpuslam_lr_check_attrs(int W, int* out) {
  if (W < 1) return -1;
  const Params P = params(W, 0, 64, 16);
  const int rows = rows_for(P);
  if (rows < 1) return -1;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, lr_kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes + 4 * rows * row_words(P);
  out[2] = (int)a.localSizeBytes;
  out[3] = rows;
  out[4] = 32 * rows;
  out[5] = PIX;
  return 0;
}
