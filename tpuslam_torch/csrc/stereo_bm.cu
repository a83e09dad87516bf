// Kernel K1: dense SAD block-matching disparity (StereoBM) on Hopper.
//
// Replaces the Pallas TPU kernel
//   tpuslam/kernels/stereo_bm_pallas.py:_bm_strip_kernel
// and is bit-equal to the plain PyTorch version
//   tpuslam_torch/kernels/stereo_bm.py:stereo_bm_plain
// (itself bit-equal to tpuslam.kernels.stereo_bm.stereo_bm, the XLA twin
// of the Pallas kernel): X-Sobel prefilter capped at ftzero with
// reflect-101 rows and columns 0 and W-1 forced to ftzero; SAD over 64
// disparities with a (2r+1)^2 box, zero outside the image and zero right
// pixels for x < d; the winner is the first minimum in OpenCV's reversed
// order j = 63 - d (ties go to the larger disparity); uniqueness and
// texture gates; x16 subpixel with C's truncating division;
// (mindisp - 1) * 16 at invalid pixels.  Also writes the per-pixel
// minimum SAD (int32, as the reference keeps it), which the left-right
// check consumes.
//
// What bounds it on this card: instruction issue, not memory.  The two
// prefiltered images (1 byte/pixel) are read once per tile and stay in
// shared memory; the time goes to the box passes' shared-memory taps.
//
// Design: launch 1 prefilters both images into uint8 scratch.  Launch 2
// gives each block a 32x8 output tile of one frame; the block stages the
// left tile with its box halo and the right tile with halo plus the 63
// extra columns the shifts reach.  Then, for the 65 planes (the texture
// image |L - ftzero|, then |L - R_d| for each disparity), GP = 4 planes
// at a time:
// - the vertical pass: one thread per (plane, staged column) forms the
//   column's 8 vertical (2r+1)-row sums as a running sum, 2r+1 terms for
//   the first row and then one term added and one removed per row
//   (2r+1 + 14 terms instead of 8 * (2r+1)); a term is 0 where the left
//   pixel lies outside the image, on the added and the removed row alike,
//   so each sum equals the direct (2r+1)-row sum exactly;
// - the horizontal pass: each thread sums 2r+1 vertical sums of its
//   output pixel per plane.
// That is 17 steps of two barriers per tile.  The vertical sums are
// uint16 in shared memory (a sum is at most 2 * prefilter_cap * (2r+1),
// below the cost limit) so that four planes fit the 48 KB of static
// shared memory.  The 64 costs of each pixel stay in shared memory as
// uint16 for the winner, uniqueness and subpixel epilogue: a cost is at
// most 2 * prefilter_cap * (2r+1)^2, so this tiled kernel takes a
// configuration only where that is at most 65535 (kernels/stereo_bm.py
// k1_tiled_refusal).  All arithmetic is integer, so CUDA's `/` is C's
// division and no TPU float workaround is needed.  Next (ROADMAP): the
// horizontal pass as a running sum, a harness cut after staging, and
// wider prefilter loads.
//
// Every other configuration the reference's strip kernel takes (another
// disparity count, a block beyond 31 or even, costs past uint16) runs in
// K1's wide kernel, `bm_wide_kernel` (see there): the same staged tile
// and running vertical sums, in int32 and in dynamic shared memory sized
// from r at launch, a running horizontal sum along each row, the right
// image staged per chunk of planes and each group of costs folded at once
// into a one-pass walk over d that keeps only what the epilogue reads, so
// it needs no cost store and has no limit on ndisp, r or the cost.  The
// main path never takes it.
//
// The phase harness (tpuslam_stereo_bm_phase) replaces the TPU timing
// probe tools/probe_bm_parts.py:148 (the strip kernel cut after each of
// its passes).  `bm_kernel<STOP>` is K1's own kernel cut after phase STOP:
// it writes that phase's two outputs (tpuslam_torch/kernels/stereo_bm.py
// PHASES, int32) and returns.  Each output depends on every plane the
// phase computes (the texture sum through live() where the phase does
// not output it), so nvcc cannot drop the phase's work, and a cut that
// needs fewer registers or less shared memory is launched with enough
// dynamic shared memory to run at K1's occupancy (blocks per SM).
// tpuslam_stereo_bm launches bm_kernel<FULL>, the main path's K1.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NDISP = 64;
constexpr int TX = 32;               // output columns per block
constexpr int TY = 8;                // output rows per block
constexpr int NT = TX * TY;
constexpr int RMAX = 15;             // block_size <= 31
constexpr int ROWS = TY + 2 * RMAX;
constexpr int LCOLS = TX + 2 * RMAX;
constexpr int RCOLS = LCOLS + NDISP - 1;
constexpr int NPLANES = NDISP + 1;   // the texture image, then 64 disparities
constexpr int GP = 4;                // planes per step: GP * LCOLS <= NT
static_assert(GP * LCOLS <= NT, "one thread per plane and column");

// the harness's cut points, in order (kernels/stereo_bm.py PHASES)
enum Phase { PREFILTER, VBOX, BOXES, WINNER, SAD, UNIQ, FULL, NPHASES };
// a cut's first output: K1's int16 disparity at FULL, else int32; the
// second output (min-SAD at FULL) is int32 at every cut
template <int STOP>
using Out = typename std::conditional<STOP == FULL, int16_t, int>::type;

__global__ void prefilter_kernel(const uint8_t* __restrict__ left,
                                 const uint8_t* __restrict__ right,
                                 uint8_t* __restrict__ lp,
                                 uint8_t* __restrict__ rp,
                                 int H, int W, int cap, long total) {
  long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const uint8_t* src = blockIdx.y ? right : left;
  uint8_t* dst = blockIdx.y ? rp : lp;
  int x = (int)(i % W);
  long t = i / W;
  int y = (int)(t % H);
  const uint8_t* im = src + (t / H) * (long)H * W;
  if (x == 0 || x == W - 1) {
    dst[i] = (uint8_t)cap;
    return;
  }
  int yu = (y == 0) ? 1 : y - 1;           // reflect-101 rows
  int yd = (y == H - 1) ? H - 2 : y + 1;
  int du = (int)im[(long)yu * W + x + 1] - (int)im[(long)yu * W + x - 1];
  int dc = (int)im[(long)y * W + x + 1] - (int)im[(long)y * W + x - 1];
  int dd = (int)im[(long)yd * W + x + 1] - (int)im[(long)yd * W + x - 1];
  int v = du + 2 * dc + dd;
  v = min(max(v, -cap), cap) + cap;
  dst[i] = (uint8_t)v;
}

// v, as the texture sum tex is never negative: the cuts between BOXES and
// FULL, which do not output tex, pass their output through live() to
// keep tex's box pass live
__device__ __forceinline__ int live(int tex, int v) {
  return tex < 0 ? tex : v;
}

template <int STOP>
__global__ void __launch_bounds__(NT)
bm_kernel(const uint8_t* __restrict__ lp, const uint8_t* __restrict__ rp,
          Out<STOP>* __restrict__ disp, int* __restrict__ minsad_out,
          int H, int W, int r, int mindisp, int ftzero, int uniq,
          int tex_thr) {
  __shared__ int16_t Ls[ROWS][LCOLS];     // -1 marks outside the image
  __shared__ uint8_t Rs[ROWS][RCOLS];
  __shared__ uint16_t Vs[GP][TY][LCOLS];
  __shared__ uint16_t costs[NDISP][NT];

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const long frame = (long)blockIdx.z * H * W;
  const uint8_t* L = lp + frame;
  const uint8_t* R = rp + frame;
  const int win = 2 * r + 1;
  const int rows = TY + 2 * r, lcols = TX + 2 * r;
  const int rcols = lcols + NDISP - 1;

  for (int i = tid; i < rows * lcols; i += NT) {
    int yy = i / lcols, xx = i % lcols;
    int y = y0 - r + yy, x = x0 - r + xx;
    Ls[yy][xx] = (y >= 0 && y < H && x >= 0 && x < W)
                     ? (int16_t)L[(long)y * W + x] : (int16_t)-1;
  }
  for (int i = tid; i < rows * rcols; i += NT) {
    int yy = i / rcols, xx = i % rcols;
    int y = y0 - r + yy, x = x0 - r - (NDISP - 1) + xx;
    Rs[yy][xx] = (y >= 0 && y < H && x >= 0 && x < W)
                     ? R[(long)y * W + x] : (uint8_t)0;
  }
  __syncthreads();

  // plane p of the 65 is k = p - 1: k = -1 the texture image
  // |L - ftzero|, k = d the absolute difference |L(x) - R(x - d)|.  This
  // thread's vertical pass: plane g of each group, staged column xx.
  const int g = tid / lcols, xx = tid % lcols;
  int tex = 0;
  int vsum = 0, v0 = 0;      // VBOX: all planes' vertical sums, plane j = 0
  for (int p0 = 0; p0 < NPLANES; p0 += GP) {
    const int k = p0 + g - 1;
    if (g < GP && k < NDISP) {
      const int rx = xx + NDISP - 1 - k;
      auto term = [&](int row) {     // 0 outside the image (Ls < 0)
        int l = Ls[row][xx];
        int rv = (k < 0) ? ftzero : (int)Rs[row][rx];
        return l >= 0 ? abs(l - rv) : 0;
      };
      int s = 0;
      for (int t = 0; t < win; ++t) s += term(t);
      Vs[g][0][xx] = (uint16_t)s;
      for (int oy = 1; oy < TY; ++oy) {
        s += term(oy - 1 + win) - term(oy - 1);
        Vs[g][oy][xx] = (uint16_t)s;
      }
    }
    __syncthreads();
    for (int q = 0; q < GP && p0 + q < NPLANES; ++q) {
      const int kq = p0 + q - 1;
      if constexpr (STOP == VBOX) {
        int v = Vs[q][ty][tx + r];
        vsum += v;
        if (kq == NDISP - 1) v0 = v;
      } else {
        int c = 0;
        for (int t = 0; t < win; ++t) c += Vs[q][ty][tx + t];
        if (kq < 0) tex = c;
        else costs[kq][tid] = (uint16_t)c;
      }
    }
    __syncthreads();
  }

  const int x = x0 + tx, y = y0 + ty;
  if (x >= W || y >= H) return;
  if constexpr (STOP == VBOX) {
    disp[frame + (long)y * W + x] = v0;
    minsad_out[frame + (long)y * W + x] = vsum;
    return;
  }
  if constexpr (STOP == BOXES) {
    int s = tex;
    for (int j = 0; j < NDISP; ++j) s += costs[NDISP - 1 - j][tid];
    disp[frame + (long)y * W + x] = costs[NDISP - 1][tid];
    minsad_out[frame + (long)y * W + x] = s;
    return;
  }

  // winner in internal order j = NDISP-1-d: first strict minimum
  int best = 1 << 30, bj = 0;
  for (int j = 0; j < NDISP; ++j) {
    int c = costs[NDISP - 1 - j][tid];
    if (c < best) { best = c; bj = j; }
  }
  if constexpr (STOP == WINNER) {
    disp[frame + (long)y * W + x] = live(tex, bj);
    minsad_out[frame + (long)y * W + x] = best;
    return;
  }
  if constexpr (STOP == SAD) {   // the neighbours before the edge swap
    disp[frame + (long)y * W + x] =
        live(tex, bj > 0 ? costs[NDISP - bj][tid] : 0);
    minsad_out[frame + (long)y * W + x] =
        bj < NDISP - 1 ? costs[NDISP - 2 - bj][tid] : 0;
    return;
  }
  bool uniq_ok = true;
  if (uniq > 0) {
    int thresh = best + (best * uniq) / 100;
    for (int j = 0; j < NDISP; ++j)
      if (abs(j - bj) > 1 && (int)costs[NDISP - 1 - j][tid] <= thresh)
        uniq_ok = false;
  }
  if constexpr (STOP == UNIQ) {
    disp[frame + (long)y * W + x] = live(tex, uniq_ok);
    minsad_out[frame + (long)y * W + x] = best;
    return;
  }
  int lo = (bj == 0) ? 1 : bj - 1;
  int hi = (bj == NDISP - 1) ? NDISP - 2 : bj + 1;
  int sad_n = costs[NDISP - 1 - lo][tid];
  int sad_p = costs[NDISP - 1 - hi][tid];
  int denom = sad_p + sad_n - 2 * best + abs(sad_p - sad_n);
  int num = (sad_p - sad_n) * 256;
  int frac = (denom != 0) ? num / denom : 0;   // C truncation
  int d_act = NDISP - 1 - bj;
  int v = ((d_act + mindisp) * 256 + frac + 15) >> 4;
  bool valid = y >= r && y < H - r && x >= mindisp + NDISP - 1 + r &&
               x < W - r && tex >= tex_thr && uniq_ok;
  long o = frame + (long)y * W + x;
  disp[o] = (int16_t)(valid ? v : (mindisp - 1) * 16);
  minsad_out[o] = best;
}

// K1's wide kernel: any disparity count (>= 1), any radius (>= 0), int32
// costs; same outputs as bm_kernel<FULL>.  A block of 32x8 threads takes a
// 32 x TYW output tile of one frame (TYW = 8 * PIX rows, PIX pixels a
// thread, rows ty + 8i), stages the tile's left rows with their box halo
// once and the right rows per chunk of `dc` planes (the columns the
// chunk's shifts reach), and walks the planes in groups of `gp`: the
// texture plane |L - ftzero| first, then d = 0, 1, ..., ndisp - 1.  Per
// group, three steps between barriers:
// - the vertical pass: a thread per (plane, staged column) forms its TYW
//   vertical (2r+1)-row sums as a running int32 sum;
// - the horizontal pass: a thread per (plane, output row) runs the
//   (2r+1)-column window along the row's 32 outputs, one sum in and one
//   out a step, and writes the group's costs;
// - the fold: each pixel's thread feeds its costs, in ascending d, into
//   its one-pass walk, so no cost outlives its group.
// Rows and columns outside the image add 0: such a column's sums are 0,
// and the running sum takes only the staged rows inside the image (a
// condition the whole block shares), so every sum equals the plain
// version's zero-padded box sum exactly.  Shapes (wide_shape): PIX from r,
// gp about two columns of vertical work a thread, dc about 64 planes, all
// in dynamic shared memory; where the staged tile does not fit the card's
// limit even at 8 rows and one plane a group, bm_wide_global_kernel takes
// the launch.  What bounds it on this card: instruction throughput, as
// the tiled kernel, mostly the vertical pass's ~5 terms (two byte loads each)
// a pixel and plane at r = 10; no cost leaves the block.

constexpr int WIDE_CHUNK = 64;    // right-image planes staged at once (about)
constexpr int WIDE_COLS = 256;    // the global kernel's column chunk

// The one pass over d ascending keeps the winner (ties to the larger d,
// as the first minimum in the reversed order), the costs at its two
// neighbours (0 outside [0, ndisp), as in the plain version) and the
// least cost at least two steps from it: `pref`, the least cost at
// 0..d-2, becomes that minimum when d wins, and every later cost beyond
// the winner's right neighbour joins it.
struct Walk {
  int best = INT_MAX, bd = 0, below = 0, above = 0, far = INT_MAX;
  int prev = 0, prev2 = 0, pref = INT_MAX;

  __device__ __forceinline__ void step(int c, int d) {
    if (d >= 2) pref = min(pref, prev2);
    if (c <= best) {
      best = c; bd = d; below = d > 0 ? prev : 0; above = 0; far = pref;
    } else if (d == bd + 1) {
      above = c;
    } else {
      far = min(far, c);
    }
    prev2 = prev;
    prev = c;
  }
};

// the uniqueness test, the subpixel step and the validity test of pixel
// (x, y), written at o
__device__ __forceinline__ void wide_epilogue(
    const Walk& w, int tex, int x, int y, long o, int H, int W, int ndisp,
    int r, int mindisp, int uniq, int tex_thr, int16_t* __restrict__ disp,
    int* __restrict__ minsad_out) {
  const int best = w.best, bd = w.bd;
  const bool uniq_ok = uniq <= 0 || w.far > best + (best * uniq) / 100;
  // in the reversed order: sad_n at d + 1, sad_p at d - 1, each taking
  // the other at the ends
  const int sad_n = (bd == ndisp - 1) ? w.below : w.above;
  const int sad_p = (bd == 0) ? w.above : w.below;
  const int denom = sad_p + sad_n - 2 * best + abs(sad_p - sad_n);
  const int num = (sad_p - sad_n) * 256;
  const int frac = (denom != 0) ? num / denom : 0;   // C truncation
  const int v = ((bd + mindisp) * 256 + frac + 15) >> 4;
  const bool valid = y >= r && y < H - r && x >= mindisp + ndisp - 1 + r &&
                     x < W - r && tex >= tex_thr && uniq_ok;
  disp[o] = (int16_t)(valid ? v : (mindisp - 1) * 16);
  minsad_out[o] = best;
}

// One staged column's vertical (2r+1)-row sums for output rows
// 0..rows_out-1 into V[0], V[stride], ...: the window of output row oy is
// staged rows oy..oy+2r, of which only [ylo, yhi) lie inside the image;
// term(yy) is the plane's term at staged row yy.
template <typename Term>
__device__ __forceinline__ void vertical_sums(Term term, int* V, int stride,
                                              int rows_out, int win, int ylo,
                                              int yhi) {
  int s = 0;
  for (int yy = ylo; yy < min(yhi, win); ++yy) s += term(yy);
  V[0] = s;
  for (int oy = 1; oy < rows_out; ++oy) {
    const int add = oy - 1 + win, sub = oy - 1;
    if (add >= ylo && add < yhi) s += term(add);
    if (sub >= ylo && sub < yhi) s -= term(sub);
    V[oy * stride] = s;
  }
}

template <int PIX>
__global__ void __launch_bounds__(NT)
bm_wide_kernel(const uint8_t* __restrict__ lp,
               const uint8_t* __restrict__ rp, int16_t* __restrict__ disp,
               int* __restrict__ minsad_out, int H, int W, int ndisp, int r,
               int mindisp, int ftzero, int uniq, int tex_thr, int gp,
               int dc) {
  constexpr int TYW = TY * PIX;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const int win = 2 * r + 1;
  const int lcols = TX + 2 * r, rows = TYW + 2 * r, rcols = lcols + dc - 1;
  // odd row strides: a thread of the horizontal pass walks a row apiece
  const int vs = lcols + 1, cs = TX + 1;
  int* Vs = (int*)wide_smem;                          // [gp][TYW][vs]
  int* Cs = Vs + (size_t)gp * TYW * vs;               // [gp][TYW][cs]
  uint8_t* Ls = (uint8_t*)(Cs + (size_t)gp * TYW * cs);     // [rows][lcols]
  uint8_t* Rs = Ls + (size_t)rows * lcols;                  // [rows][rcols]

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TYW;
  const long frame = (long)blockIdx.z * H * W;
  const uint8_t* L = lp + frame;
  const uint8_t* R = rp + frame;
  // staged row yy is image row y0 - r + yy: inside the image on [ylo, yhi)
  const int ylo = max(0, r - y0), yhi = min(rows, H - y0 + r);
  for (int i = ylo * lcols + tid; i < yhi * lcols; i += NT) {
    const int yy = i / lcols, x = x0 - r + i % lcols;
    Ls[i] = (x >= 0 && x < W) ? L[(long)(y0 - r + yy) * W + x] : 0;
  }

  Walk w[PIX];
  int tex[PIX] = {};
  int rbase = 0;
  for (int p0 = 0; p0 <= ndisp; p0 += gp) {   // plane p is d = p - 1
    const int np = min(gp, ndisp + 1 - p0);
    if (p0 % dc == 0) {
      // the chunk's planes p0..p0+dc-1 reach right staged column
      // xx - d + rbase from left staged column xx; right pixels left of
      // the image are 0
      rbase = p0 + dc - 2;
      const int xr = x0 - r - rbase;
      for (int i = ylo * rcols + tid; i < yhi * rcols; i += NT) {
        const int yy = i / rcols, x = xr + i % rcols;
        Rs[i] = (x >= 0 && x < W) ? R[(long)(y0 - r + yy) * W + x] : 0;
      }
      __syncthreads();
    }
    for (int i = tid; i < np * lcols; i += NT) {
      const int g = i / lcols, xx = i % lcols;
      const int d = p0 + g - 1, x = x0 - r + xx;
      int* V = Vs + (size_t)g * TYW * vs + xx;
      if (x < 0 || x >= W) {           // a column outside the image adds 0
        for (int oy = 0; oy < TYW; ++oy) V[oy * vs] = 0;
      } else if (d < 0) {
        vertical_sums(
            [&](int yy) { return abs(Ls[yy * lcols + xx] - ftzero); }, V,
            vs, TYW, win, ylo, yhi);
      } else {
        const uint8_t* Rc = Rs + (xx - d + rbase);
        vertical_sums([&](int yy) {
          return abs((int)Ls[yy * lcols + xx] - (int)Rc[yy * rcols]);
        }, V, vs, TYW, win, ylo, yhi);
      }
    }
    __syncthreads();
    // the horizontal pass: a thread per (plane, output row) runs the
    // window along the row's TX outputs, one column in and one out a step
    for (int i = tid; i < np * TYW; i += NT) {
      const int* V = Vs + (size_t)i * vs;
      int* C = Cs + i * cs;
      int c = 0;
      for (int t = 0; t < win; ++t) c += V[t];
#pragma unroll 4
      for (int ox = 0; ox < TX - 1; ++ox) {
        C[ox] = c;
        c += V[ox + win] - V[ox];
      }
      C[TX - 1] = c;
    }
    __syncthreads();
    for (int q = 0; q < np; ++q) {
      const int d = p0 + q - 1;
      const int* C = Cs + (q * TYW + ty) * cs + tx;
#pragma unroll
      for (int i = 0; i < PIX; ++i) {
        if (d < 0) tex[i] = C[i * TY * cs];
        else w[i].step(C[i * TY * cs], d);
      }
    }
  }
  const int x = x0 + tx;
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const int y = y0 + ty + TY * i;
    if (x < W && y < H)
      wide_epilogue(w[i], tex[i], x, y, frame + (long)y * W + x, H, W, ndisp,
                    r, mindisp, uniq, tex_thr, disp, minsad_out);
  }
}

// The wide kernel for a radius whose staged tile exceeds shared memory:
// 32x8 pixels a block, one plane at a time, the vertical pass reading the
// images from global memory in chunks of WIDE_COLS staged columns, each
// chunk's part of every window added to the pixel's sum.
__global__ void __launch_bounds__(NT)
bm_wide_global_kernel(const uint8_t* __restrict__ lp,
                      const uint8_t* __restrict__ rp,
                      int16_t* __restrict__ disp,
                      int* __restrict__ minsad_out, int H, int W, int ndisp,
                      int r, int mindisp, int ftzero, int uniq,
                      int tex_thr) {
  __shared__ int Vg[TY][WIDE_COLS];
  const int win = 2 * r + 1, lcols = TX + 2 * r, rows = TY + 2 * r;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const long frame = (long)blockIdx.z * H * W;
  const uint8_t* L = lp + frame;
  const uint8_t* R = rp + frame;
  const int ylo = max(0, r - y0), yhi = min(rows, H - y0 + r);
  Walk w;
  int tex = 0;
  for (int d = -1; d < ndisp; ++d) {
    int c = 0;
    for (int c0 = 0; c0 < lcols; c0 += WIDE_COLS) {
      const int n = min(WIDE_COLS, lcols - c0);
      for (int i = tid; i < n; i += NT) {
        const int x = x0 - r + c0 + i;
        int* V = &Vg[0][i];
        if (x < 0 || x >= W) {
          for (int oy = 0; oy < TY; ++oy) V[oy * WIDE_COLS] = 0;
          continue;
        }
        const uint8_t* Lc = L + (long)(y0 - r) * W + x;
        const uint8_t* Rc = R + (long)(y0 - r) * W + x - d;
        vertical_sums([&](int yy) {       // right pixels left of 0 are 0
          const int rv = d < 0 ? ftzero
                               : x >= d ? (int)Rc[(long)yy * W] : 0;
          return abs((int)Lc[(long)yy * W] - rv);
        }, V, WIDE_COLS, TY, win, ylo, yhi);
      }
      __syncthreads();
      for (int t = max(tx, c0); t < min(tx + win, c0 + n); ++t)
        c += Vg[ty][t - c0];
      __syncthreads();
    }
    if (d < 0) tex = c;
    else w.step(c, d);
  }
  const int x = x0 + tx, y = y0 + ty;
  if (x < W && y < H)
    wide_epilogue(w, tex, x, y, frame + (long)y * W + x, H, W, ndisp, r,
                  mindisp, uniq, tex_thr, disp, minsad_out);
}

// The wide kernel's launch shape: pixel rows a thread (PIX; 0 for the
// global kernel), planes a group, planes a right-image chunk (a multiple
// of the group) and dynamic shared bytes.
struct WideShape {
  int pix, gp, dc;
  size_t smem;
};

size_t wide_bytes(int pix, int gp, int dc, int r) {
  const size_t lcols = TX + 2 * r, rows = TY * pix + 2 * r;
  return (size_t)gp * TY * pix * (lcols + 1 + TX + 1) * sizeof(int) +
         rows * lcols + rows * (lcols + dc - 1);
}

// Taller tiles amortise the vertical halo where r is large; about two
// columns of vertical work a thread per group; the right image restaged
// every ~WIDE_CHUNK planes.  Shrinks the planes a group, then the tile,
// until the card's shared memory per block (max_smem) holds it.
WideShape wide_shape(int ndisp, int r, size_t max_smem) {
  const int planes = ndisp + 1, lcols = TX + 2 * r;
  for (int pix = r <= 3 ? 1 : r <= 12 ? 2 : 4; pix >= 1; pix /= 2) {
    for (int gp = max(1, min(2 * NT / lcols, planes)); gp >= 1; --gp) {
      const int dc = gp * ((min(WIDE_CHUNK, planes) + gp - 1) / gp);
      for (int d = dc; d >= gp; d -= gp) {
        const size_t smem = wide_bytes(pix, gp, d, r);
        if (smem <= max_smem) return {pix, gp, d, smem};
      }
    }
  }
  return {0, 1, 1, 0};
}

cudaError_t wide_shape_here(int ndisp, int r, WideShape* s) {
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) *s = wide_shape(ndisp, r, (size_t)max_smem);
  return e;
}

using WideKernel = void (*)(const uint8_t*, const uint8_t*, int16_t*, int*,
                           int, int, int, int, int, int, int, int, int, int);

// the staged wide kernel of s.pix pixel rows a thread (s.pix > 0)
WideKernel wide_kernel(const WideShape& s) {
  return s.pix == 4 ? bm_wide_kernel<4>
                   : s.pix == 2 ? bm_wide_kernel<2> : bm_wide_kernel<1>;
}

cudaError_t launch_wide(const uint8_t* lp, const uint8_t* rp, int16_t* disp,
                        int* minsad, int B, int H, int W, int ndisp, int r,
                        int mindisp, int ftzero, int uniq, int tex_thr,
                        cudaStream_t st) {
  WideShape s;
  cudaError_t e = wide_shape_here(ndisp, r, &s);
  if (e != cudaSuccess) return e;
  const int rows = TY * (s.pix ? s.pix : 1);
  dim3 grid((W + TX - 1) / TX, (H + rows - 1) / rows, B);
  if (!s.pix) {
    bm_wide_global_kernel<<<grid, dim3(TX, TY), 0, st>>>(
        lp, rp, disp, minsad, H, W, ndisp, r, mindisp, ftzero, uniq,
        tex_thr);
    return cudaGetLastError();
  }
  WideKernel k = wide_kernel(s);
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)s.smem);
  if (e != cudaSuccess) return e;
  k<<<grid, dim3(TX, TY), s.smem, st>>>(lp, rp, disp, minsad, H, W, ndisp,
                                        r, mindisp, ftzero, uniq, tex_thr,
                                        s.gp, s.dc);
  return cudaGetLastError();
}

// Launch 2 cut after STOP runs at bm_kernel<FULL>'s occupancy: a cut
// that needs fewer registers or less static shared memory than FULL would
// fit more blocks on an SM, so it takes dynamic shared memory until it
// fits as many as FULL does, and is refused if it cannot.
template <int STOP>
cudaError_t fit_occupancy(size_t* pad, int* blocks) {
  cudaFuncAttributes full, mine;
  int want = 0;
  cudaError_t e = cudaFuncGetAttributes(&full, bm_kernel<FULL>);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&mine, bm_kernel<STOP>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&want,
                                                      bm_kernel<FULL>, NT, 0);
  if (e != cudaSuccess) return e;
  *pad = full.sharedSizeBytes > mine.sharedSizeBytes
             ? full.sharedSizeBytes - mine.sharedSizeBytes : 0;
  for (;;) {   // ends: past the card's limit the attribute is refused
    e = cudaFuncSetAttribute(bm_kernel<STOP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*pad);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, bm_kernel<STOP>, NT, *pad);
    if (e != cudaSuccess) return e;
    if (*blocks <= want) break;
    *pad += 1024;
  }
  return *blocks == want ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <int STOP>
cudaError_t launch_bm(dim3 grid, cudaStream_t s, const uint8_t* lp,
                      const uint8_t* rp, void* out0, void* out1, int H,
                      int W, int r, int mindisp, int ftzero, int uniq,
                      int tex_thr) {
  size_t pad;
  int blocks;
  cudaError_t e = fit_occupancy<STOP>(&pad, &blocks);
  if (e != cudaSuccess) return e;
  bm_kernel<STOP><<<grid, dim3(TX, TY), pad, s>>>(
      lp, rp, (Out<STOP>*)out0, (int*)out1, H, W, r, mindisp, ftzero,
      uniq, tex_thr);
  return cudaGetLastError();
}

// f(std::integral_constant<int, STOP>) for the runtime phase (> PREFILTER)
template <typename F>
cudaError_t on_phase(int phase, F f) {
  switch (phase) {
    case VBOX: return f(std::integral_constant<int, VBOX>());
    case BOXES: return f(std::integral_constant<int, BOXES>());
    case WINNER: return f(std::integral_constant<int, WINNER>());
    case SAD: return f(std::integral_constant<int, SAD>());
    case UNIQ: return f(std::integral_constant<int, UNIQ>());
    case FULL: return f(std::integral_constant<int, FULL>());
    default: return cudaErrorInvalidValue;
  }
}

void launch_prefilter(const void* left, const void* right, void* lp,
                      void* rp, int B, int H, int W, int cap,
                      cudaStream_t s) {
  long total = (long)B * H * W;
  dim3 pgrid((unsigned)((total + 255) / 256), 2);
  prefilter_kernel<<<pgrid, 256, 0, s>>>(
      (const uint8_t*)left, (const uint8_t*)right, (uint8_t*)lp,
      (uint8_t*)rp, H, W, cap, total);
}

}  // namespace

// K1: the tiled kernel, or with `wide` the wide kernel (the wrapper
// chooses; the tiled kernel refuses what it cannot take).
extern "C" int tpuslam_stereo_bm(const void* left, const void* right,
                                 void* lp_scratch, void* rp_scratch,
                                 void* disp, void* minsad, int B, int H,
                                 int W, int r, int mindisp, int ftzero,
                                 int uniq, int tex_thr, int ndisp, int wide,
                                 void* stream) {
  const int win = 2 * r + 1;
  if (B < 1 || H < 3 || W < 3 || r < 0 || ndisp < 1) return -1;
  if (!wide && (r < 1 || r > RMAX || ndisp != NDISP ||
                2L * ftzero * win * win > 65535))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  launch_prefilter(left, right, lp_scratch, rp_scratch, B, H, W, ftzero, s);
  if (wide)
    return (int)launch_wide((const uint8_t*)lp_scratch,
                            (const uint8_t*)rp_scratch, (int16_t*)disp,
                            (int*)minsad, B, H, W, ndisp, r, mindisp, ftzero,
                            uniq, tex_thr, s);
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  bm_kernel<FULL><<<grid, dim3(TX, TY), 0, s>>>(
      (const uint8_t*)lp_scratch, (const uint8_t*)rp_scratch,
      (int16_t*)disp, (int*)minsad, H, W, r, mindisp, ftzero, uniq,
      tex_thr);
  return (int)cudaGetLastError();
}

// The phase harness: launch 1 into lp/rp and, past PREFILTER, launch 2
// cut after `phase` into out0/out1 (int32; out0 int16 for FULL).
extern "C" int tpuslam_stereo_bm_phase(const void* left, const void* right,
                                       void* lp, void* rp, void* out0,
                                       void* out1, int B, int H, int W,
                                       int r, int mindisp, int ftzero,
                                       int uniq, int tex_thr, int phase,
                                       void* stream) {
  if (r < 1 || r > RMAX || B < 1 || H < 3 || W < 3 || phase < 0 ||
      phase >= NPHASES)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  launch_prefilter(left, right, lp, rp, B, H, W, ftzero, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || phase == PREFILTER) return (int)e;
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  return (int)on_phase(phase, [&](auto stop) {
    return launch_bm<decltype(stop)::value>(
        grid, s, (const uint8_t*)lp, (const uint8_t*)rp, out0, out1, H, W, r,
        mindisp, ftzero, uniq, tex_thr);
  });
}

// The harness's launch 2 for `phase` (> PREFILTER) on the current card:
// registers per thread, shared memory per block (static and padding) and
// blocks per SM, into out[0..2].
extern "C" int tpuslam_stereo_bm_phase_occupancy(int phase, int* out) {
  return (int)on_phase(phase, [&](auto stop) {
    constexpr int STOP = decltype(stop)::value;
    cudaFuncAttributes a;
    size_t pad;
    cudaError_t e = fit_occupancy<STOP>(&pad, &out[2]);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, bm_kernel<STOP>);
    if (e == cudaSuccess) {
      out[0] = a.numRegs;
      out[1] = (int)(a.sharedSizeBytes + pad);
    }
    return e;
  });
}

// K1's wide kernel for ndisp disparities at radius r on the current card:
// output rows a block, planes a group, planes a right-image chunk, whether
// the tile is staged (0: bm_wide_global_kernel), shared bytes per block
// (dynamic and static), registers per thread and blocks per SM, into
// out[0..6].
extern "C" int tpuslam_stereo_bm_wide_shape(int ndisp, int r, int* out) {
  if (ndisp < 1 || r < 0) return (int)cudaErrorInvalidValue;
  WideShape s;
  cudaError_t e = wide_shape_here(ndisp, r, &s);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  int blocks = 0;
  if (s.pix) {
    WideKernel k = wide_kernel(s);
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s.smem);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, k);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, NT,
                                                        s.smem);
  } else {
    e = cudaFuncGetAttributes(&a, bm_wide_global_kernel);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, bm_wide_global_kernel, NT, 0);
  }
  if (e != cudaSuccess) return (int)e;
  const int vals[7] = {TY * (s.pix ? s.pix : 1), s.gp, s.dc, s.pix > 0,
                       (int)(s.smem + a.sharedSizeBytes), a.numRegs, blocks};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}
