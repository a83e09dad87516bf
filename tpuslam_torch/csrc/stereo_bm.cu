// Kernel K1: dense SAD block-matching disparity (StereoBM) on Hopper.
//
// Replaces the Pallas TPU kernel
//   tpuslam/kernels/stereo_bm_pallas.py:_bm_strip_kernel
// and is bit-equal to the plain PyTorch version
//   tpuslam_torch/kernels/stereo_bm.py:stereo_bm_plain
// (itself bit-equal to tpuslam.kernels.stereo_bm.stereo_bm, the XLA twin
// of the Pallas kernel): X-Sobel prefilter capped at ftzero with
// reflect-101 rows and columns 0 and W-1 forced to ftzero; SAD over the
// disparities with a (2r+1)^2 box, zero outside the image and zero right
// pixels for x < d; the winner is the first minimum in OpenCV's reversed
// order j = ndisp - 1 - d (ties go to the larger disparity); uniqueness and
// texture gates; x16 subpixel with C's truncating division;
// (mindisp - 1) * 16 at invalid pixels.  Also writes the per-pixel
// minimum SAD (int32, as the reference keeps it), which the left-right
// check consumes.  All arithmetic is integer, so CUDA's `/` is C's
// division and no TPU float workaround is needed.
//
// Launch 1 prefilters both images into uint8 scratch, four pixels of a row
// a thread (the three rows' six columns loaded once).  Launch 2 is one of
// two kernels, chosen by the wrapper from the configuration alone:
// `bm_packed_kernel`, the main path's, where there are 64 disparities, an
// odd block of 3..31 and every cost fits 16 bits (2 * cap * block^2 <=
// 65535; kernels/stereo_bm.py k1_packed_refusal), and the wide kernel
// (`bm_wide_kernel`, below) at every other configuration.
//
// bm_packed_kernel.  A block of 32x8 threads takes a 32-column output tile
// of one frame, 8 * nsb rows tall (64 rows where two blocks then fit an
// SM's shared memory, so to r = 14; packed_nsb), and stages the tile's
// rows with their box halo once, a warp per row with all of the row's
// loads issued before its stores: the left image a byte a pixel, the right
// image as words Rw[i] = R[i] | R[i+1] << 8 | R[i+2] << 16 | R[i+3] << 24
// (four neighbouring right pixels, over the 63 extra columns the shifts
// reach), rows outside the image as zeros in both images so that their
// terms are 0.  The 64 disparities go in 32 words of two 16-bit lanes, four
// disparities 4q..4q+3 in words 2q (d = 4q high, 4q + 2 low) and 2q + 1
// (4q + 1 high, 4q + 3 low).  Per sub-band of 8 output rows:
// - the vertical pass: four threads per staged column, 16 disparities
//   each, carry the column's running (2r+1)-row sums in registers from row
//   to row and from sub-band to sub-band, so the tile's vertical halo is
//   paid once.  Per row and four disparities one __vabsdiffu4 (one
//   VABSDIFF4 on sm_90a) of the left byte times 0x01010101 against a word
//   of Rw gives the four |L - R| bytes, for the row added and for the row
//   removed; the running sums take the bytes as a plain word sum S and the
//   odd bytes alone (one __byte_perm each), B, so the even bytes' sums are
//   S - (B << 8).  The sums go to shared memory, a column outside the
//   image writes zeros;
// - the horizontal pass: a thread per (word, output row) runs the window
//   along the row's 32 outputs, one sum in and one out a step, and writes
//   the costs over the vertical sums in place;
// - the fold: each pixel's thread reads its 32 cost words into registers;
//   after a barrier the next sub-band's vertical pass overwrites them while
//   the thread feeds its 64 costs in ascending d into the one-pass walk
//   (SelWalk, below) and writes the pixel.
// Packed sums are exact: a word's sums and differences are exact modulo
// 2^32, so a carry or borrow between the lanes of an intermediate value
// cancels, and a word decodes to its two lanes wherever each true value
// lies in [0, 65535]: a vertical sum is at most 255 * 31, a cost at most
// min(2 * cap, 255) * block^2 <= 2 * cap * block^2 <= 65535.  The texture
// plane |L - ftzero| (0 outside the image): int32 vertical sums by the
// first group's threads, the (2r+1)-tap horizontal sum by the pixel's
// thread.  What bounds it on this card: the 64 INT32 lanes an SM, which
// issue the VABSDIFF4s, adds and byte permutes and the walk's compares,
// mins and selects (the walk's ~8.5 a pixel and disparity the most), and
// shared-memory issue (32 lanes a clock) in the vertical and horizontal
// passes: per pixel and disparity ~1.5 and ~1.8 shared loads and stores.
// No cost leaves the block.
//
// The phase harness (tpuslam_stereo_bm_phase) replaces the TPU timing
// probe tools/probe_bm_parts.py:148 (the strip kernel cut after each of
// its passes).  `bm_packed_kernel<STOP>` is K1's own kernel cut after phase
// STOP: it writes that phase's two outputs (tpuslam_torch/kernels/
// stereo_bm.py PHASES, int32) and returns: vbox after the vertical pass
// (read at the pixel's own column), boxes after the horizontal pass,
// winner, sad and uniq from the walk's state.  Each output depends on every
// plane the phase computes (the texture sum through live() where the
// phase does not output it), so nvcc cannot drop the phase's work, and a
// cut that needs fewer registers is launched with enough dynamic shared
// memory to run at K1's occupancy (blocks per SM).
// tpuslam_stereo_bm launches bm_packed_kernel<FULL>, the main path's K1.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NDISP = 64;            // the packed kernel's disparities
constexpr int TX = 32;               // output columns per block
constexpr int TY = 8;                // thread rows per block
constexpr int NT = TX * TY;
constexpr int RMAX = 15;             // the packed kernel: block_size <= 31
constexpr int PK_SB = TY;            // output rows per sub-band
constexpr int PK_WORDS = NDISP / 2;  // cost words per pixel
constexpr int PK_GROUPS = 4;         // vertical threads per staged column
constexpr int PK_QUADS = NDISP / 4 / PK_GROUPS;  // quads a vertical thread
// two blocks an SM: 2 * (bytes + the 1 KB the card reserves a block) within
// the SM's 228 KB
constexpr size_t PK_SMEM = 115712;
static_assert(PK_WORDS == TX && PK_SB == TY,
              "a thread per (word, row) and per pixel of a sub-band");
static_assert(PK_GROUPS * (TX + 2 * RMAX) <= NT,
              "four threads per staged column");
static_assert(TX + 2 * RMAX <= 64 && TX + 2 * RMAX + NDISP - 1 <= 128,
              "a staged row: two left bytes and four right words a lane");

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
  // total: image rows (B * H) times quads of 4 pixels a row
  const int q = (W + 3) / 4;
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long t = i / q;                    // image row over the batch
  const int x0 = (int)(i - t * q) * 4, y = (int)(t % H);
  const uint8_t* im = (blockIdx.y ? right : left) + (t - y) * (long)W;
  uint8_t* dst = (blockIdx.y ? rp : lp) + t * (long)W;
  const int yu = (y == 0) ? 1 : y - 1;     // reflect-101 rows
  const int yd = (y == H - 1) ? H - 2 : y + 1;
  int u[6], c[6], d[6];                    // columns x0 - 1 .. x0 + 4
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int xx = min(max(x0 - 1 + k, 0), W - 1);
    u[k] = im[(long)yu * W + xx];
    c[k] = im[(long)y * W + xx];
    d[k] = im[(long)yd * W + xx];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int x = x0 + j;
    if (x >= W) break;
    int v = (u[j + 2] - u[j]) + 2 * (c[j + 2] - c[j]) + (d[j + 2] - d[j]);
    v = min(max(v, -cap), cap) + cap;
    dst[x] = (uint8_t)((x == 0 || x == W - 1) ? cap : v);
  }
}

// v, as the texture sum tex is never negative: the cuts between BOXES and
// FULL, which do not output tex, pass their output through live() to
// keep tex's box pass live
__device__ __forceinline__ int live(int tex, int v) {
  return tex < 0 ? tex : v;
}

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

// Walk's pass written without branches, for the packed kernel, whose
// whole warp steps through the same 64 disparities: `last` (the step
// before set the winner) stands for d == bd + 1, `above` takes the cost
// after every step that set the winner and is cleared once at the end
// where the winner is the last disparity, and a cost joins `far` unless
// it is the winner's right neighbour.  Ends in Walk's state.  The wide
// kernels keep Walk's branches: on SelWalk they ran 0.6-2.6 % slower at
// each of chip_smoke.py's seven wide configurations on an H100
// (tools/bm_wide_probe.py, in turns), where the packed kernel ran 14 %
// faster on it than on Walk.
struct SelWalk : Walk {
  bool last = false;

  __device__ __forceinline__ void step(int c, int d) {
    if (d >= 2) pref = min(pref, prev2);
    const bool le = c <= best;
    above = last ? c : above;
    far = min(far, last ? INT_MAX : c);
    far = le ? pref : far;
    below = le ? prev : below;
    bd = le ? d : bd;
    best = min(best, c);
    last = le;
    prev2 = prev;
    prev = c;
  }
  __device__ __forceinline__ void end(int ndisp) {
    if (bd == ndisp - 1) above = 0;
  }
};

// the uniqueness test of the walk's winner
__device__ __forceinline__ bool unique(const Walk& w, int uniq) {
  return uniq <= 0 || w.far > w.best + (w.best * uniq) / 100;
}

// the uniqueness test, the subpixel step and the validity test of pixel
// (x, y), written at o
__device__ __forceinline__ void wide_epilogue(
    const Walk& w, int tex, int x, int y, long o, int H, int W, int ndisp,
    int r, int mindisp, int uniq, int tex_thr, int16_t* __restrict__ disp,
    int* __restrict__ minsad_out) {
  const int best = w.best, bd = w.bd;
  const bool uniq_ok = unique(w, uniq);
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

// The packed kernel's shared memory, in 4-byte words then bytes: Vs
// [PK_SB][PK_WORDS][vs] (the sub-band's vertical sums, then its costs in
// place; vs odd, so a warp's 32 words of one row fall in 32 banks), Vt
// [PK_SB][vs] (texture vertical sums), Rw [rows][rwc], Ls [rows][lcols].
struct PackedLayout {
  int lcols, rows, rwc, vs;
  __host__ __device__ PackedLayout(int r, int nsb)
      : lcols(TX + 2 * r), rows(PK_SB * nsb + 2 * r),
        rwc(TX + 2 * r + NDISP - 1), vs((TX + 2 * r) | 1) {}
  __host__ __device__ size_t words() const {
    return (size_t)PK_SB * PK_WORDS * vs + (size_t)PK_SB * vs +
           (size_t)rows * rwc;
  }
  __host__ __device__ size_t bytes() const {
    return 4 * words() + (((size_t)rows * lcols + 3) & ~(size_t)3);
  }
};

template <int STOP>
__global__ void __launch_bounds__(NT, 2)
bm_packed_kernel(const uint8_t* __restrict__ lp,
                 const uint8_t* __restrict__ rp, Out<STOP>* __restrict__ out0,
                 int* __restrict__ out1, int H, int W, int r, int mindisp,
                 int ftzero, int uniq, int tex_thr, int nsb) {
  extern __shared__ __align__(16) unsigned char pk_smem[];
  const PackedLayout lay(r, nsb);
  const int win = 2 * r + 1, lcols = lay.lcols, rows = lay.rows;
  const int rwc = lay.rwc, vs = lay.vs;
  uint32_t* Vs = (uint32_t*)pk_smem;
  int* Vt = (int*)(Vs + PK_SB * PK_WORDS * vs);
  uint32_t* Rw = (uint32_t*)(Vt + PK_SB * vs);
  uint8_t* Ls = (uint8_t*)(Rw + rows * rwc);

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * PK_SB * nsb;
  const long frame = (long)blockIdx.z * H * W;
  const uint8_t* L = lp + frame;
  const uint8_t* R = rp + frame;
  // staged row yy is image row y0 - r + yy, inside the image on [ylo, yhi);
  // staged right column i is image column x0 - r - (NDISP - 1) + i
  const int ylo = max(0, r - y0), yhi = min(rows, H - y0 + r);
  {   // a warp per staged row, its lanes along the row, every load of a
      // row issued before its stores
    const int lane = tid % 32, xl = x0 - r, xr = x0 - r - (NDISP - 1);
    for (int yy = tid / 32; yy < rows; yy += NT / 32) {
      const bool in = yy >= ylo && yy < yhi;
      const uint8_t* Lrow = L + (long)(y0 - r + yy) * W;
      const uint8_t* Rrow = R + (long)(y0 - r + yy) * W;
      auto at = [&](const uint8_t* row, int x) -> uint32_t {
        return in && x >= 0 && x < W ? row[x] : 0;
      };
      uint32_t lv[2], rv[4][4];
#pragma unroll
      for (int k = 0; k < 2; ++k) lv[k] = at(Lrow, xl + lane + 32 * k);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          rv[k][b] = at(Rrow, xr + lane + 32 * k + b);
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (lane + 32 * k < lcols) Ls[yy * lcols + lane + 32 * k] = lv[k];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (lane + 32 * k < rwc)
          Rw[yy * rwc + lane + 32 * k] =
              rv[k][0] | rv[k][1] << 8 | rv[k][2] << 16 | rv[k][3] << 24;
    }
  }
  __syncthreads();

  // this thread's vertical pass: quads q = PK_QUADS * vj + k (d = 4q ..
  // 4q + 3) of staged column vx; quad q's right word at staged row yy is
  // Rw[yy * rwc + vx + NDISP - 4 - 4q], its byte b at d = 4q + 3 - b
  const int vj = tid / lcols, vx = tid % lcols;
  const bool vin = vj < PK_GROUPS && x0 - r + vx >= 0 && x0 - r + vx < W;
  const uint32_t* Rc = Rw + vx + NDISP - 4 - 4 * PK_QUADS * vj;
  const uint8_t* Lc = Ls + vx;
  auto texterm = [&](int yy) {     // 0 outside the image
    return yy >= ylo && yy < yhi ? abs((int)Lc[yy * lcols] - ftzero) : 0;
  };
  // quad k's running sums: S of its |L - R| words, B of their odd bytes
  // (d = 4q + 2 low, d = 4q high), so S - (B << 8) holds the even bytes
  // (d = 4q + 3 low, d = 4q + 1 high)
  uint32_t S[PK_QUADS] = {}, B[PK_QUADS] = {};
  int vt = 0;
  if (vin) {                       // output row 0: staged rows 0..2r
    for (int yy = 0; yy < win; ++yy) {
      const uint32_t l = Lc[yy * lcols] * 0x01010101u;
#pragma unroll
      for (int k = 0; k < PK_QUADS; ++k) {
        const uint32_t t = __vabsdiffu4(l, Rc[yy * rwc - 4 * k]);
        S[k] += t;
        B[k] += __byte_perm(t, 0, 0x4341);
      }
      if (vj == 0) vt += texterm(yy);
    }
  }
  // the vertical sums of sub-band s's rows into Vs and Vt
  auto vertical = [&](int s) {
    if (vj >= PK_GROUPS) return;
    for (int row = 0; row < PK_SB; ++row) {
      const int oy = s * PK_SB + row;
      if (vin && oy > 0) {
        const int ya = oy - 1 + win, yb = oy - 1;
        const uint32_t la = Lc[ya * lcols] * 0x01010101u;
        const uint32_t lb = Lc[yb * lcols] * 0x01010101u;
#pragma unroll
        for (int k = 0; k < PK_QUADS; ++k) {
          const uint32_t ta = __vabsdiffu4(la, Rc[ya * rwc - 4 * k]);
          const uint32_t tb = __vabsdiffu4(lb, Rc[yb * rwc - 4 * k]);
          S[k] += ta - tb;
          B[k] += __byte_perm(ta, 0, 0x4341) - __byte_perm(tb, 0, 0x4341);
        }
        if (vj == 0) vt += texterm(ya) - texterm(yb);
      }
      uint32_t* Vo = Vs + (row * PK_WORDS + 2 * PK_QUADS * vj) * vs + vx;
#pragma unroll
      for (int k = 0; k < PK_QUADS; ++k) {
        Vo[2 * k * vs] = B[k];
        Vo[(2 * k + 1) * vs] = S[k] - (B[k] << 8);
      }
      if (vj == 0) Vt[row * vs + vx] = vt;
    }
  };

  vertical(0);
  __syncthreads();
  const int x = x0 + tx;
  for (int s = 0; s < nsb; ++s) {
    if constexpr (STOP != VBOX) {
      // the horizontal pass of word tx in row ty, in place: the cost of
      // output ox over the vertical sum of staged column ox
      uint32_t* Vr = Vs + (ty * PK_WORDS + tx) * vs;
      uint32_t c = 0;
      for (int t = 0; t < win; ++t) c += Vr[t];
#pragma unroll
      for (int ox = 0; ox < TX - 1; ++ox) {
        const uint32_t out = Vr[ox];
        Vr[ox] = c;
        c += Vr[ox + win] - out;
      }
      Vr[TX - 1] = c;
      __syncthreads();
    }
    // pixel (tx, ty) of the sub-band: its cost words (at VBOX its vertical
    // sums, at its own staged column tx + r) and texture sum
    constexpr bool kv = STOP == VBOX;
    const uint32_t* Vp = Vs + ty * PK_WORDS * vs + tx + (kv ? r : 0);
    uint32_t cw[PK_WORDS];
#pragma unroll
    for (int p = 0; p < PK_WORDS; ++p) cw[p] = Vp[p * vs];
    int tex = 0;
    if (kv) {
      tex = Vt[ty * vs + tx + r];
    } else {
      for (int t = 0; t < win; ++t) tex += Vt[ty * vs + tx + t];
    }
    __syncthreads();
    if (s + 1 < nsb) vertical(s + 1);

    const int y = y0 + s * PK_SB + ty;
    const long o = frame + (long)y * W + x;
    const bool write = x < W && y < H;
    if constexpr (STOP == VBOX || STOP == BOXES) {
      int sum = tex;
#pragma unroll
      for (int p = 0; p < PK_WORDS; ++p)
        sum += (int)(cw[p] & 0xffffu) + (int)(cw[p] >> 16);
      if (write) {     // plane j = 0: d = NDISP - 1, the last word's low lane
        out0[o] = (int)(cw[PK_WORDS - 1] & 0xffffu);
        out1[o] = sum;
      }
    } else {
      SelWalk w;
#pragma unroll
      for (int q = 0; q < NDISP / 4; ++q) {
        w.step((int)(cw[2 * q] >> 16), 4 * q);
        w.step((int)(cw[2 * q + 1] >> 16), 4 * q + 1);
        w.step((int)(cw[2 * q] & 0xffffu), 4 * q + 2);
        w.step((int)(cw[2 * q + 1] & 0xffffu), 4 * q + 3);
      }
      w.end(NDISP);
      if (write) {
        if constexpr (STOP == WINNER) {
          out0[o] = live(tex, NDISP - 1 - w.bd);
          out1[o] = w.best;
        } else if constexpr (STOP == SAD) {   // before the edge swap
          out0[o] = live(tex, w.above);
          out1[o] = w.below;
        } else if constexpr (STOP == UNIQ) {
          out0[o] = live(tex, unique(w, uniq));
          out1[o] = w.best;
        } else {
          wide_epilogue(w, tex, x, y, o, H, W, NDISP, r, mindisp, uniq,
                        tex_thr, out0, out1);
        }
      }
    }
    __syncthreads();
  }
}

// K1's wide kernel: any disparity count (>= 1), any radius (>= 0), int32
// costs; same outputs as bm_packed_kernel<FULL>.  A block of 32x8 threads
// takes a 32 x TYW output tile of one frame (TYW = 8 * PIX rows, PIX pixels a
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
// the launch.  What bounds it on this card: instruction throughput,
// mostly the vertical pass's ~5 terms (two byte loads each) a pixel and
// plane at r = 10; no cost leaves the block.

constexpr int WIDE_CHUNK = 64;    // right-image planes staged at once (about)
constexpr int WIDE_COLS = 256;    // the global kernel's column chunk

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

// Sub-bands a tile of the packed kernel at radius r: 64 rows where two
// blocks fit an SM, else fewer.
int packed_nsb(int r) {
  int nsb = 8;
  while (nsb > 1 && PackedLayout(r, nsb).bytes() > PK_SMEM) nsb /= 2;
  return nsb;
}

// The packed kernel cut after STOP with `*smem` dynamic shared bytes: the
// layout's, padded until the cut fits no more blocks per SM than FULL
// (a cut that needs fewer registers would fit more); refused if it cannot
// run at FULL's blocks per SM.
template <int STOP>
cudaError_t packed_occupancy(int r, size_t* smem, int* blocks) {
  const size_t base = PackedLayout(r, packed_nsb(r)).bytes();
  int want = 0;
  cudaError_t e = cudaFuncSetAttribute(
      bm_packed_kernel<FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)base);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &want, bm_packed_kernel<FULL>, NT, base);
  if (e != cudaSuccess) return e;
  *smem = base;
  for (;;) {   // ends: past the card's limit the attribute is refused
    e = cudaFuncSetAttribute(bm_packed_kernel<STOP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, bm_packed_kernel<STOP>, NT, *smem);
    if (e != cudaSuccess) return e;
    if (*blocks <= want) break;
    *smem += 1024;
  }
  return *blocks == want ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <int STOP>
cudaError_t launch_packed(const uint8_t* lp, const uint8_t* rp, void* out0,
                          void* out1, int B, int H, int W, int r,
                          int mindisp, int ftzero, int uniq, int tex_thr,
                          cudaStream_t st) {
  const int nsb = packed_nsb(r);
  size_t smem = PackedLayout(r, nsb).bytes();
  int blocks;
  cudaError_t e =
      STOP == FULL
          ? cudaFuncSetAttribute(bm_packed_kernel<FULL>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem)
          : packed_occupancy<STOP>(r, &smem, &blocks);
  if (e != cudaSuccess) return e;
  dim3 grid((W + TX - 1) / TX, (H + PK_SB * nsb - 1) / (PK_SB * nsb), B);
  dim3 block(TX, TY);
  bm_packed_kernel<STOP><<<grid, block, smem, st>>>(
      lp, rp, (Out<STOP>*)out0, (int*)out1, H, W, r, mindisp, ftzero, uniq,
      tex_thr, nsb);
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
  long total = (long)B * H * ((W + 3) / 4);
  dim3 pgrid((unsigned)((total + 255) / 256), 2);
  prefilter_kernel<<<pgrid, 256, 0, s>>>(
      (const uint8_t*)left, (const uint8_t*)right, (uint8_t*)lp,
      (uint8_t*)rp, H, W, cap, total);
}

}  // namespace

// K1: the packed kernel, or with `wide` the wide kernel (the wrapper
// chooses; the packed kernel refuses what it cannot take).
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
  const uint8_t* lp = (const uint8_t*)lp_scratch;
  const uint8_t* rp = (const uint8_t*)rp_scratch;
  if (wide)
    return (int)launch_wide(lp, rp, (int16_t*)disp, (int*)minsad, B, H, W,
                            ndisp, r, mindisp, ftzero, uniq, tex_thr, s);
  return (int)launch_packed<FULL>(lp, rp, disp, minsad, B, H, W, r, mindisp,
                                  ftzero, uniq, tex_thr, s);
}

// The phase harness: launch 1 into lp/rp and, past PREFILTER, the packed
// kernel cut after `phase` into out0/out1 (int32; out0 int16 for FULL).
extern "C" int tpuslam_stereo_bm_phase(const void* left, const void* right,
                                       void* lp, void* rp, void* out0,
                                       void* out1, int B, int H, int W,
                                       int r, int mindisp, int ftzero,
                                       int uniq, int tex_thr, int phase,
                                       void* stream) {
  const int win = 2 * r + 1;
  if (r < 1 || r > RMAX || B < 1 || H < 3 || W < 3 || phase < 0 ||
      phase >= NPHASES || 2L * ftzero * win * win > 65535)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  launch_prefilter(left, right, lp, rp, B, H, W, ftzero, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || phase == PREFILTER) return (int)e;
  return (int)on_phase(phase, [&](auto stop) {
    return launch_packed<decltype(stop)::value>(
        (const uint8_t*)lp, (const uint8_t*)rp, out0, out1, B, H, W, r,
        mindisp, ftzero, uniq, tex_thr, s);
  });
}

// The packed kernel cut after `phase` (> PREFILTER) at radius r on the
// current card: registers per thread, shared memory per block (dynamic,
// with its padding, and static), blocks per SM and sub-bands of 8 output
// rows a tile (packed_nsb), into out[0..3].
extern "C" int tpuslam_stereo_bm_phase_occupancy(int phase, int r,
                                                 int* out) {
  if (r < 1 || r > RMAX) return (int)cudaErrorInvalidValue;
  return (int)on_phase(phase, [&](auto stop) {
    constexpr int STOP = decltype(stop)::value;
    cudaFuncAttributes a;
    size_t smem;
    cudaError_t e = packed_occupancy<STOP>(r, &smem, &out[2]);
    if (e == cudaSuccess)
      e = cudaFuncGetAttributes(&a, bm_packed_kernel<STOP>);
    if (e == cudaSuccess) {
      out[0] = a.numRegs;
      out[1] = (int)(a.sharedSizeBytes + smem);
      out[3] = packed_nsb(r);
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
