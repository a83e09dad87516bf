// Kernel K3: ORB descriptors (7x7 Gaussian blur + 256 pairwise tests) at
// the keypoints, on Hopper.
//
// Replaces the Pallas TPU kernel
//   tpuslam/kernels/orb.py:_orb_desc_planes_pallas (inner `kernel`, used
//   by _orb_descriptors_const_angle_pallas)
// and is bit-equal to the plain PyTorch version
//   tpuslam_torch/kernels/orb.py:orb_descriptors_plain
// (orb_blur + the constant-angle tests): the 7x7 sigma-2 blur with
// reflect-101 borders in orb_blur's f32 order (vertical taps, then
// horizontal, each sum left to right), floor(x + 0.5) clipped to [0, 255];
// then for byte k of the descriptor, bit j is blurred(p0) < blurred(p1)
// for test 8k+j of bit_pattern_31 rotated by the constant keypoint angle;
// samples outside the image read 0.  Invalid keypoints get zero rows.
//
// The Pallas kernel wrote 32 dense byte planes for every pixel because the
// TPU has no fast gather; here the tests run only at the (<= 1536 per
// frame) keypoints, which gives the same bits.  A blur result that lands
// on .5 must round the same way, so this file is compiled with
// -fmad=false (no FMA contraction), and the taps are neither paired nor
// run as sums: each sum is the plain version's, term by term.
//
// Design: two kernels, queued by one launcher (tpuslam_orb), one for each
// half of the plain version; each is also exported alone
// (tpuslam_orb_blur, tpuslam_orb_tests), as tool launchers that
// chip_smoke.py holds to the two plain halves and times apart.
// - orb_blur_kernel (orb_blur) blurs the whole image once into a
//   (B, H, W) u8 scratch that stays in L2 (14 MB for a 30-frame chunk).
//   A block takes a TH x TW output tile (a 3-D grid: columns, rows,
//   frames).  It stages the raw tile and its 3-px halo in shared memory as
//   f32, a warp per row, each byte converted once: inside the image a
//   lane loads one aligned word and funnels it with its neighbour's into
//   a 16-byte store; edge tiles load byte by byte through reflect-101.
//   The vertical taps run with each thread on VROWS rows of one column
//   (14 loads for 8 sums), the horizontal taps with each thread on HCOLS
//   adjacent outputs of one row (10 loads for 4 sums) from a tile of
//   vertical sums whose odd row stride puts a warp's 4 rows x 8 column
//   groups on 32 distinct banks; a warp's 4 byte stores then cover 4
//   rows x 32 bytes.  Bound by instruction issue: 28 f32 operations per
//   pixel, which the no-FMA order cannot share, and their loads.
// - orb_tests_kernel (descriptors_from_blurred) runs the 256 tests: one
//   warp per keypoint, lane k on byte k.  A lane holds its 16 rotated
//   (dx, dy) offsets in registers, loaded once per warp, and the warp
//   walks keypoints grid-stride; 16 byte gathers of the L2-resident
//   blurred image per lane, 0 outside the image.  Bound by the gathers:
//   the 32 lanes of a load fall on up to 26 rows.  The table stays out of
//   __constant__ memory, which would serialise the lanes' different
//   entries.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// blur: TH x TW outputs per block of BLUR_THREADS threads (chosen on the
// card with tools/shape_sweep.py, which builds other shapes with -DORB_TH,
// -DORB_TW and -DORB_THREADS)
#ifndef ORB_TH
#define ORB_TH 8
#endif
#ifndef ORB_TW
#define ORB_TW 256
#endif
#ifndef ORB_THREADS
#define ORB_THREADS 128
#endif
constexpr int TH = ORB_TH, TW = ORB_TW, BLUR_THREADS = ORB_THREADS;
constexpr int SH = TH + 6, SW = TW + 6;   // raw tile with the 3-px halo
constexpr int RS = (SW + 3) / 4 * 4;      // its row stride, whole float4s
constexpr int BW = BLUR_THREADS / 32;     // warps of a blur block
constexpr int SCOLS = (SW + 31) / 32;     // staged columns per lane
constexpr int NWORDS = (SW + 6) / 4;      // words over a row's SW bytes
constexpr int WSETS = ((SW + 3) / 4 + 31) / 32;  // float4s per lane
constexpr int VS = SW + 1;                // odd row stride of the sums
constexpr int VROWS = 8;                  // vertical pass: rows per thread
constexpr int HCOLS = 4;                  // horizontal: columns per thread
constexpr int GROUPS = TW / HCOLS;        // column groups of a tile row
constexpr int GPW = 32 / HCOLS;           // column groups per warp
static_assert(TH % VROWS == 0 && TH % HCOLS == 0 && GROUPS % GPW == 0 &&
              VS % 2 == 1 && BLUR_THREADS % 32 == 0, "tile shape");
// tests: warps per block and blocks per SM of the grid-stride loop
constexpr int TEST_WARPS = 8, TEST_BLOCKS_PER_SM = 4;

// reflect-101 for |i| <= 3 outside [0, n); the clamp only guards staged
// rows and columns that no output reads (a tile past the image's end)
__device__ __forceinline__ int refl(int i, int n) {
  i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return min(max(i, 0), n - 1);
}

// The byte <-> f32 conversions run on the FP32 adders instead of the
// slower conversion instructions (I2F, F2I, FRND).  A byte b sets the
// low mantissa bits of 2^23, and subtracting 2^23 leaves b exactly.
__device__ __forceinline__ float byte_to_float(uint8_t b) {
  return __int_as_float(0x4B000000 | b) - 8388608.0f;
}

// byte i of v the same way: one byte permute builds 2^23 + byte
__device__ __forceinline__ float bytes_to_float(uint32_t v, int i) {
  return __int_as_float(__byte_perm(v, 0x4B000000u, i | 0x7440)) -
         8388608.0f;
}

// min(floor(s + 0.5), 255) of a blur sum s >= 0 (positive taps on bytes),
// as the plain version's clamp(floor(s + 0.5), 0, 255): the sum y = s +
// 0.5 (rounded to nearest, as there) lies in [0, 2^23), where y + 2^23
// rounded down is 2^23 + floor(y) exactly, an integer in the mantissa.
__device__ __forceinline__ uint8_t round_to_byte(float s) {
  const float t = __fadd_rd(s + 0.5f, 8388608.0f);
  return (uint8_t)min(__float_as_int(t) - 0x4B000000, 255);
}

__global__ void __launch_bounds__(BLUR_THREADS)
orb_blur_kernel(const uint8_t* __restrict__ img, const float* __restrict__ gk,
                uint8_t* __restrict__ out, int H, int W) {
  __shared__ __align__(16) float raw[SH][RS];
  __shared__ float vsum[TH][VS];
  const int t = threadIdx.x;
  const long plane = (long)blockIdx.z * H * W;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const uint8_t* im = img + plane;
  float k[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) k[i] = gk[i];

  // stage the raw tile as f32, a warp per row.  Inside the image's
  // columns (no reflection, every word in the row) a lane loads the
  // aligned word j of the row's window and takes word j + 1 from its
  // neighbour; the window's misalignment picks 4 staged bytes out of
  // the pair, and one 16-byte store writes them.  Tiles at the left and
  // right edges load byte by byte with the reflected columns.
  const int lane = t & 31;
  if (x0 >= 8 && x0 + 4 * NWORDS <= W) {
    for (int r = t >> 5; r < SH; r += BW) {
      const uint8_t* a = im + (long)refl(y0 + r - 3, H) * W + x0 - 3;
      const int mis = (int)((uintptr_t)a & 3);
      const uint32_t* wrd = (const uint32_t*)(a - mis);
      const unsigned sel = (unsigned)mis * 0x1111u + 0x3210u;
      uint32_t w[WSETS + 1];
#pragma unroll
      for (int u = 0; u <= WSETS; ++u)
        w[u] = lane + 32 * u < NWORDS ? wrd[lane + 32 * u] : 0u;
#pragma unroll
      for (int u = 0; u < WSETS; ++u) {
        // word lane + 32u + 1: the next lane's, or the next set's lane 0
        const uint32_t nxt = __shfl_sync(0xffffffffu, lane == 0 ? w[u + 1]
                                                                : w[u],
                                         (lane + 1) & 31);
        const int c = 4 * (lane + 32 * u);
        if (c < SW) {
          const uint32_t v = __byte_perm(w[u], nxt, sel);
          *reinterpret_cast<float4*>(&raw[r][c]) = make_float4(
              bytes_to_float(v, 0), bytes_to_float(v, 1),
              bytes_to_float(v, 2), bytes_to_float(v, 3));
        }
      }
    }
  } else {
    int gx[SCOLS];
#pragma unroll
    for (int q = 0; q < SCOLS; ++q) gx[q] = refl(x0 + lane + 32 * q - 3, W);
    for (int r = t >> 5; r < SH; r += BW) {
      const uint8_t* src = im + (long)refl(y0 + r - 3, H) * W;
#pragma unroll
      for (int q = 0; q < SCOLS; ++q)
        if (lane + 32 * q < SW)
          raw[r][lane + 32 * q] = byte_to_float(src[gx[q]]);
    }
  }
  __syncthreads();

  // vertical taps over every staged column: v = k0*p0 + k1*p1 + ... + k6*p6
  for (int i = t; i < SW * (TH / VROWS); i += BLUR_THREADS) {
    const int g = i / SW, c = i - g * SW, r0 = g * VROWS;
    float p[VROWS + 6];
#pragma unroll
    for (int j = 0; j < VROWS + 6; ++j) p[j] = raw[r0 + j][c];
#pragma unroll
    for (int r = 0; r < VROWS; ++r) {
      float v = 0.0f;
#pragma unroll
      for (int j = 0; j < 7; ++j) v = v + k[j] * p[r + j];
      vsum[r0 + r][c] = v;
    }
  }
  __syncthreads();

  // horizontal taps: a warp takes GPW column groups x HCOLS rows
  for (int i = t; i < TH * GROUPS; i += BLUR_THREADS) {
    const int w = i >> 5;                  // lane = i & 31
    const int c0 = ((w % (GROUPS / GPW)) * GPW + lane % GPW) * HCOLS;
    const int r = (w / (GROUPS / GPW)) * HCOLS + lane / GPW;
    const int y = y0 + r;
    if (y >= H) continue;
    float q[HCOLS + 6];
#pragma unroll
    for (int j = 0; j < HCOLS + 6; ++j) q[j] = vsum[r][c0 + j];
    uint8_t* o = out + plane + (long)y * W + x0 + c0;
    const int n = W - x0 - c0;             // outputs left in the row
#pragma unroll
    for (int x = 0; x < HCOLS; ++x) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < 7; ++j) s = s + k[j] * q[x + j];
      if (n >= HCOLS || x < n) o[x] = round_to_byte(s);
    }
  }
}

__device__ __forceinline__ int sample(const uint8_t* im, int H, int W, int x,
                                      int y) {
  return ((unsigned)x < (unsigned)W && (unsigned)y < (unsigned)H)
             ? (int)im[(long)y * W + x] : 0;
}

__global__ void __launch_bounds__(TEST_WARPS * 32)
orb_tests_kernel(const uint8_t* __restrict__ blurred,
                 const float* __restrict__ kpts,
                 const bool* __restrict__ valid,
                 const int* __restrict__ table, uint8_t* __restrict__ desc,
                 int H, int W, int K, long n) {
  const int lane = threadIdx.x & 31;
  // tests 8*lane .. 8*lane+7: table rows 16*lane .. 16*lane+15, [dx, dy]
  int dx[16], dy[16];
  const int4* row = reinterpret_cast<const int4*>(table) + lane * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int4 v = row[i];
    dx[2 * i] = v.x; dy[2 * i] = v.y;
    dx[2 * i + 1] = v.z; dy[2 * i + 1] = v.w;
  }
  const long stride = (long)gridDim.x * TEST_WARPS;
  for (long kp = blockIdx.x * (long)TEST_WARPS + (threadIdx.x >> 5); kp < n;
       kp += stride) {
    int acc = 0;
    if (valid[kp]) {
      const uint8_t* im = blurred + (kp / K) * (long)H * W;
      const int cx = min(max((int)rintf(kpts[kp * 2 + 0]), 0), W - 1);
      const int cy = min(max((int)rintf(kpts[kp * 2 + 1]), 0), H - 1);
#pragma unroll
      for (int bit = 0; bit < 8; ++bit) {
        const int t0 = sample(im, H, W, cx + dx[2 * bit], cy + dy[2 * bit]);
        const int t1 = sample(im, H, W, cx + dx[2 * bit + 1],
                              cy + dy[2 * bit + 1]);
        acc |= (t0 < t1 ? 1 : 0) << bit;
      }
    }
    desc[kp * 32 + lane] = (uint8_t)acc;
  }
}

cudaError_t launch_blur(const void* img, const void* gk, void* out, int B,
                        int H, int W, cudaStream_t s) {
  const long plane = (long)H * W;
  for (int b0 = 0; b0 < B; b0 += 65535) {       // the grid's z limit
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH,
                    B - b0 < 65535 ? B - b0 : 65535);
    orb_blur_kernel<<<grid, BLUR_THREADS, 0, s>>>(
        (const uint8_t*)img + b0 * plane, (const float*)gk,
        (uint8_t*)out + b0 * plane, H, W);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

cudaError_t launch_tests(const void* blurred, const void* kpts,
                         const void* valid, const void* table, void* desc,
                         int B, int H, int W, int K, cudaStream_t s) {
  const long n = (long)B * K;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long blocks = (n + TEST_WARPS - 1) / TEST_WARPS;
  const long cap = (long)sms * TEST_BLOCKS_PER_SM;
  orb_tests_kernel<<<(unsigned)(blocks < cap ? blocks : cap),
                     TEST_WARPS * 32, 0, s>>>(
      (const uint8_t*)blurred, (const float*)kpts, (const bool*)valid,
      (const int*)table, (uint8_t*)desc, H, W, K, n);
  return cudaGetLastError();
}

bool bad_image(int B, int H, int W) { return B < 1 || H < 4 || W < 4; }

}  // namespace

// K3: blur `img` into `scratch` (B, H, W) u8, then the tests at `kpts`.
extern "C" int tpuslam_orb(const void* img, const void* kpts,
                           const void* valid, const void* table,
                           const void* gk, void* scratch, void* desc, int B,
                           int H, int W, int K, void* stream) {
  if (bad_image(B, H, W) || K < 0) return -1;
  if (K == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = launch_blur(img, gk, scratch, B, H, W, s);
  if (e == cudaSuccess)
    e = launch_tests(scratch, kpts, valid, table, desc, B, H, W, K, s);
  return (int)e;
}

// K3's first half alone (tool launcher): the blurred image.
extern "C" int tpuslam_orb_blur(const void* img, const void* gk, void* out,
                                int B, int H, int W, void* stream) {
  if (bad_image(B, H, W)) return -1;
  return (int)launch_blur(img, gk, out, B, H, W, (cudaStream_t)stream);
}

// K3's second half alone (tool launcher): the tests on a blurred image.
extern "C" int tpuslam_orb_tests(const void* blurred, const void* kpts,
                                 const void* valid, const void* table,
                                 void* desc, int B, int H, int W, int K,
                                 void* stream) {
  if (bad_image(B, H, W) || K < 0) return -1;
  if (K == 0) return 0;
  return (int)launch_tests(blurred, kpts, valid, table, desc, B, H, W, K,
                           (cudaStream_t)stream);
}

// Registers, static shared memory and local memory per thread of the
// blur kernel (out[0..2]) and of the tests kernel (out[3..5]).
extern "C" int tpuslam_orb_attrs(int* out) {
  cudaFuncAttributes a[2];
  cudaError_t e = cudaFuncGetAttributes(&a[0], orb_blur_kernel);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a[1], orb_tests_kernel);
  if (e != cudaSuccess) return (int)e;
  for (int i = 0; i < 2; ++i) {
    out[3 * i] = a[i].numRegs;
    out[3 * i + 1] = (int)a[i].sharedSizeBytes;
    out[3 * i + 2] = (int)a[i].localSizeBytes;
  }
  return 0;
}
