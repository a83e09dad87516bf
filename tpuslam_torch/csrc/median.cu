// Kernel K4: both covariance medians of a VO step, on Hopper.
//
// Replaces the Pallas TPU kernel
//   tpuslam/vo/fused.py:_masked_median2_kernel (driver
//   _masked_median2_pallas)
// and is exactly equal to the plain PyTorch version
//   tpuslam_torch/vo/fused.py:masked_median2_plain
// (sorted(where(mask, x, 3e38))[count >> 1] for each of two arrays):
// for non-negative f32 values the i32 bit pattern is monotone (+inf
// included), so the k-th smallest, k = clip(count >> 1, 0, N - 1), is
// found exactly by a 31-step bisection over [0, 2^31 - 1] that counts
// keys <= mid.  Also returns the mask count.
//
// What bounds it on this card: latency, not work -- N is at most 1536
// per row on the main path, so a step is a few compares per thread and a
// block-wide sum, and the 31 steps form one serial chain.  Design: one
// block of NT threads per row (a leading frame dimension).  Each thread
// loads its keys once into registers (KPT per array, the bit patterns,
// masked entries as 3e38's and slots past N as 2^31 - 1, which no mid
// reaches), and both arrays advance in the same step: a thread's two
// counts are packed into one int (a in the low 16 bits, b in the high
// 16, valid while N < 65536), summed across its warp by one
// __reduce_add_sync, and across the block through a double-buffered
// array of warp partials: one barrier per step, 31 steps for both
// medians.  Rows longer than REG_KEYS keys (KPT = 0) re-read their keys
// from memory in each step and sum the two counts apart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads per row (chosen on the card with tools/shape_sweep.py, which
// builds other counts with -DMED_THREADS)
#ifndef MED_THREADS
#define MED_THREADS 256
#endif
constexpr int NT = MED_THREADS, NW = NT / 32;
constexpr int REG_KEYS = 4096;             // rows held in registers
constexpr int NO_KEY = 0x7fffffff;         // above every mid
static_assert(NT % 32 == 0 && NW <= 32 && REG_KEYS % NT == 0, "block");

// The block's sums of v (and of v2 when TWO) through part[0..2*NW): each
// warp's sum by one reduction, then every warp sums the NW partials.
template <bool TWO>
__device__ __forceinline__ unsigned block_sum(unsigned v, unsigned* v2,
                                              unsigned* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(0xffffffffu, v);
  if constexpr (TWO) *v2 = __reduce_add_sync(0xffffffffu, *v2);
  if (lane == 0) {
    part[warp] = v;
    if constexpr (TWO) part[NW + warp] = *v2;
  }
  __syncthreads();
  if constexpr (TWO)
    *v2 = __reduce_add_sync(0xffffffffu, lane < NW ? part[NW + lane] : 0u);
  return __reduce_add_sync(0xffffffffu, lane < NW ? part[lane] : 0u);
}

__device__ __forceinline__ void halve(unsigned count, int k, int mid,
                                      int& lo, int& hi) {
  if (count >= (unsigned)k + 1u) hi = mid;
  else lo = mid + 1;
}

template <int KPT>
__global__ void __launch_bounds__(NT)
median2_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const bool* __restrict__ mask, float* __restrict__ meds,
               int* __restrict__ cnt_out, int N) {
  __shared__ unsigned part[2][2 * NW];     // double-buffered partials
  const long row = (long)blockIdx.x * N;
  const bool* m = mask + row;
  const float* x = a + row;
  const float* y = b + row;
  const int big = __float_as_int(3e38f);
  int ka[KPT > 0 ? KPT : 1], kb[KPT > 0 ? KPT : 1];
  unsigned c = 0;
  if constexpr (KPT > 0) {
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int i = threadIdx.x + j * NT;
      const bool in = i < N;
      // the three loads independent, so one memory round trip
      const bool on = in && m[i];
      const int xa = in ? __float_as_int(x[i]) : NO_KEY;
      const int xb = in ? __float_as_int(y[i]) : NO_KEY;
      ka[j] = on ? xa : (in ? big : NO_KEY);
      kb[j] = on ? xb : (in ? big : NO_KEY);
      c += on ? 1u : 0u;
    }
  } else {
    for (int i = threadIdx.x; i < N; i += NT) c += m[i] ? 1u : 0u;
  }
  const unsigned cnt = block_sum<false>(c, nullptr, part[1]);
  const int k = min(max((int)(cnt >> 1), 0), N - 1);

  int lo_a = 0, hi_a = 0x7fffffff, lo_b = 0, hi_b = 0x7fffffff;
#pragma unroll 1
  for (int step = 0; step < 31; ++step) {
    const int mid_a = lo_a + ((hi_a - lo_a) >> 1);  // lo + hi overflows
    const int mid_b = lo_b + ((hi_b - lo_b) >> 1);
    unsigned* buf = part[step & 1];
    unsigned ca, cb;
    if constexpr (KPT > 0) {
      unsigned both = 0;
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        both += (ka[j] <= mid_a ? 1u : 0u) +
                (kb[j] <= mid_b ? 0x10000u : 0u);
      both = block_sum<false>(both, nullptr, buf);
      ca = both & 0xffffu;
      cb = both >> 16;
    } else {
      ca = 0;
      cb = 0;
      for (int i = threadIdx.x; i < N; i += NT) {
        const bool on = m[i];
        ca += (on ? __float_as_int(x[i]) : big) <= mid_a ? 1u : 0u;
        cb += (on ? __float_as_int(y[i]) : big) <= mid_b ? 1u : 0u;
      }
      ca = block_sum<true>(ca, &cb, buf);
    }
    halve(ca, k, mid_a, lo_a, hi_a);
    halve(cb, k, mid_b, lo_b, hi_b);
  }
  if (threadIdx.x == 0) {
    meds[blockIdx.x * 2 + 0] = __int_as_float(lo_a);
    meds[blockIdx.x * 2 + 1] = __int_as_float(lo_b);
    cnt_out[blockIdx.x] = (int)cnt;
  }
}

// The register keys per thread of rows of N keys: the first of KPTS
// that holds the row, or 0 (keys re-read) past REG_KEYS.
constexpr int KPTS[] = {1, 2, 3, 4, 6, 8, 12, 16, 24, 32};

int keys_per_thread(int N) {
  for (int kpt : KPTS)
    if (kpt * NT >= N && kpt * NT <= REG_KEYS) return kpt;
  return 0;
}

// Calls f with the kernel for rows of N keys.
template <int I = 0, typename Fn>
cudaError_t on_kernel(int N, Fn f) {
  if constexpr (I < (int)(sizeof(KPTS) / sizeof(KPTS[0]))) {
    if constexpr (KPTS[I] * NT <= REG_KEYS) {
      if (keys_per_thread(N) == KPTS[I]) return f(median2_kernel<KPTS[I]>);
    }
    return on_kernel<I + 1>(N, f);
  } else {
    return f(median2_kernel<0>);
  }
}

}  // namespace

extern "C" int tpuslam_masked_median2(const void* a, const void* b,
                                      const void* mask, void* meds,
                                      void* cnt, int F, int N,
                                      void* stream) {
  if (F < 1 || N < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)on_kernel(N, [&](auto kernel) {
    kernel<<<F, NT, 0, s>>>((const float*)a, (const float*)b,
                            (const bool*)mask, (float*)meds, (int*)cnt, N);
    return cudaGetLastError();
  });
}

// Registers, static shared memory and local memory per thread of the
// kernel that rows of N keys take, and its keys per thread (out[0..3]).
extern "C" int tpuslam_masked_median2_attrs(int N, int* out) {
  if (N < 1) return -1;
  out[3] = keys_per_thread(N);
  return (int)on_kernel(N, [&](auto kernel) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, kernel);
    if (e == cudaSuccess) {
      out[0] = a.numRegs;
      out[1] = (int)a.sharedSizeBytes;
      out[2] = (int)a.localSizeBytes;
    }
    return e;
  });
}
