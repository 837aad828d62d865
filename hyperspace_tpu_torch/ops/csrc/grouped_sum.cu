// Small-domain grouped masked sums for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel filter_grouped_multi_sum
// (_grouped_multi_sum_kernel_body) in hyperspace_tpu/ops/pallas_kernels.py:
// for every group g < G <= 16, the sum of each of k measures over rows with
// pred && gid == g, plus the shared count, in one pass over pred and gids.
//
// What bounds it on the card: bytes, n*(1 + 4 + 4k) read once. The per-row
// work is 16 compares and 16*(k+1) selects, a few dozen operations against
// 5 + 4k bytes, still under the card's integer/f32 ridge.
//
// Design. The TPU kernel unrolls the group domain over per-group resident
// (8,128) tiles. Here every thread keeps 16*(k+1) accumulators in registers
// and, for each row, adds the row into the matching slot through a fully
// unrolled compare-and-select over all 16 slots (a register array indexed
// by a runtime gid would spill to local memory). Rows with a gid outside
// [0, G) land in no slot below G, as on the TPU. Each block then reduces
// its slots by warp shuffles and a fixed-order pass over the warps, and
// writes one partial per slot; a second launch sums the partials over the
// blocks in block order. No float atomics: repeat launches give the same
// bits. At most kMaxMeasures measures go through one launch; the wrapper
// runs more as several passes, which give the same bits per measure since
// each measure's sums never depend on the others.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;
constexpr int kSlots = 16;  // _MAX_PALLAS_GROUPS in the JAX package
constexpr int kMaxMeasures = 4;

struct Measures {
  const float* p[kMaxMeasures];
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
grouped_partials(const uint8_t* __restrict__ pred, const int32_t* __restrict__ gids,
                 Measures xs, int64_t n, float* __restrict__ part_s,
                 int* __restrict__ part_c) {
  constexpr int KA = K > 0 ? K : 1;
  float acc[KA][kSlots];
  int cnt[kSlots];
#pragma unroll
  for (int g = 0; g < kSlots; ++g) {
    cnt[g] = 0;
#pragma unroll
    for (int k = 0; k < KA; ++k) acc[k][g] = 0.f;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const bool p = pred[i] != 0;
    const int gid = gids[i];
    float v[KA];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = xs.p[k][i];
#pragma unroll
    for (int g = 0; g < kSlots; ++g) {
      const bool m = p && gid == g;
      cnt[g] += m ? 1 : 0;
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k][g] += m ? v[k] : 0.f;
    }
  }

  __shared__ float s_acc[kWarps][KA * kSlots];
  __shared__ int s_cnt[kWarps][kSlots];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < kSlots; ++g) {
    const int c = warp_sum(cnt[g]);
    if (lane == 0) s_cnt[warp][g] = c;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float a = warp_sum(acc[k][g]);
      if (lane == 0) s_acc[warp][k * kSlots + g] = a;
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < K * kSlots) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += s_acc[w][t];
    part_s[static_cast<int64_t>(blockIdx.x) * K * kSlots + t] = a;
  }
  if (t < kSlots) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += s_cnt[w][t];
    part_c[static_cast<int64_t>(blockIdx.x) * kSlots + t] = c;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
grouped_finish(const float* __restrict__ part_s, const int* __restrict__ part_c,
               int parts, float* __restrict__ out_s, int* __restrict__ out_c) {
  const int t = threadIdx.x;
  if (t < K * kSlots) {
    float a = 0.f;
    for (int b = 0; b < parts; ++b) a += part_s[b * K * kSlots + t];
    out_s[t] = a;
  }
  if (t < kSlots) {
    int c = 0;
    for (int b = 0; b < parts; ++b) c += part_c[b * kSlots + t];
    out_c[t] = c;
  }
}

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <int K>
int launch(const void* pred, const void* gids, const Measures& xs, long long n,
           void* part_s, void* part_c, void* out_s, void* out_c, cudaStream_t st) {
  const int grid = grid_for(n);
  grouped_partials<K><<<grid, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(pred), static_cast<const int32_t*>(gids), xs, n,
      static_cast<float*>(part_s), static_cast<int*>(part_c));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grouped_finish<K><<<1, kThreads, 0, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_c), grid,
      static_cast<float*>(out_s), static_cast<int*>(out_c));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hs_grouped_partial_blocks() { return kMaxBlocks; }
extern "C" int hs_grouped_slots() { return kSlots; }
extern "C" int hs_grouped_max_measures() { return kMaxMeasures; }

// xs: a host array of k device pointers (f32, n rows each). Outputs:
// out_s[k][16] sums and out_c[16] counts; the caller keeps the first G.
extern "C" int hs_filter_grouped_multi_sum(int device, const void* pred,
                                           const void* gids, const void* const* xs,
                                           int k, long long n, void* part_s,
                                           void* part_c, void* out_s, void* out_c,
                                           void* stream) {
  if (n <= 0 || k < 0 || k > kMaxMeasures) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Measures m{};
  for (int i = 0; i < k; ++i) m.p[i] = static_cast<const float*>(xs[i]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 0: return launch<0>(pred, gids, m, n, part_s, part_c, out_s, out_c, st);
    case 1: return launch<1>(pred, gids, m, n, part_s, part_c, out_s, out_c, st);
    case 2: return launch<2>(pred, gids, m, n, part_s, part_c, out_s, out_c, st);
    case 3: return launch<3>(pred, gids, m, n, part_s, part_c, out_s, out_c, st);
    default: return launch<4>(pred, gids, m, n, part_s, part_c, out_s, out_c, st);
  }
}
