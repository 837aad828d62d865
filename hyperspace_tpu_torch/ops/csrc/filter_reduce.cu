// Masked sum-and-count reductions for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in hyperspace_tpu/ops/pallas_kernels.py:
//   hs_filter_weighted_sum  <- filter_weighted_sum (_filter_sum_kernel)
//   hs_filter_sum           <- filter_sum (_filter_plain_sum_kernel)
// Both compute (sum over rows of pred*x[*y] in f32, count(pred) in int32).
//
// What bounds it on the card: bytes. Each row is read once (1 B predicate,
// 4 B per measure) and costs at most three f32 operations, far below the
// card's flop-per-byte ridge, so the floor is n*(1+4+4) or n*(1+4) bytes
// over the HBM rate.
//
// Design. The TPU kernel carries its sums in one resident (8,128) tile over
// a sequential grid. Blocks here run in parallel and in no order, so:
//   pass 1: a grid whose size depends only on n walks the rows with a
//           grid-stride loop; each thread keeps its f32 sum and int32 count
//           in registers; a warp-shuffle then shared-memory tree reduces
//           the block, which writes one partial;
//   pass 2: one block reduces the partials in a fixed order.
// No float atomics: two launches on the same inputs give the same bits.
// Counts stay int32, as on the TPU (f32 rounds above 2^24 rows). Padding
// rows carry pred = 0, so they add nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum in a fixed order; the result is valid in thread 0.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  T r = T(0);
  if (warp == 0) {
    r = lane < kWarps ? smem[lane] : T(0);
    r = warp_sum(r);
  }
  return r;
}

template <bool kHasY>
__global__ void __launch_bounds__(kThreads)
filter_sum_partials(const uint8_t* __restrict__ pred, const float* __restrict__ x,
                    const float* __restrict__ y, int64_t n,
                    float* __restrict__ part_s, int* __restrict__ part_c) {
  __shared__ float s_sum[kWarps];
  __shared__ int s_cnt[kWarps];
  float s = 0.f;
  int c = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const uint8_t pv = pred[i];
    // (pred * x) * y, the TPU kernel's order of operations
    float v = (pv ? 1.f : 0.f) * x[i];
    if (kHasY) v *= y[i];
    s += v;
    c += pv ? 1 : 0;
  }
  s = block_sum(s, s_sum);
  c = block_sum(c, s_cnt);
  if (threadIdx.x == 0) {
    part_s[blockIdx.x] = s;
    part_c[blockIdx.x] = c;
  }
}

__global__ void __launch_bounds__(kThreads)
filter_sum_finish(const float* __restrict__ part_s, const int* __restrict__ part_c,
                  int parts, float* __restrict__ out_s, int* __restrict__ out_c) {
  __shared__ float s_sum[kWarps];
  __shared__ int s_cnt[kWarps];
  float s = 0.f;
  int c = 0;
  for (int i = threadIdx.x; i < parts; i += kThreads) {
    s += part_s[i];
    c += part_c[i];
  }
  s = block_sum(s, s_sum);
  c = block_sum(c, s_cnt);
  if (threadIdx.x == 0) {
    *out_s = s;
    *out_c = c;
  }
}

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <bool kHasY>
int launch(int device, const void* pred, const void* x, const void* y, long long n,
           void* part_s, void* part_c, void* out_s, void* out_c, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(n);
  filter_sum_partials<kHasY><<<grid, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(pred), static_cast<const float*>(x),
      static_cast<const float*>(y), n, static_cast<float*>(part_s),
      static_cast<int*>(part_c));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  filter_sum_finish<<<1, kThreads, 0, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_c), grid,
      static_cast<float*>(out_s), static_cast<int*>(out_c));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hs_filter_partial_slots() { return kMaxBlocks; }

extern "C" int hs_filter_weighted_sum(int device, const void* pred, const void* x,
                                      const void* y, long long n, void* part_s,
                                      void* part_c, void* out_s, void* out_c,
                                      void* stream) {
  return launch<true>(device, pred, x, y, n, part_s, part_c, out_s, out_c, stream);
}

extern "C" int hs_filter_sum(int device, const void* pred, const void* x, long long n,
                             void* part_s, void* part_c, void* out_s, void* out_c,
                             void* stream) {
  return launch<false>(device, pred, x, nullptr, n, part_s, part_c, out_s, out_c,
                       stream);
}
