// Masked min/max reduction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in hyperspace_tpu/ops/pallas_kernels.py:
//   hs_masked_min_max  <- masked_min_max (_minmax_kernel)
// It computes (min, max) in f32 over the rows where valid is set, and
// (+inf, -inf) when no row is valid.
//
// NaN semantics follow jnp.minimum / jnp.maximum, which the TPU kernel
// folds with: a NaN in a valid row makes the result NaN. fminf/fmaxf would
// drop it, so every fold below propagates NaN explicitly. An invalid row
// contributes +inf / -inf, whatever its value, NaN included.
//
// What bounds it on the card: bytes. Each row is read once (4 B value, 1 B
// valid flag) and costs two compares, so the floor is n*(4+1) bytes over
// the HBM rate.
//
// Design, as filter_reduce.cu. The TPU kernel carries (min, max) in two
// resident (8,128) tiles over a sequential grid; blocks here run in
// parallel and in no order, so:
//   pass 1: a grid whose size depends only on n walks the rows with a
//           grid-stride loop; each thread keeps its min and max in
//           registers; a warp-shuffle then shared-memory tree reduces the
//           block, which writes one partial pair;
//   pass 2: one block folds the partials in a fixed order.
// No atomics: two launches on the same inputs give the same bits.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;

// min/max that keep a NaN from either side (jnp.minimum / jnp.maximum)
__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

__device__ __forceinline__ void warp_fold(float& mn, float& mx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = min_nan(mn, __shfl_down_sync(0xffffffffu, mn, o));
    mx = max_nan(mx, __shfl_down_sync(0xffffffffu, mx, o));
  }
}

// Block-wide fold in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ void block_fold(float& mn, float& mx, float* s_mn,
                                           float* s_mx) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_fold(mn, mx);
  if (lane == 0) {
    s_mn[warp] = mn;
    s_mx[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    mn = lane < kWarps ? s_mn[lane] : INFINITY;
    mx = lane < kWarps ? s_mx[lane] : -INFINITY;
    warp_fold(mn, mx);
  }
}

__global__ void __launch_bounds__(kThreads)
minmax_partials(const float* __restrict__ x, const uint8_t* __restrict__ valid,
                int64_t n, float* __restrict__ part_mn, float* __restrict__ part_mx) {
  __shared__ float s_mn[kWarps];
  __shared__ float s_mx[kWarps];
  float mn = INFINITY;
  float mx = -INFINITY;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    if (valid[i]) {
      const float v = x[i];
      mn = min_nan(mn, v);
      mx = max_nan(mx, v);
    }
  }
  block_fold(mn, mx, s_mn, s_mx);
  if (threadIdx.x == 0) {
    part_mn[blockIdx.x] = mn;
    part_mx[blockIdx.x] = mx;
  }
}

__global__ void __launch_bounds__(kThreads)
minmax_finish(const float* __restrict__ part_mn, const float* __restrict__ part_mx,
              int parts, float* __restrict__ out) {
  __shared__ float s_mn[kWarps];
  __shared__ float s_mx[kWarps];
  float mn = INFINITY;
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < parts; i += kThreads) {
    mn = min_nan(mn, part_mn[i]);
    mx = max_nan(mx, part_mx[i]);
  }
  block_fold(mn, mx, s_mn, s_mx);
  if (threadIdx.x == 0) {
    out[0] = mn;
    out[1] = mx;
  }
}

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" int hs_minmax_partial_slots() { return kMaxBlocks; }

// out: float[2] = (min, max). part_mn, part_mx: float[hs_minmax_partial_slots()].
extern "C" int hs_masked_min_max(int device, const void* x, const void* valid,
                                 long long n, void* part_mn, void* part_mx, void* out,
                                 void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(n);
  minmax_partials<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(valid), n,
      static_cast<float*>(part_mn), static_cast<float*>(part_mx));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  minmax_finish<<<1, kThreads, 0, st>>>(static_cast<const float*>(part_mn),
                                        static_cast<const float*>(part_mx), grid,
                                        static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
