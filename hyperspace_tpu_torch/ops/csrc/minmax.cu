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
// valid flag) and costs two selects and two compares, far below the card's
// flop-per-byte ridge, so the floor is n*(4+1) bytes over the HBM rate.
// Reaching it takes enough bytes in flight per SM to cover the memory
// latency: about 3.35 TB/s times a microsecond over 132 SMs, some 25 KB an
// SM. The first design (one row per thread, the x load issued only after
// its flag had arrived) kept about 10 KB in flight and ran at under half
// of the bound.
//
// Design: the memory side of filter_reduce.cu's filter_sum_vec, whose
// traffic is the same 5 B a row. The TPU kernel carries (min, max) in two
// resident (8,128) tiles over a sequential grid; blocks here run in
// parallel and in no order, so:
//   pass 1 (minmax_partials): a persistent grid of 4 blocks of 256 threads
//           an SM walks tiles of 512 rows, one tile a warp. Lane l loads,
//           for j < 4, the 4 valid bytes of rows 128j + 4l .. 128j + 4l + 3
//           as one 32-bit word and their 4 floats as one float4, so every
//           load instruction of the warp covers whole 128-byte lines. Each
//           thread loads two tiles (160 B) before it folds either: about
//           160 KB in flight an SM. No load waits on another: x is loaded
//           whatever valid holds, and each row is folded by a select
//           (valid ? x : +inf into the min, valid ? x : -inf into the
//           max), so valid keeps its != 0 byte meaning. The word and
//           float4 loads need valid 4-byte and x 16-byte aligned: when
//           either is not (an offset view), every row goes through the
//           scalar loop, which also takes the rows past the last whole
//           tile, with the same unconditional loads. A warp-shuffle then
//           shared-memory tree reduces the block, which writes one partial
//           pair;
//   pass 2 (minmax_finish): one block folds the partials in block order.
// No atomics: each thread folds its rows in an order fixed by its index
// and the grid, whose size depends only on n and the SM count (read once
// per device), so two launches on the same inputs give the same bits.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;  // 1024 threads an SM
constexpr int kTileRows = 512;   // a warp's rows per tile: 32 lanes x 4 words x 4
constexpr int kMaxDevices = 64;

std::atomic<int> g_sms[kMaxDevices];

// The SM count of `device`, queried once; a CUDA error code on failure.
cudaError_t sm_count(int device, int* sms) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int v = g_sms[device].load(std::memory_order_relaxed);
  if (v == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    g_sms[device].store(v, std::memory_order_relaxed);
  }
  *sms = v;
  return cudaSuccess;
}

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

// Folds one row: an invalid row contributes +inf / -inf, whatever v holds.
__device__ __forceinline__ void fold_row(bool ok, float v, float& mn, float& mx) {
  mn = min_nan(mn, ok ? v : INFINITY);
  mx = max_nan(mx, ok ? v : -INFINITY);
}

// Bit 7 of each byte of the result is set iff that byte of w is nonzero;
// the addition carries into no other byte.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
}

// Folds 4 rows: valid bytes in `w`, values in `v`, in row order.
__device__ __forceinline__ void fold_word(uint32_t w, float4 v, float& mn, float& mx) {
  const uint32_t nz = nonzero_bytes(w);
  fold_row((nz >> 7) & 1u, v.x, mn, mx);
  fold_row((nz >> 15) & 1u, v.y, mn, mx);
  fold_row((nz >> 23) & 1u, v.z, mn, mx);
  fold_row(nz >> 31, v.w, mn, mx);
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

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
minmax_partials(const float* __restrict__ x, const uint8_t* __restrict__ valid,
                int64_t n, bool vec, float* __restrict__ part_mn,
                float* __restrict__ part_mx) {
  __shared__ float s_mn[kWarps];
  __shared__ float s_mx[kWarps];
  float mn = INFINITY;
  float mx = -INFINITY;
  const int64_t tiles = vec ? n / kTileRows : 0;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int lane = threadIdx.x & 31;
  const uint32_t* vw = reinterpret_cast<const uint32_t*>(valid);
  const float4* xv = reinterpret_cast<const float4*>(x);
  // tile t holds words [128t, 128t + 128) of valid and float4s of x; this
  // lane's j-th is 128t + 32j + lane
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       t < tiles; t += 2 * warps) {
    const bool second = t + warps < tiles;
    const int64_t a = t * (kTileRows / 4) + lane;
    const int64_t b = (t + warps) * (kTileRows / 4) + lane;
    uint32_t va[4], vb[4];
    float4 xa[4], xb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      va[j] = __ldcs(vw + a + 32 * j);
      xa[j] = __ldcs(xv + a + 32 * j);
    }
    if (second) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vb[j] = __ldcs(vw + b + 32 * j);
        xb[j] = __ldcs(xv + b + 32 * j);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) fold_word(va[j], xa[j], mn, mx);
    if (second) {
#pragma unroll
      for (int j = 0; j < 4; ++j) fold_word(vb[j], xb[j], mn, mx);
    }
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = tiles * kTileRows + static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       i < n; i += stride) {
    fold_row(valid[i] != 0, x[i], mn, mx);
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

// The first pass's grid: enough blocks for one tile a warp, at most
// kBlocksPerSm an SM.
int grid_for(int sms, long long n) {
  const long long rows = static_cast<long long>(kTileRows) * kWarps;
  const long long blocks = (n + rows - 1) / rows;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Partial slots the first pass needs on `device` (its widest grid); a
// negative CUDA error code if the device cannot be queried.
extern "C" int hs_minmax_partial_slots(int device) {
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return sms * kBlocksPerSm;
}

// out: float[2] = (min, max). part_mn, part_mx: float[hs_minmax_partial_slots(device)].
extern "C" int hs_masked_min_max(int device, const void* x, const void* valid,
                                 long long n, void* part_mn, void* part_mx, void* out,
                                 void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(sms, n);
  const bool vec = aligned(valid, 4) && aligned(x, 16);
  minmax_partials<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(valid), n, vec,
      static_cast<float*>(part_mn), static_cast<float*>(part_mx));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  minmax_finish<<<1, kThreads, 0, st>>>(static_cast<const float*>(part_mn),
                                        static_cast<const float*>(part_mx), grid,
                                        static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
