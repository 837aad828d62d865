// Masked sum-and-count reductions for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in hyperspace_tpu/ops/pallas_kernels.py:
//   hs_filter_weighted_sum  <- filter_weighted_sum (_filter_sum_kernel)
//   hs_filter_sum           <- filter_sum (_filter_plain_sum_kernel)
// Both compute (sum over rows of pred*x[*y] in f32, count(pred) in int32).
//
// What bounds them on the card: bytes. Each row is read once (1 B predicate,
// 4 B per measure) and costs at most three f32 operations, far below the
// card's flop-per-byte ridge, so the floor is n*(1+4+4) or n*(1+4) bytes
// over the HBM rate. Reaching it takes enough bytes in flight per SM to
// cover the memory latency: about 3.35 TB/s times a microsecond over 132
// SMs, some 25 KB an SM.
//
// Two first passes, one per function. The TPU kernel carries its sums in one
// resident (8,128) tile over a sequential grid; blocks here run in parallel
// and in no order, so each thread sums its own rows in registers, a
// warp-shuffle then shared-memory tree reduces the block to one partial,
// and a second launch (filter_sum_finish, one block) folds the partials in
// block order.
//   - filter_weighted_sum keeps its first design, filter_sum_partials<true>:
//     a grid of up to 1024 blocks of 256 threads walks the rows with scalar
//     1- and 4-byte loads, one row per thread in flight. It reaches about
//     two thirds of its bound and is left as it was.
//   - filter_sum ran at under half of its bound with that design (about
//     10 KB in flight an SM), so it has a kernel of its own,
//     filter_sum_vec: a warp takes 512 rows per tile, and lane l loads, for
//     j < 4, the 4 predicate bytes of rows 128j + 4l .. 128j + 4l + 3 as one
//     32-bit word and their 4 floats as one float4. Every load instruction
//     of the warp then covers whole 128-byte lines, which one 16-byte
//     predicate load per lane beside 64 contiguous bytes of x per lane
//     would not. Each thread loads two tiles (160 B) before it adds either;
//     a persistent grid of 4 blocks an SM (1024 threads, about 160 KB in
//     flight) walks the tiles. The count is a popcount of each word's
//     nonzero bytes, so pred keeps its != 0 meaning. The word and float4
//     loads need pred 4-byte and x 16-byte aligned: when either is not (an
//     offset view), the kernel sums every row in its scalar loop, which
//     also takes the rows past the last whole tile.
// No float atomics: each thread adds its rows in an order fixed by its
// index and the grid, whose size depends only on n and the SM count (read
// once per device), so two launches on the same inputs give the same bits.
// Counts stay int32, as on the TPU (f32 rounds above 2^24 rows). Padding
// rows carry pred = 0, so they add nothing.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;
constexpr int kSumBlocksPerSm = 4;  // filter_sum_vec: 1024 threads an SM
constexpr int kTileRows = 512;      // a warp's rows per tile: 32 lanes x 4 words x 4
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

// Bit 7 of each byte of the result is set iff that byte of w is nonzero;
// the addition carries into no other byte.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
}

// Adds 4 rows: pred bytes in `w`, values in `v`, in row order.
__device__ __forceinline__ void add_word(uint32_t w, float4 v, float& s, int& c) {
  const uint32_t nz = nonzero_bytes(w);
  c += __popc(nz);
  s += ((nz >> 7) & 1u ? 1.f : 0.f) * v.x;
  s += ((nz >> 15) & 1u ? 1.f : 0.f) * v.y;
  s += ((nz >> 23) & 1u ? 1.f : 0.f) * v.z;
  s += (nz >> 31 ? 1.f : 0.f) * v.w;
}

__global__ void __launch_bounds__(kThreads, kSumBlocksPerSm)
filter_sum_vec(const uint8_t* __restrict__ pred, const float* __restrict__ x, int64_t n,
               bool vec, float* __restrict__ part_s, int* __restrict__ part_c) {
  __shared__ float s_sum[kWarps];
  __shared__ int s_cnt[kWarps];
  float s = 0.f;
  int c = 0;
  const int64_t tiles = vec ? n / kTileRows : 0;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int lane = threadIdx.x & 31;
  const uint32_t* pw = reinterpret_cast<const uint32_t*>(pred);
  const float4* xv = reinterpret_cast<const float4*>(x);
  // tile t holds words [128t, 128t + 128) of pred and float4s of x; this
  // lane's j-th is 128t + 32j + lane
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       t < tiles; t += 2 * warps) {
    const bool second = t + warps < tiles;
    const int64_t a = t * (kTileRows / 4) + lane;
    const int64_t b = (t + warps) * (kTileRows / 4) + lane;
    uint32_t pa[4], pb[4];
    float4 xa[4], xb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pa[j] = __ldcs(pw + a + 32 * j);
      xa[j] = __ldcs(xv + a + 32 * j);
    }
    if (second) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pb[j] = __ldcs(pw + b + 32 * j);
        xb[j] = __ldcs(xv + b + 32 * j);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) add_word(pa[j], xa[j], s, c);
    if (second) {
#pragma unroll
      for (int j = 0; j < 4; ++j) add_word(pb[j], xb[j], s, c);
    }
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = tiles * kTileRows + static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       i < n; i += stride) {
    const uint8_t pv = pred[i];
    s += (pv ? 1.f : 0.f) * x[i];
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

// filter_sum_vec's grid: enough blocks for one tile a warp, at most
// kSumBlocksPerSm an SM.
int sum_grid(int sms, long long n) {
  const long long rows = static_cast<long long>(kTileRows) * kWarps;
  const long long blocks = (n + rows - 1) / rows;
  const long long cap = static_cast<long long>(sms) * kSumBlocksPerSm;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
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

// Partial slots either function needs on `device` (its widest grid); a
// negative CUDA error code if the device cannot be queried.
extern "C" int hs_filter_partial_slots(int device) {
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int vec = sms * kSumBlocksPerSm;
  return vec > kMaxBlocks ? vec : kMaxBlocks;
}

extern "C" int hs_filter_weighted_sum(int device, const void* pred, const void* x,
                                      const void* y, long long n, void* part_s,
                                      void* part_c, void* out_s, void* out_c,
                                      void* stream) {
  return launch<true>(device, pred, x, y, n, part_s, part_c, out_s, out_c, stream);
}

extern "C" int hs_filter_sum(int device, const void* pred, const void* x, long long n,
                             void* part_s, void* part_c, void* out_s, void* out_c,
                             void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = sum_grid(sms, n);
  const bool vec = aligned(pred, 4) && aligned(x, 16);
  filter_sum_vec<<<grid, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(pred), static_cast<const float*>(x), n, vec,
      static_cast<float*>(part_s), static_cast<int*>(part_c));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  filter_sum_finish<<<1, kThreads, 0, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_c), grid,
      static_cast<float*>(out_s), static_cast<int*>(out_c));
  return static_cast<int>(cudaGetLastError());
}
