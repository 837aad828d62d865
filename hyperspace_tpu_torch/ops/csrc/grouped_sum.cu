// Small-domain grouped masked sums for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel filter_grouped_multi_sum
// (_grouped_multi_sum_kernel_body) in hyperspace_tpu/ops/pallas_kernels.py:
// for every group g < G <= 16, the sum of each of k measures over rows with
// pred && gid == g, plus the shared count, in one pass over pred and gids.
//
// What bounds it on the card: bytes, n*(1 + 4 + 4k) read once, over the
// HBM rate. The TPU kernel unrolls the group domain over per-group resident
// (8,128) tiles, so every row touches all 16 groups. Carried over as a
// compare-and-select over 16*(k+1) register accumulators, that cost about
// 144 instructions a row at k = 3: as long to issue as the bytes take to
// arrive, and 64 live accumulators held occupancy down.
//
// Design: per-thread group slots in shared memory, indexed by gid.
//   - Each thread owns 16*(k+1) words of dynamic shared memory: 16 int
//     counts, then 16 f32 sums for each measure. Word v of thread t sits at
//     v*256 + t, so lane t always reaches bank t mod 32 whatever the gids:
//     no bank conflicts. A row costs one read-modify-write per measure and
//     one for the count, taken only when pred holds and (unsigned)gid < 16
//     (rows with a gid outside [0, 16) count nowhere; slots G..15 are
//     computed and dropped by the caller, as on the TPU).
//   - A warp takes 512 rows per tile: lane l loads, for j < 4, the 4
//     predicate bytes of rows 128j + 4l .. 128j + 4l + 3 as one 32-bit word,
//     their gids as one int4 and each measure's values as one float4, so
//     every load instruction of the warp covers whole 128-byte lines. That is
//     16 rows and 16*(5 + 4k) bytes a thread per tile: 272 B at k = 3.
//   - The slots take (k+1)*16 KB a block of 256 threads, so an SM holds
//     4 blocks up to k = 2, 3 at k = 3 (192 KB, 768 threads, up to about
//     200 KB of loads in flight) and 2 at k = 4; the grid is that many per
//     SM (SM count read once per device), persistent over the tiles.
//   - The word, int4 and float4 loads need pred 4-byte and the other
//     columns 16-byte aligned; when one is not (an offset view), the kernel
//     adds every row in its scalar loop, which also takes the rows past the
//     last whole tile.
//   - Block fold: one warp per slot word; each lane adds 8 threads' words in
//     thread order, then a shuffle tree; lane 0 writes the block's partial.
//   - Cross-block fold, a second launch: one warp per output value; lane l
//     adds the partials of blocks l, l + 32, ... in order, then a shuffle
//     tree.
// Each thread adds its own rows in row order and every fold runs in an
// order fixed by thread and block index, never by arrival: no float
// atomics, and two launches on the same inputs give the same bits. At most
// kMaxMeasures measures go through one launch; the wrapper runs more as
// several passes, which give the same bits per measure since each
// measure's sums never depend on the others.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 16;  // _MAX_PALLAS_GROUPS in the JAX package
constexpr int kMaxMeasures = 4;
constexpr int kTileRows = 512;  // a warp's rows per tile: 32 lanes x 4 words x 4
constexpr int kMaxDevices = 64;

// Slot words a thread owns at K measures, and the block's shared memory.
__host__ __device__ constexpr int slot_words(int k) { return kSlots * (k + 1); }
constexpr int smem_bytes(int k) { return slot_words(k) * kThreads * 4; }
// Blocks an SM holds: 228 KB of shared memory, 1 KB reserved a block,
// at most 1024 threads an SM (64 registers a thread).
constexpr int blocks_per_sm(int k) { return k <= 2 ? 4 : (k == 3 ? 3 : 2); }

struct Measures {
  const float* p[kMaxMeasures];
};

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

// Adds one row into this thread's slots: `cnt` and `sum` point at its
// column (word 0 of slot 0).
template <int K>
__device__ __forceinline__ void add_row(bool p, int gid, const float* v, int* cnt,
                                        float* sum) {
  if (p && static_cast<unsigned>(gid) < kSlots) {
    cnt[gid * kThreads] += 1;
#pragma unroll
    for (int k = 0; k < K; ++k) sum[(k * kSlots + gid) * kThreads] += v[k];
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(K))
grouped_partials(const uint8_t* __restrict__ pred, const int32_t* __restrict__ gids,
                 Measures xs, int64_t n, bool vec, float* __restrict__ part_s,
                 int* __restrict__ part_c) {
  constexpr int KA = K > 0 ? K : 1;
  // 16 int counts, then K*16 f32 sums, measure-major: word v of thread t at
  // v*kThreads + t. Each word is only ever accessed as its own type.
  extern __shared__ int slots[];
  int* const counts = slots;
  float* const sums = reinterpret_cast<float*>(slots + kSlots * kThreads);
  const int t = threadIdx.x;
  const int lane = t & 31;
  int* cnt = counts + t;
  float* sum = sums + t;
#pragma unroll
  for (int v = 0; v < kSlots; ++v) cnt[v * kThreads] = 0;
#pragma unroll
  for (int v = 0; v < K * kSlots; ++v) sum[v * kThreads] = 0.f;

  const int64_t tiles = vec ? n / kTileRows : 0;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const uint32_t* pw = reinterpret_cast<const uint32_t*>(pred);
  const int4* gv = reinterpret_cast<const int4*>(gids);
  // tile w holds words [128w, 128w + 128) of pred and int4/float4s of the
  // other columns; this lane's j-th is 128w + 32j + lane
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + (t >> 5); w < tiles;
       w += warps) {
    const int64_t a = w * (kTileRows / 4) + lane;
    uint32_t p[4];
    int4 g[4];
    float4 x[KA][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[j] = __ldcs(pw + a + 32 * j);
      g[j] = __ldcs(gv + a + 32 * j);
#pragma unroll
      for (int k = 0; k < K; ++k)
        x[k][j] = __ldcs(reinterpret_cast<const float4*>(xs.p[k]) + a + 32 * j);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v[KA];
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = x[k][j].x;
      add_row<K>((p[j] & 0x000000ffu) != 0, g[j].x, v, cnt, sum);
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = x[k][j].y;
      add_row<K>((p[j] & 0x0000ff00u) != 0, g[j].y, v, cnt, sum);
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = x[k][j].z;
      add_row<K>((p[j] & 0x00ff0000u) != 0, g[j].z, v, cnt, sum);
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = x[k][j].w;
      add_row<K>((p[j] & 0xff000000u) != 0, g[j].w, v, cnt, sum);
    }
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = tiles * kTileRows + static_cast<int64_t>(blockIdx.x) * kThreads + t;
       i < n; i += stride) {
    float v[KA];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = xs.p[k][i];
    add_row<K>(pred[i] != 0, gids[i], v, cnt, sum);
  }
  __syncthreads();

  // block fold: warp w takes slot words w, w + kWarps, ...
  for (int v = t >> 5; v < slot_words(K); v += kWarps) {
    if (v < kSlots) {
      int c = 0;
#pragma unroll
      for (int i = 0; i < kThreads / 32; ++i) c += counts[v * kThreads + 32 * i + lane];
      c = warp_sum(c);
      if (lane == 0) part_c[v * gridDim.x + blockIdx.x] = c;
    } else {
      const int u = v - kSlots;
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < kThreads / 32; ++i) a += sums[u * kThreads + 32 * i + lane];
      a = warp_sum(a);
      if (lane == 0) part_s[u * gridDim.x + blockIdx.x] = a;
    }
  }
}

// One warp per output value: 16 counts, then K*16 sums (measure-major).
template <int K>
__global__ void __launch_bounds__(kThreads)
grouped_fold(const float* __restrict__ part_s, const int* __restrict__ part_c, int parts,
             float* __restrict__ out_s, int* __restrict__ out_c) {
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (v < kSlots) {
    int c = 0;
    for (int b = lane; b < parts; b += 32) c += part_c[v * parts + b];
    c = warp_sum(c);
    if (lane == 0) out_c[v] = c;
  } else if (v < slot_words(K)) {
    const int u = v - kSlots;
    float a = 0.f;
    for (int b = lane; b < parts; b += 32) a += part_s[u * parts + b];
    a = warp_sum(a);
    if (lane == 0) out_s[u] = a;
  }
}

// Enough blocks for one tile a warp, at most blocks_per_sm(K) an SM.
int grid_for(int sms, int k, long long n) {
  const long long rows = static_cast<long long>(kTileRows) * kWarps;
  const long long blocks = (n + rows - 1) / rows;
  const long long cap = static_cast<long long>(sms) * blocks_per_sm(k);
  return static_cast<int>(blocks < cap ? blocks : cap);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int K>
int launch(int device, int sms, const void* pred, const void* gids, const Measures& xs,
           bool vec, long long n, void* part_s, void* part_c, void* out_s, void* out_c,
           cudaStream_t st) {
  // above 48 KB a block needs the opt-in; the carveout asks for all of the
  // SM's 228 KB as shared memory. Set once per device.
  static std::atomic<bool> ready[kMaxDevices];
  if (!ready[device].load(std::memory_order_acquire)) {
    cudaError_t err = cudaFuncSetAttribute(
        grouped_partials<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(K));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(grouped_partials<K>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device].store(true, std::memory_order_release);
  }
  const int grid = grid_for(sms, K, n);
  grouped_partials<K><<<grid, kThreads, smem_bytes(K), st>>>(
      static_cast<const uint8_t*>(pred), static_cast<const int32_t*>(gids), xs, n, vec,
      static_cast<float*>(part_s), static_cast<int*>(part_c));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grouped_fold<K><<<(slot_words(K) + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_c), grid,
      static_cast<float*>(out_s), static_cast<int*>(out_c));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hs_grouped_slots() { return kSlots; }
extern "C" int hs_grouped_max_measures() { return kMaxMeasures; }

// The widest grid a launch with k measures takes on `device`: the caller
// sizes the partials as 16 ints and 16*k floats per block. A negative CUDA
// error code if the device cannot be queried, or k is out of range.
extern "C" int hs_grouped_partial_blocks(int device, int k) {
  if (k < 0 || k > kMaxMeasures) return -static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return sms * blocks_per_sm(k);
}

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
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  Measures m{};
  bool vec = aligned(pred, 4) && aligned(gids, 16);
  for (int i = 0; i < k; ++i) {
    m.p[i] = static_cast<const float*>(xs[i]);
    vec = vec && aligned(xs[i], 16);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 0: return launch<0>(device, sms, pred, gids, m, vec, n, part_s, part_c, out_s, out_c, st);
    case 1: return launch<1>(device, sms, pred, gids, m, vec, n, part_s, part_c, out_s, out_c, st);
    case 2: return launch<2>(device, sms, pred, gids, m, vec, n, part_s, part_c, out_s, out_c, st);
    case 3: return launch<3>(device, sms, pred, gids, m, vec, n, part_s, part_c, out_s, out_c, st);
    default: return launch<4>(device, sms, pred, gids, m, vec, n, part_s, part_c, out_s, out_c, st);
  }
}
