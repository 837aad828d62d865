// hs_native: host-side hot loops of the index build and the host join, in
// C++ (a copy of the JAX package's native/hs_native.cpp, the same entry
// points at the same ABI, 4).
//
// One pass computes the murmur-style hash (bit-identical to
// ops/hashing.py: the bucket layout is an on-disk contract), a
// counting-sort partition replaces the O(n log n) stable argsort of the
// bucket ids with O(n + buckets), an LSD radix argsort sorts int keys
// within a bucket, a chained hash table joins factorized int64 codes, and
// one binary search per left row fuses the probe and the per-key sums of
// the co-partitioned join+aggregate.
//
// Build: hyperspace_tpu_torch/native/__init__.py runs
// g++ -O3 -std=c++17 -shared -fPIC at first use, into build/native/.
// Bound with ctypes (plain C entry points).

#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t C1 = 0xCC9E2D51u;
constexpr uint32_t C2 = 0x1B873593u;
constexpr uint32_t SEED = 42u;

inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

inline uint32_t mix_round(uint32_t h, uint32_t k) {
  k *= C1;
  k = rotl32(k, 15);
  k *= C2;
  h ^= k;
  h = rotl32(h, 13);
  h = h * 5u + 0xE6546B64u;
  return h;
}

inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

}  // namespace

extern "C" {

// hash of a single int64 key column: words (lo, hi), matching
// ops/hashing.hash32_np's int64 decomposition
void hs_hash32_i64(const int64_t* keys, int64_t n, uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t bits;
    std::memcpy(&bits, &keys[i], 8);
    uint32_t h = SEED;
    h = mix_round(h, static_cast<uint32_t>(bits & 0xFFFFFFFFull));
    h = mix_round(h, static_cast<uint32_t>(bits >> 32));
    out[i] = fmix32(h);
  }
}

// hash of a single int32 key column (one word)
void hs_hash32_i32(const int32_t* keys, int64_t n, uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t h = SEED;
    h = mix_round(h, static_cast<uint32_t>(keys[i]));
    out[i] = fmix32(h);
  }
}

// hash of pre-extracted uint32 words, w columns laid out column-major
// (words[c*n + i]): the generic multi-column path
void hs_hash32_words(const uint32_t* words, int64_t n, int32_t w, uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t h = SEED;
    for (int32_t c = 0; c < w; ++c) {
      h = mix_round(h, words[static_cast<int64_t>(c) * n + i]);
    }
    out[i] = fmix32(h);
  }
}

// stable counting-sort partition by bucket = hash % num_buckets.
// Outputs: bucket_ids[n], order[n] (row indices grouped by bucket, stable
// within bucket), offsets[num_buckets+1] (bucket boundaries in order).
void hs_bucket_partition(const uint32_t* hashes, int64_t n, int32_t num_buckets,
                         int32_t* bucket_ids, int64_t* order,
                         int64_t* offsets) {
  for (int32_t b = 0; b <= num_buckets; ++b) offsets[b] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t b = static_cast<int32_t>(hashes[i] % static_cast<uint32_t>(num_buckets));
    bucket_ids[i] = b;
    offsets[b + 1] += 1;
  }
  for (int32_t b = 0; b < num_buckets; ++b) offsets[b + 1] += offsets[b];
  // scatter (stable): cursor per bucket
  int64_t* cursor = new int64_t[num_buckets];
  for (int32_t b = 0; b < num_buckets; ++b) cursor[b] = offsets[b];
  for (int64_t i = 0; i < n; ++i) {
    order[cursor[bucket_ids[i]]++] = i;
  }
  delete[] cursor;
}

// Inner hash join of two int64 code arrays (pre-factorized join keys;
// negative codes are NULL sentinels that never match). Chained hash table
// over the RIGHT side, probe from the LEFT, preserving left-major then
// right-original pair order (the order np.repeat+expand_runs produces, so
// results are interchangeable with the numpy path).
//
// Writes up to `cap` pairs into li_out/ri_out and returns the TOTAL pair
// count; if the return value exceeds cap the caller must retry with a
// larger buffer (the table build is O(nr), so a retry is cheap).
int64_t hs_join_i64(const int64_t* lcodes, int64_t nl, const int64_t* rcodes,
                    int64_t nr, int64_t* li_out, int64_t* ri_out,
                    int64_t cap) {
  // power-of-two table, ~2x right rows
  int64_t tbits = 1;
  while ((int64_t(1) << tbits) < nr * 2) ++tbits;
  const int64_t tsize = int64_t(1) << tbits;
  const uint64_t mask = static_cast<uint64_t>(tsize - 1);
  int64_t* head = new int64_t[tsize];
  int64_t* next = new int64_t[nr > 0 ? nr : 1];
  for (int64_t i = 0; i < tsize; ++i) head[i] = -1;
  // insert right rows in REVERSE so chain traversal yields ascending
  // original right order per key
  for (int64_t j = nr - 1; j >= 0; --j) {
    int64_t c = rcodes[j];
    if (c < 0) { next[j] = -1; continue; }
    uint64_t h = static_cast<uint64_t>(c) * 0x9E3779B97F4A7C15ull;
    uint64_t slot = (h >> 17) & mask;
    next[j] = head[slot];
    head[slot] = j;
  }
  int64_t total = 0;
  for (int64_t i = 0; i < nl; ++i) {
    int64_t c = lcodes[i];
    if (c < 0) continue;
    uint64_t h = static_cast<uint64_t>(c) * 0x9E3779B97F4A7C15ull;
    for (int64_t j = head[(h >> 17) & mask]; j != -1; j = next[j]) {
      if (rcodes[j] == c) {
        if (total < cap) {
          li_out[total] = i;
          ri_out[total] = j;
        }
        ++total;
      }
    }
  }
  delete[] head;
  delete[] next;
  return total;
}

// Fused probe + per-key accumulation for the co-partitioned join+aggregate
// hot shape (one int64 equi-key, sorted unique right side, aggregate inputs
// from the left side): for each left row, one binary search finds its right
// key slot; counts and W weighted sums accumulate per slot in a single
// pass — no match-index materialization, no intermediate mask arrays.
// weights is column-major [w][nl]; sums_out is [w][nr]; counts_out is [nr].
// float64 accumulation matches the numpy bincount path bit-for-bit in
// exactness class. Returns the number of matched left rows.
int64_t hs_probe_agg_i64(const int64_t* lk, int64_t nl,
                         const int64_t* rk_sorted, int64_t nr,
                         const double* weights, int32_t w,
                         int64_t* counts_out, double* sums_out) {
  for (int64_t j = 0; j < nr; ++j) counts_out[j] = 0;
  for (int64_t j = 0; j < static_cast<int64_t>(w) * nr; ++j) sums_out[j] = 0.0;
  int64_t matched = 0;
  for (int64_t i = 0; i < nl; ++i) {
    const int64_t key = lk[i];
    int64_t lo = 0, hi = nr;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (rk_sorted[mid] < key) lo = mid + 1; else hi = mid;
    }
    if (lo >= nr || rk_sorted[lo] != key) continue;
    ++matched;
    counts_out[lo] += 1;
    for (int32_t c = 0; c < w; ++c) {
      sums_out[static_cast<int64_t>(c) * nr + lo] +=
          weights[static_cast<int64_t>(c) * nl + i];
    }
  }
  return matched;
}

// Stable LSD radix argsort on int64 keys (index-build bucket sort: numpy's
// stable argsort for int64 is a comparison sort; radix is O(n) per digit
// with uniform-digit passes skipped — key ranges rarely span all 8 bytes).
void hs_radix_argsort_i64(const int64_t* keys, int64_t n, int64_t* order) {
  // bias to unsigned so negatives order before non-negatives
  static constexpr uint64_t BIAS = 0x8000000000000000ull;
  auto hist = new int64_t[8][256]();
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t k = static_cast<uint64_t>(keys[i]) ^ BIAS;
    for (int d = 0; d < 8; ++d) ++hist[d][(k >> (d * 8)) & 0xFF];
  }
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  int64_t* tmp = new int64_t[n > 0 ? n : 1];
  int64_t* src = order;
  int64_t* dst = tmp;
  for (int d = 0; d < 8; ++d) {
    const int64_t* h = hist[d];
    int nonzero = 0;
    for (int b = 0; b < 256 && nonzero < 2; ++b) nonzero += h[b] != 0;
    if (nonzero < 2) continue;  // uniform digit: pass is the identity
    int64_t offs[256];
    int64_t run = 0;
    for (int b = 0; b < 256; ++b) {
      offs[b] = run;
      run += h[b];
    }
    const int shift = d * 8;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t idx = src[i];
      const uint64_t k = static_cast<uint64_t>(keys[idx]) ^ BIAS;
      dst[offs[(k >> shift) & 0xFF]++] = idx;
    }
    int64_t* t = src;
    src = dst;
    dst = t;
  }
  if (src != order) std::memcpy(order, src, static_cast<size_t>(n) * 8);
  delete[] tmp;
  delete[] hist;
}

// int32 variant (dates, dictionary codes): 4 digit passes
void hs_radix_argsort_i32(const int32_t* keys, int64_t n, int64_t* order) {
  static constexpr uint32_t BIAS = 0x80000000u;
  auto hist = new int64_t[4][256]();
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t k = static_cast<uint32_t>(keys[i]) ^ BIAS;
    for (int d = 0; d < 4; ++d) ++hist[d][(k >> (d * 8)) & 0xFF];
  }
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  int64_t* tmp = new int64_t[n > 0 ? n : 1];
  int64_t* src = order;
  int64_t* dst = tmp;
  for (int d = 0; d < 4; ++d) {
    const int64_t* h = hist[d];
    int nonzero = 0;
    for (int b = 0; b < 256 && nonzero < 2; ++b) nonzero += h[b] != 0;
    if (nonzero < 2) continue;
    int64_t offs[256];
    int64_t run = 0;
    for (int b = 0; b < 256; ++b) {
      offs[b] = run;
      run += h[b];
    }
    const int shift = d * 8;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t idx = src[i];
      const uint32_t k = static_cast<uint32_t>(keys[idx]) ^ BIAS;
      dst[offs[(k >> shift) & 0xFF]++] = idx;
    }
    int64_t* t = src;
    src = dst;
    dst = t;
  }
  if (src != order) std::memcpy(order, src, static_cast<size_t>(n) * 8);
  delete[] tmp;
  delete[] hist;
}

int32_t hs_native_abi_version() { return 4; }

}  // extern "C"
