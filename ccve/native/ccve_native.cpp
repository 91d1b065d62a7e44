// ccve_native — host-side native runtime for the engine.
//
// The reference is pure C++ (SURVEY.md §2); in this re-design the compute
// path is JAX/XLA, and this library supplies the host runtime pieces
// that are inherently sequential or latency-bound and belong on the CPU:
//
//  * deterministic workload generation, bit-exact with the reference by
//    construction (it calls the very same std::mt19937 /
//    std::uniform_int_distribution / glibc rand() the reference uses:
//    main.cpp:41-55, simd_micro_bench.cpp:78-79),
//  * sequential hash-table builds (linear-probing insertion,
//    linear_probing_ht.cpp:27-36; chaining buckets in CSR layout,
//    chaining_ht.cpp:29-35),
//  * the murmurhash64 finalizer (hash_functions.h:8-16).
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

namespace {

inline uint64_t murmurhash64(uint64_t x) {
  x ^= x >> 32;
  x *= 0xd6e8feb86659fd93ULL;
  x ^= x >> 32;
  x *= 0xd6e8feb86659fd93ULL;
  x ^= x >> 32;
  return x;
}

}  // namespace

extern "C" {

// --- hashing ---------------------------------------------------------------

void ccve_murmurhash64(const int64_t* in, int64_t n, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = murmurhash64(uint64_t(in[i]));
}

// --- workload generation ----------------------------------------------------

// Probe table: n_rows x n_cols draws (row-major) from mt19937(2) through
// uniform_int_distribution<int>(0, rhs_size).
void ccve_gen_probe_table(int64_t n_rows, int64_t n_cols, int64_t rhs_size,
                          int64_t* out) {
  std::mt19937 gen(2);
  std::uniform_int_distribution<> dist(0, int(rhs_size));
  for (int64_t i = 0; i < n_rows * n_cols; ++i) out[i] = int64_t(dist(gen));
}

// Build-side table: keys/payloads in insertion order.
void ccve_gen_rhs_table(int64_t n_rhs, int64_t chunk_factor, int64_t* keys,
                        int64_t* payloads) {
  int64_t cnt = 0;
  const int64_t num_unique =
      n_rhs / chunk_factor + (n_rhs % chunk_factor != 0 ? 1 : 0);
  const int64_t stride = n_rhs / num_unique;
  for (int64_t i = 0; i < num_unique; ++i) {
    const int64_t unique_value = i * stride;
    for (int64_t j = 0; j < chunk_factor && cnt < n_rhs; ++j) {
      keys[cnt] = unique_value;
      payloads[cnt] = cnt + 10000000;
      ++cnt;
    }
  }
}

// Micro-bench key stream: glibc rand() & (rhs_tuples*hit_freq - 1).
void ccve_gen_microbench_keys(int64_t n_keys, int64_t rhs_tuples,
                              int64_t hit_freq, int64_t* out) {
  srand(1);  // glibc default seed, made explicit
  const int64_t mask = rhs_tuples * hit_freq - 1;
  for (int64_t i = 0; i < n_keys; ++i) out[i] = int64_t(rand()) & mask;
}

// --- hash-table builds -------------------------------------------------------

// Linear-probing build: sequential first-empty-slot insertion. slots/payload
// arrays must be length n_slots (a power of two), pre-filled by the callee.
// Returns the maximum probe-chain run length (longest stretch of occupied
// slots, i.e. an upper bound on probe iterations until an empty slot).
int64_t ccve_build_lp(const int64_t* keys, const int64_t* payloads,
                      int64_t n_rhs, int64_t n_slots, int64_t* slot_keys,
                      int64_t* slot_payloads) {
  const uint64_t mask = uint64_t(n_slots) - 1;
  for (int64_t i = 0; i < n_slots; ++i) {
    slot_keys[i] = -1;
    slot_payloads[i] = -1;
  }
  for (int64_t i = 0; i < n_rhs; ++i) {
    uint64_t slot = murmurhash64(uint64_t(keys[i])) & mask;
    while (slot_keys[slot] != -1) slot = (slot + 1) & mask;
    slot_keys[slot] = keys[i];
    slot_payloads[slot] = payloads[i];
  }
  // longest occupied run (circular)
  int64_t max_run = 0, run = 0, lead = 0;
  bool counting_lead = true;
  for (int64_t i = 0; i < n_slots; ++i) {
    if (slot_keys[i] != -1) {
      ++run;
      if (counting_lead) ++lead;
    } else {
      counting_lead = false;
      if (run > max_run) max_run = run;
      run = 0;
    }
  }
  // wrap-around run: trailing run joins the leading run
  if (run + lead > max_run) max_run = run + lead;
  if (max_run > n_slots) max_run = n_slots;
  return max_run;
}

// Chaining build in CSR layout: bucket b holds entries
// [offsets[b], offsets[b+1]) of entry_keys/entry_payloads, in insertion
// order. offsets must be length n_buckets+1; entries length n_rhs.
// Returns the maximum bucket length.
int64_t ccve_build_chaining_csr(const int64_t* keys, const int64_t* payloads,
                                int64_t n_rhs, int64_t n_buckets,
                                int64_t* offsets, int64_t* entry_keys,
                                int64_t* entry_payloads) {
  const uint64_t mask = uint64_t(n_buckets) - 1;
  std::vector<int64_t> counts(static_cast<size_t>(n_buckets), 0);
  std::vector<int64_t> bucket_of(static_cast<size_t>(n_rhs), 0);
  for (int64_t i = 0; i < n_rhs; ++i) {
    const int64_t b = int64_t(murmurhash64(uint64_t(keys[i])) & mask);
    bucket_of[size_t(i)] = b;
    ++counts[size_t(b)];
  }
  int64_t max_len = 0;
  offsets[0] = 0;
  for (int64_t b = 0; b < n_buckets; ++b) {
    if (counts[size_t(b)] > max_len) max_len = counts[size_t(b)];
    offsets[b + 1] = offsets[b] + counts[size_t(b)];
  }
  std::vector<int64_t> cursor(offsets, offsets + n_buckets);
  for (int64_t i = 0; i < n_rhs; ++i) {
    const int64_t pos = cursor[size_t(bucket_of[size_t(i)])]++;
    entry_keys[pos] = keys[i];
    entry_payloads[pos] = payloads[i];
  }
  return max_len;
}

// Chunk-batch feeder (the host IO hot loop of the pipelined executor,
// replacing DataCollection::FetchChunk + per-chunk transposition,
// data_collection.cpp:23-27): packs probe rows [seg_start*block,
// (seg_start+seg_chunks)*block) of a row-major int64[n, n_cols] table
// into a [seg_chunks, n_cols, block] column-major batch, zero-padding
// rows past n. Cache-blocked transpose.
void ccve_make_chunk_batch(const int64_t* rows, int64_t n, int64_t n_cols,
                           int64_t block, int64_t seg_start,
                           int64_t seg_chunks, int64_t* out) {
  for (int64_t c = 0; c < seg_chunks; ++c) {
    const int64_t row0 = (seg_start + c) * block;
    int64_t* chunk = out + c * n_cols * block;
    const int64_t live = std::max<int64_t>(
        0, std::min<int64_t>(block, n - row0));
    for (int64_t col = 0; col < n_cols; ++col) {
      int64_t* dst = chunk + col * block;
      const int64_t* src = rows + row0 * n_cols + col;
      int64_t r = 0;
      for (; r < live; ++r) dst[r] = src[r * n_cols];
      for (; r < block; ++r) dst[r] = 0;
    }
  }
}

}  // extern "C"
