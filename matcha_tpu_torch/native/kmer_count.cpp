// Native k-mer enumeration + counting kernel.
//
// Replaces the reference's per-anchor itertools.combinations loop fanned over a
// process pool (ref: Code/generate_kmers.py:8-132) with a multithreaded C++
// enumeration over clusters and per-thread open-addressing hash maps, merged at
// the end.  Semantics: count every sorted k-subset of each cluster whose
// adjacent node-id gaps all exceed min_distance.
//
// C ABI (used from Python via ctypes, see kmer_native.py):
//   matcha_count_kmers(...)      -> number of distinct k-mers, fills a handle
//   matcha_kmer_result_fill(...) -> copy kmers/freqs into caller buffers
//   matcha_kmer_result_free(...)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int kMaxK = 5;

// k-mers are packed into one unsigned 128-bit key (25 bits per node id,
// k <= 5) so counting is a sort + run-length pass: enumeration appends to
// per-thread vectors, each thread sorts + RLE-compresses its share, and the
// sorted runs are merged.  Sorting beats hash-map inserts here: enumeration
// output is huge and mostly-distinct, so open addressing is a cache miss per
// insert, while sorted runs stream.
using Key128 = unsigned __int128;

inline Key128 pack(const int32_t* v, int k) {
  Key128 key = 0;
  for (int i = 0; i < k; ++i) {
    key = (key << 25) | static_cast<uint32_t>(v[i]);
  }
  return key;
}

inline void unpack(Key128 key, int k, int32_t* out) {
  for (int i = k - 1; i >= 0; --i) {
    out[i] = static_cast<int32_t>(static_cast<uint32_t>(key) & 0x1FFFFFFu);
    key >>= 25;
  }
}

// Enumerate gap-filtered k-subsets of one cluster into `out` (packed keys).
// Members are sorted ascending and distinct.  A subset qualifies iff every
// adjacent pair in it differs by more than min_distance; enumeration is a
// combination odometer with gap pruning.
void enumerate_cluster(const int32_t* members, int n, int k, int min_distance,
                       std::vector<Key128>& out) {
  int idx[kMaxK];
  int32_t cur[kMaxK];
  int depth = 0;
  idx[0] = 0;
  while (depth >= 0) {
    if (idx[depth] >= n - (k - 1 - depth)) {
      --depth;
      if (depth >= 0) ++idx[depth];
      continue;
    }
    int32_t cand = members[idx[depth]];
    if (depth > 0 && cand - cur[depth - 1] <= min_distance) {
      ++idx[depth];
      continue;
    }
    cur[depth] = cand;
    if (depth == k - 1) {
      out.push_back(pack(cur, k));
      ++idx[depth];
    } else {
      ++depth;
      idx[depth] = idx[depth - 1] + 1;
    }
  }
}

struct Run {
  std::vector<Key128> keys;    // sorted unique
  std::vector<int64_t> counts;
};

// sort + run-length encode a raw key vector (in place, then compress)
Run rle_sorted(std::vector<Key128>&& raw) {
  std::sort(raw.begin(), raw.end());
  Run r;
  r.keys.reserve(raw.size() / 2 + 1);
  r.counts.reserve(raw.size() / 2 + 1);
  size_t i = 0;
  while (i < raw.size()) {
    size_t j = i + 1;
    while (j < raw.size() && raw[j] == raw[i]) ++j;
    r.keys.push_back(raw[i]);
    r.counts.push_back(static_cast<int64_t>(j - i));
    i = j;
  }
  return r;
}

Run merge_runs(const Run& a, const Run& b) {
  Run out;
  out.keys.reserve(a.keys.size() + b.keys.size());
  out.counts.reserve(a.keys.size() + b.keys.size());
  size_t i = 0, j = 0;
  while (i < a.keys.size() && j < b.keys.size()) {
    if (a.keys[i] < b.keys[j]) {
      out.keys.push_back(a.keys[i]);
      out.counts.push_back(a.counts[i]);
      ++i;
    } else if (b.keys[j] < a.keys[i]) {
      out.keys.push_back(b.keys[j]);
      out.counts.push_back(b.counts[j]);
      ++j;
    } else {
      out.keys.push_back(a.keys[i]);
      out.counts.push_back(a.counts[i] + b.counts[j]);
      ++i;
      ++j;
    }
  }
  for (; i < a.keys.size(); ++i) {
    out.keys.push_back(a.keys[i]);
    out.counts.push_back(a.counts[i]);
  }
  for (; j < b.keys.size(); ++j) {
    out.keys.push_back(b.keys[j]);
    out.counts.push_back(b.counts[j]);
  }
  return out;
}

struct Result {
  std::vector<int32_t> kmers;  // n * k
  std::vector<int64_t> freqs;  // n
  int k = 0;
};

}  // namespace

extern "C" {

int64_t matcha_count_kmers(const int32_t* flat, const int64_t* offsets,
                           int64_t num_clusters, int32_t k,
                           int32_t max_cluster_size, int32_t min_distance,
                           void** out_handle) {
  if (k > kMaxK) return -1;

  unsigned n_threads = std::max(1u, std::thread::hardware_concurrency());
  std::vector<Run> runs(n_threads);

  auto worker = [&](unsigned tid) {
    std::vector<Key128> raw;
    for (int64_t c = tid; c < num_clusters; c += n_threads) {
      int n = static_cast<int>(offsets[c + 1] - offsets[c]);
      if (n < k || n > max_cluster_size) continue;
      enumerate_cluster(flat + offsets[c], n, k, min_distance, raw);
      // bound memory: compress periodically (counts merge at the end)
      if (raw.size() >= (64u << 20)) {
        Run part = rle_sorted(std::move(raw));
        raw.clear();
        runs[tid] = runs[tid].keys.empty() ? std::move(part)
                                           : merge_runs(runs[tid], part);
      }
    }
    Run part = rle_sorted(std::move(raw));
    runs[tid] = runs[tid].keys.empty() ? std::move(part)
                                       : merge_runs(runs[tid], part);
  };
  {
    std::vector<std::thread> threads;
    for (unsigned t = 1; t < n_threads; ++t) threads.emplace_back(worker, t);
    worker(0);
    for (auto& th : threads) th.join();
  }

  // parallel pairwise merge of the per-thread sorted runs
  for (unsigned stride = 1; stride < n_threads; stride *= 2) {
    std::vector<std::thread> threads;
    for (unsigned t = 0; t + stride < n_threads; t += 2 * stride) {
      threads.emplace_back([&, t] {
        runs[t] = merge_runs(runs[t], runs[t + stride]);
        runs[t + stride] = Run{};
      });
    }
    for (auto& th : threads) th.join();
  }
  Run& final_run = runs[0];

  auto* result = new Result;
  result->k = k;
  size_t n_out = final_run.keys.size();
  result->kmers.resize(n_out * k);
  result->freqs = std::move(final_run.counts);
  for (size_t i = 0; i < n_out; ++i) {
    unpack(final_run.keys[i], k, result->kmers.data() + i * k);
  }
  *out_handle = result;
  return static_cast<int64_t>(n_out);
}

void matcha_kmer_result_fill(void* handle, int32_t* kmers_out,
                             int64_t* freqs_out) {
  auto* result = static_cast<Result*>(handle);
  std::memcpy(kmers_out, result->kmers.data(),
              result->kmers.size() * sizeof(int32_t));
  std::memcpy(freqs_out, result->freqs.data(),
              result->freqs.size() * sizeof(int64_t));
}

void matcha_kmer_result_free(void* handle) {
  delete static_cast<Result*>(handle);
}

}  // extern "C"
