// Negative sampling of one hyperedge size, after the uniform draws, for
// NVIDIA Hopper (sm_90a): K7.
//
// Replaces no TPU kernel.  The JAX package's sampler
// (matcha_tpu/sampler/negative.py:sample_negatives_with_stats) is plain jnp
// code that XLA fuses under jit; the port ran the same chain eagerly, about
// 210 PyTorch operations per size (the change mask, the chromosome ranges,
// the sorting network, the probe extraction, the int64 hash, the Bloom
// gathers, the first-accepted loop), each a launch the host dispatches.
// This file computes that chain, for given uniforms, in one launch per size
// and one per phase-2 round, with the same bits as
// matcha_tpu_torch/sampler/negative.py:_sample_eager.
//
// One thread per negative row r of n = B * neg_num (orig row = positives[r
// % B]); k <= 6 members live in registers.  Three entries:
//   phase 1  (matcha_sample_phase1): the change mask from two uniforms (the
//            truncated-binomial count by the CDF, the positions by the rank
//            of k uniforms with the index tie-break); the chromosome [lo, hi)
//            of each member (by the range starts, or a node2chrom gather);
//            the whole-range switch of rows whose hard uniform exceeds
//            hard_ratio; then up to T <= 16 proposal rounds, each sorted by
//            the k-wide network and gap-checked, the first S valid ones
//            probed against the Bloom filter in round order.  A row keeps the
//            first accepted candidate, else its first valid one, else its
//            positive.  It writes change / lo / hi for the rounds.
//   select   (matcha_sample_select): the same choice from K5's (probe, has),
//            for propose_impl="pallas".
//   round    (matcha_sample_round): one phase-2 round for the rows not yet
//            accepted, from that round's (n, k) uniforms.
// Each writes the negatives, a flag byte per row (FOUND: a Bloom-accepted
// candidate; CUR_OK: a structurally valid one), and counts[0..3] = rows not
// accepted, rows ending on a Bloom hit, rows ending on their positive, n:
// integer block sums (__syncthreads_count) added with integer atomics into
// counts, zeroed by the entry first.  The host reads counts[0] for the
// phase-2 loop's test.
//
// Exactness: the draw is lo + min(floor((hi - lo) * u), hi - lo - 1) with
// each operation rounded on its own (__fmul_rn: no FMA across the floor), as
// the eager chain computes it (proposal.cuh, shared with K5); the hash is
// the FNV / murmur double hash in uint32, whose bits the eager chain gets
// from int64 products masked to 32 bits.  A row stops proposing once it
// has accepted a candidate or probed S valid ones: no later round can
// change what it keeps.
//
// Bound on this card: latency, not bytes.  At b2048 (k = 5, n = 6,144, T = 8,
// S = 2) the uniforms in and the negatives out are ~1.3 MB (~0.4 us at 3.35
// TB/s); each thread's chain of dependent loads (uniforms, the chromosome
// starts, a Bloom word per probe) is what takes the time.  So blocks are
// small (64 threads: 96 blocks at b2048, one per SM) and nothing else is
// done: the gain is the ~210 host launches a size no longer dispatched.

#include <cuda_runtime.h>
#include <stdint.h>

#include "proposal.cuh"

namespace {

constexpr int NT = 64;  // threads per block, one row each
constexpr unsigned char FOUND = 1, CUR_OK = 2;

struct Bloom {
  const uint32_t* bits;
  uint32_t n_words, m_bits;
  int n_hashes, blocked;
};

struct Cdf {
  float v[6];
};

struct Chrom {
  const int* starts;      // (n_chrom,) first node id of each chromosome
  const int* ends;        // (n_chrom,) one past its last
  const int* node2chrom;  // (N + 1,) or null: count the starts instead
  int n_chrom;
  int has_hard;           // rows with u_hard > hard_ratio take the whole range
  float hard_ratio, n_nodes;
};

__device__ __forceinline__ uint32_t mix(uint32_t h) {  // murmur3's finaliser
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// sampler/bloom.py:DeviceBloomFilter.contains for one sorted row
template <int K>
__device__ __forceinline__ bool bloom_has(const Bloom& b, const int* v) {
  uint32_t h1 = 2166136261u, h2 = 0x9747B28Cu;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const uint32_t x = (uint32_t)v[c];
    h1 = mix(h1 ^ x) * 16777619u;
    h2 = mix(h2 ^ (x * 2654435761u)) * 2246822519u;
  }
  h2 |= 1u;
  if (b.blocked) {
    const uint32_t mask = (1u << (h2 & 31u)) | (1u << ((h2 >> 5) & 31u));
    return (__ldg(b.bits + h1 % b.n_words) & mask) == mask;
  }
  for (int i = 0; i < b.n_hashes; ++i) {
    const uint32_t idx = (h1 + (uint32_t)i * h2) % b.m_bits;
    if (!(__ldg(b.bits + (idx >> 5)) >> (idx & 31u) & 1u)) return false;
  }
  return true;
}

template <int K>
__device__ __forceinline__ void load_row(const int* __restrict__ pos, int b, int r, int* o) {
  const int* p = pos + (size_t)(r % b) * K;
#pragma unroll
  for (int c = 0; c < K; ++c) o[c] = p[c];
}

template <int K>
__device__ __forceinline__ void store_row(int* __restrict__ out, int r, const int* v) {
#pragma unroll
  for (int c = 0; c < K; ++c) out[(size_t)r * K + c] = v[c];
}

// every thread of the block, live or not: the three counts of the rows' flags
__device__ __forceinline__ void count_rows(bool live, unsigned char f, int n, int* counts) {
  const int left = __syncthreads_count(live && !(f & FOUND));
  const int bloom_fb = __syncthreads_count(live && !(f & FOUND) && (f & CUR_OK));
  const int orig_fb = __syncthreads_count(live && !(f & (FOUND | CUR_OK)));
  if (threadIdx.x == 0) {
    if (left) atomicAdd(counts, left);
    if (bloom_fb) atomicAdd(counts + 1, bloom_fb);
    if (orig_fb) atomicAdd(counts + 2, orig_fb);
    if (blockIdx.x == 0) counts[3] = n;
  }
}

template <int K>
__global__ void __launch_bounds__(NT)
    phase1_kernel(const int* __restrict__ pos, int b, int n, const float* __restrict__ u_count,
                  const float* __restrict__ u_rank, const float* __restrict__ u_hard,
                  const float* __restrict__ u, int T, int S, int md, Cdf cdf, Chrom ch,
                  Bloom bl, int* __restrict__ neg, unsigned char* __restrict__ change,
                  float* __restrict__ lo_out, float* __restrict__ hi_out,
                  unsigned char* __restrict__ flags, int* __restrict__ counts) {
  const int r = blockIdx.x * NT + threadIdx.x;
  const bool live = r < n;
  unsigned char f = 0;
  if (live) {
    int o[K];
    load_row<K>(pos, b, r, o);
    // the change mask: count ~ truncated Binomial(K, 1/2), positions by rank
    const float uc = u_count[r];
    int num = 1;
#pragma unroll
    for (int c = 0; c < K; ++c) num += uc > cdf.v[c];
    float s[K];
#pragma unroll
    for (int c = 0; c < K; ++c) s[c] = u_rank[(size_t)r * K + c];
    unsigned cm = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      int less = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) less += (s[j] < s[i]) || (s[j] == s[i] && j < i);
      if (less < num) cm |= 1u << i;
    }
    // each member's chromosome range, or the whole range for a simple row
    float lo[K], hi[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      int ci = 0;
      if (ch.node2chrom != nullptr) {
        ci = __ldg(ch.node2chrom + o[c]);
      } else {
        for (int j = 1; j < ch.n_chrom; ++j) ci += o[c] >= __ldg(ch.starts + j);
      }
      lo[c] = (float)__ldg(ch.starts + ci);
      hi[c] = (float)__ldg(ch.ends + ci);
    }
    if (ch.has_hard && !(u_hard[r] <= ch.hard_ratio)) {
      cm = (1u << K) - 1u;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        lo[c] = 1.0f;
        hi[c] = ch.n_nodes;
      }
    }
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const size_t e = (size_t)r * K + c;
      change[e] = cm >> c & 1u;
      lo_out[e] = lo[c];
      hi_out[e] = hi[c];
    }
    // the proposal rounds: the first S valid candidates, probed in order
    int chosen[K];
#pragma unroll
    for (int c = 0; c < K; ++c) chosen[c] = o[c];
    int valid = 0;
    bool found = false;
    for (int t = 0; t < T && valid < S && !found; ++t) {
      int v[K];
      if (!proposal::candidate<K>(o, cm, lo, hi, u + ((size_t)t * n + r) * K, md, v)) continue;
      found = !bloom_has<K>(bl, v);
      if (found || valid == 0) {
#pragma unroll
        for (int c = 0; c < K; ++c) chosen[c] = v[c];
      }
      ++valid;
    }
    f = (valid > 0 ? CUR_OK : 0) | (found ? FOUND : 0);
    store_row<K>(neg, r, chosen);
    flags[r] = f;
  }
  count_rows(live, f, n, counts);
}

template <int K>
__global__ void __launch_bounds__(NT)
    select_kernel(const int* __restrict__ pos, int b, int n, const int* __restrict__ probe,
                  const unsigned char* __restrict__ has, int S, Bloom bl, int* __restrict__ neg,
                  unsigned char* __restrict__ flags, int* __restrict__ counts) {
  const int r = blockIdx.x * NT + threadIdx.x;
  const bool live = r < n;
  unsigned char f = 0;
  if (live) {
    int chosen[K];
    const bool cur_ok = has[r] != 0;
    if (cur_ok) {
#pragma unroll
      for (int c = 0; c < K; ++c) chosen[c] = probe[(size_t)r * K + c];
    } else {
      load_row<K>(pos, b, r, chosen);
    }
    bool found = false;
    for (int s = 0; s < S && !found; ++s) {
      if (!has[(size_t)s * n + r]) continue;
      int v[K];
#pragma unroll
      for (int c = 0; c < K; ++c) v[c] = probe[((size_t)s * n + r) * K + c];
      found = !bloom_has<K>(bl, v);
      if (found) {
#pragma unroll
        for (int c = 0; c < K; ++c) chosen[c] = v[c];
      }
    }
    f = (cur_ok ? CUR_OK : 0) | (found ? FOUND : 0);
    store_row<K>(neg, r, chosen);
    flags[r] = f;
  }
  count_rows(live, f, n, counts);
}

template <int K>
__global__ void __launch_bounds__(NT)
    round_kernel(const int* __restrict__ pos, int b, int n,
                 const unsigned char* __restrict__ change, const float* __restrict__ lo_in,
                 const float* __restrict__ hi_in, const float* __restrict__ u, int md, Bloom bl,
                 int* __restrict__ neg, unsigned char* __restrict__ flags,
                 int* __restrict__ counts) {
  const int r = blockIdx.x * NT + threadIdx.x;
  const bool live = r < n;
  unsigned char f = 0;
  if (live) {
    f = flags[r];
    if (!(f & FOUND)) {
      int o[K];
      float lo[K], hi[K];
      unsigned cm = 0;
      load_row<K>(pos, b, r, o);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const size_t e = (size_t)r * K + c;
        cm |= (change[e] ? 1u : 0u) << c;
        lo[c] = lo_in[e];
        hi[c] = hi_in[e];
      }
      int v[K];
      if (proposal::candidate<K>(o, cm, lo, hi, u + (size_t)r * K, md, v)) {
        // take an accepted candidate; a row with no valid one yet keeps
        // this one (a Bloom hit) so that its fallback is valid
        const bool acc = !bloom_has<K>(bl, v);
        if (acc || !(f & CUR_OK)) store_row<K>(neg, r, v);
        f |= CUR_OK | (acc ? FOUND : 0);
        flags[r] = f;
      }
    }
  }
  count_rows(live, f, n, counts);
}

int blocks(int n) { return (n + NT - 1) / NT; }

Bloom bloom_of(const void* bits, unsigned n_words, unsigned m_bits, int n_hashes, int blocked) {
  return Bloom{static_cast<const uint32_t*>(bits), n_words, m_bits, n_hashes, blocked};
}

bool bad_bloom(unsigned n_words, unsigned m_bits, int n_hashes, int blocked) {
  return n_words == 0 || (!blocked && (m_bits == 0 || n_hashes < 1));
}

#define MATCHA_K_SWITCH(k, CALL) \
  switch (k) {                   \
    case 1: CALL(1); break;      \
    case 2: CALL(2); break;      \
    case 3: CALL(3); break;      \
    case 4: CALL(4); break;      \
    case 5: CALL(5); break;      \
    default: CALL(6); break;     \
  }

}  // namespace

// phase 1 of one size.  pos (b, k) int32; u_count (n,), u_rank (n, k),
// u_hard (n,) or null, u (T, n, k) f32 with n = b * neg_num; cdf[0..k) the
// truncated-binomial CDF; starts / ends (n_chrom,) int32 and node2chrom (N +
// 1,) int32 or null; the Bloom bitset (n_words uint32 words; m_bits and
// n_hashes for the classic layout) -> neg (n, k) int32, change (n, k) bytes,
// lo / hi (n, k) f32, flags (n,) bytes, counts (4,) int32.  1 <= k <= 6, 1
// <= S <= T <= 16.  Returns the CUDA error (0 = ok).
extern "C" int matcha_sample_phase1(const void* pos, int b, int neg_num, int k,
                                    const void* u_count, const void* u_rank,
                                    const void* u_hard, const void* u, int T, int S,
                                    int min_distance, const float* cdf, const void* starts,
                                    const void* ends, const void* node2chrom, int n_chrom,
                                    float hard_ratio, float n_nodes, const void* bits,
                                    unsigned n_words, unsigned m_bits, int n_hashes,
                                    int blocked, void* neg, void* change, void* lo, void* hi,
                                    void* flags, void* counts, void* stream) {
  if (k < 1 || k > 6 || b < 0 || neg_num < 0 || T < 1 || T > 16 || S < 1 || S > T ||
      n_chrom < 1 || bad_bloom(n_words, m_bits, n_hashes, blocked))
    return (int)cudaErrorInvalidValue;
  const long long nn = (long long)b * neg_num;
  if (nn > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int n = (int)nn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, 4 * sizeof(int), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  Cdf c{};
  for (int i = 0; i < k; ++i) c.v[i] = cdf[i];
  const Chrom ch{static_cast<const int*>(starts), static_cast<const int*>(ends),
                 static_cast<const int*>(node2chrom), n_chrom, u_hard != nullptr, hard_ratio,
                 n_nodes};
  const Bloom bl = bloom_of(bits, n_words, m_bits, n_hashes, blocked);
#define MATCHA_PHASE1(K)                                                                   \
  phase1_kernel<K><<<blocks(n), NT, 0, s>>>(                                               \
      static_cast<const int*>(pos), b, n, static_cast<const float*>(u_count),              \
      static_cast<const float*>(u_rank), static_cast<const float*>(u_hard),                \
      static_cast<const float*>(u), T, S, min_distance, c, ch, bl, static_cast<int*>(neg), \
      static_cast<unsigned char*>(change), static_cast<float*>(lo),                        \
      static_cast<float*>(hi), static_cast<unsigned char*>(flags),                         \
      static_cast<int*>(counts))
  MATCHA_K_SWITCH(k, MATCHA_PHASE1)
#undef MATCHA_PHASE1
  return (int)cudaGetLastError();
}

// the choice of phase 1 from K5's output: probe (S, n, k) int32, has (S, n)
// bytes -> neg, flags, counts as matcha_sample_phase1 writes them.
extern "C" int matcha_sample_select(const void* pos, int b, int neg_num, int k,
                                    const void* probe, const void* has, int S,
                                    const void* bits, unsigned n_words, unsigned m_bits,
                                    int n_hashes, int blocked, void* neg, void* flags,
                                    void* counts, void* stream) {
  if (k < 1 || k > 6 || b < 0 || neg_num < 0 || S < 1 ||
      bad_bloom(n_words, m_bits, n_hashes, blocked))
    return (int)cudaErrorInvalidValue;
  const long long nn = (long long)b * neg_num;
  if (nn > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int n = (int)nn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, 4 * sizeof(int), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  const Bloom bl = bloom_of(bits, n_words, m_bits, n_hashes, blocked);
#define MATCHA_SELECT(K)                                                                    \
  select_kernel<K><<<blocks(n), NT, 0, s>>>(                                                \
      static_cast<const int*>(pos), b, n, static_cast<const int*>(probe),                   \
      static_cast<const unsigned char*>(has), S, bl, static_cast<int*>(neg),                \
      static_cast<unsigned char*>(flags), static_cast<int*>(counts))
  MATCHA_K_SWITCH(k, MATCHA_SELECT)
#undef MATCHA_SELECT
  return (int)cudaGetLastError();
}

// one phase-2 round: change (n, k) bytes, lo / hi (n, k) f32 from phase 1,
// u (n, k) f32 this round's uniforms; neg and flags updated in place for the
// rows not yet accepted; counts written anew.
extern "C" int matcha_sample_round(const void* pos, int b, int neg_num, int k,
                                   const void* change, const void* lo, const void* hi,
                                   const void* u, int min_distance, const void* bits,
                                   unsigned n_words, unsigned m_bits, int n_hashes, int blocked,
                                   void* neg, void* flags, void* counts, void* stream) {
  if (k < 1 || k > 6 || b < 0 || neg_num < 0 || bad_bloom(n_words, m_bits, n_hashes, blocked))
    return (int)cudaErrorInvalidValue;
  const long long nn = (long long)b * neg_num;
  if (nn > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int n = (int)nn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, 4 * sizeof(int), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  const Bloom bl = bloom_of(bits, n_words, m_bits, n_hashes, blocked);
#define MATCHA_ROUND(K)                                                                  \
  round_kernel<K><<<blocks(n), NT, 0, s>>>(                                              \
      static_cast<const int*>(pos), b, n, static_cast<const unsigned char*>(change),     \
      static_cast<const float*>(lo), static_cast<const float*>(hi),                      \
      static_cast<const float*>(u), min_distance, bl, static_cast<int*>(neg),            \
      static_cast<unsigned char*>(flags), static_cast<int*>(counts))
  MATCHA_K_SWITCH(k, MATCHA_ROUND)
#undef MATCHA_ROUND
  return (int)cudaGetLastError();
}

extern "C" const char* matcha_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
