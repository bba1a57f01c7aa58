// Phase-1 negative proposals, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel matcha_tpu/ops/propose.py:_kernel (through
// propose_phase1), in the sampler's own row-major layout.  For every row r of
// n and each of T rounds t:
//   cand[c]  = lo[c] + min(floor((hi[c] - lo[c]) * u[t][r][c]), hi[c] - lo[c] - 1)
//   temp[c]  = change[c] ? cand[c] : orig[c]
//   sorted   = the k-wide sorting network of the JAX package (_SORT_NETS)
//   ok       = every gap sorted[c+1] - sorted[c] > min_distance
// and the first S ok candidates in round order go to probe[s][r][:], with
// has[s][r] = 1; slots no ok candidate reached are written as zeros.
//
// Bound on this card: bytes by the roofline, latency in fact.  At k = 5,
// n = 6,144, T = 8, S = 2 the inputs and outputs are ~1.6 MB (~0.5 us at
// 3.35 TB/s) and the arithmetic is a few hundred operations per row; a
// design with one thread per row looping over the rounds runs 24 blocks on
// 132 SMs, each thread a chain of dependent loads.  So the rounds run side by
// side instead: a group of G lanes of one warp (G = the next power of two >=
// T, at most 32) serves one row, lane t computing round t, so no loop
// carries a dependence and n = 6,144 at T = 8 is 192 blocks.  One
// __ballot_sync gives the group's ok mask in round order; lane t writes its
// candidate to slot popc(mask & lanes below t) when that is < S, and lanes
// s < S with s >= popc(mask) write the zero rows.  Every output is written
// exactly once.  Rows past n and lanes past T take part in the ballot with
// ok = false.  A lane's proposal is proposal.cuh's (shared with K7): a pure
// function of u, the multiply __fmul_rn (no FMA may fuse it into the add
// across the floor), so the kernel agrees bit for bit with the plain PyTorch
// version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "proposal.cuh"

namespace {

constexpr int NT = 256;  // threads per block

template <int K, int G>
__global__ void __launch_bounds__(NT)
    propose_kernel(const int* __restrict__ orig, const unsigned char* __restrict__ change,
                   const float* __restrict__ lo, const float* __restrict__ hi,
                   const float* __restrict__ u, int* __restrict__ probe,
                   unsigned char* __restrict__ has, int n, int T, int S, int min_distance) {
  const int t = threadIdx.x % G;                         // this lane's round
  const int r = blockIdx.x * (NT / G) + threadIdx.x / G;  // this group's row
  int v[K];
  bool ok = false;
  if (r < n && t < T) {
    const size_t row = (size_t)r * K;
    int o[K];
    float l[K], h[K];
    unsigned cm = 0;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      o[c] = orig[row + c];
      l[c] = h[c] = 0.0f;
      if (change[row + c]) {
        cm |= 1u << c;
        l[c] = lo[row + c];
        h[c] = hi[row + c];
      }
    }
    ok = proposal::candidate<K>(o, cm, l, h, u + ((size_t)t * n + r) * K, min_distance, v);
  }
  // every lane of the warp reaches the ballot: no return above
  const unsigned ballot = __ballot_sync(0xffffffffu, ok);
  if (r >= n) return;
  const int first = (threadIdx.x & 31) & ~(G - 1);  // the group's first lane
  const unsigned mask = G == 32 ? ballot : (ballot >> first) & ((1u << (G & 31)) - 1u);
  const int slot = __popc(mask & ((1u << t) - 1u));
  if (ok && slot < S) {
#pragma unroll
    for (int c = 0; c < K; ++c) probe[((size_t)slot * n + r) * K + c] = v[c];
    has[(size_t)slot * n + r] = 1;
  }
  if (t < S && t >= __popc(mask)) {
#pragma unroll
    for (int c = 0; c < K; ++c) probe[((size_t)t * n + r) * K + c] = 0;
    has[(size_t)t * n + r] = 0;
  }
}

template <int K>
int launch(const int* orig, const unsigned char* change, const float* lo, const float* hi,
           const float* u, int* probe, unsigned char* has, int n, int T, int S,
           int min_distance, cudaStream_t s) {
#define MATCHA_PROPOSE(G)                                                              \
  propose_kernel<K, G><<<(int)(((long long)n * G + NT - 1) / NT), NT, 0, s>>>(          \
      orig, change, lo, hi, u, probe, has, n, T, S, min_distance)
  if (T <= 1) MATCHA_PROPOSE(1);
  else if (T <= 2) MATCHA_PROPOSE(2);
  else if (T <= 4) MATCHA_PROPOSE(4);
  else if (T <= 8) MATCHA_PROPOSE(8);
  else if (T <= 16) MATCHA_PROPOSE(16);
  else MATCHA_PROPOSE(32);
#undef MATCHA_PROPOSE
  return (int)cudaGetLastError();
}

}  // namespace

// orig (n, k) int32, change (n, k) bytes (0/1), lo/hi (n, k) f32, u (T, n, k)
// f32 -> probe (S, n, k) int32 and has (S, n) bytes (0/1), every element
// written.  1 <= k <= 6, 1 <= T <= 32, 1 <= S <= T.  Returns the CUDA error
// (0 = ok).
extern "C" int matcha_propose_phase1(const void* orig, const void* change, const void* lo,
                                     const void* hi, const void* u, void* probe, void* has,
                                     int k, int n, int T, int S, int min_distance,
                                     void* stream) {
  if (k < 1 || k > 6 || n < 0 || T < 1 || T > 32 || S < 1 || S > T)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(orig);
  const unsigned char* c = static_cast<const unsigned char*>(change);
  const float* l = static_cast<const float*>(lo);
  const float* h = static_cast<const float*>(hi);
  const float* uu = static_cast<const float*>(u);
  int* p = static_cast<int*>(probe);
  unsigned char* hs = static_cast<unsigned char*>(has);
  switch (k) {
    case 1: return launch<1>(o, c, l, h, uu, p, hs, n, T, S, min_distance, s);
    case 2: return launch<2>(o, c, l, h, uu, p, hs, n, T, S, min_distance, s);
    case 3: return launch<3>(o, c, l, h, uu, p, hs, n, T, S, min_distance, s);
    case 4: return launch<4>(o, c, l, h, uu, p, hs, n, T, S, min_distance, s);
    case 5: return launch<5>(o, c, l, h, uu, p, hs, n, T, S, min_distance, s);
    default: return launch<6>(o, c, l, h, uu, p, hs, n, T, S, min_distance, s);
  }
}

extern "C" const char* matcha_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
