// Phase-1 negative proposals (feature-major), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel matcha_tpu/ops/propose.py:_kernel (through
// propose_phase1).  For every row r of n and each of T rounds t:
//   cand[c]  = lo[c] + min(floor((hi[c] - lo[c]) * u[t][c]), hi[c] - lo[c] - 1)
//   temp[c]  = change[c] ? cand[c] : orig[c]
//   sorted   = the k-wide sorting network of the JAX package (_SORT_NETS)
//   ok       = every gap sorted[c+1] - sorted[c] > min_distance
// and the first S ok candidates in round order go to probe[s][:, r], with
// has[s][r] = 1; slots no ok candidate reached are written as zeros.
//
// One thread per row: the k <= 6 members live in registers, the network is
// unrolled per k (a template), and each output is written exactly once.  The
// row axis is the fastest one in every array, so neighbouring threads touch
// neighbouring addresses.  The ragged edge (n not a multiple of the block) is
// masked, so any n is taken.  The result is a pure function of u: the
// multiply is __fmul_rn (no FMA may fuse it into the add across the floor),
// so the kernel agrees bit for bit with the plain PyTorch version.
// Bound on this card: bytes.  At k = 5, n = 6,144, T = 8, S = 2 it reads
// orig/change/lo/hi (4 * k * n * 4 B) and u (T * k * n * 4 B) and writes
// probe (S * k * n * 4 B) and has (S * n B): about 1.8 MB -> 0.53 us at
// 3.35 TB/s; at this size the launch itself dominates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block

__device__ __forceinline__ void cx(int& a, int& b) {
  const int lo = min(a, b), hi = max(a, b);
  a = lo;
  b = hi;
}

// the compare-exchange pairs of matcha_tpu_torch/sampler/negative.py:_SORT_NETS
template <int K>
__device__ __forceinline__ void sort_net(int* c) {
  if constexpr (K == 2) {
    cx(c[0], c[1]);
  } else if constexpr (K == 3) {
    cx(c[0], c[2]); cx(c[0], c[1]); cx(c[1], c[2]);
  } else if constexpr (K == 4) {
    cx(c[0], c[2]); cx(c[1], c[3]); cx(c[0], c[1]); cx(c[2], c[3]);
    cx(c[1], c[2]);
  } else if constexpr (K == 5) {
    cx(c[0], c[3]); cx(c[1], c[4]); cx(c[0], c[2]); cx(c[1], c[3]);
    cx(c[0], c[1]); cx(c[2], c[4]); cx(c[1], c[2]); cx(c[3], c[4]);
    cx(c[2], c[3]);
  } else if constexpr (K == 6) {
    cx(c[0], c[5]); cx(c[1], c[3]); cx(c[2], c[4]); cx(c[1], c[2]);
    cx(c[3], c[4]); cx(c[0], c[3]); cx(c[2], c[5]); cx(c[0], c[1]);
    cx(c[2], c[3]); cx(c[4], c[5]); cx(c[1], c[2]); cx(c[3], c[4]);
  }
}

template <int K>
__global__ void __launch_bounds__(NT)
    propose_kernel(const int* __restrict__ orig, const int* __restrict__ change,
                   const float* __restrict__ lo, const float* __restrict__ hi,
                   const float* __restrict__ u, int* __restrict__ probe,
                   unsigned char* __restrict__ has, int n, int T, int S, int min_distance) {
  const int r = blockIdx.x * NT + threadIdx.x;
  if (r >= n) return;
  int o[K];
  bool ch[K];
  float l[K], w[K], wm1[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const size_t i = (size_t)c * n + r;
    o[c] = orig[i];
    ch[c] = change[i] != 0;
    l[c] = lo[i];
    w[c] = __fsub_rn(hi[i], lo[i]);
    wm1[c] = __fsub_rn(w[c], 1.0f);
  }
  int rank = 0;
  for (int t = 0; t < T && rank < S; ++t) {
    int v[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      if (ch[c]) {
        const float uu = u[((size_t)t * K + c) * n + r];
        const float f = fminf(floorf(__fmul_rn(w[c], uu)), wm1[c]);
        v[c] = (int)__fadd_rn(l[c], f);
      } else {
        v[c] = o[c];
      }
    }
    sort_net<K>(v);
    bool ok = true;
#pragma unroll
    for (int c = 0; c + 1 < K; ++c) ok = ok && (v[c + 1] - v[c] > min_distance);
    if (ok) {
#pragma unroll
      for (int c = 0; c < K; ++c) probe[((size_t)rank * K + c) * n + r] = v[c];
      has[(size_t)rank * n + r] = 1;
      ++rank;
    }
  }
  for (int s = rank; s < S; ++s) {
#pragma unroll
    for (int c = 0; c < K; ++c) probe[((size_t)s * K + c) * n + r] = 0;
    has[(size_t)s * n + r] = 0;
  }
}

template <int K>
void launch(const int* orig, const int* change, const float* lo, const float* hi,
            const float* u, int* probe, unsigned char* has, int n, int T, int S,
            int min_distance, cudaStream_t s) {
  propose_kernel<K><<<(n + NT - 1) / NT, NT, 0, s>>>(orig, change, lo, hi, u, probe, has, n,
                                                      T, S, min_distance);
}

}  // namespace

// orig/change (k, n) int32, lo/hi (k, n) f32, u (T, k, n) f32 -> probe
// (S, k, n) int32 and has (S, n) bytes (0/1), every element written.
// 1 <= k <= 6, T >= 1, 1 <= S <= T.  Returns the CUDA error (0 = ok).
extern "C" int matcha_propose_phase1(const void* orig, const void* change, const void* lo,
                                     const void* hi, const void* u, void* probe, void* has,
                                     int k, int n, int T, int S, int min_distance,
                                     void* stream) {
  if (k < 1 || k > 6 || n < 0 || T < 1 || S < 1 || S > T) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(orig);
  const int* c = static_cast<const int*>(change);
  const float* l = static_cast<const float*>(lo);
  const float* h = static_cast<const float*>(hi);
  const float* uu = static_cast<const float*>(u);
  int* p = static_cast<int*>(probe);
  unsigned char* hs = static_cast<unsigned char*>(has);
  switch (k) {
    case 1: launch<1>(o, c, l, h, uu, p, hs, n, T, S, min_distance, s); break;
    case 2: launch<2>(o, c, l, h, uu, p, hs, n, T, S, min_distance, s); break;
    case 3: launch<3>(o, c, l, h, uu, p, hs, n, T, S, min_distance, s); break;
    case 4: launch<4>(o, c, l, h, uu, p, hs, n, T, S, min_distance, s); break;
    case 5: launch<5>(o, c, l, h, uu, p, hs, n, T, S, min_distance, s); break;
    default: launch<6>(o, c, l, h, uu, p, hs, n, T, S, min_distance, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* matcha_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
