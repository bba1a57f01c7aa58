// One negative proposal of a row, for the sampler's kernels: K5
// (propose.cu) and K7 (sample_negatives.cu).
//
// A proposal takes the positive's members o[0..K), a change mask cm (bit c
// set: member c is redrawn), each member's range [lo, hi) and one uniform
// per member:
//   cand[c] = lo[c] + min(floor((hi[c] - lo[c]) * u[c]), hi[c] - lo[c] - 1)
//   v[c]    = cm bit c ? cand[c] : o[c]
// then sorts v with the k-wide sorting network of the JAX package
// (matcha_tpu_torch/sampler/negative.py:_SORT_NETS) and is valid when every
// gap v[c + 1] - v[c] exceeds min_distance.  Each float operation is
// rounded on its own (__fmul_rn: no FMA may fuse the multiply into the add
// across the floor), so the bits are those of the plain PyTorch chain.

#pragma once

#include <cuda_runtime.h>

namespace proposal {

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

// one member drawn in [l, h) from the uniform u
__device__ __forceinline__ int draw(float l, float h, float u) {
  const float w = __fsub_rn(h, l);
  const float f = fminf(floorf(__fmul_rn(w, u)), __fsub_rn(w, 1.0f));
  return (int)__fadd_rn(l, f);
}

// the proposal from o, cm, lo / hi and one uniform per member u[0..K),
// sorted into v; -> whether every gap exceeds md
template <int K>
__device__ __forceinline__ bool candidate(const int* o, unsigned cm, const float* lo,
                                          const float* hi, const float* __restrict__ u,
                                          int md, int* v) {
#pragma unroll
  for (int c = 0; c < K; ++c) v[c] = (cm >> c & 1u) ? draw(lo[c], hi[c], u[c]) : o[c];
  sort_net<K>(v);
  bool ok = true;
#pragma unroll
  for (int c = 0; c + 1 < K; ++c) ok = ok && (v[c + 1] - v[c] > md);
  return ok;
}

}  // namespace proposal
