// Fused Hyper-SAGNN hyperedge attention, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel matcha_tpu/ops/hyperedge_attention.py:_fwd_kernel_fm
// (feature-major, :391-451) and its lane-major twin _fwd_kernel (:47-108):
// one kernel covers both TPU layouts.  For x (E, L, 64) it computes
//   LN_q, LN_k, LN_v of x (eps 1e-5, f32 statistics)
//   -> q, k, v = LN(x) @ W (W: 64 x H*64, H heads of dk = 64)
//   -> per head s_ij = q_i . k_j / sqrt(dk), s_ii = -1e32 under diag_mask
//   -> softmax over all L keys -> o_i = sum_j a_ij v_j
//   -> y = o @ fw + fb   (fw: H*64 x 64)
// and writes y (E, L, 64) in x's dtype.
//
// Rounding follows the TPU kernel, not the XLA oracle: the LayerNorm outputs,
// q and k are rounded to x's dtype, v stays f32, the attention output is
// rounded to x's dtype before fc1, and y is rounded once at the store.  The
// weights are read in f32, as the TPU kernel reads the f32 master params.
// Scores are f32 products of the rounded q and k, summed in f32.
//
// Bound on this card (H100 SXM, bf16 inputs, per edge of L tokens):
//   operations  2*L*64*512*3 (q/k/v) + 2*L*512*64 (fc1) + 4*L*L*512 (scores,
//               a@v); at E = 10,000, L = 5: 13.6 GFLOP -> 13.8 us at 989 TFLOP/s
//   bytes       2*E*L*64*2 (x in, y out) + 0.5 MB of f32 weights; 13.3 MB
//               -> 4.0 us at 3.35 TB/s
// so the work is bound by the tensor cores' rate.  This first version does
// not use them: it runs the products as f32 FMAs on the CUDA cores (67
// TFLOP/s peak), reading operands from shared memory.  Its design:
//   * one block of 256 threads per tile of TE edges (16 for L <= 5, else 8),
//     R = TE*L token rows; the ragged tail is masked, so any E works;
//   * the tile of x is read once; the three LayerNorms go to shared memory;
//   * a loop over heads stages the 64x64 slices of wq, wk, wv and fw in
//     shared memory, forms q_h, k_h, v_h, the L x L scores per edge, the
//     softmax and o_h, and accumulates y += o_h @ fw_h in registers;
//   * bias, cast and one store at the end.  x and y never leave the chip
//     between the LayerNorm and the store; the 512-wide q/k/v stay on chip.
// wgmma and TMA are work for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int D = 64;        // model width d (== dk)
constexpr int MAT = D * D;   // one 64 x 64 weight slice
constexpr int NT = 256;      // threads per block
constexpr int NWARP = NT / 32;
constexpr float LN_EPS = 1e-5f;

template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static float load(const float* p, size_t i) { return p[i]; }
  __device__ static float round(float v) { return v; }
  __device__ static void store(float* p, size_t i, float v) { p[i] = v; }
};

template <>
struct Io<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p, size_t i) {
    return __bfloat162float(p[i]);
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static void store(__nv_bfloat16* p, size_t i, float v) {
    p[i] = __float2bfloat16_rn(v);
  }
};

template <int L>
struct Tile {
  static constexpr int TE = L <= 5 ? 16 : 8;  // edges per block
  static constexpr int R = TE * L;            // token rows per block
  static constexpr int RPT = R / 4;           // rows per thread
  // shared memory, in floats: LN outputs (3R x 64), weight slices (4 x 64 x
  // 64), q_h / k_h / v_h (3R x 64), scores and weights (TE x L x L)
  static constexpr int SMEM_FLOATS = 3 * R * D + 4 * MAT + 3 * R * D + TE * L * L;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[m] = sum_kk X[r][kk] * W[kk][c] for the rows r = g + 4m of this thread.
// X (R x 64) and W (64 x 64) are in shared memory; every thread of a warp
// shares g, so X reads broadcast and W reads hit 32 banks.
template <int RPT>
__device__ __forceinline__ void rows_times_w(const float* __restrict__ X,
                                             const float* __restrict__ W, int g,
                                             int c, float (&acc)[RPT]) {
#pragma unroll
  for (int m = 0; m < RPT; ++m) acc[m] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 4) {
    const float w0 = W[(kk + 0) * D + c];
    const float w1 = W[(kk + 1) * D + c];
    const float w2 = W[(kk + 2) * D + c];
    const float w3 = W[(kk + 3) * D + c];
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      const float4 xv = *reinterpret_cast<const float4*>(X + (g + 4 * m) * D + kk);
      float a = acc[m];
      a = fmaf(xv.x, w0, a);
      a = fmaf(xv.y, w1, a);
      a = fmaf(xv.z, w2, a);
      a = fmaf(xv.w, w3, a);
      acc[m] = a;
    }
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(NT, 1)
    hyperedge_attention_fwd_kernel(const T* __restrict__ x, const float* __restrict__ ln,
                                   const float* __restrict__ wq, const float* __restrict__ wk,
                                   const float* __restrict__ wv, const float* __restrict__ fw,
                                   const float* __restrict__ fb, T* __restrict__ out, int E,
                                   int H, int diag_mask) {
  using TL = Tile<L>;
  constexpr int TE = TL::TE, R = TL::R, RPT = TL::RPT;
  extern __shared__ float4 smem4[];
  float* xn = reinterpret_cast<float*>(smem4);  // [3][R][64] LN_q, LN_k, LN_v
  float* wsm = xn + 3 * R * D;                   // [4][64][64] wq, wk, wv, fw slices
  float* qkv = wsm + 4 * MAT;                    // [3][R][64] q_h, k_h, v_h (q_h then o_h)
  float* prob = qkv + 3 * R * D;                 // [TE][L][L] scores, then weights

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c = tid & (D - 1), g = tid >> 6;  // output column, row group
  const size_t row0 = (size_t)blockIdx.x * TE * L;  // first token row of the tile
  const size_t rows_left = (size_t)E * L - row0;
  const int rows_valid = rows_left < (size_t)R ? (int)rows_left : R;

  // 1. the three LayerNorms, one warp per token row, two features per lane;
  //    rows past E read as zeros and are never stored
  for (int r = warp; r < R; r += NWARP) {
    float v0 = 0.f, v1 = 0.f;
    if (r < rows_valid) {
      const size_t base = (row0 + r) * D;
      v0 = Io<T>::load(x, base + lane);
      v1 = Io<T>::load(x, base + lane + 32);
    }
    const float mu = warp_sum(v0 + v1) * (1.f / D);
    const float d0 = v0 - mu, d1 = v1 - mu;
    const float var = warp_sum(d0 * d0 + d1 * d1) * (1.f / D);
    const float rs = rsqrtf(var + LN_EPS);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const float* gam = ln + (2 * t) * D;
      const float* bet = ln + (2 * t + 1) * D;
      xn[(t * R + r) * D + lane] = Io<T>::round(d0 * rs * gam[lane] + bet[lane]);
      xn[(t * R + r) * D + lane + 32] = Io<T>::round(d1 * rs * gam[lane + 32] + bet[lane + 32]);
    }
  }

  float yacc[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m) yacc[m] = 0.f;
  const float inv_temp = 1.f / sqrtf((float)D);  // 1/sqrt(dk) = 0.125 exactly
  const size_t hd = (size_t)H * D;

  for (int h = 0; h < H; ++h) {
    // 2. stage head h's 64 x 64 slices of wq, wk, wv (columns h*64..) and of
    //    fw (rows h*64..), as float4
    for (int i = tid; i < 4 * MAT / 4; i += NT) {
      const int mat = i / (MAT / 4), rem = i % (MAT / 4);
      const int row = rem / (D / 4), col = (rem % (D / 4)) * 4;
      const float* src;
      if (mat < 3) {
        const float* w = mat == 0 ? wq : (mat == 1 ? wk : wv);
        src = w + row * hd + (size_t)h * D + col;
      } else {
        src = fw + ((size_t)h * D + row) * D + col;
      }
      reinterpret_cast<float4*>(wsm)[i] = *reinterpret_cast<const float4*>(src);
    }
    __syncthreads();

    // 3. q_h, k_h (rounded to x's dtype) and v_h (f32)
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      float acc[RPT];
      rows_times_w<RPT>(xn + t * R * D, wsm + t * MAT, g, c, acc);
#pragma unroll
      for (int m = 0; m < RPT; ++m)
        qkv[(t * R + g + 4 * m) * D + c] = t < 2 ? Io<T>::round(acc[m]) : acc[m];
    }
    __syncthreads();

    // 4. scores, one warp per (edge, query i, key j)
    for (int idx = warp; idx < TE * L * L; idx += NWARP) {
      const int e = idx / (L * L), i = (idx / L) % L, j = idx % L;
      const float* qr = qkv + (e * L + i) * D;
      const float* kr = qkv + (R + e * L + j) * D;
      const float s = warp_sum(qr[lane] * kr[lane] + qr[lane + 32] * kr[lane + 32]);
      if (lane == 0) prob[idx] = (diag_mask && i == j) ? -1e32f : s * inv_temp;
    }
    __syncthreads();

    // 5. softmax over the L keys, one thread per (edge, query)
    for (int row = tid; row < TE * L; row += NT) {
      float* s = prob + row * L;
      float mx = s[0];
#pragma unroll
      for (int j = 1; j < L; ++j) mx = fmaxf(mx, s[j]);
      float ev[L], tot = 0.f;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        ev[j] = expf(s[j] - mx);
        tot += ev[j];
      }
      const float inv = 1.f / tot;
#pragma unroll
      for (int j = 0; j < L; ++j) s[j] = ev[j] * inv;
    }
    __syncthreads();

    // 6. o_h = a @ v_h, rounded to x's dtype, into q_h's slot (q_h is dead)
    {
      float o[RPT];
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const int r = g + 4 * m, e = r / L;
        const float* a = prob + r * L;
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < L; ++j) acc = fmaf(a[j], qkv[(2 * R + e * L + j) * D + c], acc);
        o[m] = Io<T>::round(acc);
      }
#pragma unroll
      for (int m = 0; m < RPT; ++m) qkv[(g + 4 * m) * D + c] = o[m];
    }
    __syncthreads();

    // 7. y += o_h @ fw_h
    {
      float acc[RPT];
      rows_times_w<RPT>(qkv, wsm + 3 * MAT, g, c, acc);
#pragma unroll
      for (int m = 0; m < RPT; ++m) yacc[m] += acc[m];
    }
    __syncthreads();  // wsm and qkv are overwritten by the next head
  }

  // 8. bias, cast, one store per output
  const float bias = fb[c];
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    const int r = g + 4 * m;
    if (r < rows_valid) Io<T>::store(out, (row0 + r) * D + c, yacc[m] + bias);
  }
}

template <typename T, int L>
cudaError_t launch(const void* x, const void* ln, const void* wq, const void* wk,
                   const void* wv, const void* fw, const void* fb, void* out, int E, int H,
                   int diag_mask, cudaStream_t stream) {
  using TL = Tile<L>;
  static_assert(TL::R % 4 == 0, "rows per tile must split over 4 row groups");
  const int smem = TL::SMEM_FLOATS * (int)sizeof(float);
  auto kernel = hyperedge_attention_fwd_kernel<T, L>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((E + TL::TE - 1) / TL::TE);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln), static_cast<const float*>(wq),
      static_cast<const float*>(wk), static_cast<const float*>(wv),
      static_cast<const float*>(fw), static_cast<const float*>(fb), static_cast<T*>(out), E,
      H, diag_mask);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers; weights and
// LayerNorm params are f32; x and out are f32 (is_bf16 = 0) or bf16.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int matcha_hyperedge_attention_fwd(const void* x, const void* ln, const void* wq,
                                              const void* wk, const void* wv, const void* fw,
                                              const void* fb, void* out, int E, int L, int H,
                                              int diag_mask, int is_bf16, void* stream) {
  if (E <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MATCHA_CASE(LL)                                                                    \
  case LL:                                                                                 \
    return (int)(is_bf16 ? launch<__nv_bfloat16, LL>(x, ln, wq, wk, wv, fw, fb, out, E, H, \
                                                     diag_mask, s)                         \
                         : launch<float, LL>(x, ln, wq, wk, wv, fw, fb, out, E, H,         \
                                             diag_mask, s));
  switch (L) {
    MATCHA_CASE(2)
    MATCHA_CASE(3)
    MATCHA_CASE(4)
    MATCHA_CASE(5)
    MATCHA_CASE(6)
    MATCHA_CASE(7)
    MATCHA_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MATCHA_CASE
}

extern "C" const char* matcha_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
