// Fused Hyper-SAGNN hyperedge attention, backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel matcha_tpu/ops/hyperedge_attention.py:_bwd_kernel_fm
// (feature-major, :481-653) and its lane-major twin _bwd_kernel (:154-309).
// For x (E, L, 64) and the output cotangent g (E, L, 64) of the forward in
// hyperedge_attention_fwd.cu it recomputes the forward per tile of edges and
// returns
//   gx (E, L, 64) in x's dtype, and in f32, summed over all edges:
//   gln (6, 64) in the row order [q.g, q.b, k.g, k.b, v.g, v.b],
//   gwq, gwk, gwv (64, H*64), gfw (H*64, 64), gfb (64,).
//
// Bound on this card (H100 SXM, bf16 inputs), per edge of L tokens, with
// hd = H*64: operations 2*L*64*hd*(3 q/k/v + 1 g_attn + 3 back to x + 4
// weight grads) + 12*L*L*hd (scores, a@v, g.v, three attention grads); bytes
// x and g read once, gx written once, f32 weights read and grads written
// once.  At E = 8,192, L = 5: 30.8 GFLOP -> 31 us at 989 TFLOP/s against
// 16.7 MB -> 5 us, so the work is bound by the tensor cores' rate.
//
// Two routes, picked by x's dtype:
//
// * bf16 (the training step's dtype, H <= 8): hyperedge_attention_bwd_tc_
//   kernel, every 64-wide product on the tensor cores (wgmma, bf16 operands,
//   f32 sums; mma_bf16.cuh).  A cluster of H blocks, one per head, walks
//   tiles of 64 token rows (64 / L whole edges).  Block h stages head h's
//   weight slices as bf16 once and keeps gfw_h, gwq_h (warpgroup 0) and
//   gwk_h, gwv_h (warpgroup 1) in registers across all its tiles.  Per tile,
//   17 products of 64 x 64 x 64, two warpgroups side by side: q, k, v and
//   g_attn; the scores and g.v (each edge's L x L diagonal block of q k^T
//   and g_attn v^T), whose softmax and its backward run in f32 in the
//   registers; a v, g_s k, g_s^T q and a^T g_attn with a and g_s laid out
//   block-diagonally; gfw and the three weight grads; and the products back
//   to the LayerNorm outputs.  Each head's share G_h of the gradient at the
//   three LayerNorm outputs goes through distributed shared memory, summed
//   over the heads in rank order, and each rank applies the LayerNorm
//   backward to its 64 / H rows, one tile later so that the cluster barrier
//   and the remote reads overlap the next tile's LayerNorms.  Rounding: the
//   operands of the products are bf16, so the weights, v, g_attn, a, g_s
//   and the attention grads are rounded to bf16 where the plain version
//   (autograd of _fwd_xla's rounding) rounds them; q and k are products of
//   bf16 weights, so the recomputed softmax differs from K1's (f32 weights)
//   by a few bf16 ulps of q and k, well inside the 3e-2 the route is held
//   to.  Sums are f32; gx is rounded once at the store.
// * f32 (and bf16 with more than 8 heads): hyperedge_attention_bwd_kernel,
//   the products as f32 FMAs on the CUDA cores.  It rounds as the TPU
//   backward does: the LayerNorm outputs, q and k to x's dtype, v and the
//   attention output kept f32.  A persistent grid of at most one block per
//   SM walks tiles of TE edges (R = TE*L <= 40 token rows); per tile and
//   head it stages the 64x64 slices of wq, wk, wv and fw (row stride 65) and
//   runs the forward again and its backward; the gradient at the three
//   LayerNorm outputs is folded into one accumulator G = sum_t gamma_t *
//   g_xt per token across the heads.
// Both routes write each block's (cluster's) weight and LayerNorm grads into
// its own f32 slice of a scratch buffer and a second kernel sums the slices
// in order: no float atomics, the same bits on every run.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int D = 64;        // model width d (== dk)
constexpr int WS = D + 1;    // row stride of a staged 64 x 64 weight slice
constexpr int NT = 256;      // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAX_ROWS = 40; // token rows per tile
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

// edges per tile: the most with TE*L <= MAX_ROWS and TE*L divisible by 4
constexpr int tile_edges(int L) {
  int te = MAX_ROWS / L;
  while ((te * L) % 4 != 0) --te;
  return te;
}

template <int L>
struct Tile {
  static constexpr int TE = tile_edges(L);
  static constexpr int R = TE * L;
  static constexpr int RPT = R / 4;  // rows per thread
  // shared memory in floats, in this order: LN outputs (3R x 64), x-hat
  // (R x 64), 1/sigma (R, padded to 4), g (R x 64), weight slices (4 x 64 x
  // 65), q_h / k_h / v_h (3R x 64), attention output then gq (R x 64),
  // g_attn (R x 64), gk and gv (2R x 64), weights then their grads (R x L),
  // g.v then the score grads (R x L)
  static constexpr int RP = (R + 3) / 4 * 4;
  static constexpr int RL = (R * L + 3) / 4 * 4;
  static constexpr int SMEM_FLOATS =
      3 * R * D + R * D + RP + R * D + 4 * D * WS + 3 * R * D + R * D + R * D + 2 * R * D +
      2 * RL;
};

// per-block scratch slice, in floats: gwq, gwk, gwv (64 x hd each), gfw
// (hd x 64), gln (6 x 64), gfb (64)
__host__ __device__ inline size_t slice_floats(int H) {
  return (size_t)4 * D * H * D + 7 * D;
}

using mma_bf16::cluster_arrive;
using mma_bf16::cluster_wait;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[m] = sum_kk X[(g + 4m)][kk] * W(kk, c) with W(kk, c) = W[kk*WS + c]
// (TRANS = false) or W[c*WS + kk] (TRANS = true).  X (R x 64) is read as
// float4 broadcasts (a warp shares g); with the row stride 65 both forms of
// W read 32 banks.
template <int RPT, bool TRANS>
__device__ __forceinline__ void rows_times_w(const float* __restrict__ X,
                                             const float* __restrict__ W, int g, int c,
                                             float (&acc)[RPT]) {
#pragma unroll
  for (int m = 0; m < RPT; ++m) acc[m] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 4) {
    float w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = TRANS ? W[c * WS + kk + u] : W[(kk + u) * WS + c];
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      const float4 xv = *reinterpret_cast<const float4*>(X + (g + 4 * m) * D + kk);
      float a = acc[m];
      a = fmaf(xv.x, w[0], a);
      a = fmaf(xv.y, w[1], a);
      a = fmaf(xv.z, w[2], a);
      a = fmaf(xv.w, w[3], a);
      acc[m] = a;
    }
  }
}

// acc[j] = sum_r X[r][16g + j] * Y[r][c] over the R rows of the tile: the
// 16 x 1 strip of a 64 x 64 weight-grad partial this thread owns.
template <int R>
__device__ __forceinline__ void outer_rows(const float* __restrict__ X,
                                           const float* __restrict__ Y, int g, int c,
                                           float (&acc)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    const float y = Y[r * D + c];
    const float4* xr = reinterpret_cast<const float4*>(X + r * D + 16 * g);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 xv = xr[q];
      acc[4 * q + 0] = fmaf(xv.x, y, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(xv.y, y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(xv.z, y, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(xv.w, y, acc[4 * q + 3]);
    }
  }
}

// dst[(a0 + 16g + j) * stride + col] (+)= acc[j]: write on the block's first
// tile, add afterwards (each address has one owner thread per block)
__device__ __forceinline__ void store_partial(float* __restrict__ dst, size_t stride, int a0,
                                              int g, size_t col, const float (&acc)[16],
                                              bool first) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float* p = dst + (size_t)(a0 + 16 * g + j) * stride + col;
    *p = first ? acc[j] : *p + acc[j];
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(NT, 1)
    hyperedge_attention_bwd_kernel(const T* __restrict__ x, const float* __restrict__ ln,
                                   const float* __restrict__ wq, const float* __restrict__ wk,
                                   const float* __restrict__ wv, const float* __restrict__ fw,
                                   const T* __restrict__ gy_in, T* __restrict__ gx_out,
                                   float* __restrict__ scratch, int E, int H, int diag_mask) {
  using TL = Tile<L>;
  constexpr int TE = TL::TE, R = TL::R, RPT = TL::RPT, RL = TL::RL;
  extern __shared__ float4 smem4[];
  float* xn = reinterpret_cast<float*>(smem4);  // [3][R][64] LN_q, LN_k, LN_v outputs
  float* xhat = xn + 3 * R * D;                  // [R][64]
  float* isig = xhat + R * D;                    // [R]
  float* gy = isig + TL::RP;                     // [R][64] output cotangent
  float* wsm = gy + R * D;                       // [4][64][65] wq, wk, wv, fw slices
  float* qkv = wsm + 4 * D * WS;                 // [3][R][64] q_h, k_h, v_h
  float* ao = qkv + 3 * R * D;                   // [R][64] attention output, then gq
  float* gat = ao + R * D;                       // [R][64] g_attn = g @ fw_h^T
  float* gkv = gat + R * D;                      // [2][R][64] gk, gv
  float* prob = gkv + 2 * R * D;                 // [TE][L][L] scores -> weights a
  float* gsc = prob + RL;                        // [TE][L][L] g.v -> score grads

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c = tid & (D - 1), g = tid >> 6;  // column, row group
  const int hd = H * D;
  const float inv_temp = 1.f / sqrtf((float)D);
  float* my = scratch + (size_t)blockIdx.x * slice_floats(H);
  float* s_gwq = my;
  float* s_gwk = s_gwq + (size_t)D * hd;
  float* s_gwv = s_gwk + (size_t)D * hd;
  float* s_gfw = s_gwv + (size_t)D * hd;
  float* s_gln = s_gfw + (size_t)hd * D;
  float* s_gfb = s_gln + 6 * D;

  float gam[3];
#pragma unroll
  for (int t = 0; t < 3; ++t) gam[t] = ln[(2 * t) * D + c];
  float lng[3] = {0.f, 0.f, 0.f}, lnb[3] = {0.f, 0.f, 0.f}, gfb = 0.f;

  const int n_tiles = (E + TE - 1) / TE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const size_t row0 = (size_t)tile * R;
    const size_t rows_left = (size_t)E * L - row0;
    const int rows_valid = rows_left < (size_t)R ? (int)rows_left : R;

    // 1. LayerNorms (one warp per row, two features per lane) and g; rows
    //    past E read as zeros, contribute nothing and are never stored
    for (int r = warp; r < R; r += NWARP) {
      float v0 = 0.f, v1 = 0.f, g0 = 0.f, g1 = 0.f;
      if (r < rows_valid) {
        const size_t base = (row0 + r) * D;
        v0 = Io<T>::load(x, base + lane);
        v1 = Io<T>::load(x, base + lane + 32);
        g0 = Io<T>::load(gy_in, base + lane);
        g1 = Io<T>::load(gy_in, base + lane + 32);
      }
      const float mu = warp_sum(v0 + v1) * (1.f / D);
      const float d0 = v0 - mu, d1 = v1 - mu;
      const float var = warp_sum(d0 * d0 + d1 * d1) * (1.f / D);
      const float rs = rsqrtf(var + LN_EPS);
      const float h0 = d0 * rs, h1 = d1 * rs;
      xhat[r * D + lane] = h0;
      xhat[r * D + lane + 32] = h1;
      if (lane == 0) isig[r] = rs;
      gy[r * D + lane] = g0;
      gy[r * D + lane + 32] = g1;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const float* gm = ln + (2 * t) * D;
        const float* bt = ln + (2 * t + 1) * D;
        xn[(t * R + r) * D + lane] = Io<T>::round(h0 * gm[lane] + bt[lane]);
        xn[(t * R + r) * D + lane + 32] = Io<T>::round(h1 * gm[lane + 32] + bt[lane + 32]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int m = 0; m < RPT; ++m) gfb += gy[(g + 4 * m) * D + c];

    float G[RPT];  // sum_t gamma_t * (gradient at LN_t's output), this thread's rows
#pragma unroll
    for (int m = 0; m < RPT; ++m) G[m] = 0.f;

    for (int h = 0; h < H; ++h) {
      // a. stage head h's 64 x 64 slices: wq, wk, wv (columns h*64..) and fw
      //    (rows h*64..), row stride 65
      for (int i = tid; i < 4 * D * D / 4; i += NT) {
        const int mat = i / (D * D / 4), rem = i % (D * D / 4);
        const int row = rem / (D / 4), col = (rem % (D / 4)) * 4;
        const float* src;
        if (mat < 3) {
          const float* w = mat == 0 ? wq : (mat == 1 ? wk : wv);
          src = w + (size_t)row * hd + (size_t)h * D + col;
        } else {
          src = fw + ((size_t)h * D + row) * D + col;
        }
        const float4 v = *reinterpret_cast<const float4*>(src);
        float* dst = wsm + mat * D * WS + row * WS + col;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
      __syncthreads();

      // b. q_h, k_h (rounded to x's dtype) and v_h (f32)
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        float acc[RPT];
        rows_times_w<RPT, false>(xn + t * R * D, wsm + t * D * WS, g, c, acc);
#pragma unroll
        for (int m = 0; m < RPT; ++m)
          qkv[(t * R + g + 4 * m) * D + c] = t < 2 ? Io<T>::round(acc[m]) : acc[m];
      }
      __syncthreads();

      // c. scores, one warp per (edge, query i, key j), then the softmax
      for (int idx = warp; idx < TE * L * L; idx += NWARP) {
        const int e = idx / (L * L), i = (idx / L) % L, j = idx % L;
        const float* qr = qkv + (e * L + i) * D;
        const float* kr = qkv + (R + e * L + j) * D;
        const float s = warp_sum(qr[lane] * kr[lane] + qr[lane + 32] * kr[lane + 32]);
        if (lane == 0) prob[idx] = (diag_mask && i == j) ? -1e32f : s * inv_temp;
      }
      __syncthreads();
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

      // d. attention output o_h = a @ v_h (f32) and g_attn = g @ fw_h^T
      {
        float acc[RPT];
#pragma unroll
        for (int m = 0; m < RPT; ++m) {
          const int r = g + 4 * m, e = r / L;
          const float* a = prob + r * L;
          float o = 0.f;
#pragma unroll
          for (int j = 0; j < L; ++j) o = fmaf(a[j], qkv[(2 * R + e * L + j) * D + c], o);
          ao[r * D + c] = o;
        }
        rows_times_w<RPT, true>(gy, wsm + 3 * D * WS, g, c, acc);
#pragma unroll
        for (int m = 0; m < RPT; ++m) gat[(g + 4 * m) * D + c] = acc[m];
      }
      __syncthreads();

      // e. gfw_h += o_h^T g, and g.v per (edge, i, j), one warp each
      {
        float wacc[16];
        outer_rows<R>(ao, gy, g, c, wacc);
        store_partial(s_gfw, D, h * D, g, c, wacc, first);
      }
      for (int idx = warp; idx < TE * L * L; idx += NWARP) {
        const int e = idx / (L * L), i = (idx / L) % L, j = idx % L;
        const float* ga = gat + (e * L + i) * D;
        const float* vr = qkv + (2 * R + e * L + j) * D;
        const float s = warp_sum(ga[lane] * vr[lane] + ga[lane + 32] * vr[lane + 32]);
        if (lane == 0) gsc[idx] = (diag_mask && i == j) ? 0.f : s;
      }
      __syncthreads();

      // f. softmax backward, one thread per (edge, query):
      //    g_s_ij = a_ij * (g.v_ij - sum_j' a_ij' g.v_ij') / sqrt(dk)
      for (int row = tid; row < TE * L; row += NT) {
        const float* a = prob + row * L;
        float* gs = gsc + row * L;
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < L; ++j) dot = fmaf(a[j], gs[j], dot);
#pragma unroll
        for (int j = 0; j < L; ++j) gs[j] = a[j] * (gs[j] - dot) * inv_temp;
      }
      __syncthreads();

      // g. gq_i = sum_j g_s_ij k_j (into o_h's slot), gk_j = sum_i g_s_ij q_i,
      //    gv_j = sum_i a_ij g_attn_i
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const int r = g + 4 * m, e = r / L, p = r % L;
        float aq = 0.f, ak = 0.f, av = 0.f;
#pragma unroll
        for (int j = 0; j < L; ++j) {
          const float gs_pj = gsc[(e * L + p) * L + j];   // row p as the query
          const float gs_jp = gsc[(e * L + j) * L + p];   // row p as the key
          const float a_jp = prob[(e * L + j) * L + p];
          aq = fmaf(gs_pj, qkv[(R + e * L + j) * D + c], aq);
          ak = fmaf(gs_jp, qkv[(e * L + j) * D + c], ak);
          av = fmaf(a_jp, gat[(e * L + j) * D + c], av);
        }
        ao[r * D + c] = aq;
        gkv[r * D + c] = ak;
        gkv[(R + r) * D + c] = av;
      }
      __syncthreads();

      // h. weight grads gW_t += LN_t^T gq/gk/gv, and the gradient at the LN
      //    outputs g_xt = g{q,k,v} @ W_t^T folded into G and the LN grads
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const float* gp = t == 0 ? ao : gkv + (t - 1) * R * D;
        float wacc[16];
        outer_rows<R>(xn + t * R * D, gp, g, c, wacc);
        float* dst = t == 0 ? s_gwq : (t == 1 ? s_gwk : s_gwv);
        store_partial(dst, (size_t)hd, 0, g, (size_t)h * D + c, wacc, first);
        float acc[RPT];
        rows_times_w<RPT, true>(gp, wsm + t * D * WS, g, c, acc);
#pragma unroll
        for (int m = 0; m < RPT; ++m) {
          G[m] = fmaf(gam[t], acc[m], G[m]);
          lng[t] = fmaf(acc[m], xhat[(g + 4 * m) * D + c], lng[t]);
          lnb[t] += acc[m];
        }
      }
      __syncthreads();  // wsm and the head buffers are overwritten next
    }

    // LayerNorm backward of the three LNs at once, one warp per row:
    //   gx = (1/sigma) * (G - mean(G) - x-hat * mean(G * x-hat))
#pragma unroll
    for (int m = 0; m < RPT; ++m) qkv[(g + 4 * m) * D + c] = G[m];
    __syncthreads();
    for (int r = warp; r < rows_valid; r += NWARP) {
      const float G0 = qkv[r * D + lane], G1 = qkv[r * D + lane + 32];
      const float h0 = xhat[r * D + lane], h1 = xhat[r * D + lane + 32];
      const float m1 = warp_sum(G0 + G1) * (1.f / D);
      const float m2 = warp_sum(G0 * h0 + G1 * h1) * (1.f / D);
      const float rs = isig[r];
      const size_t base = (row0 + r) * D;
      Io<T>::store(gx_out, base + lane, rs * (G0 - m1 - h0 * m2));
      Io<T>::store(gx_out, base + lane + 32, rs * (G1 - m1 - h1 * m2));
    }
    __syncthreads();  // the next tile overwrites every buffer
  }

  // the block's LN-param and fc1-bias grads: sum the four row groups in order
  float* red = qkv;  // [4][7][64]
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    red[(g * 7 + 2 * t) * D + c] = lng[t];
    red[(g * 7 + 2 * t + 1) * D + c] = lnb[t];
  }
  red[(g * 7 + 6) * D + c] = gfb;
  __syncthreads();
  for (int i = tid; i < 7 * D; i += NT) {
    const float s = red[i] + red[7 * D + i] + red[14 * D + i] + red[21 * D + i];
    if (i < 6 * D)
      s_gln[i] = s;
    else
      s_gfb[i - 6 * D] = s;
  }
}

// out[i] = sum over blocks b = 0, 1, ... of scratch[b][i], in block order
__global__ void __launch_bounds__(NT)
    reduce_slices_kernel(const float* __restrict__ scratch, float* __restrict__ out, int n_slices,
                         size_t n) {
  const size_t i = (size_t)blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < n_slices; ++b) s += scratch[(size_t)b * n + i];
  out[i] = s;
}

// ------------------------------------------------- the tensor-core route (bf16)
// (design in the note at the top of this file)

constexpr int TC_ROWS = 64;        // token rows per tile
constexpr int FS = 68;             // row stride of the tile's f32 buffers
constexpr int MAX_TC_HEADS = 8;    // heads = blocks of a cluster
constexpr int TILE_ELEMS = mma_bf16::TILE;
// bf16 tiles, 64 x 64 each in mma_bf16's blocked layout
enum {
  T_WQ, T_WK, T_WV, T_FW,  // head h's weight slices
  T_XQ, T_XK, T_XV,        // LN_q, LN_k, LN_v outputs
  T_GY, T_Q, T_K, T_V, T_GA,
  T_A, T_S,                // a and g_s, block-diagonal: each edge's L x L block
  T_O, T_GQ, T_GK, T_GV,
  N_BT
};
// then f32: xhat, G (two buffers each), 1/sigma (two buffers), the per-warp
// fc1-bias grads at the end (8 x 64), LN params (6 x 64), per-warp LN-grad
// sums (8 warps x 3 x 2 x 32)
constexpr int TC_F32 = 4 * TC_ROWS * FS + 2 * TC_ROWS + NWARP * D + 6 * D + NWARP * 3 * 2 * 32;
constexpr int TC_SMEM_BYTES = N_BT * TILE_ELEMS * 2 + TC_F32 * 4;
static_assert(TC_SMEM_BYTES <= 232448, "shared memory of one block");

using mma_bf16::store_bf16;

template <int L>
struct TcTile {
  static constexpr int TE = TC_ROWS / L;  // whole edges per tile
  static constexpr int R = TE * L;        // token rows holding them
};

template <int L>
__global__ void __launch_bounds__(NT, 1)
    hyperedge_attention_bwd_tc_kernel(const __nv_bfloat16* __restrict__ x,
                                      const float* __restrict__ ln, const float* __restrict__ wq,
                                      const float* __restrict__ wk, const float* __restrict__ wv,
                                      const float* __restrict__ fw,
                                      const __nv_bfloat16* __restrict__ gy_in,
                                      __nv_bfloat16* __restrict__ gx_out,
                                      float* __restrict__ scratch, int E, int H, int diag_mask) {
  using mma_bf16::async_fence;
  using mma_bf16::blk;
  using mma_bf16::wg_gemm2;
  using mma_bf16::wg_issue;
  using mma_bf16::wg_wait;
  using bf16 = __nv_bfloat16;
  using bf162 = __nv_bfloat162;
  constexpr int TE = TcTile<L>::TE, R = TcTile<L>::R;
  extern __shared__ float4 smem4[];
  bf16* tiles = reinterpret_cast<bf16*>(smem4);
  // xhat, G_h and 1/sigma are double-buffered: tile i's LayerNorm backward
  // runs after tile i + 1's LayerNorms
  float* xhat2 = reinterpret_cast<float*>(tiles + N_BT * TILE_ELEMS);  // [2][64][FS]
  float* gsm = xhat2 + 2 * TC_ROWS * FS;  // [2][64][FS]
  float* isig2 = gsm + 2 * TC_ROWS * FS;  // [2][64]
  float* wfb = isig2 + 2 * TC_ROWS;       // [8][64] per-warp gfb, at the end
  float* ln6 = wfb + NWARP * D;         // [6][64]
  float* lnacc = ln6 + 6 * D;           // [warp][t][gamma, beta][32 columns]
  auto tile = [&](int i) { return tiles + i * TILE_ELEMS; };

  cg::cluster_group cluster = cg::this_cluster();
  const int h = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // warpgroup grp (warps 4grp..4grp+3), warp q in it; a thread's rows of a
  // product are 16q + fg (+ 8), its columns 8j + 2fc (+ 1)
  const int q = warp & 3, grp = warp >> 2, fg = lane >> 2, fc = lane & 3;
  const int m0 = 16 * q, n0 = 32 * grp;  // this warp's block of a column-split product
  const int hd = H * D;
  const float inv_temp = 1.f / sqrtf((float)D);
  const float NEG_INF = __int_as_float(0xff800000);

  // head h's weights as bf16, once: W_t[k = feature][n = column] and
  // fw_h[n = head column][k = output]
  for (int i = tid; i < 4 * D * (D / 4); i += NT) {
    const int mat = i / (D * D / 4), rem = i % (D * D / 4);
    const int row = rem / (D / 4), col = (rem % (D / 4)) * 4;
    const float* src = mat < 3 ? (mat == 0 ? wq : (mat == 1 ? wk : wv)) + (size_t)row * hd +
                                     (size_t)h * D + col
                               : fw + ((size_t)h * D + row) * D + col;
    const float4 v = *reinterpret_cast<const float4*>(src);
    bf162* dst = reinterpret_cast<bf162*>(tile(T_WQ + mat) + blk(row, col));
    dst[0] = __floats2bfloat162_rn(v.x, v.y);
    dst[1] = __floats2bfloat162_rn(v.z, v.w);
  }
  for (int i = tid; i < 6 * D; i += NT) ln6[i] = ln[i];
  for (int i = tid; i < NWARP * 3 * 2 * 32; i += NT) lnacc[i] = 0.f;
  async_fence();
  __syncthreads();

  // weight-grad accumulators, across all tiles: warpgroup 0 holds gfw_h and
  // gwq_h, warpgroup 1 gwk_h and gwv_h
  float accp[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) accp[0][i] = accp[1][i] = 0.f;
  // the LayerNorm's lane layout: warp w takes rows 8w..8w+7 (one band of
  // core matrices), lane (rr, cg) row 8w + rr and the columns of chunks cg
  // and cg + 4, so eight lanes read one whole core matrix at a time
  const int rr = lane & 7, cg = lane >> 3;
  float gfb[16];  // sums of g over this lane's rows, its 16 columns
#pragma unroll
  for (int u = 0; u < 16; ++u) gfb[u] = 0.f;

  const int n_tiles = (E + TE - 1) / TE;
  // copy tile ti's rows of x and g into the a and g_s tiles (free from step
  // 5 until the next tile's softmax) with cp.async, so the copy runs while
  // the block works on the tile before
  auto prefetch = [&](int ti) {
    const size_t r0 = (size_t)ti * R;
    const size_t left = (size_t)E * L - r0;
    const int rv = left < (size_t)R ? (int)left : R;
    for (int i = tid; i < 2 * TC_ROWS * (D / 8); i += NT) {
      const int which = i / (TC_ROWS * (D / 8)), r = (i / (D / 8)) % TC_ROWS;
      const int c = 8 * (i % (D / 8));
      if (r < rv)
        mma_bf16::cp_async16(tile(T_A + which) + blk(r, c), (which ? gy_in : x) + (r0 + r) * D + c);
    }
    mma_bf16::cp_async_commit();
  };
  if ((int)blockIdx.y < n_tiles) prefetch(blockIdx.y);

  // 6. the rows 64/H * h .. of the tile in buffer b: G summed over the
  //    heads in rank order (through distributed shared memory), then the
  //    LayerNorm backward of the three LNs at once, one warp per row:
  //    gx = (1/sigma) * (G - mean(G) - x-hat * mean(G * x-hat))
  auto ln_backward = [&](int b, size_t row0, int rows_valid) {
    const float* gb = gsm + b * TC_ROWS * FS;
    const float* xb = xhat2 + b * TC_ROWS * FS;
    const int per = (TC_ROWS + H - 1) / H;
    const int r_lo = h * per;
    const int r_hi = r_lo + per < rows_valid ? r_lo + per : rows_valid;
    for (int r = r_lo + warp; r < r_hi; r += NWARP) {
      float2 v[MAX_TC_HEADS];
#pragma unroll
      for (int rk = 0; rk < MAX_TC_HEADS; ++rk)  // all remote loads in flight at once
        if (rk < H)
          v[rk] = *reinterpret_cast<const float2*>(cluster.map_shared_rank(gb, rk) + r * FS +
                                                   2 * lane);
      float G0 = 0.f, G1 = 0.f;
#pragma unroll
      for (int rk = 0; rk < MAX_TC_HEADS; ++rk)
        if (rk < H) {
          G0 += v[rk].x;
          G1 += v[rk].y;
        }
      const float2 hx = *reinterpret_cast<const float2*>(xb + r * FS + 2 * lane);
      const float mean1 = warp_sum(G0 + G1) * (1.f / D);
      const float mean2 = warp_sum(G0 * hx.x + G1 * hx.y) * (1.f / D);
      const float rs = isig2[b * TC_ROWS + r];
      reinterpret_cast<bf162*>(gx_out + (row0 + r) * D)[lane] = __floats2bfloat162_rn(
          rs * (G0 - mean1 - hx.x * mean2), rs * (G1 - mean1 - hx.y * mean2));
    }
  };

  // Each tile's G_h goes out with a cluster-barrier arrive; the wait comes
  // after the next tile's LayerNorms, so the barrier and the remote reads
  // overlap them.  The buffers alternate: a rank still reading buffer b of
  // tile i holds back everyone's wait of tile i + 1, so nobody writes b
  // (tile i + 2) meanwhile.
  int buf = 0;
  size_t prev_row0 = 0;
  int prev_valid = 0;
  for (int ti = blockIdx.y; ti < n_tiles; ti += gridDim.y, buf ^= 1) {
    const size_t row0 = (size_t)ti * R;
    const size_t rows_left = (size_t)E * L - row0;
    const int rows_valid = rows_left < (size_t)R ? (int)rows_left : R;
    float* xhat = xhat2 + buf * TC_ROWS * FS;
    float* isig = isig2 + buf * TC_ROWS;
    mma_bf16::cp_async_wait_all();
    __syncthreads();

    // 1. LayerNorms and g (from the prefetched rows): four lanes per row,
    //    sixteen columns per lane (two 16-byte chunks), a row's sums in two
    //    shuffles; rows past the tile's edges read as zeros and are never
    //    stored
    {
      const int r = 8 * warp + rr;
      float xv[16], gv[16];
      uint4 graw[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        uint4 xraw = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows_valid) {
          xraw = *reinterpret_cast<const uint4*>(tile(T_A) + blk(r, 8 * (cg + 4 * k)));
          graw[k] = *reinterpret_cast<const uint4*>(tile(T_S) + blk(r, 8 * (cg + 4 * k)));
        }
        const bf162* xb = reinterpret_cast<const bf162*>(&xraw);
        const bf162* gb = reinterpret_cast<const bf162*>(&graw[k]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 a = __bfloat1622float2(xb[u]), b = __bfloat1622float2(gb[u]);
          xv[8 * k + 2 * u] = a.x;
          xv[8 * k + 2 * u + 1] = a.y;
          gv[8 * k + 2 * u] = b.x;
          gv[8 * k + 2 * u + 1] = b.y;
        }
      }
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 16; ++u) sum += xv[u];
      sum += __shfl_xor_sync(0xffffffffu, sum, 8);
      sum += __shfl_xor_sync(0xffffffffu, sum, 16);
      const float mu = sum * (1.f / D);
      float sq = 0.f;
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        xv[u] -= mu;
        sq += xv[u] * xv[u];
      }
      sq += __shfl_xor_sync(0xffffffffu, sq, 8);
      sq += __shfl_xor_sync(0xffffffffu, sq, 16);
      const float rs = rsqrtf(sq * (1.f / D) + LN_EPS);
#pragma unroll
      for (int u = 0; u < 16; ++u) xv[u] *= rs;
      if (cg == 0) isig[r] = rs;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c = 8 * (cg + 4 * k);
        float4* xh = reinterpret_cast<float4*>(xhat + r * FS + c);
        xh[0] = make_float4(xv[8 * k], xv[8 * k + 1], xv[8 * k + 2], xv[8 * k + 3]);
        xh[1] = make_float4(xv[8 * k + 4], xv[8 * k + 5], xv[8 * k + 6], xv[8 * k + 7]);
        *reinterpret_cast<uint4*>(tile(T_GY) + blk(r, c)) = graw[k];
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const float4* gm4 = reinterpret_cast<const float4*>(ln6 + (2 * t) * D + c);
          const float4* bt4 = reinterpret_cast<const float4*>(ln6 + (2 * t + 1) * D + c);
          const float4 ga = gm4[0], gb = gm4[1], ba = bt4[0], bb = bt4[1];
          const float gm[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
          const float bt[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
          uint4 out;
          bf162* ob = reinterpret_cast<bf162*>(&out);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            ob[u] = __floats2bfloat162_rn(xv[8 * k + 2 * u] * gm[2 * u] + bt[2 * u],
                                          xv[8 * k + 2 * u + 1] * gm[2 * u + 1] + bt[2 * u + 1]);
          *reinterpret_cast<uint4*>(tile(T_XQ + t) + blk(r, c)) = out;
        }
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) gfb[u] += gv[u];
    }
    async_fence();
    __syncthreads();
    if (ti != (int)blockIdx.y) {  // the tile before: its LayerNorm backward
      cluster_wait();
      ln_backward(buf ^ 1, prev_row0, prev_valid);
    }

    // 2. on the tensor cores, two products per warpgroup: q_h and v_h
    //    (warpgroup 0), k_h and g_attn = g @ fw_h^T (warpgroup 1), each
    //    rounded to bf16
    {
      float d1[32], d2[32];
      if (grp == 0) {
        wg_gemm2<false, true, false, true>(d1, tile(T_XQ), tile(T_WQ), d2, tile(T_XV),
                                           tile(T_WV), false, q, lane);
        store_bf16(d1, tile(T_Q), q, fg, fc);
        store_bf16(d2, tile(T_V), q, fg, fc);
      } else {
        wg_gemm2<false, true, false, false>(d1, tile(T_XK), tile(T_WK), d2, tile(T_GY),
                                            tile(T_FW), false, q, lane);
        store_bf16(d1, tile(T_K), q, fg, fc);
        store_bf16(d2, tile(T_GA), q, fg, fc);
      }
    }
    async_fence();
    __syncthreads();

    // 3. on warpgroup 0: the 64 x 64 products q_h k_h^T and g_attn v_h^T on
    //    the tensor cores, of which each edge's L x L diagonal block is kept
    //    (its scores and g.v), then the softmax and its backward in f32 in
    //    the registers, a row's sums over the four lanes that hold it:
    //    g_s_ij = a_ij * (g.v_ij - sum_j' a_ij' g.v_ij') / sqrt(dk);
    //    a and g_s go out as block-diagonal bf16 tiles (each edge's L x L
    //    block, zeros elsewhere and in the rows past R)
    if (grp == 0) {
      float sc[32], gv[32];
      wg_gemm2<false, false, false, false>(sc, tile(T_Q), tile(T_K), gv, tile(T_GA),
                                           tile(T_V), false, q, lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * q + fg + 8 * hh, lo = (r / L) * L;
        const bool row_ok = r < R;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int c = 8 * j + 2 * fc + u, k = 4 * j + 2 * hh + u;
            const bool in = row_ok && c >= lo && c < lo + L;
            const bool masked = diag_mask && c == r;
            sc[k] = in ? (masked ? -1e32f : sc[k] * inv_temp) : NEG_INF;
            gv[k] = in && !masked ? gv[k] : 0.f;
            mx = fmaxf(mx, sc[k]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float tot = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int k = 4 * j + 2 * hh + u;
            sc[k] = row_ok ? expf(sc[k] - mx) : 0.f;
            tot += sc[k];
          }
        tot += __shfl_xor_sync(0xffffffffu, tot, 1);
        tot += __shfl_xor_sync(0xffffffffu, tot, 2);
        const float inv = row_ok ? 1.f / tot : 0.f;
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int k = 4 * j + 2 * hh + u;
            sc[k] *= inv;
            dot = fmaf(sc[k], gv[k], dot);
          }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int k = 4 * j + 2 * hh + u;
            gv[k] = sc[k] * (gv[k] - dot) * inv_temp;
          }
      }
      store_bf16(sc, tile(T_A), q, fg, fc);
      store_bf16(gv, tile(T_S), q, fg, fc);
    }
    __syncthreads();

    // 4. on the tensor cores, with the block-diagonal a and g_s: o_h = a v_h
    //    and gk = g_s^T q_h (warpgroup 0), gq = g_s k_h and gv = a^T g_attn
    //    (warpgroup 1), each rounded to bf16 for the products that follow
    //    (rows past R come out zero); then the a and g_s tiles are free for
    //    the next tile's rows
    {
      float d1[32], d2[32];
      if (grp == 0) {
        wg_gemm2<false, true, true, true>(d1, tile(T_A), tile(T_V), d2, tile(T_S), tile(T_Q),
                                          false, q, lane);
        store_bf16(d1, tile(T_O), q, fg, fc);
        store_bf16(d2, tile(T_GK), q, fg, fc);
      } else {
        wg_gemm2<false, true, true, true>(d1, tile(T_S), tile(T_K), d2, tile(T_A), tile(T_GA),
                                          false, q, lane);
        store_bf16(d1, tile(T_GQ), q, fg, fc);
        store_bf16(d2, tile(T_GV), q, fg, fc);
      }
    }
    async_fence();
    __syncthreads();
    if (ti + (int)gridDim.y < n_tiles) prefetch(ti + gridDim.y);

    // 5. on the tensor cores: gfw_h += o_h^T g and gwq_h += LN_q^T gq
    //    (warpgroup 0), gwk_h += LN_k^T gk and gwv_h += LN_v^T gv
    //    (warpgroup 1); then g_t @ W_t,h^T for t = q, k, v, each split by
    //    columns over the two warpgroups, whose LayerNorm-param sums go to
    //    this warp's lnacc and whose gamma-weighted sum over t is G_h
    wg_gemm2<true, true, true, true>(accp[0], tile(grp ? T_XK : T_O), tile(grp ? T_GK : T_GY),
                                     accp[1], tile(grp ? T_XV : T_XQ), tile(grp ? T_GV : T_GQ),
                                     true, q, lane);
    float G[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) G[i] = 0.f;
    float ad[2][16];
    uint32_t af[2][4][4];
    wg_issue<false, false, 32>(ad[0], af[0], tile(T_GQ), tile(T_WQ), n0, false, q, lane);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      float(&a)[16] = ad[t & 1];
      wg_wait(a);
      if (t < 2)  // the next product runs while this one's sums are taken
        wg_issue<false, false, 32>(ad[(t + 1) & 1], af[(t + 1) & 1], tile(T_GQ + t + 1),
                                   tile(T_WQ + t + 1), n0, false, q, lane);
      float sg[8], sb[8];
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int col = n0 + 8 * jn + 2 * fc;
        const float2 gam = *reinterpret_cast<const float2*>(ln6 + (2 * t) * D + col);
        const float2 x0 = *reinterpret_cast<const float2*>(xhat + (m0 + fg) * FS + col);
        const float2 x1 = *reinterpret_cast<const float2*>(xhat + (m0 + fg + 8) * FS + col);
        const float g2[2] = {gam.x, gam.y}, h0[2] = {x0.x, x0.y}, h1[2] = {x1.x, x1.y};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float lo = a[4 * jn + u], hi = a[4 * jn + 2 + u];
          sg[2 * jn + u] = lo * h0[u] + hi * h1[u];
          sb[2 * jn + u] = lo + hi;
          G[4 * jn + u] = fmaf(g2[u], lo, G[4 * jn + u]);
          G[4 * jn + 2 + u] = fmaf(g2[u], hi, G[4 * jn + 2 + u]);
        }
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          sg[i] += __shfl_xor_sync(0xffffffffu, sg[i], o);
          sb[i] += __shfl_xor_sync(0xffffffffu, sb[i], o);
        }
      if (fg == 0) {
        float* la = lnacc + (warp * 3 + t) * 2 * 32;
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            la[8 * jn + 2 * fc + u] += sg[2 * jn + u];
            la[32 + 8 * jn + 2 * fc + u] += sb[2 * jn + u];
          }
      }
    }
    float* gcur = gsm + buf * TC_ROWS * FS;
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(gcur + (m0 + fg + 8 * hh) * FS + n0 + 8 * jn + 2 * fc) =
            make_float2(G[4 * jn + 2 * hh], G[4 * jn + 2 * hh + 1]);
    cluster_arrive();
    prev_row0 = row0;
    prev_valid = rows_valid;
  }
  cluster_wait();
  ln_backward(buf ^ 1, prev_row0, prev_valid);

  // weight grads: this cluster's slice, head h's columns (rows of gfw)
  float* my = scratch + (size_t)blockIdx.y * slice_floats(H);
  float* s_gfw = my + (size_t)3 * D * hd;
  float* s_gln = s_gfw + (size_t)hd * D;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * q + fg + 8 * hh, col = 8 * j + 2 * fc;
        const float2 v = make_float2(accp[p][4 * j + 2 * hh], accp[p][4 * j + 2 * hh + 1]);
        if (grp == 0 && p == 0)  // gfw_h: rows h*64 + head column
          *reinterpret_cast<float2*>(s_gfw + (size_t)(h * D + row) * D + col) = v;
        else  // gwq (group 0), gwk, gwv (group 1): columns h*64 + column
          *reinterpret_cast<float2*>(my + (size_t)(grp ? 1 + p : 0) * D * hd +
                                     (size_t)row * hd + h * D + col) = v;
      }

  // LayerNorm-param grads of this head (the four row-warps of each column
  // half summed in order) and, on rank 0, the fc1-bias grad (the warps in
  // order); xhat is free now.  Rank 0 then sums the heads in rank order.
  __syncthreads();
  float* red = xhat2;  // [6][64] then gfb [64]
  for (int i = tid; i < 6 * D; i += NT) {
    const int t = i / (2 * D), gb = (i / D) & 1, col = i % D, cw = col / 32;
    float s = 0.f;
#pragma unroll
    for (int mw = 0; mw < 4; ++mw) s += lnacc[((mw + 4 * cw) * 3 + t) * 64 + gb * 32 + col % 32];
    red[i] = s;
  }
  // gfb: the warp's eight rows summed by a fixed shuffle tree, then the
  // warps in order
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    gfb[u] += __shfl_xor_sync(0xffffffffu, gfb[u], 1);
    gfb[u] += __shfl_xor_sync(0xffffffffu, gfb[u], 2);
    gfb[u] += __shfl_xor_sync(0xffffffffu, gfb[u], 4);
  }
  if (rr == 0)
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int u = 0; u < 8; ++u) wfb[warp * D + 8 * (cg + 4 * k) + u] = gfb[8 * k + u];
  __syncthreads();
  for (int i = tid; i < D; i += NT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) s += wfb[w * D + i];
    red[6 * D + i] = s;
  }
  cluster.sync();
  if (h == 0) {
    for (int i = tid; i < 6 * D; i += NT) {
      float s = 0.f;
      for (int rk = 0; rk < H; ++rk) s += cluster.map_shared_rank(red, rk)[i];
      s_gln[i] = s;
    }
    for (int i = tid; i < D; i += NT) s_gln[6 * D + i] = red[6 * D + i];
  }
  cluster.sync();  // every rank's shared memory stays until rank 0 has read it
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms > 0 ? sms : 132;
}

int tiles_of(int E, int L) {
  switch (L) {
#define MATCHA_TILES(LL) \
  case LL:               \
    return (E + Tile<LL>::TE - 1) / Tile<LL>::TE;
    MATCHA_TILES(2)
    MATCHA_TILES(3)
    MATCHA_TILES(4)
    MATCHA_TILES(5)
    MATCHA_TILES(6)
    MATCHA_TILES(7)
    MATCHA_TILES(8)
#undef MATCHA_TILES
    default:
      return -1;
  }
}

template <typename T, int L>
cudaError_t launch(const void* x, const void* ln, const void* wq, const void* wk,
                   const void* wv, const void* fw, const void* g, void* gx, void* scratch,
                   void* grads, int E, int H, int diag_mask, int n_blocks, cudaStream_t stream) {
  using TL = Tile<L>;
  static_assert(TL::R % 4 == 0 && TL::R <= MAX_ROWS, "rows per tile");
  const int smem = TL::SMEM_FLOATS * (int)sizeof(float);
  auto kernel = hyperedge_attention_bwd_kernel<T, L>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln), static_cast<const float*>(wq),
      static_cast<const float*>(wk), static_cast<const float*>(wv),
      static_cast<const float*>(fw), static_cast<const T*>(g), static_cast<T*>(gx),
      static_cast<float*>(scratch), E, H, diag_mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = slice_floats(H);
  reduce_slices_kernel<<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<float*>(grads), n_blocks, n);
  return cudaGetLastError();
}

// the tensor-core route takes bf16 with at most MAX_TC_HEADS heads
bool use_tc(int is_bf16, int H) { return is_bf16 && H >= 1 && H <= MAX_TC_HEADS; }

cudaLaunchConfig_t tc_config(int H, int n_clusters, cudaStream_t stream,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)H, (unsigned)n_clusters, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = TC_SMEM_BYTES;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)H;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters of H blocks that fit on the card at once (<= 0 on an error)
template <int L>
int tc_max_clusters(int H) {
  auto kernel = hyperedge_attention_bwd_tc_kernel<L>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           TC_SMEM_BYTES) != cudaSuccess)
    return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = tc_config(H, 1, 0, &attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg) != cudaSuccess) return -1;
  return n;
}

template <int L>
cudaError_t launch_tc(const void* x, const void* ln, const void* wq, const void* wk,
                      const void* wv, const void* fw, const void* g, void* gx, void* scratch,
                      void* grads, int E, int H, int diag_mask, int n_clusters,
                      cudaStream_t stream) {
  auto kernel = hyperedge_attention_bwd_tc_kernel<L>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         TC_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = tc_config(H, n_clusters, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x),
                           static_cast<const float*>(ln), static_cast<const float*>(wq),
                           static_cast<const float*>(wk), static_cast<const float*>(wv),
                           static_cast<const float*>(fw), static_cast<const __nv_bfloat16*>(g),
                           static_cast<__nv_bfloat16*>(gx), static_cast<float*>(scratch), E, H,
                           diag_mask);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = slice_floats(H);
  reduce_slices_kernel<<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<float*>(grads), n_clusters, n);
  return cudaGetLastError();
}

// tiles of the tensor-core route: 64 / L whole edges each
int tc_tiles_of(int E, int L) { return (E + TC_ROWS / L - 1) / (TC_ROWS / L); }

}  // namespace

// Scratch slices (each of matcha_hyperedge_attention_bwd_slice_floats(H)
// floats) for E edges of size L and H heads on the route the dtype takes:
// the persistent blocks of the CUDA-core route (f32, or bf16 with more than
// 8 heads; at most one block per SM), or the persistent clusters of the
// tensor-core route (bf16).  Returns a negative value for arguments the
// kernel does not take.
extern "C" int matcha_hyperedge_attention_bwd_slices(int E, int L, int H, int is_bf16) {
  const int tiles = tiles_of(E, L);
  if (tiles < 0 || E <= 0 || H <= 0) return -1;
  if (use_tc(is_bf16, H)) {
    int most = -1;
    switch (L) {
#define MATCHA_MAX(LL)             \
  case LL:                         \
    most = tc_max_clusters<LL>(H); \
    break;
      MATCHA_MAX(2)
      MATCHA_MAX(3)
      MATCHA_MAX(4)
      MATCHA_MAX(5)
      MATCHA_MAX(6)
      MATCHA_MAX(7)
      MATCHA_MAX(8)
#undef MATCHA_MAX
    }
    if (most <= 0) return -2;
    const int tc_tiles = tc_tiles_of(E, L);
    return tc_tiles < most ? tc_tiles : most;
  }
  const int sms = sm_count();
  return tiles < sms ? tiles : sms;
}

// Floats of one scratch slice (and of the packed grads output) for H heads.
extern "C" long long matcha_hyperedge_attention_bwd_slice_floats(int H) {
  return (long long)slice_floats(H);
}

// Plain C interface for ctypes.  Pointers are device pointers; the weights
// and LayerNorm params are f32; x, g and gx are f32 (is_bf16 = 0) or bf16.
// scratch holds n_slices slices and grads one slice (packed gwq, gwk, gwv,
// gfw, gln, gfb), both f32; n_slices comes from
// matcha_hyperedge_attention_bwd_slices.  bf16 with H <= 8 takes the
// tensor-core kernel, everything else the CUDA-core kernel.  Returns the
// CUDA error (0 = ok).
extern "C" int matcha_hyperedge_attention_bwd(const void* x, const void* ln, const void* wq,
                                              const void* wk, const void* wv, const void* fw,
                                              const void* g, void* gx, void* scratch,
                                              void* grads, int E, int L, int H, int diag_mask,
                                              int is_bf16, int n_slices, void* stream) {
  const bool tc = use_tc(is_bf16, H);
  if (E <= 0 || H <= 0 || tiles_of(E, L) < 0 || n_slices <= 0 ||
      n_slices > (tc ? tc_tiles_of(E, L) : tiles_of(E, L)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MATCHA_CASE(LL)                                                                       \
  case LL:                                                                                    \
    if (tc)                                                                                   \
      return (int)launch_tc<LL>(x, ln, wq, wk, wv, fw, g, gx, scratch, grads, E, H, diag_mask, \
                                n_slices, s);                                                 \
    return (int)(is_bf16 ? launch<__nv_bfloat16, LL>(x, ln, wq, wk, wv, fw, g, gx, scratch,   \
                                                     grads, E, H, diag_mask, n_slices, s)     \
                         : launch<float, LL>(x, ln, wq, wk, wv, fw, g, gx, scratch, grads, E, \
                                             H, diag_mask, n_slices, s));
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
