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
// Rounding follows the TPU backward: the LayerNorm outputs, q and k are
// rounded to x's dtype, v stays f32, the attention output that meets g in
// gfw stays f32, gx is rounded once at the store, and every weight and
// LayerNorm grad accumulates in f32.  The scores are f32 products of the
// rounded q and k, as in the forward kernel, so the recomputed softmax is the
// one the forward used.
//
// Bound on this card (H100 SXM, bf16 inputs), per edge of L tokens, with
// hd = H*64: operations 2*L*64*hd*(3 q/k/v + 1 g_attn + 3 back to x + 4
// weight grads) + 12*L*L*hd (scores, a@v, g.v, three attention grads); bytes
// x and g read once, gx written once, f32 weights read and grads written
// once.  At E = 8,192, L = 5: 30.8 GFLOP -> 31 us at 989 TFLOP/s against
// 16.7 MB -> 5 us, so the work is bound by the tensor cores' rate.  This first
// version runs its products as f32 FMAs on the CUDA cores.  Its design:
//   * a persistent grid of at most one block per SM (256 threads); block b
//     walks the tiles b, b + grid, ... of TE edges (R = TE*L <= 40 token
//     rows); the ragged tail is masked, so any E works;
//   * per tile: the three LayerNorms (x-hat and 1/sigma kept) and g go to
//     shared memory; a loop over heads stages the 64x64 slices of wq, wk, wv
//     and fw (row stride 65, so both W and W^T reads are free of bank
//     conflicts), recomputes q_h, k_h, v_h, the scores, the softmax and the
//     attention output, then runs the backward of fc1, of the softmax and of
//     the three projections;
//   * the gradient that reaches the three LayerNorm outputs is folded into
//     one accumulator G = sum_t gamma_t * g_xt per token in registers across
//     the heads (the LayerNorm backward is linear in its input gradient, and
//     all three share x-hat and 1/sigma); after the heads one warp per row
//     turns G into gx;
//   * weight and LayerNorm grads: each block adds its tiles' partials into
//     its own f32 slice of a scratch buffer (no atomics); a second kernel
//     sums the slices in block order.  The result is deterministic: the
//     same bits on every run for one grid size (one card model).
// wgmma and TMA are work for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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

}  // namespace

// Grid size (blocks, each with its own scratch slice) for E edges of size L:
// at most one block per SM.  Returns -1 for an L the kernel does not take.
extern "C" int matcha_hyperedge_attention_bwd_blocks(int E, int L) {
  const int tiles = tiles_of(E, L);
  if (tiles < 0 || E <= 0) return -1;
  const int sms = sm_count();
  return tiles < sms ? tiles : sms;
}

// Floats of one scratch slice (and of the packed grads output) for H heads.
extern "C" long long matcha_hyperedge_attention_bwd_slice_floats(int H) {
  return (long long)slice_floats(H);
}

// Plain C interface for ctypes.  Pointers are device pointers; the weights
// and LayerNorm params are f32; x, g and gx are f32 (is_bf16 = 0) or bf16.
// scratch holds n_blocks slices and grads one slice (packed gwq, gwk, gwv,
// gfw, gln, gfb), both f32; n_blocks comes from
// matcha_hyperedge_attention_bwd_blocks.  Returns the CUDA error (0 = ok).
extern "C" int matcha_hyperedge_attention_bwd(const void* x, const void* ln, const void* wq,
                                              const void* wk, const void* wv, const void* fw,
                                              const void* g, void* gx, void* scratch,
                                              void* grads, int E, int L, int H, int diag_mask,
                                              int is_bf16, int n_blocks, void* stream) {
  if (E <= 0 || H <= 0 || n_blocks <= 0 || n_blocks > tiles_of(E, L))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MATCHA_CASE(LL)                                                                       \
  case LL:                                                                                    \
    return (int)(is_bf16 ? launch<__nv_bfloat16, LL>(x, ln, wq, wk, wv, fw, g, gx, scratch,   \
                                                     grads, E, H, diag_mask, n_blocks, s)     \
                         : launch<float, LL>(x, ln, wq, wk, wv, fw, g, gx, scratch, grads, E, \
                                             H, diag_mask, n_blocks, s));
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
