// Fused classifier tail, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels matcha_tpu/ops/fused_tail.py:_fwd_kernel (through
// _ft_fwd) and _bwd_kernel (through _ft_bwd).  Per token t of the merged
// stream, from the attention output y and the static stream h (T, 64), f32
// or bf16:
//   d0 = round(y * m0)                      dropout 0.3 (train)
//   h1 = tanh(d0 @ w1 + b1)                 f32
//   hd = round(h1 * m1)                     dropout 0.4 (train)
//   o  = round(hd @ w2 + b2 + d0)
//   dyn = round(LN(o; pff_n1)), dynamic = round(LN(dyn; ln_dynamic)),
//   static = round(LN(h; ln_static)),  diff = dynamic - static (f32)
//   pp[t] = sum_c diff^2 * wc + bc          f32
// where round() is the rounding to y's dtype (none in f32), the weights are
// rounded to that dtype as the TPU kernel casts them, and LayerNorm statistics
// and every sum are f32.  The backward recomputes the chain and follows
// _bwd_kernel: gy, gh (T, 64) in y's dtype, and the sums over tokens of the
// param grads gln (6, 64), gw1, gb1, gw2, gb2, gwc, gbc in f32.
//
// Dropout bits of token t, feature c, mask stream s: fmix32(key_s + (t*64 + c)
// * 0x9E3779B9) with the keys computed by the wrapper; top 24 bits -> u in
// [0, 1), keep iff u >= rate, scale 1 / (1 - rate).  The backward regenerates
// exactly the forward's masks, and the plain PyTorch version computes the same
// bits, so kernel and plain version compare in train mode too.
//
// Bound on this card at T = 114,688, bf16: bytes.  Forward: y and h read
// once (29.4 MB), pp written (0.46 MB) -> 8.9 us at 3.35 TB/s (1.9 GFLOP ->
// 1.9 us on the tensor cores).  Backward: y, h, g read, gy, gh written
// (59 MB) -> 17.7 us (5.6 GFLOP -> 5.7 us).
//
// Forward, and the backward's f32 route: one warp works on one token at a
// time, each lane owning features c = lane and lane + 32; w1, w2 (row stride
// 65, so both W and W^T reads are free of bank conflicts), the LayerNorm
// params, b1, b2 and wc sit in shared memory, and the token's vectors stay
// in registers and a per-warp shared row.  The two 64x64 products run as f32
// FMAs from shared memory.  Only pp (forward), or gy, gh and the param-grad
// partials (backward) leave the block.  This backward runs a persistent grid
// over tiles of 32 tokens: each block keeps its own gw1/gw2 entries in
// registers (a thread owns 8 rows x 2 columns of each), adds each tile's
// outer products in token order, sums its per-lane column sums over warps in
// warp order, and writes one f32 scratch slice; a second kernel adds the
// slices in block order.  No float atomics: the same bits on every run for
// one card model.
//
// The backward's bf16 route (fused_tail_bwd_tc_kernel, chosen inside
// matcha_fused_tail_bwd by y's dtype) runs its four products and both
// weight-grad sums on the tensor cores (wgmma, bf16 operands, f32 sums;
// mma_bf16.cuh).  A persistent grid of at most one block per SM; each of a
// block's two warpgroups walks tiles of 64 tokens of its own, the next
// tile's y and h prefetched with cp.async.  A thread holds its two tokens'
// values in the wgmma accumulator layout (rows 16q + fg (+ 8), columns 8j +
// 2fc (+ 1)), so a token's 64 features lie in one quad and its LayerNorm
// sums take two shuffles, and an accumulator rounded to bf16 is the next
// product's A operand without a trip through shared memory.  Per tile: d0
// w1 and hd w2 (the forward again), tanh and the three LayerNorms, their
// backward, g_o w2^T and g_a1 w1^T (the weights read transposed through the
// descriptors), then gw1 += d0^T g_a1 and gw2 += hd^T g_o from tiles staged
// in shared memory (A read transposed with ldmatrix.trans).  gw1 and gw2
// stay in f32 registers across all of a warpgroup's tiles; the column sums
// (gln's rows, gb1, gb2, gwc) are folded over a warp's 16 rows by a fixed
// shuffle tree each tile and kept two columns per lane.  gy and gh leave
// through row-major swizzled tiles, eight lanes storing one whole 128-byte
// row.  Each block
// writes one scratch slice of the same layout, and reduce_slices_kernel adds
// the slices in block order.  Operands are rounded where the f32 route
// rounds them (w1, w2, d0, hd, g_o, g_a1), so only the order of the f32 sums
// differs; the masks come from the same hash at the same indices.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int D = 64;
constexpr int WS = D + 1;     // shared row stride of w1 and w2
constexpr int NT = 256;       // threads per block
constexpr int NWARP = NT / 32;
constexpr int TPW = 4;        // tokens per warp per backward tile
constexpr int TILE = NWARP * TPW;
constexpr int NCOL = 9;       // column sums: gln rows 0-5, gb1, gb2, gwc
constexpr int NCS = NCOL * D + 1;                 // ... and gbc
constexpr int SLICE = 2 * D * D + NCS;            // floats per block slice
constexpr int PARAM_FLOATS = 2 * D * WS + 6 * D + 3 * D;
constexpr int FWD_SMEM = (PARAM_FLOATS + NWARP * D) * 4;
constexpr int BWD_SMEM = (PARAM_FLOATS + NWARP * D + 4 * TILE * D) * 4;
static_assert(4 * TILE * D >= NWARP * NCS, "column-sum staging must fit the tiles");

struct Args {
  const void* y;
  const void* h;
  const float* ln6;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  const float* wc;
  const float* bc;
  int T;
  uint32_t key0, key1;
  int use_m0, use_m1;
  float r0, r1, s0, s1;
};

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float rnd(float v, const float*) { return v; }
__device__ __forceinline__ float rnd(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same bits (IEEE addition commutes)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ float keep(uint32_t key, uint32_t idx, float rate, float scale) {
  const uint32_t bits = fmix32(key + idx * 0x9E3779B9u);
  const float u = (float)(bits >> 8) * (1.0f / 16777216.0f);
  return u >= rate ? scale : 0.0f;
}

struct Smem {
  float* w1;  // [D][WS], rounded to y's dtype
  float* w2;
  float* ln;  // [6][D]
  float* b1;
  float* b2;
  float* wc;
  float* vb;  // [NWARP][D] per-warp vector row
};

template <typename T>
__device__ Smem load_params(const Args& a, float* sm) {
  Smem s;
  s.w1 = sm;
  s.w2 = s.w1 + D * WS;
  s.ln = s.w2 + D * WS;
  s.b1 = s.ln + 6 * D;
  s.b2 = s.b1 + D;
  s.wc = s.b2 + D;
  s.vb = s.wc + D;
  const T* tag = nullptr;
  for (int i = threadIdx.x; i < D * D; i += NT) {
    const int j = i / D, c = i % D;
    s.w1[j * WS + c] = rnd(a.w1[i], tag);
    s.w2[j * WS + c] = rnd(a.w2[i], tag);
  }
  for (int i = threadIdx.x; i < 6 * D; i += NT) s.ln[i] = a.ln6[i];
  for (int i = threadIdx.x; i < D; i += NT) {
    s.b1[i] = a.b1[i];
    s.b2[i] = a.b2[i];
    s.wc[i] = a.wc[i];
  }
  return s;
}

// LayerNorm of the warp's token (two features per lane): xhat, 1/sigma and the
// output rounded to T
template <typename T>
__device__ __forceinline__ void ln_fwd(const float* x, const float* g, const float* b,
                                       int lane, float* xh, float& inv, float* out) {
  const T* tag = nullptr;
  const float mu = warp_sum(x[0] + x[1]) * (1.0f / D);
  const float e0 = x[0] - mu, e1 = x[1] - mu;
  const float var = warp_sum(e0 * e0 + e1 * e1) * (1.0f / D);
  inv = rsqrtf(var + 1e-5f);
  xh[0] = e0 * inv;
  xh[1] = e1 * inv;
  out[0] = rnd(xh[0] * g[lane] + b[lane], tag);
  out[1] = rnd(xh[1] * g[lane + 32] + b[lane + 32], tag);
}

// LayerNorm backward: g_x = inv * (gx - mean(gx) - xhat * mean(gx * xhat)),
// gx = g_out * gamma
__device__ __forceinline__ void ln_bwd(const float* go, const float* xh, float inv,
                                       const float* gam, int lane, float* gx_out) {
  const float gx0 = go[0] * gam[lane], gx1 = go[1] * gam[lane + 32];
  const float m1 = warp_sum(gx0 + gx1) * (1.0f / D);
  const float m2 = warp_sum(gx0 * xh[0] + gx1 * xh[1]) * (1.0f / D);
  gx_out[0] = inv * (gx0 - m1 - xh[0] * m2);
  gx_out[1] = inv * (gx1 - m1 - xh[1] * m2);
}

// out[c] = sum_j v[j] * W[j][c] for c = lane, lane + 32 (v in the warp's row)
__device__ __forceinline__ void vec_mat(const float* v, const float* W, int lane, float* out) {
  float a0 = 0.f, a1 = 0.f;
#pragma unroll 16
  for (int j = 0; j < D; ++j) {
    const float x = v[j];
    a0 = fmaf(x, W[j * WS + lane], a0);
    a1 = fmaf(x, W[j * WS + lane + 32], a1);
  }
  out[0] = a0;
  out[1] = a1;
}

// out[j] = sum_c v[c] * W[j][c] for j = lane, lane + 32
__device__ __forceinline__ void vec_mat_t(const float* v, const float* W, int lane, float* out) {
  float a0 = 0.f, a1 = 0.f;
#pragma unroll 16
  for (int c = 0; c < D; ++c) {
    const float x = v[c];
    a0 = fmaf(x, W[lane * WS + c], a0);
    a1 = fmaf(x, W[(lane + 32) * WS + c], a1);
  }
  out[0] = a0;
  out[1] = a1;
}

// puts the warp's vector (two values per lane) in its shared row
__device__ __forceinline__ void to_row(float* vb, int lane, float v0, float v1) {
  __syncwarp();
  vb[lane] = v0;
  vb[lane + 32] = v1;
  __syncwarp();
}

struct Tok {
  float d0[2], m0[2], h1[2], m1[2], hd[2], xo[2], xd[2], xs[2], diff[2];
  float inv_o, inv_d, inv_s;
};

// the forward chain of token t for the calling warp
template <typename T>
__device__ __forceinline__ void token_fwd(const Args& a, const Smem& s, float* vb, int t,
                                          int lane, Tok& k) {
  const T* y = static_cast<const T*>(a.y);
  const T* h = static_cast<const T*>(a.h);
  const T* tag = nullptr;
  float hv[2], acc[2], o[2], dyn[2], dn[2], stat[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const size_t i = (size_t)t * D + lane + 32 * q;
    const float yv = ld(y, i);
    hv[q] = ld(h, i);
    k.m0[q] = a.use_m0 ? keep(a.key0, (uint32_t)i, a.r0, a.s0) : 1.0f;
    k.d0[q] = a.use_m0 ? rnd(yv * k.m0[q], tag) : yv;
  }
  to_row(vb, lane, k.d0[0], k.d0[1]);
  vec_mat(vb, s.w1, lane, acc);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int c = lane + 32 * q;
    k.h1[q] = tanhf(acc[q] + s.b1[c]);
    k.m1[q] = a.use_m1 ? keep(a.key1, (uint32_t)((size_t)t * D + c), a.r1, a.s1) : 1.0f;
    k.hd[q] = rnd(a.use_m1 ? k.h1[q] * k.m1[q] : k.h1[q], tag);
  }
  to_row(vb, lane, k.hd[0], k.hd[1]);
  vec_mat(vb, s.w2, lane, acc);
#pragma unroll
  for (int q = 0; q < 2; ++q) o[q] = rnd((acc[q] + s.b2[lane + 32 * q]) + k.d0[q], tag);
  ln_fwd<T>(o, s.ln, s.ln + D, lane, k.xo, k.inv_o, dyn);
  ln_fwd<T>(dyn, s.ln + 2 * D, s.ln + 3 * D, lane, k.xd, k.inv_d, dn);
  ln_fwd<T>(hv, s.ln + 4 * D, s.ln + 5 * D, lane, k.xs, k.inv_s, stat);
  k.diff[0] = dn[0] - stat[0];
  k.diff[1] = dn[1] - stat[1];
}

template <typename T>
__global__ void __launch_bounds__(NT) fused_tail_fwd_kernel(Args a, float* __restrict__ pp) {
  extern __shared__ float sm[];
  const Smem s = load_params<T>(a, sm);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* vb = s.vb + warp * D;
  const float bc = a.bc[0];
  for (int t = blockIdx.x * NWARP + warp; t < a.T; t += gridDim.x * NWARP) {
    Tok k;
    token_fwd<T>(a, s, vb, t, lane, k);
    const float part = warp_sum(k.diff[0] * k.diff[0] * s.wc[lane] +
                                k.diff[1] * k.diff[1] * s.wc[lane + 32]);
    if (lane == 0) pp[t] = part + bc;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
    fused_tail_bwd_kernel(Args a, const float* __restrict__ g, T* __restrict__ gy,
                          T* __restrict__ gh, float* __restrict__ scratch) {
  extern __shared__ float sm[];
  const Smem s = load_params<T>(a, sm);
  float* tiles = s.vb + NWARP * D;  // [4][TILE][D]: d0, g_a1 (rounded), hd, g_o (rounded)
  float* t_d0 = tiles;
  float* t_ga1 = t_d0 + TILE * D;
  float* t_hd = t_ga1 + TILE * D;
  float* t_go = t_hd + TILE * D;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* vb = s.vb + warp * D;
  const T* tag = nullptr;

  float acc1[8][2], acc2[8][2];  // gw1 / gw2 entries (warp + 8i, lane + 32q)
  float col[NCOL][2];
  float gbc = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc1[i][0] = acc1[i][1] = acc2[i][0] = acc2[i][1] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < NCOL; ++r) col[r][0] = col[r][1] = 0.f;

  const int n_tiles = (a.T + TILE - 1) / TILE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    for (int sl = 0; sl < TPW; ++sl) {
      const int slot = warp * TPW + sl;
      const int t = tile * TILE + slot;
      float* r_d0 = t_d0 + slot * D;
      float* r_ga1 = t_ga1 + slot * D;
      float* r_hd = t_hd + slot * D;
      float* r_go = t_go + slot * D;
      if (t >= a.T) {  // ragged edge: the slot adds nothing
        r_d0[lane] = r_d0[lane + 32] = r_ga1[lane] = r_ga1[lane + 32] = 0.f;
        r_hd[lane] = r_hd[lane + 32] = r_go[lane] = r_go[lane + 32] = 0.f;
        continue;
      }
      Tok k;
      token_fwd<T>(a, s, vb, t, lane, k);
      const float gt = g[t];
      gbc += gt;
      float g_diff[2], ng[2], g_dyn[2], g_h[2], g_o[2], g_o_dt[2], g_hd[2];
      float g_a1[2], g_a1_dt[2], g_d0[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = lane + 32 * q;
        col[8][q] += rnd(k.diff[q] * k.diff[q], tag) * gt;  // gwc
        g_diff[q] = 2.0f * k.diff[q] * (gt * s.wc[c]);
        ng[q] = -g_diff[q];
      }
      ln_bwd(g_diff, k.xd, k.inv_d, s.ln + 2 * D, lane, g_dyn);
      ln_bwd(ng, k.xs, k.inv_s, s.ln + 4 * D, lane, g_h);
      ln_bwd(g_dyn, k.xo, k.inv_o, s.ln, lane, g_o);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        col[0][q] += g_dyn[q] * k.xo[q];
        col[1][q] += g_dyn[q];
        col[2][q] += g_diff[q] * k.xd[q];
        col[3][q] += g_diff[q];
        col[4][q] += ng[q] * k.xs[q];
        col[5][q] += ng[q];
        col[7][q] += g_o[q];  // gb2
        g_o_dt[q] = rnd(g_o[q], tag);
      }
      to_row(vb, lane, g_o_dt[0], g_o_dt[1]);
      vec_mat_t(vb, s.w2, lane, g_hd);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float g_h1 = a.use_m1 ? g_hd[q] * k.m1[q] : g_hd[q];
        g_a1[q] = g_h1 * (1.0f - k.h1[q] * k.h1[q]);
        col[6][q] += g_a1[q];  // gb1
        g_a1_dt[q] = rnd(g_a1[q], tag);
      }
      to_row(vb, lane, g_a1_dt[0], g_a1_dt[1]);
      vec_mat_t(vb, s.w1, lane, g_d0);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = lane + 32 * q;
        const size_t i = (size_t)t * D + c;
        const float gd = g_d0[q] + g_o[q];  // residual
        st(gy, i, a.use_m0 ? gd * k.m0[q] : gd);
        st(gh, i, g_h[q]);
        r_d0[c] = k.d0[q];
        r_ga1[c] = g_a1_dt[q];
        r_hd[c] = k.hd[q];
        r_go[c] = g_o_dt[q];
      }
    }
    __syncthreads();
    // the tile's outer products, in token order: gw1 += d0^T g_a1, gw2 += hd^T g_o
    for (int tok = 0; tok < TILE; ++tok) {
      const float* r_d0 = t_d0 + tok * D;
      const float* r_hd = t_hd + tok * D;
      const float ga0 = t_ga1[tok * D + lane], ga1 = t_ga1[tok * D + lane + 32];
      const float go0 = t_go[tok * D + lane], go1 = t_go[tok * D + lane + 32];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dj = r_d0[warp + 8 * i], hj = r_hd[warp + 8 * i];
        acc1[i][0] = fmaf(dj, ga0, acc1[i][0]);
        acc1[i][1] = fmaf(dj, ga1, acc1[i][1]);
        acc2[i][0] = fmaf(hj, go0, acc2[i][0]);
        acc2[i][1] = fmaf(hj, go1, acc2[i][1]);
      }
    }
    __syncthreads();
  }

  float* slice = scratch + (size_t)blockIdx.x * SLICE;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = (warp + 8 * i) * D + lane + 32 * q;
      slice[e] = acc1[i][q];
      slice[D * D + e] = acc2[i][q];
    }
  }
  // column sums: per-warp copies staged in the tile buffers, summed in warp order
  float* cs = tiles;  // [NWARP][NCS]
#pragma unroll
  for (int r = 0; r < NCOL; ++r) {
    cs[warp * NCS + r * D + lane] = col[r][0];
    cs[warp * NCS + r * D + lane + 32] = col[r][1];
  }
  if (lane == 0) cs[warp * NCS + NCOL * D] = gbc;
  __syncthreads();
  for (int e = threadIdx.x; e < NCS; e += NT) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) sum += cs[w * NCS + e];
    slice[2 * D * D + e] = sum;
  }
}

__global__ void __launch_bounds__(NT)
    reduce_slices_kernel(const float* __restrict__ scratch, float* __restrict__ out,
                         int n_blocks) {
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= SLICE) return;
  float sum = 0.f;
  for (int b = 0; b < n_blocks; ++b) sum += scratch[(size_t)b * SLICE + e];
  out[e] = sum;
}

// ------------------------------------------ the backward's tensor-core route
// (design in the note at the top of this file)

constexpr int TC_ROWS = 64;  // tokens per warpgroup tile
constexpr int TILE_ELEMS = mma_bf16::TILE;
// bf16 tiles in mma_bf16's blocked layout: w1 and w2 for the block, then per
// warpgroup y and h (two buffers each) and the staged d0, hd, g_a1, g_o
enum { B_W1, B_W2, N_BT };
enum { P_Y, P_H = 2, P_D0 = 4, P_HD, P_GA1, P_GO, N_PT };
constexpr int TC_TILES = N_BT + 2 * N_PT;
// f32: ln6, b1, b2, wc, then per warpgroup 1 - h1^2 ([32 entries][128
// threads], each thread reading back its own)
constexpr int TC_PARAMS = 6 * D + 3 * D;
constexpr int TC_F32 = TC_PARAMS + 2 * 32 * 128;
constexpr int TC_BWD_SMEM = TC_TILES * TILE_ELEMS * 2 + TC_F32 * 4;
static_assert(TC_BWD_SMEM <= 232448, "shared memory of one block");
static_assert(N_PT * TILE_ELEMS * 2 >= 2 * D * D * 4, "gw staging must fit a warpgroup's tiles");
static_assert(N_PT * TILE_ELEMS * 2 >= NWARP * NCS * 4, "column-sum staging must fit");

// This thread's 32 entries of a 64 x 64 tile in the accumulator layout:
// v[4j + 2hh + u] = tile[16q + fg + 8hh][8j + 2fc + u]; rows at or past
// `valid` read as zeros.
__device__ __forceinline__ void tile_to_acc(const __nv_bfloat16* t, int q, int fg, int fc,
                                            int valid, float (&v)[32]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * q + fg + 8 * hh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 f = make_float2(0.f, 0.f);
      if (r < valid)
        f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(t + mma_bf16::blk(r, 8 * j + 2 * fc)));
      v[4 * j + 2 * hh] = f.x;
      v[4 * j + 2 * hh + 1] = f.y;
    }
  }
}

// The accumulator-layout entries, rounded to bf16, into a row-major 64 x 64
// tile whose 16-byte chunks are swizzled by the row (chunk ^ row % 8), so
// that both these stores and rows_out's reads are free of bank conflicts.
__device__ __forceinline__ void acc_to_rows(const float (&v)[32], __nv_bfloat16* t, int q, int fg,
                                            int fc) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * q + fg + 8 * hh;
      *reinterpret_cast<__nv_bfloat162*>(t + r * D + 8 * (j ^ (r & 7)) + 2 * fc) =
          __floats2bfloat162_rn(v[4 * j + 2 * hh], v[4 * j + 2 * hh + 1]);
    }
}

// this warp's 16 rows of such a tile to out (row t0 + r), whole 128-byte
// rows per eight lanes; rows at or past `valid` are not written
__device__ __forceinline__ void rows_out(const __nv_bfloat16* t, __nv_bfloat16* out, size_t t0,
                                         int q, int lane, int valid) {
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * (D / 8); i += 32) {
    const int r = 16 * q + i / (D / 8), c = i % (D / 8);
    if (r < valid)
      *reinterpret_cast<uint4*>(out + (t0 + r) * D + 8 * c) =
          *reinterpret_cast<const uint4*>(t + r * D + 8 * (c ^ (r & 7)));
  }
}

// row (0 or 1) and column of the thread's entry k = 4j + 2hh + u
__device__ __forceinline__ int row_of(int k) { return (k >> 1) & 1; }
__device__ __forceinline__ int col_of(int k, int fc) { return 8 * (k >> 2) + 2 * fc + (k & 1); }

// Each row's sum: p[hh][j] holds the thread's pair of entries j of row hh;
// a pairwise tree over j (short dependency chains), then the quad's two
// shuffles (the quad holds a row's 64 columns).
__device__ __forceinline__ void row_sums(float (&p)[2][8], float (&s)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) p[hh][j] += p[hh][j + w];
    s[hh] = p[hh][0];
    s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 1);
    s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 2);
  }
}

// LayerNorm statistics of the thread's two rows (f32): mean and 1/sigma
__device__ __forceinline__ void ln_stats(const float (&x)[32], float (&mu)[2], float (&inv)[2]) {
  float p[2][8], s[2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) p[hh][j] = x[4 * j + 2 * hh] + x[4 * j + 2 * hh + 1];
  row_sums(p, s);
  mu[0] = s[0] * (1.0f / D);
  mu[1] = s[1] * (1.0f / D);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float e0 = x[4 * j + 2 * hh] - mu[hh], e1 = x[4 * j + 2 * hh + 1] - mu[hh];
      p[hh][j] = e0 * e0 + e1 * e1;
    }
  row_sums(p, s);
  inv[0] = rsqrtf(s[0] * (1.0f / D) + 1e-5f);
  inv[1] = rsqrtf(s[1] * (1.0f / D) + 1e-5f);
}

// in place: x -> xhat = (x - mu) * inv
__device__ __forceinline__ void normalize(float (&x)[32], const float (&mu)[2],
                                          const float (&inv)[2]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) x[k] = (x[k] - mu[row_of(k)]) * inv[row_of(k)];
}

// in place: xhat -> round(xhat * g + b) to bf16
__device__ __forceinline__ void affine_bf16(float (&x)[32], const float* g, const float* b,
                                            int fc) {
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int c = col_of(k, fc);
    x[k] = __bfloat162float(__float2bfloat16_rn(x[k] * g[c] + b[c]));
  }
}

// LayerNorm backward of the two rows, in place on go: g_x = inv * (gx -
// mean(gx) - xhat * mean(gx * xhat)), gx = go * gamma
__device__ __forceinline__ void ln_bwd_rows(float (&go)[32], const float (&xh)[32],
                                            const float (&inv)[2], const float* gam, int fc) {
  float p1[2][8], p2[2][8], m1[2], m2[2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int k = 4 * j + 2 * hh;
      const float g0 = go[k] * gam[col_of(k, fc)], g1 = go[k + 1] * gam[col_of(k + 1, fc)];
      p1[hh][j] = g0 + g1;
      p2[hh][j] = g0 * xh[k] + g1 * xh[k + 1];
    }
  row_sums(p1, m1);
  row_sums(p2, m2);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int hh = row_of(k);
    const float gx = go[k] * gam[col_of(k, fc)];
    go[k] = inv[hh] * (gx - m1[hh] * (1.0f / D) - xh[k] * (m2[hh] * (1.0f / D)));
  }
}

// one level of col_sums' tree: the lanes HALF / 2 quads apart swap halves
// of s[0 .. 2 HALF), each keeping the sum of one half (the widths are
// template constants, so s stays in registers)
template <int HALF>
__device__ __forceinline__ void fold(float (&s)[16], bool upper) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? s[i] : s[i + HALF];
    const float keep = upper ? s[i + HALF] : s[i];
    s[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * HALF);
  }
}

// Column sums over the warp's 16 rows of v (PROD: of v * w, NEG: negated):
// the two rows added, then a fixed shuffle tree that halves the columns a
// lane carries at each level; lane (fg, fc) ends with columns 8fg + 2fc +
// {0, 1}.
template <bool PROD, bool NEG = false>
__device__ __forceinline__ float2 col_sums(const float (&v)[32], const float (&w)[32]) {
  const int fg = (threadIdx.x & 31) >> 2;
  float s[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k0 = 4 * j + u, k1 = k0 + 2;
      const float a0 = NEG ? -v[k0] : v[k0], a1 = NEG ? -v[k1] : v[k1];
      s[2 * j + u] = PROD ? a0 * w[k0] + a1 * w[k1] : a0 + a1;
    }
  fold<8>(s, fg & 4);
  fold<4>(s, fg & 2);
  fold<2>(s, fg & 1);
  return make_float2(s[0], s[1]);
}

__device__ __forceinline__ void add2(float2& a, float2 b) {
  a.x += b.x;
  a.y += b.y;
}

__global__ void __launch_bounds__(NT, 1)
    fused_tail_bwd_tc_kernel(Args a, const float* __restrict__ g, __nv_bfloat16* __restrict__ gy,
                             __nv_bfloat16* __restrict__ gh, float* __restrict__ scratch) {
  using mma_bf16::acc_to_a;
  using mma_bf16::async_fence;
  using mma_bf16::blk;
  using mma_bf16::store_bf16;
  using mma_bf16::wg_issue_a;
  using mma_bf16::wg_sync;
  using mma_bf16::wg_wait;
  using bf16 = __nv_bfloat16;
  using bf162 = __nv_bfloat162;
  extern __shared__ float4 smem4[];
  bf16* tiles = reinterpret_cast<bf16*>(smem4);
  float* ln6 = reinterpret_cast<float*>(tiles + TC_TILES * TILE_ELEMS);
  float* b1 = ln6 + 6 * D;
  float* b2 = b1 + D;
  float* wc = b2 + D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = warp & 3, grp = warp >> 2, fg = lane >> 2, fc = lane & 3;
  float* dts = wc + D + grp * 32 * 128 + (tid & 127);  // this thread's 1 - h1^2, stride 128
  bf16* mine = tiles + (N_BT + grp * N_PT) * TILE_ELEMS;
  auto wt = [&](int i) { return tiles + i * TILE_ELEMS; };
  auto pt = [&](int i) { return mine + i * TILE_ELEMS; };
  const bf16* y = static_cast<const bf16*>(a.y);
  const bf16* h = static_cast<const bf16*>(a.h);

  // w1 and w2 as bf16 tiles W[k][n], read as W (B_KN) and as W^T
  for (int i = tid; i < 2 * D * (D / 4); i += NT) {
    const int mat = i / (D * D / 4), rem = i % (D * D / 4);
    const int row = rem / (D / 4), col = (rem % (D / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>((mat ? a.w2 : a.w1) + row * D + col);
    bf162* dst = reinterpret_cast<bf162*>(wt(B_W1 + mat) + blk(row, col));
    dst[0] = __floats2bfloat162_rn(v.x, v.y);
    dst[1] = __floats2bfloat162_rn(v.z, v.w);
  }
  for (int i = tid; i < 6 * D; i += NT) ln6[i] = a.ln6[i];
  for (int i = tid; i < D; i += NT) {
    b1[i] = a.b1[i];
    b2[i] = a.b2[i];
    wc[i] = a.wc[i];
  }
  async_fence();
  __syncthreads();

  const int n_tiles = (a.T + TC_ROWS - 1) / TC_ROWS;
  const int n_wg = 2 * gridDim.x, w = 2 * blockIdx.x + grp;
  // this warp's 16 rows of y and h of tile ti into buffer b, with cp.async
  auto prefetch = [&](int ti, int b) {
    const size_t t0 = (size_t)ti * TC_ROWS;
    for (int i = lane; i < 2 * 16 * (D / 8); i += 32) {
      const int which = i / (16 * (D / 8)), r = 16 * q + (i / (D / 8)) % 16;
      const int c = 8 * (i % (D / 8));
      if (t0 + r < (size_t)a.T)
        mma_bf16::cp_async16(pt((which ? P_H : P_Y) + b) + blk(r, c),
                             (which ? h : y) + (t0 + r) * D + c);
    }
    mma_bf16::cp_async_commit();
  };

  float gw1[32], gw2[32];  // this warpgroup's gw1 / gw2 over all its tiles
#pragma unroll
  for (int i = 0; i < 32; ++i) gw1[i] = gw2[i] = 0.f;
  // column sums, columns 8fg + 2fc + {0, 1}: gln rows 0-5, gb1, gb2, gwc
  // (row 5, the sum of -g_diff, is row 3 negated at the end: exact)
  float2 col[NCOL];
#pragma unroll
  for (int r = 0; r < NCOL; ++r) col[r] = make_float2(0.f, 0.f);
  float gbc = 0.f;

  if (w < n_tiles) prefetch(w, 0);
  int buf = 0;
  for (int ti = w; ti < n_tiles; ti += n_wg, buf ^= 1) {
    const size_t t0 = (size_t)ti * TC_ROWS;
    const int valid = a.T - t0 < (size_t)TC_ROWS ? (int)(a.T - t0) : TC_ROWS;
    mma_bf16::cp_async_wait_all();
    // the copy is visible, and every warp of the group is done with the
    // last tile's staged d0, hd, g_a1 and g_o (overwritten below)
    wg_sync(grp);
    if (ti + n_wg < n_tiles) prefetch(ti + n_wg, buf ^ 1);

    // masks of this thread's entries, one bit each
    uint32_t keep0 = 0u, keep1 = 0u;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const uint32_t idx = (uint32_t)((t0 + 16 * q + fg + 8 * ((k >> 1) & 1)) * D + col_of(k, fc));
      if (!a.use_m0 || keep(a.key0, idx, a.r0, 1.f) != 0.f) keep0 |= 1u << k;
      if (!a.use_m1 || keep(a.key1, idx, a.r1, 1.f) != 0.f) keep1 |= 1u << k;
    }
    auto m0 = [&](int k) { return (keep0 >> k) & 1u ? a.s0 : 0.f; };
    auto m1 = [&](int k) { return (keep1 >> k) & 1u ? a.s1 : 0.f; };

    // 1. d0 = round(y * m0), staged for gw1 and kept as A fragments
    uint32_t fa[4][4];
    {
      float d0[32];
      tile_to_acc(pt(P_Y + buf), q, fg, fc, valid, d0);
      if (a.use_m0) {
#pragma unroll
        for (int k = 0; k < 32; ++k) d0[k] = __bfloat162float(__float2bfloat16_rn(d0[k] * m0(k)));
      }
      store_bf16(d0, pt(P_D0), q, fg, fc);
      acc_to_a(d0, fa);
    }
    // 2. h1 = tanh(d0 w1 + b1), hd = round(h1 * m1); 1 - h1^2 kept in
    //    shared memory until step 5
    {
      float acc[32];
      wg_issue_a<true, 64>(acc, fa, wt(B_W1), 0, false);
      wg_wait(acc);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const float h1 = tanhf(acc[k] + b1[col_of(k, fc)]);
        dts[k * 128] = 1.0f - h1 * h1;
        acc[k] = __bfloat162float(__float2bfloat16_rn(a.use_m1 ? h1 * m1(k) : h1));
      }
      store_bf16(acc, pt(P_HD), q, fg, fc);
      acc_to_a(acc, fa);
    }
    // 3. o = round(hd w2 + b2 + d0), then the three LayerNorms (statistics
    //    kept; o and dyn, exact in bf16, parked in the g_o and g_a1 tiles
    //    until their xhat is needed again) and diff = dynamic - static.
    //    Every tile access here is to this thread's own entries.
    float gd[32];  // diff, then g_diff, then g_dyn, then g_o
    float mu_o[2], inv_o[2], mu_d[2], inv_d[2], mu_s[2], inv_s[2], gt[2];
    {
      float o[32];
      {
        float d0[32];
        wg_issue_a<true, 64>(o, fa, wt(B_W2), 0, false);
        tile_to_acc(pt(P_D0), q, fg, fc, TC_ROWS, d0);
        wg_wait(o);
#pragma unroll
        for (int k = 0; k < 32; ++k)
          o[k] = __bfloat162float(__float2bfloat16_rn((o[k] + b2[col_of(k, fc)]) + d0[k]));
      }
      store_bf16(o, pt(P_GO), q, fg, fc);
      ln_stats(o, mu_o, inv_o);
      normalize(o, mu_o, inv_o);
      affine_bf16(o, ln6, ln6 + D, fc);  // o <- dyn
      store_bf16(o, pt(P_GA1), q, fg, fc);
      ln_stats(o, mu_d, inv_d);
      normalize(o, mu_d, inv_d);
      affine_bf16(o, ln6 + 2 * D, ln6 + 3 * D, fc);  // o <- dynamic
      tile_to_acc(pt(P_H + buf), q, fg, fc, valid, gd);
      ln_stats(gd, mu_s, inv_s);
      normalize(gd, mu_s, inv_s);
      affine_bf16(gd, ln6 + 4 * D, ln6 + 5 * D, fc);  // static
#pragma unroll
      for (int k = 0; k < 32; ++k) gd[k] = o[k] - gd[k];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * q + fg + 8 * hh;
      gt[hh] = r < valid ? g[t0 + r] : 0.f;
      if (fc == 0) gbc += gt[hh];
    }
    // 4. the backward of the LayerNorms: gwc, g_diff; g_h from -g_diff;
    //    g_dyn; g_o; and their column sums
    {
      float v[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const float gk = gt[row_of(k)];
        v[k] = __bfloat162float(__float2bfloat16_rn(gd[k] * gd[k])) * gk;
        gd[k] = 2.0f * gd[k] * (gk * wc[col_of(k, fc)]);
      }
      add2(col[8], col_sums<false>(v, v));
      tile_to_acc(pt(P_H + buf), q, fg, fc, valid, v);
      normalize(v, mu_s, inv_s);  // xs
      add2(col[4], col_sums<true, true>(gd, v));
      float ng[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) ng[k] = -gd[k];
      ln_bwd_rows(ng, v, inv_s, ln6 + 4 * D, fc);  // g_h
      // out through y's buffer (y's last read was step 1)
      acc_to_rows(ng, pt(P_Y + buf), q, fg, fc);
      rows_out(pt(P_Y + buf), gh, t0, q, lane, valid);
      tile_to_acc(pt(P_GA1), q, fg, fc, TC_ROWS, v);
      normalize(v, mu_d, inv_d);  // xd
      add2(col[2], col_sums<true>(gd, v));
      add2(col[3], col_sums<false>(gd, gd));
      ln_bwd_rows(gd, v, inv_d, ln6 + 2 * D, fc);  // g_dyn
      tile_to_acc(pt(P_GO), q, fg, fc, TC_ROWS, v);
      normalize(v, mu_o, inv_o);  // xo
      add2(col[0], col_sums<true>(gd, v));
      add2(col[1], col_sums<false>(gd, gd));
      ln_bwd_rows(gd, v, inv_o, ln6, fc);  // g_o
      add2(col[7], col_sums<false>(gd, gd));
    }
    float (&go)[32] = gd;
    store_bf16(go, pt(P_GO), q, fg, fc);
    acc_to_a(go, fa);
    // 5. g_a1 = (g_o w2^T) * m1 * (1 - h1^2)
    {
      float acc[32];
      wg_issue_a<false, 64>(acc, fa, wt(B_W2), 0, false);
      wg_wait(acc);
#pragma unroll
      for (int k = 0; k < 32; ++k)
        acc[k] = (a.use_m1 ? acc[k] * m1(k) : acc[k]) * dts[k * 128];
      add2(col[6], col_sums<false>(acc, acc));
      store_bf16(acc, pt(P_GA1), q, fg, fc);
      acc_to_a(acc, fa);
    }
    // 6. gy = (g_a1 w1^T + g_o) * m0, out through h's buffer (h's last
    //    read was step 4)
    {
      float acc[32];
      wg_issue_a<false, 64>(acc, fa, wt(B_W1), 0, false);
      wg_wait(acc);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const float gd = acc[k] + go[k];
        acc[k] = a.use_m0 ? gd * m0(k) : gd;
      }
      acc_to_rows(acc, pt(P_H + buf), q, fg, fc);
      rows_out(pt(P_H + buf), gy, t0, q, lane, valid);
    }
    // 7. gw1 += d0^T g_a1, gw2 += hd^T g_o, in tile order (rows past T
    //    are zero in g_a1 and g_o)
    async_fence();
    wg_sync(grp);
    mma_bf16::wg_gemm2<true, true, true, true>(gw1, pt(P_D0), pt(P_GA1), gw2, pt(P_HD),
                                               pt(P_GO), true, q, lane);
  }

  // the block's slice: gw1 / gw2 of warpgroup 0 plus warpgroup 1's, the
  // column sums and gbc over the warps in warp order
  __syncthreads();
  col[5] = make_float2(-col[3].x, -col[3].y);
  float* sgw = reinterpret_cast<float*>(tiles + (N_BT + N_PT) * TILE_ELEMS);  // [2][64][64]
  float* scs = reinterpret_cast<float*>(tiles + N_BT * TILE_ELEMS);           // [NWARP][NCS]
  if (grp == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = (16 * q + fg + 8 * hh) * D + 8 * j + 2 * fc;
        *reinterpret_cast<float2*>(sgw + e) = make_float2(gw1[4 * j + 2 * hh], gw1[4 * j + 2 * hh + 1]);
        *reinterpret_cast<float2*>(sgw + D * D + e) =
            make_float2(gw2[4 * j + 2 * hh], gw2[4 * j + 2 * hh + 1]);
      }
  }
#pragma unroll
  for (int r = 0; r < NCOL; ++r) {
    scs[warp * NCS + r * D + 8 * fg + 2 * fc] = col[r].x;
    scs[warp * NCS + r * D + 8 * fg + 2 * fc + 1] = col[r].y;
  }
  gbc = warp_sum(gbc);
  if (lane == 0) scs[warp * NCS + NCOL * D] = gbc;
  __syncthreads();
  float* slice = scratch + (size_t)blockIdx.x * SLICE;
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int k = 4 * j + 2 * hh + u;
          const int e = (16 * q + fg + 8 * hh) * D + 8 * j + 2 * fc + u;
          slice[e] = gw1[k] + sgw[e];
          slice[D * D + e] = gw2[k] + sgw[D * D + e];
        }
  }
  for (int e = tid; e < NCS; e += NT) {
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < NWARP; ++wi) sum += scs[wi * NCS + e];
    slice[2 * D * D + e] = sum;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms > 0 ? sms : 132;
}

Args make_args(const void* y, const void* h, const void* ln6, const void* w1, const void* b1,
               const void* w2, const void* b2, const void* wc, const void* bc, int T,
               uint32_t key0, uint32_t key1, int use_m0, int use_m1, float r0, float r1,
               float s0, float s1) {
  Args a;
  a.y = y;
  a.h = h;
  a.ln6 = static_cast<const float*>(ln6);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.wc = static_cast<const float*>(wc);
  a.bc = static_cast<const float*>(bc);
  a.T = T;
  a.key0 = key0;
  a.key1 = key1;
  a.use_m0 = use_m0;
  a.use_m1 = use_m1;
  a.r0 = r0;
  a.r1 = r1;
  a.s0 = s0;
  a.s1 = s1;
  return a;
}

}  // namespace

// y, h (T, 64) f32 (is_bf16 = 0) or bf16; ln6 (6, 64), w1, w2 (64, 64), b1,
// b2, wc (64,), bc (1,) f32 -> pp (T,) f32.  Returns the CUDA error (0 = ok).
extern "C" int matcha_fused_tail_fwd(const void* y, const void* h, const void* ln6,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, const void* wc, const void* bc, void* pp,
                                     int T, int is_bf16, uint32_t key0, uint32_t key1,
                                     int use_m0, int use_m1, float r0, float r1, float s0,
                                     float s1, void* stream) {
  if (T < 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a = make_args(y, h, ln6, w1, b1, w2, b2, wc, bc, T, key0, key1, use_m0, use_m1,
                           r0, r1, s0, s1);
  int grid = (T + NWARP - 1) / NWARP;
  grid = grid > 4 * sm_count() ? 4 * sm_count() : grid;
  cudaError_t err;
  if (is_bf16) {
    err = cudaFuncSetAttribute(fused_tail_fwd_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    fused_tail_fwd_kernel<__nv_bfloat16><<<grid, NT, FWD_SMEM, st>>>(a, static_cast<float*>(pp));
  } else {
    err = cudaFuncSetAttribute(fused_tail_fwd_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    fused_tail_fwd_kernel<float><<<grid, NT, FWD_SMEM, st>>>(a, static_cast<float*>(pp));
  }
  return (int)cudaGetLastError();
}

// blocks of the backward's persistent grid for T tokens: for f32, up to two
// per SM over tiles of 32 tokens; for bf16 (the tensor-core route), up to
// one per SM, two warpgroups each over tiles of 64 tokens
extern "C" int matcha_fused_tail_bwd_blocks(int T, int is_bf16) {
  const int n = is_bf16 ? (T + 2 * TC_ROWS - 1) / (2 * TC_ROWS) : (T + TILE - 1) / TILE;
  const int cap = is_bf16 ? sm_count() : 2 * sm_count();
  return n < 1 ? 1 : (n > cap ? cap : n);
}

extern "C" int matcha_fused_tail_bwd_slice_floats() { return SLICE; }

// the forward's arguments and g (T,) f32 -> gy, gh (T, 64) in y's dtype;
// grads (SLICE,) f32 = [gw1 (64x64), gw2 (64x64), gln (6x64), gb1, gb2, gwc
// (64 each), gbc]; scratch (n_blocks, SLICE) f32 is overwritten.  n_blocks
// must be matcha_fused_tail_bwd_blocks(T, is_bf16).  bf16 takes the
// tensor-core kernel, f32 the CUDA-core kernel.  Returns the CUDA error (0 =
// ok).
extern "C" int matcha_fused_tail_bwd(const void* y, const void* h, const void* ln6,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, const void* wc, const void* bc,
                                     const void* g, void* gy, void* gh, void* scratch,
                                     void* grads, int T, int is_bf16, uint32_t key0,
                                     uint32_t key1, int use_m0, int use_m1, float r0, float r1,
                                     float s0, float s1, int n_blocks, void* stream) {
  if (T < 0 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a = make_args(y, h, ln6, w1, b1, w2, b2, wc, bc, T, key0, key1, use_m0, use_m1,
                           r0, r1, s0, s1);
  const float* gg = static_cast<const float*>(g);
  float* sc = static_cast<float*>(scratch);
  cudaError_t err;
  if (is_bf16) {
    err = cudaFuncSetAttribute(fused_tail_bwd_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, TC_BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    fused_tail_bwd_tc_kernel<<<n_blocks, NT, TC_BWD_SMEM, st>>>(
        a, gg, static_cast<__nv_bfloat16*>(gy), static_cast<__nv_bfloat16*>(gh), sc);
  } else {
    err = cudaFuncSetAttribute(fused_tail_bwd_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    fused_tail_bwd_kernel<float><<<n_blocks, NT, BWD_SMEM, st>>>(
        a, gg, static_cast<float*>(gy), static_cast<float*>(gh), sc);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_slices_kernel<<<(SLICE + NT - 1) / NT, NT, 0, st>>>(sc, static_cast<float*>(grads),
                                                            n_blocks);
  return (int)cudaGetLastError();
}

extern "C" const char* matcha_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
