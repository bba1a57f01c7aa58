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
// The f32 routes of the forward and the backward: one warp works on one
// token at a time, each lane owning features c = lane and lane + 32; w1, w2 (row stride
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
// The forward's bf16 route (fused_tail_fwd_tc_kernel, chosen inside
// matcha_fused_tail_fwd by y's dtype) runs both products on the tensor cores
// through tile_fwd, the same code as the backward's recompute below (so the
// two cannot drift): a persistent grid, two blocks of two warpgroups per SM,
// each warpgroup walking tiles of 64 tokens with the next tile's y and h
// prefetched by cp.async; d0 is rounded and kept as the first product's A
// fragments, h1 = tanh(d0 w1 + b1) and hd come out of the accumulator as the
// second product's A fragments, and o, the three LayerNorms and pp stay in
// the accumulator layout.  Without weight-grad accumulators it fits 128
// registers a thread, so 16 warps share an SM (the backward has 8).
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

#include <cmath>

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
  uint32_t thr0, thr1;  // keep iff (bits >> 8) >= thr: the integer form of u >= rate
  int use_m0, use_m1;
  float r0, r1, s0, s1;
};

// The CUDA-core kernels below are the f32 routes (bf16 takes the tensor-core
// kernels), so their loads, stores and roundings to T are those of f32; rnd
// marks where the chain rounds to the compute dtype.
__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ float rnd(float v, const float*) { return v; }

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

// u = (bits >> 8) * 2^-24 is a 24-bit integer times a power of two, so u >=
// rate exactly when (bits >> 8) >= ceil(rate * 2^24): the threshold of
// kept_bit, computed once per launch
inline uint32_t keep_threshold(float rate) {
  const double t = std::ceil((double)rate * 16777216.0);
  return t <= 0.0 ? 0u : (t >= 16777216.0 ? 16777216u : (uint32_t)t);
}

__device__ __forceinline__ bool kept_bit(uint32_t key, uint32_t idx, uint32_t thr) {
  return (fmix32(key + idx * 0x9E3779B9u) >> 8) >= thr;
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

// in place: two floats rounded to bf16 (one conversion for both)
__device__ __forceinline__ void round_pair(float& x0, float& x1) {
  const float2 f = __bfloat1622float2(__floats2bfloat162_rn(x0, x1));
  x0 = f.x;
  x1 = f.y;
}

// in place: xhat -> round(xhat * g + b) to bf16 (entries k, k + 1 are
// columns c, c + 1 of one row)
__device__ __forceinline__ void affine_bf16(float (&x)[32], const float* g, const float* b,
                                            int fc) {
#pragma unroll
  for (int k = 0; k < 32; k += 2) {
    const int c = col_of(k, fc);
    x[k] = x[k] * g[c] + b[c];
    x[k + 1] = x[k + 1] * g[c + 1] + b[c + 1];
    round_pair(x[k], x[k + 1]);
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

// w1 and w2 as bf16 tiles W[k][n] (read as W, B_KN, and as W^T) at w and w
// + TILE_ELEMS; ln6, b1, b2 and wc (f32) from f on
__device__ __forceinline__ void load_tc_params(const Args& a, __nv_bfloat16* w, float* f) {
  for (int i = threadIdx.x; i < 2 * D * (D / 4); i += NT) {
    const int mat = i / (D * D / 4), rem = i % (D * D / 4);
    const int row = rem / (D / 4), col = (rem % (D / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>((mat ? a.w2 : a.w1) + row * D + col);
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(w + mat * TILE_ELEMS + mma_bf16::blk(row, col));
    dst[0] = __floats2bfloat162_rn(v.x, v.y);
    dst[1] = __floats2bfloat162_rn(v.z, v.w);
  }
  for (int i = threadIdx.x; i < 6 * D; i += NT) f[i] = a.ln6[i];
  for (int i = threadIdx.x; i < D; i += NT) {
    f[6 * D + i] = a.b1[i];
    f[7 * D + i] = a.b2[i];
    f[8 * D + i] = a.wc[i];
  }
}

// The dropout masks of this thread's 32 entries of the tile at token t0, one
// bit each (set = kept; all set where a dropout is off)
__device__ __forceinline__ void tile_masks(const Args& a, size_t t0, int q, int fg, int fc,
                                           uint32_t& keep0, uint32_t& keep1) {
  keep0 = keep1 = 0u;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const uint32_t idx = (uint32_t)((t0 + 16 * q + fg + 8 * row_of(k)) * D + col_of(k, fc));
    if (!a.use_m0 || kept_bit(a.key0, idx, a.thr0)) keep0 |= 1u << k;
    if (!a.use_m1 || kept_bit(a.key1, idx, a.thr1)) keep1 |= 1u << k;
  }
}

// the LayerNorm statistics of a tile's two rows per thread that the backward
// uses again
struct TileStats {
  float mu_o[2], inv_o[2], mu_d[2], inv_d[2], mu_s[2], inv_s[2];
};

// The forward chain of one warpgroup's tile of 64 tokens, shared by the
// forward and the backward (its steps 1-3), in the accumulator layout:
//   1. d0 = round(y * m0), into td0 (which may be ty itself) and kept as
//      A fragments;
//   2. h1 = tanh(d0 w1 + b1), hd = round(h1 * m1);
//   3. o = round(hd w2 + b2 + d0), dyn = round(LN(o)), dynamic =
//      round(LN(dyn)), static = round(LN(h)) and diff = dynamic - static
//      (f32) into diff.
// Rows of y and h at or past `valid` read as zeros.  Every tile access is to
// this thread's own entries.  BWD also keeps what the backward needs again:
// hd in thd, o in to, dyn in tdyn (exact in bf16), 1 - h1^2 in dts (stride
// 128) and the statistics in st.
template <bool BWD>
__device__ __forceinline__ void tile_fwd(const Args& a, const __nv_bfloat16* w1,
                                         const __nv_bfloat16* w2, const float* ln6,
                                         const float* b1, const float* b2,
                                         const __nv_bfloat16* ty, __nv_bfloat16* td0,
                                         const __nv_bfloat16* th, __nv_bfloat16* thd,
                                         __nv_bfloat16* to, __nv_bfloat16* tdyn, float* dts,
                                         uint32_t keep0, uint32_t keep1, int valid, int q,
                                         int fg, int fc, float (&diff)[32], TileStats& st) {
  using mma_bf16::acc_to_a;
  using mma_bf16::store_bf16;
  using mma_bf16::wg_issue_a;
  using mma_bf16::wg_wait;
  auto m0 = [&](int k) { return (keep0 >> k) & 1u ? a.s0 : 0.f; };
  auto m1 = [&](int k) { return (keep1 >> k) & 1u ? a.s1 : 0.f; };
  uint32_t fa[4][4];
  {
    float d0[32];
    tile_to_acc(ty, q, fg, fc, valid, d0);
    if (a.use_m0) {
#pragma unroll
      for (int k = 0; k < 32; k += 2) {
        d0[k] *= m0(k);
        d0[k + 1] *= m0(k + 1);
        round_pair(d0[k], d0[k + 1]);
      }
    }
    // without the dropout d0 is y: the forward (td0 == ty) has it already
    if (BWD || a.use_m0) store_bf16(d0, td0, q, fg, fc);
    acc_to_a(d0, fa);
  }
  {
    float acc[32];
    wg_issue_a<true, 64>(acc, fa, w1, 0, false);
    wg_wait(acc);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const float h1 = tanhf(acc[k] + b1[col_of(k, fc)]);
      if constexpr (BWD) dts[k * 128] = 1.0f - h1 * h1;
      acc[k] = a.use_m1 ? h1 * m1(k) : h1;
    }
#pragma unroll
    for (int k = 0; k < 32; k += 2) round_pair(acc[k], acc[k + 1]);
    if constexpr (BWD) store_bf16(acc, thd, q, fg, fc);
    acc_to_a(acc, fa);
  }
  float o[32];
  {
    float d0[32];
    wg_issue_a<true, 64>(o, fa, w2, 0, false);
    tile_to_acc(td0, q, fg, fc, valid, d0);
    wg_wait(o);
#pragma unroll
    for (int k = 0; k < 32; k += 2) {
      o[k] = (o[k] + b2[col_of(k, fc)]) + d0[k];
      o[k + 1] = (o[k + 1] + b2[col_of(k + 1, fc)]) + d0[k + 1];
      round_pair(o[k], o[k + 1]);
    }
  }
  if constexpr (BWD) store_bf16(o, to, q, fg, fc);
  ln_stats(o, st.mu_o, st.inv_o);
  normalize(o, st.mu_o, st.inv_o);
  affine_bf16(o, ln6, ln6 + D, fc);  // o <- dyn
  if constexpr (BWD) store_bf16(o, tdyn, q, fg, fc);
  ln_stats(o, st.mu_d, st.inv_d);
  normalize(o, st.mu_d, st.inv_d);
  affine_bf16(o, ln6 + 2 * D, ln6 + 3 * D, fc);  // o <- dynamic
  tile_to_acc(th, q, fg, fc, valid, diff);
  ln_stats(diff, st.mu_s, st.inv_s);
  normalize(diff, st.mu_s, st.inv_s);
  affine_bf16(diff, ln6 + 4 * D, ln6 + 5 * D, fc);  // static
#pragma unroll
  for (int k = 0; k < 32; ++k) diff[k] = o[k] - diff[k];
}

// This warp's 16 rows of y and h of the tile at token t0 into the buffers ty
// and th (rows past T are not copied), with cp.async, as one commit group
__device__ __forceinline__ void prefetch_rows(const Args& a, size_t t0, __nv_bfloat16* ty,
                                              __nv_bfloat16* th, int q, int lane) {
  const __nv_bfloat16* y = static_cast<const __nv_bfloat16*>(a.y);
  const __nv_bfloat16* h = static_cast<const __nv_bfloat16*>(a.h);
  for (int i = lane; i < 2 * 16 * (D / 8); i += 32) {
    const int which = i / (16 * (D / 8)), r = 16 * q + (i / (D / 8)) % 16;
    const int c = 8 * (i % (D / 8));
    if (t0 + r < (size_t)a.T)
      mma_bf16::cp_async16((which ? th : ty) + mma_bf16::blk(r, c),
                           (which ? h : y) + (t0 + r) * D + c);
  }
  mma_bf16::cp_async_commit();
}

// The forward's bf16 route: tiles of y and h per warpgroup (two buffers
// each, the next tile's copy in flight) after w1, w2 and the f32 params
constexpr int FWD_TC_TILES = N_BT + 2 * 4;
constexpr int FWD_TC_SMEM = FWD_TC_TILES * TILE_ELEMS * 2 + TC_PARAMS * 4;
static_assert(2 * (FWD_TC_SMEM + 1024) <= 233472, "two forward blocks per SM");

// A persistent grid of blocks of two warpgroups, two blocks per SM (16
// warps: with no weight-grad accumulators the forward fits 128 registers a
// thread); each warpgroup walks tiles of 64 tokens of its own, the next
// tile's y and h prefetched with cp.async.  Every warp reads and writes only
// its own 16 rows of its tiles (the products read their A operand from
// registers and only the weights from shared memory), so a tile needs only
// one warpgroup barrier, where its copy lands.  pp = sum_c diff^2 wc + bc
// per row: a thread's 16 columns of each of its two rows, the quad's two
// shuffles, and one lane per token writes.
__global__ void __launch_bounds__(NT, 2) fused_tail_fwd_tc_kernel(Args a, float* __restrict__ pp) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem4[];
  bf16* tiles = reinterpret_cast<bf16*>(smem4);
  float* ln6 = reinterpret_cast<float*>(tiles + FWD_TC_TILES * TILE_ELEMS);
  const float* b1 = ln6 + 6 * D;
  const float* b2 = b1 + D;
  const float* wc = b2 + D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = warp & 3, grp = warp >> 2, fg = lane >> 2, fc = lane & 3;
  bf16* mine = tiles + (N_BT + grp * 4) * TILE_ELEMS;  // y (two buffers), h (two buffers)
  load_tc_params(a, tiles, ln6);
  mma_bf16::async_fence();
  __syncthreads();
  const float bc = a.bc[0];

  const int n_tiles = (a.T + TC_ROWS - 1) / TC_ROWS;
  const int n_wg = 2 * gridDim.x, w = 2 * blockIdx.x + grp;
  if (w < n_tiles) prefetch_rows(a, (size_t)w * TC_ROWS, mine, mine + 2 * TILE_ELEMS, q, lane);
  int buf = 0;
  for (int ti = w; ti < n_tiles; ti += n_wg, buf ^= 1) {
    const size_t t0 = (size_t)ti * TC_ROWS;
    const int valid = a.T - t0 < (size_t)TC_ROWS ? (int)(a.T - t0) : TC_ROWS;
    bf16* ty = mine + buf * TILE_ELEMS;
    bf16* th = mine + (2 + buf) * TILE_ELEMS;
    mma_bf16::cp_async_wait_all();
    // the copies are visible, and the warpgroup's warps start the tile's
    // products together, as in the backward
    mma_bf16::wg_sync(grp);
    if (ti + n_wg < n_tiles)
      prefetch_rows(a, t0 + (size_t)n_wg * TC_ROWS, mine + (buf ^ 1) * TILE_ELEMS,
                    mine + (3 - buf) * TILE_ELEMS, q, lane);
    uint32_t keep0, keep1;
    tile_masks(a, t0, q, fg, fc, keep0, keep1);
    float diff[32];
    TileStats st;
    // d0 overwrites y in place: each thread reads its entries before it
    // writes them
    tile_fwd<false>(a, tiles, tiles + TILE_ELEMS, ln6, b1, b2, ty, ty, th, nullptr, nullptr,
                    nullptr, nullptr, keep0, keep1, valid, q, fg, fc, diff, st);
    float p[2][8], rs[2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int k = 4 * j + 2 * hh, c = col_of(k, fc);
        p[hh][j] = diff[k] * diff[k] * wc[c] + diff[k + 1] * diff[k + 1] * wc[c + 1];
      }
    row_sums(p, rs);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * q + fg + 8 * hh;
      if (fc == 0 && r < valid) pp[t0 + r] = rs[hh] + bc;
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
    fused_tail_bwd_tc_kernel(Args a, const float* __restrict__ g, __nv_bfloat16* __restrict__ gy,
                             __nv_bfloat16* __restrict__ gh, float* __restrict__ scratch) {
  using mma_bf16::acc_to_a;
  using mma_bf16::async_fence;
  using mma_bf16::store_bf16;
  using mma_bf16::wg_issue_a;
  using mma_bf16::wg_sync;
  using mma_bf16::wg_wait;
  using bf16 = __nv_bfloat16;
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

  load_tc_params(a, wt(B_W1), ln6);
  async_fence();
  __syncthreads();

  const int n_tiles = (a.T + TC_ROWS - 1) / TC_ROWS;
  const int n_wg = 2 * gridDim.x, w = 2 * blockIdx.x + grp;
  // this warp's 16 rows of y and h of tile ti into buffer b, with cp.async
  auto prefetch = [&](int ti, int b) {
    prefetch_rows(a, (size_t)ti * TC_ROWS, pt(P_Y + b), pt(P_H + b), q, lane);
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
    uint32_t keep0, keep1;
    tile_masks(a, t0, q, fg, fc, keep0, keep1);
    auto m0 = [&](int k) { return (keep0 >> k) & 1u ? a.s0 : 0.f; };
    auto m1 = [&](int k) { return (keep1 >> k) & 1u ? a.s1 : 0.f; };

    // 1-3. the forward chain (tile_fwd): d0 staged for gw1, hd for gw2, o
    //    and dyn parked in the g_o and g_a1 tiles until their xhat is
    //    needed again, 1 - h1^2 kept until step 5; diff = dynamic - static
    float gd[32];  // diff, then g_diff, then g_dyn, then g_o
    float gt[2];
    TileStats st;
    tile_fwd<true>(a, wt(B_W1), wt(B_W2), ln6, b1, b2, pt(P_Y + buf), pt(P_D0), pt(P_H + buf),
                   pt(P_HD), pt(P_GO), pt(P_GA1), dts, keep0, keep1, valid, q, fg, fc, gd, st);
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
      normalize(v, st.mu_s, st.inv_s);  // xs
      add2(col[4], col_sums<true, true>(gd, v));
      float ng[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) ng[k] = -gd[k];
      ln_bwd_rows(ng, v, st.inv_s, ln6 + 4 * D, fc);  // g_h
      // out through y's buffer (y's last read was step 1)
      acc_to_rows(ng, pt(P_Y + buf), q, fg, fc);
      rows_out(pt(P_Y + buf), gh, t0, q, lane, valid);
      tile_to_acc(pt(P_GA1), q, fg, fc, TC_ROWS, v);
      normalize(v, st.mu_d, st.inv_d);  // xd
      add2(col[2], col_sums<true>(gd, v));
      add2(col[3], col_sums<false>(gd, gd));
      ln_bwd_rows(gd, v, st.inv_d, ln6 + 2 * D, fc);  // g_dyn
      tile_to_acc(pt(P_GO), q, fg, fc, TC_ROWS, v);
      normalize(v, st.mu_o, st.inv_o);  // xo
      add2(col[0], col_sums<true>(gd, v));
      add2(col[1], col_sums<false>(gd, gd));
      ln_bwd_rows(gd, v, st.inv_o, ln6, fc);  // g_o
      add2(col[7], col_sums<false>(gd, gd));
    }
    float (&go)[32] = gd;
    store_bf16(go, pt(P_GO), q, fg, fc);
    uint32_t fa[4][4];
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
  a.thr0 = keep_threshold(r0);
  a.thr1 = keep_threshold(r1);
  a.use_m0 = use_m0;
  a.use_m1 = use_m1;
  a.r0 = r0;
  a.r1 = r1;
  a.s0 = s0;
  a.s1 = s1;
  return a;
}

// cudaFuncSetAttribute for the dynamic shared memory of a kernel, once per
// device (the call costs host time)
template <typename K>
cudaError_t set_smem_once(K kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace

// y, h (T, 64) f32 (is_bf16 = 0) or bf16; ln6 (6, 64), w1, w2 (64, 64), b1,
// b2, wc (64,), bc (1,) f32 -> pp (T,) f32.  bf16 takes the tensor-core
// kernel (two blocks per SM, at most one tile of 64 tokens per warpgroup
// more than the rest), f32 the CUDA-core kernel.  Returns the CUDA error (0 =
// ok).
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
  float* out = static_cast<float*>(pp);
  cudaError_t err;
  if (is_bf16) {
    static bool done[64] = {};
    if ((err = set_smem_once(fused_tail_fwd_tc_kernel, FWD_TC_SMEM, done)) != cudaSuccess)
      return (int)err;
    const int pairs = (T + 2 * TC_ROWS - 1) / (2 * TC_ROWS);
    const int grid = pairs < 2 * sm_count() ? pairs : 2 * sm_count();
    fused_tail_fwd_tc_kernel<<<grid, NT, FWD_TC_SMEM, st>>>(a, out);
  } else {
    static bool done[64] = {};
    if ((err = set_smem_once(fused_tail_fwd_kernel<float>, FWD_SMEM, done)) != cudaSuccess)
      return (int)err;
    int grid = (T + NWARP - 1) / NWARP;
    grid = grid > 4 * sm_count() ? 4 * sm_count() : grid;
    fused_tail_fwd_kernel<float><<<grid, NT, FWD_SMEM, st>>>(a, out);
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
    static bool done[64] = {};
    if ((err = set_smem_once(fused_tail_bwd_tc_kernel, TC_BWD_SMEM, done)) != cudaSuccess)
      return (int)err;
    fused_tail_bwd_tc_kernel<<<n_blocks, NT, TC_BWD_SMEM, st>>>(
        a, gg, static_cast<__nv_bfloat16*>(gy), static_cast<__nv_bfloat16*>(gh), sc);
  } else {
    static bool done[64] = {};
    if ((err = set_smem_once(fused_tail_bwd_kernel<float>, BWD_SMEM, done)) != cudaSuccess)
      return (int)err;
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
