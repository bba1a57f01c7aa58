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
// Design.  One warp works on one token at a time, each lane owning features
// c = lane and lane + 32; w1, w2 (row stride 65, so both W and W^T reads are
// free of bank conflicts), the LayerNorm params, b1, b2 and wc sit in shared
// memory, and the token's vectors stay in registers and a per-warp shared
// row.  The two 64x64 products run as f32 FMAs from shared memory.  Only pp
// (forward), or gy, gh and the param-grad partials (backward) leave the block.
// The backward runs a persistent grid over tiles of 32 tokens: each block
// keeps its own gw1/gw2 entries in registers (a thread owns 8 rows x 2
// columns of each), adds each tile's outer products in token order, sums its
// per-lane column sums over warps in warp order, and writes one f32 scratch
// slice; a second kernel adds the slices in block order.  No float atomics:
// the same bits on every run for one card model.
// Bound on this card at T = 114,688, bf16: bytes.  Forward: y and h read
// once (29.4 MB), pp written (0.46 MB) -> 8.9 us at 3.35 TB/s (1.9 GFLOP ->
// 1.9 us on the tensor cores).  Backward: y, h, g read, gy, gh written
// (59 MB) -> 17.7 us (5.6 GFLOP -> 5.7 us).  This first kernel runs its
// products on the CUDA cores and is far from either bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// blocks of the backward's persistent grid for T tokens
extern "C" int matcha_fused_tail_bwd_blocks(int T) {
  const int n_tiles = (T + TILE - 1) / TILE;
  const int cap = 2 * sm_count();
  return n_tiles < 1 ? 1 : (n_tiles > cap ? cap : n_tiles);
}

extern "C" int matcha_fused_tail_bwd_slice_floats() { return SLICE; }

// the forward's arguments and g (T,) f32 -> gy, gh (T, 64) in y's dtype;
// grads (SLICE,) f32 = [gw1 (64x64), gw2 (64x64), gln (6x64), gb1, gb2, gwc
// (64 each), gbc]; scratch (n_blocks, SLICE) f32 is overwritten.  n_blocks
// must be matcha_fused_tail_bwd_blocks(T).  Returns the CUDA error (0 = ok).
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
    err = cudaFuncSetAttribute(fused_tail_bwd_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    fused_tail_bwd_kernel<__nv_bfloat16><<<n_blocks, NT, BWD_SMEM, st>>>(
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
