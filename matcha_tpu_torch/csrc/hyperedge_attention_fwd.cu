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
// Bound on this card (H100 SXM, bf16 inputs, per edge of L tokens):
//   operations  2*L*64*512*3 (q/k/v) + 2*L*512*64 (fc1) + 4*L*L*512 (scores,
//               a@v); at E = 10,000, L = 5: 13.6 GFLOP -> 13.8 us at 989 TFLOP/s
//   bytes       2*E*L*64*2 (x in, y out) + 0.5 MB of f32 weights; 13.3 MB
//               -> 4.0 us at 3.35 TB/s
// so the work is bound by the tensor cores' rate.
//
// Two routes, picked inside matcha_hyperedge_attention_fwd by x's dtype and
// the number of heads:
//
// * bf16 with H <= 8 (every bf16 call of the model):
//   hyperedge_attention_fwd_tc_kernel, every 64-wide product on the tensor
//   cores (wgmma, bf16 operands, f32 sums; mma_bf16.cuh).  A cluster of H
//   blocks, one per head, walks tiles of 64 token rows (64 / L whole edges;
//   the ragged tail is masked, so any E works).  Block h converts head h's
//   slices of wq, wk, wv and fw to bf16 once and keeps them in shared
//   memory.  Its two warpgroups each take a tile of their own, so one
//   tile's LayerNorms and softmax run while the other's products do.  Per
//   tile a warpgroup computes the three LayerNorms (f32 statistics, bf16
//   outputs), q, k, v = LN W_h (three wgmma), the scores as each edge's
//   L x L diagonal block of q k^T (one wgmma; the edge-block-diagonal mask
//   and s_ii = -1e32 under diag_mask), the softmax in f32 registers (a row's
//   64 columns lie in one quad), o = a v and the head's partial y_h = o fw_h.
//   q, a and o go from one product to the next in registers (the
//   accumulator is the next product's A fragment); k and v go through
//   shared memory as B operands.  The partials are summed over the heads
//   through distributed shared memory in rank order: rank h adds fb to its
//   64 / H rows, rounds once and stores, one pair of tiles later so that the
//   cluster barrier overlaps the next tiles' work.  No float atomics: the
//   same bits on every call.  Rounding is the plain version's (_fwd_xla's):
//   the weights, LayerNorm outputs, q, k, v, a and o are bf16, sums f32.
// * f32 (and bf16 with more heads): hyperedge_attention_fwd_kernel, the
//   products as f32 FMAs on the CUDA cores (67 TFLOP/s peak), rounding as
//   the TPU kernel does: the LayerNorm outputs, q and k to x's dtype, v in
//   f32, the attention output to x's dtype before fc1, f32 weights.  One
//   block of 256 threads per tile of TE edges (16 for L <= 5, else 8); a
//   loop over heads stages the 64x64 slices of wq, wk, wv and fw in shared
//   memory and accumulates y += o_h @ fw_h in registers; bias, cast and one
//   store at the end.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

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

// ------------------------------------------------- the tensor-core route (bf16)
// (design in the note at the top of this file)

constexpr int TC_ROWS = 64;      // token rows per tile
constexpr int MAX_TC_HEADS = 8;  // heads = blocks of a cluster
constexpr int FS = 72;           // row stride of the f32 partials (float2 stores hit 32 banks)
constexpr int TILE_ELEMS = mma_bf16::TILE;
// bf16 tiles, 64 x 64 each in mma_bf16's blocked layout: head h's weights,
// then per warpgroup its tile's x rows (prefetched) and LN_q, LN_k, LN_v
// (LN_k and LN_v overwritten by k and v)
enum { T_WQ, T_WK, T_WV, T_FW, N_WT };
enum { G_X, G_Q, G_K, G_V, N_GT };
constexpr int TC_TILES = N_WT + 2 * N_GT;
// f32: the partials y_h [warpgroup][buffer][64][FS], LN params (6 x 64), fb
constexpr int TC_F32 = 2 * 2 * TC_ROWS * FS + 6 * D + D;
constexpr int TC_SMEM_BYTES = TC_TILES * TILE_ELEMS * 2 + TC_F32 * 4;
static_assert(TC_SMEM_BYTES <= 232448, "shared memory of one block");

template <int L>
__global__ void __launch_bounds__(NT, 1)
    hyperedge_attention_fwd_tc_kernel(const __nv_bfloat16* __restrict__ x,
                                      const float* __restrict__ ln, const float* __restrict__ wq,
                                      const float* __restrict__ wk, const float* __restrict__ wv,
                                      const float* __restrict__ fw, const float* __restrict__ fb,
                                      __nv_bfloat16* __restrict__ out, int E, int H,
                                      int diag_mask) {
  using mma_bf16::acc_to_a;
  using mma_bf16::async_fence;
  using mma_bf16::blk;
  using mma_bf16::cluster_arrive;
  using mma_bf16::cluster_wait;
  using mma_bf16::store_bf16;
  using mma_bf16::wg_issue;
  using mma_bf16::wg_issue_a;
  using mma_bf16::wg_sync;
  using mma_bf16::wg_wait;
  using bf16 = __nv_bfloat16;
  using bf162 = __nv_bfloat162;
  constexpr int TE = TC_ROWS / L, R = TE * L;  // whole edges per tile, their rows
  extern __shared__ float4 smem4[];
  bf16* tiles = reinterpret_cast<bf16*>(smem4);
  float* part = reinterpret_cast<float*>(tiles + TC_TILES * TILE_ELEMS);  // [2][2][64][FS]
  float* ln6 = part + 2 * 2 * TC_ROWS * FS;
  float* fbs = ln6 + 6 * D;

  cg::cluster_group cluster = cg::this_cluster();
  const int h = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // warpgroup grp (warps 4grp..4grp+3) works on its own tile; warp q of it
  // owns the rows 16q..16q+15 in every phase; a thread's entries of a
  // product are rows 16q + fg (+ 8), columns 8j + 2fc (+ 1)
  const int q = warp & 3, grp = warp >> 2, fg = lane >> 2, fc = lane & 3;
  bf16* mine = tiles + (N_WT + grp * N_GT) * TILE_ELEMS;
  auto wt = [&](int i) { return tiles + i * TILE_ELEMS; };
  auto gt = [&](int i) { return mine + i * TILE_ELEMS; };
  const int hd = H * D;
  const float inv_temp = 1.f / sqrtf((float)D);
  const float NEG_INF = __int_as_float(0xff800000);

  // head h's weights as bf16, once: W_t[k = feature][n = column] and
  // fw_h[k = head column][n = output]
  for (int i = tid; i < 4 * D * (D / 4); i += NT) {
    const int mat = i / (D * D / 4), rem = i % (D * D / 4);
    const int row = rem / (D / 4), col = (rem % (D / 4)) * 4;
    const float* src = mat < 3 ? (mat == 0 ? wq : (mat == 1 ? wk : wv)) + (size_t)row * hd +
                                     (size_t)h * D + col
                               : fw + ((size_t)h * D + row) * D + col;
    const float4 v = *reinterpret_cast<const float4*>(src);
    bf162* dst = reinterpret_cast<bf162*>(wt(T_WQ + mat) + blk(row, col));
    dst[0] = __floats2bfloat162_rn(v.x, v.y);
    dst[1] = __floats2bfloat162_rn(v.z, v.w);
  }
  for (int i = tid; i < 6 * D; i += NT) ln6[i] = ln[i];
  // fb as the plain version's bf16 operand
  for (int i = tid; i < D; i += NT) fbs[i] = __bfloat162float(__float2bfloat16_rn(fb[i]));
  async_fence();
  __syncthreads();

  const int n_tiles = (E + TE - 1) / TE;
  const int n_pairs = (n_tiles + 1) / 2;  // warpgroup grp takes tile 2p + grp of pair p
  // first row and valid rows of tile ti (0 rows past the last tile)
  auto rows_of = [&](int ti, size_t& row0) {
    row0 = (size_t)ti * R;
    if (ti >= n_tiles) return 0;
    const size_t left = (size_t)E * L - row0;
    return left < (size_t)R ? (int)left : R;
  };
  // this warp's rows of its tile of pair p into G_X with cp.async, so the
  // copy runs while the warpgroup works on the pair before
  auto prefetch = [&](int p) {
    size_t r0;
    const int rv = rows_of(2 * p + grp, r0);
    for (int i = lane; i < 16 * (D / 8); i += 32) {
      const int r = 16 * q + i / (D / 8), c = 8 * (i % (D / 8));
      if (r < rv) mma_bf16::cp_async16(gt(G_X) + blk(r, c), x + (r0 + r) * D + c);
    }
    mma_bf16::cp_async_commit();
  };

  // The rows 64/H * h .. of warpgroup grp's tile in buffer b: y_h summed
  // over the heads in rank order (through distributed shared memory), plus
  // fb, rounded once and stored.
  auto reduce_store = [&](int b, size_t row0, int rows_valid) {
    const float* pb = part + (grp * 2 + b) * TC_ROWS * FS;
    const int per = (TC_ROWS + H - 1) / H;
    const int r_lo = h * per;
    const int r_hi = r_lo + per < rows_valid ? r_lo + per : rows_valid;
    for (int i = tid & 127; i < (r_hi - r_lo) * (D / 4); i += 128) {
      const int r = r_lo + i / (D / 4), c = 4 * (i % (D / 4));
      float4 v[MAX_TC_HEADS];
#pragma unroll
      for (int rk = 0; rk < MAX_TC_HEADS; ++rk)  // all remote loads in flight at once
        if (rk < H)
          v[rk] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(pb, rk) + r * FS + c);
      float4 s = v[0];
#pragma unroll
      for (int rk = 1; rk < MAX_TC_HEADS; ++rk)
        if (rk < H) {
          s.x += v[rk].x;
          s.y += v[rk].y;
          s.z += v[rk].z;
          s.w += v[rk].w;
        }
      bf162* o = reinterpret_cast<bf162*>(out + (row0 + r) * D + c);
      o[0] = __floats2bfloat162_rn(s.x + fbs[c], s.y + fbs[c + 1]);
      o[1] = __floats2bfloat162_rn(s.z + fbs[c + 2], s.w + fbs[c + 3]);
    }
  };

  // Each pair's partials go out with a cluster-barrier arrive; the wait
  // comes after the next pair's products, so the barrier overlaps them.  The
  // buffers alternate: a rank still reading buffer b of pair i holds back
  // everyone's wait of pair i + 1, so nobody writes b (pair i + 2) meanwhile.
  const int rr = lane & 7, cg8 = lane >> 3;  // LayerNorm lanes: row 8-band + rr, chunks cg8, cg8 + 4
  const int first = (int)blockIdx.y;
  prefetch(first);
  int buf = 0;
  size_t prev_row0 = 0;
  int prev_valid = 0;
  for (int p = first; p < n_pairs; p += gridDim.y, buf ^= 1) {
    size_t row0;
    const int rows_valid = rows_of(2 * p + grp, row0);
    mma_bf16::cp_async_wait_all();
    // the copy is visible, and every warp of the group is done reading the
    // last tile's k and v (the next LayerNorms overwrite them)
    wg_sync(grp);

    // 1. LayerNorms of this warp's 16 rows (two bands of 8): eight lanes per
    //    row, sixteen columns each (two 16-byte chunks, so eight lanes read
    //    one whole core matrix at a time), a row's sums in two shuffles;
    //    rows past the tile's edges read as zeros and are never stored
#pragma unroll
    for (int band = 0; band < 2; ++band) {
      const int r = 16 * q + 8 * band + rr;
      float xv[16];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows_valid)
          raw = *reinterpret_cast<const uint4*>(gt(G_X) + blk(r, 8 * (cg8 + 4 * k)));
        const bf162* xb = reinterpret_cast<const bf162*>(&raw);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 a = __bfloat1622float2(xb[u]);
          xv[8 * k + 2 * u] = a.x;
          xv[8 * k + 2 * u + 1] = a.y;
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
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c = 8 * (cg8 + 4 * k);
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const float4* gm4 = reinterpret_cast<const float4*>(ln6 + (2 * t) * D + c);
          const float4* bt4 = reinterpret_cast<const float4*>(ln6 + (2 * t + 1) * D + c);
          const float4 ga = gm4[0], gb = gm4[1], ba = bt4[0], bb = bt4[1];
          const float gm[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
          const float bt[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
          uint4 o;
          bf162* ob = reinterpret_cast<bf162*>(&o);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            ob[u] = __floats2bfloat162_rn(xv[8 * k + 2 * u] * gm[2 * u] + bt[2 * u],
                                          xv[8 * k + 2 * u + 1] * gm[2 * u + 1] + bt[2 * u + 1]);
          *reinterpret_cast<uint4*>(gt(G_Q + t) + blk(r, c)) = o;
        }
      }
    }
    __syncwarp();
    if (p + (int)gridDim.y < n_pairs) prefetch(p + gridDim.y);

    // 2. q, k, v = LN W_h on the tensor cores (A: this warp's rows, read by
    //    ldmatrix before the products start); k and v rounded to bf16 over
    //    LN_k and LN_v (this warp's rows), q kept as A fragments
    uint32_t qa[4][4];
    {
      float dq[32], dk[32], dv[32];
      uint32_t ak[4][4], av[4][4];
      wg_issue<false, true, 64>(dq, qa, gt(G_Q), wt(T_WQ), 0, false, q, lane);
      wg_issue<false, true, 64>(dk, ak, gt(G_K), wt(T_WK), 0, false, q, lane);
      wg_issue<false, true, 64>(dv, av, gt(G_V), wt(T_WV), 0, false, q, lane);
      wg_wait(dq);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        mma_bf16::fence_operand(dk[i]);
        mma_bf16::fence_operand(dv[i]);
      }
      store_bf16(dk, gt(G_K), q, fg, fc);
      store_bf16(dv, gt(G_V), q, fg, fc);
      acc_to_a(dq, qa);
    }
    async_fence();
    wg_sync(grp);

    // 3. scores: the 64 x 64 product q k^T, of which each edge's L x L
    //    diagonal block is kept; the softmax in f32 in the registers, a
    //    row's sums over the four lanes that hold it; a as bf16 fragments
    //    (each edge's block, zeros elsewhere and in the rows past R)
    uint32_t aa[4][4];
    {
      float sc[32];
      wg_issue_a<false, 64>(sc, qa, gt(G_K), 0, false);
      wg_wait(sc);
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
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) sc[4 * j + 2 * hh + u] *= inv;
      }
      acc_to_a(sc, aa);
    }

    // 4. o = a v, rounded to bf16, kept as A fragments; 5. y_h = o fw_h
    uint32_t oa[4][4];
    {
      float o[32];
      wg_issue_a<true, 64>(o, aa, gt(G_V), 0, false);
      wg_wait(o);
      acc_to_a(o, oa);
    }
    float y[32];
    wg_issue_a<true, 64>(y, oa, wt(T_FW), 0, false);
    wg_wait(y);

    // 6. the pair before: every rank's partials are out; sum this rank's rows
    if (p != first) {
      cluster_wait();
      reduce_store(buf ^ 1, prev_row0, prev_valid);
    }
    // 7. this tile's partial y_h, then the arrive that publishes it
    float* pc = part + (grp * 2 + buf) * TC_ROWS * FS;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(pc + (16 * q + fg + 8 * hh) * FS + 8 * j + 2 * fc) =
            make_float2(y[4 * j + 2 * hh], y[4 * j + 2 * hh + 1]);
    cluster_arrive();
    prev_row0 = row0;
    prev_valid = rows_valid;
  }
  cluster_wait();
  reduce_store(buf ^ 1, prev_row0, prev_valid);
  cluster.sync();  // every rank's shared memory stays until all have read it
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

// Launch on at most as many clusters as fit on the card at once (asked of
// the runtime once per device, L and H) and at most one per pair of tiles.
template <int L>
cudaError_t launch_tc(const void* x, const void* ln, const void* wq, const void* wk,
                      const void* wv, const void* fw, const void* fb, void* out, int E, int H,
                      int diag_mask, cudaStream_t stream) {
  auto kernel = hyperedge_attention_fwd_tc_kernel<L>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         TC_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  constexpr int MAX_DEV = 16;
  static int most[MAX_DEV][MAX_TC_HEADS + 1] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n_max = dev < MAX_DEV ? most[dev][H] : 0;
  if (n_max <= 0) {
    const cudaLaunchConfig_t probe = tc_config(H, 1, stream, &attr);
    err = cudaOccupancyMaxActiveClusters(&n_max, (const void*)kernel, &probe);
    if (err != cudaSuccess) return err;
    if (n_max <= 0) return cudaErrorInvalidConfiguration;
    if (dev < MAX_DEV) most[dev][H] = n_max;
  }
  const int n_tiles = (E + TC_ROWS / L - 1) / (TC_ROWS / L);
  const int n_pairs = (n_tiles + 1) / 2;
  const cudaLaunchConfig_t cfg = tc_config(H, n_pairs < n_max ? n_pairs : n_max, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x),
                           static_cast<const float*>(ln), static_cast<const float*>(wq),
                           static_cast<const float*>(wk), static_cast<const float*>(wv),
                           static_cast<const float*>(fw), static_cast<const float*>(fb),
                           static_cast<__nv_bfloat16*>(out), E, H, diag_mask);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers; weights and
// LayerNorm params are f32; x and out are f32 (is_bf16 = 0) or bf16.  bf16
// with H <= 8 takes the tensor-core kernel, everything else the CUDA-core
// kernel.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int matcha_hyperedge_attention_fwd(const void* x, const void* ln, const void* wq,
                                              const void* wk, const void* wv, const void* fw,
                                              const void* fb, void* out, int E, int L, int H,
                                              int diag_mask, int is_bf16, void* stream) {
  if (E <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = use_tc(is_bf16, H);
#define MATCHA_CASE(LL)                                                                    \
  case LL:                                                                                 \
    if (tc) return (int)launch_tc<LL>(x, ln, wq, wk, wv, fw, fb, out, E, H, diag_mask, s); \
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
