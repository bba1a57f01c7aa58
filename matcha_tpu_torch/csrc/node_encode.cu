// The node-table encode for NVIDIA Hopper (sm_90a): K8.
//
// Replaces no TPU kernel.  The JAX package encodes the node table as plain
// jnp (matcha_tpu/models/hypersagnn.py:encode_node_table), which XLA fuses
// under jit; the port ran the same chain eagerly: per chromosome a cast of
// the feature rows, the feature-dropout compare, divide and select, two
// casts of the weights, two products, a tanh and a slice (or, for small
// tables, pads and stacks of every chromosome), ~330 host operations a
// training forward and ~300 more in autograd's backward.  This file computes
// the chain after the uniform draws for every chromosome in one launch a
// direction (matcha_tpu_torch/ops/node_encode.py is its wrapper):
//
//   keep   (matcha_node_encode_keep): the feature-dropout keep test
//          u < thr (thr = float32(1 - rate)) on the rows of chromosome c's
//          draw that this rank's rows read, row min(uoff + i, utop) with row
//          stride ustride, packed 32 columns a word (bit j of word w of row
//          i: column 32w + j).  A launch takes any run of chromosomes whose
//          draws are alive, so the draws need not all be held at once.
//   fwd    (matcha_node_encode_fwd): per tile of 64 rows of a chromosome,
//          X~ = keep ? x * scale : 0 (rounded to the compute dtype), T =
//          tanh(X~ W1) and H = T W2, written at the chromosome's rows of the
//          node table; T is kept for the backward.
//   bwd    (matcha_node_encode_bwd): G = (dH W2^T) * (1 - T^2), dW1 = X~^T G
//          with X~ rebuilt from x and the bits, dW2 = T^T dH, in f32.
//
// Layout: a table of int64 fields per chromosome (F_* below: pointers to its
// feature rows, w1 (width x d) and w2 (d x d), both f32; its row counts and
// offsets) and two lists of tiles, built once per shape set by the wrapper
// and kept on the device.  A forward tile is (chromosome, 64-row block); a
// backward tile is (chromosome, 64-column block of x, i.e. 64 rows of dW1)
// or (chromosome, -1), the block that sums dW2.  Every block owns the
// outputs it writes: no float atomics, the same bits on every run.
//
// Routes, chosen by the compute dtype: bf16 runs the products on the tensor
// cores (wgmma, f32 sums; mma_bf16.cuh), rounding where the eager chain
// rounds (x, the masked x, X~W1, T, dH W2^T and G); f32 runs them as FMAs on
// the CUDA cores (no TF32).  The feature rows are f32 or bf16 and are
// converted in registers.  d is 16, 32, 48 or 64; products run at width 64
// with the columns past d zero.
//
// Bound on this card: bytes.  X W1 has N = d = 64, about 64 operations a
// byte of bf16 x, a fifth of the ~295 the tensor cores need per byte of HBM.
// The forward reads x (and the bits); w1 is read by every row tile of its
// chromosome and stays in L2.  The backward reads x again, and dH and T
// (small, in L2) once per column block.  On the tensor-core route x, the
// bits, dH and T reach shared memory through a ring of cp.async stages a few
// 64 x 64 blocks ahead (a 10 kb rank's 64-row tiles read x far below the
// card's bandwidth when each block held only its next block in registers);
// the next block's w1 is loaded into registers while the current product
// runs.  The keep test reads each kept row of a draw once, a few words a
// warp in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using mma_bf16::blk;

constexpr int NT = 128;          // one warpgroup a block
constexpr int TM = 64;           // rows of a tile; columns of a block of x
constexpr int LDX = TM + 8;      // row stride (bf16) of the staged x: 144 bytes
constexpr int LDF = TM;          // row stride (f32) of the CUDA-core route's tiles
constexpr int MAXC = 64;         // chromosomes a launch can name draws for
constexpr unsigned FULL = 0xffffffffu;

// fields of a chromosome's row of the table; ops/node_encode.py writes them
enum {
  F_X,        // feature rows (rows x width), f32 or bf16, row-major
  F_W1,       // w1 (width x d) f32
  F_W2,       // w2 (d x d) f32
  F_ROWS,     // rows this rank holds
  F_WIDTH,    // columns of x (the chromosome's bins)
  F_OUT,      // row of the output (and of dH) of its first row
  F_T,        // row of T of its first row
  F_BITS,     // word of its first row's keep bits
  F_WORDS,    // words a row: ceil(width / 32)
  F_UOFF,     // row of its draw that its first row reads
  F_UTOP,     // last row of its draw (rows past it read this one)
  F_USTRIDE,  // row stride of its draw
  F_GW1,      // float of its dW1 in the flat gradient
  F_GW2,      // float of its dW2 in the flat gradient
  NF
};

struct Chrom {
  const void* x;
  const float* w1;
  const float* w2;
  long long rows, width, out, t, bits, words, uoff, utop, ustride, gw1, gw2;
};

__device__ __forceinline__ Chrom chrom(const long long* __restrict__ tab, int c) {
  const long long* f = tab + (size_t)c * NF;
  Chrom h;
  h.x = reinterpret_cast<const void*>(f[F_X]);
  h.w1 = reinterpret_cast<const float*>(f[F_W1]);
  h.w2 = reinterpret_cast<const float*>(f[F_W2]);
  h.rows = f[F_ROWS];
  h.width = f[F_WIDTH];
  h.out = f[F_OUT];
  h.t = f[F_T];
  h.bits = f[F_BITS];
  h.words = f[F_WORDS];
  h.uoff = f[F_UOFF];
  h.utop = f[F_UTOP];
  h.ustride = f[F_USTRIDE];
  h.gw1 = f[F_GW1];
  h.gw2 = f[F_GW2];
  return h;
}

struct UPtrs {
  const float* p[MAXC];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// ------------------------------------------------------------------- keep
// One warp a row of chromosomes [c0, c1) at a time (rows numbered across
// them as F_T numbers them): lane j tests column 32w + j of each word w of
// the row, the ballot is the word; KU words' loads are in flight together.
constexpr int KU = 4;

__global__ void __launch_bounds__(256)
    keep_kernel(const long long* __restrict__ tab, int c0, int c1, UPtrs u, float thr,
                uint32_t* __restrict__ bits) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long lo = tab[(size_t)c0 * NF + F_T];
  const long long hi = tab[(size_t)(c1 - 1) * NF + F_T] + tab[(size_t)(c1 - 1) * NF + F_ROWS];
  int c = c0;
  for (long long row = lo + warp; row < hi; row += n_warps) {
    while (c + 1 < c1 && tab[(size_t)(c + 1) * NF + F_T] <= row) ++c;  // rows only grow
    const Chrom h = chrom(tab, c);
    const long long i = row - h.t;
    const long long g = h.uoff + i < h.utop ? h.uoff + i : h.utop;
    const float* ur = u.p[c] + g * h.ustride;
    uint32_t* br = bits + h.bits + i * h.words;
    for (long long w0 = 0; w0 < h.words; w0 += KU) {
      bool keep[KU];
#pragma unroll
      for (int k = 0; k < KU; ++k) {
        const long long col = 32 * (w0 + k) + lane;
        keep[k] = col < h.width && ur[col] < thr;
      }
#pragma unroll
      for (int k = 0; k < KU; ++k) {
        const uint32_t word = __ballot_sync(FULL, keep[k]);
        if (lane == 0 && w0 + k < h.words) br[w0 + k] = word;
      }
    }
  }
}

// ---------------------------------------------------------- shared loaders
// This thread's 32 entries of the 64 x 64 block of x at rows r0.., columns
// k0..: row (warp / 2) + 2i, column 32 (warp % 2) + lane, as f32 (zero past
// the table), and with dropout the keep word of row (warp / 2) + 2 lane for
// the warp's 32 columns (each lane's bit is its own column's).
template <typename XT>
__device__ __forceinline__ void load_x(const Chrom& h, long long r0, long long k0, bool masked,
                                       const uint32_t* __restrict__ bits, float (&v)[32],
                                       uint32_t& word) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long col = k0 + 32 * (w & 1) + lane;
  const XT* x = static_cast<const XT*>(h.x);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const long long r = r0 + (w >> 1) + 2 * i;
    v[i] = (r < h.rows && col < h.width) ? to_f(x[r * h.width + col]) : 0.f;
  }
  word = 0u;
  if (masked) {
    const long long r = r0 + (w >> 1) + 2 * lane;
    const long long wi = (k0 >> 5) + (w & 1);
    if (r < h.rows && wi < h.words) word = bits[h.bits + r * h.words + wi];
  }
}

// entry i of load_x's block as the chain computes it in f32: kept and
// scaled, or zero
__device__ __forceinline__ float masked_x(float v, uint32_t word, int i, bool masked, float scale) {
  if (!masked) return v;
  const uint32_t wd = __shfl_sync(FULL, word, i);
  return (wd >> (threadIdx.x & 31)) & 1u ? v * scale : 0.f;
}

// The 64 x 64 block at rows k0.. of a (n_rows x d) f32 matrix, zero past
// n_rows and past column d: this thread's four 8-column groups, e = i * 128 +
// tid: row (e % 8) + 8 ((e / 8) % 8), group e / 64 (so the 8 lanes of a
// quarter-warp hold one 8 x 8 core matrix: one 128-byte store).
__device__ __forceinline__ void group_of(int i, int& r, int& g) {
  const int e = i * NT + threadIdx.x;
  r = (e & 7) + 8 * ((e >> 3) & 7);
  g = e >> 6;
}

__device__ __forceinline__ void load_w(const float* __restrict__ w, long long n_rows, int d,
                                       long long k0, float4 (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, g;
    group_of(i, r, g);
    if (k0 + r < n_rows && 8 * g < d) {
      const float4* p = reinterpret_cast<const float4*>(w + (k0 + r) * d + 8 * g);
      v[2 * i] = p[0];
      v[2 * i + 1] = p[1];
    } else {
      v[2 * i] = v[2 * i + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// load_w's block into a bf16 tile [r][c] (the canonical layout)
__device__ __forceinline__ void store_w_tc(bf16* tile, const float4 (&v)[8]) {
  using mma_bf16::pack_bf16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, g;
    group_of(i, r, g);
    const float4 a = v[2 * i], b = v[2 * i + 1];
    *reinterpret_cast<uint4*>(tile + blk(r, 8 * g)) =
        make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                   pack_bf16(b.z, b.w));
  }
}

// load_w's block into an f32 tile [r][c], row stride LDF; T: transposed
// ([c][r])
template <bool T>
__device__ __forceinline__ void store_w_f32(float* tile, const float4 (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, g;
    group_of(i, r, g);
    const float e[8] = {v[2 * i].x,     v[2 * i].y,     v[2 * i].z,     v[2 * i].w,
                        v[2 * i + 1].x, v[2 * i + 1].y, v[2 * i + 1].z, v[2 * i + 1].w};
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (T)
        tile[(8 * g + u) * LDF + r] = e[u];
      else
        tile[r * LDF + 8 * g + u] = e[u];
    }
  }
}

// the 64 rows at row r0 of a (n_rows x d) f32 matrix, zero past n_rows and
// past column d, into an f32 tile [r][c]
__device__ __forceinline__ void rows_to_tile_f32(float* tile, const float* __restrict__ src,
                                                 long long r0, long long n_rows, int d) {
  float4 v[8];
  load_w(src, n_rows, d, r0, v);
  store_w_f32<false>(tile, v);
}

// ------------------------------------------------------ tensor-core route
// acc layout (mma_bf16.cuh): entry k of thread (warp q, lane) is row 16q +
// lane/4 + 8 ((k >> 1) & 1), column 8 (k >> 2) + 2 (lane % 4) + (k & 1)

// A fragment (16 x 16 at rows m0.., depth kk..) of the staged x, row-major
// with row stride LDX; KM: the tile holds A^T ([k][m])
template <bool KM>
__device__ __forceinline__ void load_a_x(uint32_t (&a)[4], const bf16* A, int kk, int m0,
                                         int lane) {
  const int j = lane >> 3, r = lane & 7;
  if (KM)
    mma_bf16::ldsm_x4_t(a, A + (kk + r + 8 * (j >> 1)) * LDX + m0 + 8 * (j & 1));
  else
    mma_bf16::ldsm_x4(a, A + (m0 + (lane & 15)) * LDX + kk + 8 * (lane >> 4));
}

template <bool KM, bool B_KN>
__device__ __forceinline__ void issue_x(float (&acc)[32], uint32_t (&a)[4][4], const bf16* A,
                                        const bf16* B, bool accumulate, int q, int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) load_a_x<KM>(a[ks], A, 16 * ks, 16 * q, lane);
  mma_bf16::wg_issue_a<B_KN, 64>(acc, a, B, 0, accumulate);
}

// ---------------------------------------------------- staged tile loads
// The tensor-core kernels read x, dH and T through a ring of NS stages that
// cp.async fills NS - 1 tiles ahead, so a block keeps several tiles' bytes in
// flight without holding them in registers.  A row of x may start at any
// element (a chromosome's width is any number of bins), so a stage holds
// each row's 16-byte chunks from the one its first column falls in: TM / EPC
// + 1 chunks, the row's columns from element `mis` on.  Chunks past the
// table's end are zero-filled, never read.

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(mma_bf16::smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(mma_bf16::smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a stage's x block: TM rows of CPR chunks, then the rows' two keep words
template <typename XT>
struct XStage {
  static constexpr int ES = sizeof(XT);
  static constexpr int EPC = 16 / ES;          // elements a chunk
  static constexpr int CPR = TM / EPC + 1;     // chunks a row
  static constexpr int ROW = CPR * 16;         // bytes a row
  static constexpr int BITS = TM * ROW;        // byte of the keep words
  static constexpr int BYTES = BITS + TM * 2 * 4;
};

// where column k0 of row r lies in the row's staged chunks, in elements
template <typename XT>
__device__ __forceinline__ int x_mis(const Chrom& h, long long r, long long k0) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(h.x) + (r * h.width + k0) * sizeof(XT);
  return (int)((a & 15) / sizeof(XT));
}

// issue the copies of the 64 x 64 block of x at rows r0.., columns k0.. (and
// with dropout its keep words) into stage st
template <typename XT>
__device__ __forceinline__ void stage_x(char* st, const Chrom& h, long long r0, long long k0,
                                        bool masked, const uint32_t* __restrict__ bits) {
  using S = XStage<XT>;
  const char* xb = static_cast<const char*>(h.x);
  const char* end = xb + h.rows * h.width * S::ES;
  const char* base = reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(xb) & ~(uintptr_t)15);
  for (int e = threadIdx.x; e < TM * S::CPR; e += NT) {
    const int i = e / S::CPR, ch = e - i * S::CPR;
    const long long r = r0 + i;
    const char* src = base;  // an aligned address for a copy of nothing
    int n = 0;
    if (r < h.rows) {
      const uintptr_t first = reinterpret_cast<uintptr_t>(xb + (r * h.width + k0) * S::ES);
      const char* c = reinterpret_cast<const char*>((first & ~(uintptr_t)15) + 16 * ch);
      if (c < end) {
        src = c;
        n = end - c < 16 ? (int)(end - c) : 16;
      }
    }
    cp_async16_zfill(st + i * S::ROW + 16 * ch, src, n);
  }
  if (masked) {  // NT == 2 TM: a word each
    const int i = threadIdx.x >> 1;
    const long long r = r0 + i, wi = (k0 >> 5) + (threadIdx.x & 1);
    const bool ok = r < h.rows && wi < h.words;
    cp_async4_zfill(st + S::BITS + 4 * threadIdx.x, ok ? bits + h.bits + r * h.words + wi : bits,
                    ok ? 4 : 0);
  }
}

// stage st's x block, rounded to bf16, kept and scaled as the eager chain
// does, into xs (row-major, row stride LDX); zero past the table
template <typename XT>
__device__ __forceinline__ void convert_x(const char* st, bf16* xs, const Chrom& h, long long r0,
                                          long long k0, bool masked, float scale) {
  using S = XStage<XT>;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int col = 32 * (w & 1) + lane;
  const bool in_col = k0 + col < h.width;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(st + S::BITS);
#pragma unroll 8
  for (int i = 0; i < 32; ++i) {
    const int ri = (w >> 1) + 2 * i;
    const long long r = r0 + ri;
    float v = 0.f;
    if (r < h.rows && in_col) {
      const XT* row = reinterpret_cast<const XT*>(st + ri * S::ROW);
      v = rb(to_f(row[x_mis<XT>(h, r, k0) + col]));
      if (masked) v = (words[2 * ri + (w & 1)] >> lane) & 1u ? v * scale : 0.f;
    }
    xs[ri * LDX + col] = __float2bfloat16_rn(v);
  }
}

// issue the copies of rows r0.. of a (n_rows x d) bf16 matrix into a tile in
// the canonical layout, zero past n_rows and past column d (d % 16 == 0, so
// every 8-column group is 16-byte aligned)
__device__ __forceinline__ void stage_rows(bf16* tile, const bf16* __restrict__ src, long long r0,
                                           long long n_rows, int d) {
#pragma unroll
  for (int k = 0; k < TM * 8 / NT; ++k) {
    const int e = k * NT + threadIdx.x, i = e >> 3, g = e & 7;
    const bool ok = r0 + i < n_rows && 8 * g < d;
    cp_async16_zfill(tile + blk(i, 8 * g), ok ? src + (r0 + i) * d + 8 * g : src, ok ? 16 : 0);
  }
}

// the accumulator's tile rows r < n_valid, columns < d, into a (rows x d)
// matrix at row `row0` (bf16 or f32)
__device__ __forceinline__ void acc_out(const float (&acc)[32], bf16* dst, long long row0,
                                        long long n_valid, int d, int q, int fg, int fc) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * q + fg + 8 * hh;
    if (r >= n_valid) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * j < d)
        *reinterpret_cast<__nv_bfloat162*>(dst + (row0 + r) * d + 8 * j + 2 * fc) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

__device__ __forceinline__ void acc_out(const float (&acc)[32], float* dst, long long row0,
                                        long long n_valid, int d, int q, int fg, int fc) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * q + fg + 8 * hh;
    if (r >= n_valid) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * j < d)
        *reinterpret_cast<float2*>(dst + (row0 + r) * d + 8 * j + 2 * fc) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

// the tensor-core kernels' shared memory: the fixed tiles, then the ring's
// stages, each ring as deep as three forward blocks (two with f32 x) or two
// backward blocks a multiprocessor leave room for (deeper rings, or wider
// stages, with fewer blocks read x slower at a 10 kb rank's shapes on the
// H100)
constexpr int TC_FIXED = TM * LDX * 2 + 2 * mma_bf16::TILE * 2;
constexpr int NS_FWD = 4;
template <typename XT>
struct TcSmem {
  static constexpr int FWD = TC_FIXED + NS_FWD * XStage<XT>::BYTES;
  static constexpr int NS_BWD = sizeof(XT) == 2 ? 3 : 2;
  static constexpr int BWD_STAGE = XStage<XT>::BYTES + 2 * mma_bf16::TILE * 2;  // x, dH, T
  static constexpr int BWD = TC_FIXED + NS_BWD * BWD_STAGE;
};

template <typename XT>
__global__ void __launch_bounds__(NT, 3)
    fwd_tc_kernel(const long long* __restrict__ tab, const long long* __restrict__ tiles,
                  const uint32_t* __restrict__ bits, float scale, int masked, int d,
                  bf16* __restrict__ out, bf16* __restrict__ tsave, int zero_row) {
  extern __shared__ __align__(1024) char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = xs + TM * LDX;
  bf16* w2s = ws + mma_bf16::TILE;
  char* stages = reinterpret_cast<char*>(w2s + mma_bf16::TILE);
  constexpr int SB = XStage<XT>::BYTES;
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5, fg = lane >> 2, fc = lane & 3;
  const Chrom h = chrom(tab, (int)tiles[2 * blockIdx.x]);
  const long long r0 = tiles[2 * blockIdx.x + 1] * TM;
  const long long nk = (h.width + TM - 1) / TM;
#pragma unroll
  for (int k = 0; k < NS_FWD - 1; ++k) {
    if (k < nk) stage_x<XT>(stages + k * SB, h, r0, (long long)k * TM, masked, bits);
    mma_bf16::cp_async_commit();
  }
  if (zero_row && blockIdx.x == 0)
    for (int i = threadIdx.x; i < d; i += NT) out[i] = __float2bfloat16_rn(0.f);
  float4 wv[8];
  load_w(h.w2, d, d, 0, wv);
  store_w_tc(w2s, wv);
  load_w(h.w1, h.width, d, 0, wv);
  float acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.f;
  uint32_t a[4][4];
  for (long long kc = 0; kc < nk; ++kc) {
    cp_async_wait<NS_FWD - 2>();  // this thread's copies of block kc
    __syncthreads();  // everyone's; the last block's product has read xs and ws
    if (kc + NS_FWD - 1 < nk)  // into the stage block kc - 1 was read from
      stage_x<XT>(stages + ((kc + NS_FWD - 1) % NS_FWD) * SB, h, r0, (kc + NS_FWD - 1) * TM,
                  masked, bits);
    mma_bf16::cp_async_commit();
    convert_x<XT>(stages + (kc % NS_FWD) * SB, xs, h, r0, kc * TM, masked, scale);
    store_w_tc(ws, wv);
    mma_bf16::async_fence();
    __syncthreads();
    if (kc + 1 < nk) load_w(h.w1, h.width, d, (kc + 1) * TM, wv);  // under this product
    issue_x<false, true>(acc, a, xs, ws, kc > 0, q, lane);
    mma_bf16::wg_wait(acc);
  }
  // T = tanh(round(X~ W1)), rounded: the eager chain's bf16 product and tanh
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = rb(tanhf(rb(acc[k])));
  if (tsave) acc_out(acc, tsave, h.t + r0, h.rows - r0, d, q, fg, fc);
  mma_bf16::acc_to_a(acc, a);
  float o[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) o[k] = 0.f;
  mma_bf16::wg_issue_a<true, 64>(o, a, w2s, 0, false);
  mma_bf16::wg_wait(o);
  acc_out(o, out, h.out + r0, h.rows - r0, d, q, fg, fc);
}

// The backward's blocks, each over its chromosome's row tiles through the
// ring (a stage: x's block and its keep words, dH's and T's rows).  (c, jt
// >= 0): rows 64 jt.. of dW1_c; per row tile, G = round(round(dH W2^T) (1 -
// T^2)) into gs, X~ into xs, dW1 += X~^T G.  (c, -1): dW2_c = sum over row
// tiles of T^T dH.
template <typename XT>
__global__ void __launch_bounds__(NT, 2)
    bwd_tc_kernel(const long long* __restrict__ tab, const long long* __restrict__ tiles,
                  const uint32_t* __restrict__ bits, float scale, int masked, int d,
                  const bf16* __restrict__ dout, const bf16* __restrict__ tsave,
                  float* __restrict__ grad) {
  extern __shared__ __align__(1024) char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* gs = xs + TM * LDX;
  bf16* w2s = gs + mma_bf16::TILE;
  char* stages = reinterpret_cast<char*>(w2s + mma_bf16::TILE);
  using M = TcSmem<XT>;
  constexpr int NS = M::NS_BWD, SB = M::BWD_STAGE, XB = XStage<XT>::BYTES;
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5, fg = lane >> 2, fc = lane & 3;
  const Chrom h = chrom(tab, (int)tiles[2 * blockIdx.x]);
  const long long jt = tiles[2 * blockIdx.x + 1];
  const long long j0 = jt < 0 ? 0 : jt * TM;
  const long long n_rt = (h.rows + TM - 1) / TM;
  const bf16* dh_rows = dout + h.out * d;
  const bf16* t_rows = tsave + h.t * d;
  // stage k: row tile k's x block (dW1 blocks), dH rows and T rows
  auto fill = [&](char* st, long long rt) {
    if (jt >= 0) stage_x<XT>(st, h, rt * TM, j0, masked, bits);
    stage_rows(reinterpret_cast<bf16*>(st + XB), dh_rows, rt * TM, h.rows, d);
    stage_rows(reinterpret_cast<bf16*>(st + XB) + mma_bf16::TILE, t_rows, rt * TM, h.rows, d);
  };
#pragma unroll
  for (int k = 0; k < NS - 1; ++k) {
    if (k < n_rt) fill(stages + k * SB, k);
    mma_bf16::cp_async_commit();
  }
  float acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.f;
  uint32_t a[4][4];
  if (jt >= 0) {
    float4 wv[8];
    load_w(h.w2, d, d, 0, wv);
    store_w_tc(w2s, wv);
    mma_bf16::async_fence();
  }
  for (long long rt = 0; rt < n_rt; ++rt) {
    cp_async_wait<NS - 2>();
    mma_bf16::async_fence();  // the copies -> visible to wgmma after the barrier
    __syncthreads();  // stage rt is in; the last tile's products are done
    if (rt + NS - 1 < n_rt) fill(stages + ((rt + NS - 1) % NS) * SB, rt + NS - 1);
    mma_bf16::cp_async_commit();
    const char* st = stages + (rt % NS) * SB;
    const bf16* dh = reinterpret_cast<const bf16*>(st + XB);
    const bf16* tt = dh + mma_bf16::TILE;
    if (jt < 0) {
      // dW2 += T^T dH: A (m, k = row) = T[row][m], the tile [k][m]
      mma_bf16::wg_issue<true, true, 64>(acc, a, tt, dh, 0, rt > 0, q, lane);
      mma_bf16::wg_wait(acc);
      continue;
    }
    // G = dH W2^T: A = dH [m][k], B (k, n) = W2[n][k], the tile [n][k]; X~
    // into xs while it runs
    float g[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) g[k] = 0.f;
    mma_bf16::wg_issue<false, false, 64>(g, a, dh, w2s, 0, false, q, lane);
    convert_x<XT>(st, xs, h, rt * TM, j0, masked, scale);
    mma_bf16::wg_wait(g);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * q + fg + 8 * hh;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 t = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(tt + blk(r, 8 * j + 2 * fc)));
        const int k = 4 * j + 2 * hh;
        g[k] = rb(rb(g[k]) * (1.f - t.x * t.x));
        g[k + 1] = rb(rb(g[k + 1]) * (1.f - t.y * t.y));
      }
    }
    mma_bf16::store_bf16(g, gs, q, fg, fc);
    mma_bf16::async_fence();
    __syncthreads();  // xs and gs are whole
    // dW1 += X~^T G: A (m = column, k = row) = X~[row][m], xs holds [k][m]
    issue_x<true, true>(acc, a, xs, gs, rt > 0, q, lane);
    mma_bf16::wg_wait(acc);
  }
  if (jt < 0)
    acc_out(acc, grad + h.gw2, 0, d, d, q, fg, fc);
  else
    acc_out(acc, grad + h.gw1 + j0 * d, 0, h.width - j0, d, q, fg, fc);
}

// -------------------------------------------------------- CUDA-core route
// acc[4i + j] is row tm + 8i, column tn + 16j (tm = tid / 16, tn = tid % 16)

// acc += A B over depth 64, A (m, k) = a[m AM + k AK], B (k, n) = b[k BK + n
// BN], the sum over k in order
template <int AM, int AK, int BK, int BN>
__device__ __forceinline__ void fma_tile(float (&acc)[32], const float* a, const float* b, int tm,
                                         int tn) {
#pragma unroll 4
  for (int k = 0; k < TM; ++k) {
    float av[8], bv[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) av[i] = a[(tm + 8 * i) * AM + k * AK];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[k * BK + (tn + 16 * j) * BN];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[4 * i + j] = fmaf(av[i], bv[j], acc[4 * i + j]);
  }
}

__device__ __forceinline__ void store_x_f32(float* xs, const float (&v)[32], uint32_t word,
                                            bool masked, float scale) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int col = 32 * (w & 1) + lane;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    xs[((w >> 1) + 2 * i) * LDF + col] = masked_x(v[i], word, i, masked, scale);
}

// rows tm + 8i (< n_valid) and columns tn + 16j (< d) of an accumulator
// into a (rows x d) f32 matrix at row `row0`
__device__ __forceinline__ void fma_out(const float (&acc)[32], float* dst, long long row0,
                                        long long n_valid, int d, int tm, int tn) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tm + 8 * i;
    if (r >= n_valid) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (tn + 16 * j < d) dst[(row0 + r) * d + tn + 16 * j] = acc[4 * i + j];
  }
}

template <typename XT>
__global__ void __launch_bounds__(NT)
    fwd_f32_kernel(const long long* __restrict__ tab, const long long* __restrict__ tiles,
                   const uint32_t* __restrict__ bits, float scale, int masked, int d,
                   float* __restrict__ out, float* __restrict__ tsave, int zero_row) {
  __shared__ float xs[TM * LDF];
  __shared__ float ws[TM * LDF];
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  const Chrom h = chrom(tab, (int)tiles[2 * blockIdx.x]);
  const long long r0 = tiles[2 * blockIdx.x + 1] * TM;
  if (zero_row && blockIdx.x == 0)
    for (int i = threadIdx.x; i < d; i += NT) out[i] = 0.f;
  float xv[32];
  uint32_t word;
  float4 wv[8];
  load_x<XT>(h, r0, 0, masked, bits, xv, word);
  load_w(h.w1, h.width, d, 0, wv);
  float acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.f;
  const long long nk = (h.width + TM - 1) / TM;
  for (long long kc = 0; kc < nk; ++kc) {
    __syncthreads();
    store_x_f32(xs, xv, word, masked, scale);
    store_w_f32<false>(ws, wv);
    __syncthreads();
    if (kc + 1 < nk) {
      load_x<XT>(h, r0, (kc + 1) * TM, masked, bits, xv, word);
      load_w(h.w1, h.width, d, (kc + 1) * TM, wv);
    }
    fma_tile<LDF, 1, LDF, 1>(acc, xs, ws, tm, tn);
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = tanhf(acc[k]);
  if (tsave) fma_out(acc, tsave, h.t + r0, h.rows - r0, d, tm, tn);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) xs[(tm + 8 * i) * LDF + tn + 16 * j] = acc[4 * i + j];
  load_w(h.w2, d, d, 0, wv);
  store_w_f32<false>(ws, wv);
  __syncthreads();
  float o[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) o[k] = 0.f;
  fma_tile<LDF, 1, LDF, 1>(o, xs, ws, tm, tn);
  fma_out(o, out, h.out + r0, h.rows - r0, d, tm, tn);
}

template <typename XT>
__global__ void __launch_bounds__(NT)
    bwd_f32_kernel(const long long* __restrict__ tab, const long long* __restrict__ tiles,
                   const uint32_t* __restrict__ bits, float scale, int masked, int d,
                   const float* __restrict__ dout, const float* __restrict__ tsave,
                   float* __restrict__ grad) {
  __shared__ float xs[TM * LDF];   // X~ (dW1 blocks); T (dW2)
  __shared__ float gs[TM * LDF];   // dH, then G (dW1 blocks); dH (dW2)
  __shared__ float w2t[TM * LDF];  // W2^T (dW1 blocks)
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  const Chrom h = chrom(tab, (int)tiles[2 * blockIdx.x]);
  const long long jt = tiles[2 * blockIdx.x + 1];
  const long long n_rt = (h.rows + TM - 1) / TM;
  float acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.f;

  if (jt < 0) {
    for (long long rt = 0; rt < n_rt; ++rt) {
      __syncthreads();
      rows_to_tile_f32(xs, tsave + h.t * d, rt * TM, h.rows, d);
      rows_to_tile_f32(gs, dout + h.out * d, rt * TM, h.rows, d);
      __syncthreads();
      // dW2 += T^T dH: A (m, k = row) = T[row][m]
      fma_tile<1, LDF, LDF, 1>(acc, xs, gs, tm, tn);
    }
    fma_out(acc, grad + h.gw2, 0, d, d, tm, tn);
    return;
  }

  const long long j0 = jt * TM;
  float4 wv[8];
  load_w(h.w2, d, d, 0, wv);
  store_w_f32<true>(w2t, wv);  // w2t[k][n] = W2[n][k]
  float xv[32];
  uint32_t word;
  load_x<XT>(h, 0, j0, masked, bits, xv, word);
  for (long long rt = 0; rt < n_rt; ++rt) {
    const long long r0 = rt * TM;
    __syncthreads();
    rows_to_tile_f32(gs, dout + h.out * d, r0, h.rows, d);
    store_x_f32(xs, xv, word, masked, scale);
    __syncthreads();
    if (rt + 1 < n_rt) load_x<XT>(h, r0 + TM, j0, masked, bits, xv, word);
    float g[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) g[k] = 0.f;
    fma_tile<LDF, 1, LDF, 1>(g, gs, w2t, tm, tn);  // dH W2^T
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long r = r0 + tm + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tn + 16 * j;
        const float t = (r < h.rows && n < d) ? tsave[(h.t + r) * d + n] : 0.f;
        g[4 * i + j] *= 1.f - t * t;
      }
    }
    __syncthreads();  // every thread has read dH
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) gs[(tm + 8 * i) * LDF + tn + 16 * j] = g[4 * i + j];
    __syncthreads();
    // dW1 += X~^T G: A (m = column, k = row) = X~[row][m]
    fma_tile<1, LDF, LDF, 1>(acc, xs, gs, tm, tn);
  }
  fma_out(acc, grad + h.gw1 + j0 * d, 0, h.width - j0, d, tm, tn);
}

int grid_cap() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132 * 16;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132 * 16;
  return (sms > 0 ? sms : 132) * 16;
}

// a tensor-core kernel with `smem` bytes of dynamic shared memory (more than
// the 48 KB a launch gets unasked)
template <typename... P, typename... A>
void launch_tc(void (*kernel)(P...), int smem, int n_tiles, cudaStream_t st, A... args) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return;  // the error is cudaGetLastError's
  kernel<<<n_tiles, NT, smem, st>>>(args...);
}

}  // namespace

// The keep bits of chromosomes [c0, c1): u[c] the draw of chromosome c (f32,
// rows of ustride floats); total_words = the sum of their rows x words.
extern "C" int matcha_node_encode_keep(const void* tab, int c0, int c1, const void* const* u,
                                       float thr, void* bits, long long total_words,
                                       void* stream) {
  if (c0 < 0 || c1 > MAXC || c0 > c1 || total_words < 0) return (int)cudaErrorInvalidValue;
  if (total_words == 0) return 0;
  UPtrs p;
  for (int c = 0; c < MAXC; ++c) p.p[c] = (c >= c0 && c < c1) ? static_cast<const float*>(u[c]) : nullptr;
  const long long want = (total_words + 8 * KU - 1) / (8 * KU);  // 8 warps a block, a row a warp
  const int grid = (int)(want < grid_cap() ? want : grid_cap());
  keep_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(tab), c0, c1, p, thr, static_cast<uint32_t*>(bits));
  return (int)cudaGetLastError();
}

// The node rows of every forward tile: out (rows x d) in the compute dtype
// (bf16 when is_bf16, else f32), T into tsave (the same dtype) unless it is
// null; the features are bf16 when x_bf16, else f32.  zero_row: block 0 also
// writes row 0 of out as zeros.
extern "C" int matcha_node_encode_fwd(const void* tab, const void* tiles, int n_tiles,
                                      const void* bits, float scale, int masked, int d,
                                      int is_bf16, int x_bf16, void* out, void* tsave,
                                      int zero_row, void* stream) {
  if (n_tiles < 0 || d < 16 || d > 64 || d % 16 || (masked && !bits))
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* tb = static_cast<const long long*>(tab);
  const long long* tl = static_cast<const long long*>(tiles);
  const uint32_t* bt = static_cast<const uint32_t*>(bits);
  if (is_bf16) {
    bf16* o = static_cast<bf16*>(out);
    bf16* t = static_cast<bf16*>(tsave);
    if (x_bf16)
      launch_tc(fwd_tc_kernel<bf16>, TcSmem<bf16>::FWD, n_tiles, st, tb, tl, bt, scale, masked, d,
                o, t, zero_row);
    else
      launch_tc(fwd_tc_kernel<float>, TcSmem<float>::FWD, n_tiles, st, tb, tl, bt, scale, masked,
                d, o, t, zero_row);
  } else {
    float* o = static_cast<float*>(out);
    float* t = static_cast<float*>(tsave);
    if (x_bf16)
      fwd_f32_kernel<bf16><<<n_tiles, NT, 0, st>>>(tb, tl, bt, scale, masked, d, o, t, zero_row);
    else
      fwd_f32_kernel<float><<<n_tiles, NT, 0, st>>>(tb, tl, bt, scale, masked, d, o, t, zero_row);
  }
  return (int)cudaGetLastError();
}

// dW1 and dW2 of every chromosome into grad (f32, at each one's F_GW1 /
// F_GW2) from dout (the forward's output rows' gradient) and tsave, both in
// the compute dtype.
extern "C" int matcha_node_encode_bwd(const void* tab, const void* tiles, int n_tiles,
                                      const void* bits, float scale, int masked, int d,
                                      int is_bf16, int x_bf16, const void* dout,
                                      const void* tsave, void* grad, void* stream) {
  if (n_tiles < 0 || d < 16 || d > 64 || d % 16 || (masked && !bits) || !tsave)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* tb = static_cast<const long long*>(tab);
  const long long* tl = static_cast<const long long*>(tiles);
  const uint32_t* bt = static_cast<const uint32_t*>(bits);
  float* g = static_cast<float*>(grad);
  if (is_bf16) {
    const bf16* go = static_cast<const bf16*>(dout);
    const bf16* t = static_cast<const bf16*>(tsave);
    if (x_bf16)
      launch_tc(bwd_tc_kernel<bf16>, TcSmem<bf16>::BWD, n_tiles, st, tb, tl, bt, scale, masked, d,
                go, t, g);
    else
      launch_tc(bwd_tc_kernel<float>, TcSmem<float>::BWD, n_tiles, st, tb, tl, bt, scale, masked,
                d, go, t, g);
  } else {
    const float* go = static_cast<const float*>(dout);
    const float* t = static_cast<const float*>(tsave);
    if (x_bf16)
      bwd_f32_kernel<bf16><<<n_tiles, NT, 0, st>>>(tb, tl, bt, scale, masked, d, go, t, g);
    else
      bwd_f32_kernel<float><<<n_tiles, NT, 0, st>>>(tb, tl, bt, scale, masked, d, go, t, g);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* matcha_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
