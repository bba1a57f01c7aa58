// Node-table gather gradient (scatter-add) and token bincount, for NVIDIA
// Hopper (sm_90a).
//
// scatter_add replaces the TPU kernel matcha_tpu/ops/table_scatter.py:
// _scatter_kernel (through scatter_add_matmul): for g (T, d) in f32 or bf16
// and idx (T,) int32 it writes out (n_rows, d) f32 with
//   out[r] = sum over t with idx[t] == r of g[t].
// The TPU kernel builds a one-hot matrix and runs the sum on its matrix unit,
// because a random read-modify-write is slow there.  Here the tokens are
// grouped by row first (a deterministic CSR: compressed sparse rows), then
// each row's tokens are summed by one warp with 16-byte loads:
//   1. count   blocks over contiguous token chunks histogram their chunk
//              (integer atomics into a shared histogram, exact);
//   2. colscan one thread per row: the exclusive prefix of its counts over
//              the chunks, and the row's total;
//   3. place   per chunk block: the row starts (a block scan of the totals),
//              then each warp walks its contiguous part of the chunk in token
//              order, ranks equal rows with __match_any_sync and writes every
//              token's id and row at a slot fixed by (row, chunk, warp, lane):
//              a stable counting sort, so each row's tokens stand in token
//              order;
//   4. sum     one warp per piece of PIECE sorted slots: lane groups of
//              d/VEC lanes read a token's g row with 16-byte loads (a 64-wide
//              bf16 row is 8 lanes, so a warp takes 4 tokens at a time),
//              combine the groups in a fixed shuffle tree and write each row
//              whose tokens all lie in the piece once; a row that crosses a
//              piece boundary (a hub node) leaves its per-piece partials;
//   5. fixup   one warp per row: zeros for an empty row, and the sum of the
//              partials of a row that spans pieces, in piece order.
// No float atomics anywhere: the result is the same bits on every run.  Ids
// outside [0, n_rows) are dropped, as the TPU kernel's one-hot compare drops
// them.  Scratch (counts, row starts, the sorted ids and rows, the partials)
// comes from the caller; matcha_scatter_add_scratch_bytes gives its size.
// Bound on this card: bytes, g read once (T*d*2 B in bf16), out written once
// (n_rows*d*4 B), idx read once: 15.9 MB at the step's T = 114,688,
// n_rows = 3,068, d = 64 -> 4.75 us at 3.35 TB/s; the T*d adds are
// negligible.  The sort's own traffic (ids and rows, 8 bytes a token) and
// the five launches are what this design pays above the bound.
//
// bincount replaces _count_kernel (through bincount_f32): counts of each id
// in idx (T,) as (n_rows,) f32, ids outside [0, n_rows) dropped as in
// scatter_add.  Bound on this card: bytes, idx read once (T*4 B) and the
// counts written once (n_rows*4 B): 0.47 MB at the step's T = 114,688,
// n_rows = 3,068 -> 0.14 us at 3.35 TB/s, far below what one launch costs;
// so the design is one launch and nothing else: no memset, no int scratch,
// no conversion pass, no float atomics.  One thread-block cluster (16 blocks
// where the card schedules a cluster that wide, else 8), each block reading a
// contiguous chunk of idx in 16-byte vectors, one integer shared-memory
// atomic per id (merging a warp's equal ids first with __match_any_sync, or
// spreading a block's lanes over copies of its histogram, both measured
// slower on the card, hub rows included):
//   local route (n_rows <= BC_LOCAL_ROWS): each block counts its chunk into
//     its own whole histogram; behind a cluster barrier, block b sums its
//     band of rows over the blocks' histograms in rank order through
//     distributed shared memory and writes the f32 counts;
//   banded route (larger n_rows): the blocks' shared memories hold one
//     histogram together, BC_BAND rows per block per pass; every id adds
//     into the block that owns its row (a distributed-shared-memory
//     atomic), and each block writes its band once the cluster has met.
//     Tables beyond 16 * BC_BAND rows take several passes over idx.
// Integer counts are exact, so the result is the same bits on every run.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;           // threads per block (count, place, bincount)
constexpr int NWARP = NT / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_D = 1536;       // widest g row scatter_add takes
// the place kernel keeps one histogram per warp: NWARP * n_rows ints in
// shared memory up to this many rows (192 KB), else in global scratch
constexpr int SHARED_ROWS = 6144;
constexpr int MIN_CHUNK = 1024;   // tokens per chunk, at least
constexpr int MAX_CHUNKS = 64;
constexpr long long GLOBAL_HIST_INTS = 1LL << 22;  // cap of the global per-warp histograms
constexpr int PIECE = 128;        // sorted slots per warp of the sum kernel
constexpr int SUM_WARPS = 4;      // warps per block of the sum kernel
constexpr int PRE = 8;            // token steps whose loads are in flight at once

__device__ __forceinline__ bool in_range(int r, int n) { return (unsigned)r < (unsigned)n; }

// ------------------------------------------------------------------ the plan
struct Plan {
  int n_chunks, chunk, shared_hist, n_pieces;
  long long cnt, total, row_ptr, perm_tok, perm_row, ghist, head, tail, bytes;  // byte offsets
};

long long align16(long long b) { return (b + 15) / 16 * 16; }

Plan make_plan(int T, int d, int n) {
  Plan p;
  long long chunks = ((long long)T + MIN_CHUNK - 1) / MIN_CHUNK;
  chunks = chunks < 1 ? 1 : (chunks > MAX_CHUNKS ? MAX_CHUNKS : chunks);
  p.shared_hist = n <= SHARED_ROWS;
  if (!p.shared_hist) {
    const long long cap = GLOBAL_HIST_INTS / ((long long)NWARP * n);
    chunks = chunks < cap ? chunks : (cap < 1 ? 1 : cap);
  }
  long long chunk = ((long long)T + chunks - 1) / chunks;
  chunk = chunk < 1 ? 1 : chunk;
  p.chunk = (int)chunk;
  p.n_chunks = T == 0 ? 1 : (int)(((long long)T + chunk - 1) / chunk);
  p.n_pieces = (int)(((long long)T + PIECE - 1) / PIECE);
  long long at = 0;
  p.cnt = at;      at = align16(at + 4LL * p.n_chunks * n);
  p.total = at;    at = align16(at + 4LL * n);
  p.row_ptr = at;  at = align16(at + 4LL * (n + 1));
  p.perm_tok = at; at = align16(at + 4LL * T);
  p.perm_row = at; at = align16(at + 4LL * T);
  p.ghist = at;    at = align16(at + (p.shared_hist ? 0 : 4LL * p.n_chunks * NWARP * n));
  p.head = at;     at = align16(at + 4LL * p.n_pieces * d);
  p.tail = at;     at = align16(at + 4LL * p.n_pieces * d);
  p.bytes = at;
  return p;
}

// ------------------------------------------------------------------ 1. count
// cnt[c][r] = tokens of chunk c with id r
__global__ void __launch_bounds__(NT)
    csr_count_kernel(const int* __restrict__ idx, int T_, int n, int chunk,
                     int* __restrict__ cnt, int shared_hist) {
  extern __shared__ int sh[];
  int* h = shared_hist ? sh : cnt + (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += NT) h[i] = 0;
  __syncthreads();
  const long long t0 = (long long)blockIdx.x * chunk;
  const int t1 = (int)(t0 + chunk < T_ ? t0 + chunk : T_);
  for (int t = (int)t0 + threadIdx.x; t < t1; t += NT) {
    const int r = idx[t];
    if (in_range(r, n)) atomicAdd(&h[r], 1);
  }
  if (shared_hist) {
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += NT) cnt[(size_t)blockIdx.x * n + i] = h[i];
  }
}

// ---------------------------------------------------------------- 2. colscan
// cnt[c][r] <- sum over c' < c of cnt[c'][r]; total[r] = the row's tokens
__global__ void csr_colscan_kernel(int* __restrict__ cnt, int* __restrict__ total, int n,
                                   int n_chunks) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  int run = 0;
  for (int c0 = 0; c0 < n_chunks; c0 += 8) {
    int v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = c0 + u < n_chunks ? cnt[(size_t)(c0 + u) * n + r] : 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < n_chunks) cnt[(size_t)(c0 + u) * n + r] = run;
      run += v[u];
    }
  }
  total[r] = run;
}

// exclusive prefix over the block's threads in thread order; *sum = the total
__device__ __forceinline__ int block_exclusive_scan(int v, int* __restrict__ warp_sums, int* sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) {
    before += w < warp ? warp_sums[w] : 0;
    all += warp_sums[w];
  }
  *sum = all;
  return before + inc - v;
}

// ------------------------------------------------------------------ 3. place
__global__ void __launch_bounds__(NT)
    csr_place_kernel(const int* __restrict__ idx, int T_, int n, int chunk,
                     const int* __restrict__ cnt, const int* __restrict__ total,
                     int* __restrict__ row_ptr, int* __restrict__ perm_tok,
                     int* __restrict__ perm_row, int* __restrict__ ghist, int shared_hist) {
  extern __shared__ int sh[];
  __shared__ int warp_sums[NWARP];
  const int c = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* h = shared_hist ? sh : ghist + (size_t)c * NWARP * n;  // [NWARP][n]
  for (int i = tid; i < NWARP * n; i += NT) h[i] = 0;
  __syncthreads();

  const long long c0 = (long long)c * chunk;
  const int t0 = (int)(c0 < T_ ? c0 : T_);
  const int t1 = (int)(c0 + chunk < T_ ? c0 + chunk : T_);
  const int sub = (chunk + NWARP - 1) / NWARP;
  const int w0 = (int)((long long)t0 + (long long)warp * sub < t1 ? t0 + warp * sub : t1);
  const int w1 = (int)((long long)w0 + sub < t1 ? w0 + sub : t1);
  int* hw = h + (size_t)warp * n;
  const unsigned lt = (1u << lane) - 1u;

  // a. each warp counts the ids of its part: the group leader adds its size
  for (int base = w0; base < w1; base += 32) {
    const int t = base + lane;
    const int r = t < w1 ? idx[t] : -1;
    const bool ok = in_range(r, n);
    const unsigned m = __match_any_sync(FULL, ok ? r : -1);
    if (ok && (m & lt) == 0) hw[r] += __popc(m);
    __syncwarp();
  }
  __syncthreads();

  // b. row starts (exclusive scan of the totals; thread i owns rows
  //    [i*k, i*k + k)), then each warp's first slot for each row:
  //    row start + earlier chunks' tokens of the row + earlier warps'
  const int k = (n + NT - 1) / NT;
  const int r0 = tid * k < n ? tid * k : n;
  const int r1 = r0 + k < n ? r0 + k : n;
  int s = 0;
  for (int r = r0; r < r1; ++r) s += total[r];
  int all;
  int run = block_exclusive_scan(s, warp_sums, &all);
  for (int r = r0; r < r1; ++r) {
    if (c == 0) row_ptr[r] = run;
    int b = run + cnt[(size_t)c * n + r];
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      int* p = h + (size_t)w * n + r;
      const int v = *p;
      *p = b;
      b += v;
    }
    run += total[r];
  }
  if (c == 0 && tid == 0) row_ptr[n] = all;
  __syncthreads();

  // c. each warp walks its part again in token order: a token's slot is its
  //    row's cursor plus its rank among the equal ids of lower lanes
  for (int base = w0; base < w1; base += 32) {
    const int t = base + lane;
    const int r = t < w1 ? idx[t] : -1;
    const bool ok = in_range(r, n);
    const unsigned m = __match_any_sync(FULL, ok ? r : -1);
    const int leader = __ffs(m) - 1;
    int b = 0;
    if (ok && lane == leader) b = hw[r];
    b = __shfl_sync(FULL, b, leader);
    if (ok) {
      const int pos = b + __popc(m & lt);
      perm_tok[pos] = t;
      perm_row[pos] = r;
      if (lane == leader) hw[r] = b + __popc(m);
    }
    __syncwarp();
  }
}

// -------------------------------------------------------------------- 4. sum
template <typename T, int VEC>
struct Loader;

template <>
struct Loader<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(b[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Loader<float, 4> {
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
};

template <>
struct Loader<float, 1> {
  __device__ static void load(const float* p, float (&v)[1]) { v[0] = *p; }
};

template <>
struct Loader<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
};

// Piece p (one warp) holds the sorted slots [p*PIECE, ...) up to the valid
// count.  Lane = q * lpt + l: lane group q takes every tpw-th token, lane l
// of the group the columns [l*VEC, l*VEC + VEC) of each block of lpt*VEC
// columns.  A row's segment in the piece is summed per lane group, the
// groups are combined by a fixed xor-shuffle tree, and the sum goes to out
// (the row lies wholly in the piece), tail[p] (the row goes on past the
// piece) or head[p] (the row began before the piece and ends in it).
template <typename T, int VEC>
__global__ void __launch_bounds__(32 * SUM_WARPS)
    csr_sum_kernel(const T* __restrict__ g, int d, int lpt, const int* __restrict__ row_ptr,
                   int n, const int* __restrict__ perm_tok, const int* __restrict__ perm_row,
                   float* __restrict__ out, float* __restrict__ head, float* __restrict__ tail,
                   int n_pieces) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * SUM_WARPS + (threadIdx.x >> 5);
  if (p >= n_pieces) return;
  const int V = row_ptr[n];
  const int a = p * PIECE;
  if (a >= V) return;
  const int b = a + PIECE < V ? a + PIECE : V;
  const int tpw = 32 / lpt, q = lane / lpt, l = lane % lpt;
  const int prev_row = a > 0 ? perm_row[a - 1] : -1;
  const int next_row = b < V ? perm_row[b] : -1;
  const int cpb = lpt * VEC;  // columns per column block
  const int ncb = (d + cpb - 1) / cpb;

  for (int cb = 0; cb < ncb; ++cb) {
    const int col = cb * cpb + l * VEC;
    const bool col_ok = col < d;  // VEC > 1 paths have d % cpb == 0
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    int cur = -1;

    auto flush = [&]() {
#pragma unroll
      for (int o = lpt; o < 32; o <<= 1)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += __shfl_xor_sync(FULL, acc[i], o);
      if (q == 0 && col_ok) {
        float* dst;
        if (cur == next_row)
          dst = tail + (size_t)p * d;
        else if (cur == prev_row)
          dst = head + (size_t)p * d;
        else
          dst = out + (size_t)cur * d;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dst[col + i] = acc[i];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    };

    for (int base = a; base < b; base += 32) {
      const int nb = b - base < 32 ? b - base : 32;
      const int tok_j = lane < nb ? perm_tok[base + lane] : 0;
      const int row_j = lane < nb ? perm_row[base + lane] : -1;
      for (int s0 = 0; s0 < nb; s0 += PRE * tpw) {
        float v[PRE][VEC];
        int vr[PRE];
#pragma unroll
        for (int u = 0; u < PRE; ++u) {  // issue the loads of PRE steps
          const int j = s0 + u * tpw + q;
          const int t = __shfl_sync(FULL, tok_j, j & 31);
          vr[u] = __shfl_sync(FULL, row_j, j & 31);
          if (j < nb && col_ok) {
            float w[VEC];
            Loader<T, VEC>::load(g + (size_t)t * d + col, w);
#pragma unroll
            for (int i = 0; i < VEC; ++i) v[u][i] = w[i];
          } else {
            vr[u] = -1;
#pragma unroll
            for (int i = 0; i < VEC; ++i) v[u][i] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < PRE; ++u) {
          const int s = s0 + u * tpw;
          if (s >= nb) break;
          const int kend = s + tpw < nb ? s + tpw : nb;
          int k0 = s;
          while (k0 < kend) {  // the rows of this step, in order
            const int r = __shfl_sync(FULL, row_j, k0);
            if (r != cur) {
              if (cur >= 0) flush();
              cur = r;
            }
            if (vr[u] == r) {
#pragma unroll
              for (int i = 0; i < VEC; ++i) acc[i] += v[u][i];
            }
            const unsigned diff = __ballot_sync(FULL, lane > k0 && lane < kend && row_j != r);
            k0 = diff ? __ffs(diff) - 1 : kend;
          }
        }
      }
    }
    flush();
  }
}

// ------------------------------------------------------------------ 5. fixup
__global__ void __launch_bounds__(NT)
    csr_fixup_kernel(const int* __restrict__ row_ptr, int n, int d,
                     const float* __restrict__ head, const float* __restrict__ tail,
                     float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * NWARP + (threadIdx.x >> 5);
  if (r >= n) return;
  const int s = row_ptr[r], e = row_ptr[r + 1];
  float* o = out + (size_t)r * d;
  if (s == e) {
    for (int c = lane; c < d; c += 32) o[c] = 0.f;
    return;
  }
  const int p0 = s / PIECE, p1 = (e - 1) / PIECE;
  if (p0 == p1) return;  // written whole by the sum kernel
  for (int c = lane; c < d; c += 32) {
    float acc = 0.f;
#pragma unroll 8
    for (int p = p0; p < p1; ++p) acc += tail[(size_t)p * d + c];
    o[c] = acc + head[(size_t)p1 * d + c];
  }
}

template <typename T, int VEC>
cudaError_t launch_sum(const void* g, int d, int lpt, const int* row_ptr, int n,
                       const int* perm_tok, const int* perm_row, float* out, float* head,
                       float* tail, int n_pieces, cudaStream_t s) {
  const unsigned grid = (unsigned)((n_pieces + SUM_WARPS - 1) / SUM_WARPS);
  csr_sum_kernel<T, VEC><<<grid, 32 * SUM_WARPS, 0, s>>>(static_cast<const T*>(g), d, lpt,
                                                         row_ptr, n, perm_tok, perm_row, out,
                                                         head, tail, n_pieces);
  return cudaGetLastError();
}

// lanes per token for rows of d elements read VEC at a time: d/VEC when it
// divides 32, 32 when d/VEC is a multiple of 32; 0 if neither
int lanes_per_token(int d, int vec) {
  if (d % vec) return 0;
  const int u = d / vec;
  if (u <= 32 && 32 % u == 0) return u;
  return u % 32 == 0 ? 32 : 0;
}

// ----------------------------------------------------------------- bincount
namespace cg = cooperative_groups;

constexpr int BC_NT = 1024;           // threads per block
constexpr int BC_NWARP = BC_NT / 32;
constexpr int BC_UNROLL = 2;          // 16-byte loads in flight per thread
constexpr int BC_LOCAL_ROWS = 16384;  // local route: a whole histogram per block (64 KB)
constexpr int BC_BAND = 57344;        // banded route: rows per block per pass (224 KB)

// Adds this warp's ids r (one per lane) that lie in [lo, hi) to their rows,
// one integer atomic each.
template <typename Add>
__device__ __forceinline__ void add_ids(int r, int lo, int hi, const Add& add) {
  if ((unsigned)r - (unsigned)lo < (unsigned)(hi - lo)) add(r - lo);
}

// Every id of this block's share of idx that lies in [lo, hi): the 16-byte
// aligned body split into one contiguous chunk per block; the few ids before
// and after it go to warp 0 of block 0.
template <typename Add>
__device__ __forceinline__ void count_chunk(const int* __restrict__ idx, int T_, unsigned rank,
                                            unsigned C, int lo, int hi, const Add& add) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int head = (int)(((16u - (reinterpret_cast<uintptr_t>(idx) & 15u)) & 15u) / 4u);
  head = head < T_ ? head : T_;
  const int n4 = (T_ - head) / 4, tail0 = head + 4 * n4;
  const int4* __restrict__ body = reinterpret_cast<const int4*>(idx + head);
  const int per = (int)((n4 + C - 1) / C);
  const int b0 = min((int)rank * per, n4), b1 = min(b0 + per, n4);
  for (int base = b0 + warp * 32 * BC_UNROLL; base < b1; base += BC_NWARP * 32 * BC_UNROLL) {
    int4 v[BC_UNROLL];
#pragma unroll
    for (int u = 0; u < BC_UNROLL; ++u) {
      const int i = base + 32 * u + lane;
      v[u] = i < b1 ? body[i] : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < BC_UNROLL; ++u) {
      add_ids(v[u].x, lo, hi, add);
      add_ids(v[u].y, lo, hi, add);
      add_ids(v[u].z, lo, hi, add);
      add_ids(v[u].w, lo, hi, add);
    }
  }
  if (rank == 0 && warp == 0) {  // at most 3 + 3 ids
    const int j = lane - head;
    const int r = lane < head ? idx[lane] : (j < T_ - tail0 ? idx[tail0 + j] : -1);
    add_ids(r, lo, hi, add);
  }
}

__global__ void __launch_bounds__(BC_NT)
    bincount_cluster_kernel(const int* __restrict__ idx, float* __restrict__ out, int T_,
                            int n, int local, int band) {
  extern __shared__ int hist[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), C = cluster.num_blocks();
  const int tid = threadIdx.x;
  if (local) {
    for (int i = tid; i < n; i += BC_NT) hist[i] = 0;
    __syncthreads();
    count_chunk(idx, T_, rank, C, 0, n, [&](int r) { atomicAdd(hist + r, 1); });
    cluster.sync();  // every block's histogram is complete
    const int r0 = min((int)rank * band, n), r1 = min(r0 + band, n);
    for (int r = r0 + tid; r < r1; r += BC_NT) {
      int sum = 0;
#pragma unroll
      for (unsigned c = 0; c < 16; ++c)
        if (c < C) sum += cluster.map_shared_rank(hist, c)[r];
      out[r] = (float)sum;
    }
    cluster.sync();  // no block leaves while another still reads its histogram
    return;
  }
  const int window = (int)C * band;
  for (int w0 = 0; w0 < n; w0 += window) {
    for (int i = tid; i < band; i += BC_NT) hist[i] = 0;
    cluster.sync();  // every band is zero before any block adds into it
    const int hi = n - w0 < window ? n : w0 + window;
    count_chunk(idx, T_, rank, C, w0, hi, [&](int r) {
      atomicAdd(cluster.map_shared_rank(hist, (unsigned)(r / band)) + r % band, 1);
    });
    cluster.sync();  // every add has landed
    const int r0 = w0 + (int)rank * band;
    for (int i = tid; i < band && r0 + i < n; i += BC_NT) out[r0 + i] = (float)hist[i];
    __syncthreads();
  }
}

}  // namespace

// Bytes of scratch matcha_scatter_add needs for T tokens, width d, n_rows
// rows (-1 for arguments it does not take).
extern "C" long long matcha_scatter_add_scratch_bytes(int T_, int d, int n_rows) {
  if (T_ < 0 || d <= 0 || d > MAX_D || n_rows <= 0) return -1;
  return make_plan(T_, d, n_rows).bytes;
}

// g (T, d) f32 (is_bf16 = 0) or bf16, idx (T,) int32 -> out (n_rows, d) f32,
// every element written; scratch holds matcha_scatter_add_scratch_bytes
// bytes, 16-byte aligned.  1 <= d <= 1536.  Returns the CUDA error (0 = ok).
extern "C" int matcha_scatter_add(const void* g, const void* idx, void* out, void* scratch,
                                  int T_, int d, int n_rows, int is_bf16, void* stream) {
  if (T_ < 0 || d <= 0 || d > MAX_D || n_rows <= 0 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(T_, d, n_rows);
  char* base = static_cast<char*>(scratch);
  int* cnt = reinterpret_cast<int*>(base + p.cnt);
  int* total = reinterpret_cast<int*>(base + p.total);
  int* row_ptr = reinterpret_cast<int*>(base + p.row_ptr);
  int* perm_tok = reinterpret_cast<int*>(base + p.perm_tok);
  int* perm_row = reinterpret_cast<int*>(base + p.perm_row);
  int* ghist = reinterpret_cast<int*>(base + p.ghist);
  float* head = reinterpret_cast<float*>(base + p.head);
  float* tail = reinterpret_cast<float*>(base + p.tail);
  const int* ids = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaError_t err;

  csr_count_kernel<<<p.n_chunks, NT, p.shared_hist ? n_rows * (int)sizeof(int) : 0, s>>>(
      ids, T_, n_rows, p.chunk, cnt, p.shared_hist);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  csr_colscan_kernel<<<(n_rows + 127) / 128, 128, 0, s>>>(cnt, total, n_rows, p.n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int place_smem = p.shared_hist ? NWARP * n_rows * (int)sizeof(int) : 0;
  static bool smem_set[64] = {};  // per device: the attribute call costs host time
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(csr_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               NWARP * SHARED_ROWS * (int)sizeof(int));
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = true;
  }
  csr_place_kernel<<<p.n_chunks, NT, place_smem, s>>>(ids, T_, n_rows, p.chunk, cnt, total,
                                                      row_ptr, perm_tok, perm_row, ghist,
                                                      p.shared_hist);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (p.n_pieces > 0) {
    const bool aligned = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
    int lpt;
    if (is_bf16) {
      if (aligned && (lpt = lanes_per_token(d, 8)))
        err = launch_sum<__nv_bfloat16, 8>(g, d, lpt, row_ptr, n_rows, perm_tok, perm_row, o,
                                           head, tail, p.n_pieces, s);
      else
        err = launch_sum<__nv_bfloat16, 1>(g, d, (lpt = lanes_per_token(d, 1)) ? lpt : 32,
                                           row_ptr, n_rows, perm_tok, perm_row, o, head, tail,
                                           p.n_pieces, s);
    } else {
      if (aligned && (lpt = lanes_per_token(d, 4)))
        err = launch_sum<float, 4>(g, d, lpt, row_ptr, n_rows, perm_tok, perm_row, o, head,
                                   tail, p.n_pieces, s);
      else
        err = launch_sum<float, 1>(g, d, (lpt = lanes_per_token(d, 1)) ? lpt : 32, row_ptr,
                                   n_rows, perm_tok, perm_row, o, head, tail, p.n_pieces, s);
    }
    if (err != cudaSuccess) return (int)err;
  }
  csr_fixup_kernel<<<(n_rows + NWARP - 1) / NWARP, NT, 0, s>>>(row_ptr, n_rows, d, head, tail,
                                                              o);
  return (int)cudaGetLastError();
}

// The cluster width of the bincount launch on the current device, and the
// kernel's attributes, set once per device: 16 blocks where the card
// schedules such a cluster at the largest shared memory the kernel asks for,
// else the portable 8.  Returns the CUDA error (0 = ok).
static cudaError_t bincount_cluster(int* width) {
  static int chosen[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && chosen[dev]) {
    *width = chosen[dev];
    return cudaSuccess;
  }
  const int smem = BC_BAND * (int)sizeof(int);
  if ((err = cudaFuncSetAttribute(bincount_cluster_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(bincount_cluster_kernel,
                                  cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
      cudaSuccess)
    return err;
  int w = 8;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 16;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(16);
  cfg.blockDim = dim3(BC_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, bincount_cluster_kernel, &cfg) == cudaSuccess &&
      clusters > 0)
    w = 16;
  (void)cudaGetLastError();  // a refused query leaves the portable width
  if (dev < 64) chosen[dev] = w;
  *width = w;
  return cudaSuccess;
}

// idx (T,) int32 -> out (n_rows,) f32 counts, every element written, in one
// launch.  Returns the CUDA error (0 = ok).
extern "C" int matcha_bincount(const void* idx, void* out, int T_, int n_rows, void* stream) {
  if (T_ < 0 || n_rows <= 0) return (int)cudaErrorInvalidValue;
  int C = 8;
  cudaError_t err = bincount_cluster(&C);
  if (err != cudaSuccess) return (int)err;
  const int local = n_rows <= BC_LOCAL_ROWS;
  const int per_block = (int)(((long long)n_rows + C - 1) / C);
  const int band = local ? per_block : (per_block < BC_BAND ? per_block : BC_BAND);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)C);
  cfg.blockDim = dim3(BC_NT);
  cfg.dynamicSmemBytes = (size_t)(local ? n_rows : band) * sizeof(int);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bincount_cluster_kernel, static_cast<const int*>(idx),
                           static_cast<float*>(out), T_, n_rows, local, band);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* matcha_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
