// Node-table gather gradient (scatter-add) and token bincount, for NVIDIA
// Hopper (sm_90a).
//
// scatter_add replaces the TPU kernel matcha_tpu/ops/table_scatter.py:
// _scatter_kernel (through scatter_add_matmul): for g (T, d) in f32 or bf16
// and idx (T,) int32 it writes out (n_rows, d) f32 with
//   out[r] = sum over t with idx[t] == r of g[t].
// The TPU kernel builds a one-hot matrix and runs the sum on its matrix unit,
// because a random read-modify-write is slow there.  Here the tokens are
// grouped by row first, by a stable counting sort, then each row's tokens
// are summed with 16-byte loads in a fixed order, a hub row shared out among
// many warps.  Two routes, chosen from T, d and n_rows; neither keeps
// scratch that grows with n_rows times a number of token chunks.
//
// Local route (T <= SMALL_T, d <= SMALL_D, n_rows <= LOCAL_BLOCKS *
// LOCAL_ROWS: the walk pretraining's SGNS minibatches), one launch: block b
// owns a band of about n_rows / 132 rows and walks all T ids itself (they
// stay in L2), so no block waits on another.  It counts its band's ids per
// warp and row (marking which walk steps hold them), scans the counts into
// row starts and cursors, walks the marked steps again and places each of
// its tokens at its row's cursor plus its rank among the lanes of the same
// row (a ballot per key bit, or two when one row holds all of a step's:
// __match_any_sync's throughput on this card made it the walks' bound), all
// in shared memory.  Then each lane group sums a run of whole rows in token
// order, and a row of more than LONG_ROW tokens is shared out among all the
// block's lanes, its partials added in a fixed order.
//
// Grid route (the training step, and what the local route does not take),
// six launches whose grids fill the card at every table height, the rows
// cut into nb >= NB_GRID bands (two per SM):
//   1. count  per chunk of MIN_CHUNK or more tokens: a band histogram in
//             shared memory (integer atomics, exact), out as cnt[band][chunk];
//      scan   one warp per band: the exclusive prefix of its chunk counts and
//             its total;
//   2. place  per chunk: the band starts (a block scan of the totals), each
//             warp's cursor per band, then the same stable walk by band: the
//             tokens grouped by band, in token order;
//   3. sort   per band: per-warp row histograms over the band's rows (at most
//             SUB rows a pass; a taller band takes several passes), a block
//             scan into the row starts, and the stable walk by row: the
//             tokens grouped by row, in token order;
//   4. sum    one warp per piece of `piece` sorted slots (16 to 128, scaled
//             so that T makes about PIECE_TARGET pieces): lane groups of d/VEC
//             lanes read a token's g row with 16-byte loads (a 64-wide bf16
//             row is 8 lanes, so a warp takes 4 tokens at a time), combine
//             the groups in a fixed shuffle tree and write each row whose
//             tokens all lie in the piece once; a row that crosses a piece
//             boundary leaves its per-piece partials;
//   5. fixup  rpw rows per warp: zeros for the empty rows, and the sum of the
//             partials of a row that spans pieces in a fixed order (float4
//             streams over the pieces, then a fixed xor tree).
// No float atomics anywhere: the result is the same bits on every run.  Ids
// outside [0, n_rows) are dropped, as the TPU kernel's one-hot compare drops
// them.  The grid route's scratch (chunk counts, band starts, the
// band-grouped and row-grouped ids and rows, the row starts, the partials)
// comes from the caller; matcha_scatter_add_scratch_bytes gives its size:
// O(T + n_rows + nb * nc), nb * nc <= NB_MAX * NC_MAX; the local route takes
// none.
// Bound on this card: bytes, g read once (T*d*2 B in bf16, 4 in f32), out
// written once (n_rows*d*4 B), idx read once; the T*d adds are negligible.
// At the 1 Mb step (T = 114,688, n_rows = 3,068, d = 64, bf16) 15.9 MB ->
// 4.75 us at 3.35 TB/s; at the 100 kb step (n_rows = 30,345) 22.9 MB ->
// 6.84 us; an SGNS minibatch (f32, n_rows = 3,067) 1.8 / 7.2 MB at T =
// 4,096 / 24,576 -> 0.55 / 2.14 us.  What the design pays above the bound
// is the sort's own traffic and, at small T, the launches and the dependent
// trips to memory between its steps.
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

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_D = 1536;        // widest g row scatter_add takes
constexpr int NT = 512;            // threads per block of the local route and steps 1-3
constexpr int NW = NT / 32;
constexpr int HIST_INTS = 49152;   // per-warp histograms of a block: 192 KB of shared memory
constexpr int SUB = HIST_INTS / NW;     // rows one sort pass holds
constexpr int NB_MAX = HIST_INTS / NW;  // bands at most
constexpr int NB_GRID = 264;       // bands at least: two per SM
constexpr int MIN_PART = 64;       // tokens per warp of the sort before another warp joins
constexpr int NC_MAX = 256;        // token chunks of steps 1-2, at most
constexpr int MIN_CHUNK = 1024;    // and tokens per chunk, at least
constexpr int PIECE_TARGET = 2048; // pieces the sum aims for (16 to 128 slots each)
constexpr int SUM_WARPS = 4;       // warps per block of the sum kernel
constexpr int PRE = 8;             // token steps whose loads are in flight at once
constexpr int FIX_NT = 256;        // threads per block of the fixup kernel
constexpr int U = 8;               // walk steps whose id loads are in flight at once
constexpr int SMALL_T = 32768;     // the local route: tokens at most (token ids fit 16 bits),
constexpr int SMALL_D = 128;       // row width at most,
constexpr int LOCAL_BLOCKS = 132;  // blocks it aims for (one per SM),
constexpr int LOCAL_ROWS = 1024;   // and rows per block at most
constexpr int LONG_ROW = 32;       // its rows of more tokens are shared out by the block
constexpr int LU = 16;             // its walk steps whose id loads are in flight at once
static_assert(SMALL_T / NW <= 64 * 32, "a warp's walk of the local route fits a 64-bit mask");

// ints of the local route's shared memory before its partials (16-byte aligned)
__host__ __device__ __forceinline__ int local_part_offset(int R, int T) {
  return (NW * R + R + 1 + T + 3) / 4 * 4;
}

__device__ __forceinline__ bool in_range(int r, int n) { return (unsigned)r < (unsigned)n; }

// The lanes whose key equals this lane's, for keys in [-1, 2^bits): one
// ballot for the sign and one per key bit (__match_any_sync's throughput on
// this card made it the walks' bound).
__device__ __forceinline__ unsigned match_key(int key, int bits) {
  const bool neg = key < 0;
  const unsigned s = __ballot_sync(FULL, neg);
  unsigned m = neg ? s : ~s;
  for (int i = 0; i < bits; ++i) {
    const bool bit = (key >> i) & 1;
    const unsigned b = __ballot_sync(FULL, bit);
    m &= bit ? b : ~b;
  }
  return m;
}

// match_key for the valid lanes' keys, the invalid lanes matching each
// other; when every valid lane holds the same key (one row of a hub, or a
// single valid lane) two ballots settle it.
__device__ __forceinline__ unsigned match_valid(bool ok, int key, int bits) {
  const unsigned v = __ballot_sync(FULL, ok);
  const int k0 = __shfl_sync(FULL, key, v ? __ffs(v) - 1 : 0);
  if (__ballot_sync(FULL, ok && key == k0) == v) return ok ? v : ~v;
  return match_key(ok ? key : -1, bits);
}

// bits that hold every value in [0, v)
__device__ __forceinline__ int key_bits(int v) { return v > 1 ? 32 - __clz(v - 1) : 0; }

// ------------------------------------------------------------------ the plan
struct Plan {
  int local;      // 1: the local route (one launch, no scratch)
  int nb, band;   // bands of `band` rows
  int nc, chunk;  // token chunks of steps 1-2
  int piece;      // sorted slots per warp of the sum
  int rpw;        // rows per warp of the fixup
  long long n_pieces;
  long long cnt, btot, band_ptr, tok1, row1, row_ptr, perm_tok, perm_row, head, tail,
      bytes;  // byte offsets
};

struct Scratch {
  int *cnt, *btot, *band_ptr, *tok1, *row1, *row_ptr, *perm_tok, *perm_row;
  float *head, *tail;
};

__host__ __device__ __forceinline__ long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}
long long align16(long long b) { return (b + 15) / 16 * 16; }

Plan make_plan(int T, int d, int n) {
  Plan p = {};
  const long long local_band = cdiv(n, LOCAL_BLOCKS);
  p.local = T <= SMALL_T && d <= SMALL_D && local_band <= LOCAL_ROWS;
  if (p.local) {
    p.band = (int)local_band;
    p.nb = (int)cdiv(n, p.band);
    return p;  // no scratch
  }
  long long nb = cdiv(n, SUB);
  if (nb < NB_GRID) nb = NB_GRID;
  nb = nb < NB_MAX ? nb : NB_MAX;
  nb = nb < n ? nb : n;
  p.band = (int)cdiv(n, nb);
  p.nb = (int)cdiv(n, p.band);
  const long long chunk = cdiv(T, NC_MAX);
  p.chunk = (int)(chunk > MIN_CHUNK ? chunk : MIN_CHUNK);
  p.nc = T > 0 ? (int)cdiv(T, p.chunk) : 1;
  const long long want = cdiv(T, PIECE_TARGET);
  p.piece = 16;
  while (p.piece < want && p.piece < 128) p.piece *= 2;
  p.n_pieces = cdiv(T, p.piece);
  // few tokens a row: rows rarely span pieces, so a warp takes 8 of them
  p.rpw = (long long)T < 4LL * n ? 8 : 1;
  const long long counts = (long long)p.nb * p.nc;
  long long at = 0;
  p.cnt = at;      at = align16(at + 4LL * counts);
  p.btot = at;     at = align16(at + 4LL * p.nb);
  p.band_ptr = at; at = align16(at + 4LL * (p.nb + 1));
  p.tok1 = at;     at = align16(at + 4LL * T);
  p.row1 = at;     at = align16(at + 4LL * T);
  p.row_ptr = at;  at = align16(at + 4LL * ((long long)n + 1));
  p.perm_tok = at; at = align16(at + 4LL * T);
  p.perm_row = at; at = align16(at + 4LL * T);
  p.head = at;     at = align16(at + 4LL * p.n_pieces * d);
  p.tail = at;     at = align16(at + 4LL * p.n_pieces * d);
  p.bytes = at;
  return p;
}

// exclusive prefix over the block's threads in thread order; *sum = the total
template <int NWARPS>
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
  for (int w = 0; w < NWARPS; ++w) {
    before += w < warp ? warp_sums[w] : 0;
    all += warp_sums[w];
  }
  *sum = all;
  return before + inc - v;
}

// ------------------------------------------------------------- 1-2. by band
// Warp `warp`'s contiguous part [*w0, *w1) of the chunk [t0, t1).
__device__ __forceinline__ void warp_part(long long t0, long long t1, int* w0, int* w1) {
  const long long sub = (t1 - t0 + NW - 1) / NW;
  const long long a = min(t1, t0 + (threadIdx.x >> 5) * sub);
  *w0 = (int)a;
  *w1 = (int)min(t1, a + sub);
}

// Adds each in-range id of idx[w0, w1) to its band's count in h (integer
// shared-memory atomics: exact in any order).
__device__ __forceinline__ void count_walk(const int* __restrict__ idx, int w0, int w1, int n,
                                           int band, int* h) {
  const int lane = threadIdx.x & 31;
  for (int base = w0; base < w1; base += 32 * U) {
    int r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + 32 * u + lane;
      r[u] = t < w1 ? idx[t] : -1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (in_range(r[u], n)) atomicAdd(h + r[u] / band, 1);
  }
}

// Walks idx[w0, w1) in token order: each in-range token's id and row go to
// the slot hw[band] (this warp's cursor) plus its rank among the lower
// lanes of the same band, and the cursor moves on.
__device__ __forceinline__ void place_walk(const int* __restrict__ idx, int w0, int w1, int n,
                                           int band, int qbits, int* hw, int* __restrict__ tok1,
                                           int* __restrict__ row1) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  for (int base = w0; base < w1; base += 32 * U) {
    int r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + 32 * u + lane;
      r[u] = t < w1 ? idx[t] : -1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = in_range(r[u], n);
      const int q = ok ? r[u] / band : -1;
      const unsigned m = match_valid(ok, q, qbits);
      const int leader = __ffs(m) - 1;
      int c = 0;
      if (ok && lane == leader) c = hw[q];
      c = __shfl_sync(FULL, c, leader);
      if (ok) {
        const int pos = c + __popc(m & lt);
        tok1[pos] = base + 32 * u + lane;
        row1[pos] = r[u];
        if (lane == leader) hw[q] = c + __popc(m);
      }
      __syncwarp();
    }
  }
}

// hist[w][q] (warp w's count of band q) <- warp w's first slot of band q:
// first + the counts of warps before w.
__device__ __forceinline__ void warp_cursors(int* hist, int nb, int q, int first) {
  for (int w = 0; w < NW; ++w) {
    int* p = hist + w * nb + q;
    const int v = *p;
    *p = first;
    first += v;
  }
}

// ------------------------------------------------------------------ 3. sort
// Band q's tokens (in token order) to the row-grouped slots, in token order
// within each row, and the band's row starts.  The block's warps (as many as
// the band's tokens need, MIN_PART each) take contiguous parts of the band.
__device__ void sort_band(int q, int band, int n, const Scratch& s, int* h, int* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int seg0 = s.band_ptr[q], M = s.band_ptr[q + 1] - seg0;
  const int r0 = q * band, r1 = min(n, r0 + band);
  const int W = max(1, min(NW, (M + MIN_PART - 1) / MIN_PART));
  const long long part = ((long long)M + W - 1) / W;
  const int w0 = seg0 + (int)min((long long)M, warp * part);
  const int w1 = seg0 + (int)min((long long)M, (warp + 1) * part);
  int base = seg0;
  for (int s0 = r0; s0 < r1; s0 += SUB) {
    const int R = min(SUB, r1 - s0);
    int* hw = h + warp * R;  // warps >= W have empty parts and never touch it
    const int rbits = key_bits(R);
    for (int i = tid; i < W * R; i += NT) h[i] = 0;
    __syncthreads();
    for (int bb = w0; bb < w1; bb += 32 * U) {  // a. each warp counts its part by row
      int r[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = bb + 32 * u + lane;
        r[u] = t < w1 ? s.row1[t] : -1;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if ((unsigned)(r[u] - s0) < (unsigned)R) atomicAdd(hw + r[u] - s0, 1);
    }
    __syncthreads();
    // b. row starts (thread i owns rows [i*k, i*k + k) of the pass) and each
    //    warp's first slot per row
    const int k = (R + NT - 1) / NT;
    const int a0 = min(tid * k, R), a1 = min(a0 + k, R);
    int own = 0;
    for (int a = a0; a < a1; ++a)
      for (int w = 0; w < W; ++w) own += h[w * R + a];
    int all;
    int run = base + block_exclusive_scan<NW>(own, warp_sums, &all);
    for (int a = a0; a < a1; ++a) {
      s.row_ptr[s0 + a] = run;
      for (int w = 0; w < W; ++w) {
        int* p = h + w * R + a;
        const int v = *p;
        *p = run;
        run += v;
      }
    }
    base += all;
    __syncthreads();
    for (int bb = w0; bb < w1; bb += 32 * U) {  // c. the stable walk
      int r[U], tk[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = bb + 32 * u + lane;
        r[u] = t < w1 ? s.row1[t] : -1;
        tk[u] = t < w1 ? s.tok1[t] : 0;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool ok = (unsigned)(r[u] - s0) < (unsigned)R;
        const unsigned m = match_valid(ok, r[u] - s0, rbits);
        const int leader = __ffs(m) - 1;
        int c = 0;
        if (ok && lane == leader) c = hw[r[u] - s0];
        c = __shfl_sync(FULL, c, leader);
        if (ok) {
          const int pos = c + __popc(m & lt);
          s.perm_tok[pos] = tk[u];
          s.perm_row[pos] = r[u];
          if (lane == leader) hw[r[u] - s0] = c + __popc(m);
        }
        __syncwarp();
      }
    }
    __syncthreads();  // the pass's histograms and warp sums are free again
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

// Piece p (one warp) holds the sorted slots [p*piece, ...) up to V, the
// count of in-range tokens.  Lane = q * lpt + l: lane group q takes every
// tpw-th token, lane l of the group the columns [l*VEC, l*VEC + VEC) of each
// block of lpt*VEC columns.  A row's segment in the piece is summed per lane
// group, the groups are combined by a fixed xor-shuffle tree, and the sum
// goes to out (the row lies wholly in the piece), tail[p] (the row goes on
// past the piece) or head[p] (the row began before the piece and ends in it).
template <typename T, int VEC>
__device__ void sum_piece(const T* __restrict__ g, int d, int lpt, int piece, int p, int V,
                          const int* __restrict__ perm_tok, const int* __restrict__ perm_row,
                          float* __restrict__ out, float* __restrict__ head,
                          float* __restrict__ tail) {
  const int lane = threadIdx.x & 31;
  const int a = p * piece;
  const int b = a + piece < V ? a + piece : V;
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

// ----------------------------------------------------------- local route sums
// acc += the g rows of the tokens slot[0, len) (token | row << 16), columns
// [col, col + VEC), in slot order, the loads of PRE tokens in flight.
template <typename T, int VEC>
__device__ __forceinline__ void add_tokens(const T* __restrict__ g, int d, int col,
                                           const int* slot, int len, float (&acc)[VEC]) {
  for (int j0 = 0; j0 < len; j0 += PRE) {
    float v[PRE][VEC];
#pragma unroll
    for (int u = 0; u < PRE; ++u) {
      if (j0 + u < len) {
        Loader<T, VEC>::load(g + (size_t)(slot[j0 + u] & 0xffff) * d + col, v[u]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < PRE; ++u)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += v[u][i];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* dst, const float (&acc)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(dst + i) = make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = acc[i];
  }
}

// Every row [r0, r0 + R) of the band, its tokens at slot[rs[a], rs[a + 1])
// (token | a << 16).  Lane group q of warp w (G = NW * 32 / lpt groups) takes
// the rows [q*rpg, q*rpg + rpg) but those of more than LONG_ROW tokens: it
// walks their slots in order, the loads of PRE tokens in flight, and writes
// each row's sum when the row changes (zeros for an empty row).  Each long
// row (listed in longs[0, *nlong), in any order: no row's sum depends on
// another's) is shared out afterwards among all the groups in contiguous
// parts, combined by a fixed xor tree within each warp and then in warp
// order (part holds NW x d).
template <typename T, int VEC>
__device__ void local_sums(const T* __restrict__ g, int d, int lpt, int r0, int R,
                           const int* rs, const int* slot, float* part, int* longs, int* nlong,
                           float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, G = NW * (32 / lpt);
  const int gid = warp * (32 / lpt) + lane / lpt, rpg = (R + G - 1) / G;
  const int a0 = min(R, gid * rpg), a1 = min(R, a0 + rpg);
  const int c0 = (lane % lpt) * VEC, cpb = lpt * VEC;  // VEC > 1 paths have d % cpb == 0
  auto is_long = [&](int a) { return rs[a + 1] - rs[a] > LONG_ROW; };
  if (threadIdx.x == 0) *nlong = 0;
  __syncthreads();
  for (int a = threadIdx.x; a < R; a += NT)
    if (is_long(a)) longs[atomicAdd(nlong, 1)] = a;
  for (int col = c0; col < d; col += cpb) {
    for (int a = a0; a < a1; ++a) {
      if (rs[a] == rs[a + 1]) {
        float zero[VEC] = {};
        store_vec<VEC>(out + (size_t)(r0 + a) * d + col, zero);
      }
    }
    for (int s0 = a0; s0 < a1;) {  // the runs of short rows between long ones
      int s1 = s0;
      while (s1 < a1 && !is_long(s1)) ++s1;
      const int end = rs[s1];
      float acc[VEC] = {};
      int cur = -1;
      for (int j0 = rs[s0]; j0 < end; j0 += PRE) {
        float v[PRE][VEC];
        int vr[PRE];
#pragma unroll
        for (int u = 0; u < PRE; ++u) {  // issue the loads of PRE tokens
          const int e = j0 + u < end ? slot[j0 + u] : -1;
          vr[u] = e >> 16;
          if (e >= 0) {
            Loader<T, VEC>::load(g + (size_t)(e & 0xffff) * d + col, v[u]);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) v[u][i] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < PRE; ++u) {  // then add them in slot order
          if (vr[u] < 0) break;
          if (vr[u] != cur) {
            if (cur >= 0) store_vec<VEC>(out + (size_t)(r0 + cur) * d + col, acc);
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
            cur = vr[u];
          }
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += v[u][i];
        }
      }
      if (cur >= 0) store_vec<VEC>(out + (size_t)(r0 + cur) * d + col, acc);
      s0 = s1 + 1;
    }
  }
  __syncthreads();  // the list of long rows is complete
  for (int k = 0; k < *nlong; ++k) {  // the long rows, every group on each
    const int a = longs[k], len = rs[a + 1] - rs[a], per = (len + G - 1) / G;
    const int j0 = min(len, gid * per), j1 = min(len, j0 + per);
    for (int col = c0; col < d; col += cpb) {
      float acc[VEC] = {};
      add_tokens<T, VEC>(g, d, col, slot + rs[a] + j0, j1 - j0, acc);
#pragma unroll
      for (int o = lpt; o < 32; o <<= 1)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += __shfl_xor_sync(FULL, acc[i], o);
      if (lane < lpt) store_vec<VEC>(part + (size_t)warp * d + col, acc);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += NT) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) sum += part[(size_t)w * d + c];
      out[(size_t)(r0 + a) * d + c] = sum;
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ 5. fixup
// Rows [r0, r0 + rows) (one warp, rows <= 32) whose slot starts are rp[0],
// ..., rp[rows]: zeros for an empty row, and the sum of the partials of a
// row that spans pieces, in a fixed order.
__device__ void fixup_rows(int r0, int rows, int d, int piece, const int* rp,
                           const float* head, const float* tail, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const bool ok = lane < rows;
  const int s = ok ? rp[lane] : 0;
  const int e = ok ? rp[lane + 1] : 0;
  const unsigned empty = __ballot_sync(FULL, ok && s == e);
  const unsigned span = __ballot_sync(FULL, ok && s != e && s / piece != (e - 1) / piece);
  if (empty) {
    if ((d & 3) == 0) {  // out rows are 16-byte aligned
      const int d4 = d >> 2;
      float4* o = reinterpret_cast<float4*>(out + (size_t)r0 * d);
      for (int i = lane; i < rows * d4; i += 32)
        if ((empty >> (i / d4)) & 1u) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      float* o = out + (size_t)r0 * d;
      for (int i = lane; i < rows * d; i += 32)
        if ((empty >> (i / d)) & 1u) o[i] = 0.f;
    }
  }
  const int d4 = d >> 2;
  const bool streams = (d & 3) == 0 && d4 <= 32 && 32 % d4 == 0;
  for (unsigned m = span; m; m &= m - 1) {
    const int j = __ffs(m) - 1;
    const int p0 = __shfl_sync(FULL, s, j) / piece, p1 = (__shfl_sync(FULL, e, j) - 1) / piece;
    float* o = out + (size_t)(r0 + j) * d;
    if (streams) {  // 32/d4 streams of float4 rows, each over every (32/d4)-th piece,
                    // then a fixed xor tree across the streams
      const int ns = 32 / d4, c4 = lane % d4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int p = p0 + lane / d4; p < p1; p += ns) {
        const float4 v = reinterpret_cast<const float4*>(tail + (size_t)p * d)[c4];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      for (int x = d4; x < 32; x <<= 1) {
        acc.x += __shfl_xor_sync(FULL, acc.x, x);
        acc.y += __shfl_xor_sync(FULL, acc.y, x);
        acc.z += __shfl_xor_sync(FULL, acc.z, x);
        acc.w += __shfl_xor_sync(FULL, acc.w, x);
      }
      if (lane < d4) {
        const float4 h = reinterpret_cast<const float4*>(head + (size_t)p1 * d)[c4];
        reinterpret_cast<float4*>(o)[c4] =
            make_float4(acc.x + h.x, acc.y + h.y, acc.z + h.z, acc.w + h.w);
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        float acc = 0.f;
#pragma unroll 8
        for (int p = p0; p < p1; ++p) acc += tail[(size_t)p * d + c];
        o[c] = acc + head[(size_t)p1 * d + c];
      }
    }
  }
}

// ---------------------------------------------------------------- kernels
// The local route (T <= SMALL_T, d <= SMALL_D), one launch: block b owns the
// rows [b*band, b*band + band) and walks all T ids itself (they stay in L2),
// so no block waits on another; its tokens, sorted by row, and the pieces'
// partials stay in shared memory.
template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
    scatter_local_kernel(const int* __restrict__ idx, const T* __restrict__ g,
                         float* __restrict__ out, int T_, int n, int d, int lpt, int band) {
  extern __shared__ int sm[];
  __shared__ int warp_sums[NW];
  __shared__ int longs[SMALL_T / LONG_ROW], nlong;  // the band's long rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int r0 = blockIdx.x * band, R = min(band, n - r0);
  int* hist = sm;                 // NW x R per-warp row counts, then cursors
  int* rs = hist + NW * R;        // R + 1 row starts
  int* slot = rs + R + 1;         // the band's tokens sorted by row
  float* part = reinterpret_cast<float*>(sm + local_part_offset(R, T_));  // NW x d
  int w0, w1;
  warp_part(0, T_, &w0, &w1);
  int* hw = hist + warp * R;
  for (int i = tid; i < NW * R; i += NT) hist[i] = 0;
  __syncthreads();
  // a. count this band's ids by row; bit s of `mine` marks this lane's id
  //    of walk step s (a warp's part is at most SMALL_T / NW = 64 steps)
  unsigned long long mine = 0;
  for (int base = w0, s0 = 0; base < w1; base += 32 * LU, s0 += LU) {
    int r[LU];
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      const int t = base + 32 * u + lane;
      r[u] = t < w1 ? idx[t] : -1;
    }
#pragma unroll
    for (int u = 0; u < LU; ++u)
      if ((unsigned)(r[u] - r0) < (unsigned)R) {
        atomicAdd(hw + r[u] - r0, 1);
        mine |= 1ull << (s0 + u);
      }
  }
  __syncthreads();
  const int k = (R + NT - 1) / NT;  // b. row starts and each warp's cursors
  const int a0 = min(tid * k, R), a1 = min(a0 + k, R);
  int own = 0;
  for (int a = a0; a < a1; ++a)
    for (int w = 0; w < NW; ++w) own += hist[w * R + a];
  int all;
  int run = block_exclusive_scan<NW>(own, warp_sums, &all);
  for (int a = a0; a < a1; ++a) {
    rs[a] = run;
    for (int w = 0; w < NW; ++w) {
      int* p = hist + w * R + a;
      const int v = *p;
      *p = run;
      run += v;
    }
  }
  if (tid == 0) rs[R] = all;
  __syncthreads();
  const int rbits = key_bits(R);
  // c. the stable walk over the steps that hold ids of this band, loading
  //    only those ids again
  for (int base = w0, s0 = 0; base < w1; base += 32 * LU, s0 += LU) {
    const unsigned bits = (unsigned)(mine >> s0) & ((1u << LU) - 1u);
    if (!__any_sync(FULL, bits)) continue;
    int r[LU];
#pragma unroll
    for (int u = 0; u < LU; ++u) r[u] = (bits >> u) & 1u ? idx[base + 32 * u + lane] : -1;
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      const bool ok = (bits >> u) & 1u;
      if (!__ballot_sync(FULL, ok)) continue;
      const unsigned m = match_valid(ok, r[u] - r0, rbits);
      const int leader = __ffs(m) - 1;
      int c = 0;
      if (ok && lane == leader) c = hw[r[u] - r0];
      c = __shfl_sync(FULL, c, leader);
      if (ok) {
        slot[c + __popc(m & lt)] = (base + 32 * u + lane) | (r[u] - r0) << 16;
        if (lane == leader) hw[r[u] - r0] = c + __popc(m);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  local_sums<T, VEC>(g, d, lpt, r0, R, rs, slot, part, longs, &nlong, out);  // d. the sums
}

// The grid route, step 1: chunk c's band counts -> cnt[q * nc + c].
__global__ void __launch_bounds__(NT)
    band_count_kernel(const int* __restrict__ idx, int T_, int n, int nb, int band, int chunk,
                      int nc, int* __restrict__ cnt) {
  extern __shared__ int h[];
  for (int i = threadIdx.x; i < nb; i += NT) h[i] = 0;
  __syncthreads();
  const long long t0 = (long long)blockIdx.x * chunk;
  int w0, w1;
  warp_part(min((long long)T_, t0), min((long long)T_, t0 + chunk), &w0, &w1);
  count_walk(idx, w0, w1, n, band, h);
  __syncthreads();
  for (int q = threadIdx.x; q < nb; q += NT) cnt[(size_t)q * nc + blockIdx.x] = h[q];
}

// Step 1, continued: one warp per band turns its chunk counts into their
// exclusive prefix (in place) and writes the band's total.
__global__ void __launch_bounds__(256)
    band_scan_kernel(int* __restrict__ cnt, int* __restrict__ btot, int nb, int nc) {
  const int q = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (q >= nb) return;
  int* row = cnt + (size_t)q * nc;
  int carry = 0;
  for (int c0 = 0; c0 < nc; c0 += 32 * U) {
    int v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = c0 + 32 * u + lane < nc ? row[c0 + 32 * u + lane] : 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int inc = v[u];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += y;
      }
      if (c0 + 32 * u + lane < nc) row[c0 + 32 * u + lane] = carry + inc - v[u];
      carry += __shfl_sync(FULL, inc, 31);
    }
  }
  if (lane == 0) btot[q] = carry;
}

// Step 2: chunk c's band starts (a block scan of the totals), each warp's
// cursors and the stable walk.
__global__ void __launch_bounds__(NT)
    band_place_kernel(const int* __restrict__ idx, int T_, int n, int nb, int band, int chunk,
                      int nc, Scratch s) {
  extern __shared__ int hist[];  // NW per-warp histograms of nb bands
  __shared__ int warp_sums[NW];
  const int tid = threadIdx.x, c = blockIdx.x;
  const long long t0 = (long long)c * chunk;
  int w0, w1;
  warp_part(min((long long)T_, t0), min((long long)T_, t0 + chunk), &w0, &w1);
  int* hw = hist + (tid >> 5) * nb;
  for (int i = tid; i < NW * nb; i += NT) hist[i] = 0;
  __syncthreads();
  count_walk(idx, w0, w1, n, band, hw);
  const int k = (nb + NT - 1) / NT;
  const int q0 = min(tid * k, nb), q1 = min(q0 + k, nb);
  int own = 0;
  for (int q = q0; q < q1; ++q) own += s.btot[q];
  int all;
  int run = block_exclusive_scan<NW>(own, warp_sums, &all);  // its barrier ends the counting
  for (int q = q0; q < q1; ++q) {
    if (c == 0) s.band_ptr[q] = run;
    warp_cursors(hist, nb, q, run + s.cnt[(size_t)q * nc + c]);
    run += s.btot[q];
  }
  if (c == 0 && tid == 0) {
    s.band_ptr[nb] = all;
    s.row_ptr[n] = all;
  }
  __syncthreads();
  place_walk(idx, w0, w1, n, band, key_bits(nb), hw, s.tok1, s.row1);
}

// Step 3: band blockIdx.x.
__global__ void __launch_bounds__(NT) scatter_sort_kernel(Scratch s, int band, int n) {
  extern __shared__ int h[];
  __shared__ int warp_sums[NW];
  sort_band(blockIdx.x, band, n, s, h, warp_sums);
}

// Step 4: one warp per piece.
template <typename T, int VEC>
__global__ void __launch_bounds__(32 * SUM_WARPS)
    scatter_sum_kernel(const T* __restrict__ g, int d, int lpt, int piece,
                       const int* __restrict__ valid, const int* __restrict__ perm_tok,
                       const int* __restrict__ perm_row, float* __restrict__ out,
                       float* __restrict__ head, float* __restrict__ tail) {
  const long long p = (long long)blockIdx.x * SUM_WARPS + (threadIdx.x >> 5);
  const int V = *valid;
  if (p * piece < V)
    sum_piece<T, VEC>(g, d, lpt, piece, (int)p, V, perm_tok, perm_row, out, head, tail);
}

// Step 5: rpw rows per warp.
__global__ void __launch_bounds__(FIX_NT)
    scatter_fixup_kernel(int n, int d, int piece, int rpw, const int* __restrict__ row_ptr,
                         const float* __restrict__ head, const float* __restrict__ tail,
                         float* __restrict__ out) {
  const long long r = ((long long)blockIdx.x * (FIX_NT / 32) + (threadIdx.x >> 5)) * rpw;
  if (r < n) fixup_rows((int)r, (int)min((long long)rpw, n - r), d, piece, row_ptr + r, head, tail,
                        out);
}

// lanes per token for rows of d elements read VEC at a time: d/VEC when it
// divides 32, 32 when d/VEC is a multiple of 32; 0 if neither
int lanes_per_token(int d, int vec) {
  if (d % vec) return 0;
  const int u = d / vec;
  if (u <= 32 && 32 % u == 0) return u;
  return u % 32 == 0 ? 32 : 0;
}

// Kernel K's dynamic shared-memory ceiling, set once per device: the
// attribute call costs host time.
template <auto K>
cudaError_t allow_smem(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T, int VEC>
cudaError_t run_scatter(const void* g_, const int* idx, float* out, const Scratch& s,
                        const Plan& p, int T_, int d, int n, int lpt, cudaStream_t st) {
  const T* g = static_cast<const T*>(g_);
  cudaError_t err;
  if (p.local) {
    constexpr int most = (NW * LOCAL_ROWS + LOCAL_ROWS + 1 + SMALL_T + 3) / 4 * 4 + NW * SMALL_D;
    if ((err = allow_smem<scatter_local_kernel<T, VEC>>(most * (int)sizeof(int))) != cudaSuccess)
      return err;
    const size_t bytes = sizeof(int) * ((size_t)local_part_offset(p.band, T_) + NW * d);
    scatter_local_kernel<T, VEC><<<p.nb, NT, bytes, st>>>(idx, g, out, T_, n, d, lpt, p.band);
    return cudaGetLastError();
  }
  const size_t sort_bytes = sizeof(int) * NW * (size_t)min(SUB, p.band);
  band_count_kernel<<<p.nc, NT, sizeof(int) * p.nb, st>>>(idx, T_, n, p.nb, p.band, p.chunk,
                                                          p.nc, s.cnt);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  band_scan_kernel<<<(unsigned)cdiv(p.nb, 8), 256, 0, st>>>(s.cnt, s.btot, p.nb, p.nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem<band_place_kernel>(HIST_INTS * (int)sizeof(int))) != cudaSuccess)
    return err;
  band_place_kernel<<<p.nc, NT, sizeof(int) * NW * (size_t)p.nb, st>>>(idx, T_, n, p.nb, p.band,
                                                                       p.chunk, p.nc, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem<scatter_sort_kernel>(HIST_INTS * (int)sizeof(int))) != cudaSuccess)
    return err;
  scatter_sort_kernel<<<p.nb, NT, sort_bytes, st>>>(s, p.band, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (p.n_pieces > 0) {
    scatter_sum_kernel<T, VEC><<<(unsigned)cdiv(p.n_pieces, SUM_WARPS), 32 * SUM_WARPS, 0, st>>>(
        g, d, lpt, p.piece, s.band_ptr + p.nb, s.perm_tok, s.perm_row, out, s.head, s.tail);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  scatter_fixup_kernel<<<(unsigned)cdiv(cdiv(n, p.rpw), FIX_NT / 32), FIX_NT, 0, st>>>(
      n, d, p.piece, p.rpw, s.row_ptr, s.head, s.tail, out);
  return cudaGetLastError();
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
  const Plan p = make_plan(T_, d, n_rows);
  char* base = static_cast<char*>(scratch);
  Scratch s;
  s.cnt = reinterpret_cast<int*>(base + p.cnt);
  s.btot = reinterpret_cast<int*>(base + p.btot);
  s.band_ptr = reinterpret_cast<int*>(base + p.band_ptr);
  s.tok1 = reinterpret_cast<int*>(base + p.tok1);
  s.row1 = reinterpret_cast<int*>(base + p.row1);
  s.row_ptr = reinterpret_cast<int*>(base + p.row_ptr);
  s.perm_tok = reinterpret_cast<int*>(base + p.perm_tok);
  s.perm_row = reinterpret_cast<int*>(base + p.perm_row);
  s.head = reinterpret_cast<float*>(base + p.head);
  s.tail = reinterpret_cast<float*>(base + p.tail);
  const int* ids = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  int lpt;
  cudaError_t err;
  if (is_bf16) {
    if (aligned && (lpt = lanes_per_token(d, 8)))
      err = run_scatter<__nv_bfloat16, 8>(g, ids, o, s, p, T_, d, n_rows, lpt, st);
    else
      err = run_scatter<__nv_bfloat16, 1>(g, ids, o, s, p, T_, d, n_rows,
                                          (lpt = lanes_per_token(d, 1)) ? lpt : 32, st);
  } else {
    if (aligned && (lpt = lanes_per_token(d, 4)))
      err = run_scatter<float, 4>(g, ids, o, s, p, T_, d, n_rows, lpt, st);
    else
      err = run_scatter<float, 1>(g, ids, o, s, p, T_, d, n_rows,
                                  (lpt = lanes_per_token(d, 1)) ? lpt : 32, st);
  }
  return (int)err;
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
