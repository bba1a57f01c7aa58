// bf16 tensor-core building blocks for Hopper (sm_90a): 64 x 64 bf16 tiles
// in shared memory, warpgroup products on them (wgmma, f32 sums), the
// warpgroup and cluster barriers the kernels share, and cp.async copies
// from global to shared memory.
//
// Tile layout.  A 64 x 64 bf16 tile is stored as 8 x 8 blocks of 8 x 8
// elements ("core matrices", 128 contiguous bytes each, rows of 16 bytes):
//   element (r, c) at blk(r, c) = (r/8)*512 + (c/8)*64 + (r%8)*8 + c%8.
// This is the no-swizzle canonical layout wgmma reads through a descriptor,
// both K-major (a tile stored [n][k]: 16-byte rows along k) and MN-major (a
// tile stored [k][n]); ldmatrix reads it too, since every 16-byte row of a
// core matrix is contiguous, and its eight rows fall on eight bank groups.
//
// A product D (64 x N) [+]= A (64 x 64) @ B (64 x N) runs on one warpgroup
// (4 warps): A comes from registers, loaded with ldmatrix in the mma.sync
// fragment layout, warp q of the group holding rows 16q..16q+15; B is read
// by wgmma itself through a descriptor.  Thread (warp q, lane) holds
//   d[4j + 0..1] = D[16q + lane/4][8j + 2*(lane%4) + {0, 1}]
//   d[4j + 2..3] = D[16q + lane/4 + 8][8j + 2*(lane%4) + {0, 1}]
// for j < N/8.  A tile written with ordinary stores and then read by wgmma
// needs async_fence() by the writers before the barrier that orders them.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

constexpr int TILE = 64 * 64;  // elements of a tile

__device__ __forceinline__ int blk(int r, int c) {
  return (r >> 3) * 512 + (c >> 3) * 64 + (r & 7) * 8 + (c & 7);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The A fragment (16 x 16 at rows m0.., depth kk..) of a tile: A_KM, the
// tile holds A^T, i.e. [k][m] (else [m][k]).
template <bool A_KM>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* A, int kk,
                                       int m0, int lane) {
  const int j = lane >> 3, r = lane & 7;
  if (A_KM)
    ldsm_x4_t(a, A + blk(kk + r + 8 * (j >> 1), m0 + 8 * (j & 1)));
  else
    ldsm_x4(a, A + blk(m0 + (lane & 15), kk + 8 * (lane >> 4)));
}

// wgmma descriptor of the k16 x N slab of B at depth kk, columns n0..:
// B_KN, the tile holds B as [k][n] (MN-major), else as B^T, [n][k]
// (K-major).  LBO is the stride between core matrices along k, SBO along n.
template <bool B_KN>
__device__ __forceinline__ uint64_t b_desc(const __nv_bfloat16* B, int kk, int n0) {
  const uint32_t addr = smem_addr(B + (B_KN ? blk(kk, n0) : blk(n0, kk)));
  const uint64_t lbo = B_KN ? 1024 : 128, sbo = B_KN ? 128 : 1024;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads of an accumulator across a wait
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// generic-proxy stores of this thread -> visible to wgmma after a barrier
__device__ __forceinline__ void async_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TB));
}

// two floats as one bf16x2 register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator d of a 64 x 64 product, rounded to bf16, as the A
// fragments of a following product (depth = d's columns): the accumulator
// and the A operand share the mma.sync fragment layout, so the result stays
// in registers.
__device__ __forceinline__ void acc_to_a(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = pack_bf16(d[8 * ks + 0], d[8 * ks + 1]);
    a[ks][1] = pack_bf16(d[8 * ks + 2], d[8 * ks + 3]);
    a[ks][2] = pack_bf16(d[8 * ks + 4], d[8 * ks + 5]);
    a[ks][3] = pack_bf16(d[8 * ks + 6], d[8 * ks + 7]);
  }
}

// Issue d [+]= A @ B[:, n0 : n0 + N] with A given as fragments in
// registers (acc_to_a or load_a), as one wgmma group; neither a nor d may be
// touched before wg_wait.
template <bool B_KN, int N>
__device__ __forceinline__ void wg_issue_a(float (&d)[N / 2], const uint32_t (&a)[4][4],
                                           const __nv_bfloat16* B, int n0, bool accumulate) {
  static_assert(N == 64 || N == 32, "wgmma width");
#pragma unroll
  for (int i = 0; i < N / 2; ++i) fence_operand(d[i]);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t desc = b_desc<B_KN>(B, 16 * ks, n0);
    const int scale_d = (accumulate || ks > 0) ? 1 : 0;
    if constexpr (N == 64)
      wgmma_n64<B_KN ? 1 : 0>(d, a[ks], desc, scale_d);
    else
      wgmma_n32<B_KN ? 1 : 0>(d, a[ks], desc, scale_d);
  }
  wgmma_commit();
}

// Issue d [+]= A @ B[:, n0 : n0 + N] on this warpgroup (q = warp index in
// the group) as one wgmma group; accumulate = false starts from zero.  a
// holds the A fragments until the product completes: neither a nor d may be
// touched before wg_wait.
template <bool A_KM, bool B_KN, int N>
__device__ __forceinline__ void wg_issue(float (&d)[N / 2], uint32_t (&a)[4][4],
                                         const __nv_bfloat16* A, const __nv_bfloat16* B, int n0,
                                         bool accumulate, int q, int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) load_a<A_KM>(a[ks], A, 16 * ks, 16 * q, lane);
  wg_issue_a<B_KN, N>(d, a, B, n0, accumulate);
}

// Wait for every product this warpgroup issued; d (one of them) is then
// complete.
template <int M>
__device__ __forceinline__ void wg_wait(float (&d)[M]) {
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < M; ++i) fence_operand(d[i]);
}

// d1 [+]= A1 @ B1 and d2 [+]= A2 @ B2 (both 64 x 64) on this warpgroup, both
// in flight before one wait
template <bool A1_KM, bool B1_KN, bool A2_KM, bool B2_KN>
__device__ __forceinline__ void wg_gemm2(float (&d1)[32], const __nv_bfloat16* A1,
                                         const __nv_bfloat16* B1, float (&d2)[32],
                                         const __nv_bfloat16* A2, const __nv_bfloat16* B2,
                                         bool accumulate, int q, int lane) {
  uint32_t a1[4][4], a2[4][4];
  wg_issue<A1_KM, B1_KN, 64>(d1, a1, A1, B1, 0, accumulate, q, lane);
  wg_issue<A2_KM, B2_KN, 64>(d2, a2, A2, B2, 0, accumulate, q, lane);
  wg_wait(d1);
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_operand(d2[i]);
}

// A warpgroup's 64 x 64 accumulator (or any values in its layout: thread
// (warp q, lane) holds rows 16q + fg (+ 8), columns 8j + 2fc (+ 1), fg =
// lane / 4, fc = lane % 4), rounded to bf16, into a tile
__device__ __forceinline__ void store_bf16(const float (&d)[32], __nv_bfloat16* t, int q, int fg,
                                           int fc) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<__nv_bfloat162*>(t + blk(16 * q + fg + 8 * hh, 8 * j + 2 * fc)) =
          __floats2bfloat162_rn(d[4 * j + 2 * hh], d[4 * j + 2 * hh + 1]);
}

// a barrier of the 128 threads of warpgroup grp (named barrier grp + 1)
__device__ __forceinline__ void wg_sync(int grp) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(grp + 1) : "memory");
}

// the two halves of cluster.sync(), so that work can run between them
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes global -> shared without registers; completes at cp_async_wait_all
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace mma_bf16
