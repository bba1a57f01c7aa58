// Node-table gather gradient (scatter-add) and token bincount, for NVIDIA
// Hopper (sm_90a).
//
// scatter_add replaces the TPU kernel matcha_tpu/ops/table_scatter.py:
// _scatter_kernel (through scatter_add_matmul): for g (T, d) in f32 or bf16
// and idx (T,) int32 it writes out (n_rows, d) f32 with
//   out[r] = sum over t with idx[t] == r of g[t].
// The TPU kernel builds a one-hot matrix and runs the sum on its matrix unit,
// because a random read-modify-write is slow there.  Here each block OWNS a
// band of ROWS output rows: it scans the whole idx vector (458 KB at the
// training step's T = 114,688, read from L2 by every block), and each warp
// adds the g rows of the matching tokens of its contiguous token chunk, in a
// fixed order, into its own shared-memory copy of the band.  The 8 warp
// copies are then summed in warp order and stored.  No atomics anywhere: the
// result is deterministic (the same bits on every run for one grid).
// Bound on this card: bytes, g read once (T*d*2 B in bf16), out written once
// (n_rows*d*4 B), idx read once: 16.3 MB at the step's shapes -> 4.9 us at
// 3.35 TB/s; the operations (T*d adds) are negligible.
//
// bincount replaces _count_kernel (through bincount_f32): counts of each id
// in idx (T,) as (n_rows,) f32.  A shared-memory int histogram per block,
// integer atomics into a global int32 histogram (exact, so deterministic),
// then a conversion to f32.  Bound: bytes, idx read once + counts written.
// Ids outside [0, n_rows) are ignored by both kernels, as the JAX package's
// scatter-add drops them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int NWARP = NT / 32;
constexpr int ACC_FLOATS = 24 * 64;  // per-warp band: ROWS * d floats
constexpr int MAX_HIST = 49152;      // ids a shared histogram holds (192 KB)

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// grid.x = number of row bands; dynamic shared memory NWARP * rows * d f32
template <typename T>
__global__ void __launch_bounds__(NT)
    scatter_add_kernel(const T* __restrict__ g, const int* __restrict__ idx,
                       float* __restrict__ out, int T_, int d, int n_rows, int rows) {
  extern __shared__ float acc[];  // [NWARP][rows][d]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, n_rows);
  float* mine = acc + (size_t)warp * rows * d;
  for (int i = lane; i < rows * d; i += 32) mine[i] = 0.f;
  __syncwarp();

  // warp w scans its own contiguous chunk [t0, t1) of tokens, 128 at a
  // time (4 per lane, one int4 load when aligned), and adds the g rows of
  // the tokens in its band in a fixed order
  const int chunk = ((T_ + NWARP - 1) / NWARP + 127) / 128 * 128;
  const int t0 = min(warp * chunk, T_);
  const int t1 = min(t0 + chunk, T_);
  const bool vec = (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  for (int base = t0; base < t1; base += 128) {
    const int t = base + 4 * lane;
    int r[4];
    if (vec && t + 3 < t1) {
      const int4 v = *reinterpret_cast<const int4*>(idx + t);
      r[0] = v.x;
      r[1] = v.y;
      r[2] = v.z;
      r[3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) r[q] = t + q < t1 ? idx[t + q] : -1;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned hit = __ballot_sync(0xffffffffu, r[q] >= r0 && r[q] < r1);
      while (hit) {
        const int src = __ffs(hit) - 1;
        hit &= hit - 1;
        const int rr = __shfl_sync(0xffffffffu, r[q], src) - r0;
        const size_t grow = (size_t)(base + 4 * src + q) * d;
        for (int c = lane; c < d; c += 32) mine[rr * d + c] += load_f(g, grow + c);
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // sum the warp copies in warp order; one store per output
  for (int i = threadIdx.x; i < (r1 - r0) * d; i += NT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) s += acc[(size_t)w * rows * d + i];
    out[(size_t)r0 * d + i] = s;
  }
}

__global__ void __launch_bounds__(NT)
    bincount_shared_kernel(const int* __restrict__ idx, int* __restrict__ counts, int T_,
                           int n_rows) {
  extern __shared__ int hist[];
  for (int i = threadIdx.x; i < n_rows; i += NT) hist[i] = 0;
  __syncthreads();
  for (int t = blockIdx.x * NT + threadIdx.x; t < T_; t += gridDim.x * NT) {
    const int r = idx[t];
    if (r >= 0 && r < n_rows) atomicAdd(&hist[r], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_rows; i += NT)
    if (hist[i]) atomicAdd(&counts[i], hist[i]);
}

__global__ void __launch_bounds__(NT)
    bincount_global_kernel(const int* __restrict__ idx, int* __restrict__ counts, int T_,
                           int n_rows) {
  for (int t = blockIdx.x * NT + threadIdx.x; t < T_; t += gridDim.x * NT) {
    const int r = idx[t];
    if (r >= 0 && r < n_rows) atomicAdd(&counts[r], 1);
  }
}

__global__ void __launch_bounds__(NT)
    to_float_kernel(const int* __restrict__ counts, float* __restrict__ out, int n) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i < n) out[i] = (float)counts[i];
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms > 0 ? sms : 132;
}

}  // namespace

// g (T, d) f32 (is_bf16 = 0) or bf16, idx (T,) int32 -> out (n_rows, d) f32,
// every element written.  1 <= d <= 1536.  Returns the CUDA error (0 = ok).
extern "C" int matcha_scatter_add(const void* g, const void* idx, void* out, int T_, int d,
                                  int n_rows, int is_bf16, void* stream) {
  if (T_ < 0 || d <= 0 || d > ACC_FLOATS || n_rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = ACC_FLOATS / d;
  const int smem = NWARP * rows * d * (int)sizeof(float);
  const unsigned grid = (unsigned)((n_rows + rows - 1) / rows);
  cudaError_t err;
  if (is_bf16) {
    err = cudaFuncSetAttribute(scatter_add_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    scatter_add_kernel<__nv_bfloat16><<<grid, NT, smem, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const int*>(idx),
        static_cast<float*>(out), T_, d, n_rows, rows);
  } else {
    err = cudaFuncSetAttribute(scatter_add_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    scatter_add_kernel<float><<<grid, NT, smem, s>>>(static_cast<const float*>(g),
                                                     static_cast<const int*>(idx),
                                                     static_cast<float*>(out), T_, d, n_rows,
                                                     rows);
  }
  return (int)cudaGetLastError();
}

// idx (T,) int32 -> out (n_rows,) f32 counts; counts_scratch (n_rows,) int32
// is overwritten.  Returns the CUDA error (0 = ok).
extern "C" int matcha_bincount(const void* idx, void* counts_scratch, void* out, int T_,
                               int n_rows, void* stream) {
  if (T_ < 0 || n_rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* counts = static_cast<int*>(counts_scratch);
  cudaError_t err = cudaMemsetAsync(counts, 0, (size_t)n_rows * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int per_block = 8 * NT;  // tokens per block of the histogram pass
  int grid = (T_ + per_block - 1) / per_block;
  grid = grid < 1 ? 1 : (grid > 4 * sm_count() ? 4 * sm_count() : grid);
  if (n_rows <= MAX_HIST) {
    const int smem = n_rows * (int)sizeof(int);
    err = cudaFuncSetAttribute(bincount_shared_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    bincount_shared_kernel<<<grid, NT, smem, s>>>(static_cast<const int*>(idx), counts, T_,
                                                  n_rows);
  } else {
    bincount_global_kernel<<<grid, NT, 0, s>>>(static_cast<const int*>(idx), counts, T_,
                                               n_rows);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  to_float_kernel<<<(n_rows + NT - 1) / NT, NT, 0, s>>>(counts, static_cast<float*>(out),
                                                       n_rows);
  return (int)cudaGetLastError();
}

extern "C" const char* matcha_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
