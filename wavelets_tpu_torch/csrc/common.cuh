// Helpers shared by the DWT kernels: storage <-> arithmetic conversion,
// the periodic wrap, the band tables in shared memory, and the launch
// status that every C entry point returns.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wtt {

// dtype codes of the C interface (ops/build.py mirrors them)
enum DType : int { F32 = 0, F64 = 1, BF16 = 2 };

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ double ld(double v) { return v; }
__device__ __forceinline__ float ld(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(double* p, double v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// True modulo: at tiny sizes (n = 2, 4, 8) several taps alias onto one
// sample, and the periodic transform is exactly that aliased sum.
__device__ __forceinline__ int wrap(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

// Arithmetic type of a storage type: f32 for f32 and bf16, f64 for f64.
template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

// Copy the band table (nt coefficients, then nt int32 offsets) into shared
// memory at `cf` / `of`; the caller synchronises before reading it.
template <typename A>
__device__ __forceinline__ void load_bands(A* cf, int* of, const A* coefs,
                                           const int* offs, int nt, int tid,
                                           int nthreads) {
  for (int k = tid; k < nt; k += nthreads) {
    cf[k] = coefs[k];
    of[k] = offs[k];
  }
}

// Launch `kernel` with `smem` bytes of dynamic shared memory and return
// the launch status: a refused launch (too many threads, too much shared
// memory) never runs, and only cudaGetLastError reports it.
template <typename K, typename... Args>
inline int launch(K kernel, dim3 grid, dim3 block, size_t smem,
                  cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, block, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wtt
