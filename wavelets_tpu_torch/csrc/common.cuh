// Helpers shared by the DWT kernels: storage <-> arithmetic conversion,
// the periodic wrap, the band tables in shared memory, and the launch
// status that every C entry point returns (plain and cluster launches).
#pragma once

#include <cstdint>
#include <mutex>
#include <vector>
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

// The dense window of one band of a table in shared memory: cw[w] = the
// tap at offset base + w of taps k0 <= k < k1 (0 where there is none),
// and bit w of the returned mask set where there is one; every offset
// lies in [base, base + W).  One pass over the taps, each placed by
// compile-time indices, so the window stays in registers.
template <int W, typename A>
__device__ __forceinline__ unsigned band_window(A (&cw)[W], const A* cf, const int* of,
                                                int k0, int k1, int base) {
  unsigned m = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) cw[w] = A(0);
  for (int k = k0; k < k1; ++k) {
    const int o = of[k] - base;
    const A c = cf[k];
    m |= 1u << o;
#pragma unroll
    for (int w = 0; w < W; ++w)
      if (w == o) cw[w] = c;
  }
  return m;
}

// cp.async of one 16-byte word from device memory into shared memory,
// its commit, and the wait for all but the newest group (the PTX under
// __CUDA_ARCH__; a plain copy elsewhere, where the commit and wait have
// nothing to do).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
#else
  *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void cp_async_wait1() {  // all but the newest group
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
}

template <int N>  // all but the N newest groups
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// 16 bytes of the arithmetic type (4 float, 2 double), and the unsigned
// word of BYTES bytes (a 16-, 8-, 4- or 2-byte load or store).
template <typename A> struct Vec16 { using type = float4; static constexpr int n = 4; };
template <> struct Vec16<double> { using type = double2; static constexpr int n = 2; };
template <int BYTES> struct Word { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned; };
template <> struct Word<2> { using type = unsigned short; };

// xv[j] = ld(src[j]) out of shared memory for the words that hold j < cnt
// (cnt <= N; the rest of xv is left as it is), read in words of G bytes
// (src G-byte aligned); the last word may reach past src[cnt - 1].
template <int G, typename T, typename A, int N>
__device__ __forceinline__ void load_words(A (&xv)[N], const T* src, int cnt) {
  constexpr int P = G / sizeof(T);  // elements per word
  using WT = typename Word<G>::type;
#pragma unroll
  for (int q = 0; q < N; q += P) {
    if (q >= cnt) break;
    __align__(16) T w[P];
    *reinterpret_cast<WT*>(w) = reinterpret_cast<const WT*>(src)[q / P];
#pragma unroll
    for (int e = 0; e < P; ++e)
      if (q + e < N) xv[q + e] = ld(w[e]);
  }
}

// load_words with the widest word that the caller's alignment `gran`
// (16, 8, 4 for a 2-byte element, or the element's size, in bytes)
// allows.
template <typename T, typename A, int N>
__device__ __forceinline__ void load_window(A (&xv)[N], const T* src, int cnt, int gran) {
  if (gran == 16)
    load_words<16>(xv, src, cnt);
  else if (gran == 8)
    load_words<8>(xv, src, cnt);
  else if constexpr (sizeof(T) == 2) {
    if (gran == 4)
      load_words<4>(xv, src, cnt);
    else
      load_words<2>(xv, src, cnt);
  } else {
    load_words<sizeof(T)>(xv, src, cnt);
  }
}

// The widest of 16 and 8 bytes (else the element) that divides the byte
// offsets `a` and `b` of a staged window.
__host__ __device__ inline int window_gran(long long a, long long b, int elem) {
  return (a % 16 == 0 && b % 16 == 0) ? 16 : (a % 8 == 0 && b % 8 == 0) ? 8 : elem;
}

// The least l with 2^l >= v (v >= 1).
inline int ceil_log2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// Shared memory one block may take on the H100 (227 KiB).
constexpr size_t SMEM_MAX = 232448;

// Launch `kernel` with `smem` bytes of dynamic shared memory and return
// the launch status: a refused launch (too many threads, too much shared
// memory) never runs, and only cudaGetLastError reports it.
template <typename K, typename... Args>
inline int launch(K kernel, dim3 grid, dim3 block, size_t smem,
                  cudaStream_t stream, Args... args) {
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, block, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `cluster` blocks (a power of two; above 8 only
// where the card allows a non-portable size) of `threads` threads and
// `smem` shared bytes the card holds at once (cudaOccupancyMaxActiveClusters),
// into *fit; returns the status.  None is an error: the caller raises, and
// nothing retries with another cluster size.  The attributes and the
// check run once per (device, kernel, shared bytes, cluster, threads).
struct ClusterFit {
  int device;
  const void* kernel;
  size_t smem;
  int cluster, threads, status, fit;
};

template <typename... P>
inline int cluster_fit(void (*kernel)(P...), int threads, size_t smem, int cluster,
                       int* fit) {
  static std::mutex mu;
  static std::vector<ClusterFit> fits;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* key = reinterpret_cast<const void*>(kernel);
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const ClusterFit& f : fits)
      if (f.device == device && f.kernel == key && f.smem == smem &&
          f.cluster == cluster && f.threads == threads) {
        *fit = f.fit;
        return f.status;
      }
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the most any launch may take, so that no configuration's launch lowers
  // what another's needs
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(SMEM_MAX));
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  *fit = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(fit, kernel, &cfg);
  const int status = e != cudaSuccess ? static_cast<int>(e)
                     : *fit < 1       ? static_cast<int>(cudaErrorLaunchOutOfResources)
                                      : 0;
  std::lock_guard<std::mutex> lock(mu);
  fits.push_back({device, key, smem, cluster, threads, status, *fit});
  return status;
}

// launch() for a grid of thread-block clusters: `blocks` blocks in
// clusters of `cluster` along x, once cluster_fit has found a place for
// one.
template <typename... P, typename... Args>
inline int launch_cluster(void (*kernel)(P...), int blocks, int threads,
                          size_t smem, int cluster, cudaStream_t stream,
                          Args... args) {
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaGetLastError();  // the status below is this launch's alone
  int fit = 0;
  const int status = cluster_fit(kernel, threads, smem, cluster, &fit);
  if (status != 0) return status;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// launch() for a persistent kernel: as many blocks as the card holds at
// once (its SMs times the blocks per SM that the threads and shared bytes
// allow), at most `work`; each block walks work items gridDim.x apart.
// The count is found once per (device, kernel, shared bytes, threads).
struct PersistentFit {
  int device;
  const void* kernel;
  size_t smem;
  int threads, blocks, status;
};

template <typename... P, typename... Args>
inline int launch_persistent(void (*kernel)(P...), int work, int threads, size_t smem,
                             cudaStream_t stream, Args... args) {
  static std::mutex mu;
  static std::vector<PersistentFit> fits;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (work < 1) return 0;
  cudaGetLastError();  // the status below is this launch's alone
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* key = reinterpret_cast<const void*>(kernel);
  int blocks = -1, status = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const PersistentFit& f : fits)
      if (f.device == device && f.kernel == key && f.smem == smem && f.threads == threads) {
        blocks = f.blocks;
        status = f.status;
      }
  }
  if (blocks < 0) {
    int per_sm = 0, sms = 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_MAX));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    status = e != cudaSuccess ? static_cast<int>(e)
             : per_sm < 1     ? static_cast<int>(cudaErrorLaunchOutOfResources)
                              : 0;
    blocks = per_sm * sms;
    std::lock_guard<std::mutex> lock(mu);
    fits.push_back({device, key, smem, threads, blocks, status});
  }
  if (status != 0) return status;
  kernel<<<dim3(blocks < work ? blocks : work), dim3(threads), smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wtt
