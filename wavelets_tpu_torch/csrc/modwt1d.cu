// One level of the periodic MODWT over (B, N) rows, forward (kernel K) and
// inverse (kernel M): the undecimated, dilated filter pair of
// ops/modwt.py, with the taps k * 2^(j-1) apart.
//
// Replaces: wavelets_tpu/ops/pallas/modwt1d.py, _fw_kernel (v1 and w1 from
// one read of v) and _inv_kernel (v from v1 and w1).  On the TPU a whole
// row lives in VMEM so that the dilated roll wraps exactly, which limits
// it to N % 128 == 0 and B % 8 == 0; here the wrap is a true modulo on
// every tap, so any N >= 2^j and any B run, and the reach (taps - 1) *
// 2^(j-1), which can exceed N several times over, wraps as often as it
// must.  The Julia reference's GPU extension takes the same form
// (_modwt_step_kernel!, one thread per output sample).
//
// Bound on the H100: memory traffic.  The forward reads v once and writes
// two planes; the inverse reads two planes and writes one.  Each output
// sums `taps` samples a dilation apart; at small dilations neighbouring
// threads share them through L1, and the arithmetic (db4: 16 FMA per
// sample) is far below the FP32 peak.
//
// Design: one thread per output sample, a block per M_THREADS samples of
// one row (blockIdx.x runs over row tiles, then rows).  Every plane has a
// row stride and an element stride, so the forward writes w_j straight
// into its column of the (B, N, L+1) output (element stride L+1) and the
// inverse reads it from there.  A shared-memory window for the small
// dilations is left to later work.

#include "common.cuh"

namespace wtt {

constexpr int M_THREADS = 256;

template <typename T>
struct Rows {  // a (B, N) view: row stride sr, element stride se
  T* p;
  int64_t sr, se;
  __device__ __forceinline__ T* at(int b, int t) const {
    return p + static_cast<int64_t>(b) * sr + static_cast<int64_t>(t) * se;
  }
};

// Forward: v (B, N) -> v1, w1 (B, N), with dil = 2^(j-1) mod N:
//   v1[t] = sum_n g[n] v[(t - n dil) mod N],  w1[t] = sum_n h[n] v[(t - n dil) mod N].
template <typename T>
__global__ void __launch_bounds__(M_THREADS)
modwt_fw_kernel(Rows<const T> v, Rows<T> v1, Rows<T> w1, int N, int tiles,
                int dil, const typename Acc<T>::type* __restrict__ taps,
                int nt) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* cf = reinterpret_cast<A*>(smem_raw);  // g[0..nt), then h[0..nt)
  for (int k = threadIdx.x; k < 2 * nt; k += M_THREADS) cf[k] = taps[k];
  __syncthreads();
  const int b = blockIdx.x / tiles;
  const int t = (blockIdx.x % tiles) * M_THREADS + threadIdx.x;
  if (t >= N) return;
  A sv = 0, sw = 0;
  int idx = t;  // (t - n dil) mod N
  for (int n = 0; n < nt; ++n) {
    const A x = ld(*v.at(b, idx));
    sv += cf[n] * x;
    sw += cf[nt + n] * x;
    idx -= dil;
    if (idx < 0) idx += N;
  }
  st(v1.at(b, t), sv);
  st(w1.at(b, t), sw);
}

// Inverse: v1, w1 (B, N) -> v (B, N):
//   v[t] = sum_n h[n] w1[(t + n dil) mod N] + g[n] v1[(t + n dil) mod N].
template <typename T>
__global__ void __launch_bounds__(M_THREADS)
modwt_inv_kernel(Rows<const T> v1, Rows<const T> w1, Rows<T> v, int N,
                 int tiles, int dil,
                 const typename Acc<T>::type* __restrict__ taps, int nt) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* cf = reinterpret_cast<A*>(smem_raw);
  for (int k = threadIdx.x; k < 2 * nt; k += M_THREADS) cf[k] = taps[k];
  __syncthreads();
  const int b = blockIdx.x / tiles;
  const int t = (blockIdx.x % tiles) * M_THREADS + threadIdx.x;
  if (t >= N) return;
  A acc = 0;
  int idx = t;  // (t + n dil) mod N
  for (int n = 0; n < nt; ++n) {
    acc += cf[nt + n] * ld(*w1.at(b, idx)) + cf[n] * ld(*v1.at(b, idx));
    idx += dil;
    if (idx >= N) idx -= N;
  }
  st(v.at(b, t), acc);
}

constexpr int64_t M_MAX_BLOCKS = 2147483647;

template <typename T>
int modwt_fw(int B, int N, int dil, const void* v, int64_t vsr, int64_t vse,
             void* v1, int64_t v1sr, int64_t v1se, void* w1, int64_t w1sr,
             int64_t w1se, const void* taps, int nt, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int tiles = (N + M_THREADS - 1) / M_THREADS;
  const int64_t blocks = static_cast<int64_t>(B) * tiles;
  if (blocks > M_MAX_BLOCKS) return static_cast<int>(cudaErrorInvalidConfiguration);
  return launch(modwt_fw_kernel<T>, dim3(static_cast<unsigned>(blocks)),
                dim3(M_THREADS), 2 * static_cast<size_t>(nt) * sizeof(A), stream,
                Rows<const T>{static_cast<const T*>(v), vsr, vse},
                Rows<T>{static_cast<T*>(v1), v1sr, v1se},
                Rows<T>{static_cast<T*>(w1), w1sr, w1se}, N, tiles, dil,
                static_cast<const A*>(taps), nt);
}

template <typename T>
int modwt_inv(int B, int N, int dil, const void* v1, int64_t v1sr,
              int64_t v1se, const void* w1, int64_t w1sr, int64_t w1se,
              void* v, int64_t vsr, int64_t vse, const void* taps, int nt,
              cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int tiles = (N + M_THREADS - 1) / M_THREADS;
  const int64_t blocks = static_cast<int64_t>(B) * tiles;
  if (blocks > M_MAX_BLOCKS) return static_cast<int>(cudaErrorInvalidConfiguration);
  return launch(modwt_inv_kernel<T>, dim3(static_cast<unsigned>(blocks)),
                dim3(M_THREADS), 2 * static_cast<size_t>(nt) * sizeof(A), stream,
                Rows<const T>{static_cast<const T*>(v1), v1sr, v1se},
                Rows<const T>{static_cast<const T*>(w1), w1sr, w1se},
                Rows<T>{static_cast<T*>(v), vsr, vse}, N, tiles, dil,
                static_cast<const A*>(taps), nt);
}

}  // namespace wtt

extern "C" {

// Forward level.  v: (B, N) with row stride vsr and element stride vse;
// v1, w1: the (B, N) output planes with their own strides (in elements).
// dil: the dilation 2^(j-1) reduced mod N.  taps: g then h (nt each) in
// the arithmetic type, on the device.
int wtt_modwt_fw(int dtype, int B, int N, int dil, const void* v, int64_t vsr,
                 int64_t vse, void* v1, int64_t v1sr, int64_t v1se, void* w1,
                 int64_t w1sr, int64_t w1se, const void* taps, int nt,
                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::modwt_fw<float>(B, N, dil, v, vsr, vse, v1, v1sr, v1se, w1, w1sr, w1se, taps, nt, s);
    case wtt::F64:
      return wtt::modwt_fw<double>(B, N, dil, v, vsr, vse, v1, v1sr, v1se, w1, w1sr, w1se, taps, nt, s);
    case wtt::BF16:
      return wtt::modwt_fw<__nv_bfloat16>(B, N, dil, v, vsr, vse, v1, v1sr, v1se, w1, w1sr, w1se, taps, nt, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Inverse level.  v1, w1: the (B, N) planes to read; v: the (B, N) output;
// strides, dil and taps as for the forward.
int wtt_modwt_inv(int dtype, int B, int N, int dil, const void* v1,
                  int64_t v1sr, int64_t v1se, const void* w1, int64_t w1sr,
                  int64_t w1se, void* v, int64_t vsr, int64_t vse,
                  const void* taps, int nt, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::modwt_inv<float>(B, N, dil, v1, v1sr, v1se, w1, w1sr, w1se, v, vsr, vse, taps, nt, s);
    case wtt::F64:
      return wtt::modwt_inv<double>(B, N, dil, v1, v1sr, v1se, w1, w1sr, w1se, v, vsr, vse, taps, nt, s);
    case wtt::BF16:
      return wtt::modwt_inv<__nv_bfloat16>(B, N, dil, v1, v1sr, v1se, w1, w1sr, w1se, v, vsr, vse, taps, nt, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
