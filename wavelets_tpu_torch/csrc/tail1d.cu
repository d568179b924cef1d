// All remaining levels of a periodic 1-D DWT over (B, n) rows in one
// launch, forward (kernel G) and inverse (kernel H), driven by the float64
// bands of ops/bands.py.
//
// Replaces: the multi-level pyramid of wavelets_tpu/ops/pallas/pyramid1d.py
// (_fw_kernel, called through _stage_fw, and _inv_kernel through
// _stage_inv): several levels per launch with each level's detail
// streamed to its packed offset.  On the TPU a stage covers two levels of
// a long folded signal; here a whole row of up to 2^14 samples (f32,
// bf16; 2^13 in f64) stays in one block's shared memory for every
// remaining level, so the batched rows of a (4096, 4096) transform take
// all eight levels in one launch, and a long signal takes its deepest
// levels in one launch after the level kernels (csrc/level1d.cu).
//
// Bound on the H100: memory traffic at large batches (each row is read
// once and its packed result written once, whatever the level count), and
// launch latency plus the in-block synchronisation per level for a single
// short row.  The row and one scratch row sit in shared memory in the
// arithmetic type, so the size limit is the 227 KB a block may use
// (ops/tail1d.py, tail1d_fits).
//
// Design: one block per row.  Per level, each thread computes output
// pairs from the active row in shared memory into the scratch row (the
// wrap is a true modulo on the level's own length, skipped where no tap
// can wrap), streams the forward's details straight to their packed
// offsets in device memory, and __syncthreads() separates the levels.
// The intermediate scaling band stays in the arithmetic type, so bf16
// rounds once.  The forward writes the final scaling band to the row's
// head; the inverse reads the details from device memory in place and
// writes the reconstructed row only after its last level, so input and
// output may be the same memory in both directions.

#include "common.cuh"

namespace wtt {

constexpr int TAIL1D_THREADS = 256;

// Forward: x (n) -> packed (n), L levels: y[n>>l : n>>(l-1)] = d_l,
// y[: n>>L] = s_L.  Band table: ns scaling taps then nd detail taps.
template <typename T>
__global__ void __launch_bounds__(TAIL1D_THREADS)
tail1d_fw_kernel(const T* __restrict__ x, int64_t xs, T* y, int64_t ys, int n,
                 int L, const int* __restrict__ offs,
                 const typename Acc<T>::type* __restrict__ coefs, int ns, int nd,
                 int dmin, int span) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = ns + nd;
  A* cur = reinterpret_cast<A*>(smem_raw);  // [n]: the active row
  A* nxt = cur + n;                          // [n/2]: the next scaling band
  A* cf = nxt + n;
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x, nth = blockDim.x;
  const T* xb = x + static_cast<int64_t>(blockIdx.x) * xs;
  T* yb = y + static_cast<int64_t>(blockIdx.x) * ys;
  load_bands(cf, of, coefs, offs, nt, tid, nth);
  for (int i = tid; i < n; i += nth) cur[i] = ld(xb[i]);
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const int nl = n >> l, nh = nl / 2;
    for (int k = tid; k < nh; k += nth) {
      const int base = 2 * k;
      const bool inner = base + dmin >= 0 && base + dmin + span < nl;
      A s = 0, d = 0;
      for (int j = 0; j < ns; ++j) {
        const int i = base + of[j];
        s += cf[j] * cur[inner ? i : wrap(i, nl)];
      }
      for (int j = ns; j < nt; ++j) {
        const int i = base + of[j];
        d += cf[j] * cur[inner ? i : wrap(i, nl)];
      }
      nxt[k] = s;
      st(yb + nh + k, d);
    }
    __syncthreads();
    A* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int i = tid; i < (n >> L); i += nth) st(yb + i, cur[i]);
}

// Inverse: packed (n) -> (n), L levels.  Band table: the synthesis bands
// S0, D0, S1, D1 with n0..n3 taps; the details are read from y in place.
template <typename T>
__global__ void __launch_bounds__(TAIL1D_THREADS)
tail1d_inv_kernel(const T* __restrict__ y, int64_t ys, T* out, int64_t os, int n,
                  int L, const int* __restrict__ offs,
                  const typename Acc<T>::type* __restrict__ coefs, int n0, int n1,
                  int n2, int n3, int smin, int span) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = n0 + n1 + n2 + n3;
  const int e0 = n0 + n1, e1 = e0 + n2;
  A* cur = reinterpret_cast<A*>(smem_raw);  // [n]: the scaling band
  A* nxt = cur + n;                          // [n]: the merged band
  A* cf = nxt + n;
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x, nth = blockDim.x;
  const T* yb = y + static_cast<int64_t>(blockIdx.x) * ys;
  T* ob = out + static_cast<int64_t>(blockIdx.x) * os;
  load_bands(cf, of, coefs, offs, nt, tid, nth);
  for (int i = tid; i < (n >> L); i += nth) cur[i] = ld(yb[i]);
  __syncthreads();

  for (int l = L; l >= 1; --l) {
    const int nh = n >> l;
    const T* db = yb + nh;  // d_l, in place
    for (int j = tid; j < 2 * nh; j += nth) {
      const int k = j >> 1, p = j & 1;
      const int ks = p ? e0 : 0, kd = p ? e1 : n0, ke = p ? nt : e0;
      const bool inner = k + smin >= 0 && k + smin + span < nh;
      A v = 0;
      for (int q = ks; q < kd; ++q) {
        const int i = k + of[q];
        v += cf[q] * cur[inner ? i : wrap(i, nh)];
      }
      for (int q = kd; q < ke; ++q) {
        const int i = k + of[q];
        v += cf[q] * ld(db[inner ? i : wrap(i, nh)]);
      }
      nxt[j] = v;
    }
    __syncthreads();
    A* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int i = tid; i < n; i += nth) st(ob + i, cur[i]);
}

template <typename A>
size_t tail1d_smem(int n, int nt) {
  return 2 * static_cast<size_t>(n) * sizeof(A) +
         static_cast<size_t>(nt) * (sizeof(A) + sizeof(int));
}

// Threads per block: a warp at least, one per output pair of the first
// level at most.
inline int tail1d_threads(int n) {
  int t = ((n / 2 + 31) / 32) * 32;
  return t < 32 ? 32 : (t > TAIL1D_THREADS ? TAIL1D_THREADS : t);
}

template <typename T>
int tail1d_fw(int B, int n, int L, const void* x, int64_t xs, void* y,
              int64_t ys, const int* offs, const void* coefs, int ns, int nd,
              int dmin, int span, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  return launch(tail1d_fw_kernel<T>, dim3(B), dim3(tail1d_threads(n)),
                tail1d_smem<A>(n, ns + nd), stream, static_cast<const T*>(x), xs,
                static_cast<T*>(y), ys, n, L, offs, static_cast<const A*>(coefs),
                ns, nd, dmin, span);
}

template <typename T>
int tail1d_inv(int B, int n, int L, const void* y, int64_t ys, void* out,
               int64_t os, const int* offs, const void* coefs, const int* nb,
               int smin, int span, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  return launch(tail1d_inv_kernel<T>, dim3(B), dim3(tail1d_threads(n)),
                tail1d_smem<A>(n, nb[0] + nb[1] + nb[2] + nb[3]), stream,
                static_cast<const T*>(y), ys, static_cast<T*>(out), os, n, L,
                offs, static_cast<const A*>(coefs), nb[0], nb[1], nb[2], nb[3],
                smin, span);
}

}  // namespace wtt

extern "C" {

// Forward tail: x (B, n) with row stride xs -> packed rows y (B, n) with
// row stride ys, L levels.  Band table and dmin / span as for the level.
int wtt_tail1d_fw(int dtype, int B, int n, int L, const void* x, int64_t xs,
                  void* y, int64_t ys, const int* offs, const void* coefs, int ns,
                  int nd, int dmin, int span, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::tail1d_fw<float>(B, n, L, x, xs, y, ys, offs, coefs, ns, nd, dmin, span, s);
    case wtt::F64:
      return wtt::tail1d_fw<double>(B, n, L, x, xs, y, ys, offs, coefs, ns, nd, dmin, span, s);
    case wtt::BF16:
      return wtt::tail1d_fw<__nv_bfloat16>(B, n, L, x, xs, y, ys, offs, coefs, ns, nd, dmin, span, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Inverse tail: packed rows y (B, n) -> out (B, n), L levels.  nb: the tap
// counts of the synthesis bands S0, D0, S1, D1.
int wtt_tail1d_inv(int dtype, int B, int n, int L, const void* y, int64_t ys,
                   void* out, int64_t os, const int* offs, const void* coefs,
                   const int* nb, int smin, int span, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::tail1d_inv<float>(B, n, L, y, ys, out, os, offs, coefs, nb, smin, span, s);
    case wtt::F64:
      return wtt::tail1d_inv<double>(B, n, L, y, ys, out, os, offs, coefs, nb, smin, span, s);
    case wtt::BF16:
      return wtt::tail1d_inv<__nv_bfloat16>(B, n, L, y, ys, out, os, offs, coefs, nb, smin, span, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
