// All remaining levels of a small periodic 2-D DWT in one launch, forward
// and inverse, driven by the float64 bands of ops/bands.py.
//
// Replaces: wavelets_tpu/ops/pallas/tail2d.py, _fw_kernel (tail_fw) and
// _inv_kernel (tail_inv).
//
// Bound on the H100: launch latency and synchronisation, not memory.  At
// the end of a deep pyramid the active array is tiny (128^2 after seven
// levels of a 16384^2 image), so a level launch per level would cost a
// few microseconds each for almost no work.  One block per image keeps the
// whole active array resident in shared memory, in the arithmetic type,
// beside one scratch array of the same size; the size limit is therefore
// the 227 KB of shared memory a block may use (128 x 128 in f32 and bf16,
// 64 x 128 in f64), which ops/tail2d.py checks before it launches.
//
// Design: per level, a row pass (axis 1) from the array into the scratch
// and a column pass (axis 0) back, with __syncthreads() between passes and
// levels; the wrap is a true modulo on the level's own size, so it is exact
// at every depth.  The forward writes each level's detail quadrants
// straight to their packed offsets in the output and the final LL to its
// corner; the inverse reads the whole packed region once and writes the
// reconstructed array once.

#include "common.cuh"

namespace wtt {

constexpr int TAIL_THREADS = 512;

// Forward: x (m, n) -> packed (m, n), L levels.  Band table: ns scaling
// taps then nd detail taps.
template <typename T>
__global__ void __launch_bounds__(TAIL_THREADS)
tail_fw_kernel(const T* __restrict__ x, int64_t xsb, int64_t xsr, T* y, int64_t ysb,
               int64_t ysr, int m, int n, int L, const int* __restrict__ offs,
               const typename Acc<T>::type* __restrict__ coefs, int ns, int nd) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = ns + nd;
  A* act = reinterpret_cast<A*>(smem_raw);  // [m][n]: the active array
  A* tmp = act + m * n;                       // [m][n]: row-pass output
  A* cf = tmp + m * n;
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int b = blockIdx.x;
  const T* xb = x + static_cast<int64_t>(b) * xsb;
  T* yb = y + static_cast<int64_t>(b) * ysb;
  load_bands(cf, of, coefs, offs, nt, tid, nth);
  for (int i = tid; i < m * n; i += nth)
    act[i] = ld(xb[static_cast<int64_t>(i / n) * xsr + i % n]);
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const int ml = m >> l, nl = n >> l, mh = ml / 2, nh = nl / 2;
    for (int idx = tid; idx < ml * nh; idx += nth) {  // rows: [s | d] per row
      const int i = idx / nh, c = idx % nh;
      const A* row = act + i * n;
      A s = 0, d = 0;
      for (int k = 0; k < ns; ++k) s += cf[k] * row[wrap(2 * c + of[k], nl)];
      for (int k = ns; k < nt; ++k) d += cf[k] * row[wrap(2 * c + of[k], nl)];
      tmp[i * n + c] = s;
      tmp[i * n + nh + c] = d;
    }
    __syncthreads();
    for (int idx = tid; idx < mh * nl; idx += nth) {  // columns
      const int r = idx / nl, j = idx % nl;
      A s = 0, d = 0;
      for (int k = 0; k < ns; ++k) s += cf[k] * tmp[wrap(2 * r + of[k], ml) * n + j];
      for (int k = ns; k < nt; ++k) d += cf[k] * tmp[wrap(2 * r + of[k], ml) * n + j];
      if (j < nh)
        act[r * n + j] = s;                                  // LL: next level
      else
        st(yb + static_cast<int64_t>(r) * ysr + j, s);       // LH
      st(yb + static_cast<int64_t>(mh + r) * ysr + j, d);    // HL | HH
    }
    __syncthreads();
  }
  const int mL = m >> L, nL = n >> L;
  for (int idx = tid; idx < mL * nL; idx += nth) {
    const int r = idx / nL, c = idx % nL;
    st(yb + static_cast<int64_t>(r) * ysr + c, act[r * n + c]);
  }
}

// Inverse: packed (m, n) -> (m, n), L levels.  Band table: the synthesis
// bands S0, D0, S1, D1 with n0..n3 taps.
template <typename T>
__global__ void __launch_bounds__(TAIL_THREADS)
tail_inv_kernel(const T* __restrict__ y, int64_t ysb, int64_t ysr, T* out, int64_t osb,
                int64_t osr, int m, int n, int L, const int* __restrict__ offs,
                const typename Acc<T>::type* __restrict__ coefs, int n0, int n1,
                int n2, int n3) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = n0 + n1 + n2 + n3;
  const int e0 = n0 + n1, e1 = e0 + n2;
  A* act = reinterpret_cast<A*>(smem_raw);  // [m][n]: packed, then merged
  A* tmp = act + m * n;                       // [m][n]: column-synthesised halves
  A* cf = tmp + m * n;
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int b = blockIdx.x;
  const T* yb = y + static_cast<int64_t>(b) * ysb;
  T* ob = out + static_cast<int64_t>(b) * osb;
  load_bands(cf, of, coefs, offs, nt, tid, nth);
  for (int i = tid; i < m * n; i += nth)
    act[i] = ld(yb[static_cast<int64_t>(i / n) * ysr + i % n]);
  __syncthreads();

  for (int l = L; l >= 1; --l) {
    const int mh = m >> l, nh = n >> l, nl = 2 * nh;
    // axis 1: row t of (LL | LH) -> tmp row t, row t of (HL | HH) -> tmp row mh + t
    for (int idx = tid; idx < mh * nl; idx += nth) {
      const int t = idx / nl, j = idx % nl, c = j >> 1, q = j & 1;
      const int ks = q ? e0 : 0, kd = q ? e1 : n0, ke = q ? nt : e0;
      const A* top = act + t * n;
      const A* bot = act + (mh + t) * n;
      A us = 0, ud = 0;
      for (int k = ks; k < kd; ++k) {
        const int ci = wrap(c + of[k], nh);
        us += cf[k] * top[ci];
        ud += cf[k] * bot[ci];
      }
      for (int k = kd; k < ke; ++k) {
        const int ci = nh + wrap(c + of[k], nh);
        us += cf[k] * top[ci];
        ud += cf[k] * bot[ci];
      }
      tmp[t * n + j] = us;
      tmp[(mh + t) * n + j] = ud;
    }
    __syncthreads();
    // axis 0: merge the halves into the (2mh, nl) active array
    for (int idx = tid; idx < 2 * mh * nl; idx += nth) {
      const int i = idx / nl, j = idx % nl, r = i >> 1, p = i & 1;
      const int ks = p ? e0 : 0, kd = p ? e1 : n0, ke = p ? nt : e0;
      A v = 0;
      for (int k = ks; k < kd; ++k) v += cf[k] * tmp[wrap(r + of[k], mh) * n + j];
      for (int k = kd; k < ke; ++k) v += cf[k] * tmp[(mh + wrap(r + of[k], mh)) * n + j];
      act[i * n + j] = v;
    }
    __syncthreads();
  }
  for (int i = tid; i < m * n; i += nth)
    st(ob + static_cast<int64_t>(i / n) * osr + i % n, act[i]);
}

template <typename T>
size_t tail_smem(int m, int n, int nt) {
  using A = typename Acc<T>::type;
  return 2 * static_cast<size_t>(m) * n * sizeof(A) +
         static_cast<size_t>(nt) * (sizeof(A) + sizeof(int));
}

template <typename T>
int tail_fw(int B, int m, int n, int L, const void* x, int64_t xsb, int64_t xsr,
            void* y, int64_t ysb, int64_t ysr, const int* offs, const void* coefs,
            int ns, int nd, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  return launch(tail_fw_kernel<T>, dim3(B), dim3(TAIL_THREADS),
                tail_smem<T>(m, n, ns + nd), stream, static_cast<const T*>(x), xsb,
                xsr, static_cast<T*>(y), ysb, ysr, m, n, L, offs,
                static_cast<const A*>(coefs), ns, nd);
}

template <typename T>
int tail_inv(int B, int m, int n, int L, const void* y, int64_t ysb, int64_t ysr,
             void* out, int64_t osb, int64_t osr, const int* offs,
             const void* coefs, const int* nb, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  return launch(tail_inv_kernel<T>, dim3(B), dim3(TAIL_THREADS),
                tail_smem<T>(m, n, nb[0] + nb[1] + nb[2] + nb[3]), stream,
                static_cast<const T*>(y), ysb, ysr, static_cast<T*>(out), osb, osr,
                m, n, L, offs, static_cast<const A*>(coefs), nb[0], nb[1], nb[2],
                nb[3]);
}

}  // namespace wtt

extern "C" {

// Forward tail: x (B, m, n) -> packed planes y (B, m, n), L levels.
int wtt_tail_fw(int dtype, int B, int m, int n, int L, const void* x, int64_t xsb,
                int64_t xsr, void* y, int64_t ysb, int64_t ysr, const int* offs,
                const void* coefs, int ns, int nd, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::tail_fw<float>(B, m, n, L, x, xsb, xsr, y, ysb, ysr, offs, coefs, ns, nd, s);
    case wtt::F64:
      return wtt::tail_fw<double>(B, m, n, L, x, xsb, xsr, y, ysb, ysr, offs, coefs, ns, nd, s);
    case wtt::BF16:
      return wtt::tail_fw<__nv_bfloat16>(B, m, n, L, x, xsb, xsr, y, ysb, ysr, offs, coefs, ns, nd, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Inverse tail: packed planes y (B, m, n) -> out (B, m, n), L levels.
int wtt_tail_inv(int dtype, int B, int m, int n, int L, const void* y, int64_t ysb,
                 int64_t ysr, void* out, int64_t osb, int64_t osr, const int* offs,
                 const void* coefs, const int* nb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::tail_inv<float>(B, m, n, L, y, ysb, ysr, out, osb, osr, offs, coefs, nb, s);
    case wtt::F64:
      return wtt::tail_inv<double>(B, m, n, L, y, ysb, ysr, out, osb, osr, offs, coefs, nb, s);
    case wtt::BF16:
      return wtt::tail_inv<__nv_bfloat16>(B, m, n, L, y, ysb, ysr, out, osb, osr, offs, coefs, nb, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
