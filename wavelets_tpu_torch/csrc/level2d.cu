// One level of the periodic 2-D DWT, forward and inverse, driven by the
// float64 bands of ops/bands.py (filter and lifting wavelets alike).
//
// Replaces: the forward level of wavelets_tpu/ops/pallas/mxu2d.py,
// _mxu_packed_dma_kernel (packed mode) and _mxu_kernel (quads mode), and
// the inverse level _mxu_inv_kernel_v6 (f32) / _mxu_inv_kernel (bf16),
// called through _mxu_inv_call.
//
// Bound on the H100: memory traffic.  A level reads its active array once
// and writes the same number of samples once (four quarter-size
// quadrants); at 16384^2 float32 and 8 levels the pyramid reads about
// 1.33 GiB and writes about 1.33 GiB, about 0.85 ms at the spec sheet's
// 3.35 TB/s and more against the measured copy floor.  The arithmetic is
// small (cdf97: about 45 FMA per sample) and runs on the CUDA cores in
// the storage's own arithmetic type (f32 for f32 and bf16, f64 for f64),
// so no split-precision emulation is needed.
//
// Design: one block per TR x TC tile of output quads and one image
// (blockIdx.z).  Phase 1 filters the tile's input rows, plus the band's
// halo rows, along axis 1 straight from global memory into shared memory
// (one thread per output column pair, wrapped column reads, coalesced in
// pairs); phase 2 filters those rows along axis 0 out of shared memory and
// writes LL/LH/HL/HH through four caller-given strided planes, so packed
// mode writes the details straight into the full-size packed array.  The
// halo rows (span/2TR of the tile) are read twice, through L2.  Tiling for
// TMA and wider vector loads is left to later work.

#include "common.cuh"

namespace wtt {

constexpr int TR = 32;  // output rows (quads) per tile
constexpr int TC = 32;  // output columns (quads) per tile = blockDim.x
constexpr int BY = 8;   // blockDim.y

template <typename T>
struct Plane {  // a (B, rows, cols) view with unit column stride
  T* p;
  int64_t sb, sr;
  __device__ __forceinline__ T* row(int b, int r) const {
    return p + static_cast<int64_t>(b) * sb + static_cast<int64_t>(r) * sr;
  }
};

// Forward: x (m, n) -> four (m/2, n/2) quadrants.
//   LL[r,c] = sum_i sum_j cs[i] cs[j] x[2r+ds[i], 2c+ds[j]]
//   LH = (cs rows, cd cols), HL = (cd rows, cs cols), HH = (cd, cd);
// every index is taken mod m (rows) or mod n (columns).
template <typename T>
__global__ void __launch_bounds__(TC * BY)
level_fw_kernel(Plane<const T> x, int m, int n, Plane<T> ll, Plane<T> lh,
                Plane<T> hl, Plane<T> hh, const int* __restrict__ offs,
                const typename Acc<T>::type* __restrict__ coefs, int ns, int nd,
                int dmin, int span) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = ns + nd;
  const int rows_ext = 2 * TR + span;
  A* S = reinterpret_cast<A*>(smem_raw);  // row-filtered scaling, [rows_ext][TC]
  A* D = S + rows_ext * TC;               // row-filtered detail
  A* cf = D + rows_ext * TC;
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tx = threadIdx.x, ty = threadIdx.y;
  load_bands(cf, of, coefs, offs, nt, ty * TC + tx, TC * BY);
  __syncthreads();

  const int b = blockIdx.z;
  const int mh = m / 2, nh = n / 2;
  const int r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
  const int c = c0 + tx;
  const int tr = min(TR, mh - r0);
  // no column of this tile wraps: skip the modulo
  const bool inner = 2 * c0 + dmin >= 0 && 2 * (c0 + TC - 1) + dmin + span < n;

  if (c < nh) {
    for (int t = ty; t < 2 * tr + span; t += BY) {
      const T* row = x.row(b, wrap(2 * r0 + dmin + t, m));
      A s = 0, d = 0;
      for (int k = 0; k < ns; ++k) {
        int ci = 2 * c + of[k];
        s += cf[k] * ld(row[inner ? ci : wrap(ci, n)]);
      }
      for (int k = ns; k < nt; ++k) {
        int ci = 2 * c + of[k];
        d += cf[k] * ld(row[inner ? ci : wrap(ci, n)]);
      }
      S[t * TC + tx] = s;
      D[t * TC + tx] = d;
    }
  }
  __syncthreads();
  if (c < nh) {
    for (int rl = ty; rl < tr; rl += BY) {
      A vll = 0, vlh = 0, vhl = 0, vhh = 0;
      for (int k = 0; k < ns; ++k) {
        int t = (2 * rl + of[k] - dmin) * TC + tx;
        vll += cf[k] * S[t];
        vlh += cf[k] * D[t];
      }
      for (int k = ns; k < nt; ++k) {
        int t = (2 * rl + of[k] - dmin) * TC + tx;
        vhl += cf[k] * S[t];
        vhh += cf[k] * D[t];
      }
      const int r = r0 + rl;
      st(ll.row(b, r) + c, vll);
      st(lh.row(b, r) + c, vlh);
      st(hl.row(b, r) + c, vhl);
      st(hh.row(b, r) + c, vhh);
    }
  }
}

// Inverse: four (mh, nh) quadrants -> (2mh, 2nh), from the per-parity
// synthesis bands S0, D0, S1, D1 (in that order in the band table):
//   x[2r+p, 2c+q] = sum over (row band, col band) of the quadrant's
//   double sum, row band of parity p at (r + delta) mod mh, column band
//   of parity q at (c + delta) mod nh; LL takes (S, S), LH (S, D),
//   HL (D, S) and HH (D, D).
template <typename T>
__global__ void __launch_bounds__(TC * BY)
level_inv_kernel(Plane<const T> ll, Plane<const T> lh, Plane<const T> hl,
                 Plane<const T> hh, int mh, int nh, Plane<T> out,
                 const int* __restrict__ offs,
                 const typename Acc<T>::type* __restrict__ coefs, int n0, int n1,
                 int n2, int n3, int smin, int span) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = n0 + n1 + n2 + n3;
  const int rows_ext = TR + span;
  constexpr int W = 2 * TC;              // output columns per tile
  A* US = reinterpret_cast<A*>(smem_raw);  // column-synthesised LL|LH, [rows_ext][W]
  A* UD = US + rows_ext * W;               // column-synthesised HL|HH
  A* cf = UD + rows_ext * W;
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tx = threadIdx.x, ty = threadIdx.y;
  load_bands(cf, of, coefs, offs, nt, ty * TC + tx, TC * BY);
  __syncthreads();

  // band k-ranges: parity 0 -> S [0, n0), D [n0, e0); parity 1 -> S [e0, e1), D [e1, nt)
  const int e0 = n0 + n1, e1 = e0 + n2;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
  const int c = c0 + tx;
  const int tr = min(TR, mh - r0);
  const bool inner = c0 + smin >= 0 && c0 + TC - 1 + smin + span < nh;

  if (c < nh) {
    for (int t = ty; t < tr + span; t += BY) {
      const int q0 = wrap(r0 + smin + t, mh);
      const T* rll = ll.row(b, q0);
      const T* rlh = lh.row(b, q0);
      const T* rhl = hl.row(b, q0);
      const T* rhh = hh.row(b, q0);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int ks = q ? e0 : 0, kd = q ? e1 : n0, ke = q ? nt : e0;
        A us = 0, ud = 0;
        for (int k = ks; k < kd; ++k) {
          int ci = c + of[k];
          ci = inner ? ci : wrap(ci, nh);
          us += cf[k] * ld(rll[ci]);
          ud += cf[k] * ld(rhl[ci]);
        }
        for (int k = kd; k < ke; ++k) {
          int ci = c + of[k];
          ci = inner ? ci : wrap(ci, nh);
          us += cf[k] * ld(rlh[ci]);
          ud += cf[k] * ld(rhh[ci]);
        }
        US[t * W + 2 * tx + q] = us;
        UD[t * W + 2 * tx + q] = ud;
      }
    }
  }
  __syncthreads();
  for (int jl = tx; jl < W; jl += TC) {
    const int j = 2 * c0 + jl;
    if (j >= 2 * nh) continue;
    for (int i = ty; i < 2 * tr; i += BY) {
      const int rl = i >> 1, p = i & 1;
      const int ks = p ? e0 : 0, kd = p ? e1 : n0, ke = p ? nt : e0;
      A v = 0;
      for (int k = ks; k < kd; ++k) v += cf[k] * US[(rl + of[k] - smin) * W + jl];
      for (int k = kd; k < ke; ++k) v += cf[k] * UD[(rl + of[k] - smin) * W + jl];
      st(out.row(b, 2 * r0 + i) + j, v);
    }
  }
}

template <typename T>
int level_fw(int B, int m, int n, const void* x, int64_t xsb, int64_t xsr,
             void* const* o, const int64_t* osb, const int64_t* osr,
             const int* offs, const void* coefs, int ns, int nd, int dmin,
             int span, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  auto plane = [&](int i) { return Plane<T>{static_cast<T*>(o[i]), osb[i], osr[i]}; };
  const int mh = m / 2, nh = n / 2;
  dim3 grid((nh + TC - 1) / TC, (mh + TR - 1) / TR, B);
  size_t smem = 2 * static_cast<size_t>(2 * TR + span) * TC * sizeof(A) +
                static_cast<size_t>(ns + nd) * (sizeof(A) + sizeof(int));
  return launch(level_fw_kernel<T>, grid, dim3(TC, BY), smem, stream,
                Plane<const T>{static_cast<const T*>(x), xsb, xsr}, m, n,
                plane(0), plane(1), plane(2), plane(3), offs,
                static_cast<const A*>(coefs), ns, nd, dmin, span);
}

template <typename T>
int level_inv(int B, int mh, int nh, const void* const* q, const int64_t* qsb,
              const int64_t* qsr, void* out, int64_t osb, int64_t osr,
              const int* offs, const void* coefs, const int* nb, int smin,
              int span, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  auto plane = [&](int i) {
    return Plane<const T>{static_cast<const T*>(q[i]), qsb[i], qsr[i]};
  };
  dim3 grid((nh + TC - 1) / TC, (mh + TR - 1) / TR, B);
  const int nt = nb[0] + nb[1] + nb[2] + nb[3];
  size_t smem = 2 * static_cast<size_t>(TR + span) * 2 * TC * sizeof(A) +
                static_cast<size_t>(nt) * (sizeof(A) + sizeof(int));
  return launch(level_inv_kernel<T>, grid, dim3(TC, BY), smem, stream,
                plane(0), plane(1), plane(2), plane(3), mh, nh,
                Plane<T>{static_cast<T*>(out), osb, osr}, offs,
                static_cast<const A*>(coefs), nb[0], nb[1], nb[2], nb[3], smin,
                span);
}

}  // namespace wtt

extern "C" {

// Forward level.  o / osb / osr: the LL, LH, HL, HH planes (pointer, batch
// stride, row stride, in elements).  offs / coefs: the analysis band table
// on the device, ns scaling taps then nd detail taps; dmin is the smallest
// offset and span the largest minus the smallest.
int wtt_level_fw(int dtype, int B, int m, int n, const void* x, int64_t xsb,
                 int64_t xsr, void* const* o, const int64_t* osb,
                 const int64_t* osr, const int* offs, const void* coefs, int ns,
                 int nd, int dmin, int span, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::level_fw<float>(B, m, n, x, xsb, xsr, o, osb, osr, offs, coefs, ns, nd, dmin, span, s);
    case wtt::F64:
      return wtt::level_fw<double>(B, m, n, x, xsb, xsr, o, osb, osr, offs, coefs, ns, nd, dmin, span, s);
    case wtt::BF16:
      return wtt::level_fw<__nv_bfloat16>(B, m, n, x, xsb, xsr, o, osb, osr, offs, coefs, ns, nd, dmin, span, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Inverse level.  q / qsb / qsr: the LL, LH, HL, HH planes (mh, nh) to read;
// out: the (2mh, 2nh) plane to write.  nb: the tap counts of the synthesis
// bands S0, D0, S1, D1; smin / span as for the forward.
int wtt_level_inv(int dtype, int B, int mh, int nh, const void* const* q,
                  const int64_t* qsb, const int64_t* qsr, void* out,
                  int64_t osb, int64_t osr, const int* offs, const void* coefs,
                  const int* nb, int smin, int span, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::level_inv<float>(B, mh, nh, q, qsb, qsr, out, osb, osr, offs, coefs, nb, smin, span, s);
    case wtt::F64:
      return wtt::level_inv<double>(B, mh, nh, q, qsb, qsr, out, osb, osr, offs, coefs, nb, smin, span, s);
    case wtt::BF16:
      return wtt::level_inv<__nv_bfloat16>(B, mh, nh, q, qsb, qsr, out, osb, osr, offs, coefs, nb, smin, span, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* wtt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
