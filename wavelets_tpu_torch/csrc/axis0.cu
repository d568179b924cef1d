// One level of the periodic DWT along the middle axis of strided (B, R, C)
// views, forward (kernel I) and inverse (kernel J), driven by the float64
// bands of ops/bands.py (filter and lifting wavelets alike, no tap cap).
//
// Replaces: the axis-0 level of wavelets_tpu/ops/pallas/axis0.py --
// _fw_mxu_kernel / _fw_kernel (forward, the banded-matmul and the VPU
// roll-chain bodies of one computation) and _inv_mxu_kernel / _inv_kernel
// (inverse) -- and, in halo mode, their explicit-halo variants
// _fw_mxu_ext_kernel / _fw_ext_kernel and _inv_mxu_ext_kernel /
// _inv_ext_kernel, which the sharded drivers (parallel/sharded.py) run on
// each shard with the ring-exchanged rows of its neighbours.  On the TPU the level takes one (R, C) array and writes the
// packed (2, R/2, C); here the array is any (B, R, C) view with int64
// strides and a unit column stride, and the two output planes have their
// own strides.  So the 3-D driver (ops/dwt3d.py) runs the pass along axis
// 0 of a sub-cube (B = m', R = d', C = n') straight from its packed
// scratch into the packed output, with no copy, and B = 1 is the TPU
// kernels' (R, C) case.
//
// Bound on the H100: memory traffic.  A level reads its view once and
// writes the same number of samples once (a and d); each output costs
// about 2 * taps loads, which the shared-memory window serves, so device
// memory sees each input byte once (plus span/2TR of halo rows, through
// L2).  The arithmetic (cdf97: 16 FMA per output pair) is far below the
// FP32 peak.
//
// Design: threads run along C (loads and stores coalesced along the unit
// stride).  A block takes A0_LANES (batch, column) lanes: 32 columns of one
// batch item, or, where C < 32, every column of 32 / C batch items, so
// narrow deep levels keep the lanes busy; and A0_TR output pairs along R.
// It stages its 2 * A0_TR + span input rows (wrapped with a true modulo:
// R can be 2 at the deepest level) in shared memory and computes its
// outputs from there.  In halo mode (the template flag HALO) a staged row
// above the view is read from the caller's `above` rows and one below it
// from `below`, instead of wrapping: above[H_above + r] for r < 0,
// below[r - R] for r >= R (the inverse likewise from the halos of a and of
// d).  The wrapper checks that each halo covers the bands' reach, so with
// halos equal to the wrapped rows the result is bit for bit the periodic
// one; the branch costs nothing in the blocks whose window lies inside the
// view.  The inverse may read the scaling plane's leading
// (Bc, R/2, Cc) corner from a separate view: the 3-D inverse keeps the
// deeper level's result apart from the stored details, and this read
// joins them without a copy.  Tiling for TMA is left to later work.

#include "common.cuh"

namespace wtt {

constexpr int A0_LANES = 32;   // (batch, column) lanes per block = blockDim.x
constexpr int A0_BY = 8;       // blockDim.y
constexpr int A0_TR = 32;      // output rows (pairs) per block

template <typename T>
struct View3 {  // a (B, R, C) view with unit column stride
  T* p;
  int64_t sb, sr;
  __device__ __forceinline__ T* at(int b, int r, int c) const {
    return p + static_cast<int64_t>(b) * sb + static_cast<int64_t>(r) * sr + c;
  }
};

// The split of a level into blocks: `cw` columns by `bpb` batch items per
// block (cw * bpb <= A0_LANES), `ctiles` column tiles, `rtiles` row tiles;
// blockIdx.x runs over column tiles, then row tiles, then batch tiles.
struct A0Grid {
  int cw, bpb, ctiles, rtiles;
  int64_t blocks;
};

inline A0Grid a0_grid(int B, int Rh, int C) {
  A0Grid g;
  g.cw = C < A0_LANES ? C : A0_LANES;
  g.bpb = A0_LANES / g.cw;
  g.ctiles = (C + g.cw - 1) / g.cw;
  g.rtiles = (Rh + A0_TR - 1) / A0_TR;
  g.blocks = static_cast<int64_t>(g.ctiles) * g.rtiles * ((B + g.bpb - 1) / g.bpb);
  return g;
}

// This thread's lane: batch item b, column c, and the block's first
// output row k0; `valid` is false on the ragged edges.
struct Lane {
  int b, c, k0;
  bool valid;
};

__device__ __forceinline__ Lane a0_lane(const A0Grid& g, int B, int C) {
  const int bl = threadIdx.x / g.cw, cl = threadIdx.x - bl * g.cw;
  const int ct = blockIdx.x % g.ctiles;
  const int rest = blockIdx.x / g.ctiles;
  const int rt = rest % g.rtiles, bt = rest / g.rtiles;
  Lane l;
  l.b = bt * g.bpb + bl;
  l.c = ct * g.cw + cl;
  l.k0 = rt * A0_TR;
  l.valid = bl < g.bpb && l.b < B && l.c < C;
  return l;
}

// Forward: x (B, R, C) -> a, d (B, R/2, C):
//   a[b, k, c] = sum_i cs[i] x[b, (2k + ds[i]) mod R, c], d likewise.
// In halo mode the rows outside [0, R) come from above / below instead.
template <typename T, bool HALO>
__global__ void __launch_bounds__(A0_LANES * A0_BY)
axis0_fw_kernel(View3<const T> x, View3<T> a, View3<T> d, View3<const T> above,
                int ha, View3<const T> below, int B, int R, int C,
                A0Grid g, const int* __restrict__ offs,
                const typename Acc<T>::type* __restrict__ coefs, int ns, int nd,
                int dmin, int span) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = ns + nd;
  A* win = reinterpret_cast<A*>(smem_raw);  // [2 * A0_TR + span][A0_LANES]
  A* cf = win + (2 * A0_TR + span) * A0_LANES;
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tx = threadIdx.x, ty = threadIdx.y;
  load_bands(cf, of, coefs, offs, nt, ty * A0_LANES + tx, A0_LANES * A0_BY);

  const Lane l = a0_lane(g, B, C);
  const int tr = min(A0_TR, R / 2 - l.k0);
  const int start = 2 * l.k0 + dmin;
  const int rows = 2 * tr - 1 + span;        // rows 2k + dmin .. 2k + dmax
  const bool inner = start >= 0 && start + rows <= R;  // no row wraps
  if (l.valid) {
    for (int t = ty; t < rows; t += A0_BY) {
      const int r = start + t;
      const T* p;
      if (inner) p = x.at(l.b, r, l.c);
      else if (HALO) p = r < 0 ? above.at(l.b, ha + r, l.c)
                         : r >= R ? below.at(l.b, r - R, l.c) : x.at(l.b, r, l.c);
      else p = x.at(l.b, wrap(r, R), l.c);
      win[t * A0_LANES + tx] = ld(*p);
    }
  }
  __syncthreads();
  if (l.valid) {
    for (int kl = ty; kl < tr; kl += A0_BY) {
      const A* v = win + (2 * kl - dmin) * A0_LANES + tx;  // v[o * LANES] = x[2k + o]
      A sa = 0, da = 0;
      for (int k = 0; k < ns; ++k) sa += cf[k] * v[of[k] * A0_LANES];
      for (int k = ns; k < nt; ++k) da += cf[k] * v[of[k] * A0_LANES];
      st(a.at(l.b, l.k0 + kl, l.c), sa);
      st(d.at(l.b, l.k0 + kl, l.c), da);
    }
  }
}

// Inverse: a, d (B, Rh, C) -> x (B, 2Rh, C), from the per-parity synthesis
// bands S0, D0, S1, D1 (in that order in the band table):
//   x[b, 2k+p, c] = sum cS_p[i] a[b, (k + dS_p[i]) mod Rh, c]
//                 + sum cD_p[i] d[b, (k + dD_p[i]) mod Rh, c],
// where a[b, :, c] is read from `corner` for b < Bc and c < Cc.  In halo
// mode a row q < 0 of a (of d) is read from ah[0] (dh[0]) at ha + q, and a
// row q >= Rh from ah[1] (dh[1]) at q - Rh.
template <typename T, bool HALO>
__global__ void __launch_bounds__(A0_LANES * A0_BY)
axis0_inv_kernel(View3<const T> a, View3<const T> d, View3<const T> corner,
                 int Bc, int Cc, View3<const T> ah0, View3<const T> ah1,
                 View3<const T> dh0, View3<const T> dh1, int ha,
                 View3<T> x, int B, int Rh, int C, A0Grid g,
                 const int* __restrict__ offs,
                 const typename Acc<T>::type* __restrict__ coefs, int n0, int n1,
                 int n2, int n3, int smin, int span) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = n0 + n1 + n2 + n3;
  const int e0 = n0 + n1, e1 = e0 + n2;
  const int W = A0_TR + span;                // window rows
  A* ws = reinterpret_cast<A*>(smem_raw);    // [W][A0_LANES] scaling window
  A* wd = ws + W * A0_LANES;                 // [W][A0_LANES] detail window
  A* cf = wd + W * A0_LANES;
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tx = threadIdx.x, ty = threadIdx.y;
  load_bands(cf, of, coefs, offs, nt, ty * A0_LANES + tx, A0_LANES * A0_BY);

  const Lane l = a0_lane(g, B, C);
  const int tr = min(A0_TR, Rh - l.k0);
  const int start = l.k0 + smin;
  const int rows = tr + span;
  const bool inner = start >= 0 && start + rows <= Rh;
  if (l.valid) {
    const View3<const T>& src = (l.b < Bc && l.c < Cc) ? corner : a;
    for (int t = ty; t < rows; t += A0_BY) {
      const int q = start + t;
      const T *ps, *pd;
      if (inner) {
        ps = src.at(l.b, q, l.c);
        pd = d.at(l.b, q, l.c);
      } else if (HALO) {
        ps = q < 0 ? ah0.at(l.b, ha + q, l.c)
             : q >= Rh ? ah1.at(l.b, q - Rh, l.c) : src.at(l.b, q, l.c);
        pd = q < 0 ? dh0.at(l.b, ha + q, l.c)
             : q >= Rh ? dh1.at(l.b, q - Rh, l.c) : d.at(l.b, q, l.c);
      } else {
        ps = src.at(l.b, wrap(q, Rh), l.c);
        pd = d.at(l.b, wrap(q, Rh), l.c);
      }
      ws[t * A0_LANES + tx] = ld(*ps);
      wd[t * A0_LANES + tx] = ld(*pd);
    }
  }
  __syncthreads();
  if (l.valid) {
    for (int i = ty; i < 2 * tr; i += A0_BY) {
      const int kl = i >> 1, p = i & 1;
      const int ks = p ? e0 : 0, kd = p ? e1 : n0, ke = p ? nt : e0;
      const int base = (kl - smin) * A0_LANES + tx;  // [base + o * LANES] = row k + o
      A v = 0;
      for (int k = ks; k < kd; ++k) v += cf[k] * ws[base + of[k] * A0_LANES];
      for (int k = kd; k < ke; ++k) v += cf[k] * wd[base + of[k] * A0_LANES];
      st(x.at(l.b, 2 * l.k0 + i, l.c), v);
    }
  }
}

constexpr int64_t A0_MAX_BLOCKS = 2147483647;

// The k-th of the caller's halo views (pointers, batch and row strides), or
// an empty view where there are none.
template <typename T>
View3<const T> halo_view(const void* const* hp, const int64_t* hsb,
                         const int64_t* hsr, int k) {
  if (hp == nullptr) return View3<const T>{nullptr, 0, 0};
  return View3<const T>{static_cast<const T*>(hp[k]), hsb[k], hsr[k]};
}

template <typename T, bool HALO>
int axis0_fw(int B, int R, int C, const void* x, int64_t xsb, int64_t xsr,
             void* a, int64_t asb, int64_t asr, void* d, int64_t dsb,
             int64_t dsr, const void* const* hp, const int64_t* hsb,
             const int64_t* hsr, int ha, const int* offs, const void* coefs,
             int ns, int nd, int dmin, int span, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const A0Grid g = a0_grid(B, R / 2, C);
  if (g.blocks > A0_MAX_BLOCKS) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(2 * A0_TR + span) * A0_LANES * sizeof(A) +
                      static_cast<size_t>(ns + nd) * (sizeof(A) + sizeof(int));
  return launch(axis0_fw_kernel<T, HALO>, dim3(static_cast<unsigned>(g.blocks)),
                dim3(A0_LANES, A0_BY), smem, stream,
                View3<const T>{static_cast<const T*>(x), xsb, xsr},
                View3<T>{static_cast<T*>(a), asb, asr},
                View3<T>{static_cast<T*>(d), dsb, dsr},
                halo_view<T>(hp, hsb, hsr, 0), ha, halo_view<T>(hp, hsb, hsr, 1),
                B, R, C, g, offs, static_cast<const A*>(coefs), ns, nd, dmin,
                span);
}

template <typename T, bool HALO>
int axis0_inv(int B, int Rh, int C, const void* a, int64_t asb, int64_t asr,
              const void* d, int64_t dsb, int64_t dsr, const void* corner,
              int64_t csb, int64_t csr, int Bc, int Cc, const void* const* hp,
              const int64_t* hsb, const int64_t* hsr, int ha, void* x,
              int64_t xsb, int64_t xsr, const int* offs, const void* coefs,
              const int* nb, int smin, int span, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const A0Grid g = a0_grid(B, Rh, C);
  if (g.blocks > A0_MAX_BLOCKS) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int nt = nb[0] + nb[1] + nb[2] + nb[3];
  const size_t smem = 2 * static_cast<size_t>(A0_TR + span) * A0_LANES * sizeof(A) +
                      static_cast<size_t>(nt) * (sizeof(A) + sizeof(int));
  return launch(axis0_inv_kernel<T, HALO>, dim3(static_cast<unsigned>(g.blocks)),
                dim3(A0_LANES, A0_BY), smem, stream,
                View3<const T>{static_cast<const T*>(a), asb, asr},
                View3<const T>{static_cast<const T*>(d), dsb, dsr},
                View3<const T>{static_cast<const T*>(corner), csb, csr}, Bc, Cc,
                halo_view<T>(hp, hsb, hsr, 0), halo_view<T>(hp, hsb, hsr, 1),
                halo_view<T>(hp, hsb, hsr, 2), halo_view<T>(hp, hsb, hsr, 3), ha,
                View3<T>{static_cast<T*>(x), xsb, xsr}, B, Rh, C, g, offs,
                static_cast<const A*>(coefs), nb[0], nb[1], nb[2], nb[3], smin,
                span);
}

template <bool HALO>
int fw_dispatch(int dtype, int B, int R, int C, const void* x, int64_t xsb,
                int64_t xsr, void* a, int64_t asb, int64_t asr, void* d,
                int64_t dsb, int64_t dsr, const void* const* hp,
                const int64_t* hsb, const int64_t* hsr, int ha, const int* offs,
                const void* coefs, int ns, int nd, int dmin, int span,
                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return axis0_fw<float, HALO>(B, R, C, x, xsb, xsr, a, asb, asr, d, dsb, dsr, hp, hsb, hsr, ha, offs, coefs, ns, nd, dmin, span, s);
    case F64:
      return axis0_fw<double, HALO>(B, R, C, x, xsb, xsr, a, asb, asr, d, dsb, dsr, hp, hsb, hsr, ha, offs, coefs, ns, nd, dmin, span, s);
    case BF16:
      return axis0_fw<__nv_bfloat16, HALO>(B, R, C, x, xsb, xsr, a, asb, asr, d, dsb, dsr, hp, hsb, hsr, ha, offs, coefs, ns, nd, dmin, span, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool HALO>
int inv_dispatch(int dtype, int B, int Rh, int C, const void* a, int64_t asb,
                 int64_t asr, const void* d, int64_t dsb, int64_t dsr,
                 const void* corner, int64_t csb, int64_t csr, int Bc, int Cc,
                 const void* const* hp, const int64_t* hsb, const int64_t* hsr,
                 int ha, void* x, int64_t xsb, int64_t xsr, const int* offs,
                 const void* coefs, const int* nb, int smin, int span,
                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return axis0_inv<float, HALO>(B, Rh, C, a, asb, asr, d, dsb, dsr, corner, csb, csr, Bc, Cc, hp, hsb, hsr, ha, x, xsb, xsr, offs, coefs, nb, smin, span, s);
    case F64:
      return axis0_inv<double, HALO>(B, Rh, C, a, asb, asr, d, dsb, dsr, corner, csb, csr, Bc, Cc, hp, hsb, hsr, ha, x, xsb, xsr, offs, coefs, nb, smin, span, s);
    case BF16:
      return axis0_inv<__nv_bfloat16, HALO>(B, Rh, C, a, asb, asr, d, dsb, dsr, corner, csb, csr, Bc, Cc, hp, hsb, hsr, ha, x, xsb, xsr, offs, coefs, nb, smin, span, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wtt

extern "C" {

// Forward level along the middle axis.  x: (B, R, C) with batch and row
// strides xsb, xsr; a, d: the (B, R/2, C) output planes with their own
// strides (all strides in elements, unit column stride).  offs / coefs:
// the analysis band table on the device, ns scaling taps then nd detail
// taps; dmin is the smallest offset and span the largest minus the
// smallest.
int wtt_axis0_fw(int dtype, int B, int R, int C, const void* x, int64_t xsb,
                 int64_t xsr, void* a, int64_t asb, int64_t asr, void* d,
                 int64_t dsb, int64_t dsr, const int* offs, const void* coefs,
                 int ns, int nd, int dmin, int span, void* stream) {
  return wtt::fw_dispatch<false>(dtype, B, R, C, x, xsb, xsr, a, asb, asr, d,
                                 dsb, dsr, nullptr, nullptr, nullptr, 0, offs,
                                 coefs, ns, nd, dmin, span, stream);
}

// The forward level in halo mode: hp[0] / hp[1] (batch strides hsb[k], row
// strides hsr[k]) are the (B, ha, C) rows above x and the rows below it,
// read where wtt_axis0_fw would wrap.  The caller makes them cover the
// bands' reach: ha >= -dmin rows above, dmin + span - 1 rows below.
int wtt_axis0_fw_halo(int dtype, int B, int R, int C, const void* x,
                      int64_t xsb, int64_t xsr, void* a, int64_t asb,
                      int64_t asr, void* d, int64_t dsb, int64_t dsr,
                      const void* const* hp, const int64_t* hsb,
                      const int64_t* hsr, int ha, const int* offs,
                      const void* coefs, int ns, int nd, int dmin, int span,
                      void* stream) {
  return wtt::fw_dispatch<true>(dtype, B, R, C, x, xsb, xsr, a, asb, asr, d,
                                dsb, dsr, hp, hsb, hsr, ha, offs, coefs, ns, nd,
                                dmin, span, stream);
}

// Inverse level along the middle axis.  a, d: the (B, Rh, C) planes to
// read; corner (csb, csr): where a's leading (Bc, Rh, Cc) block is read
// from instead (Bc = Cc = 0: nowhere); x: the (B, 2Rh, C) output.  nb: the
// tap counts of the synthesis bands S0, D0, S1, D1; smin / span as for the
// forward.
int wtt_axis0_inv(int dtype, int B, int Rh, int C, const void* a, int64_t asb,
                  int64_t asr, const void* d, int64_t dsb, int64_t dsr,
                  const void* corner, int64_t csb, int64_t csr, int Bc, int Cc,
                  void* x, int64_t xsb, int64_t xsr, const int* offs,
                  const void* coefs, const int* nb, int smin, int span,
                  void* stream) {
  return wtt::inv_dispatch<false>(dtype, B, Rh, C, a, asb, asr, d, dsb, dsr,
                                  corner, csb, csr, Bc, Cc, nullptr, nullptr,
                                  nullptr, 0, x, xsb, xsr, offs, coefs, nb, smin,
                                  span, stream);
}

// The inverse level in halo mode, without a corner: hp[0..3] (strides
// hsb[k], hsr[k]) are the rows above a (ha of them), below a, above d (ha)
// and below d, read where wtt_axis0_inv would wrap.  The caller makes them
// cover the bands' reach: ha >= -smin rows above, smin + span below.
int wtt_axis0_inv_halo(int dtype, int B, int Rh, int C, const void* a,
                       int64_t asb, int64_t asr, const void* d, int64_t dsb,
                       int64_t dsr, const void* const* hp, const int64_t* hsb,
                       const int64_t* hsr, int ha, void* x, int64_t xsb,
                       int64_t xsr, const int* offs, const void* coefs,
                       const int* nb, int smin, int span, void* stream) {
  return wtt::inv_dispatch<true>(dtype, B, Rh, C, a, asb, asr, d, dsb, dsr,
                                 nullptr, 0, 0, 0, 0, hp, hsb, hsr, ha, x, xsb,
                                 xsr, offs, coefs, nb, smin, span, stream);
}

}  // extern "C"
