// One level of the periodic 3-D DWT in one pass, forward (level3_fw) and
// inverse (level3_inv), for wavelets whose bands reach only inside the
// sample pair: analysis offsets in {0, 1}, synthesis offsets 0 (haar, as a
// filter and as a lifting scheme).  Driven by the float64 bands of
// ops/bands.py, as kernels A, B, I and J are.
//
// Replaces, for those wavelets, the 3-D driver's two launches a level
// (ops/dwt3d.py): kernel A on the d' slabs into a volume-sized scratch,
// then kernel I along axis 0 into the packed output; J into a scratch,
// then B, for the inverse.  Both are counterparts of the TPU's
// wavelets_tpu/ops/pallas/dwt3d.py level (dwt3_pallas / idwt3_pallas).
//
// Bound on the H100: memory traffic.  With pair reach a level is a
// separate 2 x 2 x 2 block transform for each output position: 8 inputs
// in, one value of each of the 8 octants out, no halo.  So a level reads
// its active sub-cube once and writes the same number of samples once,
// where A+I and J+B read and write it twice; at 512^3 float32 one pass
// moves 1.07 GB, 0.320 ms at the spec sheet's 3.35 TB/s.
//
// Design:
// * Persistent blocks (launch_persistent) of 256 threads walk the output
//   rows' column groups, a flat index over (k, i, g): octant row (k, i)
//   and group g of E = 16 / sizeof(T) output columns.  A thread reads
//   the group's 2E input columns (32 bytes) of the four input rows (2k +
//   a, 2i + b), a, b in {0, 1}, as two 16-byte words each, and stores one
//   16-byte word into each of the eight octants (the inverse: one word
//   from each octant, two into each of the four output rows).  Where the
//   rows are no whole 16-byte words (VEC = false: the deep levels of
//   small volumes) a thread takes one output column and scalar loads and
//   stores.  An octant (the inverse: the output) whose base or strides
//   are no whole words takes element stores (the `vout` bits).
// * Everything happens in registers; nothing is shared between threads,
//   so the kernel has no barrier and no shared memory.
// * The arithmetic of the chain it replaces: one explicit fma per tap,
//   from 0, in the arithmetic type (f32 for f32 and bf16, f64 for f64).
//   Forward in A's and I's axis order, -1, -2, then -3, each band's taps
//   in their order: the scaling band ascending, the detail band as the
//   table has it (a filter's runs descending).  Inverse in J's and B's
//   order, -3, -1, then -2, each output its S tap then its D tap.  So
//   float32 and float64 outputs equal the A+I and J+B chains bit for bit.
//   bfloat16 keeps the values between axes in float32 and rounds once,
//   where the chain rounds to its bfloat16 scratch between the two
//   launches.

#include "common.cuh"

namespace wtt {

constexpr int L3_THREADS = 256;

template <typename T>
struct Vol {  // a (d, m, n) view with unit column stride
  T* p;
  int64_t sd, sr;
  __device__ __forceinline__ T* row(int k, int i) const {
    return p + static_cast<int64_t>(k) * sd + static_cast<int64_t>(i) * sr;
  }
};

// The eight octants of a level, octant z = 4 zd + 2 zm + zn (zd, zm, zn:
// 0 for the scaling half along axes -3, -2, -1, 1 for the detail half).
template <typename T>
struct Octants {
  Vol<T> o[8];
};

// Geometry: the octants' rows mh, the groups of a row (nh / E on the
// 16-byte path, else nh) and the work items dh * mh * groups.
struct L3Geom {
  int mh, groups, items;
};

// An analysis band as the chain runs it: taps a then b (n of them), tap a
// at offset oa with coefficient ca.
template <typename A>
struct Band {
  A ca, cb;
  int oa, ob, n;
};

// A band of the table (taps k0 .. k0 + n - 1): ascending offsets, or
// descending where `desc` (kernels A and I: a filter's detail band).
template <typename A>
__device__ __forceinline__ Band<A> ana_band(const int* of, const A* cf, int k0, int n,
                                            bool desc) {
  Band<A> b{A(0), A(0), 0, 0, n};
  if (n == 0) return b;
  int i = k0, j = k0 + 1;
  if (n == 2 && (of[i] > of[j]) != desc) {
    i = k0 + 1;
    j = k0;
  }
  b.oa = of[i];
  b.ca = cf[i];
  if (n == 2) {
    b.ob = of[j];
    b.cb = cf[j];
  }
  return b;
}

// One analysis sum of the pair (x0, x1).
template <typename A>
__device__ __forceinline__ A ana(const Band<A>& b, A x0, A x1) {
  A acc = A(0);
  if (b.n > 0) acc = fma(b.ca, b.oa ? x1 : x0, acc);
  if (b.n > 1) acc = fma(b.cb, b.ob ? x1 : x0, acc);
  return acc;
}

// The synthesis of one parity: its S tap (if any), then its D tap.
template <typename A>
struct Syn {
  A cs, cd;
  bool hs, hd;
};

template <typename A>
__device__ __forceinline__ A syn(const Syn<A>& q, A s, A d) {
  A acc = A(0);
  if (q.hs) acc = fma(q.cs, s, acc);
  if (q.hd) acc = fma(q.cd, d, acc);
  return acc;
}

// The work item t: octant row (k, i) and the group's first output column.
__device__ __forceinline__ void l3_item(const L3Geom& g, unsigned t, int per, int& k,
                                        int& i, int& c0) {
  const int r = static_cast<int>(t / g.groups);
  c0 = (static_cast<int>(t) - r * g.groups) * per;
  k = r / g.mh;
  i = r - k * g.mh;
}

// Forward: x (2dh, 2mh, 2nh) -> the eight octants (dh, mh, nh):
//   O[zd, zm, zn][k, i, c] = band_zd over a of band_zm over b of band_zn
//   over q of x[2k + a, 2i + b, 2c + q],
// the n axis first, then m, then d, each band_z the scaling (0) or detail
// (1) analysis band.
template <typename T, bool VEC>
__global__ void __launch_bounds__(L3_THREADS, 2)
level3_fw_kernel(Vol<const T> x, Octants<T> y, unsigned vout, L3Geom g,
                 const int* __restrict__ offs,
                 const typename Acc<T>::type* __restrict__ coefs, int ns, int nd) {
  using A = typename Acc<T>::type;
  constexpr int E = 16 / sizeof(T);
  constexpr int P = VEC ? E : 1;  // output columns per thread
  using W16 = typename Word<16>::type;
  const bool drev = nd > 1 && offs[ns + 1] < offs[ns];
  Band<A> band[2];
  band[0] = ana_band(offs, coefs, 0, ns, false);
  band[1] = ana_band(offs, coefs, ns, nd, drev);

  const unsigned stride = gridDim.x * L3_THREADS, items = g.items;
  for (unsigned t = blockIdx.x * L3_THREADS + threadIdx.x; t < items; t += stride) {
    int k, i, c0;
    l3_item(g, t, P, k, i, c0);
    // v[a][b]: input row (2k + a, 2i + b), columns 2 c0 .. 2 (c0 + P) - 1
    __align__(16) T v[2][2][2 * P];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const T* src = x.row(2 * k + a, 2 * i + b) + 2 * c0;
        if (VEC) {
          reinterpret_cast<W16*>(v[a][b])[0] = reinterpret_cast<const W16*>(src)[0];
          reinterpret_cast<W16*>(v[a][b])[1] = reinterpret_cast<const W16*>(src)[1];
        } else {
          v[a][b][0] = src[0];
          v[a][b][1] = src[1];
        }
      }
    // w[z][e]: octant z at column c0 + e, one column at a time
    __align__(16) T w[8][P];
#pragma unroll
    for (int e = 0; e < P; ++e) {
      A r[2][2][2];  // axis -1 of row (2k + a, 2i + b): r[a][b][zn]
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const A x0 = ld(v[a][b][2 * e]), x1 = ld(v[a][b][2 * e + 1]);
          r[a][b][0] = ana(band[0], x0, x1);
          r[a][b][1] = ana(band[1], x0, x1);
        }
#pragma unroll
      for (int zm = 0; zm < 2; ++zm)
#pragma unroll
        for (int zn = 0; zn < 2; ++zn) {
          // axis -2 on each of the two slabs, then axis -3 into octants
          // (0, zm, zn) and (1, zm, zn)
          const A c0v = ana(band[zm], r[0][0][zn], r[0][1][zn]);
          const A c1v = ana(band[zm], r[1][0][zn], r[1][1][zn]);
#pragma unroll
          for (int zd = 0; zd < 2; ++zd)
            st(&w[4 * zd + 2 * zm + zn][e], ana(band[zd], c0v, c1v));
        }
    }
#pragma unroll
    for (int z = 0; z < 8; ++z) {
      T* dst = y.o[z].row(k, i) + c0;
      if (VEC && ((vout >> z) & 1)) {
        *reinterpret_cast<W16*>(dst) = *reinterpret_cast<const W16*>(w[z]);
      } else {
#pragma unroll
        for (int e = 0; e < P; ++e) dst[e] = w[z][e];
      }
    }
  }
}

// Inverse: the eight octants (dh, mh, nh) -> x (2dh, 2mh, 2nh):
//   axis -3 (J): P[a, zm, zn] = syn_a(O[0, zm, zn], O[1, zm, zn]);
//   axis -1 (B): U[a, zm, q] = syn_q(P[a, zm, 0], P[a, zm, 1]);
//   axis -2 (B): x[2k + a, 2i + p, 2c + q] = syn_p(U[a, 0, q], U[a, 1, q]),
// with syn_p the parity-p synthesis: its S tap, then its D tap.
template <typename T, bool VEC>
__global__ void __launch_bounds__(L3_THREADS, 2)
level3_inv_kernel(Octants<const T> y, Vol<T> x, bool vout, L3Geom g,
                  const int* __restrict__ offs,
                  const typename Acc<T>::type* __restrict__ coefs, int n0, int n1,
                  int n2, int n3) {
  using A = typename Acc<T>::type;
  constexpr int E = 16 / sizeof(T);
  constexpr int P = VEC ? E : 1;  // input columns per thread
  using W16 = typename Word<16>::type;
  // the bands S0, D0, S1, D1: at most one tap each, at offset 0
  const int e0 = n0 + n1, e1 = e0 + n2;
  Syn<A> par[2];
  par[0] = Syn<A>{n0 ? coefs[0] : A(0), n1 ? coefs[n0] : A(0), n0 > 0, n1 > 0};
  par[1] = Syn<A>{n2 ? coefs[e0] : A(0), n3 ? coefs[e1] : A(0), n2 > 0, n3 > 0};

  const unsigned stride = gridDim.x * L3_THREADS, items = g.items;
  for (unsigned t = blockIdx.x * L3_THREADS + threadIdx.x; t < items; t += stride) {
    int k, i, c0;
    l3_item(g, t, P, k, i, c0);
    // p[a][zm][zn][e]: axis -3 of the octants' column c0 + e
    A p[2][2][2][P];
    {
      A o[8][P];
#pragma unroll
      for (int z = 0; z < 8; ++z) {
        const T* src = y.o[z].row(k, i) + c0;
        __align__(16) T v[P];
        if (VEC)
          *reinterpret_cast<W16*>(v) = *reinterpret_cast<const W16*>(src);
        else
          v[0] = src[0];
#pragma unroll
        for (int e = 0; e < P; ++e) o[z][e] = ld(v[e]);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int z = 0; z < 4; ++z)
#pragma unroll
          for (int e = 0; e < P; ++e)
            p[a][z >> 1][z & 1][e] = syn(par[a], o[z][e], o[4 + z][e]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      // axis -1: u[zm][q][e], output column 2 (c0 + e) + q of the pair of
      // rows zm; then axis -2 into rows 2i and 2i + 1
      A u[2][2][P];
#pragma unroll
      for (int zm = 0; zm < 2; ++zm)
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < P; ++e)
            u[zm][q][e] = syn(par[q], p[a][zm][0][e], p[a][zm][1][e]);
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        __align__(16) T w[2 * P];
#pragma unroll
        for (int e = 0; e < P; ++e)
#pragma unroll
          for (int q = 0; q < 2; ++q) st(w + 2 * e + q, syn(par[pr], u[0][q][e], u[1][q][e]));
        T* dst = x.row(2 * k + a, 2 * i + pr) + 2 * c0;
        if (VEC && vout) {
          reinterpret_cast<W16*>(dst)[0] = reinterpret_cast<const W16*>(w)[0];
          reinterpret_cast<W16*>(dst)[1] = reinterpret_cast<const W16*>(w)[1];
        } else {
#pragma unroll
          for (int e = 0; e < 2 * P; ++e) dst[e] = w[e];
        }
      }
    }
  }
}

inline bool l3_words(const void* p, int64_t sd, int64_t sr, int e) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sd % e == 0 && sr % e == 0;
}

// The geometry, the 16-byte path where nh and every view the kernel reads
// are whole 16-byte words; false where the items do not fit an int.
template <typename T>
bool l3_geom(int dh, int mh, int nh, bool vec, L3Geom& g) {
  constexpr int E = 16 / sizeof(T);
  g.mh = mh;
  g.groups = vec ? nh / E : nh;
  const int64_t items = static_cast<int64_t>(dh) * mh * g.groups;
  g.items = static_cast<int>(items);
  return items <= 2147483647;
}

// The eight octants of the level in the packed array y (depth and row
// strides sd, sr): octant z at y + zd dh sd + zm mh sr + zn nh, except
// the scaling octant (z = 0), which is `lll` where that is given.
template <typename T>
Octants<T> octants_of(T* y, int64_t sd, int64_t sr, T* lll, int64_t lsd, int64_t lsr,
                      int dh, int mh, int nh) {
  Octants<T> o;
  for (int z = 0; z < 8; ++z)
    o.o[z] = Vol<T>{y + (z >> 2) * dh * sd + ((z >> 1) & 1) * mh * sr + (z & 1) * nh, sd, sr};
  if (lll != nullptr) o.o[0] = Vol<T>{lll, lsd, lsr};
  return o;
}

template <typename T>
int level3_fw(int dh, int mh, int nh, const void* x, int64_t xsd, int64_t xsr, void* y,
              int64_t ysd, int64_t ysr, void* lll, int64_t lsd, int64_t lsr, const int* offs,
              const void* coefs, int ns, int nd, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  constexpr int E = 16 / sizeof(T);
  const bool vec = nh % E == 0 && l3_words(x, xsd, xsr, E);
  const Octants<T> o = octants_of(static_cast<T*>(y), ysd, ysr, static_cast<T*>(lll), lsd,
                                  lsr, dh, mh, nh);
  unsigned vout = 0;
  for (int z = 0; z < 8; ++z)
    if (l3_words(o.o[z].p, o.o[z].sd, o.o[z].sr, E)) vout |= 1u << z;
  L3Geom g;
  if (!l3_geom<T>(dh, mh, nh, vec, g)) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int work = (g.items + L3_THREADS - 1) / L3_THREADS;
  const Vol<const T> xv{static_cast<const T*>(x), xsd, xsr};
  const A* cf = static_cast<const A*>(coefs);
  if (vec)
    return launch_persistent(level3_fw_kernel<T, true>, work, L3_THREADS, 0, stream, xv, o,
                             vout, g, offs, cf, ns, nd);
  return launch_persistent(level3_fw_kernel<T, false>, work, L3_THREADS, 0, stream, xv, o,
                           vout, g, offs, cf, ns, nd);
}

template <typename T>
int level3_inv(int dh, int mh, int nh, const void* y, int64_t ysd, int64_t ysr,
               const void* lll, int64_t lsd, int64_t lsr, void* x, int64_t xsd, int64_t xsr,
               const int* offs, const void* coefs, const int* nb, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  constexpr int E = 16 / sizeof(T);
  const Octants<const T> o =
      octants_of(static_cast<const T*>(y), ysd, ysr, static_cast<const T*>(lll), lsd, lsr,
                 dh, mh, nh);
  bool vec = nh % E == 0;
  for (int z = 0; z < 8; ++z) vec = vec && l3_words(o.o[z].p, o.o[z].sd, o.o[z].sr, E);
  const bool vout = l3_words(x, xsd, xsr, E);
  L3Geom g;
  if (!l3_geom<T>(dh, mh, nh, vec, g)) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int work = (g.items + L3_THREADS - 1) / L3_THREADS;
  const Vol<T> xv{static_cast<T*>(x), xsd, xsr};
  const A* cf = static_cast<const A*>(coefs);
  if (vec)
    return launch_persistent(level3_inv_kernel<T, true>, work, L3_THREADS, 0, stream, o, xv,
                             vout, g, offs, cf, nb[0], nb[1], nb[2], nb[3]);
  return launch_persistent(level3_inv_kernel<T, false>, work, L3_THREADS, 0, stream, o, xv,
                           vout, g, offs, cf, nb[0], nb[1], nb[2], nb[3]);
}

}  // namespace wtt

extern "C" {

// Forward level of the (2dh, 2mh, 2nh) view x (strides xsd, xsr, unit
// column stride) into the packed array y (strides ysd, ysr): the seven
// detail octants into their places in y's leading (2dh, 2mh, 2nh)
// sub-cube, the scaling octant into lll (strides lsd, lsr), or into y's
// leading (dh, mh, nh) block where lll is null.  offs / coefs: the
// analysis band table on the device, ns scaling taps then nd detail taps,
// every offset 0 or 1.
int wtt_level3_fw(int dtype, int dh, int mh, int nh, const void* x, int64_t xsd,
                  int64_t xsr, void* y, int64_t ysd, int64_t ysr, void* lll, int64_t lsd,
                  int64_t lsr, const int* offs, const void* coefs, int ns, int nd,
                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::level3_fw<float>(dh, mh, nh, x, xsd, xsr, y, ysd, ysr, lll, lsd, lsr, offs,
                                   coefs, ns, nd, s);
    case wtt::F64:
      return wtt::level3_fw<double>(dh, mh, nh, x, xsd, xsr, y, ysd, ysr, lll, lsd, lsr, offs,
                                    coefs, ns, nd, s);
    case wtt::BF16:
      return wtt::level3_fw<__nv_bfloat16>(dh, mh, nh, x, xsd, xsr, y, ysd, ysr, lll, lsd, lsr,
                                           offs, coefs, ns, nd, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Inverse level: the octants in y (the scaling one from lll where that is
// given) -> the (2dh, 2mh, 2nh) view x.  nb: the tap counts of the
// synthesis bands S0, D0, S1, D1, each 0 or 1, every offset 0.
int wtt_level3_inv(int dtype, int dh, int mh, int nh, const void* y, int64_t ysd,
                   int64_t ysr, const void* lll, int64_t lsd, int64_t lsr, void* x,
                   int64_t xsd, int64_t xsr, const int* offs, const void* coefs,
                   const int* nb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::level3_inv<float>(dh, mh, nh, y, ysd, ysr, lll, lsd, lsr, x, xsd, xsr, offs,
                                    coefs, nb, s);
    case wtt::F64:
      return wtt::level3_inv<double>(dh, mh, nh, y, ysd, ysr, lll, lsd, lsr, x, xsd, xsr, offs,
                                     coefs, nb, s);
    case wtt::BF16:
      return wtt::level3_inv<__nv_bfloat16>(dh, mh, nh, y, ysd, ysr, lll, lsd, lsr, x, xsd, xsr,
                                            offs, coefs, nb, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
