// One level of the periodic 2-D DWT, forward (kernel A) and inverse (kernel
// B), driven by the float64 bands of ops/bands.py (filter and lifting
// wavelets alike).
//
// Replaces: the forward level of wavelets_tpu/ops/pallas/mxu2d.py,
// _mxu_packed_dma_kernel (packed mode) and _mxu_kernel (quads mode), and
// the inverse level _mxu_inv_kernel_v6 (f32) / _mxu_inv_kernel (bf16),
// called through _mxu_inv_call (and fused2d.py's _inv_kernel).
//
// Bound on the H100: memory traffic.  A level reads its active array once
// and writes the same number of samples once (four quarter-size
// quadrants); at 16384^2 float32 one level moves 2.15 GB, 0.641 ms at the
// spec sheet's 3.35 TB/s.  The arithmetic is small (cdf97: about 16 FMA
// per sample and pass) and runs on the CUDA cores in the storage's own
// arithmetic type (f32 for f32 and bf16, f64 for f64), so no
// split-precision emulation is needed.
//
// Kernel A: one block per TR x TC tile of output quads and one image
// (blockIdx.z).  Phase 1 filters the tile's input rows, plus the band's
// halo rows, along axis 1 straight from global memory into shared memory
// (one thread per output column pair, wrapped column reads, coalesced in
// pairs); phase 2 filters those rows along axis 0 out of shared memory and
// writes LL/LH/HL/HH through four caller-given strided planes, so packed
// mode writes the details straight into the full-size packed array.
//
// Kernel B (level_inv_tiled_kernel): what bounded its first form was the
// load issue, not the bytes: two scalar global loads per tap per thread
// and a shared band-table read per tap, about 50 load instructions per
// output sample.  Its design:
// * Staging.  Persistent blocks (as many as fit the SMs) walk the tiles;
//   each tile's four quadrants, with the synthesis bands' halo rows and
//   columns, go into shared memory with 16-byte cp.async in two stages,
//   so the next tile's loads overlap this tile's taps.  The periodic wrap
//   is applied while staging (rows and 16-byte column words taken with a
//   true modulo), so every tap loop is wrap-free and 2 x 2 levels stay
//   exact.  Planes whose base, strides or width are not whole 16-byte
//   words take a 4-byte staging path of the same kernel (VEC = false).
// * The band table in registers, as dense windows: for each source (the
//   scaling quadrants LL / HL and the detail ones LH / HH) the union of
//   its two parity bands' offsets, at most W wide (W = 8 or 16, a
//   template parameter chosen by the span); each tap loop is unrolled over
//   the window, and a band's mask selects its taps.  A staged value is
//   read once per thread for all four sums it feeds.
// * The pass along axis 1 into US / UD in the arithmetic type (never
//   rounded), then the pass along axis 0, each thread 16 bytes of
//   neighbouring columns per shared read and per store.
// * The arithmetic of the first form: one explicit fma per tap, the S
//   band then the D band, k ascending, so chains of B launches stay what
//   the tail kernel D computes (csrc/tail2d.cu) bit for bit.
// A span of 16 or more (db10) takes the first form, one block per tile
// with wrapped taps (level_inv_wrap_kernel).

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
// The first form of kernel B, for spans of 16 or more: one block per tile,
// wrapped taps read from global memory.
template <typename T>
__global__ void __launch_bounds__(TC * BY)
level_inv_wrap_kernel(Plane<const T> ll, Plane<const T> lh, Plane<const T> hl,
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

// --- kernel B: staged tiles, dense windows in registers ----------------------

constexpr int IT_THREADS = 256;

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

// 16 bytes of the arithmetic type (4 float, 2 double), and the word that
// holds V storage elements (16 bytes, or 8 for bfloat16).
template <typename A> struct Vec16 { using type = float4; static constexpr int n = 4; };
template <> struct Vec16<double> { using type = double2; static constexpr int n = 2; };
template <int BYTES> struct Word { using type = uint4; };
template <> struct Word<8> { using type = uint2; };

// Geometry of the tiled inverse, filled by the host; ops/level2d.py
// (inv_smem) mirrors the shared bytes.  A tile is TR x TC quads of one
// image; tiles run image by image, row by row.  A staged quadrant row holds
// ps storage elements, column e being quad column (c0 + smin - sh + e) mod
// nh, with sh = smin mod E on the 16-byte path (the row then starts on a
// 16-byte word of the plane) and 0 on the 4-byte path; a staged quadrant
// holds rows = TR + span rows, row i being (r0 + smin + i) mod mh.
struct InvGeom {
  int B, mh, nh, smin, span, tiles_c, tiles, rows, ps, sh;
  __host__ __device__ int quad() const { return rows * ps; }  // T elements
};

template <typename T>
size_t inv_tiled_smem(const InvGeom& g, int nt) {
  using A = typename Acc<T>::type;
  return 2 * static_cast<size_t>(g.rows) * 2 * TC * sizeof(A) +  // US, UD
         2 * 4 * static_cast<size_t>(g.quad()) * sizeof(T) +      // two stages
         static_cast<size_t>(nt) * (sizeof(A) + sizeof(int));     // band table
}

template <typename T, int W, bool VEC>
__global__ void __launch_bounds__(IT_THREADS, 2)
level_inv_tiled_kernel(Plane<const T> q0, Plane<const T> q1, Plane<const T> q2,
                       Plane<const T> q3, Plane<T> out, bool vout, InvGeom g,
                       const int* __restrict__ offs,
                       const typename Acc<T>::type* __restrict__ coefs, int n0, int n1,
                       int n2, int n3) {
  using A = typename Acc<T>::type;
  constexpr int E = 16 / sizeof(T);  // storage elements per 16-byte word
  constexpr int V = Vec16<A>::n;     // columns per thread in the axis-0 pass
  constexpr int WU = 2 * TC;         // a US / UD row
  using AV = typename Vec16<A>::type;
  using TW = typename Word<V * sizeof(T)>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* US = reinterpret_cast<A*>(smem_raw);  // [rows][2 TC]: LL | LH along axis 1
  A* UD = US + g.rows * WU;                // HL | HH
  T* stg = reinterpret_cast<T*>(UD + g.rows * WU);  // two stages of four quadrants
  const int nt = n0 + n1 + n2 + n3, e0 = n0 + n1, e1 = e0 + n2;
  A* cf = reinterpret_cast<A*>(stg + 2 * 4 * g.quad());
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x;
  const int total = g.B * g.tiles;

  // stage tile `t` into stage buffer `s`: staged row i of quadrant q at
  // slot 4 i + q, SL threads to a slot (one per 16-byte word, or per
  // element on the 4-byte path); the modulo only where the tile's window
  // wraps
  constexpr int SL = VEC ? 64 / E : 64;
  const auto stage = [&](int t, int s) {
    const int b = t / g.tiles, rem = t - b * g.tiles;
    const int r0 = (rem / g.tiles_c) * TR, c0 = (rem % g.tiles_c) * TC;
    T* dst = stg + s * 4 * g.quad();
    const int rb = r0 + g.smin, cb = c0 + g.smin - g.sh;
    const bool rin = rb >= 0 && rb + g.rows <= g.mh, cin = cb >= 0 && cb + g.ps <= g.nh;
    const int k = tid % SL, n = VEC ? g.ps / E : g.ps;
    if (k >= n) return;
    for (int slot = tid / SL; slot < 4 * g.rows; slot += IT_THREADS / SL) {
      const int qi = slot & 3, i = slot >> 2;
      const Plane<const T>& qp = qi == 0 ? q0 : qi == 1 ? q1 : qi == 2 ? q2 : q3;
      const T* row = qp.row(b, rin ? rb + i : wrap(rb + i, g.mh));
      T* d = dst + qi * g.quad() + i * g.ps;
      if (VEC)
        cp_async16(d + k * E, row + (cin ? cb + k * E : wrap(cb + k * E, g.nh)));
      else
        d[k] = row[cin ? cb + k : wrap(cb + k, g.nh)];
    }
  };
  if (static_cast<int>(blockIdx.x) < total) stage(blockIdx.x, 0);
  cp_async_commit();

  load_bands(cf, of, coefs, offs, nt, tid, IT_THREADS);
  __syncthreads();
  // the dense windows: the scaling sources (LL, HL) over offsets [ls, ls +
  // ws), the detail sources (LH, HH) over [lt, lt + wt); csp[d] / msp bit
  // d: the parity-p scaling band's tap at offset ls + d (cdp / mdp: the
  // detail band's at lt + d)
  int ls = 1 << 30, hs = -(1 << 30), lt = 1 << 30, ht = -(1 << 30);
  for (int k = 0; k < nt; ++k) {
    if (k < n0 || (k >= e0 && k < e1)) {
      ls = min(ls, of[k]);
      hs = max(hs, of[k]);
    } else {
      lt = min(lt, of[k]);
      ht = max(ht, of[k]);
    }
  }
  const int ws = hs - ls + 1, wt = ht - lt + 1;
  A cs0[W], cs1[W], cd0[W], cd1[W];
  unsigned ms0 = 0, ms1 = 0, md0 = 0, md1 = 0;
#pragma unroll
  for (int d = 0; d < W; ++d) {
    cs0[d] = cs1[d] = cd0[d] = cd1[d] = A(0);
    for (int k = 0; k < nt; ++k) {
      const int band = k < n0 ? 0 : k < e0 ? 1 : k < e1 ? 2 : 3;
      if (of[k] - ((band & 1) ? lt : ls) != d) continue;
      if (band == 0) { cs0[d] = cf[k]; ms0 |= 1u << d; }
      if (band == 1) { cd0[d] = cf[k]; md0 |= 1u << d; }
      if (band == 2) { cs1[d] = cf[k]; ms1 |= 1u << d; }
      if (band == 3) { cd1[d] = cf[k]; md1 |= 1u << d; }
    }
  }

  for (int t = blockIdx.x, it = 0; t < total; t += gridDim.x, ++it) {
    // the next tile's loads go out before this tile's taps
    if (t + static_cast<int>(gridDim.x) < total) stage(t + gridDim.x, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // this tile staged; the last tile's axis-0 pass done
    const int b = t / g.tiles, rem = t - b * g.tiles;
    const int r0 = (rem / g.tiles_c) * TR, c0 = (rem % g.tiles_c) * TC;
    const T* sq = stg + (it & 1) * 4 * g.quad();

    // axis 1: row i, quad column c -> US / UD [i][2c + q]
    for (int u = tid; u < g.rows * TC; u += IT_THREADS) {
      const int i = u / TC, c = u - i * TC;
      const int base = i * g.ps + c + g.sh - g.smin;
      const T* ll = sq + base + ls;
      const T* hl = sq + 2 * g.quad() + base + ls;
      const T* lh = sq + g.quad() + base + lt;
      const T* hh = sq + 3 * g.quad() + base + lt;
      A s0 = 0, s1 = 0, d0 = 0, d1 = 0;  // US q = 0, 1; UD q = 0, 1
#pragma unroll
      for (int d = 0; d < W; ++d) {
        if (d >= ws) break;
        const A a = ld(ll[d]), h = ld(hl[d]);
        if ((ms0 >> d) & 1) { s0 = fma(cs0[d], a, s0); d0 = fma(cs0[d], h, d0); }
        if ((ms1 >> d) & 1) { s1 = fma(cs1[d], a, s1); d1 = fma(cs1[d], h, d1); }
      }
#pragma unroll
      for (int d = 0; d < W; ++d) {
        if (d >= wt) break;
        const A a = ld(lh[d]), h = ld(hh[d]);
        if ((md0 >> d) & 1) { s0 = fma(cd0[d], a, s0); d0 = fma(cd0[d], h, d0); }
        if ((md1 >> d) & 1) { s1 = fma(cd1[d], a, s1); d1 = fma(cd1[d], h, d1); }
      }
      US[i * WU + 2 * c] = s0;
      US[i * WU + 2 * c + 1] = s1;
      UD[i * WU + 2 * c] = d0;
      UD[i * WU + 2 * c + 1] = d1;
    }
    __syncthreads();

    // axis 0: output rows 2r + p of V neighbouring columns
    const int tr = min(TR, g.mh - r0), ncol = 2 * min(TC, g.nh - c0);
    for (int u = tid; u < TR * (WU / V); u += IT_THREADS) {
      const int r = u / (WU / V), j0 = (u - r * (WU / V)) * V;
      if (r >= tr || j0 >= ncol) continue;
      A v0[V], v1[V];
#pragma unroll
      for (int e = 0; e < V; ++e) v0[e] = v1[e] = A(0);
      const A* us = US + (r + ls - g.smin) * WU + j0;
      const A* ud = UD + (r + lt - g.smin) * WU + j0;
#pragma unroll
      for (int d = 0; d < W; ++d) {
        if (d >= ws) break;
        A a[V];
        *reinterpret_cast<AV*>(a) = *reinterpret_cast<const AV*>(us + d * WU);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if ((ms0 >> d) & 1) v0[e] = fma(cs0[d], a[e], v0[e]);
          if ((ms1 >> d) & 1) v1[e] = fma(cs1[d], a[e], v1[e]);
        }
      }
#pragma unroll
      for (int d = 0; d < W; ++d) {
        if (d >= wt) break;
        A a[V];
        *reinterpret_cast<AV*>(a) = *reinterpret_cast<const AV*>(ud + d * WU);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if ((md0 >> d) & 1) v0[e] = fma(cd0[d], a[e], v0[e]);
          if ((md1 >> d) & 1) v1[e] = fma(cd1[d], a[e], v1[e]);
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const A* v = p ? v1 : v0;
        T* o = out.row(b, 2 * (r0 + r) + p) + 2 * c0 + j0;
        if (vout && j0 + V <= ncol) {
          __align__(16) T w[V];
#pragma unroll
          for (int e = 0; e < V; ++e) st(w + e, v[e]);
          *reinterpret_cast<TW*>(o) = *reinterpret_cast<const TW*>(w);
        } else {
          for (int e = 0; e < V && j0 + e < ncol; ++e) st(o + e, v[e]);
        }
      }
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
int level_inv_wrap(int B, int mh, int nh, const void* const* q, const int64_t* qsb,
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
  return launch(level_inv_wrap_kernel<T>, grid, dim3(TC, BY), smem, stream,
                plane(0), plane(1), plane(2), plane(3), mh, nh,
                Plane<T>{static_cast<T*>(out), osb, osr}, offs,
                static_cast<const A*>(coefs), nb[0], nb[1], nb[2], nb[3], smin,
                span);
}

template <typename T, int W, bool VEC>
int level_inv_tiled(const InvGeom& g, const void* const* q, const int64_t* qsb,
                    const int64_t* qsr, void* out, int64_t osb, int64_t osr, bool vout,
                    const int* offs, const void* coefs, const int* nb, size_t smem,
                    cudaStream_t stream) {
  using A = typename Acc<T>::type;
  auto plane = [&](int i) {
    return Plane<const T>{static_cast<const T*>(q[i]), qsb[i], qsr[i]};
  };
  return launch_persistent(level_inv_tiled_kernel<T, W, VEC>, g.B * g.tiles, IT_THREADS,
                           smem, stream, plane(0), plane(1), plane(2), plane(3),
                           Plane<T>{static_cast<T*>(out), osb, osr}, vout, g, offs,
                           static_cast<const A*>(coefs), nb[0], nb[1], nb[2], nb[3]);
}

// Kernel B: the tiled form for spans below 16 (a window of 8 or 16 offsets
// per source), 16-byte staging where every plane's base, strides and width
// are whole 16-byte words; the first form otherwise.
template <typename T>
int level_inv(int B, int mh, int nh, const void* const* q, const int64_t* qsb,
              const int64_t* qsr, void* out, int64_t osb, int64_t osr,
              const int* offs, const void* coefs, const int* nb, int smin,
              int span, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  if (span >= 16)
    return level_inv_wrap<T>(B, mh, nh, q, qsb, qsr, out, osb, osr, offs, coefs, nb,
                             smin, span, stream);
  constexpr int E = 16 / sizeof(T), V = Vec16<A>::n;
  bool vec = nh % E == 0;
  for (int i = 0; i < 4; ++i)
    vec = vec && reinterpret_cast<uintptr_t>(q[i]) % 16 == 0 && qsb[i] % E == 0 &&
          qsr[i] % E == 0;
  const bool vout = reinterpret_cast<uintptr_t>(out) % (V * sizeof(T)) == 0 &&
                    osb % V == 0 && osr % V == 0;
  InvGeom g;
  g.B = B;
  g.mh = mh;
  g.nh = nh;
  g.smin = smin;
  g.span = span;
  g.tiles_c = (nh + TC - 1) / TC;
  g.tiles = (mh + TR - 1) / TR * g.tiles_c;
  g.rows = TR + span;
  g.sh = vec ? ((smin % E) + E) % E : 0;
  g.ps = (g.sh + TC + span + E - 1) / E * E;
  if (static_cast<int64_t>(B) * g.tiles > 2147483647 || g.ps > 64)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = inv_tiled_smem<T>(g, nb[0] + nb[1] + nb[2] + nb[3]);
  const bool narrow = span < 8;
  if (vec)
    return narrow ? level_inv_tiled<T, 8, true>(g, q, qsb, qsr, out, osb, osr, vout, offs, coefs, nb, smem, stream)
                  : level_inv_tiled<T, 16, true>(g, q, qsb, qsr, out, osb, osr, vout, offs, coefs, nb, smem, stream);
  return narrow ? level_inv_tiled<T, 8, false>(g, q, qsb, qsr, out, osb, osr, vout, offs, coefs, nb, smem, stream)
                : level_inv_tiled<T, 16, false>(g, q, qsb, qsr, out, osb, osr, vout, offs, coefs, nb, smem, stream);
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
