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
// Kernel A (level_fw_tiled_kernel) had the same fault as B's first form
// below: one scalar global load per tap per thread in its row pass, and
// shared band-table reads per tap in both passes.  Its design is B's:
// * Staging.  Persistent blocks walk the tiles (TR x TC output quads, TR =
//   32, or 16 for float64), image by image; each tile's 2 TR - 1 + span
//   input rows and 2 TC - 1 + span columns go into shared memory by
//   16-byte cp.async in two stages, the next tile's copies in flight
//   while this tile's taps run.  The wrap is applied while staging (rows
//   and 16-byte column words taken with a true modulo), so the tap loops
//   are wrap-free and 2 x 2 and 4 x 8 levels stay exact.  An input whose
//   base, strides or width are not whole 16-byte words takes a 4-byte
//   staging path of the same kernel (VEC = false).
// * The bands in registers as dense windows over the union of the two
//   bands' offsets (W = 8 or 16 wide, chosen by the span; masks select
//   each band's taps).  In the row pass a thread takes V neighbouring
//   output columns (16 bytes of the arithmetic type), reads the staged
//   values they need once, in the widest words their alignment allows,
//   and feeds each to both sums of every tap that reaches it.
// * The row pass into S / D in the arithmetic type (never rounded), then
//   the column pass, 16 bytes of S or D per shared read and 16 bytes (8
//   for bfloat16) per store into each of LL / LH / HL / HH, written
//   through four caller-given strided planes, so packed mode writes the
//   details straight into the full-size packed array.
// * The arithmetic of the first form: one explicit fma per tap, each sum
//   over its band's taps in table order, so chains of A launches stay
//   what the tail kernel C computes and two A launches what kernel N
//   computes (csrc/tail2d.cu, csrc/stage2d.cu), bit for bit.
// A span of 16 or more (db10, sym5 and up) takes the first form, one block
// per tile with wrapped taps read from global memory (level_fw_wrap_kernel).
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
// The first form of kernel A, for spans of 16 or more: one block per tile,
// wrapped taps read from global memory.
template <typename T>
__global__ void __launch_bounds__(TC * BY)
level_fw_wrap_kernel(Plane<const T> x, int m, int n, Plane<T> ll, Plane<T> lh,
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

// --- kernel A: staged tiles, dense windows in registers ----------------------

constexpr int FT_THREADS = 256;
constexpr int FW_PAD = 64;  // staged elements past a stage's last row

// Output rows (quads) per tile of the tiled forward: 32, or 16 for float64,
// whose staged rows take twice the bytes (three blocks an SM either way).
template <typename A>
__host__ __device__ constexpr int fw_tr() {
  return sizeof(A) == 8 ? 16 : 32;
}

// Geometry of the tiled forward, filled by the host; ops/level2d.py
// (fw_smem) mirrors the shared bytes.  A tile is TR x TC output quads of
// one image; tiles run image by image, row by row.  A stage holds rows =
// 2 TR - 1 + span input rows, row i being (2 r0 + dmin + i) mod m, of ps
// storage elements, column e being (2 c0 + dmin - sh + e) mod n, with sh =
// dmin mod E on the 16-byte path (the row then starts on a 16-byte word
// of the plane) and 0 on the 4-byte path; ps is a whole number of 16-byte
// words, and for 4- and 8-byte types an odd number of them, so that the
// row pass's two rows per quarter warp fall on different banks.
struct FwGeom {
  int B, m, n, mh, nh, dmin, span, tiles_c, tiles, rows, ps, sh;
  __host__ __device__ int stage() const { return rows * ps + FW_PAD; }  // T elements
};

template <typename T>
size_t fw_tiled_smem(const FwGeom& g, int nt) {
  using A = typename Acc<T>::type;
  return 2 * static_cast<size_t>(g.rows) * TC * sizeof(A) +  // S, D
         2 * static_cast<size_t>(g.stage()) * sizeof(T) +     // two stages
         static_cast<size_t>(nt) * (sizeof(A) + sizeof(int));  // band table
}

// Kernel A's tiled form.  Row pass: each thread takes V neighbouring
// output columns (16 bytes of the arithmetic type) of one staged row: it
// reads the 2V - 1 + span staged values they need once, in the widest
// words their alignment allows, and feeds each to every tap of both sums
// that reaches it.  Column pass: each thread takes V columns of one output
// row and reads 16 bytes of S and D per window row for LL / LH (scaling
// band) and HL / HH (detail band).  The windows run over the union of the
// two bands' offsets, [dmin, dmin + W); each sum takes its band's taps in
// table order, which bands.py makes ascending, except a filter's detail
// band (offsets 1, 0, -1, ...): the kernel reads the detail band's
// direction from its first two offsets and runs a descending one in a
// loop of its own.
template <typename T, int W, bool VEC>
__global__ void __launch_bounds__(FT_THREADS, 2)
level_fw_tiled_kernel(Plane<const T> x, Plane<T> o0, Plane<T> o1, Plane<T> o2,
                      Plane<T> o3, bool vout, FwGeom g, const int* __restrict__ offs,
                      const typename Acc<T>::type* __restrict__ coefs, int ns, int nd) {
  using A = typename Acc<T>::type;
  constexpr int E = 16 / sizeof(T);  // storage elements per 16-byte word
  constexpr int V = Vec16<A>::n;     // output columns per thread
  constexpr int GR = TC / V;         // column groups of a row
  constexpr int NX = 2 * V + W - 1;  // staged values a group may read
  constexpr int TRf = fw_tr<A>();
  // two rows per quarter warp where a group's window start moves 32
  // bytes from one group to the next (float32, float64)
  constexpr bool SPLIT = 2 * V * sizeof(T) == 32;
  constexpr int GL = GR / 4;
  using AV = typename Vec16<A>::type;
  using TW = typename Word<V * sizeof(T)>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* S = reinterpret_cast<A*>(smem_raw);  // [rows][TC] scaling along axis 1
  A* D = S + g.rows * TC;                 // detail along axis 1
  T* stg = reinterpret_cast<T*>(D + g.rows * TC);  // two stages
  const int nt = ns + nd;
  A* cf = reinterpret_cast<A*>(stg + 2 * g.stage());
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x, lane = tid & 31;
  const int total = g.B * g.tiles;

  // stage tile `t` into stage buffer `s`: a warp per staged row, a lane
  // per 16-byte word (per element on the 4-byte path); the modulo only
  // where the tile's window wraps
  const auto stage = [&](int t, int s) {
    const int b = t / g.tiles, rem = t - b * g.tiles;
    const int r0 = (rem / g.tiles_c) * TRf, c0 = (rem % g.tiles_c) * TC;
    T* dst = stg + s * g.stage();
    const int rb = 2 * r0 + g.dmin, cb = 2 * c0 + g.dmin - g.sh;
    const bool rin = rb >= 0 && rb + g.rows <= g.m, cin = cb >= 0 && cb + g.ps <= g.n;
    const int nw = VEC ? g.ps / E : g.ps;
    for (int i = tid >> 5; i < g.rows; i += FT_THREADS / 32) {
      const T* row = x.row(b, rin ? rb + i : wrap(rb + i, g.m));
      T* d = dst + i * g.ps;
      for (int k = lane; k < nw; k += 32) {
        if (VEC)
          cp_async16(d + k * E, row + (cin ? cb + k * E : wrap(cb + k * E, g.n)));
        else
          d[k] = row[cin ? cb + k : wrap(cb + k, g.n)];
      }
    }
  };
  if (static_cast<int>(blockIdx.x) < total) stage(blockIdx.x, 0);
  cp_async_commit();

  load_bands(cf, of, coefs, offs, nt, tid, FT_THREADS);
  __syncthreads();
  // the dense windows over offsets dmin + d, d < W: cs / ms bit d the
  // scaling band's tap there, cd / md the detail band's; the detail
  // band's mask goes to the ascending (mda) or descending (mdd) loop
  A cs[W], cd[W];
  unsigned ms = 0, md = 0;
#pragma unroll
  for (int d = 0; d < W; ++d) {
    cs[d] = cd[d] = A(0);
    for (int k = 0; k < nt; ++k) {
      if (of[k] - g.dmin != d) continue;
      if (k < ns) {
        cs[d] = cf[k];
        ms |= 1u << d;
      } else {
        cd[d] = cf[k];
        md |= 1u << d;
      }
    }
  }
  const bool drev = nd > 1 && of[ns + 1] < of[ns];
  const unsigned mda = drev ? 0u : md, mdd = drev ? md : 0u;
  const int gran = window_gran(static_cast<long long>(g.sh) * sizeof(T),
                               2 * V * static_cast<long long>(sizeof(T)), sizeof(T));

  for (int t = blockIdx.x, it = 0; t < total; t += gridDim.x, ++it) {
    // the next tile's loads go out before this tile's taps
    if (t + static_cast<int>(gridDim.x) < total) stage(t + gridDim.x, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // this tile staged; the last tile's column pass done
    const int b = t / g.tiles, rem = t - b * g.tiles;
    const int r0 = (rem / g.tiles_c) * TRf, c0 = (rem % g.tiles_c) * TC;
    const T* sq = stg + (it & 1) * g.stage();

    // axis 1: staged row i, output columns V gi .. V gi + V - 1 -> S, D
    const int units = (SPLIT ? (g.rows + 1) & ~1 : g.rows) * GR;
    for (int u = tid; u < units; u += FT_THREADS) {
      const int i = SPLIT ? ((u >> 2) & 1) | ((u >> 3) / GL) << 1 : u / GR;
      const int gi = SPLIT ? (u & 3) | ((u >> 3) % GL) << 2 : u % GR;
      if (i >= g.rows) continue;
      A xv[NX];
      load_window(xv, sq + i * g.ps + 2 * V * gi + g.sh, 2 * V - 1 + g.span, gran);
      __align__(16) A s[V];
      __align__(16) A d[V];
#pragma unroll
      for (int e = 0; e < V; ++e) s[e] = d[e] = A(0);
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (k > g.span) break;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if ((ms >> k) & 1) s[e] = fma(cs[k], xv[2 * e + k], s[e]);
          if ((mda >> k) & 1) d[e] = fma(cd[k], xv[2 * e + k], d[e]);
        }
      }
      if (mdd) {
#pragma unroll
        for (int k = W - 1; k >= 0; --k) {
#pragma unroll
          for (int e = 0; e < V; ++e)
            if ((mdd >> k) & 1) d[e] = fma(cd[k], xv[2 * e + k], d[e]);
        }
      }
      *reinterpret_cast<AV*>(S + i * TC + V * gi) = *reinterpret_cast<const AV*>(s);
      *reinterpret_cast<AV*>(D + i * TC + V * gi) = *reinterpret_cast<const AV*>(d);
    }
    __syncthreads();

    // axis 0: output row r, columns j0 .. j0 + V - 1 of the four planes
    const int tr = min(TRf, g.mh - r0), ncol = min(TC, g.nh - c0);
    for (int u = tid; u < TRf * GR; u += FT_THREADS) {
      const int r = u / GR, j0 = (u % GR) * V;
      if (r >= tr || j0 >= ncol) continue;
      A ll[V], lh[V], hl[V], hh[V];
#pragma unroll
      for (int e = 0; e < V; ++e) ll[e] = lh[e] = hl[e] = hh[e] = A(0);
      const A* sp = S + 2 * r * TC + j0;
      const A* dp = D + 2 * r * TC + j0;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (k > g.span) break;
        if (!(((ms | mda) >> k) & 1)) continue;
        __align__(16) A a[V];
        __align__(16) A h[V];
        *reinterpret_cast<AV*>(a) = *reinterpret_cast<const AV*>(sp + k * TC);
        *reinterpret_cast<AV*>(h) = *reinterpret_cast<const AV*>(dp + k * TC);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if ((ms >> k) & 1) {
            ll[e] = fma(cs[k], a[e], ll[e]);
            lh[e] = fma(cs[k], h[e], lh[e]);
          }
          if ((mda >> k) & 1) {
            hl[e] = fma(cd[k], a[e], hl[e]);
            hh[e] = fma(cd[k], h[e], hh[e]);
          }
        }
      }
      if (mdd) {
#pragma unroll
        for (int k = W - 1; k >= 0; --k) {
          if (!((mdd >> k) & 1)) continue;
          __align__(16) A a[V];
          __align__(16) A h[V];
          *reinterpret_cast<AV*>(a) = *reinterpret_cast<const AV*>(sp + k * TC);
          *reinterpret_cast<AV*>(h) = *reinterpret_cast<const AV*>(dp + k * TC);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            hl[e] = fma(cd[k], a[e], hl[e]);
            hh[e] = fma(cd[k], h[e], hh[e]);
          }
        }
      }
      const int rr = r0 + r, cc = c0 + j0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const A* v = q == 0 ? ll : q == 1 ? lh : q == 2 ? hl : hh;
        const Plane<T>& pl = q == 0 ? o0 : q == 1 ? o1 : q == 2 ? o2 : o3;
        T* op = pl.row(b, rr) + cc;
        if (vout && j0 + V <= ncol) {
          __align__(16) T w[V];
#pragma unroll
          for (int e = 0; e < V; ++e) st(w + e, v[e]);
          *reinterpret_cast<TW*>(op) = *reinterpret_cast<const TW*>(w);
        } else {
          for (int e = 0; e < V && j0 + e < ncol; ++e) st(op + e, v[e]);
        }
      }
    }
  }
}

template <typename T>
int level_fw_wrap(int B, int m, int n, const void* x, int64_t xsb, int64_t xsr,
                  void* const* o, const int64_t* osb, const int64_t* osr,
                  const int* offs, const void* coefs, int ns, int nd, int dmin,
                  int span, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  auto plane = [&](int i) { return Plane<T>{static_cast<T*>(o[i]), osb[i], osr[i]}; };
  const int mh = m / 2, nh = n / 2;
  dim3 grid((nh + TC - 1) / TC, (mh + TR - 1) / TR, B);
  size_t smem = 2 * static_cast<size_t>(2 * TR + span) * TC * sizeof(A) +
                static_cast<size_t>(ns + nd) * (sizeof(A) + sizeof(int));
  return launch(level_fw_wrap_kernel<T>, grid, dim3(TC, BY), smem, stream,
                Plane<const T>{static_cast<const T*>(x), xsb, xsr}, m, n,
                plane(0), plane(1), plane(2), plane(3), offs,
                static_cast<const A*>(coefs), ns, nd, dmin, span);
}

template <typename T, int W, bool VEC>
int level_fw_tiled(const FwGeom& g, const void* x, int64_t xsb, int64_t xsr,
                   void* const* o, const int64_t* osb, const int64_t* osr, bool vout,
                   const int* offs, const void* coefs, int ns, int nd, size_t smem,
                   cudaStream_t stream) {
  using A = typename Acc<T>::type;
  auto plane = [&](int i) { return Plane<T>{static_cast<T*>(o[i]), osb[i], osr[i]}; };
  return launch_persistent(level_fw_tiled_kernel<T, W, VEC>, g.B * g.tiles, FT_THREADS,
                           smem, stream, Plane<const T>{static_cast<const T*>(x), xsb, xsr},
                           plane(0), plane(1), plane(2), plane(3), vout, g, offs,
                           static_cast<const A*>(coefs), ns, nd);
}

// Kernel A: the tiled form for spans below 16 (a window of 8 or 16
// offsets), 16-byte staging where x's base, strides and width are whole
// 16-byte words; the first form otherwise.
template <typename T>
int level_fw(int B, int m, int n, const void* x, int64_t xsb, int64_t xsr,
             void* const* o, const int64_t* osb, const int64_t* osr,
             const int* offs, const void* coefs, int ns, int nd, int dmin,
             int span, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  if (span >= 16)
    return level_fw_wrap<T>(B, m, n, x, xsb, xsr, o, osb, osr, offs, coefs, ns, nd,
                            dmin, span, stream);
  constexpr int E = 16 / sizeof(T), V = Vec16<A>::n;
  const bool vec = n % E == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   xsb % E == 0 && xsr % E == 0;
  bool vout = true;
  for (int i = 0; i < 4; ++i)
    vout = vout && reinterpret_cast<uintptr_t>(o[i]) % (V * sizeof(T)) == 0 &&
           osb[i] % V == 0 && osr[i] % V == 0;
  constexpr int TRf = fw_tr<A>();
  FwGeom g;
  g.B = B;
  g.m = m;
  g.n = n;
  g.mh = m / 2;
  g.nh = n / 2;
  g.dmin = dmin;
  g.span = span;
  g.tiles_c = (g.nh + TC - 1) / TC;
  g.tiles = (g.mh + TRf - 1) / TRf * g.tiles_c;
  g.rows = 2 * TRf - 1 + span;
  g.sh = vec ? ((dmin % E) + E) % E : 0;
  g.ps = (g.sh + 2 * TC - 1 + span + E - 1) / E * E;
  if (2 * V * sizeof(T) == 32 && g.ps * sizeof(T) % 32 == 0) g.ps += E;
  if (static_cast<int64_t>(B) * g.tiles > 2147483647)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = fw_tiled_smem<T>(g, ns + nd);
  const bool narrow = span < 8;
  if (vec)
    return narrow ? level_fw_tiled<T, 8, true>(g, x, xsb, xsr, o, osb, osr, vout, offs, coefs, ns, nd, smem, stream)
                  : level_fw_tiled<T, 16, true>(g, x, xsb, xsr, o, osb, osr, vout, offs, coefs, ns, nd, smem, stream);
  return narrow ? level_fw_tiled<T, 8, false>(g, x, xsb, xsr, o, osb, osr, vout, offs, coefs, ns, nd, smem, stream)
                : level_fw_tiled<T, 16, false>(g, x, xsb, xsr, o, osb, osr, vout, offs, coefs, ns, nd, smem, stream);
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
