// Levels 1 and 2 of the periodic 2-D forward DWT in one launch (kernel N),
// driven by the float64 bands of ops/bands.py (filter and lifting wavelets
// alike, no tap cap).
//
// Replaces: wavelets_tpu/ops/pallas/stage2d.py, _stage2_kernel (called
// through stage2_fw): levels 1 and 2 with exact halos, level 1's LL kept on
// chip with the ring that level 2 reads, the six detail blocks and LL2
// written straight to their packed places.
//
// Bound on the H100: memory traffic.  Two levels move level 1's bytes: x
// is read once, and LH1/HL1/HH1, LH2/HL2/HH2 and LL2 are written once, m*n
// samples in all; at 16384^2 float32 that is 2.15 GB, 0.641 ms at the spec
// sheet's 3.35 TB/s, against two launches of kernel A, whose level 2 reads
// LL1 back from device memory.  The arithmetic (cdf97: about 45 FMA per
// sample at level 1, a quarter of that at level 2) stays far below the
// FP32 peak.
//
// Two forms.  The strip form (stage2_strip_kernel) runs where the bands'
// span is below 16; the first form (stage2_fw_kernel) above, and where the
// host asks for it.  Each sum takes its taps in kernel A's order, one fma
// per tap, and LL1 is rounded to the storage type between the levels, so
// both forms equal two launches of kernel A bit for bit.
//
// The strip form.  The first form (below) ran its phases in sequence, one
// 174 KB block per SM, with scalar staging, two shared reads per tap, and
// each tile's halo rows staged and filtered again by the tile below.  Here
// a work item is a strip of q2 level-2 quad columns (4 q2 columns of x)
// and a segment of seg level-2 rows, and a persistent block walks the
// segment downward, RS level-2 rows (4 RS rows of x) per step, keeping
// small rings in shared memory:
// * the staged x rows: 4 RS rows a step, in SN_STAGES buffers filled by
//   16-byte cp.async two steps ahead of the step that reads them (a
//   4-byte path for x not in whole 16-byte words), the periodic wrap
//   applied while staging (rows, and 16-byte column words, with a true
//   modulo), so the tap loops carry no wrap;
// * S1 / D1, level 1's row pass, r1 = 4 RS + span - 1 rows deep;
// * the step's 2 RS new LL1 rows, rounded to the storage type;
// * S2 / D2, level 2's row pass over them, r2 = 2 RS - 1 + hi - dmin rows.
// A step (1) filters its new x rows along the rows, (2) completes 2 RS LL1
// rows (their LH1, HL1, HH1 stored where the strip owns them), (3) filters
// those along the rows and (4) completes RS rows of LL2, LH2, HL2, HH2.
// (3) and (4) run beside the next step's (1) and (2), so two barriers
// separate the steps, and a block's threads share both passes' work.
// The vertical halo is staged and filtered once per segment (warm steps
// above its first row fill the rings), so only the horizontal halo is
// recomputed.  The band windows sit in registers (band_window), and the
// passes are kernel A's: V outputs (16 bytes of the arithmetic type) per
// thread, 16-byte reads of the rings, 16-byte stores where the planes
// allow.  The block is small (SN_THREADS), so that four fit an SM: a
// step's passes are short chains behind a barrier, and more blocks an SM
// hide them.  The host (stage2_strip) takes q2 as wide as an LL1 window
// row of SN_WIDTH bytes allows, and seg so that the grid has about
// SN_ITEMS items, enough to cover the card at 16384^2 and at the smallest
// images.
//
// The first form: one block of NT threads per T2 x T2 tile of level-2
// quads and one image (blockIdx.z).  The level-2 tile reads LL1 rows and
// columns [2 r2 + dmin, 2 (r2 + T2 - 1) + dmax]; widened to cover the
// tile's own level-1 quads, that is a W1 x W1 window of LL1 (the ring of
// reach r on each side), which in turn reads an XR x XR window of x.  The
// block
//   1. stages the x window in shared memory (coalesced loads, wrapped with
//      a true modulo, so any m and n divisible by 4 work), its columns
//      split into even and odd planes so that the stride-2 reads of the
//      row pass hit consecutive words;
//   2. filters it along axis 1 (the row pass of kernel A, csrc/level2d.cu)
//      into S1 / D1;
//   3. filters those along axis 0: LL1 over the whole window, rounded to
//      the storage type as the per-level path rounds it, into shared
//      memory only; LH1 / HL1 / HH1 for the tile's interior quads only,
//      written to their planes, so every output element has one writer;
//   4. runs level 2 on the LL1 window the same way and writes LL2, LH2,
//      HL2 and HH2.
// Each thread computes RB outputs down a column per step, so that a tap's
// coefficient and offset, read from shared memory, serve RB products.
// Shared memory holds the x window and the row pass; LL1 and level 2's row
// pass reuse them.  The wrapper picks the largest T2 whose window fits (32
// for cdf97 in float32, 16 in float64), and launch() refuses more than the
// card's 227 KiB.

#include <algorithm>

#include "common.cuh"

namespace wtt {

constexpr int NT = 512;  // threads per block
constexpr int RB = 4;    // outputs along the row axis per thread and step

template <typename T>
struct StagePlane {  // a (B, rows, cols) view with unit column stride
  T* p;
  int64_t sb, sr;
  __device__ __forceinline__ T* row(int b, int r) const {
    return p + static_cast<int64_t>(b) * sb + static_cast<int64_t>(r) * sr;
  }
};

// The seven output planes: LL2, LH1, HL1, HH1, LH2, HL2, HH2.
template <typename T>
struct StageOuts {
  StagePlane<T> p[7];
};

// Window sizes of one tile (see the header): lo / hi bound the band offsets
// together with the tile's own quads, W1 is the LL1 window, XR the x window
// (square), XH its half width rounded up.
struct StageGeom {
  int lo, W1, XR, XH, W1H;
  __host__ __device__ StageGeom(int T2, int dmin, int span) {
    lo = dmin < 0 ? dmin : 0;
    const int hi = dmin + span > 1 ? dmin + span : 1;
    W1 = 2 * T2 - 1 + hi - lo;
    XR = 2 * W1 - 1 + span;
    XH = (XR + 1) / 2;
    W1H = (W1 + 1) / 2;
  }
  // shared memory in elements of the arithmetic type, band table excluded
  __host__ __device__ int64_t elems() const {
    return 2 * static_cast<int64_t>(XR) * XH + 2 * static_cast<int64_t>(XR) * W1;
  }
};

// A flat loop over a (rows, cols) index space, NT threads apart, that steps
// its (row, col) pair without a division per step.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ __forceinline__ Walk(int start, int cols_) : cols(cols_) {
    r = start / cols;
    c = start - r * cols;
    dr = NT / cols;
    dc = NT - dr * cols;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// The storage type's rounding of an arithmetic value, back in the
// arithmetic type (LL1 is stored at this precision between the levels).
__device__ __forceinline__ float rnd(float v, float) { return v; }
__device__ __forceinline__ double rnd(double v, double) { return v; }
__device__ __forceinline__ float rnd(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

// acc[r] += sum over taps k in [k0, k1) of cf[k] * src[r * rstride + off[k]],
// for the first nr of RB outputs: each tap's coefficient and offset are
// read once for the RB outputs, which share them.  The order of the sum is
// kernel A's (taps in order, one accumulator per output).
template <typename A>
__device__ __forceinline__ void sum_taps(A (&acc)[RB], int nr, const A* src,
                                         int rstride, const A* cf,
                                         const int* off, int k0, int k1) {
  for (int k = k0; k < k1; ++k) {
    const A c = cf[k];
    const A* p = src + off[k];
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (r < nr) acc[r] += c * p[r * rstride];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
stage2_fw_kernel(StagePlane<const T> x, int m, int n, StageOuts<T> o,
                 const int* __restrict__ offs,
                 const typename Acc<T>::type* __restrict__ coefs, int ns, int nd,
                 int dmin, int span, int T2) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const StageGeom g(T2, dmin, span);
  const int nt = ns + nd;
  const int xplane = g.XR * g.XH, l1plane = g.W1 * g.W1H;
  A* P = reinterpret_cast<A*>(smem_raw);  // x window [2][XR][XH], then LL1 [2][W1][W1H]
  A* S1 = P + 2 * xplane;                 // row pass [XR][W1], then level 2's [W1][T2]
  A* D1 = S1 + g.XR * g.W1;
  A* cf = D1 + g.XR * g.W1;
  // per tap: its offset in the x window's and in LL1's split planes, and
  // its row offset in the level-1 and the level-2 row passes
  int* tap1 = reinterpret_cast<int*>(cf + nt);
  int* tap2 = tap1 + nt;
  int* row1 = tap2 + nt;
  int* row2 = row1 + nt;
  const int tid = threadIdx.x;
  for (int k = tid; k < nt; k += NT) {
    const int o1 = offs[k] - dmin, o2 = offs[k] - g.lo;
    cf[k] = coefs[k];
    tap1[k] = (o1 & 1) * xplane + (o1 >> 1);
    tap2[k] = (o2 & 1) * l1plane + (o2 >> 1);
    row1[k] = o1 * g.W1;
    row2[k] = o2 * T2;
  }

  const int b = blockIdx.z;
  const int m2 = m / 4, n2 = n / 4;
  const int r2 = blockIdx.y * T2, c2 = blockIdx.x * T2;
  const int tr2 = min(T2, m2 - r2), tc2 = min(T2, n2 - c2);
  // first LL1 row / column of the window, first x row / column
  const int w1r = 2 * r2 + g.lo, w1c = 2 * c2 + g.lo;
  const int xr0 = 2 * w1r + dmin, xc0 = 2 * w1c + dmin;

  // 1. stage the x window, a warp per row, its columns split by parity
  {
    const bool inr = xr0 >= 0 && xr0 + g.XR <= m;
    const bool inc = xc0 >= 0 && xc0 + g.XR <= n;
    for (int t = tid >> 5; t < g.XR; t += NT / 32) {
      const T* row = x.row(b, inr ? xr0 + t : wrap(xr0 + t, m));
      A* dst = P + t * g.XH;
#pragma unroll 4
      for (int c = tid & 31; c < g.XR; c += 32)
        dst[(c & 1) * xplane + (c >> 1)] = ld(row[inc ? xc0 + c : wrap(xc0 + c, n)]);
    }
  }
  __syncthreads();

  // 2. level 1 along axis 1: S1 / D1 [t][j] for every x window row t and
  //    LL1 window column j, RB rows per step
  for (Walk it(tid, g.W1); it.r * RB < g.XR; it.next()) {
    const int t0 = it.r * RB, j = it.c, nr = min(RB, g.XR - t0);
    A s[RB] = {}, d[RB] = {};
    const A* src = P + t0 * g.XH + j;
    sum_taps(s, nr, src, g.XH, cf, tap1, 0, ns);
    sum_taps(d, nr, src, g.XH, cf, tap1, ns, nt);
    for (int r = 0; r < nr; ++r) {
      S1[(t0 + r) * g.W1 + j] = s[r];
      D1[(t0 + r) * g.W1 + j] = d[r];
    }
  }
  __syncthreads();

  // 3. level 1 along axis 0: LL1 over the window into shared memory (P is
  //    free now), the details of the tile's own quads to their planes
  for (Walk it(tid, g.W1); it.r * RB < g.W1; it.next()) {
    const int w0 = it.r * RB, j = it.c, nr = min(RB, g.W1 - w0);
    const A* cs = S1 + 2 * w0 * g.W1 + j;
    A vll[RB] = {};
    sum_taps(vll, nr, cs, 2 * g.W1, cf, row1, 0, ns);
    for (int r = 0; r < nr; ++r)
      P[(j & 1) * l1plane + (w0 + r) * g.W1H + (j >> 1)] = rnd(vll[r], T());
    // quad offsets within the tile: rows w0 + lo .., column j + lo
    const int ri = w0 + g.lo, ci = j + g.lo;
    if (ci >= 0 && ci < 2 * tc2 && ri + nr > 0 && ri < 2 * tr2) {
      const A* cd = D1 + 2 * w0 * g.W1 + j;
      A vlh[RB] = {}, vhl[RB] = {}, vhh[RB] = {};
      sum_taps(vlh, nr, cd, 2 * g.W1, cf, row1, 0, ns);
      sum_taps(vhl, nr, cs, 2 * g.W1, cf, row1, ns, nt);
      sum_taps(vhh, nr, cd, 2 * g.W1, cf, row1, ns, nt);
      for (int r = 0; r < nr; ++r) {
        if (ri + r < 0 || ri + r >= 2 * tr2) continue;
        const int rr = 2 * r2 + ri + r, cc = 2 * c2 + ci;
        st(o.p[1].row(b, rr) + cc, vlh[r]);
        st(o.p[2].row(b, rr) + cc, vhl[r]);
        st(o.p[3].row(b, rr) + cc, vhh[r]);
      }
    }
  }
  __syncthreads();

  // 4a. level 2 along axis 1 on the LL1 window: S2 / D2 [w][q] (in S1's
  //     place)
  A* S2 = S1;
  A* D2 = S1 + g.W1 * T2;
  for (Walk it(tid, T2); it.r * RB < g.W1; it.next()) {
    const int w0 = it.r * RB, q = it.c, nr = min(RB, g.W1 - w0);
    A s[RB] = {}, d[RB] = {};
    const A* src = P + w0 * g.W1H + q;
    sum_taps(s, nr, src, g.W1H, cf, tap2, 0, ns);
    sum_taps(d, nr, src, g.W1H, cf, tap2, ns, nt);
    for (int r = 0; r < nr; ++r) {
      S2[(w0 + r) * T2 + q] = s[r];
      D2[(w0 + r) * T2 + q] = d[r];
    }
  }
  __syncthreads();

  // 4b. level 2 along axis 0: the tile's LL2, LH2, HL2, HH2
  for (Walk it(tid, T2); it.r * RB < tr2; it.next()) {
    const int q0 = it.r * RB, p = it.c, nr = min(RB, tr2 - q0);
    if (p >= tc2) continue;
    const A* cs = S2 + 2 * q0 * T2 + p;
    const A* cd = D2 + 2 * q0 * T2 + p;
    A vll[RB] = {}, vlh[RB] = {}, vhl[RB] = {}, vhh[RB] = {};
    sum_taps(vll, nr, cs, 2 * T2, cf, row2, 0, ns);
    sum_taps(vlh, nr, cd, 2 * T2, cf, row2, 0, ns);
    sum_taps(vhl, nr, cs, 2 * T2, cf, row2, ns, nt);
    sum_taps(vhh, nr, cd, 2 * T2, cf, row2, ns, nt);
    for (int r = 0; r < nr; ++r) {
      const int rr = r2 + q0 + r, cc = c2 + p;
      st(o.p[0].row(b, rr) + cc, vll[r]);
      st(o.p[4].row(b, rr) + cc, vlh[r]);
      st(o.p[5].row(b, rr) + cc, vhl[r]);
      st(o.p[6].row(b, rr) + cc, vhh[r]);
    }
  }
}

// --- the strip form ----------------------------------------------------------

constexpr int SN_THREADS = 128;  // threads per block (four blocks an SM)
constexpr int SN_RS = 2;         // level-2 rows per step
constexpr int SN_STAGES = 3;     // staged steps: this one and the next two
constexpr int SN_ITEMS = 2048;   // work items the segment height aims at
constexpr int SN_WIDTH = 512;    // bytes of an LL1 window row at most

// Geometry of the strip form, filled by the host; ops/stage2d.py
// (stage_plan) mirrors it.  lo = min(dmin, 0) and hi = max(dmin + span, 1)
// bound the LL1 columns (rows) that a strip's level-2 quads and its own
// level-1 quads read; lov is lo rounded down to a multiple of V.  A strip
// holds q2 level-2 columns from c2 = strip * q2; its LL1 window holds w1
// columns (a multiple of 4 V), column j being LL1 column 2 c2 + lov + j.
// A staged x row holds ps storage elements, element e being x column (4 c2
// + 2 lov + dmin - sh + e) mod n, with sh = (2 lov + dmin) mod E on the
// 16-byte path and 0 on the 4-byte path.  Segment sg holds level-2 rows
// [sg seg, min((sg + 1) seg, m4)); its walk starts warm steps above them.
// Work items run image by image, segment by segment, strip by strip.
struct StripGeom {
  int B, m, n, m4, n4, dmin, span, lo, hi, lov;
  int q2, w1, ps, sh, r1, r2, warm, seg, segs, strips, items;
  int vmask;  // bit i: plane i takes V-element stores
};

template <typename T>
size_t strip_smem(const StripGeom& g, int nt) {
  using A = typename Acc<T>::type;
  return (2 * static_cast<size_t>(g.r1) * g.w1 + 2 * SN_RS * static_cast<size_t>(g.w1) +
          2 * static_cast<size_t>(g.r2) * g.q2) * sizeof(A) +              // rings
         SN_STAGES * 4 * SN_RS * static_cast<size_t>(g.ps) * sizeof(T) +  // stages
         static_cast<size_t>(nt) * (sizeof(A) + sizeof(int));             // band table
}

// V outputs of T at p from v (rounded to T), as one word where `vec`,
// else element by element for the first cnt.
template <int V, typename T, typename A>
__device__ __forceinline__ void store_v(T* p, const A* v, bool vec, int cnt) {
  using TW = typename Word<V * sizeof(T)>::type;
  if (vec && cnt >= V) {
    __align__(16) T w[V];
#pragma unroll
    for (int e = 0; e < V; ++e) st(w + e, v[e]);
    *reinterpret_cast<TW*>(p) = *reinterpret_cast<const TW*>(w);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (e < cnt) st(p + e, v[e]);
  }
}

// A row pass of kernel A: V outputs of S and D from the staged or LL1
// values xv (xv[2 e + k] is tap offset dmin + k of output e), the scaling
// band in ascending order, the detail band ascending (mda) or descending
// (mdd).
template <int W, int V, typename A, int NX>
__device__ __forceinline__ void row_pass(A (&s)[V], A (&d)[V], const A (&xv)[NX],
                                         const A (&cs)[W], const A (&cd)[W], unsigned ms,
                                         unsigned mda, unsigned mdd, int span) {
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = d[e] = A(0);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k > span) break;
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
}

// A column pass of kernel A over a ring: V columns of LL (and, where
// `all`, LH, HL, HH) from the ring rows of taps k <= span, ring row of tap
// k being (a0 + k) mod depth, pitch `pitch`; S and D the rings of the
// scaling and detail row-pass outputs.
template <int W, int V, typename A>
__device__ __forceinline__ void col_pass(A (&ll)[V], A (&lh)[V], A (&hl)[V], A (&hh)[V],
                                         const A* S, const A* D, int a0, int depth,
                                         int pitch, bool all, const A (&cs)[W],
                                         const A (&cd)[W], unsigned ms, unsigned mda,
                                         unsigned mdd, int span) {
  using AV = typename Vec16<A>::type;
#pragma unroll
  for (int e = 0; e < V; ++e) ll[e] = lh[e] = hl[e] = hh[e] = A(0);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k > span) break;
    const bool ks = (ms >> k) & 1, kd = all && ((mda >> k) & 1);
    if (!(ks || kd)) continue;
    int r = a0 + k;
    if (r >= depth) r -= depth;
    __align__(16) A a[V];
    *reinterpret_cast<AV*>(a) = *reinterpret_cast<const AV*>(S + r * pitch);
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (ks) ll[e] = fma(cs[k], a[e], ll[e]);
    if (all) {
      __align__(16) A h[V];
      *reinterpret_cast<AV*>(h) = *reinterpret_cast<const AV*>(D + r * pitch);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (ks) lh[e] = fma(cs[k], h[e], lh[e]);
        if (kd) {
          hl[e] = fma(cd[k], a[e], hl[e]);
          hh[e] = fma(cd[k], h[e], hh[e]);
        }
      }
    }
  }
  if (all && mdd) {
#pragma unroll
    for (int k = W - 1; k >= 0; --k) {
      if (!((mdd >> k) & 1)) continue;
      int r = a0 + k;
      if (r >= depth) r -= depth;
      __align__(16) A a[V];
      __align__(16) A h[V];
      *reinterpret_cast<AV*>(a) = *reinterpret_cast<const AV*>(S + r * pitch);
      *reinterpret_cast<AV*>(h) = *reinterpret_cast<const AV*>(D + r * pitch);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        hl[e] = fma(cd[k], a[e], hl[e]);
        hh[e] = fma(cd[k], h[e], hh[e]);
      }
    }
  }
}

// One work item: image b, level-2 rows [r2s, r2e), columns from c2; its
// walk starts at level-2 row r20() and takes steps() steps.
struct StripItem {
  int b, r2s, r2e, c2, warm;
  __device__ __forceinline__ StripItem(const StripGeom& g, int t) : warm(g.warm) {
    const int per = g.segs * g.strips;
    b = t / per;
    const int rem = t - b * per, sg = rem / g.strips;
    c2 = (rem - sg * g.strips) * g.q2;
    r2s = sg * g.seg;
    r2e = min(r2s + g.seg, g.m4);
  }
  __device__ __forceinline__ int r20() const { return r2s - SN_RS * warm; }
  __device__ __forceinline__ int steps() const {
    return warm + (r2e - r2s + SN_RS - 1) / SN_RS;
  }
};

template <typename T, int W, bool VEC>
__global__ void __launch_bounds__(SN_THREADS, 4)
stage2_strip_kernel(StagePlane<const T> x, StageOuts<T> o, StripGeom g,
                    const int* __restrict__ offs,
                    const typename Acc<T>::type* __restrict__ coefs, int ns, int nd) {
  using A = typename Acc<T>::type;
  constexpr int E = 16 / sizeof(T);   // storage elements per 16-byte word
  constexpr int V = Vec16<A>::n;      // outputs per thread and pass
  constexpr int NX = 2 * V + W - 1;   // values a row-pass unit reads
  constexpr int XR = 4 * SN_RS;       // x rows staged per step
  // two rows per quarter warp in the row pass where a unit's window start
  // moves 32 bytes from one unit to the next (float32, float64), as in A
  constexpr bool SPLIT = 2 * V * sizeof(T) == 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* S1 = reinterpret_cast<A*>(smem_raw);  // [r1][w1] level 1 along axis 1
  A* D1 = S1 + g.r1 * g.w1;
  A* L1 = D1 + g.r1 * g.w1;                // [2 RS][w1] the step's LL1 rows
  A* S2 = L1 + 2 * SN_RS * g.w1;           // [r2][q2] level 2 along axis 1
  A* D2 = S2 + g.r2 * g.q2;
  T* stg = reinterpret_cast<T*>(D2 + g.r2 * g.q2);  // [SN_STAGES][XR][ps]
  const int nt = ns + nd;
  A* cf = reinterpret_cast<A*>(stg + SN_STAGES * XR * g.ps);
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x, lane = tid & 31;

  // stage step s of item `it` into buffer q: a warp per x row, a lane per
  // 16-byte word (per element on the 4-byte path); the modulo only where
  // the window wraps
  const auto stage = [&](const StripItem& it, int s, int q) {
    T* dst = stg + q * XR * g.ps;
    const int xr0 = 4 * (it.r20() + SN_RS * s) + 2 * g.hi + g.dmin + g.span - 3;
    const int cb = 4 * it.c2 + 2 * g.lov + g.dmin - g.sh;
    const bool rin = xr0 >= 0 && xr0 + XR <= g.m, cin = cb >= 0 && cb + g.ps <= g.n;
    const int nw = VEC ? g.ps / E : g.ps;
    for (int i = tid >> 5; i < XR; i += SN_THREADS / 32) {
      const T* row = x.row(it.b, rin ? xr0 + i : wrap(xr0 + i, g.m));
      T* d = dst + i * g.ps;
      for (int k = lane; k < nw; k += 32) {
        if (VEC)
          cp_async16(d + k * E, row + (cin ? cb + k * E : wrap(cb + k * E, g.n)));
        else
          d[k] = row[cin ? cb + k : wrap(cb + k, g.n)];
      }
    }
  };
  // the prefetch cursor, SN_STAGES - 1 steps ahead: item pt, its step
  // pst of pns
  int pt = blockIdx.x, pst = 0;
  int pns = pt < g.items ? StripItem(g, pt).steps() : 0;
  const auto prefetch = [&](int q) {
    if (pt < g.items) {
      stage(StripItem(g, pt), pst, q);
      if (++pst == pns) {
        pt += gridDim.x;
        pst = 0;
        if (pt < g.items) pns = StripItem(g, pt).steps();
      }
    }
    cp_async_commit();
  };
  for (int q = 0; q < SN_STAGES - 1; ++q) prefetch(q);

  load_bands(cf, of, coefs, offs, nt, tid, SN_THREADS);
  __syncthreads();
  A cs[W], cd[W];
  const unsigned ms = band_window(cs, cf, of, 0, ns, g.dmin);
  const unsigned md = band_window(cd, cf, of, ns, nt, g.dmin);
  const bool drev = nd > 1 && of[ns + 1] < of[ns];
  const unsigned mda = drev ? 0u : md, mdd = drev ? md : 0u;
  const int gran1 = window_gran(static_cast<long long>(g.sh) * sizeof(T),
                                2 * V * static_cast<long long>(sizeof(T)), sizeof(T));
  const int gran3 = window_gran(static_cast<long long>(g.dmin - g.lov) * sizeof(A),
                                2 * V * static_cast<long long>(sizeof(A)), sizeof(A));
  const int GR = g.w1 / V, GQ = g.q2 / V, nh = g.n / 2;

  int q = 0;  // the stage buffer of this step
  for (int t = blockIdx.x; t < g.items; t += gridDim.x) {
    const StripItem it(g, t);
    const int steps = it.steps(), r20 = it.r20();
    int h1 = 0, h2 = 0;  // ring rows of step s's (h1) and step s - 1's (h2) first new row
    // pass s runs the level-1 passes of step s and the level-2 passes of
    // step s - 1, so that two barriers separate the steps; a last pass
    // (s == steps) runs the last step's level-2 passes
    for (int s = 0; s <= steps; ++s) {
      const bool now = s < steps, prev = s > 0;
      if (now) {
        prefetch(q == 0 ? SN_STAGES - 1 : q - 1);
        cp_async_wait<SN_STAGES - 1>();
      }
      __syncthreads();  // step s staged; the last pass's reads done
      const T* sq = stg + q * XR * g.ps;
      const int rho = r20 + SN_RS * s;  // step s's first level-2 row
      const int rhp = rho - SN_RS;      // step s - 1's

      // 1. level 1 along axis 1 (step s): staged row i, LL1 window columns
      //    V gi .. -> S1 / D1 ring row (h1 + i) mod r1;
      // 3. level 2 along axis 1 (step s - 1) on its LL1 rows -> S2 / D2
      //    ring row (h2 + uu) mod r2
      const int n1 = now ? XR * GR : 0, n3 = prev ? 2 * SN_RS * GQ : 0;
      for (int u = tid; u < n1 + n3; u += SN_THREADS) {
        using AV = typename Vec16<A>::type;
        A xv[NX];
        __align__(16) A sv[V];
        __align__(16) A dv[V];
        if (u < n1) {
          const int gl = GR >> 2;
          const int i = SPLIT ? ((u >> 2) & 1) | ((u >> 3) / gl) << 1 : u / GR;
          const int gi = SPLIT ? (u & 3) | ((u >> 3) % gl) << 2 : u % GR;
          load_window(xv, sq + i * g.ps + g.sh + 2 * V * gi, 2 * V - 1 + g.span, gran1);
          row_pass<W, V>(sv, dv, xv, cs, cd, ms, mda, mdd, g.span);
          int r = h1 + i;
          if (r >= g.r1) r -= g.r1;
          *reinterpret_cast<AV*>(S1 + r * g.w1 + V * gi) = *reinterpret_cast<const AV*>(sv);
          *reinterpret_cast<AV*>(D1 + r * g.w1 + V * gi) = *reinterpret_cast<const AV*>(dv);
        } else {
          const int uu = (u - n1) / GQ, gi = u - n1 - uu * GQ;
          load_window(xv, L1 + uu * g.w1 + (g.dmin - g.lov) + 2 * V * gi,
                      2 * V - 1 + g.span, gran3);
          row_pass<W, V>(sv, dv, xv, cs, cd, ms, mda, mdd, g.span);
          int r = h2 + uu;
          if (r >= g.r2) r -= g.r2;
          *reinterpret_cast<AV*>(S2 + r * g.q2 + V * gi) = *reinterpret_cast<const AV*>(sv);
          *reinterpret_cast<AV*>(D2 + r * g.q2 + V * gi) = *reinterpret_cast<const AV*>(dv);
        }
      }
      __syncthreads();

      // 2. level 1 along axis 0 (step s): LL1 row w = 2 rho + hi - 1 + uu
      //    (S1 rows 2 w + dmin + k at ring rows (h1 + 2 uu + XR + k) mod
      //    r1) into L1 for every window column, and LH1 / HL1 / HH1 where
      //    the strip and the segment own the quads;
      // 4. level 2 along axis 0 (step s - 1): level-2 row rhp + v2 (S2 rows
      //    of LL1 rows 2 (rhp + v2) + dmin + k at ring rows (h2 + 2 v2 + 2
      //    RS + k) mod r2) -> LL2, LH2, HL2, HH2 where the segment owns it
      const int n2 = now ? 2 * SN_RS * GR : 0, n4 = prev ? SN_RS * GQ : 0;
      for (int u = tid; u < n2 + n4; u += SN_THREADS) {
        A ll[V], lh[V], hl[V], hh[V];
        if (u < n2) {
          const int uu = u / GR, j0 = V * (u - uu * GR);
          const int w = 2 * rho + g.hi - 1 + uu, c1 = 2 * it.c2 + g.lov + j0;
          const bool own = w >= 2 * it.r2s && w < 2 * it.r2e && j0 >= -g.lov &&
                           j0 < 2 * g.q2 - g.lov && c1 < nh;
          col_pass<W, V>(ll, lh, hl, hh, S1 + j0, D1 + j0, (h1 + 2 * uu + XR) % g.r1, g.r1,
                         g.w1, own, cs, cd, ms, mda, mdd, g.span);
          __align__(16) A lr[V];
#pragma unroll
          for (int e = 0; e < V; ++e) lr[e] = rnd(ll[e], T());
          using AV = typename Vec16<A>::type;
          *reinterpret_cast<AV*>(L1 + uu * g.w1 + j0) = *reinterpret_cast<const AV*>(lr);
          if (own) {
#pragma unroll
            for (int p = 1; p < 4; ++p) {
              const A* v = p == 1 ? lh : p == 2 ? hl : hh;
              store_v<V>(o.p[p].row(it.b, w) + c1, v, (g.vmask >> p) & 1, nh - c1);
            }
          }
        } else {
          const int v2 = (u - n2) / GQ, j0 = V * (u - n2 - v2 * GQ);
          const int r2 = rhp + v2, cc = it.c2 + j0;
          if (r2 < it.r2s || r2 >= it.r2e || cc >= g.n4) continue;
          col_pass<W, V>(ll, lh, hl, hh, S2 + j0, D2 + j0, (h2 + 2 * v2 + 2 * SN_RS) % g.r2,
                         g.r2, g.q2, true, cs, cd, ms, mda, mdd, g.span);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const A* v = p == 0 ? ll : p == 1 ? lh : p == 2 ? hl : hh;
            const int pl = p == 0 ? 0 : p + 3;
            store_v<V>(o.p[pl].row(it.b, r2) + cc, v, (g.vmask >> pl) & 1, g.n4 - cc);
          }
        }
      }
      if (prev) {
        h2 += 2 * SN_RS;
        if (h2 >= g.r2) h2 -= g.r2;
      }
      if (now) {
        h1 += XR;
        if (h1 >= g.r1) h1 -= g.r1;
        q = q == SN_STAGES - 1 ? 0 : q + 1;
      }
    }
  }
}

template <typename T, int W, bool VEC>
int stage2_strip_launch(const StripGeom& g, StagePlane<const T> x, const StageOuts<T>& outs,
                        const int* offs, const void* coefs, int ns, int nd,
                        cudaStream_t stream) {
  using A = typename Acc<T>::type;
  return launch_persistent(stage2_strip_kernel<T, W, VEC>, g.items, SN_THREADS,
                           strip_smem<T>(g, ns + nd), stream, x, outs, g, offs,
                           static_cast<const A*>(coefs), ns, nd);
}

// The strip form's geometry (see StripGeom) and launch: a window of 8
// offsets below a span of 8, else 16; 16-byte staging where x's base,
// strides and width are whole 16-byte words.
template <typename T>
int stage2_strip(int B, int m, int n, const void* x, int64_t xsb, int64_t xsr,
                 const StageOuts<T>& outs, const int* offs, const void* coefs, int ns,
                 int nd, int dmin, int span, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  constexpr int E = 16 / sizeof(T), V = Vec16<A>::n;
  const bool vec = n % E == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   xsb % E == 0 && xsr % E == 0;
  StripGeom g;
  g.B = B;
  g.m = m;
  g.n = n;
  g.m4 = m / 4;
  g.n4 = n / 4;
  g.dmin = dmin;
  g.span = span;
  g.lo = dmin < 0 ? dmin : 0;
  g.hi = dmin + span > 1 ? dmin + span : 1;
  g.lov = -((-g.lo + V - 1) / V) * V;
  // the widest strip (q2 a multiple of 4) whose LL1 window row holds
  // SN_WIDTH bytes
  const int cap = SN_WIDTH / static_cast<int>(sizeof(A));
  g.q2 = (cap + 1 - g.hi + g.lov) / 2 / 4 * 4;
  g.w1 = (2 * g.q2 - 1 + g.hi - g.lov + 4 * V - 1) / (4 * V) * (4 * V);
  g.sh = vec ? (((2 * g.lov + dmin) % E) + E) % E : 0;
  g.ps = (g.sh + 2 * g.w1 - 1 + span + E - 1) / E * E;
  if (2 * V * sizeof(T) == 32 && g.ps * sizeof(T) % 32 == 0) g.ps += E;
  g.r1 = 4 * SN_RS + span - 1;
  g.r2 = 2 * SN_RS - 1 + g.hi - dmin;
  const int reach = 2 * (g.hi - g.lo) + span - 3;  // level-2 rows of warm-up, x4
  g.warm = reach <= 0 ? 0 : ((reach + 3) / 4 + SN_RS - 1) / SN_RS;
  g.strips = (g.n4 + g.q2 - 1) / g.q2;
  const int64_t rows = static_cast<int64_t>(g.m4) * B * g.strips;
  const int64_t want = (rows + SN_ITEMS - 1) / SN_ITEMS;
  g.seg = static_cast<int>((std::max<int64_t>(want, 1) + SN_RS - 1) / SN_RS * SN_RS);
  g.segs = (g.m4 + g.seg - 1) / g.seg;
  const int64_t items = static_cast<int64_t>(B) * g.segs * g.strips;
  if (items > 2147483647 || g.q2 < 4) return static_cast<int>(cudaErrorInvalidConfiguration);
  g.items = static_cast<int>(items);
  g.vmask = 0;
  for (int i = 0; i < 7; ++i)
    if (reinterpret_cast<uintptr_t>(outs.p[i].p) % (V * sizeof(T)) == 0 &&
        outs.p[i].sb % V == 0 && outs.p[i].sr % V == 0)
      g.vmask |= 1 << i;
  const StagePlane<const T> xp{static_cast<const T*>(x), xsb, xsr};
  const bool narrow = span < 8;
  if (vec)
    return narrow ? stage2_strip_launch<T, 8, true>(g, xp, outs, offs, coefs, ns, nd, stream)
                  : stage2_strip_launch<T, 16, true>(g, xp, outs, offs, coefs, ns, nd, stream);
  return narrow ? stage2_strip_launch<T, 8, false>(g, xp, outs, offs, coefs, ns, nd, stream)
                : stage2_strip_launch<T, 16, false>(g, xp, outs, offs, coefs, ns, nd, stream);
}

template <typename T>
int stage2_fw(int B, int m, int n, const void* x, int64_t xsb, int64_t xsr,
              void* const* o, const int64_t* osb, const int64_t* osr,
              const int* offs, const void* coefs, int ns, int nd, int dmin,
              int span, int T2, int strips, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  StageOuts<T> outs;
  for (int i = 0; i < 7; ++i)
    outs.p[i] = StagePlane<T>{static_cast<T*>(o[i]), osb[i], osr[i]};
  if (strips && span < 16)
    return stage2_strip<T>(B, m, n, x, xsb, xsr, outs, offs, coefs, ns, nd, dmin, span,
                           stream);
  const StageGeom g(T2, dmin, span);
  const int m2 = m / 4, n2 = n / 4;
  dim3 grid((n2 + T2 - 1) / T2, (m2 + T2 - 1) / T2, B);
  size_t smem = static_cast<size_t>(g.elems()) * sizeof(A) +
                static_cast<size_t>(ns + nd) * (sizeof(A) + 4 * sizeof(int));
  return launch(stage2_fw_kernel<T>, grid, dim3(NT), smem, stream,
                StagePlane<const T>{static_cast<const T*>(x), xsb, xsr}, m, n,
                outs, offs, static_cast<const A*>(coefs), ns, nd, dmin, span,
                T2);
}

}  // namespace wtt

extern "C" {

// Levels 1 and 2.  o / osb / osr: the LL2, LH1, HL1, HH1, LH2, HL2, HH2
// planes (pointer, batch stride, row stride, in elements).  offs / coefs:
// the analysis band table on the device, ns scaling taps then nd detail
// taps; dmin is the smallest offset and span the largest minus the
// smallest.  strips: run the strip form where the span is below 16 (else,
// and where strips is 0, the first form); T2: the first form's tile side
// in level-2 quads.
int wtt_stage2_fw(int dtype, int B, int m, int n, const void* x, int64_t xsb,
                  int64_t xsr, void* const* o, const int64_t* osb,
                  const int64_t* osr, const int* offs, const void* coefs,
                  int ns, int nd, int dmin, int span, int T2, int strips,
                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::stage2_fw<float>(B, m, n, x, xsb, xsr, o, osb, osr, offs, coefs, ns, nd, dmin, span, T2, strips, s);
    case wtt::F64:
      return wtt::stage2_fw<double>(B, m, n, x, xsb, xsr, o, osb, osr, offs, coefs, ns, nd, dmin, span, T2, strips, s);
    case wtt::BF16:
      return wtt::stage2_fw<__nv_bfloat16>(B, m, n, x, xsb, xsr, o, osb, osr, offs, coefs, ns, nd, dmin, span, T2, strips, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
