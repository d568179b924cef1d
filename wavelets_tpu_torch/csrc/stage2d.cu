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
// sheet's 3.35 TB/s, against 0.80 ms for two launches of kernel A, whose
// level 2 reads LL1 back from device memory.  The arithmetic (cdf97: about
// 45 FMA per sample at level 1, a quarter of that at level 2, plus the
// recomputed ring) stays far below the FP32 peak.
//
// Design: one block of NT threads per T2 x T2 tile of level-2 quads and
// one image (blockIdx.z).  The level-2 tile reads LL1 rows and columns
// [2 r2 + dmin, 2 (r2 + T2 - 1) + dmax]; widened to cover the tile's own
// level-1 quads, that is a W1 x W1 window of LL1 (the ring of reach r on
// each side), which in turn reads an XR x XR window of x.  The block
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
// coefficient and offset, read from shared memory, serve RB products (the
// passes are bound by instruction issue, not by the card's memory).  Each
// sum takes its taps in kernel A's order, so the result is A's, launch for
// launch.  Shared memory holds the x window and the row pass; LL1 and
// level 2's row pass reuse them.  The wrapper picks the largest T2 whose
// window fits (32 for cdf97 in float32, 16 in float64), and launch()
// refuses more than the card's 227 KiB.  Overlapping the window loads with
// compute (cp.async or TMA, several tiles per block) is left to later work.

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

template <typename T>
int stage2_fw(int B, int m, int n, const void* x, int64_t xsb, int64_t xsr,
              void* const* o, const int64_t* osb, const int64_t* osr,
              const int* offs, const void* coefs, int ns, int nd, int dmin,
              int span, int T2, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  StageOuts<T> outs;
  for (int i = 0; i < 7; ++i)
    outs.p[i] = StagePlane<T>{static_cast<T*>(o[i]), osb[i], osr[i]};
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
// smallest.  T2: the tile's side in level-2 quads.
int wtt_stage2_fw(int dtype, int B, int m, int n, const void* x, int64_t xsb,
                  int64_t xsr, void* const* o, const int64_t* osb,
                  const int64_t* osr, const int* offs, const void* coefs,
                  int ns, int nd, int dmin, int span, int T2, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::stage2_fw<float>(B, m, n, x, xsb, xsr, o, osb, osr, offs, coefs, ns, nd, dmin, span, T2, s);
    case wtt::F64:
      return wtt::stage2_fw<double>(B, m, n, x, xsb, xsr, o, osb, osr, offs, coefs, ns, nd, dmin, span, T2, s);
    case wtt::BF16:
      return wtt::stage2_fw<__nv_bfloat16>(B, m, n, x, xsb, xsr, o, osb, osr, offs, coefs, ns, nd, dmin, span, T2, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
