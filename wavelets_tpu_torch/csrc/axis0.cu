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
// The first forms of kernels I and J: threads run along C (loads
// and stores coalesced along the unit stride).  A block takes A0_LANES
// (batch, column) lanes: 32 columns of one batch item, or, where C < 32,
// every column of 32 / C batch items, so narrow deep levels keep the
// lanes busy; and A0_TR output pairs along R.  It stages its 2 * A0_TR +
// span input rows (wrapped with a true modulo: R can be 2 at the deepest
// level) in shared memory and computes its outputs from there.  In halo
// mode (the template flag HALO) a staged row above the view is read from
// the caller's `above` rows and one below it from `below`, instead of
// wrapping: above[H_above + r] for r < 0, below[r - R] for r >= R (the
// inverse likewise from the halos of a and of d).  The wrapper checks
// that each halo covers the bands' reach, so with halos equal to the
// wrapped rows the result is bit for bit the periodic one.  The inverse
// may read the scaling plane's leading (Bc, R/2, Cc) corner from a
// separate view: the 3-D inverse keeps the deeper level's result apart
// from the stored details, and this read joins them without a copy.
//
// Kernels J and I ran at 2.4x and 1.7x the copy floor in that form:
// 131,072 blocks at 16384^2, each reloading the band table and staging
// once behind one barrier (staging and taps never overlapped), scalar
// 4-byte loads and stores, two shared band-table reads per tap.  Their
// tiled forms (axis0_inv_tiled_kernel, axis0_fw_tiled_kernel) take kernel
// B's and F's design (csrc/level2d.cu, csrc/level1d.cu):
// * Staging.  Persistent blocks walk work items: 32 output pairs of a
//   strip of 32 V columns (V = 16 bytes of the arithmetic type) of one
//   batch item, or of several where C is narrower (the deep levels, the
//   3-D driver's sub-cubes); a small level takes smaller items, so that
//   it still spreads over the SMs.  Each item's window rows (J: pairs +
//   span rows of a and of d; I: 2 pairs - 1 + span rows of x) go into
//   shared memory by 16-byte cp.async in two stages, the next item's
//   copies in flight while this item's taps run.  Each staged row's
//   source is picked while staging, so the tap loops never branch on it:
//   the periodic wrap, the halo views in halo mode, and J's corner per
//   16-byte word (a word across Cc element by element).  Views whose
//   bases, strides or C are not whole 16-byte words take a 4-byte
//   staging path of the same kernel (VEC = false).
// * The bands in registers as dense windows (W = 8 or 16, chosen by the
//   span; masks select each band's taps): J's four synthesis bands over
//   the synthesis span, I's two analysis bands over [dmin, dmin + W).
// * Each thread takes V neighbouring columns of one output pair and reads
//   each staged 16-byte (bfloat16: 8-byte) word of its window once for
//   both sums (J: output rows 2k and 2k + 1; I: a and d, except a filter's
//   detail band, below), and stores each output row as one word where
//   that plane's base and strides allow (I checks a and d apart: the 3-D
//   and sharded drivers write views with strides of their own).
// * The arithmetic of the first forms: one explicit fma per tap, each
//   band in table order (J: the S band then the D band).  bands.py makes
//   every band ascending except a filter's detail band (offsets 1, 0, -1,
//   ...), which I runs in a descending loop of its own, as kernel E does.
//   So the tiled forms equal the first forms bit for bit in every dtype,
//   and halo mode with wrapped halos stays the periodic result bit for
//   bit (the sharded drivers rely on it).
// A span of 16 or more (J: db10 and up; I: coif4, sym5, db10 and up)
// takes the first form (axis0_inv_kernel, axis0_fw_kernel); so does a
// forward level of fewer than min_pairs output pairs in all, which the
// host passes (ops/axis0.py FW_A0_MIN_PAIRS, measured on the card).

#include <algorithm>

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

// --- kernels J and I: staged tiles, dense windows in registers ---------------

constexpr int JT_THREADS = 256;
constexpr int JT_TR = 32;      // output pairs (J: rows 2k, 2k + 1) of a full work item
constexpr int JT_MIN_TR = 8;   // ... and of the least
constexpr int JT_GROUPS = 32;  // column groups of V columns in a strip
// A level that full work items cut into fewer than JT_SPREAD takes smaller
// ones (first fewer batch items, then fewer output pairs, down to
// JT_MIN_TR), so that its items still spread over the card's resident
// blocks (two on each of the H100's 132 SMs) about twice.
constexpr int JT_SPREAD = 512;

// Columns (storage elements) of a strip: JT_GROUPS groups of V columns, V
// being 16 bytes of the arithmetic type; and the T elements of one stage,
// the a and d rows of a full item's window.
template <typename T>
__host__ __device__ constexpr int a0_strip() {
  return JT_GROUPS * Vec16<typename Acc<T>::type>::n;
}

template <typename T>
__host__ __device__ int a0_stage(int span) {
  return 2 * (JT_TR + span) * a0_strip<T>();
}

template <typename T>
size_t inv_tiled_smem(int span, int nt) {
  using A = typename Acc<T>::type;
  return 2 * static_cast<size_t>(a0_stage<T>(span)) * sizeof(T) +
         static_cast<size_t>(nt) * (sizeof(A) + sizeof(int));
}

// The work items of a tiled form over a level of (B, pairs, C) output
// pairs, filled by a0_items on the host; ops/axis0.py (_items) mirrors
// it.  A work item is tr <= JT_TR output pairs (k0 <= k < k0 + tr) of a
// strip of cw columns of 1 << bsh batch items: cw = a0_strip() where C is
// wider, else C, with as many batch items as one strip's room holds
// (fewer, and a smaller tr, where the level would have fewer than
// JT_SPREAD items).  Items run column strip first, then row band, then
// batch group, so the blocks at work at one time share their halo rows
// in L2.  A staged row of one batch item holds ps storage elements, cw
// rounded up to a 16-byte word, and takes 1 << lsh threads; column group
// j (V columns) of item bl of output pair r is unit (r << bsh | bl) << gsh
// | j.
struct A0Items {
  int tr, cw, ctiles, rtiles, items, bsh, gsh, ps, lsh;
};

// Fills g for a level of B batch items of `pairs` output pairs of C
// columns, its views staged by 16-byte words (vec) or elements; false
// where the items do not fit an int.
template <typename T>
bool a0_items(int B, int pairs, int C, bool vec, A0Items& g) {
  constexpr int E = 16 / sizeof(T), V = Vec16<typename Acc<T>::type>::n;
  constexpr int SW = a0_strip<T>();
  g.cw = C < SW ? C : SW;
  g.ctiles = (C + g.cw - 1) / g.cw;
  g.ps = (g.cw + E - 1) / E * E;
  g.gsh = ceil_log2((g.cw + V - 1) / V);
  // as many batch items as the strip's groups and room allow, no more than B
  int bsh = 0;
  while ((2 << bsh) <= (JT_GROUPS >> g.gsh) && (2 << bsh) * g.ps <= SW && (1 << bsh) < B)
    ++bsh;
  const auto count = [&](int tr, int bsh) {
    return static_cast<int64_t>(g.ctiles) * ((pairs + tr - 1) / tr) *
           ((B + (1 << bsh) - 1) >> bsh);
  };
  int tr = JT_TR;
  while (count(tr, bsh) < JT_SPREAD && (bsh > 0 || tr > JT_MIN_TR)) {
    if (bsh > 0)
      --bsh;
    else
      tr /= 2;
  }
  g.tr = tr;
  g.bsh = bsh;
  g.rtiles = (pairs + tr - 1) / tr;
  g.lsh = std::min(ceil_log2(vec ? g.ps / E : g.ps), 8);
  const int64_t items = count(tr, bsh);
  g.items = static_cast<int>(items);
  return items <= 2147483647;
}

// Work item t of g: its first batch item b0, output pair k0 and column c0.
__device__ __forceinline__ void a0_item(const A0Items& g, int t, int& b0, int& k0,
                                        int& c0) {
  const int rest = t / g.ctiles;
  c0 = (t - rest * g.ctiles) * g.cw;
  k0 = (rest % g.rtiles) * g.tr;
  b0 = (rest / g.rtiles) << g.bsh;
}

// Geometry of the tiled inverse, filled by the host; ops/axis0.py
// (inv_plan, inv_smem) mirrors it.  Its output pairs are rows 2k and 2k +
// 1; window row i is pair row k0 + smin + i, and the staged row of (i,
// source s, batch item bl) sits at ((2 i + s) << bsh | bl) * ps.
struct InvA0Geom : A0Items {
  int B, Rh, C, Bc, Cc, ha, smin, span;
};

// Kernel J's tiled form.  Each thread takes V neighbouring columns of one
// output pair: it reads each staged row of its window once, 16 bytes of
// the storage type (8 for bfloat16) of a and then of d, feeds it to the
// sums of both output rows 2k and 2k + 1, and stores each row as one
// word.  The windows run over the synthesis span, offsets smin + w for w <
// W, one per band (S0, S1, D0, D1) with a mask; each output sums its S
// band, then its D band, taps in ascending offset, the table's order.
// The staging picks each row's source, so the tap loops never branch on
// it: the periodic wrap (a true modulo: Rh can be 1), in halo mode the
// halo views above and below, and a's leading (Bc, Rh, Cc) block from the
// corner view (per 16-byte word; a word across Cc element by element).
template <typename T, int W, bool VEC, bool HALO>
__global__ void __launch_bounds__(JT_THREADS, 2)
axis0_inv_tiled_kernel(View3<const T> a, View3<const T> d, View3<const T> corner,
                       View3<const T> ah0, View3<const T> ah1, View3<const T> dh0,
                       View3<const T> dh1, View3<T> x, bool vout, InvA0Geom g,
                       const int* __restrict__ offs,
                       const typename Acc<T>::type* __restrict__ coefs, int n0,
                       int n1, int n2, int n3) {
  using A = typename Acc<T>::type;
  constexpr int E = 16 / sizeof(T);  // storage elements per 16-byte word
  constexpr int V = Vec16<A>::n;     // columns per thread
  using TW = typename Word<V * sizeof(T)>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stg = reinterpret_cast<T*>(smem_raw);  // two stages
  const int SB = a0_stage<T>(g.span);
  const int nt = n0 + n1 + n2 + n3, e0 = n0 + n1, e1 = e0 + n2;
  A* cf = reinterpret_cast<A*>(stg + 2 * SB);
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x;
  const int bpb = 1 << g.bsh;
  const int rs = (2 << g.bsh) * g.ps;  // one window row: a and d of bpb items

  // stage work item `t` into stage buffer `buf`: the tr + span window rows
  // of a and d that its pairs read, each row's source picked here
  const auto stage = [&](int t, int buf) {
    int b0, k0, c0;
    a0_item(g, t, b0, k0, c0);
    const int rows = min(g.tr, g.Rh - k0) + g.span;
    const int nb = min(bpb, g.B - b0), cwl = min(g.cw, g.C - c0);
    const int nw = VEC ? cwl / E : cwl;
    const int q0 = k0 + g.smin;
    const bool rin = q0 >= 0 && q0 + rows <= g.Rh;  // no row wraps or leaves
    T* dst = stg + buf * SB;
    const int sl = (1 << g.lsh) - 1;
    for (int s = tid >> g.lsh; s < (2 * rows) << g.bsh; s += JT_THREADS >> g.lsh) {
      const int bl = s & (bpb - 1), src = (s >> g.bsh) & 1, q = q0 + (s >> (g.bsh + 1));
      if (bl >= nb) continue;
      const int b = b0 + bl;
      const int row = HALO || rin ? q : wrap(q, g.Rh);
      const T* p;
      if (HALO && q < 0)
        p = src ? dh0.at(b, g.ha + q, c0) : ah0.at(b, g.ha + q, c0);
      else if (HALO && q >= g.Rh)
        p = src ? dh1.at(b, q - g.Rh, c0) : ah1.at(b, q - g.Rh, c0);
      else
        p = src ? d.at(b, row, c0) : a.at(b, row, c0);
      // columns below ccut come from the corner
      const int ccut = !HALO && src == 0 && b < g.Bc ? min(g.Cc - c0, cwl) : 0;
      const T* pc = ccut > 0 ? corner.at(b, row, c0) : p;
      T* dq = dst + s * g.ps;
      for (int k = tid & sl; k < nw; k += sl + 1) {
        if (!VEC) {
          dq[k] = (k < ccut ? pc : p)[k];
        } else if (k * E + E <= ccut || k * E >= ccut) {
          cp_async16(dq + k * E, (k * E < ccut ? pc : p) + k * E);
        } else {
          for (int e = 0; e < E; ++e) dq[k * E + e] = (k * E + e < ccut ? pc : p)[k * E + e];
        }
      }
    }
  };
  if (static_cast<int>(blockIdx.x) < g.items) stage(blockIdx.x, 0);
  cp_async_commit();

  load_bands(cf, of, coefs, offs, nt, tid, JT_THREADS);
  __syncthreads();
  // the dense windows: cs0[w] / ms0 bit w the parity-0 S band's tap at
  // offset smin + w (cs1: parity 1; cd0, cd1: the D bands)
  A cs0[W], cs1[W], cd0[W], cd1[W];
  const unsigned ms0 = band_window(cs0, cf, of, 0, n0, g.smin);
  const unsigned md0 = band_window(cd0, cf, of, n0, e0, g.smin);
  const unsigned ms1 = band_window(cs1, cf, of, e0, e1, g.smin);
  const unsigned md1 = band_window(cd1, cf, of, e1, nt, g.smin);

  for (int t = blockIdx.x, it = 0; t < g.items; t += gridDim.x, ++it) {
    // the next work item's loads go out before this one's taps
    if (t + static_cast<int>(gridDim.x) < g.items) stage(t + gridDim.x, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // this item staged
    int b0, k0, c0;
    a0_item(g, t, b0, k0, c0);
    const int tr = min(g.tr, g.Rh - k0);
    const int nb = min(bpb, g.B - b0), cwl = min(g.cw, g.C - c0);
    const T* sq = stg + (it & 1) * SB;
    for (int u = tid; u < g.tr << (g.bsh + g.gsh); u += JT_THREADS) {
      const int j0 = (u & ((1 << g.gsh) - 1)) * V;
      const int bl = (u >> g.gsh) & (bpb - 1), r = u >> (g.gsh + g.bsh);
      if (r >= tr || bl >= nb || j0 >= cwl) continue;
      const T* pa = sq + r * rs + bl * g.ps + j0;  // pa[w rs]: a at pair k + smin + w
      const T* pd = pa + bpb * g.ps;                // the same row of d
      A o0[V], o1[V];
#pragma unroll
      for (int e = 0; e < V; ++e) o0[e] = o1[e] = A(0);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (w > g.span) break;
        A v[V];
        load_words<V * sizeof(T)>(v, pa + w * rs, V);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if ((ms0 >> w) & 1) o0[e] = fma(cs0[w], v[e], o0[e]);
          if ((ms1 >> w) & 1) o1[e] = fma(cs1[w], v[e], o1[e]);
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (w > g.span) break;
        A v[V];
        load_words<V * sizeof(T)>(v, pd + w * rs, V);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if ((md0 >> w) & 1) o0[e] = fma(cd0[w], v[e], o0[e]);
          if ((md1 >> w) & 1) o1[e] = fma(cd1[w], v[e], o1[e]);
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const A* o = p ? o1 : o0;
        T* op = x.at(b0 + bl, 2 * (k0 + r) + p, c0 + j0);
        if (vout && j0 + V <= cwl) {
          __align__(16) T wv[V];
#pragma unroll
          for (int e = 0; e < V; ++e) st(wv + e, o[e]);
          *reinterpret_cast<TW*>(op) = *reinterpret_cast<const TW*>(wv);
        } else {
          for (int e = 0; e < V && j0 + e < cwl; ++e) st(op + e, o[e]);
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is restaged
  }
}

// T elements of one stage of kernel I's tiled form: the 2 JT_TR - 1 + span
// rows of x that a full item's pairs read, a strip wide.
template <typename T>
__host__ __device__ int a0_fw_stage(int span) {
  return (2 * JT_TR - 1 + span) * a0_strip<T>();
}

template <typename T>
size_t fw_tiled_smem(int span, int nt) {
  using A = typename Acc<T>::type;
  return 2 * static_cast<size_t>(a0_fw_stage<T>(span)) * sizeof(T) +
         static_cast<size_t>(nt) * (sizeof(A) + sizeof(int));
}

// Geometry of the tiled forward, filled by the host; ops/axis0.py
// (fw_plan, fw_smem) mirrors it.  Its output pairs are a and d of pair k
// (k < R / 2); window row i is x's row 2 k0 + dmin + i, and the staged row
// of (i, batch item bl) sits at (i << bsh | bl) * ps.
struct FwA0Geom : A0Items {
  int B, R, C, ha, dmin, span;
};

// Kernel I's tiled form.  Each thread takes V neighbouring columns of one
// output pair k: it reads each staged row 2k + dmin + w of its window once,
// 16 bytes of the storage type (8 for bfloat16), feeds it to the taps of
// both sums that reach it, and stores a and d as one word each where the
// plane allows (va, vd).  The windows run over [dmin, dmin + W), one per
// band with a mask; each sum takes its band's taps in table order:
// ascending, except a filter's detail band, which runs in a descending
// loop of its own (re-reading its rows).  The staging picks each row's
// source, so the tap loops never branch on it: the periodic wrap (a true
// modulo: R can be 2), in halo mode above[ha + r] for a row r < 0 and
// below[r - R] for r >= R.
template <typename T, int W, bool VEC, bool HALO>
__global__ void __launch_bounds__(JT_THREADS, 2)
axis0_fw_tiled_kernel(View3<const T> x, View3<const T> above, View3<const T> below,
                      View3<T> a, View3<T> d, bool va, bool vd, FwA0Geom g,
                      const int* __restrict__ offs,
                      const typename Acc<T>::type* __restrict__ coefs, int ns, int nd) {
  using A = typename Acc<T>::type;
  constexpr int E = 16 / sizeof(T);  // storage elements per 16-byte word
  constexpr int V = Vec16<A>::n;     // columns per thread
  using TW = typename Word<V * sizeof(T)>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stg = reinterpret_cast<T*>(smem_raw);  // two stages
  const int SB = a0_fw_stage<T>(g.span);
  const int nt = ns + nd;
  A* cf = reinterpret_cast<A*>(stg + 2 * SB);
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x;
  const int bpb = 1 << g.bsh;
  const int rs = bpb * g.ps;  // one window row: bpb items
  const int Rh = g.R / 2;

  // stage work item `t` into stage buffer `buf`: the 2 tr - 1 + span rows
  // of x that its pairs read, each row's source picked here
  const auto stage = [&](int t, int buf) {
    int b0, k0, c0;
    a0_item(g, t, b0, k0, c0);
    const int rows = 2 * min(g.tr, Rh - k0) - 1 + g.span;
    const int nb = min(bpb, g.B - b0), cwl = min(g.cw, g.C - c0);
    const int nw = VEC ? cwl / E : cwl;
    const int r0 = 2 * k0 + g.dmin;
    const bool rin = r0 >= 0 && r0 + rows <= g.R;  // no row wraps or leaves
    T* dst = stg + buf * SB;
    const int sl = (1 << g.lsh) - 1;
    for (int s = tid >> g.lsh; s < rows << g.bsh; s += JT_THREADS >> g.lsh) {
      const int bl = s & (bpb - 1), r = r0 + (s >> g.bsh);
      if (bl >= nb) continue;
      const int b = b0 + bl;
      const T* p;
      if (HALO && r < 0)
        p = above.at(b, g.ha + r, c0);
      else if (HALO && r >= g.R)
        p = below.at(b, r - g.R, c0);
      else
        p = x.at(b, HALO || rin ? r : wrap(r, g.R), c0);
      T* dq = dst + s * g.ps;
      for (int k = tid & sl; k < nw; k += sl + 1) {
        if (VEC)
          cp_async16(dq + k * E, p + k * E);
        else
          dq[k] = p[k];
      }
    }
  };
  if (static_cast<int>(blockIdx.x) < g.items) stage(blockIdx.x, 0);
  cp_async_commit();

  load_bands(cf, of, coefs, offs, nt, tid, JT_THREADS);
  __syncthreads();
  // the dense windows over offsets dmin + w, w < W: cs / ms bit w the
  // scaling band's tap there, cd / md the detail band's; the detail
  // band's mask goes to the ascending (mda) or descending (mdd) loop
  A cs[W], cd[W];
  const unsigned ms = band_window(cs, cf, of, 0, ns, g.dmin);
  const unsigned md = band_window(cd, cf, of, ns, nt, g.dmin);
  const bool drev = nd > 1 && of[ns + 1] < of[ns];
  const unsigned mda = drev ? 0u : md, mdd = drev ? md : 0u;
  const unsigned mup = ms | mda;  // rows the ascending loop reads

  for (int t = blockIdx.x, it = 0; t < g.items; t += gridDim.x, ++it) {
    // the next work item's loads go out before this one's taps
    if (t + static_cast<int>(gridDim.x) < g.items) stage(t + gridDim.x, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // this item staged
    int b0, k0, c0;
    a0_item(g, t, b0, k0, c0);
    const int tr = min(g.tr, Rh - k0);
    const int nb = min(bpb, g.B - b0), cwl = min(g.cw, g.C - c0);
    const T* sq = stg + (it & 1) * SB;
    for (int u = tid; u < g.tr << (g.bsh + g.gsh); u += JT_THREADS) {
      const int j0 = (u & ((1 << g.gsh) - 1)) * V;
      const int bl = (u >> g.gsh) & (bpb - 1), r = u >> (g.gsh + g.bsh);
      if (r >= tr || bl >= nb || j0 >= cwl) continue;
      const T* px = sq + 2 * r * rs + bl * g.ps + j0;  // px[w rs]: x row 2k + dmin + w
      A sa[V], da[V];
#pragma unroll
      for (int e = 0; e < V; ++e) sa[e] = da[e] = A(0);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (w > g.span) break;
        if (!((mup >> w) & 1)) continue;
        A v[V];
        load_words<V * sizeof(T)>(v, px + w * rs, V);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if ((ms >> w) & 1) sa[e] = fma(cs[w], v[e], sa[e]);
          if ((mda >> w) & 1) da[e] = fma(cd[w], v[e], da[e]);
        }
      }
      if (mdd) {
#pragma unroll
        for (int w = W - 1; w >= 0; --w) {
          if (!((mdd >> w) & 1)) continue;
          A v[V];
          load_words<V * sizeof(T)>(v, px + w * rs, V);
#pragma unroll
          for (int e = 0; e < V; ++e) da[e] = fma(cd[w], v[e], da[e]);
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const A* o = p ? da : sa;
        T* op = (p ? d : a).at(b0 + bl, k0 + r, c0 + j0);
        if ((p ? vd : va) && j0 + V <= cwl) {
          __align__(16) T wv[V];
#pragma unroll
          for (int e = 0; e < V; ++e) st(wv + e, o[e]);
          *reinterpret_cast<TW*>(op) = *reinterpret_cast<const TW*>(wv);
        } else {
          for (int e = 0; e < V && j0 + e < cwl; ++e) st(op + e, o[e]);
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is restaged
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

inline bool words16(const void* p, int64_t sb, int64_t sr, int e) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % e == 0 && sr % e == 0;
}

// An output plane that takes a word store of V columns: its base and its
// batch and row strides whole words of V storage elements.
template <typename T>
bool words_out(const void* p, int64_t sb, int64_t sr) {
  constexpr int V = Vec16<typename Acc<T>::type>::n;
  return reinterpret_cast<uintptr_t>(p) % (V * sizeof(T)) == 0 && sb % V == 0 && sr % V == 0;
}

template <typename T, int W, bool VEC, bool HALO>
int axis0_fw_launch(const FwA0Geom& g, const void* x, int64_t xsb, int64_t xsr,
                    const void* const* hp, const int64_t* hsb, const int64_t* hsr,
                    void* a, int64_t asb, int64_t asr, void* d, int64_t dsb, int64_t dsr,
                    bool va, bool vd, const int* offs, const void* coefs, int ns, int nd,
                    cudaStream_t stream) {
  using A = typename Acc<T>::type;
  return launch_persistent(
      axis0_fw_tiled_kernel<T, W, VEC, HALO>, g.items, JT_THREADS,
      fw_tiled_smem<T>(g.span, ns + nd), stream,
      View3<const T>{static_cast<const T*>(x), xsb, xsr}, halo_view<T>(hp, hsb, hsr, 0),
      halo_view<T>(hp, hsb, hsr, 1), View3<T>{static_cast<T*>(a), asb, asr},
      View3<T>{static_cast<T*>(d), dsb, dsr}, va, vd, g, offs,
      static_cast<const A*>(coefs), ns, nd);
}

// Kernel I's tiled form (spans below 16: a window of 8 or 16 offsets), on
// its 16-byte staging path where C and every view it reads (x, the halos)
// have 16-byte bases and batch and row strides of whole 16-byte words, on
// its 4-byte path otherwise.
template <typename T, bool HALO>
int axis0_fw_tiled(int B, int R, int C, const void* x, int64_t xsb, int64_t xsr,
                   void* a, int64_t asb, int64_t asr, void* d, int64_t dsb,
                   int64_t dsr, const void* const* hp, const int64_t* hsb,
                   const int64_t* hsr, int ha, const int* offs, const void* coefs,
                   int ns, int nd, int dmin, int span, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  bool vec = C % E == 0 && words16(x, xsb, xsr, E);
  if (HALO)
    for (int k = 0; k < 2; ++k) vec = vec && words16(hp[k], hsb[k], hsr[k], E);
  const bool va = words_out<T>(a, asb, asr), vd = words_out<T>(d, dsb, dsr);
  FwA0Geom g;
  if (!a0_items<T>(B, R / 2, C, vec, g)) return static_cast<int>(cudaErrorInvalidConfiguration);
  g.B = B;
  g.R = R;
  g.C = C;
  g.ha = ha;
  g.dmin = dmin;
  g.span = span;
  const bool narrow = span < 8;
  if (vec)
    return narrow ? axis0_fw_launch<T, 8, true, HALO>(g, x, xsb, xsr, hp, hsb, hsr, a, asb, asr, d, dsb, dsr, va, vd, offs, coefs, ns, nd, stream)
                  : axis0_fw_launch<T, 16, true, HALO>(g, x, xsb, xsr, hp, hsb, hsr, a, asb, asr, d, dsb, dsr, va, vd, offs, coefs, ns, nd, stream);
  return narrow ? axis0_fw_launch<T, 8, false, HALO>(g, x, xsb, xsr, hp, hsb, hsr, a, asb, asr, d, dsb, dsr, va, vd, offs, coefs, ns, nd, stream)
                : axis0_fw_launch<T, 16, false, HALO>(g, x, xsb, xsr, hp, hsb, hsr, a, asb, asr, d, dsb, dsr, va, vd, offs, coefs, ns, nd, stream);
}

// Kernel I: the tiled form for spans below 16 and levels of at least
// min_pairs output pairs (B R/2 C), the first form (one block per A0Grid
// tile, wrapped taps read from a shared window) otherwise.
template <typename T, bool HALO>
int axis0_fw(int B, int R, int C, const void* x, int64_t xsb, int64_t xsr,
             void* a, int64_t asb, int64_t asr, void* d, int64_t dsb,
             int64_t dsr, const void* const* hp, const int64_t* hsb,
             const int64_t* hsr, int ha, const int* offs, const void* coefs,
             int ns, int nd, int dmin, int span, int64_t min_pairs,
             cudaStream_t stream) {
  using A = typename Acc<T>::type;
  if (span < 16 && static_cast<int64_t>(B) * (R / 2) * C >= min_pairs)
    return axis0_fw_tiled<T, HALO>(B, R, C, x, xsb, xsr, a, asb, asr, d, dsb, dsr, hp,
                                   hsb, hsr, ha, offs, coefs, ns, nd, dmin, span, stream);
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

template <typename T, int W, bool VEC, bool HALO>
int axis0_inv_launch(const InvA0Geom& g, const void* a, int64_t asb, int64_t asr,
                     const void* d, int64_t dsb, int64_t dsr, const void* corner,
                     int64_t csb, int64_t csr, const void* const* hp, const int64_t* hsb,
                     const int64_t* hsr, void* x, int64_t xsb, int64_t xsr, bool vout,
                     const int* offs, const void* coefs, const int* nb,
                     cudaStream_t stream) {
  using A = typename Acc<T>::type;
  return launch_persistent(
      axis0_inv_tiled_kernel<T, W, VEC, HALO>, g.items, JT_THREADS,
      inv_tiled_smem<T>(g.span, nb[0] + nb[1] + nb[2] + nb[3]), stream,
      View3<const T>{static_cast<const T*>(a), asb, asr},
      View3<const T>{static_cast<const T*>(d), dsb, dsr},
      View3<const T>{static_cast<const T*>(corner), csb, csr},
      halo_view<T>(hp, hsb, hsr, 0), halo_view<T>(hp, hsb, hsr, 1),
      halo_view<T>(hp, hsb, hsr, 2), halo_view<T>(hp, hsb, hsr, 3),
      View3<T>{static_cast<T*>(x), xsb, xsr}, vout, g, offs,
      static_cast<const A*>(coefs), nb[0], nb[1], nb[2], nb[3]);
}

// Kernel J's tiled form (spans below 16: a window of 8 or 16 offsets), on
// its 16-byte staging path where C and every view it reads (a, d, the
// corner, the halos) have 16-byte bases and batch and row strides of whole
// 16-byte words, on its 4-byte path otherwise.
template <typename T, bool HALO>
int axis0_inv_tiled(int B, int Rh, int C, const void* a, int64_t asb, int64_t asr,
                    const void* d, int64_t dsb, int64_t dsr, const void* corner,
                    int64_t csb, int64_t csr, int Bc, int Cc, const void* const* hp,
                    const int64_t* hsb, const int64_t* hsr, int ha, void* x,
                    int64_t xsb, int64_t xsr, const int* offs, const void* coefs,
                    const int* nb, int smin, int span, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  bool vec = C % E == 0 && words16(a, asb, asr, E) && words16(d, dsb, dsr, E);
  if (Bc > 0 && Cc > 0) vec = vec && words16(corner, csb, csr, E);
  if (HALO)
    for (int k = 0; k < 4; ++k) vec = vec && words16(hp[k], hsb[k], hsr[k], E);
  const bool vout = words_out<T>(x, xsb, xsr);
  InvA0Geom g;
  if (!a0_items<T>(B, Rh, C, vec, g)) return static_cast<int>(cudaErrorInvalidConfiguration);
  g.B = B;
  g.Rh = Rh;
  g.C = C;
  g.Bc = Bc;
  g.Cc = Cc;
  g.ha = ha;
  g.smin = smin;
  g.span = span;
  const bool narrow = span < 8;
  if (vec)
    return narrow ? axis0_inv_launch<T, 8, true, HALO>(g, a, asb, asr, d, dsb, dsr, corner, csb, csr, hp, hsb, hsr, x, xsb, xsr, vout, offs, coefs, nb, stream)
                  : axis0_inv_launch<T, 16, true, HALO>(g, a, asb, asr, d, dsb, dsr, corner, csb, csr, hp, hsb, hsr, x, xsb, xsr, vout, offs, coefs, nb, stream);
  return narrow ? axis0_inv_launch<T, 8, false, HALO>(g, a, asb, asr, d, dsb, dsr, corner, csb, csr, hp, hsb, hsr, x, xsb, xsr, vout, offs, coefs, nb, stream)
                : axis0_inv_launch<T, 16, false, HALO>(g, a, asb, asr, d, dsb, dsr, corner, csb, csr, hp, hsb, hsr, x, xsb, xsr, vout, offs, coefs, nb, stream);
}

// Kernel J: the tiled form for spans below 16, the first form (one block
// per A0Grid tile, wrapped taps read from shared windows) above.
template <typename T, bool HALO>
int axis0_inv(int B, int Rh, int C, const void* a, int64_t asb, int64_t asr,
              const void* d, int64_t dsb, int64_t dsr, const void* corner,
              int64_t csb, int64_t csr, int Bc, int Cc, const void* const* hp,
              const int64_t* hsb, const int64_t* hsr, int ha, void* x,
              int64_t xsb, int64_t xsr, const int* offs, const void* coefs,
              const int* nb, int smin, int span, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  if (span < 16)
    return axis0_inv_tiled<T, HALO>(B, Rh, C, a, asb, asr, d, dsb, dsr, corner, csb, csr,
                                    Bc, Cc, hp, hsb, hsr, ha, x, xsb, xsr, offs, coefs, nb,
                                    smin, span, stream);
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
                int64_t min_pairs, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return axis0_fw<float, HALO>(B, R, C, x, xsb, xsr, a, asb, asr, d, dsb, dsr, hp, hsb, hsr, ha, offs, coefs, ns, nd, dmin, span, min_pairs, s);
    case F64:
      return axis0_fw<double, HALO>(B, R, C, x, xsb, xsr, a, asb, asr, d, dsb, dsr, hp, hsb, hsr, ha, offs, coefs, ns, nd, dmin, span, min_pairs, s);
    case BF16:
      return axis0_fw<__nv_bfloat16, HALO>(B, R, C, x, xsb, xsr, a, asb, asr, d, dsb, dsr, hp, hsb, hsr, ha, offs, coefs, ns, nd, dmin, span, min_pairs, s);
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
// smallest.  A level of fewer than min_pairs output pairs (B R/2 C) takes
// the first form (0: the tiled form wherever the span allows it).
int wtt_axis0_fw(int dtype, int B, int R, int C, const void* x, int64_t xsb,
                 int64_t xsr, void* a, int64_t asb, int64_t asr, void* d,
                 int64_t dsb, int64_t dsr, const int* offs, const void* coefs,
                 int ns, int nd, int dmin, int span, int64_t min_pairs,
                 void* stream) {
  return wtt::fw_dispatch<false>(dtype, B, R, C, x, xsb, xsr, a, asb, asr, d,
                                 dsb, dsr, nullptr, nullptr, nullptr, 0, offs,
                                 coefs, ns, nd, dmin, span, min_pairs, stream);
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
                      int64_t min_pairs, void* stream) {
  return wtt::fw_dispatch<true>(dtype, B, R, C, x, xsb, xsr, a, asb, asr, d,
                                dsb, dsr, hp, hsb, hsr, ha, offs, coefs, ns, nd,
                                dmin, span, min_pairs, stream);
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
