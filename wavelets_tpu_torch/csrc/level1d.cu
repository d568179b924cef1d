// One level of the periodic 1-D DWT over (B, n) rows, forward (kernel E)
// and inverse (kernel F), driven by the float64 bands of ops/bands.py
// (filter and lifting wavelets alike, no tap cap).
//
// Replaces: the batched 1-D level of wavelets_tpu/ops/pallas/dwt1d.py --
// _mxu_fw_kernel / _mxu_inv_kernel (the MXU level) and the three-kernel
// VPU form _step_fw_kernel + _split_kernel / _merge_kernel +
// _step_inv_kernel -- and the folded long-signal level of
// wavelets_tpu/ops/pallas/wide1d.py (_mxu_fw_kernel_w / _mxu_inv_kernel_w
// and the VPU _fw_kernel / _inv_kernel).  On the TPU those variants exist
// because a row had to fit VMEM (lane butterflies, the (R, C) fold, banded
// MXU dots); here one kernel takes any (B, n): B = 1 for a long signal,
// B = 2^d for a wavelet-packet depth d.  The deinterleave of the VPU form
// (#18) is E's output layout and the interleave (#19) F's input layout.
//
// Bound on the H100: memory traffic.  A level reads its row once and
// writes the same number of samples once (s and d); each output costs
// about 2 * taps loads, which the shared-memory tile serves, so device
// memory sees each input byte once.  The arithmetic (cdf97: 16 FMA per
// output pair) is far below the FP32 peak.
//
// The first forms of kernels E and F: a block takes a tile of up to E_TK
// (F_TK) output pairs of one row (a long row is split into tiles) or
// several whole rows (short rows, as at deep packet depths where rows have
// 2 samples), loads the tile's input window (wrapped modulo n, coalesced)
// into shared memory in the arithmetic type, and computes its outputs from
// there.  Rows and tiles ride blockIdx.x only (a packet depth can have
// 2^19 rows, beyond gridDim.y's 65535).  Outputs go through caller-given
// planes with their own row strides: the packed array's detail segment,
// or the two halves of each output row for the packet transform.
//
// Kernels F and E ran at 4.4x and 2.6x their bound in that form: an
// integer division, a wrap select and a scalar global load per staged
// element, a shared band-table read per tap, one or two outputs per
// thread as scalar stores, and 524,288 (F) or 262,144 (E) blocks at 16384
// rows of 16384.  Their design is kernel B's (csrc/level2d.cu):
// * Staging.  Persistent blocks walk work items: a tile of up to 512 V
//   pairs of one row, or as many whole short rows as fit one (a packet
//   depth of 2^19 rows of one pair runs 1024 items, not 2^19 blocks).
//   E cuts a small level into smaller items, so that they still spread
//   over the SMs.  Each item's windows (E: twice its pairs plus the span
//   in samples of x; F: its pairs plus the span of s and of d; wrapped
//   while staged) go into shared memory by 16-byte cp.async in two
//   stages, the next item's copies in flight while this item's taps run;
//   a staged row takes a power of two of threads, so no division per
//   element.  Inputs whose bases, row strides or length are
//   not whole 16-byte words take a 4-byte staging path of the same kernel
//   (VEC = false).
// * The bands in registers as dense windows (W = 8 or 16 wide, chosen by
//   the span; masks select each band's taps): E's over the union of the
//   two analysis bands' offsets, F's over the synthesis span.
// * Each thread makes V neighbouring pairs: E reads the 2V - 1 + span
//   staged samples they need once and stores V scaling and V detail
//   outputs as one word each (16 bytes, 8 for bfloat16) where the plane
//   allows; F makes 2V outputs, one 16-byte word of x.
// * The arithmetic of the first forms: one explicit fma per tap, each
//   band in table order (F: the S band then the D band; E: a filter's
//   detail band, held in descending offset order, in a loop of its own).
// A span of 16 or more (E: coif4, sym5, db10 and up; F: db10 and up)
// takes the first form (level1d_fw_kernel, level1d_inv_wrap_kernel); so
// does a forward level of fewer than min_pairs output pairs in all, which
// the host passes (ops/level1d.py FW1D_MIN_PAIRS, measured on the card):
// there the tiled form's fixed costs outweigh its faster staging.

#include <algorithm>

#include "common.cuh"

namespace wtt {

constexpr int E_THREADS = 256;
constexpr int E_TK = 512;        // output pairs per block, forward
constexpr int F_TK = 256;        // output pairs per block, inverse
constexpr size_t SMEM_SOFT = 48 * 1024;   // rows per block stop here

// Split of a level into blocks: `tk` pairs per tile, `tiles` tiles per
// row, `rpb` rows per block (rpb > 1 only when a whole row is one tile).
struct Tiling {
  int tk, tiles, rpb;
  int64_t blocks;
};

template <typename A>
Tiling tiling(int B, int pairs, int TK, int win_per_pair, int span, int nt) {
  Tiling t;
  t.tk = pairs < TK ? pairs : TK;
  t.tiles = (pairs + t.tk - 1) / t.tk;
  const size_t row_bytes = static_cast<size_t>(win_per_pair * t.tk + span) * sizeof(A);
  const size_t table = static_cast<size_t>(nt) * (sizeof(A) + sizeof(int));
  int rpb = TK / t.tk;
  const size_t room = SMEM_SOFT > table ? (SMEM_SOFT - table) / row_bytes : 0;
  if (static_cast<size_t>(rpb) > room) rpb = static_cast<int>(room);
  t.rpb = rpb < 1 ? 1 : rpb;
  t.blocks = static_cast<int64_t>((B + t.rpb - 1) / t.rpb) * t.tiles;
  return t;
}

// Forward: x (B, n) -> s, d (B, n/2):
//   s[b, k] = sum_i cs[i] x[b, (2k + ds[i]) mod n], d likewise with (dd, cd).
template <typename T>
__global__ void __launch_bounds__(E_THREADS)
level1d_fw_kernel(const T* __restrict__ x, int64_t xs, T* s, int64_t ss, T* d,
                  int64_t dst, int B, int n, int tk, int tiles, int rpb,
                  const int* __restrict__ offs,
                  const typename Acc<T>::type* __restrict__ coefs, int ns,
                  int nd, int dmin, int span) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = ns + nd;
  const int W = 2 * tk + span;            // window stride per row
  A* win = reinterpret_cast<A*>(smem_raw);  // [rpb][W]
  A* cf = win + static_cast<size_t>(rpb) * W;
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x, nth = blockDim.x;
  load_bands(cf, of, coefs, offs, nt, tid, nth);

  const int nh = n / 2;
  const int g = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int b0 = g * rpb;
  const int rows = min(rpb, B - b0);
  const int k0 = t * tk;
  const int cnt = min(tk, nh - k0);
  const int w = 2 * cnt + span;
  const int start = 2 * k0 + dmin;
  const bool inner = start >= 0 && start + w <= n;  // no sample wraps
  for (int i = tid; i < rows * w; i += nth) {
    const int r = i / w, j = i - r * w;
    const T* row = x + static_cast<int64_t>(b0 + r) * xs;
    const int idx = start + j;
    win[r * W + j] = ld(row[inner ? idx : wrap(idx, n)]);
  }
  __syncthreads();
  for (int i = tid; i < rows * cnt; i += nth) {
    const int r = i / cnt, kk = i - r * cnt;
    const A* v = win + r * W + 2 * kk - dmin;  // v[o] = x[2k + o]
    A sa = 0, da = 0;
    for (int k = 0; k < ns; ++k) sa += cf[k] * v[of[k]];
    for (int k = ns; k < nt; ++k) da += cf[k] * v[of[k]];
    const int64_t b = b0 + r;
    st(s + b * ss + k0 + kk, sa);
    st(d + b * dst + k0 + kk, da);
  }
}

// Inverse: s, d (B, nh) -> x (B, 2nh), from the per-parity synthesis bands
// S0, D0, S1, D1 (in that order in the band table):
//   x[b, 2k+p] = sum cS_p[i] s[b, (k + dS_p[i]) mod nh]
//              + sum cD_p[i] d[b, (k + dD_p[i]) mod nh].
// The first form of kernel F, for spans of 16 or more.
template <typename T>
__global__ void __launch_bounds__(E_THREADS)
level1d_inv_wrap_kernel(const T* __restrict__ s, int64_t ss, const T* __restrict__ d,
                   int64_t dst, T* x, int64_t xs, int B, int nh, int tk,
                   int tiles, int rpb, const int* __restrict__ offs,
                   const typename Acc<T>::type* __restrict__ coefs, int n0,
                   int n1, int n2, int n3, int smin, int span) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = n0 + n1 + n2 + n3;
  const int e0 = n0 + n1, e1 = e0 + n2;
  const int W = tk + span;
  A* ws = reinterpret_cast<A*>(smem_raw);   // [rpb][W] scaling window
  A* wd = ws + static_cast<size_t>(rpb) * W;  // [rpb][W] detail window
  A* cf = wd + static_cast<size_t>(rpb) * W;
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x, nth = blockDim.x;
  load_bands(cf, of, coefs, offs, nt, tid, nth);

  const int g = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int b0 = g * rpb;
  const int rows = min(rpb, B - b0);
  const int k0 = t * tk;
  const int cnt = min(tk, nh - k0);
  const int w = cnt + span;
  const int start = k0 + smin;
  const bool inner = start >= 0 && start + w <= nh;
  for (int i = tid; i < rows * w; i += nth) {
    const int r = i / w, j = i - r * w;
    const int64_t b = b0 + r;
    const int idx = inner ? start + j : wrap(start + j, nh);
    ws[r * W + j] = ld(s[b * ss + idx]);
    wd[r * W + j] = ld(d[b * dst + idx]);
  }
  __syncthreads();
  const int per_row = 2 * cnt;
  for (int i = tid; i < rows * per_row; i += nth) {
    const int r = i / per_row, j = i - r * per_row;
    const int kk = j >> 1, p = j & 1;
    const int ks = p ? e0 : 0, kd = p ? e1 : n0, ke = p ? nt : e0;
    const A* vs = ws + r * W + kk - smin;  // vs[o] = s[k + o]
    const A* vd = wd + r * W + kk - smin;
    A v = 0;
    for (int k = ks; k < kd; ++k) v += cf[k] * vs[of[k]];
    for (int k = kd; k < ke; ++k) v += cf[k] * vd[of[k]];
    st(x + static_cast<int64_t>(b0 + r) * xs + 2 * k0 + j, v);
  }
}

constexpr int64_t MAX_BLOCKS = 2147483647;

template <typename T>
int level1d_fw_wrap(int B, int n, const void* x, int64_t xs, void* s, int64_t ss,
                    void* d, int64_t dst, const int* offs, const void* coefs, int ns,
                    int nd, int dmin, int span, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const Tiling tl = tiling<A>(B, n / 2, E_TK, 2, span, ns + nd);
  if (tl.blocks > MAX_BLOCKS) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(tl.rpb) * (2 * tl.tk + span) * sizeof(A) +
                      static_cast<size_t>(ns + nd) * (sizeof(A) + sizeof(int));
  return launch(level1d_fw_kernel<T>, dim3(static_cast<unsigned>(tl.blocks)),
                dim3(E_THREADS), smem, stream, static_cast<const T*>(x), xs,
                static_cast<T*>(s), ss, static_cast<T*>(d), dst, B, n, tl.tk,
                tl.tiles, tl.rpb, offs, static_cast<const A*>(coefs), ns, nd,
                dmin, span);
}

// --- kernel E: staged tiles, dense windows in registers ----------------------

constexpr int FE_THREADS = 256;
constexpr int FE_GROUPS = 512;  // pair groups of V pairs per tile
constexpr int FE_SLACK = 32;    // staged elements of a row beyond a full tile's samples
constexpr int FE_PAD = 64;      // staged elements past a stage's last row
// A level that full tiles cut into fewer than FE_SPREAD work items takes
// smaller ones (down to FE_MIN_GROUPS groups of V pairs, or fewer short
// rows to an item), so that its items still spread over the card's
// resident blocks (two on each of the H100's 132 SMs) about twice.
constexpr int FE_SPREAD = 512;
constexpr int FE_MIN_GROUPS = 16;

// Geometry of the tiled forward, filled by the host; ops/level1d.py
// (fw1d_plan, fw1d_smem) mirrors it.  A work item is a tile of tk output
// pairs of rpb rows: a long row (n/2 above tk pairs: a full tile's
// FE_GROUPS V, or fewer in a small level) is cut into `tiles` tiles of one
// row each; shorter rows are one tile each, rpb of them together.  A staged row holds ps storage elements,
// element e being x[(2 k0 + dmin - sh + e) mod n], with sh = dmin mod E on
// the 16-byte path and 0 on the 4-byte path; ps is a whole number of
// 16-byte words.  Pair group j (V pairs) of a tile's row r is unit r << gsh
// | j; a staged row takes 1 << lsh threads.  A stage has room for one row of
// a full tile, so its size does not depend on the shape.
struct Fw1dGeom {
  int B, n, dmin, span, tk, tiles, rpb, gsh, ps, sh, lsh;
};

template <typename T>
__host__ __device__ constexpr int fw1d_stage() {  // T elements of one stage
  return 2 * FE_GROUPS * Vec16<typename Acc<T>::type>::n + FE_SLACK + FE_PAD;
}

template <typename T>
size_t fw1d_tiled_smem(int nt) {
  using A = typename Acc<T>::type;
  return 2 * static_cast<size_t>(fw1d_stage<T>()) * sizeof(T) +
         static_cast<size_t>(nt) * (sizeof(A) + sizeof(int));
}

// Kernel E's tiled form: each thread takes V neighbouring output pairs of
// one row (V = 16 bytes of the arithmetic type): it reads the 2V - 1 +
// span staged samples they need once, in the widest words their alignment
// allows, feeds each to every tap of both sums that reaches it, and
// stores the V scaling and the V detail outputs as one word each (16
// bytes, 8 for bfloat16) where the plane's base and row stride allow.  The
// windows run over the union of the two bands' offsets, [dmin, dmin + W);
// each sum takes its band's taps in table order, which bands.py makes
// ascending, except a filter's detail band (offsets 1, 0, -1, ...), which
// runs in a descending loop of its own (as kernel A's).
template <typename T, int W, bool VEC>
__global__ void __launch_bounds__(FE_THREADS, 2)
level1d_fw_tiled_kernel(const T* __restrict__ x, int64_t xs, T* s, int64_t ss, T* d,
                        int64_t dst, bool vs, bool vd, Fw1dGeom g,
                        const int* __restrict__ offs,
                        const typename Acc<T>::type* __restrict__ coefs, int ns, int nd) {
  using A = typename Acc<T>::type;
  constexpr int E = 16 / sizeof(T);  // storage elements per 16-byte word
  constexpr int V = Vec16<A>::n;     // output pairs per thread
  constexpr int NX = 2 * V + W - 1;  // staged samples a group may read
  constexpr int SB = fw1d_stage<T>();
  using TW = typename Word<V * sizeof(T)>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stg = reinterpret_cast<T*>(smem_raw);  // two stages: [rpb][ps]
  const int nt = ns + nd;
  A* cf = reinterpret_cast<A*>(stg + 2 * SB);
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x;
  const int nh = g.n / 2;
  const int total = (g.B + g.rpb - 1) / g.rpb * g.tiles;

  // stage work item `t` into stage buffer `buf`: 1 << lsh threads per
  // staged row, one per 16-byte word (per element on the 4-byte path); the
  // modulo only where the tile's window wraps
  const auto stage = [&](int t, int buf) {
    const int grp = t / g.tiles, b0 = grp * g.rpb;
    const int rows = min(g.rpb, g.B - b0), k0 = (t - grp * g.tiles) * g.tk;
    T* dstg = stg + buf * SB;
    const int cb = 2 * k0 + g.dmin - g.sh;
    const bool cin = cb >= 0 && cb + g.ps <= g.n;
    const int nw = VEC ? g.ps / E : g.ps, sl = (1 << g.lsh) - 1;
    for (int q = tid >> g.lsh; q < rows; q += FE_THREADS >> g.lsh) {
      const T* row = x + static_cast<int64_t>(b0 + q) * xs;
      T* dq = dstg + q * g.ps;
      for (int k = tid & sl; k < nw; k += sl + 1) {
        if (VEC)
          cp_async16(dq + k * E, row + (cin ? cb + k * E : wrap(cb + k * E, g.n)));
        else
          dq[k] = row[cin ? cb + k : wrap(cb + k, g.n)];
      }
    }
  };
  if (static_cast<int>(blockIdx.x) < total) stage(blockIdx.x, 0);
  cp_async_commit();

  load_bands(cf, of, coefs, offs, nt, tid, FE_THREADS);
  __syncthreads();
  // the dense windows over offsets dmin + w, w < W: cs / ms bit w the
  // scaling band's tap there, cd / md the detail band's; the detail
  // band's mask goes to the ascending (mda) or descending (mdd) loop
  A cs[W], cd[W];
  const unsigned ms = band_window(cs, cf, of, 0, ns, g.dmin);
  const unsigned md = band_window(cd, cf, of, ns, nt, g.dmin);
  const bool drev = nd > 1 && of[ns + 1] < of[ns];
  const unsigned mda = drev ? 0u : md, mdd = drev ? md : 0u;
  const int gran = window_gran(static_cast<long long>(g.sh) * sizeof(T),
                               2 * V * static_cast<long long>(sizeof(T)), sizeof(T));

  for (int t = blockIdx.x, it = 0; t < total; t += gridDim.x, ++it) {
    // the next work item's loads go out before this one's taps
    if (t + static_cast<int>(gridDim.x) < total) stage(t + gridDim.x, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // this item staged
    const int grp = t / g.tiles, b0 = grp * g.rpb;
    const int rows = min(g.rpb, g.B - b0), k0 = (t - grp * g.tiles) * g.tk;
    const int cnt = min(g.tk, nh - k0);
    const T* sq = stg + (it & 1) * SB;
    for (int u = tid; u < g.rpb << g.gsh; u += FE_THREADS) {
      const int r = u >> g.gsh, k = (u & ((1 << g.gsh) - 1)) * V;
      if (r >= rows || k >= cnt) continue;
      A xv[NX];
      load_window(xv, sq + r * g.ps + 2 * k + g.sh, 2 * V - 1 + g.span, gran);
      A sv[V], dv[V];
#pragma unroll
      for (int e = 0; e < V; ++e) sv[e] = dv[e] = A(0);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (w > g.span) break;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if ((ms >> w) & 1) sv[e] = fma(cs[w], xv[2 * e + w], sv[e]);
          if ((mda >> w) & 1) dv[e] = fma(cd[w], xv[2 * e + w], dv[e]);
        }
      }
      if (mdd) {
#pragma unroll
        for (int w = W - 1; w >= 0; --w) {
#pragma unroll
          for (int e = 0; e < V; ++e)
            if ((mdd >> w) & 1) dv[e] = fma(cd[w], xv[2 * e + w], dv[e]);
        }
      }
      const int64_t b = b0 + r;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const A* o = p ? dv : sv;
        T* op = p ? d + b * dst + k0 + k : s + b * ss + k0 + k;
        if ((p ? vd : vs) && k + V <= cnt) {
          __align__(16) T wv[V];
#pragma unroll
          for (int e = 0; e < V; ++e) st(wv + e, o[e]);
          *reinterpret_cast<TW*>(op) = *reinterpret_cast<const TW*>(wv);
        } else {
          for (int e = 0; e < V && k + e < cnt; ++e) st(op + e, o[e]);
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is restaged
  }
}

template <typename T, int W, bool VEC>
int level1d_fw_tiled(const Fw1dGeom& g, const void* x, int64_t xs, void* s, int64_t ss,
                     void* d, int64_t dst, bool vs, bool vd, const int* offs,
                     const void* coefs, int ns, int nd, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int64_t work = static_cast<int64_t>((g.B + g.rpb - 1) / g.rpb) * g.tiles;
  if (work > 2147483647) return static_cast<int>(cudaErrorInvalidConfiguration);
  return launch_persistent(level1d_fw_tiled_kernel<T, W, VEC>, static_cast<int>(work),
                           FE_THREADS, fw1d_tiled_smem<T>(ns + nd), stream,
                           static_cast<const T*>(x), xs, static_cast<T*>(s), ss,
                           static_cast<T*>(d), dst, vs, vd, g, offs,
                           static_cast<const A*>(coefs), ns, nd);
}

// Kernel E: the tiled form for spans below 16 (a window of 8 or 16
// offsets) and levels of at least min_pairs output pairs, 16-byte staging
// where x's base, row stride and n are whole 16-byte words; the first
// form otherwise.
template <typename T>
int level1d_fw(int B, int n, const void* x, int64_t xs, void* s, int64_t ss,
               void* d, int64_t dst, const int* offs, const void* coefs, int ns,
               int nd, int dmin, int span, int64_t min_pairs, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  if (span >= 16 || static_cast<int64_t>(B) * (n / 2) < min_pairs)
    return level1d_fw_wrap<T>(B, n, x, xs, s, ss, d, dst, offs, coefs, ns, nd, dmin,
                              span, stream);
  constexpr int E = 16 / sizeof(T), V = Vec16<A>::n, full = FE_GROUPS * V;
  const bool vec = n % E == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && xs % E == 0;
  const bool vs = reinterpret_cast<uintptr_t>(s) % (V * sizeof(T)) == 0 && ss % V == 0;
  const bool vd = reinterpret_cast<uintptr_t>(d) % (V * sizeof(T)) == 0 && dst % V == 0;
  const int nh = n / 2;
  Fw1dGeom g;
  g.B = B;
  g.n = n;
  g.dmin = dmin;
  g.span = span;
  g.sh = vec ? ((dmin % E) + E) % E : 0;
  // pairs per work item: a full tile, or a FE_SPREAD-th of the level
  const int64_t want = static_cast<int64_t>(B) * nh / FE_SPREAD;
  const int per = static_cast<int>(
      std::min<int64_t>(full, std::max<int64_t>(FE_MIN_GROUPS * V, (want + V - 1) / V * V)));
  g.tk = nh > per ? per : nh;
  g.tiles = (nh + g.tk - 1) / g.tk;
  g.gsh = ceil_log2((g.tk + V - 1) / V);
  g.ps = (g.sh + 2 * g.tk - 1 + span + E - 1) / E * E;
  // as many short rows as the groups, one stage's room and the spread allow
  const int fit = (2 * full + FE_SLACK) / g.ps;
  g.rpb = std::max(1, std::min(std::min(FE_GROUPS >> g.gsh, fit), per / g.tk));
  g.lsh = std::min(ceil_log2(vec ? g.ps / E : g.ps), 8);
  const bool narrow = span < 8;
  if (vec)
    return narrow ? level1d_fw_tiled<T, 8, true>(g, x, xs, s, ss, d, dst, vs, vd, offs, coefs, ns, nd, stream)
                  : level1d_fw_tiled<T, 16, true>(g, x, xs, s, ss, d, dst, vs, vd, offs, coefs, ns, nd, stream);
  return narrow ? level1d_fw_tiled<T, 8, false>(g, x, xs, s, ss, d, dst, vs, vd, offs, coefs, ns, nd, stream)
                : level1d_fw_tiled<T, 16, false>(g, x, xs, s, ss, d, dst, vs, vd, offs, coefs, ns, nd, stream);
}

// --- kernel F: staged tiles, dense windows in registers ----------------------

constexpr int FI_THREADS = 256;
constexpr int FI_GROUPS = 512;  // pair groups of V pairs per tile
constexpr int FI_SLACK = 32;    // staged elements of a row beyond a full tile's pairs
constexpr int FI_PAD = 64;      // staged elements past a stage's last row

// Geometry of the tiled inverse, filled by the host; ops/level1d.py
// (inv1d_smem) mirrors the shared bytes.  A work item is a tile of tk
// output pairs of rpb rows: a long row (nh above a full tile's FI_GROUPS V
// pairs) is cut into `tiles` tiles of one row each; shorter rows are one
// tile each, rpb of them together.  A staged row of s or d holds ps
// storage elements, element e being (k0 + smin - sh + e) mod nh, with sh =
// smin mod E on the 16-byte path and 0 on the 4-byte path; ps is a whole
// number of 16-byte words.  Pair group g (V pairs) of a tile's row r is
// unit r << gsh | g; staged slot q (the s row of tile row q >> 1, or its d
// row) takes 1 << lsh threads.  A stage has room for two rows of a full
// tile, so its size does not depend on the shape.
struct Inv1dGeom {
  int B, nh, smin, span, tk, tiles, rpb, gsh, ps, sh, lsh;
};

template <typename T>
__host__ __device__ constexpr int inv1d_stage() {  // T elements of one stage
  return 2 * (FI_GROUPS * (8 / static_cast<int>(sizeof(T))) + FI_SLACK) + FI_PAD;
}

template <typename T>
size_t inv1d_tiled_smem(int nt) {
  using A = typename Acc<T>::type;
  return 2 * static_cast<size_t>(inv1d_stage<T>()) * sizeof(T) +
         static_cast<size_t>(nt) * (sizeof(A) + sizeof(int));
}

// Kernel F's tiled form: each thread takes V neighbouring pairs of one row
// (2V outputs, one 16-byte word of x): it reads the V + span staged
// values of s and of d that they need once, in words of 8 bytes where
// their alignment allows, feeds each to every tap that reaches it, and
// stores the 2V outputs as one 16-byte word.  The windows run over the
// synthesis span, offsets smin + d for d < W, one per band (S0, S1, D0,
// D1) with a mask; each output sums its S band, then its D band, taps in
// ascending offset, the table's order (bands.py reads them off in that
// order).
template <typename T, int W, bool VEC>
__global__ void __launch_bounds__(FI_THREADS, 2)
level1d_inv_tiled_kernel(const T* __restrict__ s, int64_t ss, const T* __restrict__ d,
                         int64_t dst, T* x, int64_t xs, bool vout, Inv1dGeom g,
                         const int* __restrict__ offs,
                         const typename Acc<T>::type* __restrict__ coefs, int n0, int n1,
                         int n2, int n3) {
  using A = typename Acc<T>::type;
  constexpr int E = 16 / sizeof(T);  // storage elements per 16-byte word
  constexpr int V = E / 2;           // pairs per thread
  constexpr int NV = V + W - 1;      // staged values a group may read per source
  constexpr int SB = inv1d_stage<T>();
  using TW = typename Word<16>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stg = reinterpret_cast<T*>(smem_raw);  // two stages: [rpb][s row, d row]
  const int nt = n0 + n1 + n2 + n3, e0 = n0 + n1, e1 = e0 + n2;
  A* cf = reinterpret_cast<A*>(stg + 2 * SB);
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x;
  const int groups = (g.B + g.rpb - 1) / g.rpb, total = groups * g.tiles;

  // stage work item `t` into stage buffer `buf`: 1 << lsh threads per
  // staged row, one per 16-byte word (per element on the 4-byte path); the
  // modulo only where the tile's window wraps
  const auto stage = [&](int t, int buf) {
    const int grp = t / g.tiles, b0 = grp * g.rpb;
    const int rows = min(g.rpb, g.B - b0), k0 = (t - grp * g.tiles) * g.tk;
    T* dstg = stg + buf * SB;
    const int cb = k0 + g.smin - g.sh;
    const bool cin = cb >= 0 && cb + g.ps <= g.nh;
    const int nw = VEC ? g.ps / E : g.ps, sl = (1 << g.lsh) - 1;
    for (int q = tid >> g.lsh; q < 2 * rows; q += FI_THREADS >> g.lsh) {
      const int64_t b = b0 + (q >> 1);
      const T* row = (q & 1) ? d + b * dst : s + b * ss;
      T* dq = dstg + q * g.ps;
      for (int k = tid & sl; k < nw; k += sl + 1) {
        if (VEC)
          cp_async16(dq + k * E, row + (cin ? cb + k * E : wrap(cb + k * E, g.nh)));
        else
          dq[k] = row[cin ? cb + k : wrap(cb + k, g.nh)];
      }
    }
  };
  if (static_cast<int>(blockIdx.x) < total) stage(blockIdx.x, 0);
  cp_async_commit();

  load_bands(cf, of, coefs, offs, nt, tid, FI_THREADS);
  __syncthreads();
  // the dense windows: cs0[w] / ms0 bit w the parity-0 S band's tap at
  // offset smin + w (cs1: parity 1; cd0, cd1: the D bands)
  A cs0[W], cs1[W], cd0[W], cd1[W];
  unsigned ms0 = 0, ms1 = 0, md0 = 0, md1 = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    cs0[w] = cs1[w] = cd0[w] = cd1[w] = A(0);
    for (int k = 0; k < nt; ++k) {
      if (of[k] - g.smin != w) continue;
      const int band = k < n0 ? 0 : k < e0 ? 1 : k < e1 ? 2 : 3;
      if (band == 0) { cs0[w] = cf[k]; ms0 |= 1u << w; }
      if (band == 1) { cd0[w] = cf[k]; md0 |= 1u << w; }
      if (band == 2) { cs1[w] = cf[k]; ms1 |= 1u << w; }
      if (band == 3) { cd1[w] = cf[k]; md1 |= 1u << w; }
    }
  }
  const int gran = window_gran(static_cast<long long>(g.sh) * sizeof(T),
                               V * static_cast<long long>(sizeof(T)), sizeof(T));
  const int cntv = V + g.span;

  for (int t = blockIdx.x, it = 0; t < total; t += gridDim.x, ++it) {
    // the next work item's loads go out before this one's taps
    if (t + static_cast<int>(gridDim.x) < total) stage(t + gridDim.x, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // this item staged
    const int grp = t / g.tiles, b0 = grp * g.rpb;
    const int rows = min(g.rpb, g.B - b0), k0 = (t - grp * g.tiles) * g.tk;
    const int cnt = min(g.tk, g.nh - k0);
    const T* sq = stg + (it & 1) * SB;
    for (int u = tid; u < g.rpb << g.gsh; u += FI_THREADS) {
      const int r = u >> g.gsh, k = (u & ((1 << g.gsh) - 1)) * V;
      if (r >= rows || k >= cnt) continue;
      A sv[NV], dv[NV];
      load_window(sv, sq + 2 * r * g.ps + k + g.sh, cntv, gran);
      load_window(dv, sq + (2 * r + 1) * g.ps + k + g.sh, cntv, gran);
      A o[2 * V];
#pragma unroll
      for (int e = 0; e < 2 * V; ++e) o[e] = A(0);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (w > g.span) break;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if ((ms0 >> w) & 1) o[2 * e] = fma(cs0[w], sv[e + w], o[2 * e]);
          if ((ms1 >> w) & 1) o[2 * e + 1] = fma(cs1[w], sv[e + w], o[2 * e + 1]);
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (w > g.span) break;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if ((md0 >> w) & 1) o[2 * e] = fma(cd0[w], dv[e + w], o[2 * e]);
          if ((md1 >> w) & 1) o[2 * e + 1] = fma(cd1[w], dv[e + w], o[2 * e + 1]);
        }
      }
      T* op = x + static_cast<int64_t>(b0 + r) * xs + 2 * (k0 + k);
      if (vout && k + V <= cnt) {
        __align__(16) T wv[2 * V];
#pragma unroll
        for (int e = 0; e < 2 * V; ++e) st(wv + e, o[e]);
        *reinterpret_cast<TW*>(op) = *reinterpret_cast<const TW*>(wv);
      } else {
        for (int e = 0; e < 2 * V && k + e / 2 < cnt; ++e) st(op + e, o[e]);
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is restaged
  }
}

template <typename T>
int level1d_inv_wrap(int B, int nh, const void* s, int64_t ss, const void* d,
                     int64_t dst, void* x, int64_t xs, const int* offs,
                     const void* coefs, const int* nb, int smin, int span,
                     cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int nt = nb[0] + nb[1] + nb[2] + nb[3];
  // two windows (s and d) of tk + span samples per row
  const Tiling tl = tiling<A>(B, nh, F_TK, 2, 2 * span, nt);
  if (tl.blocks > MAX_BLOCKS) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = 2 * static_cast<size_t>(tl.rpb) * (tl.tk + span) * sizeof(A) +
                      static_cast<size_t>(nt) * (sizeof(A) + sizeof(int));
  return launch(level1d_inv_wrap_kernel<T>, dim3(static_cast<unsigned>(tl.blocks)),
                dim3(E_THREADS), smem, stream, static_cast<const T*>(s), ss,
                static_cast<const T*>(d), dst, static_cast<T*>(x), xs, B, nh,
                tl.tk, tl.tiles, tl.rpb, offs, static_cast<const A*>(coefs),
                nb[0], nb[1], nb[2], nb[3], smin, span);
}

template <typename T, int W, bool VEC>
int level1d_inv_tiled(const Inv1dGeom& g, const void* s, int64_t ss, const void* d,
                      int64_t dst, void* x, int64_t xs, bool vout, const int* offs,
                      const void* coefs, const int* nb, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int64_t work = static_cast<int64_t>((g.B + g.rpb - 1) / g.rpb) * g.tiles;
  if (work > 2147483647) return static_cast<int>(cudaErrorInvalidConfiguration);
  return launch_persistent(level1d_inv_tiled_kernel<T, W, VEC>, static_cast<int>(work),
                           FI_THREADS, inv1d_tiled_smem<T>(nb[0] + nb[1] + nb[2] + nb[3]),
                           stream, static_cast<const T*>(s), ss, static_cast<const T*>(d),
                           dst, static_cast<T*>(x), xs, vout, g, offs,
                           static_cast<const A*>(coefs), nb[0], nb[1], nb[2], nb[3]);
}

// Kernel F: the tiled form for spans below 16 (a window of 8 or 16
// offsets), 16-byte staging where s's and d's bases and row strides and nh
// are whole 16-byte words; the first form otherwise.
template <typename T>
int level1d_inv(int B, int nh, const void* s, int64_t ss, const void* d,
                int64_t dst, void* x, int64_t xs, const int* offs,
                const void* coefs, const int* nb, int smin, int span,
                cudaStream_t stream) {
  if (span >= 16)
    return level1d_inv_wrap<T>(B, nh, s, ss, d, dst, x, xs, offs, coefs, nb, smin, span,
                               stream);
  constexpr int E = 16 / sizeof(T), V = E / 2, full = FI_GROUPS * V;
  const bool vec = nh % E == 0 && reinterpret_cast<uintptr_t>(s) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(d) % 16 == 0 && ss % E == 0 && dst % E == 0;
  const bool vout = reinterpret_cast<uintptr_t>(x) % 16 == 0 && xs % E == 0;
  Inv1dGeom g;
  g.B = B;
  g.nh = nh;
  g.smin = smin;
  g.span = span;
  g.sh = vec ? ((smin % E) + E) % E : 0;
  g.tk = nh > full ? full : nh;
  g.tiles = (nh + g.tk - 1) / g.tk;
  g.gsh = ceil_log2((g.tk + V - 1) / V);
  g.ps = (g.sh + g.tk + span + E - 1) / E * E;
  // as many short rows as the groups and a stage's two full rows allow
  const int fit = 2 * (full + FI_SLACK) / (2 * g.ps);
  g.rpb = std::max(1, std::min(FI_GROUPS >> g.gsh, fit));
  g.lsh = std::min(ceil_log2(vec ? g.ps / E : g.ps), 8);
  const bool narrow = span < 8;
  if (vec)
    return narrow ? level1d_inv_tiled<T, 8, true>(g, s, ss, d, dst, x, xs, vout, offs, coefs, nb, stream)
                  : level1d_inv_tiled<T, 16, true>(g, s, ss, d, dst, x, xs, vout, offs, coefs, nb, stream);
  return narrow ? level1d_inv_tiled<T, 8, false>(g, s, ss, d, dst, x, xs, vout, offs, coefs, nb, stream)
                : level1d_inv_tiled<T, 16, false>(g, s, ss, d, dst, x, xs, vout, offs, coefs, nb, stream);
}

}  // namespace wtt

extern "C" {

// Forward level.  x: (B, n) with row stride xs; s, d: the (B, n/2) output
// planes with row strides ss, ds (all strides in elements, unit column
// stride).  offs / coefs: the analysis band table on the device, ns
// scaling taps then nd detail taps; dmin is the smallest offset and span
// the largest minus the smallest.  Bands that reach too far for one
// tile's window in shared memory are refused with
// cudaErrorInvalidConfiguration (launch() in common.cuh).  A level of
// fewer than min_pairs output pairs (B n/2) takes the first form.
int wtt_level1d_fw(int dtype, int B, int n, const void* x, int64_t xs, void* s,
                   int64_t ss, void* d, int64_t ds, const int* offs,
                   const void* coefs, int ns, int nd, int dmin, int span,
                   int64_t min_pairs, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::level1d_fw<float>(B, n, x, xs, s, ss, d, ds, offs, coefs, ns, nd, dmin, span, min_pairs, st);
    case wtt::F64:
      return wtt::level1d_fw<double>(B, n, x, xs, s, ss, d, ds, offs, coefs, ns, nd, dmin, span, min_pairs, st);
    case wtt::BF16:
      return wtt::level1d_fw<__nv_bfloat16>(B, n, x, xs, s, ss, d, ds, offs, coefs, ns, nd, dmin, span, min_pairs, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Inverse level.  s, d: the (B, nh) planes to read (row strides ss, ds);
// x: the (B, 2nh) output with row stride xs.  nb: the tap counts of the
// synthesis bands S0, D0, S1, D1; smin / span as for the forward.
int wtt_level1d_inv(int dtype, int B, int nh, const void* s, int64_t ss,
                    const void* d, int64_t ds, void* x, int64_t xs,
                    const int* offs, const void* coefs, const int* nb, int smin,
                    int span, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::level1d_inv<float>(B, nh, s, ss, d, ds, x, xs, offs, coefs, nb, smin, span, st);
    case wtt::F64:
      return wtt::level1d_inv<double>(B, nh, s, ss, d, ds, x, xs, offs, coefs, nb, smin, span, st);
    case wtt::BF16:
      return wtt::level1d_inv<__nv_bfloat16>(B, nh, s, ss, d, ds, x, xs, offs, coefs, nb, smin, span, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
