// All remaining levels of a periodic 1-D DWT over (B, n) rows in one
// launch, forward (kernel G) and inverse (kernel H), driven by the float64
// bands of ops/bands.py.
//
// Replaces: the multi-level pyramid of wavelets_tpu/ops/pallas/pyramid1d.py
// (_fw_kernel, called through _stage_fw, and _inv_kernel through
// _stage_inv): several levels per launch with each level's detail
// streamed to its packed offset.  On the TPU a stage covers two levels of
// a long folded signal; here a whole row of up to 2^14 samples (f32,
// bf16; 2^13 in f64) stays in one block's shared memory for every
// remaining level, so the batched rows of a (4096, 4096) transform take
// all eight levels in one launch, and a long signal takes its deepest
// levels in one launch after the level kernels (csrc/level1d.cu).
//
// Bound on the H100: memory traffic at large batches (each row is read
// once and its packed result written once, whatever the level count), and
// launch latency plus the in-block synchronisation per level for a single
// short row.  The row and one scratch row sit in shared memory in the
// arithmetic type, so the size limit is the 227 KB a block may use
// (ops/tail1d.py, tail1d_fits).
//
// Design of the first forms of G and H: one block per row.  Per level, each
// thread computes output pairs from the active row in shared memory into
// the scratch row (the wrap is a true modulo on the level's own length,
// skipped where no tap can wrap), streams the forward's details straight
// to their packed offsets in device memory, and __syncthreads() separates
// the levels.  The intermediate scaling band stays in the arithmetic type,
// so bf16 rounds once.  The forward writes the final scaling band to the
// row's head; the inverse writes the reconstructed row only after its last
// level, so input and output may be the same memory in both directions.
//
// H's staged form (tail1d_inv_staged_kernel), for synthesis bands whose
// span is below 16 and whose sources' taps fit a window of 8 (every
// wavelet of the package with such a span); the first form otherwise, and
// where the host asks for it.  The first form read each level's detail
// band from device memory inside its tap loop, right after a barrier, with
// scalar loads (L round trips to device memory per row, in series), read
// a coefficient and an offset from shared memory per tap, and held two
// rows of the arithmetic type per row.  Here:
// * The packed row (s_L and every d_l, n samples) is staged once, with
//   16-byte cp.async (4-byte copies for rows that are not whole 16-byte
//   words); no level reads device memory.
// * Per level each thread takes V neighbouring output pairs (16 bytes of
//   the arithmetic type) of one row: it reads the s and d windows they
//   need from shared memory into registers (in words where they lie inside
//   the level's length, element by element, wrapped on it, where they
//   wrap) and applies the synthesis bands as windows of W offsets in
//   registers (band_window; W = 4 or 8, the host's choice from the
//   widest source's taps, so that db2 and db4 take 4), one fma per tap,
//   the S band then the D band, taps in table order: the first form's
//   sums.
// * Two scaling buffers, X (half a row) and Y (a quarter), in the
//   arithmetic type: a level writes its outputs straight to one while it
//   reads its scaling band from the other, so one barrier separates the
//   levels and no output waits in registers across one (a first version
//   that merged each level in place held them there: 85 registers a
//   thread, and spills at the 64 that four blocks an SM allow).  The
//   stage and the buffers take 7/8 of the first form's bytes in float32,
//   5/8 in bfloat16.
// * Short rows run several to a block, so that the deep levels keep
//   threads busy; the host takes the rows and threads so that the first
//   level needs at most HS_IPT items per thread (a longer row runs alone,
//   its threads taking several items).  A window that wraps takes one add
//   or subtract per value (a modulo only below 16 pairs).
// * The last level writes the row straight to device memory in 16-byte
//   words.
//
// G's staged form (tail1d_fw_staged_kernel) is H's mirror, for analysis
// bands whose span is below 16 and whose bands each fit a window of 8 or
// 16 samples (W = 4 or 8 output pairs: haar, db2, db4 take 4, cdf97 8;
// the host's choice, ops/tail1d.py fw_window); the first form where the
// span is 16 or more (sym5, db10) and where the host asks for it.  G's
// first form read x with scalar loads, a coefficient and an offset from
// shared memory per tap, wrapped each tap by a select and stored each
// detail as a scalar (4.8x its copy floor on an H100 at (4096, 4096) db4
// L8).  Here:
// * Each block stages its rows whole, once (16-byte cp.async; element by
//   element where x's base, row stride or n is no whole 16-byte word), and
//   waits for them before any store, so x and y may still be the same
//   memory; short rows several to a block, by H's rule (stage_geom), but
//   in blocks of 128 threads, four items each, where that makes GS_WIDE
//   blocks or more (the deep levels are short chains behind barriers:
//   more blocks an SM keep more of them in flight).
// * Per level each thread takes V neighbouring output pairs (16 bytes of
//   the arithmetic type) of one row and reads each band's window (2V - 2
//   plus the band's width samples) from shared memory into registers: in
//   words where it lies inside the level's length, element by element,
//   wrapped by one add or subtract (a modulo below 16 pairs), where not.
//   The bands are register windows (band_window), one fma per tap in
//   table order: the S band ascending, the D band ascending (a lifting
//   scheme) or descending (a filter) in a loop of its own: the first
//   form's sums, so the two forms agree bit for bit.
// * Two scaling buffers, X (half a row) and Y (a quarter, in the row's
//   stage, dead once level 1 has read it), in the arithmetic type: level l
//   reads one and writes the other (X at odd levels, Y at even ones), so
//   one barrier separates the levels and no output waits in registers
//   across one.
// * Each level's details go straight to their packed offset y[n >> l :
//   n >> (l - 1)], a thread's V outputs as one word (16 bytes, 8 in
//   bfloat16) where the offset allows, and s_L to the row's head at the
//   last level; no pass over the row follows the levels.

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace wtt {

constexpr int TAIL1D_THREADS = 256;

// Forward: x (n) -> packed (n), L levels: y[n>>l : n>>(l-1)] = d_l,
// y[: n>>L] = s_L.  Band table: ns scaling taps then nd detail taps.
template <typename T>
__global__ void __launch_bounds__(TAIL1D_THREADS)
tail1d_fw_kernel(const T* __restrict__ x, int64_t xs, T* y, int64_t ys, int n,
                 int L, const int* __restrict__ offs,
                 const typename Acc<T>::type* __restrict__ coefs, int ns, int nd,
                 int dmin, int span) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = ns + nd;
  A* cur = reinterpret_cast<A*>(smem_raw);  // [n]: the active row
  A* nxt = cur + n;                          // [n/2]: the next scaling band
  A* cf = nxt + n;
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x, nth = blockDim.x;
  const T* xb = x + static_cast<int64_t>(blockIdx.x) * xs;
  T* yb = y + static_cast<int64_t>(blockIdx.x) * ys;
  load_bands(cf, of, coefs, offs, nt, tid, nth);
  for (int i = tid; i < n; i += nth) cur[i] = ld(xb[i]);
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const int nl = n >> l, nh = nl / 2;
    for (int k = tid; k < nh; k += nth) {
      const int base = 2 * k;
      const bool inner = base + dmin >= 0 && base + dmin + span < nl;
      A s = 0, d = 0;
      for (int j = 0; j < ns; ++j) {
        const int i = base + of[j];
        s += cf[j] * cur[inner ? i : wrap(i, nl)];
      }
      for (int j = ns; j < nt; ++j) {
        const int i = base + of[j];
        d += cf[j] * cur[inner ? i : wrap(i, nl)];
      }
      nxt[k] = s;
      st(yb + nh + k, d);
    }
    __syncthreads();
    A* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int i = tid; i < (n >> L); i += nth) st(yb + i, cur[i]);
}

// Inverse: packed (n) -> (n), L levels.  Band table: the synthesis bands
// S0, D0, S1, D1 with n0..n3 taps; the details are read from y in place.
template <typename T>
__global__ void __launch_bounds__(TAIL1D_THREADS)
tail1d_inv_kernel(const T* __restrict__ y, int64_t ys, T* out, int64_t os, int n,
                  int L, const int* __restrict__ offs,
                  const typename Acc<T>::type* __restrict__ coefs, int n0, int n1,
                  int n2, int n3, int smin, int span) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = n0 + n1 + n2 + n3;
  const int e0 = n0 + n1, e1 = e0 + n2;
  A* cur = reinterpret_cast<A*>(smem_raw);  // [n]: the scaling band
  A* nxt = cur + n;                          // [n]: the merged band
  A* cf = nxt + n;
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x, nth = blockDim.x;
  const T* yb = y + static_cast<int64_t>(blockIdx.x) * ys;
  T* ob = out + static_cast<int64_t>(blockIdx.x) * os;
  load_bands(cf, of, coefs, offs, nt, tid, nth);
  for (int i = tid; i < (n >> L); i += nth) cur[i] = ld(yb[i]);
  __syncthreads();

  for (int l = L; l >= 1; --l) {
    const int nh = n >> l;
    const T* db = yb + nh;  // d_l, in place
    for (int j = tid; j < 2 * nh; j += nth) {
      const int k = j >> 1, p = j & 1;
      const int ks = p ? e0 : 0, kd = p ? e1 : n0, ke = p ? nt : e0;
      const bool inner = k + smin >= 0 && k + smin + span < nh;
      A v = 0;
      for (int q = ks; q < kd; ++q) {
        const int i = k + of[q];
        v += cf[q] * cur[inner ? i : wrap(i, nh)];
      }
      for (int q = kd; q < ke; ++q) {
        const int i = k + of[q];
        v += cf[q] * ld(db[inner ? i : wrap(i, nh)]);
      }
      nxt[j] = v;
    }
    __syncthreads();
    A* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int i = tid; i < n; i += nth) st(ob + i, cur[i]);
}

// --- kernel H's staged form --------------------------------------------------

constexpr int HS_THREADS = 256;  // threads per block at most
constexpr int HS_IPT = 2;        // items (V pairs) per thread that set the rows a block holds
// G's staged form takes blocks of half as many threads, each of twice the
// items (the same rows to a block), where the launch has at least
// GS_WIDE blocks (the H100's SMs): twice the blocks an SM then keep its
// levels, short chains behind barriers, in flight (on an H100 at (4096,
// 4096) db4 L8: 154 against 180 us)
constexpr int GS_WIDE = 132;

// Geometry of the staged forms (G's and H's alike), filled by the host;
// ops/tail1d.py (fw_plan, inv_plan) mirrors it.  A block holds `rows` rows
// of the input, row r at stg + r ps (storage elements, ps = n rounded up
// to a 16-byte word), and two scaling buffers per row in the arithmetic
// type, pa elements in all: X (xa elements, n/2 rounded up to V) and Y
// (n/4 rounded up to V).  H writes X at its even levels and Y at its odd
// ones; G writes X at its odd levels and Y at its even ones, and keeps Y
// in the row's stage (its pa is xa).
struct StageGeom {
  int B, n, L, rows, ps, pa, xa;
};

template <typename T>
size_t staged_smem(const StageGeom& g, int nt) {
  using A = typename Acc<T>::type;
  return static_cast<size_t>(g.rows) * (static_cast<size_t>(g.ps) * sizeof(T) +
                                        static_cast<size_t>(g.pa) * sizeof(A)) +
         static_cast<size_t>(nt) * (sizeof(A) + sizeof(int));
}

// The staged geometry: as many rows per block as keep the first level
// within ipt items (V pairs) per thread of mt threads (one row where a row
// has more), and no more threads than that level's items ask (into
// *threads).  H takes HS_IPT and HS_THREADS.
template <typename T>
StageGeom stage_geom(int B, int n, int L, int* threads, int mt = HS_THREADS,
                     int ipt = HS_IPT) {
  using A = typename Acc<T>::type;
  constexpr int E = 16 / sizeof(T), V = Vec16<A>::n;
  StageGeom g;
  g.B = B;
  g.n = n;
  g.L = L;
  const int per = (n / 2 + V - 1) / V;  // items of a row at the first level
  g.rows = std::max(1, std::min(B, ipt * mt / per));
  *threads = std::min(mt, (g.rows * per + ipt * 32 - 1) / (ipt * 32) * 32);
  g.ps = (n + E - 1) / E * E;
  g.xa = (n / 2 + V - 1) / V * V;
  g.pa = g.xa + (n / 4 + V - 1) / V * V;
  return g;
}

// Stage the block's rows (from row b0, `rows` of them, row stride xs) at
// stg: one 16-byte word (one element on the other path) per thread and
// step, then the commit; the caller waits and synchronises.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_rows(T* stg, const T* x, int64_t xs, int b0, int rows,
                                           const StageGeom& g) {
  constexpr int E = 16 / sizeof(T);
  const int nw = VEC ? g.n / E : g.n;
  for (int i = threadIdx.x; i < rows * nw; i += blockDim.x) {
    const int r = i / nw, k = i - r * nw;
    const T* row = x + static_cast<int64_t>(b0 + r) * xs;
    if (VEC)
      cp_async16(stg + r * g.ps + k * E, row + k * E);
    else
      stg[r * g.ps + k] = row[k];
  }
  cp_async_commit();
}

// v[j] = src[(a + j) mod nh] for j < cnt: words of `gran` bytes where the
// window lies inside [0, nh), else element by element, wrapped by one
// add or subtract where nh >= near (the caller's bound: the window then
// reaches less than nh past either end) and with the modulo below that.
template <int N, typename S, typename A>
__device__ __forceinline__ void load_level(A (&v)[N], const S* src, int a, int cnt, int nh,
                                           int gran, int near = 16) {
  if (a >= 0 && a + cnt <= nh) {
    load_window(v, src + a, cnt, gran);
  } else if (nh >= near) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = a + j;
      if (j < cnt) v[j] = ld(src[i < 0 ? i + nh : i >= nh ? i - nh : i]);
    }
  } else {
    // below `near` the window may wrap several times: wrap each index by
    // repeated adds or subtracts (a few at most), not by a division
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < cnt) {
        int i = a + j;
        while (i < 0) i += nh;
        while (i >= nh) i -= nh;
        v[j] = ld(src[i]);
      }
  }
}

// The synthesis bands as windows in registers: parity p's S band over
// offsets ls + w (cs[p], mask ms[p]; ws offsets hold both parities' taps)
// and its D band over lt + w (cd[p], md[p]; wt offsets).
template <typename A, int W>
struct SynWindows {
  A cs[2][W], cd[2][W];
  unsigned ms[2], md[2];
  int ls, ws, lt, wt;
};

// 2V outputs (V pairs from k0) of one level from the scaling band s and
// the detail band d, each nh long.
template <int W, int V, typename A, typename S, typename T>
__device__ __forceinline__ void syn_pairs(A (&o)[2 * V], const S* s, const T* d, int nh,
                                          int k0, const SynWindows<A, W>& b, int gs,
                                          int gd) {
  A sv[V + W - 1], dv[V + W - 1];
  load_level(sv, s, k0 + b.ls, V - 1 + b.ws, nh, gs);
  load_level(dv, d, k0 + b.lt, V - 1 + b.wt, nh, gd);
#pragma unroll
  for (int e = 0; e < 2 * V; ++e) o[e] = A(0);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (w >= b.ws) break;
#pragma unroll
    for (int e = 0; e < V; ++e)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        if ((b.ms[p] >> w) & 1) o[2 * e + p] = fma(b.cs[p][w], sv[e + w], o[2 * e + p]);
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (w >= b.wt) break;
#pragma unroll
    for (int e = 0; e < V; ++e)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        if ((b.md[p] >> w) & 1) o[2 * e + p] = fma(b.cd[p][w], dv[e + w], o[2 * e + p]);
  }
}

template <typename T, int W, bool VEC>
__global__ void __launch_bounds__(HS_THREADS, 4)
tail1d_inv_staged_kernel(const T* y, int64_t ys, T* out, int64_t os, bool vout,
                         StageGeom g, const int* __restrict__ offs,
                         const typename Acc<T>::type* __restrict__ coefs, int n0, int n1,
                         int n2, int n3) {
  using A = typename Acc<T>::type;
  constexpr int V = Vec16<A>::n;     // pairs per item
  using AV = typename Vec16<A>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stg = reinterpret_cast<T*>(smem_raw);                 // [rows][ps] the packed rows
  A* sc = reinterpret_cast<A*>(stg + g.rows * g.ps);       // [rows][pa] X | Y
  const int nt = n0 + n1 + n2 + n3, e0 = n0 + n1, e1 = e0 + n2;
  A* cf = sc + g.rows * g.pa;
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int b0 = blockIdx.x * g.rows, rows = min(g.rows, g.B - b0);

  stage_rows<T, VEC>(stg, y, ys, b0, rows, g);
  load_bands(cf, of, coefs, offs, nt, tid, nth);
  cp_async_wait<0>();
  __syncthreads();
  SynWindows<A, W> b;
  int hs = -(1 << 30), ht = -(1 << 30);
  b.ls = b.lt = 1 << 30;
  for (int k = 0; k < nt; ++k) {
    if (k < n0 || (k >= e0 && k < e1)) {
      b.ls = min(b.ls, of[k]);
      hs = max(hs, of[k]);
    } else {
      b.lt = min(b.lt, of[k]);
      ht = max(ht, of[k]);
    }
  }
  b.ws = hs - b.ls + 1;
  b.wt = ht - b.lt + 1;
  if (b.ws > W || b.wt > W) __trap();  // the host's window does not hold the bands
  b.ms[0] = band_window(b.cs[0], cf, of, 0, n0, b.ls);
  b.md[0] = band_window(b.cd[0], cf, of, n0, e0, b.lt);
  b.ms[1] = band_window(b.cs[1], cf, of, e0, e1, b.ls);
  b.md[1] = band_window(b.cd[1], cf, of, e1, nt, b.lt);

  // level l reads its s band from the stage (l = L) or from level l + 1's
  // buffer, its d band from the stage, and writes to X (l even) or Y (l
  // odd), or to the output (l = 1); one barrier separates the levels
  for (int l = g.L; l >= 1; --l) {
    const int nh = g.n >> l;
    const int src = (l + 1) & 1 ? g.xa : 0, dst = l & 1 ? g.xa : 0;
    // the window word sizes: the level's first band is read from the
    // stage, the others from a buffer
    const int gs = l == g.L ? window_gran(static_cast<long long>(b.ls) * sizeof(T),
                                          V * static_cast<long long>(sizeof(T)), sizeof(T))
                            : window_gran(static_cast<long long>(b.ls) * sizeof(A),
                                          V * static_cast<long long>(sizeof(A)), sizeof(A));
    const int gd = window_gran(static_cast<long long>(nh + b.lt) * sizeof(T),
                               V * static_cast<long long>(sizeof(T)), sizeof(T));
    const int per = (nh + V - 1) / V;
    for (int u = tid; u < rows * per; u += nth) {
      const int r = u / per, k0 = (u - r * per) * V;
      const T* d = stg + r * g.ps + nh;
      __align__(16) A o[2 * V];
      if (l == g.L)
        syn_pairs<W, V>(o, stg + r * g.ps, d, nh, k0, b, gs, gd);
      else
        syn_pairs<W, V>(o, sc + r * g.pa + src, d, nh, k0, b, gs, gd);
      if (l > 1) {
        A* p = sc + r * g.pa + dst + 2 * k0;
        if (k0 + V <= nh) {
          *reinterpret_cast<AV*>(p) = *reinterpret_cast<const AV*>(o);
          *reinterpret_cast<AV*>(p + V) = *reinterpret_cast<const AV*>(o + V);
        } else {
#pragma unroll
          for (int e = 0; e < 2 * V; ++e)
            if (e < 2 * (nh - k0)) p[e] = o[e];
        }
      } else {
        T* p = out + static_cast<int64_t>(b0 + r) * os + 2 * k0;
        if (vout && k0 + V <= nh) {
          __align__(16) T w[2 * V];
#pragma unroll
          for (int e = 0; e < 2 * V; ++e) st(w + e, o[e]);
#pragma unroll
          for (int q = 0; q < 2 * V * static_cast<int>(sizeof(T)) / 16; ++q)
            reinterpret_cast<uint4*>(p)[q] = reinterpret_cast<const uint4*>(w)[q];
        } else {
#pragma unroll
          for (int e = 0; e < 2 * V; ++e)
            if (e < 2 * (nh - k0)) st(p + e, o[e]);
        }
      }
    }
    __syncthreads();  // this level's outputs written; its inputs read
  }
}

template <typename T, int W, bool VEC>
int tail1d_inv_staged_launch(const StageGeom& g, int threads, const T* y, int64_t ys,
                             T* out, int64_t os, bool vout, const int* offs,
                             const void* coefs, const int* nb, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int nt = nb[0] + nb[1] + nb[2] + nb[3];
  return launch(tail1d_inv_staged_kernel<T, W, VEC>, dim3((g.B + g.rows - 1) / g.rows),
                dim3(threads), staged_smem<T>(g, nt), stream, y, ys, out, os, vout, g,
                offs, static_cast<const A*>(coefs), nb[0], nb[1], nb[2], nb[3]);
}

// H's staged form (geometry: stage_geom), the 16-byte path where y's
// base and row stride and n are whole 16-byte words.  W: the window the
// host picked (ops/tail1d.py, inv_window), 4 or 8 offsets, which holds
// each source's taps.
template <typename T>
int tail1d_inv_staged(int B, int n, int L, const void* y, int64_t ys, void* out,
                      int64_t os, const int* offs, const void* coefs, const int* nb,
                      int window, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  int threads = 0;
  const StageGeom g = stage_geom<T>(B, n, L, &threads);
  const bool vec = n % E == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 && ys % E == 0;
  const bool vout = reinterpret_cast<uintptr_t>(out) % 16 == 0 && os % E == 0;
  auto yp = static_cast<const T*>(y);
  auto op = static_cast<T*>(out);
  switch (window * 2 + vec) {
    case 9: return tail1d_inv_staged_launch<T, 4, true>(g, threads, yp, ys, op, os, vout, offs, coefs, nb, stream);
    case 8: return tail1d_inv_staged_launch<T, 4, false>(g, threads, yp, ys, op, os, vout, offs, coefs, nb, stream);
    case 17: return tail1d_inv_staged_launch<T, 8, true>(g, threads, yp, ys, op, os, vout, offs, coefs, nb, stream);
    case 16: return tail1d_inv_staged_launch<T, 8, false>(g, threads, yp, ys, op, os, vout, offs, coefs, nb, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// --- kernel G's staged form --------------------------------------------------

// The analysis bands as windows in registers: the S band over the sample
// offsets ls + w (cs, mask ms; ws offsets), the D band over lt + w (cd;
// wt offsets), each at most 2W samples (W output pairs) wide.  Each sum
// takes its taps in table order: ops/bands.py lists the S band ascending
// and the D band ascending (a lifting scheme) or descending (a filter),
// so the D band's mask goes to the ascending (mda) or the descending
// (mdd) loop, as in kernel E.
template <typename A, int W>
struct AnaWindows {
  A cs[2 * W], cd[2 * W];
  unsigned ms, mda, mdd;
  int ls, ws, lt, wt;
};

// V output pairs (from pair k0) of one level of the nl samples at st (the
// stage in the storage type, level 1 where it is not the arithmetic
// type) or else at bu: sv the scaling outputs, dv the details.  Only the
// window loads depend on the source, so the taps' code is one copy (on an
// H100, two copies took bfloat16 from 110 to 163 us at (4096, 4096) db4
// L8).  Each band's
// window (2V - 2 + its width samples) is read once into registers, in
// words of gs / gd bytes where it lies inside the level, wrapped element
// by element where it does not (one add or subtract from 16 pairs up, as
// every offset lies within 16 of the pair).
template <int W, int V, typename A, typename T>
__device__ __forceinline__ void ana_pairs(A (&sv)[V], A (&dv)[V], const T* st, const A* bu,
                                          int nl, int k0, const AnaWindows<A, W>& b, int gs,
                                          int gd) {
  constexpr int NX = 2 * V + 2 * W - 2;
#pragma unroll
  for (int e = 0; e < V; ++e) sv[e] = dv[e] = A(0);
  A xv[NX];
  const auto window = [&](int a, int cnt, int gran) {
    if constexpr (std::is_same<T, A>::value)
      load_level(xv, bu, a, cnt, nl, gran, 32);
    else if (st)
      load_level(xv, st, a, cnt, nl, gran, 32);
    else
      load_level(xv, bu, a, cnt, nl, gran, 32);
  };
  window(2 * k0 + b.ls, 2 * V - 2 + b.ws, gs);
#pragma unroll
  for (int w = 0; w < 2 * W; ++w) {
    if (w >= b.ws) break;
#pragma unroll
    for (int e = 0; e < V; ++e)
      if ((b.ms >> w) & 1) sv[e] = fma(b.cs[w], xv[2 * e + w], sv[e]);
  }
  window(2 * k0 + b.lt, 2 * V - 2 + b.wt, gd);
#pragma unroll
  for (int w = 0; w < 2 * W; ++w) {
    if (w >= b.wt) break;
#pragma unroll
    for (int e = 0; e < V; ++e)
      if ((b.mda >> w) & 1) dv[e] = fma(b.cd[w], xv[2 * e + w], dv[e]);
  }
  if (b.mdd) {
#pragma unroll
    for (int w = 2 * W - 1; w >= 0; --w) {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if ((b.mdd >> w) & 1) dv[e] = fma(b.cd[w], xv[2 * e + w], dv[e]);
    }
  }
}

// cnt (<= V) outputs o to p in the storage type: one word of V elements
// where `vec` (p aligned to the word) and the item is whole.
template <int V, typename T, typename A>
__device__ __forceinline__ void store_pairs(T* p, const A (&o)[V], int cnt, bool vec) {
  using TW = typename Word<V * sizeof(T)>::type;
  if (vec && cnt >= V) {
    __align__(16) T w[V];
#pragma unroll
    for (int e = 0; e < V; ++e) st(w + e, o[e]);
    *reinterpret_cast<TW*>(p) = *reinterpret_cast<const TW*>(w);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (e < cnt) st(p + e, o[e]);
  }
}

// Kernel G's staged form, the mirror of H's: each block stages its rows
// whole, once, and waits for them before any store, so x and y may be the
// same memory; level l (1 .. L) reads its row from the stage (l = 1) or
// from the buffer level l - 1 wrote, and writes its scaling band to X (l
// odd) or Y (l even) -- s_L straight to the row's head -- and its details
// straight to their packed offset y[n >> l : n >> (l - 1)]; one barrier
// separates the levels.  Y (n/4 of the arithmetic type) lives in the
// row's stage, which no level reads after the first: a row takes n
// storage elements and n/2 of the arithmetic type.  vout: y's base and
// row stride allow words of V elements.
template <typename T, int W, bool VEC>
__global__ void __launch_bounds__(HS_THREADS, W == 4 ? 4 : 2)
tail1d_fw_staged_kernel(const T* x, int64_t xs, T* y, int64_t ys, bool vout, StageGeom g,
                        const int* __restrict__ offs,
                        const typename Acc<T>::type* __restrict__ coefs, int ns, int nd) {
  using A = typename Acc<T>::type;
  constexpr int V = Vec16<A>::n;     // pairs per item
  using AV = typename Vec16<A>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stg = reinterpret_cast<T*>(smem_raw);                 // [rows][ps] the input rows
  A* sc = reinterpret_cast<A*>(stg + g.rows * g.ps);       // [rows][pa] X | Y
  const int nt = ns + nd;
  A* cf = sc + g.rows * g.pa;
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int b0 = blockIdx.x * g.rows, rows = min(g.rows, g.B - b0);

  stage_rows<T, VEC>(stg, x, xs, b0, rows, g);
  load_bands(cf, of, coefs, offs, nt, tid, nth);
  cp_async_wait<0>();
  __syncthreads();  // the rows staged: from here on y may be written
  AnaWindows<A, W> b;
  int hs = -(1 << 30), ht = -(1 << 30);
  b.ls = b.lt = 1 << 30;
  for (int k = 0; k < nt; ++k) {
    if (k < ns) {
      b.ls = min(b.ls, of[k]);
      hs = max(hs, of[k]);
    } else {
      b.lt = min(b.lt, of[k]);
      ht = max(ht, of[k]);
    }
  }
  b.ws = hs - b.ls + 1;
  b.wt = ht - b.lt + 1;
  // the host's window holds the bands, every offset within 16 of the pair
  if (b.ws > 2 * W || b.wt > 2 * W || min(b.ls, b.lt) < -16 || max(hs, ht) > 16) __trap();
  b.ms = band_window(b.cs, cf, of, 0, ns, b.ls);
  const unsigned md = band_window(b.cd, cf, of, ns, nt, b.lt);
  const bool drev = nd > 1 && of[ns + 1] < of[ns];
  b.mda = drev ? 0u : md;
  b.mdd = drev ? md : 0u;

  for (int l = 1; l <= g.L; ++l) {
    const int nl = g.n >> (l - 1), nh = nl >> 1;
    // the window word sizes: level 1 reads the stage, the others a buffer;
    // bfloat16 windows in 4-byte words where they start on one
    const long long es = l == 1 ? sizeof(T) : sizeof(A);
    int gs = window_gran(b.ls * es, 2 * V * es, static_cast<int>(es));
    int gd = window_gran(b.lt * es, 2 * V * es, static_cast<int>(es));
    if (es == 2 && gs == 2 && b.ls % 2 == 0) gs = 4;
    if (es == 2 && gd == 2 && b.lt % 2 == 0) gd = 4;
    const bool vd = vout && nh % V == 0;
    const int per = (nh + V - 1) / V;
    for (int u = tid; u < rows * per; u += nth) {
      const int r = u / per, k0 = (u - r * per) * V;
      A sv[V], dv[V];
      A* const xb = sc + r * g.pa;                          // X
      A* const yb = reinterpret_cast<A*>(stg + r * g.ps);   // Y: the stage's space
      // one copy of the taps' code: level 1 reads the stage (for float32
      // and float64, Y's space), the others X or Y
      ana_pairs<W, V>(sv, dv, l == 1 ? stg + r * g.ps : nullptr, l % 2 == 0 ? xb : yb, nl,
                      k0, b, gs, gd);
      T* yr = y + static_cast<int64_t>(b0 + r) * ys;
      const int cnt = min(V, nh - k0);
      store_pairs<V>(yr + nh + k0, dv, cnt, vd);
      if (l == g.L) {
        store_pairs<V>(yr + k0, sv, cnt, vout);
      } else {
        A* p = (l & 1 ? xb : yb) + k0;
        if (cnt == V) {
          *reinterpret_cast<AV*>(p) = *reinterpret_cast<const AV*>(sv);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (e < cnt) p[e] = sv[e];
        }
      }
    }
    __syncthreads();  // this level's outputs written; its inputs read
  }
}

template <typename T, int W, bool VEC>
int tail1d_fw_staged_launch(const StageGeom& g, int threads, const T* x, int64_t xs, T* y,
                            int64_t ys, bool vout, const int* offs, const void* coefs,
                            int ns, int nd, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  return launch(tail1d_fw_staged_kernel<T, W, VEC>, dim3((g.B + g.rows - 1) / g.rows),
                dim3(threads), staged_smem<T>(g, ns + nd), stream, x, xs, y, ys, vout, g,
                offs, static_cast<const A*>(coefs), ns, nd);
}

// G's staged form (geometry: stage_geom, blocks of 128 threads from GS_WIDE
// blocks up), the 16-byte path where x's base
// and row stride and n are whole 16-byte words; details and s_L in words
// of V elements where y's base and row stride allow.  W: the window the
// host picked (ops/tail1d.py, fw_window), 4 or 8 output pairs (8 or 16
// samples), which holds each band.
template <typename T>
int tail1d_fw_staged(int B, int n, int L, const void* x, int64_t xs, void* y, int64_t ys,
                     const int* offs, const void* coefs, int ns, int nd, int window,
                     cudaStream_t stream) {
  using A = typename Acc<T>::type;
  constexpr int E = 16 / sizeof(T), V = Vec16<A>::n;
  int threads = 0;
  StageGeom g = stage_geom<T>(B, n, L, &threads, HS_THREADS / 2, 2 * HS_IPT);
  if ((g.B + g.rows - 1) / g.rows < GS_WIDE) g = stage_geom<T>(B, n, L, &threads);
  g.pa = g.xa;  // X alone: Y takes the stage's space once level 1 has read it
  const bool vec = n % E == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && xs % E == 0;
  const bool vout = reinterpret_cast<uintptr_t>(y) % (V * sizeof(T)) == 0 && ys % V == 0;
  auto xp = static_cast<const T*>(x);
  auto yp = static_cast<T*>(y);
  switch (window * 2 + vec) {
    case 9: return tail1d_fw_staged_launch<T, 4, true>(g, threads, xp, xs, yp, ys, vout, offs, coefs, ns, nd, stream);
    case 8: return tail1d_fw_staged_launch<T, 4, false>(g, threads, xp, xs, yp, ys, vout, offs, coefs, ns, nd, stream);
    case 17: return tail1d_fw_staged_launch<T, 8, true>(g, threads, xp, xs, yp, ys, vout, offs, coefs, ns, nd, stream);
    case 16: return tail1d_fw_staged_launch<T, 8, false>(g, threads, xp, xs, yp, ys, vout, offs, coefs, ns, nd, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename A>
size_t tail1d_smem(int n, int nt) {
  return 2 * static_cast<size_t>(n) * sizeof(A) +
         static_cast<size_t>(nt) * (sizeof(A) + sizeof(int));
}

// Threads per block: a warp at least, one per output pair of the first
// level at most.
inline int tail1d_threads(int n) {
  int t = ((n / 2 + 31) / 32) * 32;
  return t < 32 ? 32 : (t > TAIL1D_THREADS ? TAIL1D_THREADS : t);
}

template <typename T>
int tail1d_fw(int B, int n, int L, const void* x, int64_t xs, void* y,
              int64_t ys, const int* offs, const void* coefs, int ns, int nd,
              int dmin, int span, int window, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  if (window && span < 16)
    return tail1d_fw_staged<T>(B, n, L, x, xs, y, ys, offs, coefs, ns, nd, window, stream);
  return launch(tail1d_fw_kernel<T>, dim3(B), dim3(tail1d_threads(n)),
                tail1d_smem<A>(n, ns + nd), stream, static_cast<const T*>(x), xs,
                static_cast<T*>(y), ys, n, L, offs, static_cast<const A*>(coefs),
                ns, nd, dmin, span);
}

template <typename T>
int tail1d_inv(int B, int n, int L, const void* y, int64_t ys, void* out,
               int64_t os, const int* offs, const void* coefs, const int* nb,
               int smin, int span, int window, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  if (window && span < 16)
    return tail1d_inv_staged<T>(B, n, L, y, ys, out, os, offs, coefs, nb, window, stream);
  return launch(tail1d_inv_kernel<T>, dim3(B), dim3(tail1d_threads(n)),
                tail1d_smem<A>(n, nb[0] + nb[1] + nb[2] + nb[3]), stream,
                static_cast<const T*>(y), ys, static_cast<T*>(out), os, n, L,
                offs, static_cast<const A*>(coefs), nb[0], nb[1], nb[2], nb[3],
                smin, span);
}

}  // namespace wtt

extern "C" {

// Forward tail: x (B, n) with row stride xs -> packed rows y (B, n) with
// row stride ys, L levels.  Band table and dmin / span as for the level.
// window: the staged form's window (4 or 8 output pairs, ops/tail1d.py
// fw_window), which runs where the span is below 16; else, and where
// window is 0, the first form.
int wtt_tail1d_fw(int dtype, int B, int n, int L, const void* x, int64_t xs,
                  void* y, int64_t ys, const int* offs, const void* coefs, int ns,
                  int nd, int dmin, int span, int window, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::tail1d_fw<float>(B, n, L, x, xs, y, ys, offs, coefs, ns, nd, dmin, span, window, s);
    case wtt::F64:
      return wtt::tail1d_fw<double>(B, n, L, x, xs, y, ys, offs, coefs, ns, nd, dmin, span, window, s);
    case wtt::BF16:
      return wtt::tail1d_fw<__nv_bfloat16>(B, n, L, x, xs, y, ys, offs, coefs, ns, nd, dmin, span, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Inverse tail: packed rows y (B, n) -> out (B, n), L levels.  nb: the tap
// counts of the synthesis bands S0, D0, S1, D1.  window: the staged
// form's window (4 or 8 offsets, ops/tail1d.py inv_window), which runs
// where the span is below 16 and a block holds the row's first level;
// else, and where window is 0, the first form.
int wtt_tail1d_inv(int dtype, int B, int n, int L, const void* y, int64_t ys,
                   void* out, int64_t os, const int* offs, const void* coefs,
                   const int* nb, int smin, int span, int window, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::tail1d_inv<float>(B, n, L, y, ys, out, os, offs, coefs, nb, smin, span, window, s);
    case wtt::F64:
      return wtt::tail1d_inv<double>(B, n, L, y, ys, out, os, offs, coefs, nb, smin, span, window, s);
    case wtt::BF16:
      return wtt::tail1d_inv<__nv_bfloat16>(B, n, L, y, ys, out, os, offs, coefs, nb, smin, span, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
