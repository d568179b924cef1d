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
// Design of G and of H's first form: one block per row.  Per level, each
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

#include <algorithm>

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

// Geometry of the staged form, filled by the host; ops/tail1d.py
// (inv_plan) mirrors it.  A block holds `rows` rows of the packed input,
// row r at stg + r ps (storage elements, ps = n rounded up to a 16-byte
// word), and two scaling buffers per row in the arithmetic type, pa
// elements in all: X (xa elements, n/2 rounded up to V) for the outputs of
// the even levels, Y (n/4 rounded up to V) for the odd ones.
struct InvStageGeom {
  int B, n, L, rows, ps, pa, xa;
};

template <typename T>
size_t inv_staged_smem(const InvStageGeom& g, int nt) {
  using A = typename Acc<T>::type;
  return static_cast<size_t>(g.rows) * (static_cast<size_t>(g.ps) * sizeof(T) +
                                        static_cast<size_t>(g.pa) * sizeof(A)) +
         static_cast<size_t>(nt) * (sizeof(A) + sizeof(int));
}

// v[j] = src[(a + j) mod nh] for j < cnt: words of `gran` bytes where the
// window lies inside [0, nh), else element by element, wrapped by one
// add or subtract where nh >= 16 (the window reaches less than 16 past
// either end) and with the modulo below that.
template <int N, typename S, typename A>
__device__ __forceinline__ void load_level(A (&v)[N], const S* src, int a, int cnt, int nh,
                                           int gran) {
  if (a >= 0 && a + cnt <= nh) {
    load_window(v, src + a, cnt, gran);
  } else if (nh >= 16) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = a + j;
      if (j < cnt) v[j] = ld(src[i < 0 ? i + nh : i >= nh ? i - nh : i]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < cnt) v[j] = ld(src[wrap(a + j, nh)]);
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
                         InvStageGeom g, const int* __restrict__ offs,
                         const typename Acc<T>::type* __restrict__ coefs, int n0, int n1,
                         int n2, int n3) {
  using A = typename Acc<T>::type;
  constexpr int E = 16 / sizeof(T);  // storage elements per 16-byte word
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

  // stage the block's rows: one 16-byte word (one element on the 4-byte
  // path) per thread and step
  const int nw = VEC ? g.n / E : g.n;
  for (int i = tid; i < rows * nw; i += nth) {
    const int r = i / nw, k = i - r * nw;
    const T* row = y + static_cast<int64_t>(b0 + r) * ys;
    if (VEC)
      cp_async16(stg + r * g.ps + k * E, row + k * E);
    else
      stg[r * g.ps + k] = row[k];
  }
  cp_async_commit();
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
int tail1d_inv_staged_launch(const InvStageGeom& g, int threads, const T* y, int64_t ys,
                             T* out, int64_t os, bool vout, const int* offs,
                             const void* coefs, const int* nb, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int nt = nb[0] + nb[1] + nb[2] + nb[3];
  return launch(tail1d_inv_staged_kernel<T, W, VEC>, dim3((g.B + g.rows - 1) / g.rows),
                dim3(threads), inv_staged_smem<T>(g, nt), stream, y, ys, out, os, vout, g,
                offs, static_cast<const A*>(coefs), nb[0], nb[1], nb[2], nb[3]);
}

// The staged form's geometry (see InvStageGeom): as many rows per block as
// keep the first level within HS_IPT items per thread of HS_THREADS
// threads (one row where a row has more), and no more threads than that
// level's items ask; the 16-byte path where y's base and row stride and n
// are whole 16-byte words.  W:
// the window the host picked (ops/tail1d.py, inv_window), 4 or 8
// offsets, which holds each source's taps.
template <typename T>
int tail1d_inv_staged(int B, int n, int L, const void* y, int64_t ys, void* out,
                      int64_t os, const int* offs, const void* coefs, const int* nb,
                      int window, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  constexpr int E = 16 / sizeof(T), V = Vec16<A>::n;
  InvStageGeom g;
  g.B = B;
  g.n = n;
  g.L = L;
  const int per = (n / 2 + V - 1) / V;  // items of a row at the first level
  g.rows = std::max(1, std::min(B, HS_IPT * HS_THREADS / per));
  const int threads =
      std::min(HS_THREADS, (g.rows * per + HS_IPT * 32 - 1) / (HS_IPT * 32) * 32);
  g.ps = (n + E - 1) / E * E;
  g.xa = (n / 2 + V - 1) / V * V;
  g.pa = g.xa + (n / 4 + V - 1) / V * V;
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
              int dmin, int span, cudaStream_t stream) {
  using A = typename Acc<T>::type;
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
int wtt_tail1d_fw(int dtype, int B, int n, int L, const void* x, int64_t xs,
                  void* y, int64_t ys, const int* offs, const void* coefs, int ns,
                  int nd, int dmin, int span, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::tail1d_fw<float>(B, n, L, x, xs, y, ys, offs, coefs, ns, nd, dmin, span, s);
    case wtt::F64:
      return wtt::tail1d_fw<double>(B, n, L, x, xs, y, ys, offs, coefs, ns, nd, dmin, span, s);
    case wtt::BF16:
      return wtt::tail1d_fw<__nv_bfloat16>(B, n, L, x, xs, y, ys, offs, coefs, ns, nd, dmin, span, s);
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
