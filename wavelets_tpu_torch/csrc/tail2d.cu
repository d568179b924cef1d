// All remaining levels of a small periodic 2-D DWT in one launch, forward
// (kernel C) and inverse (kernel D), driven by the float64 bands of
// ops/bands.py.
//
// Replaces: wavelets_tpu/ops/pallas/tail2d.py, _fw_kernel (tail_fw) and
// _inv_kernel (tail_inv).
//
// Bound on the H100: latency and instruction issue, not memory.  At the
// end of a deep pyramid the active array is tiny (128^2 after seven levels
// of a 16384^2 image): one level is about 262 K multiply-adds (cdf97) on
// 64 KB, so the bytes bound is tens of nanoseconds and the time goes to
// the launch, the barriers between the passes and levels, and the issue
// of the tap loops.  The whole array stays in shared memory, in the
// arithmetic type, for all its levels; the size limit is what one block
// could hold (128 x 128 in f32 and bf16, 64 x 128 in f64: ops/tail2d.py,
// tail_fits), whatever the cluster.
//
// Design (ops/tail2d.py, tail_plan, picks the parameters):
// * A thread-block cluster of P blocks per image (up to 8, 16 for a batch
//   of up to three; P = 1 once the batch alone fills the card).  Block p of the cluster owns a band of rows of
//   each level: forward, the level's output rows [p R, (p + 1) R) and the
//   2R input rows above them; inverse, the half-rows [p R, (p + 1) R) of
//   the level's four quadrants and the 2R merged rows they give.  The row
//   pass is local, and writes its edge rows a second time straight into
//   the neighbours' shared memory (distributed shared memory) as the halo
//   rows that their column pass reads, wrapped periodically; the column
//   pass is local.  A level's LL rows stay in the block that computed
//   them, as its rows of the next level.  Levels with fewer than MIN_ROWS
//   rows per block run on rank 0 alone: forward, every block writes its
//   last LL rows straight into rank 0's shared memory and leaves; inverse,
//   rank 0 runs the deep levels first and writes each block's LL rows into
//   that block.
// * No wrap in the tap loops.  Each row of the row pass's input carries a
//   periodic halo of columns, and each band of the column pass's input a
//   halo of rows, filled with a true modulo when they are written, so the
//   aliasing of levels smaller than the band's reach (2 x 2, 4 x 8) stays
//   exact.  The forward keeps its rows as even and odd column planes, so
//   the stride-2 reads of the row pass hit consecutive words.
// * The band table in registers: the coefficients once per launch and the
//   offsets, turned into addresses, once per pass, unrolled up to a
//   compile-time tap count K (16 or 32); a larger table takes the
//   one-block kernels with wrapped taps below (the generic route).
// * The column pass computes V neighbouring columns per thread (4 in f32
//   and bf16, 2 in f64) from one 16-byte load per tap.
// * Each sum takes its taps in table order with one accumulator, row pass
//   then column pass, as kernels A and B do (csrc/level2d.cu), so C equals
//   a chain of A launches bit for bit in f32 and f64 (and bf16 at one
//   level: C keeps the LL between levels in the arithmetic type), and D a
//   chain of B launches.
// * Barriers: per level shared by the cluster, one cluster barrier after
//   the row pass (the halo rows have arrived) and one block barrier after
//   the column pass; the row pass's output alternates between two buffers,
//   so a block that runs ahead writes the next level's halo rows into the
//   buffer that its neighbours no longer read.  Every block reads all its
//   input before level 1's cluster barrier and stores only after it, so
//   the output may be the input (the forward runs in place on the split
//   route).  A block leaves only after the last barrier at which another
//   may still touch its shared memory.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace wtt {

// Geometry of the cluster kernels; ops/tail2d.py (_elems) mirrors the
// shared-memory sizes.  Levels 1 .. split run on P blocks, the rest on
// rank 0.  rows(l): output rows (forward) or half-rows (inverse) of level
// l per block; part(l): a row of one column plane (forward) or quadrant
// (inverse) with its hl + hr halo columns; pitch(l): a row of the column
// pass's input, rounded up to V; hu / hd: its halo rows.
struct TailGeom {
  int m, n, L, P, split, hl, hr, hu, hd, vec, lp;  // vec, P = 2^lp: powers of two
  __host__ __device__ int blocks(int l) const { return l <= split ? P : 1; }
  __host__ __device__ int rows(int l) const { return (m >> l) >> (l <= split ? lp : 0); }
  __host__ __device__ int up(int v) const { return (v + vec - 1) & -vec; }
  __host__ __device__ int part(int l) const { return hl + (n >> l) + hr; }
  __host__ __device__ int pitch(int l) const { return up(2 * (n >> l)); }
  // forward: the active rows (two planes), then the row pass's output
  __host__ __device__ int fw_act() const {
    int a = 0;
    for (int l = 1; l <= L; ++l) a = max(a, 4 * rows(l) * part(l));
    return up(a);
  }
  __host__ __device__ int fw_tmp() const {
    int t = 0;
    for (int l = 1; l <= L; ++l) t = max(t, (hu + 2 * rows(l) + hd) * pitch(l));
    return t;
  }
  // inverse: one section per level (LL, LH, HL, HH quadrant rows), then the
  // row pass's output (two halves)
  __host__ __device__ int inv_sec(int l) const {
    int s = 0;
    for (int k = 1; k < l; ++k) s += up(4 * rows(k) * part(k));
    return s;
  }
  __host__ __device__ int inv_half(int l) const { return (hu + rows(l) + hd) * pitch(l); }
  __host__ __device__ int inv_tmp() const {
    int t = 0;
    for (int l = 1; l <= L; ++l) t = max(t, 2 * inv_half(l));
    return t;
  }
  // the row pass's output alternates between two buffers from level to
  // level when blocks share a level, so that a block may write its
  // neighbours' halo rows of the next level while they still read this
  // level's
  __host__ __device__ int bufs() const { return P > 1 ? 2 : 1; }
  __host__ __device__ int elems(bool inverse) const {
    return inverse ? inv_sec(L + 1) + bufs() * inv_tmp() : fw_act() + bufs() * fw_tmp();
  }
};

namespace {

// A flat walk over a (rows, cols) index space, blockDim.x threads apart,
// that steps its (row, col) pair without a division per step; consecutive
// threads take consecutive columns.
struct Steps {
  int r, c, dr, dc, cols;
  __device__ __forceinline__ Steps(int cols_) : cols(cols_) {
    r = threadIdx.x / cols;
    c = threadIdx.x - r * cols;
    dr = blockDim.x / cols;
    dc = blockDim.x - dr * cols;
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

// Read `rows` rows of `cols` elements (row r at src(r)) U elements per
// thread at a time, so that U loads are in flight together, and hand each
// value to f(row, col, value).
template <int U, typename A, typename S, typename F>
__device__ __forceinline__ void read_rows(int rows, int cols, S src, F f) {
  Steps it(cols);
  while (it.r < rows) {
    A v[U];
    int rr[U], cc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      rr[u] = it.r;
      cc[u] = it.c;
      if (it.r < rows) v[u] = ld(src(it.r)[it.c]);
      it.next();
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (rr[u] < rows) f(rr[u], cc[u], v[u]);
  }
}

// read_rows with 16-byte loads (E storage elements each), for rows that
// all start 16-byte aligned and hold a whole number of them (vec16).
template <typename T>
__device__ __forceinline__ bool vec16(const T* base, int64_t sr, int cols) {
  constexpr int E = 16 / sizeof(T);
  return (reinterpret_cast<uintptr_t>(base) & 15) == 0 && sr % E == 0 && cols % E == 0;
}

template <int U, typename A, typename T, typename S, typename F>
__device__ __forceinline__ void read_rows16(int rows, int cols, S src, F f) {
  constexpr int E = 16 / sizeof(T);
  Steps it(cols / E);
  while (it.r < rows) {
    uint4 raw[U];
    int rr[U], cc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      rr[u] = it.r;
      cc[u] = it.c * E;
      if (it.r < rows) raw[u] = *reinterpret_cast<const uint4*>(src(it.r) + it.c * E);
      it.next();
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (rr[u] < rows) {
        const T* t = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int e = 0; e < E; ++e) f(rr[u], cc[u] + e, static_cast<A>(ld(t[e])));
      }
  }
}

// Store v at column c of a periodic row of width w whose storage starts hl
// halo columns before column 0 and ends hr after column w - 1: at every
// column congruent to c mod w (one or two for w above the halos, more
// when the level is smaller than the band's reach).
template <typename A>
__device__ __forceinline__ void put(A* row, int c, A v, int w, int hl, int hr) {
  if (w >= hl && w >= hr) {  // at most one copy on each side
    row[hl + c] = v;
    if (c < hr) row[hl + w + c] = v;
    if (c >= w - hl) row[hl + c - w] = v;
    return;
  }
  int q = c;
  while (q - w >= -hl) q -= w;
  for (; q < w + hr; q += w) row[hl + q] = v;
}

// 16-byte vectors of the column pass: V values of the arithmetic type.
template <typename A> struct Vec { using type = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };

// Two rows at once (rows Rh apart forward, the inverse's top and bottom
// rows), with the same offsets: a0 += taps k < split, a1 += taps split <=
// k < nt, of top[o[k]], and b0, b1 the same of bot[o[k]], in table order,
// each product fused into its sum: the accumulation of kernels A and B,
// whose `s += c * x` the compiler contracts to one fma (an explicit fma
// here, since the two selections would otherwise share one rounded
// product).  The reads of CH taps are issued before their sums; o[k] is 0
// (a valid address) for k >= nt.  Each sum is selected, not branched to:
// the band bounds are the same for every thread, but the compiler cannot
// know it.
constexpr int CH = 8;

template <typename A, int K>
__device__ __forceinline__ void taps2(A& a0, A& a1, A& b0, A& b1, const A* top,
                                      const A* bot, const A (&cf)[K],
                                      const int (&o)[K], int split, int nt) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += CH) {
    A v[CH], w[CH];
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      v[u] = top[o[k0 + u]];
      w[u] = bot[o[k0 + u]];
    }
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const int k = k0 + u;
      const bool p0 = k < split, p1 = k >= split && k < nt;
      const A s0 = fma(cf[k], v[u], a0), s1 = fma(cf[k], v[u], a1);
      const A t0 = fma(cf[k], w[u], b0), t1 = fma(cf[k], w[u], b1);
      a0 = p0 ? s0 : a0;
      a1 = p1 ? s1 : a1;
      b0 = p0 ? t0 : b0;
      b1 = p1 ? t1 : b1;
    }
  }
}

// The same for V neighbouring columns of one row, one 16-byte read per
// tap.
template <typename A, int K>
__device__ __forceinline__ void tapsv(A (&a0)[Vec<A>::n], A (&a1)[Vec<A>::n],
                                      const A* src, const A (&cf)[K],
                                      const int (&o)[K], int split, int nt) {
  constexpr int V = Vec<A>::n, C = CH / 2;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += C) {
    A v[C][V];
#pragma unroll
    for (int u = 0; u < C; ++u)
      *reinterpret_cast<typename Vec<A>::type*>(v[u]) =
          *reinterpret_cast<const typename Vec<A>::type*>(src + o[k0 + u]);
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const int k = k0 + u;
      const bool p0 = k < split, p1 = k >= split && k < nt;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const A s0 = fma(cf[k], v[u][e], a0[e]), s1 = fma(cf[k], v[u][e], a1[e]);
        a0[e] = p0 ? s0 : a0[e];
        a1[e] = p1 ? s1 : a1[e];
      }
    }
  }
}

// Copy the halo rows of a band of `own` rows (hu above it, hd below, the
// band at rows [hu, hu + own) of `sec`) from the blocks of the cluster
// that own them: local row i holds the level's row rk * own - hu + i,
// taken mod own * blocks.  Several reads per thread in flight together.
template <typename A>
__device__ void fill_halo(const cg::cluster_group& cl, A* sec, int own, int blocks,
                          int rk, int hu, int hd, int cols, int pitch) {
  constexpr int U = 4;
  Steps it(cols);
  while (it.r < hu + hd) {
    A v[U];
    A* dst[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      dst[u] = nullptr;
      if (it.r < hu + hd) {
        const int i = it.r < hu ? it.r : own + it.r;
        const int g = wrap(rk * own - hu + i, own * blocks);
        const int q = g / own;
        A* src = sec + (hu + g - q * own) * pitch + it.c;
        if (q != rk) src = cl.map_shared_rank(src, q);
        v[u] = *src;
        dst[u] = sec + i * pitch + it.c;
      }
      it.next();
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (dst[u]) *dst[u] = v[u];
  }
}

// The halo rows that the row pass writes straight into the neighbours'
// buffers: the block above keeps this block's first hd output rows below
// its band, the block below its last hu rows above its band (the same
// block when the level runs on one).  Only where every halo row lies in a
// neighbour's band (R >= hu, hd); elsewhere fill_halo reads them after the
// pass.
template <typename A>
struct Halo {
  A *up, *dn;
  int R, hu, hd, pt;
  bool push;
  __device__ __forceinline__ Halo(const cg::cluster_group& cl, A* buf, int R_, int blocks,
                                  int rk, int hu_, int hd_, int pt_)
      : R(R_), hu(hu_), hd(hd_), pt(pt_), push(R_ >= hu_ && R_ >= hd_) {
    const int qa = (rk + blocks - 1) % blocks, qb = (rk + 1) % blocks;
    up = qa == rk ? buf : cl.map_shared_rank(buf, qa);
    dn = qb == rk ? buf : cl.map_shared_rank(buf, qb);
  }
  __device__ __forceinline__ A* above(int r) const {
    return push && r < hd ? up + (hu + R + r) * pt : nullptr;
  }
  __device__ __forceinline__ A* below(int r) const {
    return push && r >= R - hu ? dn + (r - (R - hu)) * pt : nullptr;
  }
};

// A split cluster barrier: every block arrives when it starts and waits
// before its first access to another block's shared memory, which must not
// come before that block runs.
__device__ __forceinline__ void cluster_arrive() {
#ifdef __CUDA_ARCH__
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
#else
  cg::this_cluster().sync();
#endif
}

__device__ __forceinline__ void cluster_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#else
  cg::this_cluster().sync();
#endif
}

__device__ __forceinline__ void level_sync(const cg::cluster_group& cl, int blocks) {
  if (blocks > 1)
    cl.sync();
  else
    __syncthreads();
}

}  // namespace

// Forward: x (m, n) -> packed (m, n), L levels; the band table holds ns
// scaling taps then nd detail taps.  Grid: B clusters of g.P blocks.
template <typename T, int K, int NTH>
__global__ void __launch_bounds__(NTH, 1)
tail_fw_kernel(const T* __restrict__ x, int64_t xsb, int64_t xsr, T* y, int64_t ysb,
               int64_t ysr, TailGeom g, const int* __restrict__ offs,
               const typename Acc<T>::type* __restrict__ coefs, int ns, int nd) {
  using A = typename Acc<T>::type;
  constexpr int V = Vec<A>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int nt = ns + nd;
  A* act = reinterpret_cast<A*>(smem_raw);  // the level's rows: even, odd planes
  A* tmp = act + g.fw_act();                  // the row pass's output, halo rows
  const int tsize = g.fw_tmp();
  if (g.P > 1) cluster_arrive();
  const T* xb = x + static_cast<int64_t>(blockIdx.x / g.P) * xsb;
  T* yb = y + static_cast<int64_t>(blockIdx.x / g.P) * ysb;
  A cf[K];
  int of[K], o[K];  // the band offsets, and a pass's addresses from them
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cf[k] = k < nt ? coefs[k] : A(0);
    of[k] = k < nt ? offs[k] : 0;
  }

  {  // level 1's rows of this block
    const int Ri = 2 * g.rows(1), wp = g.part(1), nh = g.n >> 1;
    const T* src = xb + static_cast<int64_t>(rank) * Ri * xsr;
    const auto row = [&](int r) { return src + r * xsr; };
    const auto to = [&](int r, int c, A v) {
      put(act + ((c & 1) * Ri + r) * wp, c >> 1, v, nh, g.hl, g.hr);
    };
    if (vec16(src, xsr, g.n))
      read_rows16<4, A, T>(Ri, g.n, row, to);
    else
      read_rows<16, A>(Ri, g.n, row, to);
  }
  // (every block reads all its rows before the first barrier of level 1,
  // and stores only after it, so the output may be the input)
  __syncthreads();
  if (g.P > 1) cluster_wait();

  for (int l = 1; l <= g.L; ++l) {
    const int blocks = g.blocks(l);
    if (blocks < g.P && l == g.split + 1) {
      cl.sync();  // every block's LL rows are in rank 0
      if (rank != 0) return;
    }
    const int rk = blocks > 1 ? rank : 0;
    const int R = g.rows(l), Ri = 2 * R, nh = g.n >> l, nl = 2 * nh;
    const int wp = g.part(l), pt = g.pitch(l);
    // rows: [s | d] of every input row, from the even / odd planes
#pragma unroll
    for (int k = 0; k < K; ++k)
      o[k] = k < nt ? (of[k] & 1) * Ri * wp + (of[k] >> 1) : 0;
    A* buf = tmp + (blocks > 1 ? (l & 1) * tsize : 0);
    const Halo<A> halo(cl, buf, Ri, blocks, rk, g.hu, g.hd, pt);
    // two rows per thread, Rh apart, for two more independent sums
    const int Rh = (Ri + 1) >> 1;
    for (Steps it(nh); it.r < Rh; it.next()) {
      const int r2 = it.r + Rh < Ri ? it.r + Rh : it.r;
      A sd[2][2] = {};
      taps2<A, K>(sd[0][0], sd[0][1], sd[1][0], sd[1][1], act + it.r * wp + g.hl + it.c,
                  act + r2 * wp + g.hl + it.c, cf, o, ns, nt);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? r2 : it.r;
        A* rows[3] = {buf + (g.hu + r) * pt, halo.above(r), halo.below(r)};
#pragma unroll
        for (A* row : rows)
          if (row) {
            row[it.c] = sd[h][0];
            row[nh + it.c] = sd[h][1];
          }
      }
    }
    level_sync(cl, blocks);
    if (!halo.push) {
      fill_halo(cl, buf, Ri, blocks, rk, g.hu, g.hd, nl, pt);
      level_sync(cl, blocks);  // (no block leaves while another reads it)
    }

    // columns: LL to the next level's rows (rank 0's past the split), LH,
    // HL, HH to their packed places
    const bool last = l == g.L;
    const bool to0 = !last && g.blocks(l + 1) < blocks;
    const int Rn = last ? 0 : 2 * g.rows(l + 1), wpn = last ? 0 : g.part(l + 1);
    A* nxt = to0 ? cl.map_shared_rank(act, 0) : act;
    const int r0n = to0 ? rank * R : 0;
#pragma unroll
    for (int k = 0; k < K; ++k) o[k] = k < nt ? of[k] * pt : 0;
    const int64_t r0 = static_cast<int64_t>(rk) * R, mh = g.m >> l;
    for (Steps it((nl + V - 1) / V); it.r < R; it.next()) {
      const int j0 = it.c * V;
      A s[V] = {}, d[V] = {};
      tapsv<A, K>(s, d, buf + (g.hu + 2 * it.r) * pt + j0, cf, o, ns, nt);
      T* ys = yb + (r0 + it.r) * ysr;
      T* yd = yb + (mh + r0 + it.r) * ysr;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int j = j0 + u;
        if (j >= nl) break;
        if (j < nh && !last)
          put(nxt + ((j & 1) * Rn + r0n + it.r) * wpn, j >> 1, s[u], nh >> 1, g.hl, g.hr);
        else
          st(ys + j, s[u]);
        st(yd + j, d[u]);
      }
    }
    __syncthreads();
  }
}

// Inverse: packed (m, n) -> (m, n), L levels; the band table holds the
// synthesis bands S0, D0, S1, D1 with n0..n3 taps.  Grid: B clusters of
// g.P blocks.
template <typename T, int K, int NTH>
__global__ void __launch_bounds__(NTH, 1)
tail_inv_kernel(const T* __restrict__ y, int64_t ysb, int64_t ysr, T* out, int64_t osb,
                int64_t osr, TailGeom g, const int* __restrict__ offs,
                const typename Acc<T>::type* __restrict__ coefs, int n0, int n1,
                int n2, int n3) {
  using A = typename Acc<T>::type;
  constexpr int V = Vec<A>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int nt = n0 + n1 + n2 + n3, e0 = n0 + n1, e1 = e0 + n2;
  A* secs = reinterpret_cast<A*>(smem_raw);  // per level: LL, LH, HL, HH rows
  const int send = g.inv_sec(g.L + 1), tsize = g.inv_tmp();
  A* tmp = secs + send;                       // the row pass's two halves
  if (g.P > 1) cluster_arrive();
  const T* yb = y + static_cast<int64_t>(blockIdx.x / g.P) * ysb;
  T* ob = out + static_cast<int64_t>(blockIdx.x / g.P) * osb;
  A cf[K];
  int of[K], o[K];  // the band offsets, and a pass's addresses from them
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cf[k] = k < nt ? coefs[k] : A(0);
    of[k] = k < nt ? offs[k] : 0;
  }

  // every level's quadrant rows of this block (rank 0: of the deep
  // levels, all of them); the LL of a level above L comes from below
  for (int l = 1, so = 0; l <= g.L; ++l) {
    const int R = g.rows(l), nh = g.n >> l, wp = g.part(l);
    A* sec = secs + so;
    so += g.up(4 * R * wp);
    if (g.blocks(l) == 1 && rank != 0) continue;
    const int64_t t0 = static_cast<int64_t>(g.blocks(l) > 1 ? rank : 0) * R;
    const int64_t mh = g.m >> l;
    // rows [0, R): the band's top rows (LL | LH); [R, 2R): its bottom rows
    const auto row = [&](int r) { return yb + (t0 + r + (r >= R) * (mh - R)) * ysr; };
    const auto to = [&](int r, int c, A v) {
      const int right = c >= nh;
      if (r >= R || right || l == g.L)  // an LL above level L comes from below
        put(sec + ((r >= R) * R + right * R + r) * wp, c - right * nh, v, nh, g.hl, g.hr);
    };
    if (vec16(yb, ysr, 2 * nh))
      read_rows16<4, A, T>(2 * R, 2 * nh, row, to);
    else
      read_rows<16, A>(2 * R, 2 * nh, row, to);
  }
  // (level 1 alone stores, after every block has read its rows)
  __syncthreads();
  if (g.P > 1) cluster_wait();

  for (int l = g.L, so = send; l >= 1; --l) {
    const int blocks = g.blocks(l);
    so -= g.up(4 * g.rows(l) * g.part(l));  // so: level l's section
    if (blocks == 1 && rank != 0) continue;
    if (blocks > 1 && l == g.split && g.split < g.L) cl.sync();  // LL rows from rank 0
    const int rk = blocks > 1 ? rank : 0;
    const int R = g.rows(l), nh = g.n >> l, nl = 2 * nh;
    const int wp = g.part(l), pt = g.pitch(l), half = g.inv_half(l);
    A* sec = secs + so;
    // rows: top row t of (LL | LH) -> half 0, bottom row of (HL | HH) ->
    // half 1, both output parities; a D band reads the quadrant R rows on
#pragma unroll
    for (int k = 0; k < K; ++k)
      o[k] = k >= nt ? 0 : of[k] + (((k >= n0 && k < e0) || k >= e1) ? R * wp : 0);
    A* buf = tmp + (blocks > 1 ? (l & 1) * tsize : 0);
    const Halo<A> halo(cl, buf, R, blocks, rk, g.hu, g.hd, pt);
    for (Steps it(nh); it.r < R; it.next()) {
      A s0 = 0, s1 = 0, d0 = 0, d1 = 0;
      const int c = g.hl + it.c;
      taps2<A, K>(s0, s1, d0, d1, sec + it.r * wp + c, sec + (2 * R + it.r) * wp + c,
                  cf, o, e0, nt);
      A* rows[3] = {buf + (g.hu + it.r) * pt, halo.above(it.r), halo.below(it.r)};
#pragma unroll
      for (A* row : rows)
        if (row) {
          row[2 * it.c] = s0;
          row[2 * it.c + 1] = s1;
          row[half + 2 * it.c] = d0;
          row[half + 2 * it.c + 1] = d1;
        }
    }
    level_sync(cl, blocks);
    if (!halo.push) {
      fill_halo(cl, buf, R, blocks, rk, g.hu, g.hd, nl, pt);
      fill_halo(cl, buf + half, R, blocks, rk, g.hu, g.hd, nl, pt);
      level_sync(cl, blocks);  // (no block leaves while another reads it)
    }

    // columns: merged rows 2r, 2r + 1 -> the next level's LL rows (every
    // block's, from rank 0, below the split), or to `out` at level 1
    const bool spread = l > 1 && g.blocks(l - 1) > blocks;
    const int Rn = l > 1 ? g.rows(l - 1) : 0, wpn = l > 1 ? g.part(l - 1) : 0;
    A* nxt = l > 1 ? sec - g.up(4 * Rn * wpn) : nullptr;
#pragma unroll
    for (int k = 0; k < K; ++k)
      o[k] = k >= nt ? 0 : of[k] * pt + (((k >= n0 && k < e0) || k >= e1) ? half : 0);
    const int64_t i0 = 2 * static_cast<int64_t>(rk) * R;
    for (Steps it((nl + V - 1) / V); it.r < R; it.next()) {
      const int j0 = it.c * V;
      A v[2][V] = {};
      tapsv<A, K>(v[0], v[1], buf + (g.hu + it.r) * pt + j0, cf, o, e0, nt);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int i = 2 * it.r + p;
        A* row = nullptr;
        if (l > 1) {
          const int q = spread ? i / Rn : 0;
          row = nxt + (i - q * Rn) * wpn;
          if (q != rank && spread) row = cl.map_shared_rank(row, q);
        }
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const int j = j0 + u;
          if (j >= nl) break;
          if (l > 1)
            put(row, j, v[p][u], nl, g.hl, g.hr);
          else
            st(ob + (i0 + i) * osr + j, v[p][u]);
        }
      }
    }
    __syncthreads();
  }
}

// The generic route: one block per image with the taps wrapped by a true
// modulo, for band tables of more than 32 taps (the unchanged first
// design of this file).
constexpr int TAIL_THREADS = 512;

// Forward: x (m, n) -> packed (m, n), L levels.  Band table: ns scaling
// taps then nd detail taps.
template <typename T>
__global__ void __launch_bounds__(TAIL_THREADS)
tail_fw_wrap_kernel(const T* __restrict__ x, int64_t xsb, int64_t xsr, T* y, int64_t ysb,
               int64_t ysr, int m, int n, int L, const int* __restrict__ offs,
               const typename Acc<T>::type* __restrict__ coefs, int ns, int nd) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = ns + nd;
  A* act = reinterpret_cast<A*>(smem_raw);  // [m][n]: the active array
  A* tmp = act + m * n;                       // [m][n]: row-pass output
  A* cf = tmp + m * n;
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int b = blockIdx.x;
  const T* xb = x + static_cast<int64_t>(b) * xsb;
  T* yb = y + static_cast<int64_t>(b) * ysb;
  load_bands(cf, of, coefs, offs, nt, tid, nth);
  for (int i = tid; i < m * n; i += nth)
    act[i] = ld(xb[static_cast<int64_t>(i / n) * xsr + i % n]);
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const int ml = m >> l, nl = n >> l, mh = ml / 2, nh = nl / 2;
    for (int idx = tid; idx < ml * nh; idx += nth) {  // rows: [s | d] per row
      const int i = idx / nh, c = idx % nh;
      const A* row = act + i * n;
      A s = 0, d = 0;
      for (int k = 0; k < ns; ++k) s += cf[k] * row[wrap(2 * c + of[k], nl)];
      for (int k = ns; k < nt; ++k) d += cf[k] * row[wrap(2 * c + of[k], nl)];
      tmp[i * n + c] = s;
      tmp[i * n + nh + c] = d;
    }
    __syncthreads();
    for (int idx = tid; idx < mh * nl; idx += nth) {  // columns
      const int r = idx / nl, j = idx % nl;
      A s = 0, d = 0;
      for (int k = 0; k < ns; ++k) s += cf[k] * tmp[wrap(2 * r + of[k], ml) * n + j];
      for (int k = ns; k < nt; ++k) d += cf[k] * tmp[wrap(2 * r + of[k], ml) * n + j];
      if (j < nh)
        act[r * n + j] = s;                                  // LL: next level
      else
        st(yb + static_cast<int64_t>(r) * ysr + j, s);       // LH
      st(yb + static_cast<int64_t>(mh + r) * ysr + j, d);    // HL | HH
    }
    __syncthreads();
  }
  const int mL = m >> L, nL = n >> L;
  for (int idx = tid; idx < mL * nL; idx += nth) {
    const int r = idx / nL, c = idx % nL;
    st(yb + static_cast<int64_t>(r) * ysr + c, act[r * n + c]);
  }
}

// Inverse: packed (m, n) -> (m, n), L levels.  Band table: the synthesis
// bands S0, D0, S1, D1 with n0..n3 taps.
template <typename T>
__global__ void __launch_bounds__(TAIL_THREADS)
tail_inv_wrap_kernel(const T* __restrict__ y, int64_t ysb, int64_t ysr, T* out, int64_t osb,
                int64_t osr, int m, int n, int L, const int* __restrict__ offs,
                const typename Acc<T>::type* __restrict__ coefs, int n0, int n1,
                int n2, int n3) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = n0 + n1 + n2 + n3;
  const int e0 = n0 + n1, e1 = e0 + n2;
  A* act = reinterpret_cast<A*>(smem_raw);  // [m][n]: packed, then merged
  A* tmp = act + m * n;                       // [m][n]: column-synthesised halves
  A* cf = tmp + m * n;
  int* of = reinterpret_cast<int*>(cf + nt);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int b = blockIdx.x;
  const T* yb = y + static_cast<int64_t>(b) * ysb;
  T* ob = out + static_cast<int64_t>(b) * osb;
  load_bands(cf, of, coefs, offs, nt, tid, nth);
  for (int i = tid; i < m * n; i += nth)
    act[i] = ld(yb[static_cast<int64_t>(i / n) * ysr + i % n]);
  __syncthreads();

  for (int l = L; l >= 1; --l) {
    const int mh = m >> l, nh = n >> l, nl = 2 * nh;
    // axis 1: row t of (LL | LH) -> tmp row t, row t of (HL | HH) -> tmp row mh + t
    for (int idx = tid; idx < mh * nl; idx += nth) {
      const int t = idx / nl, j = idx % nl, c = j >> 1, q = j & 1;
      const int ks = q ? e0 : 0, kd = q ? e1 : n0, ke = q ? nt : e0;
      const A* top = act + t * n;
      const A* bot = act + (mh + t) * n;
      A us = 0, ud = 0;
      for (int k = ks; k < kd; ++k) {
        const int ci = wrap(c + of[k], nh);
        us += cf[k] * top[ci];
        ud += cf[k] * bot[ci];
      }
      for (int k = kd; k < ke; ++k) {
        const int ci = nh + wrap(c + of[k], nh);
        us += cf[k] * top[ci];
        ud += cf[k] * bot[ci];
      }
      tmp[t * n + j] = us;
      tmp[(mh + t) * n + j] = ud;
    }
    __syncthreads();
    // axis 0: merge the halves into the (2mh, nl) active array
    for (int idx = tid; idx < 2 * mh * nl; idx += nth) {
      const int i = idx / nl, j = idx % nl, r = i >> 1, p = i & 1;
      const int ks = p ? e0 : 0, kd = p ? e1 : n0, ke = p ? nt : e0;
      A v = 0;
      for (int k = ks; k < kd; ++k) v += cf[k] * tmp[wrap(r + of[k], mh) * n + j];
      for (int k = kd; k < ke; ++k) v += cf[k] * tmp[(mh + wrap(r + of[k], mh)) * n + j];
      act[i * n + j] = v;
    }
    __syncthreads();
  }
  for (int i = tid; i < m * n; i += nth)
    st(ob + static_cast<int64_t>(i / n) * osr + i % n, act[i]);
}

template <typename T>
size_t tail_smem(int m, int n, int nt) {
  using A = typename Acc<T>::type;
  return 2 * static_cast<size_t>(m) * n * sizeof(A) +
         static_cast<size_t>(nt) * (sizeof(A) + sizeof(int));
}

template <typename T>
int tail_fw_wrap(int B, int m, int n, int L, const void* x, int64_t xsb, int64_t xsr,
            void* y, int64_t ysb, int64_t ysr, const int* offs, const void* coefs,
            int ns, int nd, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  return launch(tail_fw_wrap_kernel<T>, dim3(B), dim3(TAIL_THREADS),
                tail_smem<T>(m, n, ns + nd), stream, static_cast<const T*>(x), xsb,
                xsr, static_cast<T*>(y), ysb, ysr, m, n, L, offs,
                static_cast<const A*>(coefs), ns, nd);
}

template <typename T>
int tail_inv_wrap(int B, int m, int n, int L, const void* y, int64_t ysb, int64_t ysr,
             void* out, int64_t osb, int64_t osr, const int* offs,
             const void* coefs, const int* nb, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  return launch(tail_inv_wrap_kernel<T>, dim3(B), dim3(TAIL_THREADS),
                tail_smem<T>(m, n, nb[0] + nb[1] + nb[2] + nb[3]), stream,
                static_cast<const T*>(y), ysb, ysr, static_cast<T*>(out), osb, osr,
                m, n, L, offs, static_cast<const A*>(coefs), nb[0], nb[1], nb[2],
                nb[3]);
}


template <typename T, int K>
int tail_fw_cluster(int B, const TailGeom& g, const void* x, int64_t xsb, int64_t xsr,
                    void* y, int64_t ysb, int64_t ysr, const int* offs,
                    const void* coefs, int ns, int nd, size_t smem, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  constexpr int NTH = K <= 16 ? 512 : 256;
  return launch_cluster(tail_fw_kernel<T, K, NTH>, B * g.P, NTH, smem, g.P, stream,
                        static_cast<const T*>(x), xsb, xsr, static_cast<T*>(y), ysb,
                        ysr, g, offs, static_cast<const A*>(coefs), ns, nd);
}

template <typename T, int K>
int tail_inv_cluster(int B, const TailGeom& g, const void* y, int64_t ysb, int64_t ysr,
                     void* out, int64_t osb, int64_t osr, const int* offs,
                     const void* coefs, const int* nb, size_t smem,
                     cudaStream_t stream) {
  using A = typename Acc<T>::type;
  constexpr int NTH = 256;  // the inverse needs more than 128 registers a thread
  return launch_cluster(tail_inv_kernel<T, K, NTH>, B * g.P, NTH, smem, g.P, stream,
                        static_cast<const T*>(y), ysb, ysr, static_cast<T*>(out), osb,
                        osr, g, offs, static_cast<const A*>(coefs), nb[0], nb[1],
                        nb[2], nb[3]);
}

// The plan's geometry, or false where the kernel cannot take it: a cluster
// that is not a power of two up to 16, levels past the split that the
// cluster does not share evenly, or shared memory below the layout's.
template <typename T>
bool tail_geom(TailGeom& g, int m, int n, int L, const int* plan, size_t smem,
               bool inverse) {
  using A = typename Acc<T>::type;
  g = TailGeom{m, n, L, plan[0], plan[1], plan[3], plan[4], plan[5], plan[6],
               static_cast<int>(16 / sizeof(A)), 0};
  if (g.P < 1 || g.P > 16 || (g.P & (g.P - 1)) || g.split < 1 || g.split > L)
    return false;
  while ((1 << g.lp) < g.P) ++g.lp;
  for (int l = 1; l <= g.split; ++l)
    if ((m >> l) % g.P) return false;
  return static_cast<size_t>(g.elems(inverse)) * sizeof(A) <= smem;
}

template <typename T>
int tail_fw(int B, int m, int n, int L, const void* x, int64_t xsb, int64_t xsr,
            void* y, int64_t ysb, int64_t ysr, const int* offs, const void* coefs,
            int ns, int nd, const int* plan, size_t smem, cudaStream_t stream) {
  if (plan[2] == 0)
    return tail_fw_wrap<T>(B, m, n, L, x, xsb, xsr, y, ysb, ysr, offs, coefs, ns, nd,
                           stream);
  TailGeom g;
  if (!tail_geom<T>(g, m, n, L, plan, smem, false) || ns + nd > plan[2])
    return static_cast<int>(cudaErrorInvalidValue);
  if (plan[2] == 16)
    return tail_fw_cluster<T, 16>(B, g, x, xsb, xsr, y, ysb, ysr, offs, coefs, ns, nd,
                                  smem, stream);
  if (plan[2] == 32)
    return tail_fw_cluster<T, 32>(B, g, x, xsb, xsr, y, ysb, ysr, offs, coefs, ns, nd,
                                  smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int tail_inv(int B, int m, int n, int L, const void* y, int64_t ysb, int64_t ysr,
             void* out, int64_t osb, int64_t osr, const int* offs, const void* coefs,
             const int* nb, const int* plan, size_t smem, cudaStream_t stream) {
  if (plan[2] == 0)
    return tail_inv_wrap<T>(B, m, n, L, y, ysb, ysr, out, osb, osr, offs, coefs, nb,
                            stream);
  TailGeom g;
  if (!tail_geom<T>(g, m, n, L, plan, smem, true) ||
      nb[0] + nb[1] + nb[2] + nb[3] > plan[2])
    return static_cast<int>(cudaErrorInvalidValue);
  if (plan[2] == 16)
    return tail_inv_cluster<T, 16>(B, g, y, ysb, ysr, out, osb, osr, offs, coefs, nb,
                                   smem, stream);
  if (plan[2] == 32)
    return tail_inv_cluster<T, 32>(B, g, y, ysb, ysr, out, osb, osr, offs, coefs, nb,
                                   smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wtt

extern "C" {

// Forward tail: x (B, m, n) -> packed planes y (B, m, n), L levels.  plan:
// cluster size, split level, tap template (0: the generic route), halo
// columns left / right and rows above / below (ops/tail2d.py, tail_plan);
// smem: shared bytes per block.
int wtt_tail_fw(int dtype, int B, int m, int n, int L, const void* x, int64_t xsb,
                int64_t xsr, void* y, int64_t ysb, int64_t ysr, const int* offs,
                const void* coefs, int ns, int nd, const int* plan, int64_t smem,
                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto sm = static_cast<size_t>(smem);
  switch (dtype) {
    case wtt::F32:
      return wtt::tail_fw<float>(B, m, n, L, x, xsb, xsr, y, ysb, ysr, offs, coefs, ns, nd, plan, sm, s);
    case wtt::F64:
      return wtt::tail_fw<double>(B, m, n, L, x, xsb, xsr, y, ysb, ysr, offs, coefs, ns, nd, plan, sm, s);
    case wtt::BF16:
      return wtt::tail_fw<__nv_bfloat16>(B, m, n, L, x, xsb, xsr, y, ysb, ysr, offs, coefs, ns, nd, plan, sm, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Inverse tail: packed planes y (B, m, n) -> out (B, m, n), L levels; plan
// and smem as for the forward.
int wtt_tail_inv(int dtype, int B, int m, int n, int L, const void* y, int64_t ysb,
                 int64_t ysr, void* out, int64_t osb, int64_t osr, const int* offs,
                 const void* coefs, const int* nb, const int* plan, int64_t smem,
                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto sm = static_cast<size_t>(smem);
  switch (dtype) {
    case wtt::F32:
      return wtt::tail_inv<float>(B, m, n, L, y, ysb, ysr, out, osb, osr, offs, coefs, nb, plan, sm, s);
    case wtt::F64:
      return wtt::tail_inv<double>(B, m, n, L, y, ysb, ysr, out, osb, osr, offs, coefs, nb, plan, sm, s);
    case wtt::BF16:
      return wtt::tail_inv<__nv_bfloat16>(B, m, n, L, y, ysb, ysr, out, osb, osr, offs, coefs, nb, plan, sm, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
