// The periodic MODWT over (B, N) rows: all levels of a row in one launch,
// forward (kernel modwt_fw_levels) and inverse (modwt_inv_levels), and one
// level forward (kernel K) and inverse (kernel M): the undecimated,
// dilated filter pair of ops/modwt.py, with the taps k * 2^(j-1) apart.
//
// Replaces: wavelets_tpu/ops/pallas/modwt1d.py, modwt_pallas (_step and
// _fw_kernel: v_j and w_j from one read of v_{j-1}, per level, then a
// stack into (B, N, L+1)) and imodwt_pallas (_inv_kernel).  On the TPU a
// whole row lives in VMEM so that the dilated roll wraps exactly, which
// limits it to N % 128 == 0 and B % 8 == 0; here the wrap is a true
// modulo, so any N >= 2^L and any B run, and the reach (taps - 1) *
// 2^(j-1), which can exceed N several times over, wraps as often as it
// must.
//
// Bound on the H100: memory traffic.  The transform's least traffic reads
// x once and writes the (B, N, L+1) result once: L + 2 planes, 134 MB at
// (512, 8192) L6 in float32, 0.040 ms at 3.35 TB/s.  The arithmetic (db4:
// 16 FMA per sample and level) is far below the FP32 peak.
//
// Design of modwt_fw_levels (ops/modwt1d.py, modwt_plan, picks P):
// * A thread-block cluster of P blocks per row; block p owns the samples
//   [p R, (p + 1) R).  The scaling band stays in shared memory for all the
//   levels, in two alternating buffers in the storage type, so bfloat16
//   rounds v_j exactly where a chain of per-level launches does.
// * The dilated reach: before level j each block copies the (taps - 1)
//   2^(j-1) samples that precede its range, wrapped with a true modulo on
//   the sample index and the owning block, from its neighbours' buffers
//   (distributed shared memory) into a halo in front of its own, so the
//   tap loop is wrap-free.  One cluster barrier per level.
// * Persistent clusters, as many as the card holds, walk the rows; the
//   next row's x is fetched (cp.async) into the scaling buffer that the
//   last level leaves free, so loads, taps and stores of successive rows
//   overlap instead of every block loading, computing and storing at once.
// * The outputs: each block stages w_1 .. w_L and v_L for its range in
//   shared memory in the output's own (t, j) layout and writes
//   out[b, t0:t1, 0:L+1], one contiguous span, with 16-byte stores: each
//   byte of the output is written once, where the per-level kernel wrote
//   a 4-byte column element into each 32-byte sector, L times over.
// * The taps in registers, unrolled up to a compile-time count (8, 16 or
//   32), one explicit fma per tap in kernel K's order, so the result
//   equals a chain of K launches bit for bit.
// A row whose layout no cluster of up to 16 blocks can hold runs one K
// launch per level (the plan decides before the launch).
//
// modwt_inv_levels is the other half of the design, in the same layout
// and plan (see its kernel below).  M per level took 322.5 us on an
// H100 at (512, 8192) db4 L6 in six launches: one output per thread, two taps
// from shared memory and two scalar loads per tap, w_j read as a column
// of (B, N, L+1) at element stride L+1 (one 4-byte element per 28-byte
// row, sector after sector), and each v_j through a scratch plane in
// device memory.
//
// Kernels K and M: one thread per output sample, a block per M_THREADS
// samples of one row (blockIdx.x runs over row tiles, then rows).  Every
// plane has a row stride and an element stride, so K can write w_j into a
// column of a (B, N, L+1) array (element stride L+1) and M reads it from
// there.  The Julia reference's GPU extension takes the same form
// (_modwt_step_kernel!, one thread per output sample).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace wtt {

constexpr int M_THREADS = 256;

template <typename T>
struct Rows {  // a (B, N) view: row stride sr, element stride se
  T* p;
  int64_t sr, se;
  __device__ __forceinline__ T* at(int b, int t) const {
    return p + static_cast<int64_t>(b) * sr + static_cast<int64_t>(t) * se;
  }
};

// Forward: v (B, N) -> v1, w1 (B, N), with dil = 2^(j-1) mod N:
//   v1[t] = sum_n g[n] v[(t - n dil) mod N],  w1[t] = sum_n h[n] v[(t - n dil) mod N].
template <typename T>
__global__ void __launch_bounds__(M_THREADS)
modwt_fw_kernel(Rows<const T> v, Rows<T> v1, Rows<T> w1, int N, int tiles,
                int dil, const typename Acc<T>::type* __restrict__ taps,
                int nt) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* cf = reinterpret_cast<A*>(smem_raw);  // g[0..nt), then h[0..nt)
  for (int k = threadIdx.x; k < 2 * nt; k += M_THREADS) cf[k] = taps[k];
  __syncthreads();
  const int b = blockIdx.x / tiles;
  const int t = (blockIdx.x % tiles) * M_THREADS + threadIdx.x;
  if (t >= N) return;
  A sv = 0, sw = 0;
  int idx = t;  // (t - n dil) mod N
  for (int n = 0; n < nt; ++n) {
    const A x = ld(*v.at(b, idx));
    sv = fma(cf[n], x, sv);
    sw = fma(cf[nt + n], x, sw);
    idx -= dil;
    if (idx < 0) idx += N;
  }
  st(v1.at(b, t), sv);
  st(w1.at(b, t), sw);
}

// Inverse: v1, w1 (B, N) -> v (B, N):
//   v[t] = sum_n h[n] w1[(t + n dil) mod N] + g[n] v1[(t + n dil) mod N].
template <typename T>
__global__ void __launch_bounds__(M_THREADS)
modwt_inv_kernel(Rows<const T> v1, Rows<const T> w1, Rows<T> v, int N,
                 int tiles, int dil,
                 const typename Acc<T>::type* __restrict__ taps, int nt) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* cf = reinterpret_cast<A*>(smem_raw);
  for (int k = threadIdx.x; k < 2 * nt; k += M_THREADS) cf[k] = taps[k];
  __syncthreads();
  const int b = blockIdx.x / tiles;
  const int t = (blockIdx.x % tiles) * M_THREADS + threadIdx.x;
  if (t >= N) return;
  // one fma per tap, the detail term then the scaling term, taps in
  // order: the sum that modwt_inv_levels_kernel repeats bit for bit
  A acc = 0;
  int idx = t;  // (t + n dil) mod N
  for (int n = 0; n < nt; ++n) {
    acc = fma(cf[nt + n], ld(*w1.at(b, idx)), acc);
    acc = fma(cf[n], ld(*v1.at(b, idx)), acc);
    idx += dil;
    if (idx >= N) idx -= N;
  }
  st(v.at(b, t), acc);
}


// All L levels of the forward MODWT of each row, out (B, N, L+1) with unit
// element stride and row stride L+1.  Grid: B clusters of P blocks; block
// p of a row owns [p R, min(N, (p + 1) R)).  Shared memory, in elements of
// T, each section 16-byte aligned: two buffers of H + R (the scaling band
// at [H, H + R), level j's halo of (taps - 1) 2^(j-1) samples just below
// it; H is level L's), then the output stage of R (L + 1) + E elements
// (E = 16 / sizeof(T)), offset so that its element 0 shares its global
// address's place in a 16-byte word.
constexpr int MW_THREADS = 256;

struct ModwtGeom {
  int N, L, P, R, H;
  __host__ __device__ static int up(int v, int e) { return (v + e - 1) / e * e; }
  __host__ __device__ int buf(int e) const { return up(H + R, e); }
  __host__ __device__ int elems(int e) const {
    return 2 * buf(e) + up(R * (L + 1) + e, e);
  }
};

// A split cluster barrier: arrive once a block has made its last read of
// another block's shared memory, wait before it leaves.
__device__ __forceinline__ void cl_arrive() {
#ifdef __CUDA_ARCH__
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
#else
  cg::this_cluster().sync();
#endif
}

__device__ __forceinline__ void cl_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#else
  cg::this_cluster().sync();
#endif
}

// Copy x[b, t0 : t0 + own] to dst: by cp.async where the element is 4 or
// 8 bytes (bfloat16 in 4-byte pairs where the row is contiguous and both
// sides are 4-byte aligned), else by plain loads; the caller waits
// (cp_async_wait_all) and synchronises before reading it.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
#else
  for (int k = 0; k < bytes; ++k)
    static_cast<unsigned char*>(dst)[k] = static_cast<const unsigned char*>(src)[k];
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

template <typename T>
__device__ __forceinline__ void fetch_row(T* dst, Rows<const T> x, int b, int t0, int own) {
  const int tid = threadIdx.x;
  if (sizeof(T) >= 4) {
    for (int i = tid; i < own; i += MW_THREADS)
      cp_async(dst + i, x.at(b, t0 + i), sizeof(T));
    return;
  }
  const T* src = x.at(b, t0);
  if (x.se == 1 && ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 3) == 0) {
    for (int i = 2 * tid; i + 1 < own; i += 2 * MW_THREADS) cp_async(dst + i, src + i, 4);
    if ((own & 1) && tid == 0) dst[own - 1] = src[own - 1];
    return;
  }
  for (int i = tid; i < own; i += MW_THREADS) dst[i] = *x.at(b, t0 + i);
}

// Persistent: as many clusters as the card holds walk the rows gridDim.x /
// P apart, and the next row's x is fetched into the free scaling buffer
// during the last level of this one, so its load overlaps the taps and
// this row's output store the next row's levels.
template <typename T, int K>
__global__ void __launch_bounds__(MW_THREADS)
modwt_fw_levels_kernel(Rows<const T> x, int B, T* __restrict__ out, int64_t osb, ModwtGeom g,
                       const typename Acc<T>::type* __restrict__ taps, int nt) {
  using A = typename Acc<T>::type;
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x;
  const int L1 = g.L + 1, t0 = rank * g.R;
  const int own = max(0, min(g.R, g.N - t0));
  const int rows_step = gridDim.x / g.P;
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + g.buf(E);
  T* const stage0 = nxt + g.buf(E);
  A cs[K], cw[K];  // g and h
#pragma unroll
  for (int n = 0; n < K; ++n) {
    cs[n] = n < nt ? taps[n] : A(0);
    cw[n] = n < nt ? taps[nt + n] : A(0);
  }
  int b = blockIdx.x / g.P;
  fetch_row(cur + g.H, x, b, t0, own);
  cp_async_wait_all();
  __syncthreads();
  cl_arrive();  // this block's x is in place

  for (; b < B; b += rows_step) {
    cl_wait();  // every block's x of row b is in place, and row b - 1 done
    T* ob = out + static_cast<int64_t>(b) * osb + static_cast<int64_t>(t0) * L1;
    const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(ob) & 15) / sizeof(T));
    T* stage = stage0 + mis;  // stage[i * L1 + j]: out[b, t0 + i, j]
    for (int j = 1; j <= g.L; ++j) {
      const int dil = 1 << (j - 1);  // 2^(j-1) <= N / 2
      const int hj = (nt - 1) * dil;
      // the halo: cur[H - hj + i] = v[(t0 - hj + i) mod N], from its owner
      for (int i = tid; i < hj; i += MW_THREADS) {
        const int s = wrap(t0 - hj + i, g.N);
        const int q = s / g.R;
        const T* src = cur + g.H + (s - q * g.R);
        if (q != rank) src = cl.map_shared_rank(src, q);
        cur[g.H - hj + i] = *src;
      }
      // nxt is free at the last level: the next row's x goes there
      if (j == g.L && b + rows_step < B) fetch_row(nxt + g.H, x, b + rows_step, t0, own);
      __syncthreads();
      for (int i = tid; i < own; i += MW_THREADS) {
        const T* p = cur + g.H + i;
        A sv = 0, sw = 0;
#pragma unroll
        for (int n = 0; n < K; ++n)
          if (n < nt) {
            const A v = ld(p[-n * dil]);
            sv = fma(cs[n], v, sv);
            sw = fma(cw[n], v, sw);
          }
        st(stage + i * L1 + j - 1, sw);
        st(j == g.L ? stage + i * L1 + g.L : nxt + g.H + i, sv);
      }
      if (j < g.L) {
        cl.sync();  // v_j complete in every block; nobody reads cur any more
        T* t = cur;
        cur = nxt;
        nxt = t;
      }
    }
    __syncthreads();
    // out[b, t0:t0+own, :] from the stage: 16-byte words where whole
    const int n = own * L1;
    T* base = ob - mis;  // 16-byte aligned
    const int words = (mis + n + E - 1) / E;
    for (int wi = tid; wi < words; wi += MW_THREADS) {
      const int e0 = wi * E;
      if (e0 >= mis && e0 + E <= mis + n) {
        *reinterpret_cast<uint4*>(base + e0) = *reinterpret_cast<const uint4*>(stage0 + e0);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (e0 + e >= mis && e0 + e < mis + n) base[e0 + e] = stage0[e0 + e];
      }
    }
    cp_async_wait_all();
    __syncthreads();
    T* t = cur;  // the next row's x
    cur = nxt;
    nxt = t;
    cl_arrive();  // this block's next x is in place, its reads of row b done
  }
  cl_wait();  // no block leaves while another may read its buffers
}

// All L levels of the inverse MODWT of each row: xw (B, N, L+1) with
// batch stride xsb, row stride L+1 and unit element stride -> out (B, N)
// with row stride osr and unit element stride.  The mirror of
// modwt_fw_levels_kernel, in its layout (ModwtGeom): two scaling buffers
// of H + R elements and a stage of R (L + 1) + E.  Block p of a row's
// cluster owns [t0, t0 + own) = [p R, min(N, (p + 1) R)):
// * The stage: the block's span xw[b, t0 : t0 + own, 0 : L+1], one
//   contiguous run, fetched once in 16-byte cp.async words (a partial
//   first or last word element by element) and kept in the input's own
//   (t, j) layout, at stage0 + mis (mis: the run's offset in its first
//   word), so no column is ever read at stride L+1 from device memory.
// * Level j (L down to 1): v_{j-1}[t] = sum_n h[n] w_j[(t + n 2^(j-1)) mod N]
//   + g[n] v_j[(t + n 2^(j-1)) mod N].  The reach lies after the block's
//   range: (taps - 1) 2^(j-1) samples, wrapped by a true modulo on the
//   sample and the owning block, as often as the row requires.  Before the
//   level each block copies v_j's halo from its neighbours' scaling
//   buffers (at level L: their stages' column L) behind its own v_j, and
//   w_j's from their stages into the free buffer's tail, both through
//   distributed shared memory; so the tap loop does not wrap.  One cluster
//   barrier per level.
// * v_j stays in the storage type in the two alternating buffers, so
//   bfloat16 rounds it where a chain of M launches does, and each sum is
//   M's: one fma per tap, the detail term then the scaling term, taps in
//   order, unrolled to the template K (8, 16 or 32) in registers.  The
//   outputs whose reach stays inside the block's range (all but the last
//   (taps - 1) 2^(j-1)) run four to a thread, MW_THREADS apart: four
//   independent sums whose loads share their addressing, w_j from the
//   stage; the rest one to a thread, w_j from the stage or the halo.
// * v_0 goes to the free buffer, then to out[b, t0 : t0 + own], one
//   contiguous span, in 16-byte words; meanwhile the next row's span is
//   fetched into the stage (persistent clusters walk the rows).
constexpr int MI_OUTS = 4;  // outputs per thread and pass, MW_THREADS apart

template <typename T, int K>
__global__ void __launch_bounds__(MW_THREADS)
modwt_inv_levels_kernel(const T* __restrict__ xw, int64_t xsb, int B, T* __restrict__ out,
                        int64_t osr, ModwtGeom g,
                        const typename Acc<T>::type* __restrict__ taps, int nt) {
  using A = typename Acc<T>::type;
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x;
  const int L1 = g.L + 1, t0 = rank * g.R;
  const int own = max(0, min(g.R, g.N - t0));
  const int rows_step = gridDim.x / g.P;
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + g.buf(E);
  T* const stage0 = nxt + g.buf(E);
  A cs[K], cw[K];  // g and h
#pragma unroll
  for (int n = 0; n < K; ++n) {
    cs[n] = n < nt ? taps[n] : A(0);
    cw[n] = n < nt ? taps[nt + n] : A(0);
  }
  // the offset of block q's run in its first 16-byte word, for row b
  const auto mis_of = [&](int b, int q) {
    const T* p = xw + static_cast<int64_t>(b) * xsb + static_cast<int64_t>(q) * g.R * L1;
    return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
  };
  // fetch row b's span into the stage: the 16-byte words that hold it,
  // by cp.async where whole, the partial first and last words element by
  // element (nothing outside the span is read)
  const auto fetch = [&](int b) {
    const int mis = mis_of(b, rank), n = own * L1;
    const T* base = xw + static_cast<int64_t>(b) * xsb + static_cast<int64_t>(t0) * L1 - mis;
    const int words = (mis + n + E - 1) / E;
    for (int wi = tid; wi < words; wi += MW_THREADS) {
      const int e0 = wi * E;
      if (e0 >= mis && e0 + E <= mis + n) {
        cp_async16(stage0 + e0, base + e0);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (e0 + e >= mis && e0 + e < mis + n) stage0[e0 + e] = base[e0 + e];
      }
    }
    cp_async_commit();
  };
  int b = blockIdx.x / g.P;
  fetch(b);
  cp_async_wait<0>();
  __syncthreads();
  cl_arrive();  // this block's span of row b is in place

  for (; b < B; b += rows_step) {
    cl_wait();  // every block's span of row b in place, and row b - 1 done
    const int mis = mis_of(b, rank);
    const T* stage = stage0 + mis;  // stage[t * L1 + j]: xw[b, t0 + t, j]
    for (int j = g.L; j >= 1; --j) {
      const int dil = 1 << (j - 1);  // 2^(j-1) <= N / 2
      const int hj = (nt - 1) * dil;
      // level L's v_L: the stage's column L, into the buffer
      if (j == g.L)
        for (int i = tid; i < own; i += MW_THREADS) cur[i] = stage[i * L1 + g.L];
      // the halos, from their owners: cur[own + i] = v_j[(t0 + own + i)
      // mod N], nxt[own + i] = w_j[...]
      for (int i = tid; i < hj; i += MW_THREADS) {
        const int s = (t0 + own + i) % g.N;
        const int q = s / g.R, off = s - q * g.R;
        const T* st_q = stage0 + mis_of(b, q) + off * L1;
        const T* v_q = j == g.L ? st_q + g.L : cur + off;
        const T* w_q = st_q + j - 1;
        if (q != rank) {
          v_q = cl.map_shared_rank(v_q, q);
          w_q = cl.map_shared_rank(w_q, q);
        }
        cur[own + i] = *v_q;
        nxt[own + i] = *w_q;
      }
      if (j == 1) cl_arrive();  // this row's reads of other blocks are done
      __syncthreads();
      const T* wj = stage + j - 1;
      // the outputs [0, inner) reach no further than the block's range
      const int inner = max(0, own - hj), dw = dil * L1;
      for (int t = tid; t < inner; t += MI_OUTS * MW_THREADS) {
        A acc[MI_OUTS];
#pragma unroll
        for (int k = 0; k < MI_OUTS; ++k) acc[k] = A(0);
        const T* pv = cur + t;
        const T* pw = wj + t * L1;
#pragma unroll
        for (int n = 0; n < K; ++n)
          if (n < nt) {
#pragma unroll
            for (int k = 0; k < MI_OUTS; ++k)
              if (t + k * MW_THREADS < inner) {
                acc[k] = fma(cw[n], ld(pw[k * MW_THREADS * L1]), acc[k]);
                acc[k] = fma(cs[n], ld(pv[k * MW_THREADS]), acc[k]);
              }
            pv += dil;
            pw += dw;
          }
#pragma unroll
        for (int k = 0; k < MI_OUTS; ++k)
          if (t + k * MW_THREADS < inner) st(nxt + t + k * MW_THREADS, acc[k]);
      }
      for (int t = inner + tid; t < own; t += MW_THREADS) {
        A acc = 0;
#pragma unroll
        for (int n = 0; n < K; ++n)
          if (n < nt) {
            const int idx = t + n * dil;
            acc = fma(cw[n], ld(idx < own ? wj[idx * L1] : nxt[idx]), acc);
            acc = fma(cs[n], ld(cur[idx]), acc);
          }
        st(nxt + t, acc);
      }
      if (j > 1) {
        cl.sync();  // v_{j-1} complete in every block; nobody reads cur any more
        T* tp = cur;
        cur = nxt;
        nxt = tp;
      }
    }
    __syncthreads();  // v_0 complete in nxt; this block's reads of its stage done
    cl_wait();        // and every other block's (they arrived after their halos)
    if (b + rows_step < B) fetch(b + rows_step);
    // out[b, t0 : t0 + own] from nxt: 16-byte words where whole
    T* ob = out + static_cast<int64_t>(b) * osr + t0;
    const int mo = static_cast<int>((reinterpret_cast<uintptr_t>(ob) & 15) / sizeof(T));
    T* base = ob - mo;  // 16-byte aligned
    const int words = (mo + own + E - 1) / E;
    for (int wi = tid; wi < words; wi += MW_THREADS) {
      const int e0 = wi * E - mo;  // nxt index of the word's first element
      if (e0 >= 0 && e0 + E <= own) {
        __align__(16) T wv[E];
#pragma unroll
        for (int e = 0; e < E; ++e) wv[e] = nxt[e0 + e];
        *reinterpret_cast<uint4*>(base + wi * E) = *reinterpret_cast<const uint4*>(wv);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (e0 + e >= 0 && e0 + e < own) ob[e0 + e] = nxt[e0 + e];
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next span staged; nxt read
    cl_arrive();  // this block's next span is in place, its row b done
  }
  cl_wait();  // no block leaves while another may read its shared memory
}

constexpr int64_t M_MAX_BLOCKS = 2147483647;

template <typename T>
int modwt_fw(int B, int N, int dil, const void* v, int64_t vsr, int64_t vse,
             void* v1, int64_t v1sr, int64_t v1se, void* w1, int64_t w1sr,
             int64_t w1se, const void* taps, int nt, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int tiles = (N + M_THREADS - 1) / M_THREADS;
  const int64_t blocks = static_cast<int64_t>(B) * tiles;
  if (blocks > M_MAX_BLOCKS) return static_cast<int>(cudaErrorInvalidConfiguration);
  return launch(modwt_fw_kernel<T>, dim3(static_cast<unsigned>(blocks)),
                dim3(M_THREADS), 2 * static_cast<size_t>(nt) * sizeof(A), stream,
                Rows<const T>{static_cast<const T*>(v), vsr, vse},
                Rows<T>{static_cast<T*>(v1), v1sr, v1se},
                Rows<T>{static_cast<T*>(w1), w1sr, w1se}, N, tiles, dil,
                static_cast<const A*>(taps), nt);
}

template <typename T>
int modwt_inv(int B, int N, int dil, const void* v1, int64_t v1sr,
              int64_t v1se, const void* w1, int64_t w1sr, int64_t w1se,
              void* v, int64_t vsr, int64_t vse, const void* taps, int nt,
              cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int tiles = (N + M_THREADS - 1) / M_THREADS;
  const int64_t blocks = static_cast<int64_t>(B) * tiles;
  if (blocks > M_MAX_BLOCKS) return static_cast<int>(cudaErrorInvalidConfiguration);
  return launch(modwt_inv_kernel<T>, dim3(static_cast<unsigned>(blocks)),
                dim3(M_THREADS), 2 * static_cast<size_t>(nt) * sizeof(A), stream,
                Rows<const T>{static_cast<const T*>(v1), v1sr, v1se},
                Rows<const T>{static_cast<const T*>(w1), w1sr, w1se},
                Rows<T>{static_cast<T*>(v), vsr, vse}, N, tiles, dil,
                static_cast<const A*>(taps), nt);
}


template <typename T, int K>
int modwt_fw_levels_k(int B, const ModwtGeom& g, const void* x, int64_t xsr, int64_t xse,
                      void* out, int64_t osb, const void* taps, int nt, size_t smem,
                      cudaStream_t stream) {
  using A = typename Acc<T>::type;
  auto kernel = modwt_fw_levels_kernel<T, K>;
  int fit = 0;
  const int status = cluster_fit(kernel, MW_THREADS, smem, g.P, &fit);
  if (status != 0) return status;
  return launch_cluster(kernel, (B < fit ? B : fit) * g.P, MW_THREADS, smem, g.P, stream,
                        Rows<const T>{static_cast<const T*>(x), xsr, xse}, B,
                        static_cast<T*>(out), osb, g, static_cast<const A*>(taps), nt);
}

// plan: P, R, H, K (ops/modwt1d.py, modwt_plan); refused where the kernel
// cannot take it: a cluster that is not a power of two up to 16, blocks
// that do not cover the row, a halo short of level L's reach, more taps
// than the template, or fewer shared bytes than the layout.
template <typename T>
int modwt_fw_levels(int B, int N, int L, const void* x, int64_t xsr, int64_t xse,
                    void* out, int64_t osb, const void* taps, int nt, const int* plan,
                    size_t smem, cudaStream_t stream) {
  const ModwtGeom g{N, L, plan[0], plan[1], plan[2]};
  const int K = plan[3];
  if (g.P < 1 || g.P > 16 || (g.P & (g.P - 1)) || L < 1 || L > 30 ||
      (1 << L) > N || g.R < 1 || static_cast<int64_t>(g.R) * g.P < N ||
      static_cast<int64_t>(g.R) * (g.P - 1) >= N || nt < 1 || nt > K ||
      static_cast<int64_t>(g.H) < static_cast<int64_t>(nt - 1) << (L - 1) ||
      static_cast<size_t>(g.elems(16 / sizeof(T))) * sizeof(T) > smem ||
      static_cast<int64_t>(B) * g.P > M_MAX_BLOCKS)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (K) {
    case 8:
      return modwt_fw_levels_k<T, 8>(B, g, x, xsr, xse, out, osb, taps, nt, smem, stream);
    case 16:
      return modwt_fw_levels_k<T, 16>(B, g, x, xsr, xse, out, osb, taps, nt, smem, stream);
    case 32:
      return modwt_fw_levels_k<T, 32>(B, g, x, xsr, xse, out, osb, taps, nt, smem, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int K>
int modwt_inv_levels_k(int B, const ModwtGeom& g, const void* xw, int64_t xsb, void* out,
                       int64_t osr, const void* taps, int nt, size_t smem,
                       cudaStream_t stream) {
  using A = typename Acc<T>::type;
  auto kernel = modwt_inv_levels_kernel<T, K>;
  int fit = 0;
  const int status = cluster_fit(kernel, MW_THREADS, smem, g.P, &fit);
  if (status != 0) return status;
  return launch_cluster(kernel, (B < fit ? B : fit) * g.P, MW_THREADS, smem, g.P, stream,
                        static_cast<const T*>(xw), xsb, B, static_cast<T*>(out), osr, g,
                        static_cast<const A*>(taps), nt);
}

// plan: P, R, H, K (ops/modwt1d.py, modwt_inv_plan: the forward's plan,
// the layout being the same); refused as for the forward.
template <typename T>
int modwt_inv_levels(int B, int N, int L, const void* xw, int64_t xsb, void* out,
                     int64_t osr, const void* taps, int nt, const int* plan, size_t smem,
                     cudaStream_t stream) {
  const ModwtGeom g{N, L, plan[0], plan[1], plan[2]};
  const int K = plan[3];
  if (g.P < 1 || g.P > 16 || (g.P & (g.P - 1)) || L < 1 || L > 30 ||
      (1 << L) > N || g.R < 1 || static_cast<int64_t>(g.R) * g.P < N ||
      static_cast<int64_t>(g.R) * (g.P - 1) >= N || nt < 1 || nt > K ||
      static_cast<int64_t>(g.H) < static_cast<int64_t>(nt - 1) << (L - 1) ||
      static_cast<size_t>(g.elems(16 / sizeof(T))) * sizeof(T) > smem ||
      static_cast<int64_t>(B) * g.P > M_MAX_BLOCKS)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (K) {
    case 8:
      return modwt_inv_levels_k<T, 8>(B, g, xw, xsb, out, osr, taps, nt, smem, stream);
    case 16:
      return modwt_inv_levels_k<T, 16>(B, g, xw, xsb, out, osr, taps, nt, smem, stream);
    case 32:
      return modwt_inv_levels_k<T, 32>(B, g, xw, xsb, out, osr, taps, nt, smem, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
}  // namespace wtt

extern "C" {

// Forward level.  v: (B, N) with row stride vsr and element stride vse;
// v1, w1: the (B, N) output planes with their own strides (in elements).
// dil: the dilation 2^(j-1) reduced mod N.  taps: g then h (nt each) in
// the arithmetic type, on the device.
int wtt_modwt_fw(int dtype, int B, int N, int dil, const void* v, int64_t vsr,
                 int64_t vse, void* v1, int64_t v1sr, int64_t v1se, void* w1,
                 int64_t w1sr, int64_t w1se, const void* taps, int nt,
                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::modwt_fw<float>(B, N, dil, v, vsr, vse, v1, v1sr, v1se, w1, w1sr, w1se, taps, nt, s);
    case wtt::F64:
      return wtt::modwt_fw<double>(B, N, dil, v, vsr, vse, v1, v1sr, v1se, w1, w1sr, w1se, taps, nt, s);
    case wtt::BF16:
      return wtt::modwt_fw<__nv_bfloat16>(B, N, dil, v, vsr, vse, v1, v1sr, v1se, w1, w1sr, w1se, taps, nt, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Inverse level.  v1, w1: the (B, N) planes to read; v: the (B, N) output;
// strides, dil and taps as for the forward.
int wtt_modwt_inv(int dtype, int B, int N, int dil, const void* v1,
                  int64_t v1sr, int64_t v1se, const void* w1, int64_t w1sr,
                  int64_t w1se, void* v, int64_t vsr, int64_t vse,
                  const void* taps, int nt, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::modwt_inv<float>(B, N, dil, v1, v1sr, v1se, w1, w1sr, w1se, v, vsr, vse, taps, nt, s);
    case wtt::F64:
      return wtt::modwt_inv<double>(B, N, dil, v1, v1sr, v1se, w1, w1sr, w1se, v, vsr, vse, taps, nt, s);
    case wtt::BF16:
      return wtt::modwt_inv<__nv_bfloat16>(B, N, dil, v1, v1sr, v1se, w1, w1sr, w1se, v, vsr, vse, taps, nt, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// All levels forward.  x: (B, N) with row stride xsr and element stride
// xse; out: (B, N, L+1) with batch stride osb, row stride L+1 and unit
// element stride.  taps: g then h (nt each) in the arithmetic type, on the
// device.  plan: int32[4] {P, R, H, K}; smem: shared bytes per block.
int wtt_modwt_fw_levels(int dtype, int B, int N, int L, const void* x, int64_t xsr,
                        int64_t xse, void* out, int64_t osb, const void* taps, int nt,
                        const int* plan, int64_t smem, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto sm = static_cast<size_t>(smem);
  switch (dtype) {
    case wtt::F32:
      return wtt::modwt_fw_levels<float>(B, N, L, x, xsr, xse, out, osb, taps, nt, plan, sm, s);
    case wtt::F64:
      return wtt::modwt_fw_levels<double>(B, N, L, x, xsr, xse, out, osb, taps, nt, plan, sm, s);
    case wtt::BF16:
      return wtt::modwt_fw_levels<__nv_bfloat16>(B, N, L, x, xsr, xse, out, osb, taps, nt, plan, sm, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// All levels inverse.  xw: (B, N, L+1) with batch stride xsb, row stride
// L+1 and unit element stride; out: (B, N) with row stride osr and unit
// element stride.  taps, plan and smem as for the forward.
int wtt_modwt_inv_levels(int dtype, int B, int N, int L, const void* xw, int64_t xsb,
                         void* out, int64_t osr, const void* taps, int nt, const int* plan,
                         int64_t smem, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto sm = static_cast<size_t>(smem);
  switch (dtype) {
    case wtt::F32:
      return wtt::modwt_inv_levels<float>(B, N, L, xw, xsb, out, osr, taps, nt, plan, sm, s);
    case wtt::F64:
      return wtt::modwt_inv_levels<double>(B, N, L, xw, xsb, out, osr, taps, nt, plan, sm, s);
    case wtt::BF16:
      return wtt::modwt_inv_levels<__nv_bfloat16>(B, N, L, xw, xsb, out, osr, taps, nt, plan, sm, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
