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
// Design: a block takes a tile of up to E_TK output pairs of one row (a
// long row is split into tiles) or several whole rows (short rows, as at
// deep packet depths where rows have 2 samples), loads the tile's input
// window (2 * pairs + span samples per row, wrapped modulo n, coalesced)
// into shared memory in the arithmetic type, and computes its outputs from
// there.  Rows and tiles ride blockIdx.x only (a packet depth can have
// 2^19 rows, beyond gridDim.y's 65535).  Outputs go through caller-given
// planes with their own row strides: the packed array's detail segment,
// or the two halves of each output row for the packet transform.  Tiling
// for TMA is left to later work.

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
template <typename T>
__global__ void __launch_bounds__(E_THREADS)
level1d_inv_kernel(const T* __restrict__ s, int64_t ss, const T* __restrict__ d,
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
int level1d_fw(int B, int n, const void* x, int64_t xs, void* s, int64_t ss,
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

template <typename T>
int level1d_inv(int B, int nh, const void* s, int64_t ss, const void* d,
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
  return launch(level1d_inv_kernel<T>, dim3(static_cast<unsigned>(tl.blocks)),
                dim3(E_THREADS), smem, stream, static_cast<const T*>(s), ss,
                static_cast<const T*>(d), dst, static_cast<T*>(x), xs, B, nh,
                tl.tk, tl.tiles, tl.rpb, offs, static_cast<const A*>(coefs),
                nb[0], nb[1], nb[2], nb[3], smin, span);
}

}  // namespace wtt

extern "C" {

// Forward level.  x: (B, n) with row stride xs; s, d: the (B, n/2) output
// planes with row strides ss, ds (all strides in elements, unit column
// stride).  offs / coefs: the analysis band table on the device, ns
// scaling taps then nd detail taps; dmin is the smallest offset and span
// the largest minus the smallest.  Bands that reach too far for one
// tile's window in shared memory are refused with
// cudaErrorInvalidConfiguration (launch() in common.cuh).
int wtt_level1d_fw(int dtype, int B, int n, const void* x, int64_t xs, void* s,
                   int64_t ss, void* d, int64_t ds, const int* offs,
                   const void* coefs, int ns, int nd, int dmin, int span,
                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case wtt::F32:
      return wtt::level1d_fw<float>(B, n, x, xs, s, ss, d, ds, offs, coefs, ns, nd, dmin, span, st);
    case wtt::F64:
      return wtt::level1d_fw<double>(B, n, x, xs, s, ss, d, ds, offs, coefs, ns, nd, dmin, span, st);
    case wtt::BF16:
      return wtt::level1d_fw<__nv_bfloat16>(B, n, x, xs, s, ss, d, ds, offs, coefs, ns, nd, dmin, span, st);
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
