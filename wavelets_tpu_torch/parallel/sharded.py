"""Sharded multi-level transforms over a ring of torch devices.

The counterpart of ``wavelets_tpu/parallel/sharded.py``, single-controller
like it: one process drives every shard of a :class:`mesh.Mesh`.

* Arrays are sharded by rows (axis 0) over one mesh axis; the transform
  along every other axis is local to a shard.
* The transform along axis 0 needs only a few rows of each ring
  neighbour: :func:`_ring_from_prev` / :func:`_ring_from_next` hand each
  shard its neighbours' edge rows (a view on the same device, an
  event-ordered copy across devices; ``wrap=False`` gives zeros, as
  ``lax.ppermute`` does).
* Per level the active band ``y[:m >> l]`` is cut into ``nd`` equal
  row-chunks, one per shard (:meth:`mesh.Sharded.fetch`), the level body
  runs per chunk, and each chunk's scaling and detail halves are written
  where the packed layout puts them: every shard stays busy at every
  level, as GSPMD's re-sharding does in the JAX package.  Reads of a level
  all come before its writes, so on one device, in one stream, the level
  runs in place.
* A band too small to shard (:func:`_can_shard`), or past the cost
  model's switch level, takes one level of the single-device route on
  shard 0's device, and is written back.

Level body, for a periodic wavelet with float32, float64 or bfloat16 data
(the kernel route): kernel E along the last axis (and kernel I along the
middle one of a volume), then kernel I in halo mode along axis 0 with the
neighbours' rows, straight into the packed output; the inverse runs J in
halo mode, then I's inverse J along the middle axis of a volume and F
along the last.  Otherwise (the lifting boundaries zeropad and symmetric,
other dtypes) the torch formulations below: zeropad is the ring without
its wrap link, symmetric a flip of the edge shards' own rows.  Outputs are
:class:`mesh.Sharded` arrays in the single-device packed layout.
"""

from __future__ import annotations

import os
from math import prod

import torch

from ..ops import axis0, filter_fb, level1d
from ..ops.level2d import DTYPES
from ..ops.wpt import _engine_level
from ..transforms import _check_levels, _periodic, _transform
from ..utils.indexing import maxtransformlevels
from ..wt.carriers import OrthoFilter
from ..wt.schemes import PREDICT
from .costmodel import SCENARIOS, tail_switch_level
from .mesh import Mesh, Sharded, make_mesh, move, shard

__all__ = ["make_mesh", "dwt1", "idwt1", "dwt2", "idwt2", "dwt3", "idwt3",
           "shard_rows", "tail_switch_for", "STATS"]

# levels run sharded and through the global fallback, and the inverse's
# copy of its input (it writes each level's active block in place)
STATS = {"sharded_levels": 0, "fallback_levels": 0, "clones": 0}


def shard_rows(x, mesh: Mesh, axis: str = "x") -> Sharded:
    """Place ``x`` row-sharded over the mesh axis ``axis``."""
    return shard(x, mesh, (axis,))


def _ring_from_next(ring, rows, wrap=True):
    """Each block receives the *next* block's first ``rows`` rows, on its
    own device.  ``wrap=False`` drops the ring's wrap link: the LAST block
    then receives zeros (``lax.ppermute`` semantics) — exactly the
    "zeropad" boundary extension."""
    nd = len(ring)
    out = []
    for j, blk in enumerate(ring):
        if not wrap and j == nd - 1:
            out.append(torch.zeros_like(blk[:rows]))
        else:
            out.append(move(ring[(j + 1) % nd][:rows], blk.device))
    return out


def _ring_from_prev(ring, rows, wrap=True):
    """Each block receives the *previous* block's last ``rows`` rows.
    ``wrap=False``: the FIRST block receives zeros."""
    nd = len(ring)
    out = []
    for j, blk in enumerate(ring):
        if not wrap and j == 0:
            out.append(torch.zeros_like(blk[:rows]))
        else:
            src = ring[j - 1]
            out.append(move(src[src.shape[0] - rows:], blk.device))
    return out


# --- the kernel route: E/F on the local axes, I/J in halo mode on axis 0 ----

def _as_rows(t):
    """A chunk ``(c, *rest)`` as the axis-0 kernels' ``(B, R = c, C)``:
    ``(1, c, 1)`` for a signal, ``(1, c, n)`` for an image and the
    permuted ``(m, c, n)`` for a volume, all views."""
    if t.dim() == 1:
        return t[None, :, None]
    if t.dim() == 2:
        return t[None]
    return t.permute(1, 0, 2)


def _flat_rows(t):
    """``t (c, m, n)`` as ``(c m, n)`` rows where one row stride allows
    (a view), else None; ``t`` itself when 2-D."""
    if t.dim() == 2:
        return t
    if t.shape[0] == 1 or t.stride(0) == t.shape[1] * t.stride(1):
        return t.view(-1, t.shape[-1])
    return None


def _local_fw_kernel(chunk, wt):
    """The local axes of one chunk, last then middle: kernel E into a new
    tensor, then kernel I along the middle axis of a volume."""
    if chunk.dim() == 1:
        return chunk
    n = chunk.shape[-1]
    out = torch.empty(chunk.shape, dtype=chunk.dtype, device=chunk.device)
    rows = out.view(-1, n)
    level1d.level1d_fw(chunk.reshape(-1, n), wt, rows[:, : n // 2],
                       rows[:, n // 2:])
    if chunk.dim() == 2:
        return out
    m = out.shape[1]
    mid = torch.empty_like(out)
    axis0.axis0_fw(out, wt, mid[:, : m // 2], mid[:, m // 2:])
    return mid


def _local_inv_kernel(col, wt, rows):
    """Inverse of :func:`_local_fw_kernel` from ``col`` into the ``(B, n)``
    rows ``rows`` (a view of the destination): kernel J along the middle
    axis of a volume, then F along the last."""
    if col.dim() == 3:
        m = col.shape[1]
        mid = torch.empty_like(col)
        axis0.axis0_inv(col[:, : m // 2], col[:, m // 2:], wt, out=mid)
        col = mid
    n = col.shape[-1]
    flat = col.reshape(-1, n)
    level1d.level1d_inv(flat[:, : n // 2], flat[:, n // 2:], wt, out=rows)


# --- the torch formulations along the sharded axis ---------------------------

def _split_rows(ext):
    """(even-indexed rows, odd-indexed rows) of ``ext`` along axis 0."""
    r = ext.shape[0]
    if r % 2:
        ext = torch.cat([ext, torch.zeros_like(ext[:1])])
        r += 1
    p = ext.reshape(r // 2, 2, *ext.shape[1:])
    return p[:, 0], p[:, 1]


def _filter_axis0_fw(ring, h, g):
    """One forward filter level along axis 0 of the ring's chunks with
    ring halos: the (a, d) chunks of each shard."""
    flen = len(h)
    wrap = flen - 2
    r = ring[0].shape[0]
    if wrap > 0:
        below = _ring_from_next(ring, min(wrap, r))
        above = _ring_from_prev(ring, min(wrap, r))
        exts = [torch.cat([a, x, b]) for a, x, b in zip(above, ring, below)]
    else:
        exts = ring
    gr = g[::-1]
    tops, bots = [], []
    for ext in exts:
        E, O = _split_rows(ext)

        def s2(a, cnt):
            src = E if a % 2 == 0 else O
            return src[a // 2: a // 2 + cnt]

        a0 = float(h[0]) * s2(wrap, r // 2)
        d0 = float(gr[0]) * s2(0, r // 2)
        for m in range(1, flen):
            a0 = a0 + float(h[m]) * s2(wrap + m, r // 2)
            d0 = d0 + float(gr[m]) * s2(m, r // 2)
        tops.append(a0)
        bots.append(d0)
    return tops, bots


def _upsample0(v):
    return torch.stack([v, torch.zeros_like(v)], 1).reshape(
        v.shape[0] * 2, *v.shape[1:])


def _filter_axis0_inv(a_ring, d_ring, h, g):
    """Inverse filter level along axis 0 -> each shard's merged rows."""
    flen = len(h)
    fa = bd = (flen - 1) // 2      # scaling halo from prev, detail from next
    hl = a_ring[0].shape[0]
    if fa > 0:
        a_ring = [torch.cat([p, a]) for p, a in
                  zip(_ring_from_prev(a_ring, min(fa, hl)), a_ring)]
    if bd > 0:
        d_ring = [torch.cat([d, q]) for d, q in
                  zip(d_ring, _ring_from_next(d_ring, min(bd, hl)))]
    zpad = (flen - 1) - 2 * fa     # 0 or 1
    hr = h[::-1]
    r = 2 * hl
    cols = []
    for a_ext, d_ext in zip(a_ring, d_ring):
        ue = _upsample0(a_ext)
        if zpad:
            ue = torch.cat([torch.zeros_like(ue[:zpad]), ue])
        we = _upsample0(d_ext)
        we = torch.cat([torch.zeros_like(we[:1]), we])
        col = float(hr[0]) * ue[0:r] + float(g[0]) * we[0:r]
        for m in range(1, flen):
            col = col + float(hr[m]) * ue[m: m + r]
            col = col + float(g[m]) * we[m: m + r]
        cols.append(col)
    return cols


def _lift_steps_axis0(s, d, scheme, fw):
    """The scheme's steps along the sharded axis 0 of the rings ``s`` and
    ``d`` (lists of the shards' halves), with ring halos per step.

    Non-periodic boundaries map onto the ring exactly as on one device
    (ops/lifting._fix_edges): "zeropad" drops the ring's wrap link (the
    end shards receive zeros, which IS the extension) and "symmetric"
    (half-sample, ext[-j] = src[j-1]) gives the end shards their own
    reflected edge rows."""
    steps = scheme.steps if fw else scheme.steps[::-1]
    sign = -1.0 if fw else 1.0
    bd = getattr(scheme, "boundary", "periodic")
    wrap = bd == "periodic"

    def stencil(src, coef, shift):
        # result[i] = sum_k coef[k] * src_ext[i + k - shift]  (global rows)
        offs = [k - shift for k in range(len(coef))]
        front = max(0, -min(offs))
        back = max(0, max(offs))
        rloc = src[0].shape[0]
        exts = [[x] for x in src]
        if front > 0:
            f = min(front, rloc)
            above = _ring_from_prev(src, f, wrap)
            if bd == "symmetric":
                above[0] = torch.flip(src[0][:f], (0,))
            for e, a in zip(exts, above):
                e.insert(0, a)
        if back > 0:
            b = min(back, rloc)
            below = _ring_from_next(src, b, wrap)
            if bd == "symmetric":
                below[-1] = torch.flip(src[-1][rloc - b:], (0,))
            for e, b_ in zip(exts, below):
                e.append(b_)
        out = []
        for parts in exts:
            ext = torch.cat(parts) if len(parts) > 1 else parts[0]
            acc = None
            for k, c in enumerate(coef):
                lo = front + offs[k]
                term = c * ext[lo: lo + rloc]
                acc = term if acc is None else acc + term
            out.append(acc)
        return out

    for step in steps:
        if step.kind == PREDICT:
            s = [x + sign * t for x, t in
                 zip(s, stencil(d, step.coef, step.shift))]
        else:
            d = [x + sign * t for x, t in
                 zip(d, stencil(s, step.coef, step.shift))]
    return s, d


def _lifting_axis0_fw(ring, scheme):
    """One forward lifting level along axis 0: even/odd split (even local
    rows keep the global parity), halo'd steps, norms."""
    halves = [_split_rows(x) for x in ring]
    s, d = _lift_steps_axis0([h[0] for h in halves], [h[1] for h in halves],
                             scheme, True)
    return ([x * scheme.norm1 for x in s], [x * scheme.norm2 for x in d])


def _lifting_axis0_inv(a_ring, d_ring, scheme):
    s = [a * (1.0 / scheme.norm1) for a in a_ring]
    d = [x * (1.0 / scheme.norm2) for x in d_ring]
    s, d = _lift_steps_axis0(s, d, scheme, False)
    return [torch.stack([a, b], 1).reshape(a.shape[0] * 2, *a.shape[1:])
            for a, b in zip(s, d)]


def _axis0_fw_torch(ring, wt):
    if isinstance(wt, OrthoFilter):
        return _filter_axis0_fw(ring, *filter_fb.filter_pair(wt))
    return _lifting_axis0_fw(ring, wt)


def _axis0_inv_torch(a_ring, d_ring, wt):
    if isinstance(wt, OrthoFilter):
        return _filter_axis0_inv(a_ring, d_ring, *filter_fb.filter_pair(wt))
    return _lifting_axis0_inv(a_ring, d_ring, wt)


def _local_axes_fw(blk, wt):
    """Every local axis (last to first; axis 0 is the sharded one) with
    the torch engines' periodic or boundary-aware level."""
    for axis in range(-1, -blk.dim(), -1):
        blk = torch.movedim(_engine_level(torch.movedim(blk, axis, -1), wt,
                                          True), -1, axis)
    return blk


def _local_axes_inv(blk, wt):
    for axis in range(-(blk.dim() - 1), 0):
        blk = torch.movedim(_engine_level(torch.movedim(blk, axis, -1), wt,
                                          False), -1, axis)
    return blk


# --- one level ---------------------------------------------------------------

def _level_fw_sharded(src, y, sub, wt, devs, kernel, base=0):
    """One forward level of the active block ``src[base:base + sub[0],
    :sub[1], ...]`` into ``y``'s packed places there, one row-chunk per
    ring device."""
    nd = len(devs)
    ma, c = sub[0], sub[0] // nd
    rest = tuple(slice(0, s) for s in sub[1:])
    chunks = [src.fetch((slice(base + j * c, base + (j + 1) * c),) + rest,
                        devs[j]) for j in range(nd)]
    tops = [(slice(base + j * c // 2, base + (j + 1) * c // 2),) + rest
            for j in range(nd)]
    bots = [(slice(base + ma // 2 + j * c // 2,
                   base + ma // 2 + (j + 1) * c // 2),) + rest
            for j in range(nd)]
    if not kernel:
        outs = _axis0_fw_torch([_local_axes_fw(ch, wt) for ch in chunks], wt)
        for regions, parts in zip((tops, bots), outs):
            for reg, part in zip(regions, parts):
                y.store(tuple(r.start for r in reg), part)
        return
    if src is y and len(sub) == 1:
        # a signal has no local axes: the chunks are views of y itself,
        # which the halo level below writes
        chunks = [ch.clone() for ch in chunks]
    rowts = [_local_fw_kernel(ch, wt) for ch in chunks]
    above = _ring_from_prev(rowts, axis0.halo_reach(wt, False)[0])
    below = _ring_from_next(rowts, axis0.halo_reach(wt, False)[1])
    for j in range(nd):
        dests = []
        for reg in (tops[j], bots[j]):
            view = y.view(reg, devs[j])
            dests.append(view if view is not None else torch.empty(
                [r.stop - r.start for r in reg], dtype=y.dtype,
                device=devs[j]))
        axis0.axis0_fw(_as_rows(rowts[j]), wt, *map(_as_rows, dests),
                       above=_as_rows(above[j]), below=_as_rows(below[j]))
        for reg, dest in zip((tops[j], bots[j]), dests):
            y.store(tuple(r.start for r in reg), dest)


def _level_inv_sharded(y, sub, wt, devs, kernel, base=0):
    """One inverse level of ``y[base:base + sub[0], :sub[1], ...]``, in
    place, one row-chunk per ring device: every read of the level comes
    before its first write."""
    nd = len(devs)
    ma, c = sub[0], sub[0] // nd
    h = c // 2
    rest = tuple(slice(0, s) for s in sub[1:])
    a_ring = [y.fetch((slice(base + j * h, base + (j + 1) * h),) + rest,
                      devs[j]) for j in range(nd)]
    d_ring = [y.fetch((slice(base + ma // 2 + j * h,
                             base + ma // 2 + (j + 1) * h),) + rest, devs[j])
              for j in range(nd)]
    starts = [(base + j * c,) + (0,) * len(rest) for j in range(nd)]
    if not kernel:
        cols = _axis0_inv_torch(a_ring, d_ring, wt)
        for st, col in zip(starts, cols):
            y.store(st, _local_axes_inv(col, wt))
        return
    ia, ib = axis0.halo_reach(wt, True)
    halos = list(zip(_ring_from_prev(a_ring, ia), _ring_from_next(a_ring, ib),
                     _ring_from_prev(d_ring, ia), _ring_from_next(d_ring, ib)))
    cols = []
    for j in range(nd):
        col = torch.empty((c,) + tuple(sub[1:]), dtype=y.dtype,
                          device=devs[j])
        axis0.axis0_inv(_as_rows(a_ring[j]), _as_rows(d_ring[j]), wt,
                        out=_as_rows(col),
                        halos=tuple(map(_as_rows, halos[j])))
        cols.append(col)
    for j, (st, col) in enumerate(zip(starts, cols)):
        if col.dim() == 1:
            y.store(st, col)
            continue
        dest = y.view((slice(base + j * c, base + (j + 1) * c),) + rest,
                      devs[j])
        rows = _flat_rows(dest) if dest is not None else None
        if rows is None:
            dest = torch.empty_like(col)
            rows = _flat_rows(dest)
        _local_inv_kernel(col, wt, rows)
        y.store(st, dest)


def _level_global(src, dst, sub, wt, fw, device):
    """Fallback: one level of the single-device route (the kernels on a
    CUDA device) on the whole active block, gathered on ``device``."""
    region = tuple(slice(0, s) for s in sub)
    active = src.fetch(region, device)
    dst.store((0,) * len(sub), _transform(active, wt, 1, len(sub), fw))


# --- public drivers ---------------------------------------------------------

def _can_shard(m_active: int, nd: int, halo: int) -> bool:
    m_loc = m_active // nd
    return (m_active % (2 * nd) == 0) and m_loc >= max(2, halo)


def _halo_rows(wt) -> int:
    """Minimum local rows per shard for the one-neighbour ring exchange.

    The JAX package's gate: filters need flen-2 rows of each neighbour on
    the full-resolution rows; lifting steps run on the split halves, so
    one neighbour covers a step's reach only when m_loc >= 2 * reach.  The
    halo kernels here take the composed bands' reach in one exchange
    (``axis0.halo_reach``: forward on the chunk's rows, inverse on its
    halves), which some factored schemes (sym5, db8-db10, sym9, coif8 and
    vaid as lifting) carry beyond that gate; the larger of the two
    holds."""
    if isinstance(wt, OrthoFilter):
        h = max(len(wt.qmf) - 1, 1)
    else:
        h = 1
        for st in wt.steps:
            h = max(h, abs(st.shift), len(st.coef))
        h *= 2
    fa, fb = axis0.halo_reach(wt, False)
    ia, ib = axis0.halo_reach(wt, True)
    return max(h, fa, fb, 2 * ia, 2 * ib)


def tail_switch_for(shape, dtype, wt, nd, L) -> int:
    """Deep-tail switch level for a ``shape`` rows-sharded transform: the
    WAVELETS_TPU_SHARD_TAIL_LEVEL override, else the α-β cost model under
    the WAVELETS_TPU_SHARD_SCENARIO preset, both read at call time."""
    ov = os.environ.get("WAVELETS_TPU_SHARD_TAIL_LEVEL")
    if ov is not None:
        return int(ov)
    sc = SCENARIOS.get(os.environ.get("WAVELETS_TPU_SHARD_SCENARIO", "ici"),
                       SCENARIOS["ici"])
    itemsize = torch.empty((), dtype=dtype).element_size()
    return tail_switch_level(shape[0], max(1, prod(shape[1:])), itemsize,
                             _halo_rows(wt), nd, L, sc)


def _ring(x: Sharded, axis_name: str):
    """The ring's devices: the blocks of ``x`` along ``axis_name``."""
    return [x.device_of((j,)) for j in range(x.mesh.shape[axis_name])]


def _dwt_sharded(x: Sharded, wt, L: int, axis_name: str, fw: bool,
                 tail: int) -> Sharded:
    """The N-D driver: axis 0 sharded over the mesh ring, the other axes
    local; ``tail`` is the deep-tail switch level (tail_switch_for)."""
    devs = _ring(x, axis_name)
    nd = len(devs)
    rank = x.ndim
    if nd == 1:
        # one shard has no ring: the single-device route, exactly
        out = _transform(x.gather(devs[0]), wt, L, rank, fw)
        return shard(out, x.mesh, x.spec)
    if L == 0:
        return x.map(torch.clone)
    halo = _halo_rows(wt)
    kernel = _periodic(wt) and x.dtype in DTYPES
    shape = x.shape
    if fw:
        y, src = x.empty_like(), x
        for l in range(L):
            sub = tuple(s >> l for s in shape)
            if l + 1 < tail and _can_shard(sub[0], nd, halo):
                _level_fw_sharded(src, y, sub, wt, devs, kernel)
                STATS["sharded_levels"] += 1
            else:
                _level_global(src, y, sub, wt, True, devs[0])
                STATS["fallback_levels"] += 1
            src = y
        return y
    y = x.map(torch.clone)
    STATS["clones"] += 1
    for l in range(L, 0, -1):
        sub = tuple(s >> (l - 1) for s in shape)
        if l < tail and _can_shard(sub[0], nd, halo):
            _level_inv_sharded(y, sub, wt, devs, kernel)
            STATS["sharded_levels"] += 1
        else:
            _level_global(y, y, sub, wt, False, devs[0])
            STATS["fallback_levels"] += 1
    return y


def _require_periodic(wt):
    if getattr(wt, "boundary", "periodic") != "periodic":
        raise NotImplementedError(
            "this sharded driver implements the periodic boundary only; "
            "sharded.dwt2/idwt2/dwt3/idwt3 support zeropad/symmetric for "
            "the lifting engine")


def _sharded(x, wt, L, mesh, axis_name, fw, rank):
    if mesh is None:
        mesh = make_mesh(axis=axis_name)
    # integer input promotes before the levels (shard does it), and L is
    # validated as the single-device API validates it
    x = shard_rows(x, mesh, axis_name)
    if L is None:
        L = maxtransformlevels(x)
    if x.ndim != rank:
        raise ValueError(f"expected rank-{rank} input, got shape {x.shape}")
    _check_levels(x, int(L), rank)
    tail = tail_switch_for(x.shape, x.dtype, wt, mesh.shape[axis_name],
                           int(L))
    return _dwt_sharded(x, wt, int(L), axis_name, fw, tail)


def dwt1(x, wt, L: int | None = None, mesh: Mesh | None = None,
         axis_name: str = "x") -> Sharded:
    """Sharded 1-D forward DWT of a long signal, packed layout.

    The signal is sharded as contiguous chunks over the mesh ring; each
    level's stencil needs only a few samples of the ring neighbours, so
    the N-D driver applies with rank 1 (no local axes; the halo kernels
    run with B = C = 1).  Lifting boundaries map onto the ring exactly as
    in 2-D/3-D.  Deep levels whose band is smaller than the mesh take the
    single-device route."""
    return _sharded(x, wt, L, mesh, axis_name, True, 1)


def idwt1(y, wt, L: int | None = None, mesh: Mesh | None = None,
          axis_name: str = "x") -> Sharded:
    """Inverse of :func:`dwt1`."""
    return _sharded(y, wt, L, mesh, axis_name, False, 1)


def dwt2(x, wt, L: int | None = None, mesh: Mesh | None = None,
         axis_name: str = "x") -> Sharded:
    """Sharded 2-D forward DWT (filter or lifting), packed layout.

    ``x`` — a Sharded array (see :func:`shard_rows`), a tensor or an
    array-like, row-sharded over ``mesh``'s ``axis_name`` on entry; the
    result carries the same sharding."""
    return _sharded(x, wt, L, mesh, axis_name, True, 2)


def idwt2(y, wt, L: int | None = None, mesh: Mesh | None = None,
          axis_name: str = "x") -> Sharded:
    """Inverse of :func:`dwt2`."""
    return _sharded(y, wt, L, mesh, axis_name, False, 2)


def dwt3(x, wt, L: int | None = None, mesh: Mesh | None = None,
         axis_name: str = "x") -> Sharded:
    """Sharded 3-D forward DWT: the leading (plane) axis sharded over the
    mesh ring, rows and columns local per shard."""
    return _sharded(x, wt, L, mesh, axis_name, True, 3)


def idwt3(y, wt, L: int | None = None, mesh: Mesh | None = None,
          axis_name: str = "x") -> Sharded:
    """Inverse of :func:`dwt3`."""
    return _sharded(y, wt, L, mesh, axis_name, False, 3)
