"""Distributed application layer: sharded best-basis, noise estimation,
denoising, wavelet packets and the MODWT.

The counterpart of ``wavelets_tpu/parallel/apps.py``, on the port's
single-controller meshes (mesh.py):

* ``bestbasistree`` — every shard scatters its local segment-entropy sums
  into the per-depth vector on shard 0's device, where they are summed
  (the JAX package's ``lax.psum``), and the min-prune runs there.  The
  packet levels run per shard where a shard holds whole segments (kernel
  E), and as the 1-D ring level (I in halo mode) over each segment's
  sub-ring of shards where a segment spans several.
* ``noisest`` — the level-L detail-row band of a sharded transform; its
  MAD sample (the stride subsample of ``mad_subsampled``) is gathered from
  the shards onto shard 0's device (the JAX package's ``all_gather``).
* ``denoise`` — noisest -> sharded dwt -> threshold per shard -> sharded
  idwt; ``TI=True`` cycle-spins that pipeline over the shift grid, a roll
  of a sharded array being a fetch of each block's shifted rows.
* ``wpt``/``iwpt`` and ``modwt``/``imodwt`` of a row-sharded signal; the
  MODWT keeps the JAX package's halo -> gather switch.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import modwt as modwt_ops
from ..ops.wpt import iwpt as iwpt_single, packet_level, wpt as wpt_single
from ..threshold.denoise import DEFAULT_WAVELET, VisuShrink, mad_subsampled
from ..threshold.entropy import (Entropy, ShannonEntropy, _coef_terms,
                                 _depth_masks, bestbasistree as _bbt_single,
                                 prune)
from ..threshold.ops import BiggestTH, threshold as _threshold
from ..transforms import _periodic, modwt as modwt_single, \
    imodwt as imodwt_single
from ..utils.indexing import maxmodwttransformlevels, maxtransformlevels
from ..utils.trees import isvalidtree, maketree, treedepth
from ..wt.carriers import DiscreteWavelet, OrthoFilter
from ..ops.level2d import DTYPES
from . import mesh2d, sharded
from .mesh import Mesh, Sharded, make_mesh, move, shard

__all__ = ["bestbasistree", "noisest", "denoise", "wpt", "iwpt",
           "modwt", "imodwt"]


def _place(x, mesh: Mesh, axis_name: str) -> Sharded:
    """``x`` as the drivers take it: a grid on a 2-axis mesh for 2-D and
    3-D arrays, rows over ``axis_name`` (the first axis of a 2-axis mesh)
    otherwise."""
    if len(mesh.axis_names) == 2:
        ndim = len(x.shape) if hasattr(x, "shape") else np.ndim(x)
        return shard(x, mesh, mesh.axis_names if ndim in (2, 3)
                     else mesh.axis_names[:1])
    return shard(x, mesh, (axis_name,))


def _mesh_dwt(v, wt, L: int, mesh: Mesh, axis_name: str, fw: bool):
    """Route a sharded multi-level DWT by mesh rank: 1-axis meshes take
    the ring drivers (sharded.py); 2-axis meshes the grid drivers
    (mesh2d.py) for images and volumes, and the ring over their first
    axis for other ranks."""
    v = _place(v, mesh, axis_name)
    if len(mesh.axis_names) == 2:
        if v.ndim in (2, 3):
            return mesh2d._grid_run(v, wt, int(L), fw)
        axis_name = mesh.axis_names[0]
    return sharded._sharded(v, wt, int(L), mesh, axis_name, fw, v.ndim)


def _dev0(x: Sharded) -> torch.device:
    return next(iter(x.blocks.values())).device


def _global_norm(x: Sharded, device):
    """The l2 norm of a sharded array: the shards' sums of squares, summed
    on ``device``."""
    return torch.sqrt(sum(move(torch.sum(b * b), device)
                          for b in x.blocks.values()))


def _seg_entropies(x: Sharded, et: Entropy, nrm, nseg: int, device):
    """Per-segment entropy sums of a row-sharded signal: each shard's
    partial sums scattered into a (nseg,) vector on ``device`` and summed
    there (entropy.jl:74's reduction, distributed)."""
    n, nd = x.shape[0], len(x.blocks)
    loc, nj = n // nd, n // nseg
    e = torch.zeros(nseg, dtype=x.dtype, device=device)
    for (j,), blk in x.blocks.items():
        terms = _coef_terms(blk, et, move(nrm, blk.device))
        if nj >= loc:
            # the chunk lies inside one segment: one partial sum
            e[j * loc // nj] += move(terms.sum(), device)
        else:
            # whole segments are local: a run of segment sums
            k = loc // nj
            e[j * k:(j + 1) * k] += move(terms.view(k, nj).sum(-1), device)
    return e


def _pow2_mesh(n: int, nd: int) -> bool:
    """Shard chunks nest with the packet segments at every depth iff the
    shard count is a power of two that divides n."""
    return n % nd == 0 and nd & (nd - 1) == 0


def bestbasistree(y, wt: DiscreteWavelet, L: int | None = None,
                  tree: np.ndarray | None = None,
                  et: Entropy = ShannonEntropy(),
                  mesh: Mesh | None = None,
                  axis_name: str = "x") -> np.ndarray:
    """Distributed best-basis search for a row-sharded 1-D signal.

    Matches ``threshold.bestbasistree`` (same prune on the same
    entropies).  On a mesh whose shard count is not a power of two
    dividing the length, the search runs on shard 0's device instead."""
    if mesh is None:
        mesh = make_mesh(axis=axis_name)
    sharded._require_periodic(wt)
    ys = shard(y, mesh, (axis_name,))
    if ys.ndim != 1:
        raise ValueError("bestbasistree expects a 1-D signal")
    n = ys.shape[0]
    dev = _dev0(ys)
    if not _pow2_mesh(n, mesh.shape[axis_name]):
        return _bbt_single(ys.gather(dev), wt, L=L, tree=tree, et=et)
    Lmax = maxtransformlevels(n)
    if tree is None:
        tree = maketree(n, Lmax if L is None else int(L), "full")
    masks = _depth_masks(n, tree, None, Lmax, dev)
    nrm = _global_norm(ys, dev)
    x = ys
    entr_bf = []
    for d in range(Lmax):
        entr_bf.append(_seg_entropies(x, et, nrm, 2 ** d, dev))
        x = _packet_depth(x, wt, d, True)
    entr_af = _seg_entropies(x, et, nrm, 2 ** (Lmax - 1), dev)
    return prune(entr_bf, entr_af, masks)


def _band_sample(y: Sharded, r0: int, r1: int, cap: int, device):
    """The rows [r0, r1) of ``y`` flattened row-major, as the stride
    subsample that ``mad_subsampled`` takes (every element up to ``cap``),
    gathered from the shards that hold them onto ``device``."""
    width = int(np.prod(y.shape[1:], dtype=np.int64))
    count = (r1 - r0) * width
    stride = -(-count // cap) if count > cap else 1
    pos = np.arange(0, count, stride, dtype=np.int64)
    coords = (r0 + pos // width,) + np.unravel_index(pos % width, y.shape[1:])
    out = torch.empty(len(pos), dtype=y.dtype, device=device)
    for idx, blk in y.blocks.items():
        region = y.region(idx)
        inside = np.ones(len(pos), dtype=bool)
        for c, r in zip(coords, region):
            inside &= (c >= r.start) & (c < r.stop)
        if not inside.any():
            continue
        local = tuple(torch.as_tensor(c[inside] - r.start, device=blk.device)
                      for c, r in zip(coords, region))
        out[torch.as_tensor(np.nonzero(inside)[0], device=device)] = \
            move(blk[local], device)
    return out


def noisest(x, wt: DiscreteWavelet | None = DEFAULT_WAVELET, L: int = 1,
            mesh: Mesh | None = None, axis_name: str = "x"):
    """Distributed noise-sigma estimate of a sharded array: MAD of the
    level-L detail-row band / 0.6745 (denoising.jl:94-110; the detail-band
    divergence of ``threshold.noisest``), a 0-d tensor on shard 0's
    device."""
    if mesh is None:
        mesh = make_mesh(axis=axis_name)
    y = _place(x, mesh, axis_name) if wt is None else \
        _mesh_dwt(x, wt, int(L), mesh, axis_name, True)
    m = y.shape[0]
    cap = 1 << 18
    dr = _band_sample(y, m >> L, m >> (L - 1), cap, _dev0(y))
    return mad_subsampled(dr, cap) / 0.6745


def _threshold_sharded(y: Sharded, th, t):
    """Threshold every block; BiggestTH ranks the whole array, so it runs
    on shard 0's device."""
    if isinstance(th, BiggestTH):
        return shard(_threshold(y.gather(_dev0(y)), th, t), y.mesh, y.spec)
    return y.map(lambda b: _threshold(b, th, t))


def _roll(x: Sharded, shift: int, axis: int) -> Sharded:
    """``torch.roll`` of a sharded array along ``axis``: each new block
    fetches its shifted rows (one or two pieces) from the blocks that hold
    them."""
    n = x.shape[axis]
    s = shift % n
    if s == 0:
        return x
    out = x.empty_like()
    for idx, blk in out.blocks.items():
        region = list(x.region(idx))
        a, b = region[axis].start, region[axis].stop
        pieces = []
        lo = (a - s) % n
        while a < b:
            take = min(b - a, n - lo)
            region[axis] = slice(lo, lo + take)
            pieces.append(x.fetch(tuple(region), blk.device))
            a, lo = a + take, 0
        blk.copy_(torch.cat(pieces, dim=axis) if len(pieces) > 1
                  else pieces[0])
    return out


def denoise(x, wt: DiscreteWavelet | None = DEFAULT_WAVELET, *,
            L: int | None = None, dnt=None, TI: bool = False,
            nspin: int | None = None,
            mesh: Mesh | None = None, axis_name: str = "x") -> Sharded:
    """Sharded VisuShrink denoising: sigma (distributed MAD) -> sharded
    dwt -> threshold -> sharded idwt (the denoise stack of
    denoising.jl:22-82 on a mesh).  ``TI=True`` cycle-spins the sharded
    pipeline over an ``nspin``-per-axis shift grid, accumulating a running
    sum."""
    if mesh is None:
        mesh = make_mesh(axis=axis_name)
    x = _place(x, mesh, axis_name)
    if L is None:
        L = min(maxtransformlevels(x), 6)
    if dnt is None:
        dnt = VisuShrink.for_length(x.shape[0])
    t = noisest(x, wt, 1, mesh, axis_name) * dnt.t
    if wt is None:
        if TI:      # as threshold.denoise: no silent non-TI result
            raise ValueError("TI not supported with wt=None")
        return _threshold_sharded(x, dnt.th, t)

    def pipe(v):
        y = _mesh_dwt(v, wt, int(L), mesh, axis_name, True)
        y = _threshold_sharded(y, dnt.th, t)
        return _mesh_dwt(y, wt, int(L), mesh, axis_name, False)

    if not TI:
        return pipe(x)
    if nspin is None:
        nspin = 8
    shifts = [tuple(c) for c in np.ndindex(*(int(nspin),) * x.ndim)]
    acc = x.map(torch.zeros_like)
    for sh in shifts:
        z = x
        for ax, s in enumerate(sh):
            z = _roll(z, s, ax)
        z = pipe(z)
        for ax, s in enumerate(sh):
            z = _roll(z, -s, ax)
        for idx, blk in acc.blocks.items():
            blk += z.blocks[idx]
    return acc.map(lambda b: b / len(shifts))


# --- sharded wavelet packets -------------------------------------------------

def _packet_depth(x: Sharded, wt, d: int, fw: bool, flags=None) -> Sharded:
    """One packet depth of a row-sharded signal over a power-of-two mesh:
    the 2^d segments' level (where ``flags`` is given, the inactive
    segments pass through)."""
    n, nd = x.shape[0], len(x.blocks)
    nseg = 2 ** d
    nj, loc = n // nseg, n // nd
    devs = [x.device_of((j,)) for j in range(nd)]
    out = x.empty_like()
    if nseg >= nd:
        # every shard holds whole segments: one level launch per shard
        for (j,), blk in x.blocks.items():
            segs = blk.view(-1, nj)
            res = packet_level(segs, wt, fw, out.blocks[(j,)].view(-1, nj))
            if flags is not None:
                mine = flags[j * (loc // nj):(j + 1) * (loc // nj)]
                if not mine.all():
                    res.copy_(torch.where(
                        torch.as_tensor(mine, device=blk.device)[:, None],
                        res, segs))
        return out
    # each segment spans k shards: the 1-D ring level over its sub-ring
    k = nd // nseg
    kernel = _periodic(wt) and x.dtype in DTYPES
    halo = sharded._halo_rows(wt)
    for q in range(nseg):
        base = q * nj
        if flags is not None and not flags[q]:
            out.store((base,), x.fetch((slice(base, base + nj),), devs[0]))
            continue
        ring = devs[q * k:(q + 1) * k]
        if not sharded._can_shard(nj, k, halo):
            seg = x.fetch((slice(base, base + nj),), ring[0])
            out.store((base,), packet_level(seg[None], wt, fw)[0])
        elif fw:
            sharded._level_fw_sharded(x, out, (nj,), wt, ring, kernel, base)
        else:
            out.store((base,), x.fetch((slice(base, base + nj),), ring[0]))
            sharded._level_inv_sharded(out, (nj,), wt, ring, kernel, base)
    return out


def _wpt_sharded(x: Sharded, wt, tree, fw: bool) -> Sharded:
    # lifting boundaries apply per segment: the sub-ring level drops the
    # wrap link at the segment's ends, and the per-shard level is the
    # single-device one
    n = x.shape[0]
    tree = np.asarray(tree, dtype=bool)
    if not isvalidtree(n, tree):
        raise ValueError("invalid tree")
    if tree.size == 0 or not tree[0]:
        return x
    if not _pow2_mesh(n, len(x.blocks)):
        # segments straddle shards at every depth: the single-device route
        dev = _dev0(x)
        fn = wpt_single if fw else iwpt_single
        return shard(fn(x.gather(dev), wt, tree), x.mesh, x.spec)
    Lmax = treedepth(tree)
    depths = range(Lmax) if fw else range(Lmax - 1, -1, -1)
    y = x
    for d in depths:
        flags = tree[2 ** d - 1: 2 ** (d + 1) - 1]
        if flags.any():
            y = _packet_depth(y, wt, d, fw, None if flags.all() else flags)
    return y


def _packet_entry(x, wt, tree, L, mesh, axis_name):
    if mesh is None:
        mesh = make_mesh(axis=axis_name)
    x = shard(x, mesh, (axis_name,))
    if x.ndim != 1:
        raise ValueError("the sharded packet transform takes a 1-D signal")
    if tree is None:
        n = x.shape[0]
        tree = maketree(n, maxtransformlevels(n) if L is None else int(L),
                        "full")
    return x, tree


def wpt(x, wt: DiscreteWavelet, tree=None, L: int | None = None,
        mesh: Mesh | None = None, axis_name: str = "x") -> Sharded:
    """Sharded wavelet packet transform of a row-sharded 1-D signal.

    Deep depths (each shard holding whole segments) are shard-local;
    shallow depths (segments spanning shards) run the 1-D ring level over
    each segment's shards.  Matches ``wpt``."""
    x, tree = _packet_entry(x, wt, tree, L, mesh, axis_name)
    return _wpt_sharded(x, wt, tree, True)


def iwpt(y, wt: DiscreteWavelet, tree=None, L: int | None = None,
         mesh: Mesh | None = None, axis_name: str = "x") -> Sharded:
    """Inverse of :func:`wpt`."""
    y, tree = _packet_entry(y, wt, tree, L, mesh, axis_name)
    return _wpt_sharded(y, wt, tree, False)


# --- sharded MODWT -----------------------------------------------------------

def _modwt_gather_frac() -> float:
    """Halo -> gather switch point of the sharded MODWT, as in the JAX
    package: gather when the dilated reach h_need >= frac * shard length
    (1.0, the structural bound, unless WAVELETS_TPU_MODWT_GATHER_FRAC in
    (0, 1] says otherwise; read at call time)."""
    return float(os.environ.get("WAVELETS_TPU_MODWT_GATHER_FRAC", "1.0"))


def _modwt_level(ring, taps_list, dil: int, sign: int):
    """One dilated periodic correlation per taps vector on every shard's
    chunk: with one neighbour's rows while the reach fits a chunk, else
    from the whole band gathered on the shard's device.  Returns one list
    of chunks per taps vector."""
    loc = ring[0].shape[0]
    flen = max(len(t) for t in taps_list)
    h_need = (flen - 1) * dil
    if not h_need >= _modwt_gather_frac() * loc and h_need < loc:
        if sign < 0:     # reads v[t - k dil]: rows of the previous shard
            exts = [torch.cat([h, v]) for h, v in
                    zip(sharded._ring_from_prev(ring, h_need), ring)]
            off = h_need
        else:            # reads v[t + k dil]: rows of the next shard
            exts = [torch.cat([v, h]) for h, v in
                    zip(sharded._ring_from_next(ring, h_need), ring)]
            off = 0
        outs = []
        for taps in taps_list:
            res = []
            for ext in exts:
                acc = None
                for k, c in enumerate(taps):
                    start = off - k * dil if sign < 0 else off + k * dil
                    term = float(c) * ext[start: start + loc]
                    acc = term if acc is None else acc + term
                res.append(acc)
            outs.append(res)
        return outs
    # the reach spans shards: gather the band, compute the local window
    outs = [[] for _ in taps_list]
    for j, v in enumerate(ring):
        full = torch.cat([move(u, v.device) for u in ring])
        for o, taps in zip(outs, taps_list):
            o.append(modwt_ops._dilated_corr(full, taps, dil, sign)
                     [j * loc:(j + 1) * loc])
    return outs


def _modwt_entry(x, mesh, axis_name):
    if mesh is None:
        mesh = make_mesh(axis=axis_name)
    return shard(x, mesh, (axis_name,)), mesh


def modwt(x, wt: OrthoFilter, L: int | None = None,
          mesh: Mesh | None = None, axis_name: str = "x") -> Sharded:
    """Sharded MODWT of a row-sharded 1-D signal -> ``(N, L+1)`` sharded on
    its first axis (the layout of ``modwt``)."""
    xs, mesh = _modwt_entry(x, mesh, axis_name)
    if xs.ndim != 1:
        raise ValueError("the sharded MODWT takes a 1-D signal")
    N, nd = xs.shape[0], mesh.shape[axis_name]
    L = maxmodwttransformlevels(N) if L is None else int(L)
    if L < 1 or 2 ** L > N:
        # validated for every mesh size, as the single-device path does
        raise ValueError("too many transform levels (N < 2^L)"
                         if L >= 1 else "L must be >= 1")
    if nd == 1 or N % nd:
        # one shard (or chunks of unequal length): the single-device route
        return shard(modwt_single(xs.gather(_dev0(xs)), wt, L), mesh,
                     (axis_name,))
    g, h = modwt_ops.modwt_filter_pair(wt)
    v = [xs.blocks[(j,)] for j in range(nd)]
    cols = []
    for j in range(1, L + 1):
        w1, v = _modwt_level(v, [h, g], 2 ** (j - 1), -1)
        cols.append(w1)
    cols.append(v)
    out = Sharded((N, L + 1), mesh, (axis_name, None),
                  (xs.splits[0], (0, L + 1)), {})
    for j in range(nd):
        out.blocks[(j,)] = torch.stack([c[j] for c in cols], dim=-1)
    return out


def imodwt(xw, wt: OrthoFilter, mesh: Mesh | None = None,
           axis_name: str = "x") -> Sharded:
    """Inverse of :func:`modwt` for a row-sharded ``(N, L+1)`` array."""
    xs, mesh = _modwt_entry(xw, mesh, axis_name)
    N, nd = xs.shape[0], mesh.shape[axis_name]
    L = xs.shape[-1] - 1
    if nd == 1 or N % nd:
        return shard(imodwt_single(xs.gather(_dev0(xs)), wt), mesh,
                     (axis_name,))
    g, h = modwt_ops.modwt_filter_pair(wt)
    blocks = [xs.blocks[(j,)] for j in range(nd)]
    v = [b[:, L] for b in blocks]
    for j in range(L, 0, -1):
        (tw,) = _modwt_level([b[:, j - 1] for b in blocks], [h],
                             2 ** (j - 1), +1)
        (tv,) = _modwt_level(v, [g], 2 ** (j - 1), +1)
        v = [a + b for a, b in zip(tw, tv)]
    return Sharded((N,), mesh, (axis_name,), (xs.splits[0],),
                   {(j,): v[j] for j in range(nd)})
