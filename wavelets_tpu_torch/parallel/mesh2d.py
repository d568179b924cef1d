"""2-axis mesh sharding: images cut into blocks over a grid of devices.

The counterpart of ``wavelets_tpu/parallel/mesh2d.py``.  Both image axes
are sharded (P('x', 'y')), so both directions of each separable level need
the ring neighbours' rows: each is a ring exchange over its mesh axis.  As
in the JAX package, both directions run the torch formulations of the
axis-0 level (sharded.py: ``_filter_axis0_fw`` / ``_lifting_axis0_fw`` and
their inverses, every lifting boundary included); the lane direction runs
them on the transposed block (a view, no communication).  Routing that
direction through a transposed copy and kernels I/J in halo mode is later
work.

Per level the four quadrant blocks of every device are written where the
packed layout puts them, and the shrinking active band is cut anew into
the grid, exactly like the 1-axis driver.  Volumes are sharded
P('x', 'y', None): planes and rows over the grid, columns local.
"""

from __future__ import annotations

import torch

from ..ops.wpt import _engine_level
from ..transforms import _check_levels
from ..utils.indexing import maxtransformlevels
from .mesh import Mesh, Sharded, make_mesh2d, shard
from .sharded import (STATS, _axis0_fw_torch, _axis0_inv_torch, _can_shard,
                      _halo_rows, _level_global)

__all__ = ["make_mesh2d", "shard_grid", "dwt2", "idwt2", "dwt3", "idwt3",
           "shard_grid3"]


def shard_grid(x, mesh: Mesh) -> Sharded:
    """Place a 2-D array block-sharded over both mesh axes."""
    return shard(x, mesh, mesh.axis_names)


def shard_grid3(x, mesh: Mesh) -> Sharded:
    """Place a 3-D array block-sharded over both mesh axes (last axis
    local)."""
    return shard(x, mesh, mesh.axis_names + (None,))


def _t(v):
    return v.transpose(0, 1)


class _Grid:
    """The active band ``sub`` of a grid-sharded array, cut into equal
    blocks, one per mesh device."""

    def __init__(self, mesh: Mesh, sub):
        self.nx, self.ny = mesh.devices.shape
        self.mesh = mesh
        self.sub = sub
        self.cm, self.cn = sub[0] // self.nx, sub[1] // self.ny

    def cells(self):
        return [(i, k) for i in range(self.nx) for k in range(self.ny)]

    def fetch(self, src: Sharded, start=(0, 0, 0), size=None):
        """Every device's block of ``src``: the cell's ``size`` (the block
        size by default) rows x cols (x the local axis), from ``start``."""
        size = size or (self.cm, self.cn) + tuple(self.sub[2:])
        return {(i, k): src.fetch(
            (slice(start[0] + i * size[0], start[0] + (i + 1) * size[0]),
             slice(start[1] + k * size[1], start[1] + (k + 1) * size[1]))
            + tuple(slice(start[2], start[2] + p) for p in size[2:]),
            self.mesh.device((i, k))) for i, k in self.cells()}

    def along_x(self, fn, *inputs):
        """``fn(*rings)`` over each grid column (the 'x' ring), where
        ``rings[q]`` is ``inputs[q]``'s blocks down the column; one dict
        per list that ``fn`` returns."""
        outs = None
        for k in range(self.ny):
            res = fn(*[[inp[(i, k)] for i in range(self.nx)]
                       for inp in inputs])
            outs = outs or [{} for _ in res]
            for o, lst in zip(outs, res):
                for i, v in enumerate(lst):
                    o[(i, k)] = v
        return outs

    def along_y(self, fn, *inputs):
        """``fn(*rings)`` over each grid row (the 'y' ring) of the
        transposed blocks; the results transposed back."""
        outs = None
        for i in range(self.nx):
            res = fn(*[[_t(inp[(i, k)]) for k in range(self.ny)]
                       for inp in inputs])
            outs = outs or [{} for _ in res]
            for o, lst in zip(outs, res):
                for k, v in enumerate(lst):
                    o[(i, k)] = _t(v)
        return outs


def _fw2(src, y, g: _Grid, wt):
    """One forward 2-D level: along the rows (the 'y' ring), then along
    the columns ('x')."""
    def fw(r):
        return _axis0_fw_torch(r, wt)

    left, right = g.along_y(fw, g.fetch(src))
    ll, hl = g.along_x(fw, left)
    lh, hh = g.along_x(fw, right)
    mh, nh = g.sub[0] // 2, g.sub[1] // 2
    for (i, k) in g.cells():
        r, c = i * g.cm // 2, k * g.cn // 2
        for q, r0, c0 in ((ll, 0, 0), (lh, 0, nh), (hl, mh, 0), (hh, mh, nh)):
            y.store((r0 + r, c0 + c), q[(i, k)])


def _inv(wt):
    return lambda a, d: (_axis0_inv_torch(a, d, wt),)


def _inv2(y, g: _Grid, wt):
    """One inverse 2-D level, in place: columns, then rows."""
    mh, nh = g.sub[0] // 2, g.sub[1] // 2
    size = (g.cm // 2, g.cn // 2)
    ll, lh = g.fetch(y, (0, 0), size), g.fetch(y, (0, nh), size)
    hl, hh = g.fetch(y, (mh, 0), size), g.fetch(y, (mh, nh), size)
    (left,) = g.along_x(_inv(wt), ll, hl)
    (right,) = g.along_x(_inv(wt), lh, hh)
    (out,) = g.along_y(_inv(wt), left, right)
    for (i, k) in g.cells():
        y.store((i * g.cm, k * g.cn), out[(i, k)])


def _fw3(src, y, g: _Grid, wt):
    """One forward 3-D level: the local last axis, then axis 1 over the
    'y' ring, then axis 0 over 'x' (the reference's planes, rows, columns
    order)."""
    def fw(r):
        return _axis0_fw_torch(r, wt)

    p2 = g.sub[2] // 2
    v = {c: _engine_level(b, wt, True) for c, b in g.fetch(src).items()}
    mh, nh = g.sub[0] // 2, g.sub[1] // 2
    for k1 in range(2):                     # axis 2: s, d
        part = {c: b[..., k1 * p2:(k1 + 1) * p2] for c, b in v.items()}
        for k2, q in enumerate(g.along_y(fw, part)):         # axis 1: a, d
            for k3, o in enumerate(g.along_x(fw, q)):        # axis 0: a, d
                for (i, k) in g.cells():
                    y.store((k3 * mh + i * g.cm // 2, k2 * nh + k * g.cn // 2,
                             k1 * p2), o[(i, k)])


def _inv3(y, g: _Grid, wt):
    """One inverse 3-D level, in place: axis 0, then axis 1, then the
    local last axis."""
    mh, nh, p2 = g.sub[0] // 2, g.sub[1] // 2, g.sub[2] // 2
    size = (g.cm // 2, g.cn // 2, p2)
    halves = []
    for k1 in range(2):
        ax1 = []
        for k2 in range(2):
            a0 = g.fetch(y, (0, k2 * nh, k1 * p2), size)
            d0 = g.fetch(y, (mh, k2 * nh, k1 * p2), size)
            ax1 += g.along_x(_inv(wt), a0, d0)
        halves += g.along_y(_inv(wt), *ax1)
    for (i, k) in g.cells():
        packed = torch.cat([halves[0][(i, k)], halves[1][(i, k)]], dim=2)
        y.store((i * g.cm, k * g.cn, 0), _engine_level(packed, wt, False))


def _grid_run(x: Sharded, wt, L: int, fw: bool) -> Sharded:
    mesh = x.mesh
    nx, ny = mesh.devices.shape
    halo = _halo_rows(wt)
    dev0 = mesh.device((0, 0))
    fw_level, inv_level = (_fw2, _inv2) if x.ndim == 2 else (_fw3, _inv3)
    shape = x.shape

    def can(sub):
        return _can_shard(sub[0], nx, halo) and _can_shard(sub[1], ny, halo)

    if L == 0:
        return x.map(torch.clone)
    if fw:
        y, src = x.empty_like(), x
        for l in range(L):
            sub = tuple(s >> l for s in shape)
            if can(sub):
                fw_level(src, y, _Grid(mesh, sub), wt)
                STATS["sharded_levels"] += 1
            else:
                _level_global(src, y, sub, wt, True, dev0)
                STATS["fallback_levels"] += 1
            src = y
        return y
    y = x.map(torch.clone)
    STATS["clones"] += 1
    for l in range(L, 0, -1):
        sub = tuple(s >> (l - 1) for s in shape)
        if can(sub):
            inv_level(y, _Grid(mesh, sub), wt)
            STATS["sharded_levels"] += 1
        else:
            _level_global(y, y, sub, wt, False, dev0)
            STATS["fallback_levels"] += 1
    return y


def _grid_entry(x, wt, L, mesh, rank):
    """Shared entry validation: integer promotion (``shard`` does it),
    rank check, and L validated as the single-device API validates it."""
    if mesh is None:
        mesh = make_mesh2d()
    if len(mesh.axis_names) != 2:
        raise ValueError("the grid drivers need a 2-axis mesh")
    x = shard(x, mesh, mesh.axis_names)
    if x.ndim != rank:
        raise ValueError(f"expected rank-{rank} input, got shape {x.shape}")
    if L is None:
        L = maxtransformlevels(x)
    _check_levels(x, int(L), rank)
    return x, int(L)


def dwt3(x, wt, L: int | None = None, mesh: Mesh | None = None) -> Sharded:
    """Forward 3-D DWT on a 2-axis device mesh (volume sharded
    P(x, y, None)), packed layout."""
    x, L = _grid_entry(x, wt, L, mesh, 3)
    return _grid_run(x, wt, L, True)


def idwt3(y, wt, L: int | None = None, mesh: Mesh | None = None) -> Sharded:
    """Inverse of :func:`dwt3`."""
    y, L = _grid_entry(y, wt, L, mesh, 3)
    return _grid_run(y, wt, L, False)


def dwt2(x, wt, L: int | None = None, mesh: Mesh | None = None) -> Sharded:
    """Forward 2-D DWT on a 2-axis device mesh, packed layout."""
    x, L = _grid_entry(x, wt, L, mesh, 2)
    return _grid_run(x, wt, L, True)


def idwt2(y, wt, L: int | None = None, mesh: Mesh | None = None) -> Sharded:
    """Inverse of :func:`dwt2`."""
    y, L = _grid_entry(y, wt, L, mesh, 2)
    return _grid_run(y, wt, L, False)
