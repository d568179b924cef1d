"""Meshes of torch devices and arrays sharded over them: the port's
counterpart of ``jax.sharding`` for the single-controller drivers.

One process drives every shard, as ``shard_map`` does in the JAX package.
A :class:`Mesh` is a 1-D or 2-D grid of ``torch.device``s with named axes.
A device may repeat: ``Mesh(["cuda:0"] * 4, ("x",))`` is four shards on one
card (the counterpart of XLA's virtual host devices), and
``Mesh(["cpu"] * k, ("x",))`` is what the CPU tests use.  A
:class:`Sharded` array is a global shape, the mesh, a spec naming the mesh
axis (or None) of each dimension, and one tensor per block, each on the
device the mesh puts it on.

Moving data between shards (:func:`move`): a block already on the target
device is used in place, as a view, so on one device the ring exchange and
the re-sharding cost no copy and run in the one stream's order.  Between
two CUDA devices the copy is ordered after its producer by an event that
the consumer's stream waits on.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

__all__ = ["Mesh", "Sharded", "make_mesh", "make_mesh2d", "shard", "move",
           "COPIES"]

# copies the drivers made: moves between devices, regions assembled from
# several blocks (or from another device), and writes back into blocks
COPIES = {"moved": 0, "assembled": 0, "stored": 0}


class Mesh:
    """A 1-D or 2-D grid of torch devices with one name per axis."""

    def __init__(self, devices, axis_names=("x",)):
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) == 1:
            grid = np.empty(len(devices), dtype=object)
            grid[:] = [torch.device(d) for d in devices]
        elif len(self.axis_names) == 2:
            rows = [[torch.device(d) for d in row] for row in devices]
            if len({len(r) for r in rows}) != 1:
                raise ValueError("a 2-D mesh needs rows of equal length")
            grid = np.empty((len(rows), len(rows[0])), dtype=object)
            for i, row in enumerate(rows):
                grid[i, :] = row
        else:
            raise ValueError("a mesh has one or two axes")
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = grid
        self.shape = dict(zip(self.axis_names, grid.shape))

    def device(self, idx) -> torch.device:
        """The device at grid position ``idx`` (a tuple, one entry per
        axis; missing trailing entries are 0)."""
        idx = tuple(idx) + (0,) * (self.devices.ndim - len(idx))
        return self.devices[idx]

    def _key(self):
        return (self.axis_names, tuple(str(d) for d in self.devices.flat),
                self.devices.shape)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"Mesh({self.devices.tolist()}, {self.axis_names})"


def _cuda_devices(n):
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n is None:
        n = count
    if count < n or n < 1:
        raise ValueError(f"make_mesh({n}): only {count} CUDA devices visible")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: int | None = None, axis: str = "x") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` visible CUDA devices (all of
    them by default); raises when fewer are visible, or none."""
    return Mesh(_cuda_devices(n_devices), (axis,))


def make_mesh2d(shape: tuple[int, int] | None = None,
                axes: tuple[str, str] = ("x", "y")) -> Mesh:
    """A 2-D mesh over the visible CUDA devices, ``shape`` (rows, cols) or
    the squarest factorisation of their count."""
    if shape is None:
        n = len(_cuda_devices(None))
        a = int(np.sqrt(n))
        while n % a:
            a -= 1
        shape = (a, n // a)
    devs = _cuda_devices(shape[0] * shape[1])
    return Mesh([devs[i * shape[1]:(i + 1) * shape[1]]
                 for i in range(shape[0])], axes)


def move(t, device):
    """``t`` on ``device``: ``t`` itself when it is there, else a copy.  A
    copy between two CUDA devices waits for ``t``'s producer (an event on
    the current stream of ``t``'s device) and is enqueued on the current
    stream of ``device``, ahead of the consumers there."""
    device = torch.device(device)
    if t.device == device:
        return t
    COPIES["moved"] += 1
    if t.device.type == "cuda" and device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(t.device))
        with torch.cuda.device(device):
            torch.cuda.current_stream(device).wait_event(ready)
            return t.to(device, non_blocking=True)
    return t.to(device)


def _bounds(size: int, parts: int):
    """Block starts of ``size`` split in ``parts`` (as torch.tensor_split:
    the first ``size % parts`` blocks one longer), and the end."""
    q, r = divmod(size, parts)
    out = [0]
    for j in range(parts):
        out.append(out[-1] + q + (1 if j < r else 0))
    return tuple(out)


class Sharded:
    """A global array of ``shape``, cut along the dimensions that ``spec``
    names a mesh axis for, one block per grid position of those axes.

    ``splits[k]`` holds the block starts of dimension k and its size;
    ``blocks`` maps a block index (one entry per sharded dimension, in
    order) to its tensor on ``mesh.device(index)``."""

    def __init__(self, shape, mesh: Mesh, spec, splits, blocks):
        self.shape = tuple(int(s) for s in shape)
        self.mesh = mesh
        self.spec = tuple(spec)
        self.splits = tuple(tuple(b) for b in splits)
        self.blocks = dict(blocks)

    @property
    def dtype(self):
        return next(iter(self.blocks.values())).dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def sharded_dims(self):
        return [k for k, a in enumerate(self.spec) if a is not None]

    def region(self, idx):
        """The global slices of block ``idx``."""
        out = [slice(0, s) for s in self.shape]
        for k, i in zip(self.sharded_dims(), idx):
            out[k] = slice(self.splits[k][i], self.splits[k][i + 1])
        return tuple(out)

    def device_of(self, idx) -> torch.device:
        axes = [self.spec[k] for k in self.sharded_dims()]
        pos = [0] * len(self.mesh.axis_names)
        for a, i in zip(axes, idx):
            pos[self.mesh.axis_names.index(a)] = i
        return self.mesh.device(pos)

    def empty_like(self, dtype=None) -> "Sharded":
        """A Sharded of the same layout with uninitialised blocks."""
        return Sharded(self.shape, self.mesh, self.spec, self.splits, {
            i: torch.empty(b.shape, dtype=dtype or b.dtype, device=b.device)
            for i, b in self.blocks.items()})

    def map(self, fn) -> "Sharded":
        """``fn`` of every block (same shape), as a new Sharded."""
        return Sharded(self.shape, self.mesh, self.spec, self.splits,
                       {i: fn(b) for i, b in self.blocks.items()})

    def _full(self, region):
        return tuple(region) + tuple(
            slice(0, s) for s in self.shape[len(region):])

    def view(self, region, device):
        """The global ``region`` (a tuple of slices with unit step) as a
        view of one block, where one block on ``device`` holds all of it;
        else None."""
        pieces = list(self._overlaps(self._full(region)))
        if len(pieces) == 1:
            idx, src, _ = pieces[0]
            blk = self.blocks[idx]
            if blk.device == torch.device(device):
                return blk[src]
        return None

    def fetch(self, region, device):
        """The global ``region`` as one tensor on ``device``: a view of a
        block (:meth:`view`) where one can be, else a new tensor assembled
        from moved pieces."""
        region = self._full(region)
        out = self.view(region, device)
        if out is not None:
            return out
        shape = [r.stop - r.start for r in region]
        out = torch.empty(shape, dtype=self.dtype, device=device)
        COPIES["assembled"] += 1
        for idx, src, dst in self._overlaps(region):
            out[dst].copy_(move(self.blocks[idx][src], device))
        return out

    def store(self, start, t):
        """Write ``t`` into the global region that starts at ``start``."""
        region = tuple(slice(s, s + n) for s, n in zip(start, t.shape))
        region = region + tuple(slice(0, s) for s in self.shape[len(region):])
        for idx, dst, src in self._overlaps(region):
            view = self.blocks[idx][dst]
            piece = t[src]
            if view.data_ptr() != piece.data_ptr() or \
                    view.device != piece.device:
                COPIES["stored"] += 1
                view.copy_(move(piece, view.device))

    def _overlaps(self, region):
        """(block index, slices within the block, slices within the
        region) of every block that meets ``region``."""
        dims = self.sharded_dims()
        for idx in itertools.product(*[range(len(self.splits[k]) - 1)
                                       for k in dims]):
            blk_sl, reg_sl = [], []
            for k, r in enumerate(region):
                lo, hi = (self.splits[k][idx[dims.index(k)]],
                          self.splits[k][idx[dims.index(k)] + 1]) \
                    if k in dims else (0, self.shape[k])
                a, b = max(lo, r.start), min(hi, r.stop)
                if a >= b:
                    break
                blk_sl.append(slice(a - lo, b - lo))
                reg_sl.append(slice(a - r.start, b - r.start))
            else:
                yield idx, tuple(blk_sl), tuple(reg_sl)

    def gather(self, device) -> torch.Tensor:
        """The whole array as one tensor on ``device``."""
        return self.fetch(tuple(slice(0, s) for s in self.shape), device)

    def __repr__(self):
        return (f"Sharded(shape={self.shape}, spec={self.spec}, "
                f"dtype={self.dtype}, mesh={self.mesh!r})")


def shard(x, mesh: Mesh, spec) -> Sharded:
    """Place ``x`` (a tensor, an array-like or a Sharded) on ``mesh``, cut
    along each dimension that ``spec`` names a mesh axis for.  Integer and
    boolean input promotes to float64, as the transforms do.  A contiguous
    block already on its device stays a view of ``x`` (the drivers never
    write into their input)."""
    if isinstance(x, Sharded):
        full = tuple(spec) + (None,) * (x.ndim - len(spec))
        if x.mesh == mesh and x.spec == full:
            return x
        x = x.gather(next(iter(x.blocks.values())).device)
    elif not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    if x.ndim < len(spec):
        raise ValueError(f"spec {spec} is longer than the rank {x.ndim}")
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float64)
    for a in spec:
        if a is not None and a not in mesh.axis_names:
            raise ValueError(f"spec names {a!r}, not an axis of {mesh!r}")
    splits = [_bounds(s, mesh.shape[a]) if a is not None else (0, s)
              for s, a in zip(x.shape, spec)]
    out = Sharded(x.shape, mesh, spec, splits, {})
    dims = out.sharded_dims()
    for idx in itertools.product(*[range(mesh.shape[spec[k]])
                                   for k in dims]):
        out.blocks[idx] = move(x[out.region(idx)], out.device_of(idx)) \
            .contiguous()
    return out
