"""Multi-level periodic 2-D DWT over ``(B, m, n)``, in the packed layout.

The counterpart of ``wavelets_tpu/ops/pallas/lifting2d.py``
(``_dwt2_packed``, ``idwt2_lifting``) and, through the bands, of
``filter2d.dwt2_filter`` / ``idwt2_filter``.  Layout: after L levels LL_L
sits at ``[:m>>L, :n>>L]``; level l's LH at ``[:m>>l, n>>l : n>>(l-1)]``,
HL at ``[m>>l : m>>(l-1), :n>>l]`` and HH in the corner between them.

Forward: the packed output ``y`` is allocated once.  While the active
array is too large for one block's shared memory, a level launch
(ops/level2d.py) writes the level's three detail quadrants straight into
``y`` and its LL into a scratch buffer; two scratch buffers (m/2 x n/2 and
m/4 x n/4) take turns, so no level reads the memory it writes.  Then one
tail launch (ops/tail2d.py) does every remaining level and writes the final
LL into ``y``'s corner, so there is no closing copy.  The inverse mirrors
it: one tail launch for the deepest levels, then one level launch per
level, reading the detail quadrants in place from ``y``.

Routes (``route=``), the counterparts of the JAX package's switches
(transforms.py picks one per call):

* ``"level"``: the levels above, kernels A then C / D then B.
* ``"stage"`` (forward only): kernel N (ops/stage2d.py) runs levels 1 and
  2 in one launch, writing both levels' details into ``y`` and LL2 into a
  scratch view (into ``y``'s corner when L == 2); then A per level and C.
  It takes a single image whose first two levels are level launches
  (:func:`stage_ok`); elsewhere the route runs A per level, as the JAX
  package's ``stage2_ok`` gate sends such calls to the per-level kernels.
* ``"split"``: each level as two launches (ops/rowcol2d.py): E over the
  rows into a scratch, I down its columns straight into the level's place
  in ``y``, whose LL the next level reads in place; then C in place on the
  corner.  The inverse runs D into a scratch, then per level J (reading
  the deeper LL through its corner view) and F.

The image index rides the kernels' batch axis.  On the CPU every launch
takes its kernel's plain version, through the same route.

On the card a call's launches are one CUDA graph per call signature
(ops/graph.py): the first call of a signature runs them through the
launch wrappers, the second records them, and later calls write their
buffers' addresses into the recorded launches and send them whole.
``GRAPHS`` counts the CUDA calls by how they ran.
"""

from __future__ import annotations

import torch

from .. import tracing
from . import graph, level2d, rowcol2d, stage2d, tail2d
from .level2d import detail_planes
from .scratch import Scratch

__all__ = ["dwt2", "idwt2", "kernel_levels", "detail_planes", "stage_ok",
           "ROUTES", "GRAPHS"]

ROUTES = ("level", "stage", "split")
_KERNELS = (level2d.level_fw, level2d.level_inv, tail2d.tail_fw,
            tail2d.tail_inv, stage2d.stage2_fw, rowcol2d.rowcol_fw,
            rowcol2d.rowcol_inv)
_PLAIN = (level2d.level_fw_plain, level2d.level_inv_plain,
          tail2d.tail_fw_plain, tail2d.tail_inv_plain,
          stage2d.stage2_fw_plain, rowcol2d.rowcol_fw_plain,
          rowcol2d.rowcol_inv_plain)
# CUDA calls by how they ran (ops/graph.py, Store): captured a graph,
# replayed one, ran the wrappers after a refused capture, or ran them
# for any other reason (a signature's first call, plain=True, L == 0, a
# stream under capture)
GRAPHS = {"captures": 0, "replays": 0, "fallbacks": 0, "plain": 0}
_graphs = graph.Store(GRAPHS, "pyramid2d.replay")


def kernel_levels(m: int, n: int, L: int, wt, dtype, inverse: bool) -> int:
    """How many of the L levels run as level launches: the levels whose
    active array does not fit the tail (:func:`tail2d.tail_fits`)."""
    k = 0
    while k < L and not tail2d.tail_fits(m >> k, n >> k, wt, dtype, inverse):
        k += 1
    return k


def stage_ok(B: int, m: int, n: int, L: int, wt, dtype) -> bool:
    """The stage route's gate for kernel N: one image, m and n divisible by
    4, two levels or more, both of them level launches, and a band reach
    that fits the kernel's window (:func:`stage2d.stage_tile`)."""
    return (B == 1 and L >= 2 and m % 4 == 0 and n % 4 == 0
            and kernel_levels(m, n, L, wt, dtype, inverse=False) >= 2
            and stage2d.stage_tile(wt, dtype) is not None)


def _check_route(route, inverse):
    if route not in ROUTES or (inverse and route == "stage"):
        raise ValueError(f"unknown route {route!r}")


def _run(name, x, wt, L, route, plain, chain, out, scratch):
    """Make a call's launches: through the graph of its signature
    (ops/graph.py) for a CUDA call, else ``chain()`` directly."""
    if plain or x.device.type != "cuda":
        chain()
        GRAPHS["plain"] += x.device.type == "cuda"
    else:
        _graphs.run(graph.signature(name, wt, x, route, L), chain, x, out,
                    scratch)


def _fw_chain(x, wt, L, route, fns, y, scratch):
    """The forward's launches on ``route`` (the module docstring)."""
    level_fw, _, tail_fw, _, stage_fw, split_fw, _ = fns
    B, m, n = x.shape
    k = kernel_levels(m, n, L, wt, x.dtype, inverse=False)
    if route == "split":
        act = x
        for l in range(1, k + 1):
            ml, nl = m >> (l - 1), n >> (l - 1)
            split_fw(act, wt, y[:, :ml, :nl], scratch.view(0, B, ml, nl))
            act = y[:, : ml >> 1, : nl >> 1]
    else:
        act, first = x, 1
        if route == "stage" and stage_ok(B, m, n, L, wt, x.dtype):
            ll2 = (y[:, : m >> 2, : n >> 2] if L == 2
                   else scratch.view(1, B, m >> 2, n >> 2))
            stage_fw(x, wt, (ll2, *detail_planes(y, 1),
                             *detail_planes(y, 2)))
            act, first = ll2, 3
        for l in range(first, k + 1):
            mh, nh = m >> l, n >> l
            ll = (y[:, :mh, :nh] if l == L
                  else scratch.view((l - 1) % 2, B, mh, nh))
            level_fw(act, wt, (ll, *detail_planes(y, l)))
            act = ll
    if k < L:
        # in place on the split route: the tail reads its image first
        tail_fw(act, wt, L - k, out=y[:, : m >> k, : n >> k])


def dwt2(x, wt, L: int, *, route: str = "level", plain: bool = False):
    """L-level forward 2-D DWT of a contiguous ``x (B, m, n)`` -> packed
    ``(B, m, n)``, through ``route`` (see the module docstring).
    ``plain=True`` runs the kernels' plain versions on any device (a
    reference for checking the kernels on the card)."""
    with tracing.span("pyramid2d.dwt2", L):
        _check_route(route, False)
        B, m, n = x.shape
        y = torch.empty_like(x)
        if L == 0:
            GRAPHS["plain"] += x.device.type == "cuda"
            return y.copy_(x)
        scratch = Scratch(x, (B * m * n, 0) if route == "split" else
                          (B * (m >> 1) * (n >> 1), B * (m >> 2) * (n >> 2)))
        fns = _PLAIN if plain else _KERNELS
        _run("dwt2", x, wt, L, route, plain,
             lambda: _fw_chain(x, wt, L, route, fns, y, scratch), y, scratch)
        return y


def _inv_chain(y, wt, L, route, fns, out, scratch):
    """The inverse's launches on ``route`` (the module docstring)."""
    _, level_inv, _, tail_inv, _, _, split_inv = fns
    B, m, n = y.shape
    k = kernel_levels(m, n, L, wt, y.dtype, inverse=True)
    split = route == "split"

    def dest(l):   # where level l's merged (m >> (l-1), n >> (l-1)) goes
        if l == 1:
            return out
        return scratch.view(1 if split else l % 2, B, m >> (l - 1),
                            n >> (l - 1))

    if k < L:
        act = tail_inv(y[:, : m >> k, : n >> k], wt, L - k, out=dest(k + 1))
    else:
        act = y[:, : m >> L, : n >> L]
    for l in range(k, 0, -1):
        if split:
            ml, nl = m >> (l - 1), n >> (l - 1)
            act = split_inv(y[:, :ml, :nl], wt, dest(l),
                            corner=act if k < L or l < k else None,
                            scratch=scratch.view(0, B, ml, nl))
        else:
            act = level_inv(act, *detail_planes(y, l), wt, out=dest(l))


def idwt2(y, wt, L: int, *, route: str = "level", plain: bool = False):
    """Inverse of :func:`dwt2`: packed ``y (B, m, n)`` -> ``(B, m, n)``,
    through ``route`` ("level" or "split")."""
    with tracing.span("pyramid2d.idwt2", L):
        _check_route(route, True)
        B, m, n = y.shape
        out = torch.empty_like(y, memory_format=torch.contiguous_format)
        if L == 0:
            GRAPHS["plain"] += y.device.type == "cuda"
            return out.copy_(y)
        # the split route's J writes buffer 0, its F and the tail buffer 1
        scratch = Scratch(y, (B * m * n, B * (m >> 1) * (n >> 1))
                          if route == "split" else
                          (B * (m >> 1) * (n >> 1), B * (m >> 2) * (n >> 2)))
        fns = _PLAIN if plain else _KERNELS
        _run("idwt2", y, wt, L, route, plain,
             lambda: _inv_chain(y, wt, L, route, fns, out, scratch), out,
             scratch)
        return out
