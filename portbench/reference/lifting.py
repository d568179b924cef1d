"""Plain float64 periodic lifting DWT over the trailing axes, in the packed
layout: the benchmark's own reference, independent of the program.

Per level the active sub-array (each transformed axis cut to ``n >> l``)
is lifted along the last axis, then the one before it, and so on; each
axis packs its even (scaling) half first.  The inverse runs the levels
from the deepest and the axes in the opposite order.  The constants are
the frozen copy in ``schemes.json``.  Plain ``torch`` operations only, on
whatever device the input is on.
"""

from __future__ import annotations

import itertools
import json
from pathlib import Path

import torch

__all__ = ["scheme", "dwt", "idwt", "regions"]

_SCHEMES = json.loads(Path(__file__).with_name("schemes.json").read_text())


def scheme(name: str) -> dict:
    """The frozen lifting scheme ``name`` (``cdf97``, ``haar``)."""
    return _SCHEMES[name]


def _cut(ndim: int, axis: int, part) -> tuple:
    idx = [slice(None)] * ndim
    idx[axis] = part
    return tuple(idx)


def _lifted(halves: dict, sch: dict, axis: int, sign: float, order) -> dict:
    for step in order:
        w = step["writes"]
        src = halves["even" if w == "odd" else "odd"]
        acc = None
        for k, c in enumerate(step["taps"]):
            term = c * torch.roll(src, step["shift"] - k, dims=axis)
            acc = term if acc is None else acc + term
        halves[w] = halves[w] + sign * acc
    return halves


def level_fw(x: torch.Tensor, sch: dict, axis: int) -> torch.Tensor:
    """One forward level along ``axis``: ``[even | odd]``."""
    halves = {"even": x[_cut(x.ndim, axis, slice(0, None, 2))],
              "odd": x[_cut(x.ndim, axis, slice(1, None, 2))]}
    halves = _lifted(halves, sch, axis, -1.0, sch["steps"])
    return torch.cat([halves["even"] * sch["norm_even"],
                      halves["odd"] * sch["norm_odd"]], dim=axis)


def level_inv(y: torch.Tensor, sch: dict, axis: int) -> torch.Tensor:
    """Inverse of :func:`level_fw` along ``axis``."""
    h = y.shape[axis] // 2
    halves = {"even": y[_cut(y.ndim, axis, slice(0, h))] / sch["norm_even"],
              "odd": y[_cut(y.ndim, axis, slice(h, None))] / sch["norm_odd"]}
    halves = _lifted(halves, sch, axis, 1.0, sch["steps"][::-1])
    out = torch.empty_like(y)
    out[_cut(y.ndim, axis, slice(0, None, 2))] = halves["even"]
    out[_cut(y.ndim, axis, slice(1, None, 2))] = halves["odd"]
    return out


def _active(shape, ndt: int, level: int) -> tuple:
    return (Ellipsis,) + tuple(slice(0, s >> level) for s in shape[-ndt:])


def dwt(x: torch.Tensor, sch: dict, L: int, ndt: int) -> torch.Tensor:
    """L-level forward DWT of the trailing ``ndt`` axes, in float64."""
    y = x.to(torch.float64, copy=True)
    for lev in range(L):
        idx = _active(y.shape, ndt, lev)
        a = y[idx]
        for axis in range(-1, -ndt - 1, -1):
            a = level_fw(a, sch, axis)
        y[idx] = a
        del a
    return y


def idwt(y: torch.Tensor, sch: dict, L: int, ndt: int) -> torch.Tensor:
    """Inverse of :func:`dwt`, in float64."""
    x = y.to(torch.float64, copy=True)
    for lev in range(L, 0, -1):
        idx = _active(x.shape, ndt, lev - 1)
        a = x[idx]
        for axis in range(-ndt, 0):
            a = level_inv(a, sch, axis)
        x[idx] = a
        del a
    return x


def regions(shape, L: int, ndt: int) -> list:
    """The packed layout's bands, as ``(label, band, scope)`` indices: for
    each level l the ``2^ndt - 1`` detail blocks (label ``"level l"``),
    then the level-L approximation (label ``"approximation"``).  ``scope``
    is the band's level's active sub-array (its bands and every deeper
    one): a band's error is measured against the largest value there, so
    that a band of a few coefficients that happen to lie near zero is not
    judged against their own size."""
    out = []
    for lev in range(1, L + 1):
        sizes = [s >> lev for s in shape[-ndt:]]
        scope = _active(shape, ndt, lev - 1)
        for highs in itertools.product((0, 1), repeat=ndt):
            if any(highs):
                out.append((f"level {lev}", (Ellipsis,) + tuple(
                    slice(h * s, (h + 1) * s) for h, s in zip(highs, sizes)),
                    scope))
    out.append(("approximation", _active(shape, ndt, L),
                _active(shape, ndt, L - 1)))
    return out
