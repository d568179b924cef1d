"""Multi-level periodic 3-D DWT of a ``(D, M, N)`` volume, in the packed
layout.

The counterpart of ``wavelets_tpu/ops/pallas/dwt3d.py`` (``dwt3_pallas``,
``idwt3_pallas``), with the layout of the JAX engines' ``dwt_nd`` for
three axes: per level the active sub-cube ``[:d', :m', :n']`` is
transformed along axes -1, -2, then -3, and each axis packs its scaling
half first.

Forward level: the 2-D level kernel (A, ops/level2d.py) reads the active
sub-cube in place as d' slabs of ``(m', n')`` on its batch axis and writes
the four quadrants into their packed places of a contiguous ``(d', m',
n')`` scratch; then the axis-0 kernel (I, ops/axis0.py) runs along axis 0
of the scratch, viewed as ``(B = m', R = d', C = n')``, straight into the
two halves of the output's sub-cube.  Level 1 reads ``x`` and never writes
it.  Inverse level: J runs from the sub-cube's two halves into the scratch
(reading the scaling half's leading octant from the deeper level's result,
kept apart from the stored details), then B (``level_inv``) reads the
scratch's quadrants and writes the level's result.  That is two launches
per level, with no concatenation and no copy.

On the CPU every launch takes its kernel's plain version, through the same
route.
"""

from __future__ import annotations

import torch

from .. import tracing
from . import axis0, level2d
from .level2d import detail_planes
from .scratch import Scratch

__all__ = ["dwt3", "idwt3"]

_KERNELS = (level2d.level_fw, level2d.level_inv, axis0.axis0_fw,
            axis0.axis0_inv)
_PLAIN = (level2d.level_fw_plain, level2d.level_inv_plain,
          axis0.axis0_fw_plain, axis0.axis0_inv_plain)


def _quads(s):
    """The four quadrant planes (LL, LH, HL, HH) of ``s (d, m, n)``."""
    _, m, n = s.shape
    return (s[:, : m // 2, : n // 2], *detail_planes(s, 1))


def _rows(v):
    """``v (d, m, n)`` as the axis-0 kernels' ``(B = m, R = d, C = n)``."""
    return v.permute(1, 0, 2)


def dwt3(x, wt, L: int, *, plain: bool = False):
    """L-level forward 3-D DWT of a contiguous ``x (D, M, N)`` -> packed
    ``(D, M, N)``.  ``plain=True`` runs the kernels' plain versions on any
    device (a reference for checking the kernels on the card)."""
    with tracing.span("dwt3d.dwt3", L):
        level_fw, _, a0_fw, _ = _PLAIN if plain else _KERNELS
        D, M, N = x.shape
        y = torch.empty_like(x)
        if L == 0:
            return y.copy_(x)
        scratch = Scratch(x, (x.numel(), 0))     # buffer 0 only: A's output
        act = x
        for l in range(1, L + 1):
            d, m, n = D >> (l - 1), M >> (l - 1), N >> (l - 1)
            s = scratch.view(0, d, m, n)
            level_fw(act, wt, _quads(s))
            a0_fw(_rows(s), wt, _rows(y[: d // 2, :m, :n]),
                  _rows(y[d // 2: d, :m, :n]))
            act = y[: d // 2, : m // 2, : n // 2]
        return y


def idwt3(y, wt, L: int, *, plain: bool = False):
    """Inverse of :func:`dwt3`: packed ``y (D, M, N)`` -> ``(D, M, N)``."""
    with tracing.span("dwt3d.idwt3", L):
        _, level_inv, _, a0_inv = _PLAIN if plain else _KERNELS
        D, M, N = y.shape
        out = torch.empty_like(y, memory_format=torch.contiguous_format)
        if L == 0:
            return out.copy_(y)
        scratch = Scratch(y, (y.numel(), y.numel() // 8))
        corner = None      # the deeper level's result, as a's leading block
        for l in range(L, 0, -1):
            d, m, n = D >> (l - 1), M >> (l - 1), N >> (l - 1)
            s = scratch.view(0, d, m, n)
            a0_inv(_rows(y[: d // 2, :m, :n]), _rows(y[d // 2: d, :m, :n]), wt,
                   out=_rows(s), corner=corner)
            dest = out if l == 1 else scratch.view(1, d, m, n)
            level_inv(*_quads(s), wt, out=dest)
            corner = _rows(dest)
        return out
