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

For a wavelet whose bands reach only inside the sample pair (haar: every
analysis offset 0 or 1, every synthesis offset 0; ``level3d.pair_reach``)
a level is one launch of the one-pass level instead (ops/level3d.py):
forward, it reads the active sub-cube once, writes the seven detail
octants straight into their packed places and the scaling octant into a
scratch of one eighth of the level (into ``y`` at the deepest level, and
the next level reads it from the scratch, never from ``y``, which it
writes); inverse, it reads the seven detail octants from ``y`` and the
scaling octant from the deeper level's result (from ``y`` at the deepest
level), and writes the level's result to ``out`` at level 1, else to a
scratch.  Two ping-pong buffers of one eighth and one sixty-fourth of the
volume serve every level.  Its float32 and float64 outputs equal the
two-launch chain's bit for bit.  Every other wavelet, or a volume past
the kernels' int work items, takes the chain.

On the CPU every launch takes its kernel's plain version, through the same
route.
"""

from __future__ import annotations

import torch

from .. import tracing
from . import axis0, level2d, level3d
from .level2d import detail_planes
from .scratch import Scratch

__all__ = ["dwt3", "idwt3", "chain_fw", "chain_inv", "one_pass_fw",
           "one_pass_inv"]

_KERNELS = (level2d.level_fw, level2d.level_inv, axis0.axis0_fw,
            axis0.axis0_inv)
_PLAIN = (level2d.level_fw_plain, level2d.level_inv_plain,
          axis0.axis0_fw_plain, axis0.axis0_inv_plain)
_ONE_PASS = (level3d.level3_fw, level3d.level3_inv)
_ONE_PASS_PLAIN = (level3d.level3_fw_plain, level3d.level3_inv_plain)


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
        if L == 0:
            return torch.empty_like(x).copy_(x)
        fw = one_pass_fw if level3d.takes(wt, x) else chain_fw
        return fw(x, wt, L, plain=plain)


def idwt3(y, wt, L: int, *, plain: bool = False):
    """Inverse of :func:`dwt3`: packed ``y (D, M, N)`` -> ``(D, M, N)``."""
    with tracing.span("dwt3d.idwt3", L):
        if L == 0:
            return torch.empty_like(
                y, memory_format=torch.contiguous_format).copy_(y)
        inv = one_pass_inv if level3d.takes(wt, y) else chain_inv
        return inv(y, wt, L, plain=plain)


def chain_fw(x, wt, L: int, *, plain: bool = False):
    """:func:`dwt3` (L >= 1) as two launches a level, A then I, for any
    wavelet."""
    level_fw, _, a0_fw, _ = _PLAIN if plain else _KERNELS
    D, M, N = x.shape
    y = torch.empty_like(x)
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


def chain_inv(y, wt, L: int, *, plain: bool = False):
    """:func:`idwt3` (L >= 1) as two launches a level, J then B, for any
    wavelet."""
    _, level_inv, _, a0_inv = _PLAIN if plain else _KERNELS
    D, M, N = y.shape
    out = torch.empty_like(y, memory_format=torch.contiguous_format)
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


def one_pass_fw(x, wt, L: int, *, plain: bool = False):
    """:func:`dwt3` (L >= 1) as one launch a level, for a wavelet of
    ``level3d.pair_reach``: level l's scaling octant goes to buffer (l - 1)
    mod 2, of one eighth (l odd) or one sixty-fourth (l even) of x, the
    deepest level's to y."""
    level_fw = (_ONE_PASS_PLAIN if plain else _ONE_PASS)[0]
    D, M, N = x.shape
    y = torch.empty_like(x)
    scratch = Scratch(x, (x.numel() // 8, x.numel() // 64))
    act = x
    for l in range(1, L + 1):
        lll = None if l == L else scratch.view(
            (l - 1) % 2, D >> l, M >> l, N >> l)
        level_fw(act, wt, y, lll)
        act = lll
    return y


def one_pass_inv(y, wt, L: int, *, plain: bool = False):
    """:func:`idwt3` (L >= 1) as one launch a level, for a wavelet of
    ``level3d.pair_reach``: level l's result (l >= 2) goes to buffer l mod
    2, of one eighth (l even) or one sixty-fourth (l odd) of y, and the
    next level reads it as its scaling octant."""
    level_inv = (_ONE_PASS_PLAIN if plain else _ONE_PASS)[1]
    D, M, N = y.shape
    out = torch.empty_like(y, memory_format=torch.contiguous_format)
    scratch = Scratch(y, (y.numel() // 8, y.numel() // 64))
    lll = None         # the deeper level's result
    for l in range(L, 0, -1):
        dest = out if l == 1 else scratch.view(
            l % 2, D >> (l - 1), M >> (l - 1), N >> (l - 1))
        level_inv(y, wt, dest, lll)
        lll = dest
    return out
