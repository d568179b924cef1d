"""Multi-level periodic 1-D DWT over ``(B, n)`` rows, in the packed layout.

The counterpart of ``wavelets_tpu/ops/pallas/dwt1d.py`` (``dwt1d_pallas``,
``idwt1d_pallas``) for batched rows and of ``wide1d.py`` / ``pyramid1d.py``
(``dwt1d_wide``, ``dwt1d_pyramid``) for a single long signal, which is
here a batch of one row.  Layout per row: ``[s_L | d_L | d_{L-1} | ... |
d_1]``, level l's detail at ``[n>>l : n>>(l-1)]``.

Forward: the packed output ``y`` is allocated once.  While the active row
is too long for one block's shared memory, a level launch (kernel E,
ops/level1d.py) writes the level's detail straight into ``y`` and its
scaling band into a scratch buffer; two scratch buffers (B·n/2 and B·n/4)
take turns, so no level reads the memory it writes.  Then one tail launch
(kernel G, ops/tail1d.py) does every remaining level and writes the final
scaling band into ``y``'s head, so there is no closing concatenate.  The
inverse mirrors it: one tail launch (H) for the deepest levels, then one
level launch (F) per level, reading the details in place from ``y``.

On the CPU every launch takes its kernel's plain version, through the same
route.
"""

from __future__ import annotations

import torch

from .. import tracing
from . import level1d, tail1d
from .scratch import Scratch

__all__ = ["dwt1", "idwt1", "kernel_levels1d"]

_KERNELS = (level1d.level1d_fw, level1d.level1d_inv, tail1d.tail1d_fw,
            tail1d.tail1d_inv)
_PLAIN = (level1d.level1d_fw_plain, level1d.level1d_inv_plain,
          tail1d.tail1d_fw_plain, tail1d.tail1d_inv_plain)


def kernel_levels1d(n: int, L: int, wt, dtype, inverse: bool) -> int:
    """How many of the L levels run as level launches: the levels whose
    active row does not fit the tail (:func:`tail1d.tail1d_fits`)."""
    k = 0
    while k < L and not tail1d.tail1d_fits(n >> k, wt, dtype, inverse):
        k += 1
    return k


def dwt1(x, wt, L: int, *, plain: bool = False):
    """L-level forward 1-D DWT of a contiguous ``x (B, n)`` -> packed
    ``(B, n)``.  ``plain=True`` runs the kernels' plain versions on any
    device (a reference for checking the kernels on the card)."""
    with tracing.span("dwt1d.dwt1", L):
        level_fw, _, tail_fw, _ = _PLAIN if plain else _KERNELS
        B, n = x.shape
        y = torch.empty_like(x)
        if L == 0:
            return y.copy_(x)
        k = kernel_levels1d(n, L, wt, x.dtype, inverse=False)
        scratch = Scratch(x, (B * (n >> 1), B * (n >> 2)))
        act = x
        for l in range(1, k + 1):
            nh = n >> l
            s = y[:, :nh] if l == L else scratch.view((l - 1) % 2, B, nh)
            level_fw(act, wt, s, y[:, nh: 2 * nh])
            act = s
        if k < L:
            tail_fw(act, wt, L - k, out=y[:, : n >> k])
        return y


def idwt1(y, wt, L: int, *, plain: bool = False):
    """Inverse of :func:`dwt1`: packed ``y (B, n)`` -> ``(B, n)``."""
    with tracing.span("dwt1d.idwt1", L):
        _, level_inv, _, tail_inv = _PLAIN if plain else _KERNELS
        B, n = y.shape
        out = torch.empty_like(y, memory_format=torch.contiguous_format)
        if L == 0:
            return out.copy_(y)
        k = kernel_levels1d(n, L, wt, y.dtype, inverse=True)
        scratch = Scratch(y, (B * (n >> 1), B * (n >> 2)))

        def dest(l):   # where level l's merged n >> (l-1) samples go
            if l == 1:
                return out
            return scratch.view(l % 2, B, n >> (l - 1))

        if k < L:
            act = tail_inv(y[:, : n >> k], wt, L - k, out=dest(k + 1))
        else:
            act = y[:, : n >> L]
        for l in range(k, 0, -1):
            act = level_inv(act, y[:, n >> l: n >> (l - 1)], wt, out=dest(l))
        return out
