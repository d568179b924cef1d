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

The image index rides the kernels' batch axis.  On the CPU every launch
takes its kernel's plain version, through the same route.
"""

from __future__ import annotations

import torch

from . import level2d, tail2d
from .level2d import detail_planes

__all__ = ["dwt2", "idwt2", "kernel_levels", "detail_planes"]

_KERNELS = (level2d.level_fw, level2d.level_inv, tail2d.tail_fw,
            tail2d.tail_inv)
_PLAIN = (level2d.level_fw_plain, level2d.level_inv_plain,
          tail2d.tail_fw_plain, tail2d.tail_inv_plain)


def kernel_levels(m: int, n: int, L: int, wt, dtype, inverse: bool) -> int:
    """How many of the L levels run as level launches: the levels whose
    active array does not fit the tail (:func:`tail2d.tail_fits`)."""
    k = 0
    while k < L and not tail2d.tail_fits(m >> k, n >> k, wt, dtype, inverse):
        k += 1
    return k


class _Scratch:
    """Two ping-pong buffers for the LL between levels: buffer 0 holds
    up to B x m/2 x n/2 samples, buffer 1 up to B x m/4 x n/4."""

    def __init__(self, like, B, m, n):
        self.like = like
        self.caps = (B * (m >> 1) * (n >> 1), B * (m >> 2) * (n >> 2))
        self.bufs = [None, None]

    def view(self, i, B, rows, cols):
        if self.bufs[i] is None:
            self.bufs[i] = torch.empty(self.caps[i], dtype=self.like.dtype,
                                       device=self.like.device)
        return self.bufs[i][: B * rows * cols].view(B, rows, cols)


def dwt2(x, wt, L: int, *, plain: bool = False):
    """L-level forward 2-D DWT of a contiguous ``x (B, m, n)`` -> packed
    ``(B, m, n)``.  ``plain=True`` runs the kernels' plain versions on any
    device (a reference for checking the kernels on the card)."""
    level_fw, _, tail_fw, _ = _PLAIN if plain else _KERNELS
    B, m, n = x.shape
    y = torch.empty_like(x)
    if L == 0:
        return y.copy_(x)
    k = kernel_levels(m, n, L, wt, x.dtype, inverse=False)
    scratch = _Scratch(x, B, m, n)
    act = x
    for l in range(1, k + 1):
        mh, nh = m >> l, n >> l
        ll = y[:, :mh, :nh] if l == L else scratch.view((l - 1) % 2, B, mh, nh)
        level_fw(act, wt, (ll, *detail_planes(y, l)))
        act = ll
    if k < L:
        tail_fw(act, wt, L - k, out=y[:, : m >> k, : n >> k])
    return y


def idwt2(y, wt, L: int, *, plain: bool = False):
    """Inverse of :func:`dwt2`: packed ``y (B, m, n)`` -> ``(B, m, n)``."""
    _, level_inv, _, tail_inv = _PLAIN if plain else _KERNELS
    B, m, n = y.shape
    out = torch.empty_like(y, memory_format=torch.contiguous_format)
    if L == 0:
        return out.copy_(y)
    k = kernel_levels(m, n, L, wt, y.dtype, inverse=True)
    scratch = _Scratch(y, B, m, n)

    def dest(l):   # where level l's merged (m >> (l-1), n >> (l-1)) goes
        if l == 1:
            return out
        return scratch.view(l % 2, B, m >> (l - 1), n >> (l - 1))

    if k < L:
        act = tail_inv(y[:, : m >> k, : n >> k], wt, L - k, out=dest(k + 1))
    else:
        act = y[:, : m >> L, : n >> L]
    for l in range(k, 0, -1):
        act = level_inv(act, *detail_planes(y, l), wt, out=dest(l))
    return out
