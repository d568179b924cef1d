"""Wavelet packet transform over arbitrary binary trees.

The counterpart of ``wavelets_tpu/ops/wpt.py``.  The tree is host-side
data (a NumPy bool heap, see utils/trees.py, which the public entry
points validate): per depth d, the active
array is viewed as ``(B·2^d, n/2^d)`` rows, one per segment, and one
batched level runs over all of them; inactive segments pass through a
``torch.where`` on the depth's flag mask.

Route: a periodic boundary with float32, bfloat16 or float64 data takes
the 1-D level kernels (ops/level1d.py; kernel E forward, F inverse), one
launch per depth.  E's two output planes are the two halves of each output
row, so ``[s | d]`` lands in place, and two buffers take turns so that no
launch writes the rows it reads.  Other boundaries and dtypes take the
torch engines' level functions (ops/lifting.py, ops/filter_fb.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.trees import treedepth
from ..wt.carriers import GLS, OrthoFilter
from ..wt.factor import check_boundary_stability
from .. import tracing
from . import filter_fb, level1d, lifting
from .level2d import DTYPES
from .scratch import Scratch

__all__ = ["wpt", "iwpt", "packet_level"]


def _periodic(wt) -> bool:
    return getattr(wt, "boundary", "periodic") == "periodic"


def _engine_level(rows, wt, fw: bool):
    """One level of ``rows (R, nj)`` on the torch engines -> ``(R, nj)``."""
    half = rows.shape[-1] // 2
    if isinstance(wt, OrthoFilter):
        h, g = filter_fb.filter_pair(wt)
        if fw:
            return torch.cat(filter_fb.dwt_level(rows, h, g), dim=-1)
        return filter_fb.idwt_level(rows[..., :half], rows[..., half:], h, g)
    if fw:
        return torch.cat(lifting.lifting_level_fw(rows, wt), dim=-1)
    return lifting.lifting_level_inv(rows[..., :half], rows[..., half:], wt)


def packet_level(segs, wt, fw: bool, out=None, *, plain: bool = False):
    """One level of every row of ``segs (R, nj)``: ``[s | d]`` per row
    (forward) or the merged rows (inverse), into ``out`` where given (it may
    not overlap ``segs``).  A periodic boundary with float32, bfloat16 or
    float64 data takes kernel E or F (their plain versions with
    ``plain=True``); the rest takes the torch engines."""
    if not (_periodic(wt) and segs.dtype in DTYPES):
        res = _engine_level(segs, wt, fw)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(segs)
    half = segs.shape[-1] // 2
    if fw:
        (level1d.level1d_fw_plain if plain else level1d.level1d_fw)(
            segs, wt, out[:, :half], out[:, half:])
    else:
        (level1d.level1d_inv_plain if plain else level1d.level1d_inv)(
            segs[:, :half], segs[:, half:], wt, out=out)
    return out


def _wpt_impl(x, wt, tree: np.ndarray, fw: bool, plain: bool):
    n = x.shape[-1]
    tree = np.asarray(tree, dtype=bool)
    if tree.size == 0 or not tree[0]:
        return x  # empty tree (no factor of 2) or inactive root: identity
    if isinstance(wt, GLS):
        # the same refusal as the lifting engine, whatever the route
        check_boundary_stability(wt, lifting.numpy_dtype(x.dtype))

    Lmax = treedepth(tree)
    depths = range(Lmax) if fw else range(Lmax - 1, -1, -1)
    B = int(np.prod(x.shape[:-1], dtype=np.int64))
    y = x.reshape(B, n).contiguous()
    scratch = Scratch(y, (B * n, B * n))
    turn = 0
    for d in depths:
        nseg = 2 ** d
        nj = n // nseg
        flags = tree[nseg - 1: 2 * nseg - 1]
        if not flags.any():
            continue
        segs = y.view(B * nseg, nj)
        out = packet_level(segs, wt, fw, scratch.view(turn, B * nseg, nj),
                           plain=plain)
        turn ^= 1
        if not flags.all():
            mask = torch.as_tensor(flags, device=y.device)[:, None]
            out = torch.where(mask, out.view(B, nseg, nj),
                              segs.view(B, nseg, nj))
        y = out.reshape(B, n)
    return y.reshape(x.shape)


def wpt(x, wt, tree: np.ndarray, *, plain: bool = False):
    """Forward wavelet packet transform of ``x`` along the last axis over a
    valid ``tree``.  ``plain=True`` runs the level kernels' plain versions
    on any device (a reference for checking the kernels on the card)."""
    with tracing.span("wpt.wpt"):
        return _wpt_impl(x, wt, tree, True, plain)


def iwpt(y, wt, tree: np.ndarray, *, plain: bool = False):
    """Inverse wavelet packet transform along the last axis."""
    with tracing.span("wpt.iwpt"):
        return _wpt_impl(y, wt, tree, False, plain)
