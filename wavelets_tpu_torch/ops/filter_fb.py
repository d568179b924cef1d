"""Filter-bank DWT engine in PyTorch (periodic boundary, orthogonal filters).

The torch counterpart of ``wavelets_tpu/ops/filter_fb.py``, with the same
closed forms (0-based; h is the l2-normalised scaling filter and
g[m] = (-1)^m h[m] its quadrature mirror):

    a[k] = sum_m h[m] * x[(2k + m)     mod n]
    d[k] = sum_m g[m] * x[(2k + 1 - m) mod n]

    x[t] = sum_{m == t mod 2} h[m] * a[((t - m) mod n) / 2]
         + sum_{m == t+1 mod 2} g[m] * d[((t + m - 1) mod n) / 2]

It runs on the tensor's own device.  The 2-D periodic route of
``transforms.dwt`` goes to ops/pyramid2d.py instead; this engine serves the
routes that have no kernel yet (ndt 1 and 3).  The multi-level layout is
the packed [s_L | d_L | ... | d_1] of utils/indexing.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..wt.carriers import OrthoFilter
from ..utils.signals import mirror

__all__ = [
    "filter_pair", "dwt_level", "idwt_level",
    "dwt1d", "idwt1d", "dwt_nd", "idwt_nd",
]


def filter_pair(wt: OrthoFilter):
    """(h, g) in float64: the scaling filter and its quadrature mirror
    g[m] = (-1)^m h[m]."""
    h = wt.qmf_array()
    return h, mirror(h)


def _extend_periodic(x, front: int, back: int):
    """Concatenate periodic wrap samples so that index arithmetic in
    [-front, n + back) becomes in-bounds; filters longer than the signal
    tile it."""
    n = x.shape[-1]
    parts = []
    if front > 0:
        reps = -(-front // n)
        ext = torch.cat([x] * reps, dim=-1) if reps > 1 else x
        parts.append(ext[..., ext.shape[-1] - front:])
    parts.append(x)
    if back > 0:
        reps = -(-back // n)
        ext = torch.cat([x] * reps, dim=-1) if reps > 1 else x
        parts.append(ext[..., :back])
    if len(parts) == 1:
        return x
    return torch.cat(parts, dim=-1)


def _planes(v):
    r = v.reshape(*v.shape[:-1], v.shape[-1] // 2, 2)
    return r[..., 0], r[..., 1]


def dwt_level(x, h: np.ndarray, g: np.ndarray):
    """One forward DWT level along the last axis: (..., n) -> (a, d), each
    (..., n // 2), accumulated in ascending tap order."""
    n = x.shape[-1]
    if n % 2:
        raise ValueError("level transform requires even length")
    flen = len(h)
    half = n // 2
    wrap = max(flen - 2, 0)
    pad = (n + wrap) % 2
    e0, e1 = _planes(_extend_periodic(x, 0, wrap + pad))   # xe[2q], xe[2q+1]
    f0, f1 = _planes(_extend_periodic(x, wrap, pad))
    grev = g[::-1]
    a = d = None
    for m in range(flen):
        src_a = e0 if m % 2 == 0 else e1
        src_d = f0 if m % 2 == 0 else f1
        off = m // 2
        ta = float(h[m]) * src_a[..., off:off + half]
        td = float(grev[m]) * src_d[..., off:off + half]
        a = ta if a is None else a + ta
        d = td if d is None else d + td
    return a, d


def _upsample_last(a):
    """Zero-stuff along the last axis: u[2k] = a[k], u[2k + 1] = 0."""
    u = torch.stack([a, torch.zeros_like(a)], dim=-1)
    return u.reshape(*a.shape[:-1], a.shape[-1] * 2)


def idwt_level(a, d, h: np.ndarray, g: np.ndarray):
    """One inverse DWT level along the last axis: (a, d) -> x of length
    2 * half."""
    n = 2 * a.shape[-1]
    flen = len(h)
    ue = _extend_periodic(_upsample_last(a), flen - 1, 0)
    we = _extend_periodic(_upsample_last(d), 1, max(flen - 2, 0))
    hrev = h[::-1]
    x = float(hrev[0]) * ue[..., 0:n] + float(g[0]) * we[..., 0:n]
    for m in range(1, flen):
        x = x + float(hrev[m]) * ue[..., m:m + n]
        x = x + float(g[m]) * we[..., m:m + n]
    return x


def dwt1d(x, h, g, L: int):
    """L-level forward DWT along the last axis -> packed [s_L|d_L|...|d_1]."""
    if L == 0:
        return x
    s = x
    details = []
    for _ in range(L):
        s, d = dwt_level(s, h, g)
        details.append(d)
    return torch.cat([s] + details[::-1], dim=-1)


def idwt1d(y, h, g, L: int):
    """Inverse of dwt1d on the packed layout."""
    if L == 0:
        return y
    n = y.shape[-1]
    s = y[..., : n >> L]
    for l in range(L, 0, -1):
        s = idwt_level(s, y[..., n >> l: n >> (l - 1)], h, g)
    return s


def _level_along_axis(active, h, g, axis: int, fw: bool):
    moved = torch.movedim(active, axis, -1)
    if fw:
        out = torch.cat(dwt_level(moved, h, g), dim=-1)
    else:
        half = moved.shape[-1] // 2
        out = idwt_level(moved[..., :half], moved[..., half:], h, g)
    return torch.movedim(out, -1, axis)


def dwt_nd(x, h, g, L: int, ndt: int):
    """L-level separable forward DWT over the last ``ndt`` axes.

    Per level the active (top-left) block is transformed along the axes
    last to first and written back; leading axes are batch."""
    if L == 0:
        return x
    y = x.clone()
    tshape = x.shape[-ndt:]
    for l in range(L):
        idx = (Ellipsis,) + tuple(slice(0, s >> l) for s in tshape)
        active = y[idx]
        for axis in range(-1, -ndt - 1, -1):
            active = _level_along_axis(active, h, g, axis, fw=True)
        y[idx] = active
    return y


def idwt_nd(y, h, g, L: int, ndt: int):
    """Inverse of dwt_nd (axes first to last per level, levels deep to
    shallow)."""
    if L == 0:
        return y
    x = y.clone()
    tshape = y.shape[-ndt:]
    for l in range(L, 0, -1):
        idx = (Ellipsis,) + tuple(slice(0, s >> (l - 1)) for s in tshape)
        active = x[idx]
        for axis in range(-ndt, 0):
            active = _level_along_axis(active, h, g, axis, fw=False)
        x[idx] = active
    return x
