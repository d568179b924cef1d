"""Subband API: the coefficients as separate bands instead of one packed
array.

The counterpart of ``wavelets_tpu/subbands.py``.  ``dwt_subbands`` returns
``{"ll": <coarse>, "levels": [(lh, hl, hh), ...]}`` for 2-D inputs (level
1 first), and ``{"s": <coarse>, "d": [d1, d2, ...]}`` for 1-D.
``from_packed`` returns views into the packed array; ``to_packed`` builds
it again with ``torch.cat``.
"""

from __future__ import annotations

import torch

from .transforms import _as_float, _as_tensor, dwt, idwt
from .utils.indexing import maxtransformlevels
from .wt.carriers import DiscreteWavelet

__all__ = [
    "dwt_subbands", "idwt_subbands", "to_packed", "from_packed",
]


def _split_packed_1d(y, L: int):
    n = y.shape[-1]
    return {
        "s": y[..., : n >> L],
        "d": [y[..., n >> l: n >> (l - 1)] for l in range(1, L + 1)],
    }


def _split_packed_2d(y, L: int):
    m, n = y.shape[-2:]
    levels = []
    for l in range(1, L + 1):
        mh, nh = m >> l, n >> l
        levels.append((y[..., :mh, nh: 2 * nh],
                       y[..., mh: 2 * mh, :nh],
                       y[..., mh: 2 * mh, nh: 2 * nh]))
    return {"ll": y[..., : m >> L, : n >> L], "levels": levels}


def from_packed(y, L: int, ndt: int | None = None, *, device=None):
    """Packed coefficient array -> subband dict (views of ``y``)."""
    y = _as_tensor(y, device)
    ndt = min(y.ndim, 2) if ndt is None else ndt
    if ndt == 1:
        return _split_packed_1d(y, L)
    if ndt == 2:
        return _split_packed_2d(y, L)
    raise ValueError("subband API supports ndt in (1, 2)")


def to_packed(bands):
    """Subband dict -> packed coefficient array."""
    if "s" in bands:  # 1-D
        y = bands["s"]
        for d in reversed(bands["d"]):
            y = torch.cat([y, d], dim=-1)
        return y
    y = bands["ll"]
    for lh, hl, hh in reversed(bands["levels"]):
        y = torch.cat([torch.cat([y, lh], dim=-1),
                       torch.cat([hl, hh], dim=-1)], dim=-2)
    return y


def dwt_subbands(x, wt: DiscreteWavelet, L: int | None = None,
                 *, ndt: int | None = None, device=None):
    """Forward DWT returning the subband dict (1-D and 2-D)."""
    x = _as_float(x, device)
    ndt_eff = min(x.ndim, 2) if ndt is None else ndt
    if L is None:
        L = maxtransformlevels(tuple(x.shape[-ndt_eff:]))
    y = dwt(x, wt, L, ndt=ndt_eff)
    return from_packed(y, int(L), ndt_eff)


def idwt_subbands(bands, wt: DiscreteWavelet):
    """Inverse DWT from a subband dict."""
    if "s" in bands:
        L = len(bands["d"])
        return idwt(to_packed(bands), wt, L, ndt=1)
    L = len(bands["levels"])
    return idwt(to_packed(bands), wt, L, ndt=2)
