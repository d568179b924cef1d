"""Maximal-overlap (undecimated, à-trous) DWT in PyTorch — any signal length.

The torch counterpart of ``wavelets_tpu/ops/modwt.py``.  Level j applies a
stride-2^(j-1) dilated periodic correlation (reference:
src/Transforms/transforms_maximal_overlap.jl):

    w_j[t] = sum_n h[n] * v[(t - n*2^(j-1)) mod N]
    v_j[t] = sum_n g[n] * v[(t - n*2^(j-1)) mod N]

with g = reverse(qmf)/sqrt(2), h = mirror(qmf)/sqrt(2), as torch.roll
accumulations on the tensor's own device; the periodic wrap is exact for
any N.  ``modwt_step`` and ``imodwt_step`` are the plain versions of the
MODWT kernels K and M (ops/modwt1d.py).

Output layout matches the reference: shape (..., N, L+1) with detail level
j in column j-1 and the final scaling band in column L.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.signals import mirror
from ..wt.carriers import OrthoFilter

__all__ = ["modwt_filter_pair", "modwt_step", "imodwt_step", "modwt",
           "imodwt"]


def modwt_filter_pair(wt: OrthoFilter):
    """(g, h): MODWT scaling and detail filters in float64, pre-scaled by
    1/sqrt(2).  Only an orthogonal filter has them: a lifting scheme is
    refused with a TypeError."""
    if not isinstance(wt, OrthoFilter):
        raise TypeError(f"the MODWT needs an orthogonal filter (OrthoFilter), "
                        f"not {type(wt).__name__}")
    q = wt.qmf_array()
    g = q[::-1] / np.sqrt(2.0)
    h = mirror(q) / np.sqrt(2.0)
    return g.copy(), h


def _dilated_corr(v, taps, dilation: int, sign: int):
    """sum_n taps[n] * v[(t + sign*n*dilation) mod N] along the last axis."""
    N = v.shape[-1]
    acc = None
    for n, c in enumerate(taps):
        sh = (-sign * n * dilation) % N
        term = torch.roll(v, sh, dims=-1) if sh else v
        term = float(c) * term
        acc = term if acc is None else acc + term
    return acc


def modwt_step(v, j: int, h, g):
    """One MODWT level: returns (v_{j}, w_{j}) from level-(j-1) scaling coefs."""
    dil = 2 ** (j - 1)
    w1 = _dilated_corr(v, h, dil, sign=-1)
    v1 = _dilated_corr(v, g, dil, sign=-1)
    return v1, w1


def imodwt_step(v, w, j: int, h, g):
    """Inverse of modwt_step: level-(j-1) scaling coefs from (v_j, w_j)."""
    dil = 2 ** (j - 1)
    return _dilated_corr(w, h, dil, sign=+1) + _dilated_corr(v, g, dil,
                                                             sign=+1)


def check_levels(N: int, L: int):
    """The JAX package's refusals: L >= 1 and 2^L <= N."""
    if L < 1:
        raise ValueError("L must be >= 1")
    if 2 ** L > N:
        raise ValueError("too many transform levels (N < 2^L)")


def modwt(x, wt: OrthoFilter, L: int):
    """MODWT of x along the last axis -> (..., N, L+1)."""
    check_levels(x.shape[-1], L)
    g, h = modwt_filter_pair(wt)
    v = x
    cols = []
    for j in range(1, L + 1):
        v, w = modwt_step(v, j, h, g)
        cols.append(w)
    cols.append(v)
    return torch.stack(cols, dim=-1)


def imodwt(xw, wt: OrthoFilter):
    """Inverse MODWT of an (..., N, L+1) coefficient array -> (..., N)."""
    g, h = modwt_filter_pair(wt)
    L = xw.shape[-1] - 1
    v = xw[..., L]
    for j in range(L, 0, -1):
        v = imodwt_step(v, xw[..., j - 1], j, h, g)
    return v
