"""Analysis and synthesis bands of one periodic DWT level, in float64.

A level of either engine is a pair of periodic correlations along each
axis, so it is fully described by its bands:

    a[k] = sum_i coef_s[i] * x[(2k + delta_s[i]) mod n]
    d[k] = sum_i coef_d[i] * x[(2k + delta_d[i]) mod n]

and, for the inverse, by the per-parity synthesis bands

    x[2k + p] = sum_i cS[p][i] * s[(k + dS[p][i]) mod n/2]
              + sum_i cD[p][i] * d[(k + dD[p][i]) mod n/2].

The same numbers drive the CUDA kernels and their plain versions
(ops/level2d.py, ops/tail2d.py) for filter and lifting wavelets alike.
The extraction is a copy of ``wavelets_tpu/ops/pallas/mxu2d.py``
(``level_bands``, ``synthesis_bands``, ``_band_reach``, ``_syn_reach``),
kept operation for operation so that both packages hold bit-identical
bands.  Results are cached per wavelet and returned read-only.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..wt.carriers import OrthoFilter
from ..wt.schemes import PREDICT
from .filter_fb import filter_pair

__all__ = ["level_bands", "synthesis_bands", "band_reach", "syn_reach",
           "tap_count", "acc_dtype", "BandTable", "band_table"]


def _frozen(*arrays):
    for a in arrays:
        a.setflags(write=False)
    return arrays


@lru_cache(maxsize=None)
def level_bands(wt):
    """Analysis bands ``(delta_s, coef_s, delta_d, coef_d)`` in float64.

    Exact for both engines by construction from their own formulations:
    the filter taps for an OrthoFilter, and for a GLS the lifting chain
    run on a circulant response matrix.
    """
    if isinstance(wt, OrthoFilter):
        h, g = filter_pair(wt)
        h = np.asarray(h, np.float64)
        g = np.asarray(g, np.float64)
        return _frozen(np.arange(len(h)), h, 1 - np.arange(len(g)), g)
    N = 512
    N2 = N // 2
    S = np.zeros((N2, N))
    D = np.zeros((N2, N))
    S[np.arange(N2), 2 * np.arange(N2)] = 1.0
    D[np.arange(N2), 2 * np.arange(N2) + 1] = 1.0
    for st in wt.steps:
        src = D if st.kind == PREDICT else S
        acc = np.zeros_like(src)
        for k, c in enumerate(st.coef):
            # roll(src, sh)[i] = src[i - sh] with sh = shift - k
            acc += c * np.roll(src, st.shift - k, axis=0)
        if st.kind == PREDICT:
            S = S - acc
        else:
            D = D - acc
    S *= wt.norm1
    D *= wt.norm2
    k0 = N2 // 2

    def band(M):
        row = M[k0]
        nz = np.nonzero(np.abs(row) > 0.0)[0]
        return nz - 2 * k0, row[nz]

    ds, cs = band(S)
    dd, cd = band(D)
    return _frozen(ds, cs, dd, cd)


def band_reach(wt):
    """(left, right) reach of the analysis bands around 2k."""
    ds, _, dd, _ = level_bands(wt)
    deltas = np.concatenate([ds, dd])
    return int(-deltas.min()), int(deltas.max())


@lru_cache(maxsize=None)
def synthesis_bands(wt):
    """Per-parity synthesis bands, float64, as
    ``((dS0, cS0), (dD0, cD0), (dS1, cS1), (dD1, cD1))``.

    Derived from the analysis bands: build the periodic analysis matrix,
    invert it (its transpose for an orthogonal filter bank), and read the
    bands off the circulant rows.  Entries below 1e-10 are dropped.
    """
    ds, cs, dd, cd = level_bands(wt)
    N = 512
    N2 = N // 2
    T = np.zeros((N, N))
    for k in range(N2):
        for dlt, c in zip(ds, cs):
            T[k, (2 * k + dlt) % N] += c
        for dlt, c in zip(dd, cd):
            T[N2 + k, (2 * k + dlt) % N] += c
    Ti = T.T if isinstance(wt, OrthoFilter) else np.linalg.inv(T)
    k0 = N2 // 2
    out = []
    for p in (0, 1):
        row = Ti[2 * k0 + p]
        for resp in (row[:N2], row[N2:]):
            nz = np.nonzero(np.abs(resp) > 1e-10)[0]
            out.append(_frozen(nz - k0, resp[nz]))
    return tuple(out)


def syn_reach(wt):
    """(left, right) reach of the synthesis bands around k."""
    deltas = np.concatenate([d for d, _ in synthesis_bands(wt)])
    return int(-deltas.min()), int(deltas.max())


def tap_count(wt, inverse: bool) -> int:
    """Taps of one level: the analysis bands (s and d), or all four
    synthesis bands."""
    if inverse:
        return sum(len(d) for d, _ in synthesis_bands(wt))
    ds, _, dd, _ = level_bands(wt)
    return len(ds) + len(dd)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Arithmetic type of a storage type: float64 for float64, float32 for
    float32 and bfloat16."""
    return torch.float64 if dtype == torch.float64 else torch.float32


class BandTable(NamedTuple):
    """A level's bands as the kernels take them: int32 offsets and
    coefficients in the arithmetic type, concatenated band after band."""
    offs: torch.Tensor
    coefs: torch.Tensor
    counts: tuple          # taps per band
    dmin: int              # smallest offset
    span: int              # largest offset minus smallest

    @property
    def nbytes(self) -> int:
        """Shared memory the table takes inside a kernel."""
        return self.offs.numel() * 4 + self.coefs.numel() * \
            self.coefs.element_size()


@lru_cache(maxsize=None)
def band_table(wt, synthesis: bool, dtype: torch.dtype,
               device: torch.device) -> BandTable:
    """Analysis bands (s, d) or synthesis bands (S0, D0, S1, D1) of ``wt``
    for storage ``dtype``, built once per (wavelet, dtype, device)."""
    if synthesis:
        bands = synthesis_bands(wt)
    else:
        ds, cs, dd, cd = level_bands(wt)
        bands = ((ds, cs), (dd, cd))
    offs = np.concatenate([d for d, _ in bands])
    coefs = np.concatenate([c for _, c in bands])
    return BandTable(
        torch.as_tensor(offs.astype(np.int32), device=device),
        torch.as_tensor(coefs, device=device).to(acc_dtype(dtype)),
        tuple(len(d) for d, _ in bands),
        int(offs.min()), int(offs.max() - offs.min()))
