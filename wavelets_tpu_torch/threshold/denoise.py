"""Denoising: VisuShrink and translation-invariant cycle-spinning.

The counterpart of ``wavelets_tpu/threshold/denoise.py`` (reference:
src/Threshold/denoising.jl).  The transforms are the port's ``dwt`` /
``idwt``, so on the card they run the CUDA kernels.  The TI path runs the
spins as the JAX package's two routes do: on the card one spin at a time
(its kernel route: each spin's transforms fill the card, and the peak
memory is one transform), on the CPU ``spin_chunk`` spins at a time (its
vmapped route: the chunk's rolled copies ride the drivers' leading
(batch) axis through one dwt -> threshold -> idwt, so the peak memory is
about ``spin_chunk`` transforms).  The threshold acts on each spin's
transform alone, as under vmap: ``BiggestTH`` keeps m coefficients of each.

Medians: ``jnp.median`` averages the two middle values; here
``torch.quantile(v, 0.5, interpolation="midpoint")`` does the same, below
its 2^24-element limit, and a sort above it.  ``mad_subsampled`` caps the
sample at 2^18 coefficients by a stride subsample, as the JAX package
does (a declared divergence from the reference, which takes the median of
an n/2-element flat chunk; see PARITY.md).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from ..utils.indexing import detailrange, iscube, maxtransformlevels
from ..wt import classes as _classes
from ..wt.carriers import DiscreteWavelet, wavelet
from ..transforms import _as_float, dwt, idwt
from .ops import HardTH, THType, threshold

__all__ = ["DNFT", "VisuShrink", "denoise", "noisest", "mad_subsampled",
           "DEFAULT_WAVELET"]

# torch.quantile refuses inputs above this many elements
_QUANTILE_MAX = 1 << 24


@dataclasses.dataclass(frozen=True)
class DNFT:
    pass


@dataclasses.dataclass(frozen=True, init=False)
class VisuShrink(DNFT):
    """Universal threshold sqrt(2 log n) (for unit sigma) with a threshold
    operator (default hard).

    Constructors mirror the reference (denoising.jl:36-44):
    ``VisuShrink(n)`` — universal threshold for signal length n with the
    default hard operator; ``VisuShrink(th, t)`` — explicit operator and
    threshold value.
    """
    th: THType
    t: float

    def __init__(self, th_or_n, t: float | None = None):
        if isinstance(th_or_n, (int, np.integer)) and t is None:
            th = HardTH()
            t = float(np.sqrt(2 * np.log(th_or_n)))
        else:
            th = th_or_n
        object.__setattr__(self, "th", th)
        object.__setattr__(self, "t", float(t))

    @staticmethod
    def for_length(n: int, th: THType = HardTH()) -> "VisuShrink":
        return VisuShrink(th, float(np.sqrt(2 * np.log(n))))


DEFAULT_WAVELET = wavelet(_classes.sym5, "filter")


def _median(v):
    """Median of a 1-D tensor, the two middle values averaged."""
    if v.numel() <= _QUANTILE_MAX:
        work = v if v.dtype in (torch.float32, torch.float64) else v.float()
        return torch.quantile(work, 0.5, interpolation="midpoint").to(v.dtype)
    s = torch.sort(v).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) / 2


def mad_subsampled(dr, cap: int = 1 << 18):
    """Median absolute deviation of the 1-D tensor ``dr``, with a
    deterministic stride subsample above ``cap`` coefficients (the JAX
    package's estimator, shared by ``noisest`` and the sharded one)."""
    if dr.shape[0] > cap:
        stride = -(-dr.shape[0] // cap)
        dr = dr[::stride]
    med = _median(dr)
    return _median((dr - med).abs())


def noisest(x, wt: DiscreteWavelet | None = DEFAULT_WAVELET, L: int = 1, *,
            device=None):
    """Estimate the noise sigma: MAD of the level-L detail band / 0.6745,
    as a 0-d tensor on ``x``'s device.

    reference: src/Threshold/denoising.jl:94-110.  As in the JAX package,
    for ndim > 1 the band is the rows that hold the level-L detail
    quadrants (the reference's linear indexing grabs a flat chunk; see
    PARITY.md).
    """
    x = _as_float(x, device)
    y = x if wt is None else dwt(x, wt, int(L), ndt=min(x.ndim, 3))
    r = detailrange(y.shape[0], L)
    dr = y.reshape(y.shape[0], -1)[r.start: r.stop].reshape(-1) \
        if y.ndim > 1 else y[r.start: r.stop]
    return mad_subsampled(dr) / 0.6745


def _spin_shifts(nspin, ndim: int) -> np.ndarray:
    """All shift vectors of the cycle-spin grid (Fortran order, matching the
    reference's CartesianIndices enumeration, denoising.jl:113-121)."""
    if isinstance(nspin, int):
        nspin = (nspin,)
    if len(nspin) != ndim:
        raise ValueError("nspin must have one entry per dimension")
    grids = [range(s) for s in nspin]
    # Julia CartesianIndices varies the first axis fastest
    combos = list(itertools.product(*reversed(grids)))
    return np.array([c[::-1] for c in combos], dtype=np.int32)


def denoise(x, wt: DiscreteWavelet | None = DEFAULT_WAVELET, *,
            L: int | None = None, dnt: DNFT | None = None,
            estnoise=noisest, TI: bool = False, nspin=None,
            spin_chunk: int = 8, device=None):
    """Wavelet-shrinkage denoising (reference: denoising.jl:22-82).

    TI=True averages over all circular shifts in the ``nspin`` grid
    (default 8 per dimension): on a CUDA tensor one at a time, on a CPU
    tensor ``spin_chunk`` at a time (at least one, at most the grid; peak
    memory ``spin_chunk`` full-size transforms).  ``device`` as for ``dwt``.
    """
    x = _as_float(x, device)
    if not iscube(x):
        raise ValueError("array must be square/cube")
    if L is None:
        L = min(maxtransformlevels(x), 6)
    L = int(L)
    if dnt is None:
        dnt = VisuShrink.for_length(x.shape[0])
    t = estnoise(x, wt) * dnt.t

    def pipe(z):   # z: x's shape, or a chunk of them on a leading axis
        y = dwt(z, wt, L, ndt=x.ndim)
        y = threshold(y, dnt.th, t) if z.ndim == x.ndim else \
            torch.stack([threshold(v, dnt.th, t) for v in y])
        return idwt(y, wt, L, ndt=x.ndim)

    if not TI:
        return threshold(x, dnt.th, t) if wt is None else pipe(x)
    if wt is None:
        raise ValueError("TI not supported with wt=None")
    if nspin is None:
        nspin = tuple(8 for _ in range(x.ndim))
    elif isinstance(nspin, int):
        nspin = (nspin,)
    else:
        nspin = tuple(nspin)
    shifts = [tuple(int(s) for s in sh) for sh in _spin_shifts(nspin, x.ndim)]
    dims = tuple(range(x.ndim))
    chunk = 1 if x.device.type == "cuda" else \
        max(1, min(int(spin_chunk), len(shifts)))
    acc = torch.zeros_like(x)
    for c0 in range(0, len(shifts), chunk):
        group = shifts[c0: c0 + chunk]
        zs = [torch.roll(x, sh, dims) for sh in group]
        zs = [pipe(zs[0])] if len(zs) == 1 else pipe(torch.stack(zs))
        for z, sh in zip(zs, group):
            acc += torch.roll(z, tuple(-s for s in sh), dims)
    return acc / len(shifts)
