"""Transform-carrier types: OrthoFilter and GLS, and the wavelet() factory.

These are hashable frozen objects holding float64 coefficients as tuples;
they are passed to transforms as *static* arguments, so each (wavelet,
shape, levels) combination compiles once and caches.

Mirrors the reference surface: OrthoFilter / GLS / wavelet()
(src/WT/wt_main.jl:132-264), QMF-pair derivation
(src/WT/wt_main.jl:166-183).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..utils.signals import mirror
from .classes import WaveletClass, OrthoWaveletClass, Daubechies
from .daubechies import daubechies
from .filters import FILTERS
from .schemes import SCHEMES, LSStep

__all__ = [
    "DiscreteWavelet", "FilterWavelet", "LSWavelet",
    "OrthoFilter", "GLS", "wavelet",
    "qmf", "makeqmfpair", "makereverseqmfpair",
    "FILTER", "LIFTING", "PERIODIC", "ZEROPAD", "SYMMETRIC",
]

FILTER = "filter"
LIFTING = "lifting"
PERIODIC = "periodic"
ZEROPAD = "zeropad"
SYMMETRIC = "symmetric"

# The reference declares ZPBoundary/SymBoundary/NullBoundary but implements
# only periodic (src/WT/wt_main.jl:33-49).  Here the LIFTING engine
# additionally supports zero-pad and (half-sample) symmetric extension with
# exact reconstruction — every lifting step is invertible under any
# deterministic extension of the kept half (ops/lifting.py).  The filter
# engine stays periodic-only: a decimated filter bank with non-periodic
# extension is not perfectly reconstructible at same-size coefficient
# arrays, which is presumably why the reference never implemented it.
_SUPPORTED_BOUNDARIES = (PERIODIC, ZEROPAD, SYMMETRIC)


class DiscreteWavelet:
    """Base for transform carriers."""


class FilterWavelet(DiscreteWavelet):
    pass


class LSWavelet(DiscreteWavelet):
    pass


@dataclasses.dataclass(frozen=True)
class OrthoFilter(FilterWavelet):
    """Orthogonal filter-bank wavelet: an l2-normalized QMF + a name.

    reference: src/WT/wt_main.jl:139-163
    """
    qmf: Tuple[float, ...]
    name: str
    boundary: str = PERIODIC

    def __len__(self):
        return len(self.qmf)

    def qmf_array(self) -> np.ndarray:
        return np.asarray(self.qmf, dtype=np.float64)

    def scale(self, a: float) -> "OrthoFilter":
        """Scale all taps by a scalar."""
        return OrthoFilter(tuple(c * a for c in self.qmf), self.name,
                           self.boundary)


def _ortho_filter_from_class(w: OrthoWaveletClass, boundary: str) -> OrthoFilter:
    name = w.name()
    if isinstance(w, Daubechies):
        h = daubechies(w.vanishingmoments())
    else:
        if name not in FILTERS:
            raise ValueError(f"filter not found: {name!r}")
        h = FILTERS[name]
    h = np.asarray(h, dtype=np.float64)
    h = h / np.linalg.norm(h)
    return OrthoFilter(tuple(float(c) for c in h), name, boundary)


@dataclasses.dataclass(frozen=True)
class GLS(LSWavelet):
    """General lifting scheme: step sequence + half normalizations.

    reference: src/WT/wt_main.jl:224-236
    """
    steps: Tuple[LSStep, ...]
    norm1: float
    norm2: float
    name: str
    boundary: str = PERIODIC


def _gls_from_class(w: WaveletClass, boundary: str) -> GLS:
    """GLS from the published SCHEMES table, or — beyond the reference,
    which supports lifting for FOUR wavelets only (src/WT/wt_main.jl:
    451-480) — from an on-the-fly Daubechies-Sweldens polyphase
    factorization of the class's orthogonal filter (wt/factor.py).  The
    factored scheme reproduces the filter transform to the coefficient
    table's own orthonormality precision and is exactly invertible."""
    name = w.name()
    if name in SCHEMES:
        steps, n1, n2 = SCHEMES[name]
        return GLS(steps, n1, n2, name, boundary)
    if isinstance(w, OrthoWaveletClass):
        from .factor import lifting_factorization
        f = _ortho_filter_from_class(w, PERIODIC)
        try:
            steps, n1, n2 = lifting_factorization(f.qmf, name)
        except ValueError as e:
            raise ValueError(
                f"lifting scheme not found: {name!r} ({e})") from e
        return GLS(steps, n1, n2, name, boundary)
    raise ValueError(f"lifting scheme not found: {name!r}")


def wavelet(c: WaveletClass, transform: str = FILTER,
            boundary: str = PERIODIC) -> DiscreteWavelet:
    """Construct a wavelet carrier from a class.

    ``transform`` is "filter" (OrthoFilter) or "lifting" (GLS);
    ``boundary`` is "periodic" (the reference's only implemented boundary,
    src/WT/wt_main.jl:240-264), or — for the lifting transform only —
    "zeropad" / "symmetric" (an extension beyond the reference; exact
    reconstruction, see ops/lifting.py).
    """
    if boundary not in _SUPPORTED_BOUNDARIES:
        raise ValueError(f"unsupported boundary {boundary!r}; "
                         f"supported: {_SUPPORTED_BOUNDARIES}")
    if transform == FILTER and boundary != PERIODIC:
        raise NotImplementedError(
            f"boundary {boundary!r} is only available with "
            "transform='lifting' (the decimated filter bank is not "
            "perfectly reconstructible under non-periodic extension at "
            "same-size coefficient arrays)")
    if transform == FILTER:
        if not isinstance(c, OrthoWaveletClass):
            raise ValueError(
                f"filter transform requires an orthogonal class, got {c!r} "
                "(use transform='lifting' for biorthogonal classes)")
        return _ortho_filter_from_class(c, boundary)
    if transform == LIFTING:
        return _gls_from_class(c, boundary)
    raise ValueError(f"unknown transform type {transform!r}")


# --- QMF pair derivation ----------------------------------------------------

def qmf(f: OrthoFilter) -> np.ndarray:
    return f.qmf_array()


def makereverseqmfpair(f: OrthoFilter, fw: bool = True,
                       dtype=np.float64):
    """(scfilter, dcfilter) in *reversed* (FIR-state) orientation.

    Forward:  scfilter = reverse(h),  dcfilter = mirror(h)
    Inverse:  scfilter = h,           dcfilter = reverse(mirror(h))

    reference: src/WT/wt_main.jl:172-183
    """
    h = np.asarray(f.qmf, dtype=dtype)
    if fw:
        scfilter = h[::-1].copy()
        dcfilter = mirror(h)
    else:
        scfilter = h.copy()
        dcfilter = mirror(h)[::-1].copy()
    return scfilter, dcfilter


def makeqmfpair(f: OrthoFilter, fw: bool = True, dtype=np.float64):
    """(scfilter, dcfilter) in convolution orientation (reversed pair
    reversed back).  reference: src/WT/wt_main.jl:166-169
    """
    scfilter, dcfilter = makereverseqmfpair(f, fw, dtype)
    return scfilter[::-1].copy(), dcfilter[::-1].copy()
