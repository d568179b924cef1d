"""Wavelet definitions: classes, filter tables, lifting schemes, carriers.

Usage mirrors the reference's WT module::

    from wavelets_tpu_torch import wt
    w  = wt.wavelet(wt.db2)                # OrthoFilter (filter transform)
    wl = wt.wavelet(wt.cdf97, wt.LIFTING)  # GLS (lifting transform)
"""

from .classes import (
    WaveletClass, OrthoWaveletClass, BiOrthoWaveletClass,
    Haar, Beylkin, Vaidyanathan, Daubechies, Coiflet, Symlet, Battle, CDF,
    ALL_CLASSES,
)
from .classes import *  # noqa: F401,F403  (the named shortcut instances)
from .daubechies import daubechies
from .filters import FILTERS
from .schemes import SCHEMES, LSStep, PREDICT, UPDATE
from .factor import lifting_factorization
from .carriers import (
    DiscreteWavelet, FilterWavelet, LSWavelet, OrthoFilter, GLS, wavelet,
    qmf, makeqmfpair, makereverseqmfpair,
    FILTER, LIFTING, PERIODIC, ZEROPAD, SYMMETRIC,
)

__all__ = [
    "WaveletClass", "OrthoWaveletClass", "BiOrthoWaveletClass",
    "Haar", "Beylkin", "Vaidyanathan", "Daubechies", "Coiflet", "Symlet",
    "Battle", "CDF", "ALL_CLASSES",
    "daubechies", "FILTERS", "SCHEMES", "LSStep", "PREDICT", "UPDATE",
    "lifting_factorization",
    "DiscreteWavelet", "FilterWavelet", "LSWavelet", "OrthoFilter", "GLS",
    "wavelet", "qmf", "makeqmfpair", "makereverseqmfpair",
    "FILTER", "LIFTING", "PERIODIC", "ZEROPAD", "SYMMETRIC",
] + list(ALL_CLASSES)
