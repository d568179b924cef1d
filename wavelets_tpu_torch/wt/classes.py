"""Wavelet classes: named families with vanishing-moment parameters.

Mirrors the reference type hierarchy (src/WT/wt_main.jl:51-128) with plain
frozen dataclasses.  Instances are hashable and serve as static (trace-time)
arguments to jitted transforms.

Shortcuts mirror the reference constants: ``wt.haar``, ``wt.db2``,
``wt.coif4``, ``wt.sym8``, ``wt.batt4``, ``wt.beyl``, ``wt.vaid``,
``wt.cdf97``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

__all__ = [
    "WaveletClass", "OrthoWaveletClass", "BiOrthoWaveletClass",
    "Haar", "Beylkin", "Vaidyanathan", "Daubechies", "Coiflet", "Symlet",
    "Battle", "CDF", "ALL_CLASSES",
]


@dataclasses.dataclass(frozen=True)
class WaveletClass:
    """Base for all wavelet classes."""

    def class_name(self) -> str:
        raise NotImplementedError

    def name(self) -> str:
        raise NotImplementedError

    def vanishingmoments(self) -> Union[int, Tuple[int, int]]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class OrthoWaveletClass(WaveletClass):
    pass


@dataclasses.dataclass(frozen=True)
class BiOrthoWaveletClass(WaveletClass):
    pass


@dataclasses.dataclass(frozen=True)
class Haar(OrthoWaveletClass):
    def class_name(self): return "Haar"
    def name(self): return "haar"
    def vanishingmoments(self): return 1


@dataclasses.dataclass(frozen=True)
class Beylkin(OrthoWaveletClass):
    def class_name(self): return "Beylkin"
    def name(self): return "beyl"
    def vanishingmoments(self): return -1


@dataclasses.dataclass(frozen=True)
class Vaidyanathan(OrthoWaveletClass):
    def class_name(self): return "Vaidyanathan"
    def name(self): return "vaid"
    def vanishingmoments(self): return -1


@dataclasses.dataclass(frozen=True)
class Daubechies(OrthoWaveletClass):
    N: int

    def __post_init__(self):
        if self.N < 1:
            raise ValueError("Daubechies N must be >= 1")

    def class_name(self): return "Daubechies"
    def name(self): return f"db{self.N}"
    def vanishingmoments(self): return self.N


@dataclasses.dataclass(frozen=True)
class Coiflet(OrthoWaveletClass):
    N: int

    def class_name(self): return "Coiflet"
    def name(self): return f"coif{self.N}"
    def vanishingmoments(self): return self.N


@dataclasses.dataclass(frozen=True)
class Symlet(OrthoWaveletClass):
    N: int

    def class_name(self): return "Symlet"
    def name(self): return f"sym{self.N}"
    def vanishingmoments(self): return self.N


@dataclasses.dataclass(frozen=True)
class Battle(OrthoWaveletClass):
    N: int

    def class_name(self): return "Battle"
    def name(self): return f"batt{self.N}"
    def vanishingmoments(self): return self.N


@dataclasses.dataclass(frozen=True)
class CDF(BiOrthoWaveletClass):
    N1: int
    N2: int

    def class_name(self): return "CDF"
    def name(self): return f"cdf{self.N1}/{self.N2}"
    def vanishingmoments(self): return (self.N1, self.N2)


def _shortcuts():
    out = {
        "haar": Haar(), "beyl": Beylkin(), "vaid": Vaidyanathan(),
        "cdf97": CDF(9, 7),
    }
    for n in range(1, 11):
        out[f"db{n}"] = Daubechies(n)
    for n in (2, 4, 6, 8):
        out[f"coif{n}"] = Coiflet(n)
    for n in range(4, 11):
        out[f"sym{n}"] = Symlet(n)
    for n in (2, 4, 6):
        out[f"batt{n}"] = Battle(n)
    return out


ALL_CLASSES = _shortcuts()
globals().update(ALL_CLASSES)
__all__ += list(ALL_CLASSES)
