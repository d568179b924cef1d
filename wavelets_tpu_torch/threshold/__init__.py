"""Application layer: thresholding, denoising, entropy/best-basis, pursuit."""

from .ops import (
    THType, HardTH, SoftTH, SemiSoftTH, SteinTH, BiggestTH, PosTH, NegTH,
    threshold, DEFAULT_TH,
)
from .denoise import DNFT, VisuShrink, denoise, noisest, DEFAULT_WAVELET
from .entropy import (
    Entropy, ShannonEntropy, LogEnergyEntropy, coefentropy, bestbasistree,
)
from .pursuit import matchingpursuit

__all__ = [
    "THType", "HardTH", "SoftTH", "SemiSoftTH", "SteinTH", "BiggestTH",
    "PosTH", "NegTH", "threshold", "DEFAULT_TH",
    "DNFT", "VisuShrink", "denoise", "noisest", "DEFAULT_WAVELET",
    "Entropy", "ShannonEntropy", "LogEnergyEntropy", "coefentropy",
    "bestbasistree", "matchingpursuit",
]
