"""Entropy measures and best-basis tree search.

The counterpart of ``wavelets_tpu/threshold/entropy.py`` (reference:
src/Threshold/entropy.jl).  The packet levels run one launch per depth
(ops/wpt.py's ``packet_level``: kernel E for a periodic boundary), each
depth's per-node entropies are one segment sum, and the
Coifman–Wickerhauser min-prune runs on the entropies' device in their own
dtype, as the reference computes it in T (entropy.jl:112-129).  Only the
finished tree leaves the device, as a NumPy bool heap.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.wpt import packet_level
from ..transforms import _as_float
from ..utils.indexing import maxtransformlevels
from ..utils.trees import isvalidtree
from ..wt.carriers import DiscreteWavelet

__all__ = [
    "Entropy", "ShannonEntropy", "LogEnergyEntropy", "coefentropy",
    "bestbasistree",
]


@dataclasses.dataclass(frozen=True)
class Entropy:
    pass


@dataclasses.dataclass(frozen=True)
class ShannonEntropy(Entropy):
    """Coifman–Wickerhauser: sum of -s log s, s = (x/nrm)^2."""


@dataclasses.dataclass(frozen=True)
class LogEnergyEntropy(Entropy):
    """Sum of -log s, s = (x/nrm)^2."""


def _coef_terms(x, et: Entropy, nrm):
    s = (x / nrm) ** 2
    if isinstance(et, ShannonEntropy):
        return torch.where(s == 0, 0.0, -s * torch.log(s))
    if isinstance(et, LogEnergyEntropy):
        return torch.where(s == 0, 0.0, -torch.log(s))
    raise ValueError(f"unknown entropy {et!r}")


def coefentropy(x, et: Entropy = ShannonEntropy(), nrm=None, *, device=None):
    """Additive entropy of a coefficient block (normalized by ``nrm``,
    default its own l2 norm), as a 0-d tensor on ``x``'s device."""
    x = _as_float(x, device)
    if nrm is None:
        nrm = torch.linalg.norm(x.reshape(-1))
    return torch.sum(_coef_terms(x, et, nrm))


def _depth_masks(n, tree, L, Lmax, device):
    """Per-depth activity of the search: None (all active), False (all
    inactive) or a bool tensor of the 2^d tree bits."""
    if tree is None:
        active_L = Lmax if L is None else int(L)
        if not 0 <= active_L <= Lmax:
            raise ValueError(f"L={active_L} out of range (max {Lmax})")
        return [None if d < active_L else False for d in range(Lmax)]
    if not isvalidtree(n, tree):
        raise ValueError("invalid tree")
    bits = torch.as_tensor(np.asarray(tree, dtype=bool), device=device)
    return [bits[2 ** d - 1: 2 ** (d + 1) - 1] for d in range(Lmax)]


def prune(entr_levels, entr_af, masks) -> np.ndarray:
    """Coifman–Wickerhauser min-prune: the per-depth before-entropies
    (length 2^d at depth d), the bottom nodes' after-entropies and the
    per-depth masks of :func:`_depth_masks` -> the best tree as a NumPy
    bool heap.  Arithmetic in the entropies' dtype, on their device."""
    D = len(entr_levels)
    best = torch.minimum(entr_levels[-1], entr_af)
    best_children = [entr_af]                 # children sums per depth
    for d in range(D - 2, -1, -1):
        child_sum = best.view(-1, 2).sum(-1)
        best_children.append(child_sum)
        best = torch.minimum(entr_levels[d], child_sum)
    best_children.reverse()                   # [d] = children sums at d
    # top-down: keep a split only if its before-entropy exceeds the
    # cheapest children sum AND its parent stayed split
    device = entr_af.device
    bits = []
    parent_on = torch.ones(1, dtype=torch.bool, device=device)
    for d in range(D):
        if masks[d] is False:                 # inactive depth
            bits.append(torch.zeros(2 ** d, dtype=torch.bool, device=device))
            continue
        on = parent_on & (entr_levels[d] > best_children[d])
        if masks[d] is not None:
            on = on & masks[d]
        bits.append(on)
        parent_on = on.repeat_interleave(2)
    return torch.cat(bits).cpu().numpy()


def bestbasistree(y, wt: DiscreteWavelet, L: int | None = None,
                  tree: np.ndarray | None = None,
                  et: Entropy = ShannonEntropy(), *,
                  device=None) -> np.ndarray:
    """Best-basis subtree of ``tree`` (default: full tree of depth L) for a
    1-D signal, via the Coifman–Wickerhauser bottom-up entropy prune.

    As the reference, every depth of the packet transform is taken and
    entropied, even for a depth-limited tree (entropy.jl:58-81).
    reference: src/Threshold/entropy.jl:47-129
    """
    y = _as_float(y, device)
    if y.ndim != 1:
        raise ValueError("bestbasistree expects a 1-D signal")
    n = y.shape[0]
    Lmax = maxtransformlevels(n)
    masks = _depth_masks(n, tree, L, Lmax, y.device)
    nrm = torch.linalg.norm(y)
    x = y
    entr = []
    for d in range(Lmax):
        segs = x.reshape(2 ** d, n >> d)
        entr.append(_coef_terms(segs, et, nrm).sum(-1))
        x = packet_level(segs, wt, True).reshape(n)
    entr_af = _coef_terms(x.reshape(2 ** (Lmax - 1), -1), et, nrm).sum(-1)
    return prune(entr, entr_af, masks)
