"""Thresholding operators, elementwise on tensors.

The counterpart of ``wavelets_tpu/threshold/ops.py`` (reference:
src/Threshold/threshold_main.jl): hard, soft, semisoft, stein,
biggest-m-term, pos and neg.  Operators are singleton marker objects, so
call sites read like the reference (``threshold(x, HardTH(), t)``).
``BiggestTH`` keeps the m largest magnitudes; among equal magnitudes the
lower index wins, as ``lax.top_k`` decides, through a stable sort of
``-|x|`` (``torch.topk`` leaves the order of ties unspecified on CUDA).

A tensor stays on its device; any other input goes to the card unless
``device`` is given (the port's device rule, transforms.py).
"""

from __future__ import annotations

import dataclasses

import torch

from ..transforms import _as_tensor

__all__ = [
    "THType", "HardTH", "SoftTH", "SemiSoftTH", "SteinTH", "BiggestTH",
    "PosTH", "NegTH", "threshold", "DEFAULT_TH",
]


@dataclasses.dataclass(frozen=True)
class THType:
    pass


@dataclasses.dataclass(frozen=True)
class HardTH(THType):
    """x -> 0 where |x| <= t."""


@dataclasses.dataclass(frozen=True)
class SoftTH(THType):
    """x -> sign(x) * max(|x| - t, 0)."""


@dataclasses.dataclass(frozen=True)
class SemiSoftTH(THType):
    """0 for |x|<=t, linear ramp sign(x)*2(|x|-t) for t<|x|<2t, identity above."""


@dataclasses.dataclass(frozen=True)
class SteinTH(THType):
    """x -> x * max(1 - t^2/x^2, 0)."""


@dataclasses.dataclass(frozen=True)
class BiggestTH(THType):
    """Keep the m largest-magnitude coefficients, zero the rest."""


@dataclasses.dataclass(frozen=True)
class PosTH(THType):
    """Zero positive entries."""


@dataclasses.dataclass(frozen=True)
class NegTH(THType):
    """Zero negative entries."""


DEFAULT_TH = HardTH()


def _biggest(x, m: int):
    n = x.numel()
    m = max(0, min(int(m), n))
    if m == 0:
        return torch.zeros_like(x)
    flat = x.reshape(-1)
    idx = torch.sort(-flat.abs(), stable=True).indices[:m]
    keep = torch.zeros(n, dtype=torch.bool, device=x.device)
    keep[idx] = True
    return torch.where(keep, flat, 0).reshape(x.shape)


def threshold(x, th: THType, t=None, *, device=None):
    """Apply a thresholding operator; returns a new tensor.

    For BiggestTH, ``t`` is the integer m (number of kept coefficients);
    otherwise the non-negative threshold value (a number or a 0-d tensor,
    such as a noise estimate still on the card).
    """
    x = _as_tensor(x, device)
    if isinstance(th, BiggestTH):
        return _biggest(x, t)
    if isinstance(th, PosTH):
        return torch.where(x > 0, 0, x)
    if isinstance(th, NegTH):
        return torch.where(x < 0, 0, x)

    mag = x.abs()
    t = torch.as_tensor(t, dtype=mag.dtype, device=x.device)
    if isinstance(th, HardTH):
        return torch.where(mag <= t, 0, x)
    if isinstance(th, SoftTH):
        sh = mag - t
        return torch.where(sh < 0, 0, torch.sgn(x) * sh)
    if isinstance(th, SemiSoftTH):
        sh = mag - t
        ramp = torch.sgn(x) * sh * 2
        return torch.where(sh < 0, 0, torch.where(sh < t, ramp, x))
    if isinstance(th, SteinTH):
        sh = 1 - t * t / (x * x)
        return torch.where(sh < 0, 0, x * sh)
    raise ValueError(f"unknown threshold type {th!r}")
