"""Least bytes and operations of a multi-level periodic lifting DWT over
the trailing ``ndt`` axes, one direction.

Bytes: each level reads its active array once and writes its output once,
so ``2 * itemsize * numel * g`` with ``g = sum_l 2^(-ndt l)``, the active
array summed over the L levels as a multiple of the input:
``(4/3)(1 - 4^-L)`` in 2-D, ``(8/7)(1 - 8^-L)`` in 3-D.

Operations: one lifting pass along one axis costs, per sample, one
multiply-add (2 operations) per tap for the half a step writes, so one
operation a tap of every step, and one multiply by the half's norm; each
level runs ``ndt`` passes over its active array.
"""

from __future__ import annotations

import math

__all__ = ["geometric", "one_direction"]


def geometric(L: int, ndt: int) -> float:
    """The active array summed over L levels, as a multiple of the input."""
    r = 2.0 ** -ndt
    return (1 - r ** L) / (1 - r)


def one_direction(shape, L: int, itemsize: int, sch: dict,
                  ndt: int) -> tuple[float, float]:
    """(bytes, operations) of one forward or inverse L-level transform of
    an array of ``shape`` (leading axes batch)."""
    n = math.prod(shape)
    g = geometric(L, ndt)
    per_sample = sum(len(step["taps"]) for step in sch["steps"]) + 1
    return 2.0 * itemsize * n * g, float(n) * g * ndt * per_sample
