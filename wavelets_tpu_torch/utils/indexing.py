"""Coefficient-index arithmetic for packed DWT layouts.

The packed 1-D layout (shared with the reference library, see
src/Util/non_dyadic.jl:1-25 and dyadic.jl:1-20) is::

    y = [ s_L | d_L | d_{L-1} | ... | d_1 ]

where after an L-level transform of a length-n signal the scaling band
``s_L`` occupies ``y[0 : n/2^L]`` and the level-l detail band occupies
``y[n/2^l : n/2^(l-1)]``.

All functions here are pure Python/NumPy integer math, evaluated at trace
time.  Indices are 0-based (the reference is 1-based Julia; ranges are
returned as Python ``range`` objects over 0-based positions).
"""

from __future__ import annotations

import math
from typing import Sequence, Union

__all__ = [
    # non-dyadic
    "detailindex", "detailrange", "detailn",
    "maxtransformlevels", "maxmodwttransformlevels",
    # dyadic
    "dyadicdetailindex", "dyadicdetailrange", "dyadicscalingrange",
    "dyadicdetailn", "ndyadicscales", "maxdyadiclevel",
    "tl2dyadiclevel", "dyadiclevel2tl",
    # predicates
    "iscube", "isdyadic", "sufficientpoweroftwo",
]

ShapeLike = Union[int, Sequence[int]]


def _first_dim(n: ShapeLike) -> int:
    if isinstance(n, int):
        return n
    if hasattr(n, "shape"):  # array-like
        return int(n.shape[0])
    return int(n[0])


def _dims(x) -> Sequence[int]:
    if isinstance(x, int):
        return (x,)
    if hasattr(x, "shape"):
        return tuple(int(s) for s in x.shape)
    return tuple(int(s) for s in x)


# --- non-dyadic (any n with enough factors of two) --------------------------
# reference: src/Util/non_dyadic.jl

def detailn(n: ShapeLike, l: int) -> int:
    """Number of detail coefficients at level ``l`` (l >= 1)."""
    return round(_first_dim(n) / 2 ** l)


def detailindex(n: ShapeLike, l: int, i: int) -> int:
    """0-based packed index of the i-th (0-based) detail coef at level l."""
    return round(_first_dim(n) / 2 ** l) + i


def detailrange(n: ShapeLike, l: int) -> range:
    """0-based range of the level-l detail band in the packed layout."""
    n = _first_dim(n)
    return range(round(n / 2 ** l), round(n / 2 ** (l - 1)))


def maxtransformlevels(x: ShapeLike) -> int:
    """Multiplicity of the factor 2 in every dimension of ``x``.

    For an int: largest L with n % 2^L == 0 (0 if n <= 1).
    """
    dims = _dims(x)
    return min(_maxtransformlevels_int(n) for n in dims)


def _maxtransformlevels_int(n: int) -> int:
    if n <= 1:
        return 0
    tl = 0
    while n % (2 ** tl) == 0:
        tl += 1
    return tl - 1


def maxmodwttransformlevels(x: ShapeLike) -> int:
    """floor(log2(n)) — MODWT admits any length."""
    if isinstance(x, int):
        n = x
    elif hasattr(x, "shape"):
        n = 1
        for s in x.shape:
            n *= int(s)
    else:
        n = _first_dim(x)
    return int(math.floor(math.log2(n)))


# --- dyadic (n = 2^J) -------------------------------------------------------
# reference: src/Util/dyadic.jl
# Level j counts from the coarse end: detail level j holds 2^j coefs at
# packed positions [2^j, 2^(j+1)).

def dyadicdetailindex(j: int, i: int) -> int:
    """0-based packed index of the i-th (0-based) dyadic detail coef at level j."""
    return 2 ** j + i


def dyadicdetailrange(j: int) -> range:
    return range(2 ** j, 2 ** (j + 1))


def dyadicscalingrange(j: int) -> range:
    return range(0, 2 ** j)


def dyadicdetailn(j: int) -> int:
    return 2 ** j


def ndyadicscales(n: ShapeLike) -> int:
    return round(math.log2(_first_dim(n)))


def maxdyadiclevel(n: ShapeLike) -> int:
    return ndyadicscales(n) - 1


def tl2dyadiclevel(n: ShapeLike, L: int) -> int:
    """Convert a number of transformed levels L to the minimum dyadic level j."""
    return ndyadicscales(n) - L


def dyadiclevel2tl(n: ShapeLike, j: int) -> int:
    return tl2dyadiclevel(n, j)


# --- predicates -------------------------------------------------------------
# reference: src/Util/util_main.jl:4-27

def iscube(x) -> bool:
    """All dimensions equal?"""
    dims = _dims(x)
    return all(d == dims[0] for d in dims)


def isdyadic(x) -> bool:
    """Every dimension (or the int itself) a power of two?"""
    if isinstance(x, int):
        # a predicate must answer False for 0/negative, not raise a
        # math-domain error out of log2 (code-review r5)
        return x > 0 and x == 2 ** ndyadicscales(x)
    return all(isdyadic(d) for d in _dims(x))


def sufficientpoweroftwo(x, L: int) -> bool:
    """Can ``x`` support an L-level transform (each dim divisible by 2^L)?"""
    if isinstance(x, int):
        return x % (2 ** L) == 0
    return all(d % (2 ** L) == 0 for d in _dims(x))
