"""Index math, trees, and signal utilities (host-side, trace-time)."""

from .indexing import (
    detailindex, detailrange, detailn,
    maxtransformlevels, maxmodwttransformlevels,
    dyadicdetailindex, dyadicdetailrange, dyadicscalingrange,
    dyadicdetailn, ndyadicscales, maxdyadiclevel,
    tl2dyadiclevel, dyadiclevel2tl,
    iscube, isdyadic, sufficientpoweroftwo,
)
from .trees import maketree, isvalidtree, treedepth
from .signals import (
    mirror, upsample, downsample, wcount, circshift,
    makewavelet, testfunction,
)

__all__ = [
    "detailindex", "detailrange", "detailn",
    "maxtransformlevels", "maxmodwttransformlevels",
    "dyadicdetailindex", "dyadicdetailrange", "dyadicscalingrange",
    "dyadicdetailn", "ndyadicscales", "maxdyadiclevel",
    "tl2dyadiclevel", "dyadiclevel2tl",
    "iscube", "isdyadic", "sufficientpoweroftwo",
    "maketree", "isvalidtree", "treedepth",
    "mirror", "upsample", "downsample", "wcount", "circshift",
    "makewavelet", "testfunction",
]
