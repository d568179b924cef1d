"""wavelets_tpu_torch: the PyTorch and CUDA port of ``wavelets_tpu``.

It runs the periodic 2-D DWT, the periodic 1-D DWT (batched rows and
single long signals, ``ndt=1``) and the wavelet packet transform, with
their inverses, through hand-written CUDA kernels for the H100
(``csrc/``, built with ``nvcc`` at first use), with a plain PyTorch version
beside every kernel that a CPU tensor takes.  The other routes run on the
torch engines (``ops/lifting.py``, ``ops/filter_fb.py``).  A non-tensor
input runs on the CUDA card unless ``device`` is given.  The package
imports ``torch`` and NumPy, never JAX.

Public surface (the part of ``wavelets_tpu``'s that is ported so far):

  transforms:  dwt, idwt (ndt = 1, 2, 3), wpt, iwpt
  wavelets:    wt.wavelet, wt.cdf97, wt.haar, wt.db4, ... (wt module)
  utilities:   index math, maketree, isvalidtree, testfunction, ...
"""

from . import wt
from . import utils
from .utils import (
    detailindex, detailrange, detailn,
    maxtransformlevels, maxmodwttransformlevels,
    dyadicdetailindex, dyadicdetailrange, dyadicscalingrange,
    dyadicdetailn, ndyadicscales, maxdyadiclevel,
    tl2dyadiclevel, dyadiclevel2tl,
    iscube, isdyadic, sufficientpoweroftwo,
    maketree, isvalidtree,
    mirror, upsample, downsample, wcount, circshift,
    makewavelet, testfunction,
)
from .wt import (
    DiscreteWavelet, FilterWavelet, LSWavelet, OrthoFilter, GLS, wavelet,
)
from .transforms import dwt, idwt, wpt, iwpt

__version__ = "0.1.0"

__all__ = [
    "wt", "utils", "dwt", "idwt", "wpt", "iwpt",
    "DiscreteWavelet", "FilterWavelet", "LSWavelet", "OrthoFilter", "GLS",
    "wavelet",
    "detailindex", "detailrange", "detailn",
    "maxtransformlevels", "maxmodwttransformlevels",
    "dyadicdetailindex", "dyadicdetailrange", "dyadicscalingrange",
    "dyadicdetailn", "ndyadicscales", "maxdyadiclevel",
    "tl2dyadiclevel", "dyadiclevel2tl",
    "iscube", "isdyadic", "sufficientpoweroftwo",
    "maketree", "isvalidtree",
    "mirror", "upsample", "downsample", "wcount", "circshift",
    "makewavelet", "testfunction",
]
