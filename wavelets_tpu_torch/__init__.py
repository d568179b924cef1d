"""wavelets_tpu_torch: the PyTorch and CUDA port of ``wavelets_tpu``.

It runs the periodic 1-D, 2-D and 3-D DWT (batched rows and single long
signals for ``ndt=1``), the wavelet packet transform and the MODWT, with
their inverses, the threshold layer (denoising, best basis, matching
pursuit) and, in ``parallel``, all of these sharded over a mesh of torch
devices, through hand-written CUDA kernels for the H100
(``csrc/``, built with ``nvcc`` at first use), with a plain PyTorch version
beside every kernel that a CPU tensor takes.  The other routes run on the
torch engines (``ops/lifting.py``, ``ops/filter_fb.py``).  A non-tensor
input runs on the CUDA card unless ``device`` is given.  The package
imports ``torch`` and NumPy, never JAX.

Public surface (the part of ``wavelets_tpu``'s that is ported so far):

  transforms:  dwt, idwt (ndt = 1, 2, 3), wpt, iwpt, modwt, imodwt, dwtc,
               idwtc (complex input as two real transforms)
  subbands:    dwt_subbands, idwt_subbands, to_packed, from_packed
  threshold:   threshold and its operators (HardTH, SoftTH, ...), DNFT,
               VisuShrink, denoise, noisest, coefentropy, the entropies,
               bestbasistree, matchingpursuit
  parallel:    Mesh, Sharded, make_mesh, the sharded and grid transforms
               and the distributed apps (``wavelets_tpu_torch.parallel``)
  polyphase:   split_last, merge_last
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
from .transforms import dwt, idwt, wpt, iwpt, modwt, imodwt, dwtc, idwtc
from .ops.lifting import split_last, merge_last
from .subbands import dwt_subbands, idwt_subbands, to_packed, from_packed
from .threshold import (
    threshold, HardTH, SoftTH, SemiSoftTH, SteinTH, BiggestTH, PosTH, NegTH,
    DNFT, VisuShrink, denoise, noisest,
    coefentropy, Entropy, ShannonEntropy, LogEnergyEntropy, bestbasistree,
    matchingpursuit,
)

__version__ = "0.1.0"

__all__ = [
    "wt", "utils",
    "dwt", "idwt", "wpt", "iwpt", "modwt", "imodwt", "dwtc", "idwtc",
    "dwt_subbands", "idwt_subbands", "to_packed", "from_packed",
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
    "split_last", "merge_last",
    "makewavelet", "testfunction",
    "threshold", "HardTH", "SoftTH", "SemiSoftTH", "SteinTH", "BiggestTH",
    "PosTH", "NegTH", "DNFT", "VisuShrink", "denoise", "noisest",
    "coefentropy", "Entropy", "ShannonEntropy", "LogEnergyEntropy",
    "bestbasistree", "matchingpursuit",
]
