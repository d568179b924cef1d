"""Public transform API of the port: ``dwt`` and ``idwt``.

The counterpart of ``wavelets_tpu/transforms.py``.  The wavelet carrier
picks the engine (OrthoFilter -> filter bank, GLS -> lifting) and the
trailing ``ndt`` axes are transformed (default: the array rank, at most 3;
leading axes are batch).  Integer and boolean input promotes to float64.

Routing: a periodic boundary with ``ndt == 2`` and float32, bfloat16 or
float64 data goes to ops/pyramid2d.py, whose level and tail launches run
the CUDA kernels on a CUDA tensor and their plain versions on a CPU tensor.
Everything else runs on the torch engines (ops/lifting.py,
ops/filter_fb.py) on the tensor's own device.  Complex input and the other
transforms of the JAX package are not ported yet.
"""

from __future__ import annotations

import torch

from .utils.indexing import maxtransformlevels, sufficientpoweroftwo
from .wt.carriers import GLS, OrthoFilter, DiscreteWavelet
from .wt.factor import check_boundary_stability
from .ops import filter_fb, lifting, pyramid2d
from .ops.level2d import DTYPES

__all__ = ["dwt", "idwt"]

# transform dims = array rank, capped at 3 (higher ranks batch the leading
# axes)
_MAX_NDT = 3


def _as_float(x):
    x = torch.as_tensor(x)
    if x.is_complex():
        raise NotImplementedError("complex input is not ported yet")
    if not x.is_floating_point():
        x = x.to(torch.float64)
    return x


def _ndt(x, ndt):
    if ndt is None:
        ndt = min(x.ndim, _MAX_NDT)
    if not 1 <= ndt <= x.ndim:
        raise ValueError(f"ndt={ndt} invalid for rank-{x.ndim} input")
    return ndt


def _check_levels(x, L, ndt):
    if L < 0:
        raise ValueError("L must be non-negative")
    for s in x.shape[-ndt:]:
        if not sufficientpoweroftwo(s, L):
            raise ValueError(
                f"size {tuple(x.shape[-ndt:])} lacks a 2^{L} factor in every "
                "transform dimension")


def _periodic(wt) -> bool:
    return getattr(wt, "boundary", "periodic") == "periodic"


def _transform(x, wt, L, ndt, fw):
    if L == 0:
        return x
    if isinstance(wt, GLS):
        # the same refusal as the lifting engine, whatever the route
        check_boundary_stability(wt, lifting.numpy_dtype(x.dtype))
    if ndt == 2 and _periodic(wt) and x.dtype in DTYPES:
        flat = x.reshape((-1,) + tuple(x.shape[-2:])).contiguous()
        fn = pyramid2d.dwt2 if fw else pyramid2d.idwt2
        return fn(flat, wt, L).reshape(x.shape)
    if isinstance(wt, OrthoFilter):
        h, g = filter_fb.filter_pair(wt)
        if ndt == 1:
            return filter_fb.dwt1d(x, h, g, L) if fw \
                else filter_fb.idwt1d(x, h, g, L)
        return filter_fb.dwt_nd(x, h, g, L, ndt) if fw \
            else filter_fb.idwt_nd(x, h, g, L, ndt)
    if ndt == 1:
        return lifting.dwt1d_lifting(x, wt, L) if fw \
            else lifting.idwt1d_lifting(x, wt, L)
    return lifting.dwt_nd_lifting(x, wt, L, ndt) if fw \
        else lifting.idwt_nd_lifting(x, wt, L, ndt)


def dwt(x, wt: DiscreteWavelet, L: int | None = None, *,
        ndt: int | None = None):
    """Forward discrete wavelet transform.

    ``x`` — a tensor (or array-like) of rank 1, 2 or 3, or higher with the
    trailing ``ndt`` axes transformed and the leading axes batched.
    ``wt`` — a carrier from ``wt.wavelet``.  ``L`` — the number of levels
    (default: the most the shape allows).  Returns the coefficients in the
    packed layout, on ``x``'s device (``x`` itself when ``L`` is 0).
    """
    x = _as_float(x)
    ndt = _ndt(x, ndt)
    if L is None:
        L = maxtransformlevels(tuple(x.shape[-ndt:]))
    _check_levels(x, L, ndt)
    return _transform(x, wt, int(L), ndt, True)


def idwt(y, wt: DiscreteWavelet, L: int | None = None, *,
         ndt: int | None = None):
    """Inverse of :func:`dwt`."""
    y = _as_float(y)
    ndt = _ndt(y, ndt)
    if L is None:
        L = maxtransformlevels(tuple(y.shape[-ndt:]))
    _check_levels(y, L, ndt)
    return _transform(y, wt, int(L), ndt, False)
