"""Public transform API of the port: ``dwt``/``idwt``, ``wpt``/``iwpt``,
``modwt``/``imodwt`` and ``dwtc``/``idwtc``.

The counterpart of ``wavelets_tpu/transforms.py``.  The wavelet carrier
picks the engine (OrthoFilter -> filter bank, GLS -> lifting) and the
trailing ``ndt`` axes are transformed (default: the array rank, at most 3;
leading axes are batch).  Integer and boolean input promotes to float64.
Complex input runs as two real transforms, ``torch.complex(f(re),
f(im))``: the coefficients are real, so this is exact (complex64 through
the float32 route, complex128 through the float64 one).

Device: a ``torch.Tensor`` stays on its own device unless ``device`` is
given; any other input (a NumPy array, a list, a scalar) is placed on
``device``, or on the CUDA card when ``device`` is None.  Without a card
that raises: pass ``device="cpu"`` to run on the CPU.

``donate``: ``dwt``, ``idwt``, ``wpt``, ``iwpt``, ``modwt`` and ``imodwt``
take ``donate=False`` as the JAX package does (there, ``donate=True``
hands the input's buffer to XLA: the functional form of the reference's
in-place ``dwt!``).  The port reuses no input buffer on any route, so
``donate=True`` gives the same result and leaves the input as it was.

Routing: a periodic boundary with float32, bfloat16 or float64 data goes to
ops/pyramid2d.py for ``ndt == 2`` (on the route that :func:`routes2d`
reads from the JAX package's switches at every call), to ops/dwt1d.py for ``ndt == 1``
(leading axes flatten onto the batch) and to ops/dwt3d.py for ``ndt == 3``
(one volume at a time); their launches run the CUDA kernels on a CUDA
tensor and their plain versions on a CPU tensor.  ``wpt``/``iwpt`` run one
1-D level launch per tree depth (ops/wpt.py); ``modwt`` one launch for
all levels where ops/modwt1d.py's plan fits the rows (one level launch
per level beyond it), ``imodwt`` one level launch per level.  Everything
else runs on the torch engines (ops/lifting.py, ops/filter_fb.py,
ops/modwt.py) on the tensor's own device.

Each public call opens a root span of ``tracing.py`` (``dwt``, ``idwt``,
``wpt``, ``iwpt``, ``modwt``, ``imodwt``), which records only while
tracing is on.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from .utils.indexing import (maxmodwttransformlevels, maxtransformlevels,
                             sufficientpoweroftwo)
from .utils.trees import isvalidtree, maketree
from .wt.carriers import GLS, OrthoFilter, DiscreteWavelet
from .wt.factor import check_boundary_stability
from . import tracing
from .ops import (dwt1d, dwt3d, filter_fb, lifting, modwt as modwt_ops,
                  modwt1d, pyramid2d, wpt as wpt_ops)
from .ops.level2d import DTYPES

__all__ = ["dwt", "idwt", "wpt", "iwpt", "modwt", "imodwt", "dwtc", "idwtc",
           "routes2d"]

# transform dims = array rank, capped at 3 (higher ranks batch the leading
# axes)
_MAX_NDT = 3


def _as_tensor(x, device=None):
    """The device rule: a tensor stays on its device unless ``device`` is
    given; anything else goes to ``device``, or to the CUDA card."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: a non-tensor input goes to the card unless "
            "device is given (device='cpu' runs on the CPU)")
    return torch.as_tensor(x, device=device)


def _as_float(x, device=None):
    x = _as_tensor(x, device)
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float64)
    return x


def _parts(fn, x, *args, **kwargs):
    """``fn`` of a complex ``x`` as two real transforms: exact, since every
    transform here is linear with real coefficients."""
    return torch.complex(fn(x.real, *args, **kwargs),
                         fn(x.imag, *args, **kwargs))


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


def routes2d() -> tuple[str, str]:
    """The 2-D routes (forward, inverse) of ops/pyramid2d.py that mirror the
    JAX package's switches, read at every call:

    ==================================  ==================  ===============
    switches                            JAX fw / inv        port fw / inv
    ==================================  ==================  ===============
    none                                mxu2d / mxu2d       level / level
    ``MXU_LS2=1`` (``MXU2D``,           stage2d, mxu2d /    stage / level
    ``PACKED2D``, ``PACKED_DMA`` not 0) mxu2d
    ``MXU2D=0``                         fused2d / row-col   level / split
    ``MXU2D=0 FUSED2D=0``               row-col / row-col   split / split
    ``MXU2D=0 FUSED_INV=1``             fused2d / fused2d   level / level
    ==================================  ==================  ===============

    (each switch is ``WAVELETS_TPU_<name>``; under ``MXU2D=0`` the JAX
    forward takes fused2d's packed kernel with ``PACKED2D=1``, whatever
    ``FUSED2D`` says, and so does the port's level route).  The JAX
    package's tile plans (``fused_ok``, ``_plan_level``, ``_stage_plan``)
    are not mirrored: they size TPU memory, and the results agree.
    """
    env = os.environ.get
    if env("WAVELETS_TPU_MXU2D") == "0":
        fw = ("split" if env("WAVELETS_TPU_FUSED2D") == "0"
              and env("WAVELETS_TPU_PACKED2D") != "1" else "level")
        inv = "level" if env("WAVELETS_TPU_FUSED_INV") == "1" else "split"
        return fw, inv
    stage = (env("WAVELETS_TPU_MXU_LS2") == "1"
             and env("WAVELETS_TPU_PACKED2D") != "0"
             and env("WAVELETS_TPU_PACKED_DMA") != "0")
    return ("stage" if stage else "level"), "level"


def _transform(x, wt, L, ndt, fw):
    if L == 0:
        return x
    if isinstance(wt, GLS):
        # the same refusal as the lifting engine, whatever the route
        check_boundary_stability(wt, lifting.numpy_dtype(x.dtype))
    if ndt == 2 and _periodic(wt) and x.dtype in DTYPES:
        flat = x.reshape((-1,) + tuple(x.shape[-2:])).contiguous()
        fn = pyramid2d.dwt2 if fw else pyramid2d.idwt2
        return fn(flat, wt, L, route=routes2d()[0 if fw else 1]).reshape(
            x.shape)
    if ndt == 1 and _periodic(wt) and x.dtype in DTYPES:
        flat = x.reshape(-1, x.shape[-1]).contiguous()
        fn = dwt1d.dwt1 if fw else dwt1d.idwt1
        return fn(flat, wt, L).reshape(x.shape)
    if ndt == 3 and _periodic(wt) and x.dtype in DTYPES:
        fn = dwt3d.dwt3 if fw else dwt3d.idwt3
        if x.ndim == 3:
            return fn(x.contiguous(), wt, L)
        vols = x.reshape((-1,) + tuple(x.shape[-3:]))
        return torch.stack([fn(v.contiguous(), wt, L) for v in vols]
                           ).reshape(x.shape)
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
        ndt: int | None = None, donate: bool = False, device=None):
    """Forward discrete wavelet transform.

    ``x`` — a tensor (or array-like) of rank 1, 2 or 3, or higher with the
    trailing ``ndt`` axes transformed and the leading axes batched.
    ``wt`` — a carrier from ``wt.wavelet``.  ``L`` — the number of levels
    (default: the most the shape allows).  ``device`` — where to run (see
    the module docstring).  ``donate`` is accepted for the JAX package's
    signature and changes nothing (see the module docstring).  Returns the
    coefficients in the packed layout, on that device (the input itself
    when ``L`` is 0, unless complex).
    """
    with tracing.span("dwt", -1 if L is None else L):
        x = _as_float(x, device)
        if x.is_complex():
            return _parts(dwt, x, wt, L, ndt=ndt)
        ndt = _ndt(x, ndt)
        if L is None:
            L = maxtransformlevels(tuple(x.shape[-ndt:]))
        _check_levels(x, L, ndt)
        return _transform(x, wt, int(L), ndt, True)


def idwt(y, wt: DiscreteWavelet, L: int | None = None, *,
         ndt: int | None = None, donate: bool = False, device=None):
    """Inverse of :func:`dwt` (``donate`` as there)."""
    with tracing.span("idwt", -1 if L is None else L):
        y = _as_float(y, device)
        if y.is_complex():
            return _parts(idwt, y, wt, L, ndt=ndt)
        ndt = _ndt(y, ndt)
        if L is None:
            L = maxtransformlevels(tuple(y.shape[-ndt:]))
        _check_levels(y, L, ndt)
        return _transform(y, wt, int(L), ndt, False)


# --- wavelet packets --------------------------------------------------------

def _tree_or_levels(tree, L):
    """The reference's L-or-tree third-positional overload."""
    if isinstance(tree, (int, np.integer)):
        if L is not None and L != tree:
            raise ValueError("give either tree or L, not both")
        return None, int(tree)
    if tree is not None and L is not None:
        raise ValueError("give either tree or L, not both")
    return tree, L


@lru_cache(maxsize=64)
def _full_tree(n: int, L: int) -> np.ndarray:
    """The full L-level tree of a length-n signal, read-only, built once:
    it is valid by construction (checking a tree costs milliseconds at
    n = 2^20)."""
    tree = maketree(n, L, "full")
    tree.setflags(write=False)
    return tree


def _wpt_common(x, wt, tree, L, fw, device):
    x = _as_float(x, device)
    if x.is_complex():
        return _parts(_wpt_common, x, wt, tree, L, fw, None)
    n = x.shape[-1]
    if tree is None:
        tree = _full_tree(n, maxtransformlevels(n) if L is None else int(L))
    elif not isvalidtree(n, tree):
        raise ValueError("invalid tree")
    fn = wpt_ops.wpt if fw else wpt_ops.iwpt
    return fn(x, wt, tree)


def wpt(x, wt: DiscreteWavelet, tree=None, L: int | None = None, *,
        donate: bool = False, device=None):
    """Wavelet packet transform along the last axis.

    ``tree`` is a bool heap vector (see utils.maketree); if omitted, a full
    L-level tree is used (default L: the most the length allows).  An
    integer third positional is taken as ``L``.  ``donate`` and ``device``
    as for :func:`dwt`.
    """
    with tracing.span("wpt"):
        tree, L = _tree_or_levels(tree, L)
        return _wpt_common(x, wt, tree, L, True, device)


def iwpt(y, wt: DiscreteWavelet, tree=None, L: int | None = None, *,
         donate: bool = False, device=None):
    """Inverse of :func:`wpt` (also accepts an integer as ``L``)."""
    with tracing.span("iwpt"):
        tree, L = _tree_or_levels(tree, L)
        return _wpt_common(y, wt, tree, L, False, device)


# --- MODWT ------------------------------------------------------------------

def modwt(x, wt: OrthoFilter, L: int | None = None, *,
          donate: bool = False, device=None):
    """Maximal-overlap DWT along the last axis -> ``(..., N, L+1)``: detail
    level j in column j-1, the scaling band in column L.  Any length N
    works; ``L`` defaults to ``maxmodwttransformlevels(N)``.  Leading axes
    flatten onto the kernels' batch.  ``donate`` and ``device`` as for
    :func:`dwt`."""
    with tracing.span("modwt", -1 if L is None else L):
        x = _as_float(x, device)
        if x.is_complex():
            return _parts(modwt, x, wt, L)
        N = x.shape[-1]
        L = maxmodwttransformlevels(N) if L is None else int(L)
        modwt_ops.check_levels(N, L)
        modwt_ops.modwt_filter_pair(wt)          # refuses a lifting scheme
        if x.dtype not in DTYPES:
            return modwt_ops.modwt(x, wt, L)
        flat = x.reshape(-1, N).contiguous()
        return modwt1d.modwt(flat, wt, L).reshape(*x.shape, L + 1)


def imodwt(xw, wt: OrthoFilter, *, donate: bool = False, device=None):
    """Inverse MODWT of an ``(..., N, L+1)`` coefficient array (``donate``
    as for :func:`dwt`)."""
    with tracing.span("imodwt"):
        xw = _as_float(xw, device)
        if xw.is_complex():
            return _parts(imodwt, xw, wt)
        modwt_ops.modwt_filter_pair(wt)          # refuses a lifting scheme
        if xw.dtype not in DTYPES:
            return modwt_ops.imodwt(xw, wt)
        flat = xw.reshape((-1,) + tuple(xw.shape[-2:]))
        return modwt1d.imodwt(flat, wt).reshape(xw.shape[:-1])


# --- column-wise transform over the trailing channel axis -------------------

def dwtc(x, wt: DiscreteWavelet, L: int | None = None, *, device=None):
    """Per-channel 2-D DWT of an ``(m, n, c)`` array (channels last): the
    channels ride the 2-D pyramid's batch axis."""
    x = _as_float(x, device)
    return torch.movedim(dwt(torch.movedim(x, -1, 0), wt, L, ndt=2), 0, -1)


def idwtc(y, wt: DiscreteWavelet, L: int | None = None, *, device=None):
    """Inverse of :func:`dwtc`."""
    y = _as_float(y, device)
    return torch.movedim(idwt(torch.movedim(y, -1, 0), wt, L, ndt=2), 0, -1)
