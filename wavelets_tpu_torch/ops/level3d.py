"""One level of the periodic 3-D DWT in one pass, for wavelets whose bands
reach only inside the sample pair: CUDA kernels and their plain versions.

``level3_fw`` takes the active sub-cube ``x (d, m, n)`` to its eight
octants ``(d/2, m/2, n/2)``, octant ``z = 4 zd + 2 zm + zn`` being the
scaling (0) or detail (1) half along axes -3, -2 and -1.  It writes them
into the packed array ``y``, each in its place in y's leading ``(d, m,
n)`` sub-cube (:func:`octants`), except the scaling octant, which goes to
``lll`` where that is given.  ``level3_inv`` is its inverse: it reads the
octants from ``y`` (the scaling one from ``lll`` where given) and writes
the ``(d, m, n)`` result.  So the 3-D driver (ops/dwt3d.py) hands each
level its whole packed array and a scratch of one eighth, and makes no
view of the octants.  Every view has a unit column stride and any other
strides.

They serve the wavelets of :func:`pair_reach`: analysis offsets 0 and 1,
synthesis offsets 0 (haar, as a filter and as a lifting scheme).  Then a
level is a separate 2 x 2 x 2 block transform for each output position,
and one launch reads and writes the sub-cube once where the chain of
kernels A and I (J and B for the inverse) does it twice (csrc/level3d.cu).
Both are driven by the wavelet's bands (ops/bands.py) and sum as that
chain does, so float32 and float64 outputs equal it bit for bit; bfloat16
keeps the values between axes in float32 and rounds once.

A tensor on the CPU takes the plain PyTorch version (``level3_fw_plain``,
``level3_inv_plain``): the plain versions of the chain, axis by axis, with
no rounding to the storage type between the axes.  A CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import build
from .bands import acc_dtype, band_table, level_bands, synthesis_bands
from .level2d import _analysis, _check_input, _check_plane, _synthesis, \
    merge_inv, quads_fw

__all__ = ["DTYPES", "LAUNCHES", "PLAIN_CALLS", "pair_reach", "takes",
           "octants", "level3_fw", "level3_fw_plain", "level3_inv",
           "level3_inv_plain"]

DTYPES = (torch.float32, torch.float64, torch.bfloat16)
# kernel launches and plain-version calls, per entry point
LAUNCHES = build.counter("level3_fw", "level3_inv")
PLAIN_CALLS = {"level3_fw": 0, "level3_inv": 0}


@lru_cache(maxsize=None)
def pair_reach(wt) -> bool:
    """Whether ``wt``'s bands reach only inside the pair: every analysis
    offset 0 or 1, every synthesis offset 0."""
    ds, _, dd, _ = level_bands(wt)
    ana = {int(o) for o in ds} | {int(o) for o in dd}
    syn = {int(o) for d, _ in synthesis_bands(wt) for o in d}
    return ana <= {0, 1} and syn <= {0}


def takes(wt, x) -> bool:
    """Whether the one-pass level runs the volume ``x``: a wavelet of
    :func:`pair_reach`, a dtype of ``DTYPES``, and a level-1 octant of
    fewer than 2^31 samples (the kernels' work items fit an int)."""
    return (x.dtype in DTYPES and x.numel() // 8 < 2 ** 31
            and pair_reach(wt))


def octants(v, lll=None):
    """The eight octants of ``v (d, m, n)`` in the packed layout: octant
    ``z = 4 zd + 2 zm + zn`` is ``v[zd d/2 : (zd + 1) d/2, zm m/2 : ...,
    zn n/2 : ...]``, octant 0 ``lll`` where that is given."""
    d, m, n = (s // 2 for s in v.shape)
    octs = [v[zd * d:(zd + 1) * d, zm * m:(zm + 1) * m, zn * n:(zn + 1) * n]
            for zd in (0, 1) for zm in (0, 1) for zn in (0, 1)]
    if lll is not None:
        octs[0] = lll
    return octs


def _fits(wt, *_):
    if not pair_reach(wt):
        raise ValueError(f"level3: the bands of {wt.name} reach beyond the "
                         "sample pair")


def _check_level(y, shape, lll, x):
    """``y`` holds the level's ``shape`` and ``lll`` its scaling octant,
    both like ``x``."""
    if not isinstance(y, torch.Tensor) or y.dim() != 3:
        raise ValueError("y must be a (D, M, N) tensor")
    if any(s % 2 for s in shape) or any(a < b for a, b in zip(y.shape, shape)):
        raise ValueError(f"a level of even sizes {tuple(shape)} inside y, "
                         f"got y of {tuple(y.shape)}")
    _check_plane(y, "y", y.shape, x.dtype, x.device)
    if lll is not None:
        _check_plane(lll, "lll", tuple(s // 2 for s in shape), x.dtype,
                     x.device)


# --- plain versions ----------------------------------------------------------

def _fw_args(x, y, lll):
    _check_input(x)
    if y is None:
        y = torch.empty_like(x)
    _check_level(y, x.shape, lll, x)
    return x, y, lll


def level3_fw_plain(x, wt, y=None, lll=None):
    """Plain PyTorch version of :func:`level3_fw` (same outputs): the plain
    2-D level of each slab, then the plain level along axis -3, in the
    arithmetic type.  In bfloat16 each axis sums as the kernel does (one
    fma per tap, ``quads_fw(..., fused=True)``), so an output rounds to
    bfloat16 from the kernel's float32 sum."""
    _fits(wt)
    x, y, lll = _fw_args(x, y, lll)
    PLAIN_CALLS["level3_fw"] += 1
    d, m, n = x.shape
    octs = octants(y[:d, :m, :n], lll)
    fused = x.dtype == torch.bfloat16
    for z, q in enumerate(quads_fw(x.to(acc_dtype(x.dtype)), wt,
                                   fused=fused)):
        a, dd = _analysis(q, wt, 0, fused=fused)
        octs[z].copy_(a)
        octs[4 + z].copy_(dd)
    return y


def _inv_args(y, out, lll):
    _check_input(y, "y")
    if out is None:
        out = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    _check_plane(out, "out", out.shape, y.dtype, y.device)
    _check_level(y, out.shape, lll, y)
    return y, out, lll


def level3_inv_plain(y, wt, out=None, lll=None):
    """Plain PyTorch version of :func:`level3_inv`: the plain synthesis
    along axis -3, then the plain 2-D inverse of each slab, in the
    arithmetic type."""
    _fits(wt)
    y, out, lll = _inv_args(y, out, lll)
    PLAIN_CALLS["level3_inv"] += 1
    d, m, n = out.shape
    o = [t.to(acc_dtype(t.dtype)) for t in octants(y[:d, :m, :n], lll)]
    out.copy_(merge_inv(*(_synthesis(o[z], o[4 + z], wt, 0)
                          for z in range(4)), wt))
    return out


# --- kernels -----------------------------------------------------------------

def _lll_args(lll):
    return (None, 0, 0) if lll is None else (lll, lll.stride(0),
                                             lll.stride(1))


def _fw_plan(wt, x, y, lll):
    """The forward's launch plan for this call's signature."""
    table = band_table(wt, False, x.dtype, x.device)
    d, m, n = x.shape
    return build.Plan(_FW, (
        build.dtype_code(x.dtype), d // 2, m // 2, n // 2, x, x.stride(0),
        x.stride(1), y, y.stride(0), y.stride(1), *_lll_args(lll),
        table.offs.data_ptr(), table.coefs.data_ptr(), *table.counts),
        keep=table)


def _inv_plan(wt, y, out, lll):
    """The inverse's launch plan for this call's signature."""
    table = band_table(wt, True, y.dtype, y.device)
    d, m, n = out.shape
    return build.Plan(_INV, (
        build.dtype_code(y.dtype), d // 2, m // 2, n // 2, y, y.stride(0),
        y.stride(1), *_lll_args(lll), out, out.stride(0), out.stride(1),
        table.offs.data_ptr(), table.coefs.data_ptr(),
        (ctypes.c_int * 4)(*table.counts)), keep=table)


_FW = build.Site(
    "level3_fw", lambda wt, x, y, lll: _fw_args(x, y, lll),
    lambda x, y, lll: (x, y) if lll is None else (x, y, lll),
    lambda wt, x, y, lll: level3_fw_plain(x, wt, y, lll), _fw_plan,
    result=1, writes=slice(1, None), fits=_fits)
_INV = build.Site(
    "level3_inv", lambda wt, y, out, lll: _inv_args(y, out, lll),
    lambda y, out, lll: (y, out) if lll is None else (y, lll, out),
    lambda wt, y, out, lll: level3_inv_plain(y, wt, out, lll), _inv_plan,
    result=1, writes=slice(-1, None), fits=_fits)


def level3_fw(x, wt, y=None, lll=None):
    """Forward 3-D level of ``x (d, m, n)`` (even sizes, unit column
    stride), for a wavelet of :func:`pair_reach`: the seven detail octants
    into their packed places in ``y`` (a ``(D, M, N)`` array of at least
    x's sizes, unit column stride; allocated like x when None), the
    scaling octant into ``lll (d/2, m/2, n/2)``, or into ``y[:d/2, :m/2,
    :n/2]`` where ``lll`` is None.  The outputs may not overlap ``x``.
    Returns ``y``."""
    return build.run(_FW, wt, (x, y, lll))


def level3_inv(y, wt, out=None, lll=None):
    """Inverse 3-D level: the octants of the level ``out (d, m, n)`` read
    from their packed places in ``y`` (the scaling one from ``lll (d/2,
    m/2, n/2)`` where given) -> ``out`` (allocated at y's size when None),
    which may not overlap them.  Returns ``out``."""
    return build.run(_INV, wt, (y, out, lll))
