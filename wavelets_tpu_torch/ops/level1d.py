"""One level of the periodic 1-D DWT over ``(B, n)`` rows: CUDA kernels E
(forward) and F (inverse) and their plain versions.

``level1d_fw`` takes ``x (B, n)`` to the scaling and detail bands ``s`` and
``d`` (each ``(B, n/2)``).  The outputs are any two planes with unit
column stride and their own row strides, so the multi-level loop
(ops/dwt1d.py) writes ``d`` straight into the packed array's detail
segment, and the packet transform (ops/wpt.py) writes ``[s | d]`` into the
two halves of each output row.  ``level1d_inv`` is its inverse: it reads
the two planes (in place from a packed array, if the caller wishes) and
writes the merged ``(B, 2nh)`` rows.

Both are driven by the wavelet's bands (ops/bands.py), as the 2-D kernels
are; the plain versions are the 1-D passes of ops/level2d.py.  They
replace the TPU kernels of ``wavelets_tpu/ops/pallas/dwt1d.py`` and
``wide1d.py`` (see csrc/level1d.cu).  Both run on persistent blocks
that stage tiles (a stretch of one row, or several short rows: of x for
the forward, of s and d for the inverse) with 16-byte copies, the next
tile's while this one's taps run, with the bands in registers as windows
of 8 or 16 offsets (:func:`fw1d_window`, :func:`inv1d_window`); a span of
16 or more takes the first form, one block per tile, and so does a forward
level of fewer than ``FW1D_MIN_PAIRS`` output pairs, where the tiled
form's fixed costs outweigh its staging.  :func:`fw1d_plan`,
:func:`fw1d_smem` and :func:`inv1d_smem` mirror the launches.  A tensor
on the CPU takes the plain
PyTorch version (``level1d_fw_plain``, ``level1d_inv_plain``); a CUDA
tensor launches the kernel or raises.  Arithmetic runs in float32 for
float32 and bfloat16 storage (bfloat16 outputs are rounded once per level)
and in float64 for float64.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from .bands import acc_dtype, band_table, level_bands, synthesis_bands
from .level2d import DTYPES, _analysis, _synthesis

__all__ = ["DTYPES", "LAUNCHES", "PLAIN_CALLS", "level1d_fw",
           "level1d_fw_plain", "level1d_inv", "level1d_inv_plain",
           "inv1d_window", "inv1d_smem", "fw1d_window", "fw1d_smem",
           "fw1d_plan", "FW1D_MIN_PAIRS"]

LAUNCHES = build.counter("level1d_fw", "level1d_inv")
PLAIN_CALLS = {"level1d_fw": 0, "level1d_inv": 0}

# kernel F (csrc/level1d.cu): the tiled form's window bounds; its pair
# groups per tile, staged slack per row and pad per stage; the first form's
# output pairs per block
INV1D_WINDOWS = (8, 16)
_FI_GROUPS, _FI_SLACK, _FI_PAD = 512, 32, 64
_F_TK = 256
# kernel E: the same for the tiled forward, and the first form's pairs
FW1D_WINDOWS = (8, 16)
_FE_GROUPS, _FE_SLACK, _FE_PAD = 512, 32, 64
_FE_SPREAD, _FE_MIN_GROUPS = 512, 16
_E_TK = 512
# a forward level of fewer output pairs (B n/2) takes the first form:
# below it the first form measured faster on the H100 (chip_smoke.py
# phase 5c, "e_forms_by_size")
FW1D_MIN_PAIRS = 1 << 18


def check_rows(t, name, shape=None, dtype=None, device=None):
    """``t`` must be a ``(B, n)`` tensor with unit column stride (and the
    given shape, dtype and device, where given)."""
    if not isinstance(t, torch.Tensor) or t.dim() != 2:
        raise ValueError(f"{name} must be a (B, n) tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if dtype is None:
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} not in {DTYPES}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: unsupported device {t.device}")
    elif t.dtype != dtype or t.device != device:
        raise ValueError(f"{name} is {t.dtype} on {t.device}, expected "
                         f"{dtype} on {device}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} needs unit column stride")


def _fw_outs(x, s, d):
    B, n = x.shape
    if n < 2 or n % 2:
        raise ValueError(f"level1d_fw needs an even length, got {n}")
    shape = (B, n // 2)
    if s is None and d is None:
        return (torch.empty(shape, dtype=x.dtype, device=x.device),
                torch.empty(shape, dtype=x.dtype, device=x.device))
    if s is None or d is None:
        raise ValueError("give both output planes s and d, or neither")
    check_rows(s, "s", shape, x.dtype, x.device)
    check_rows(d, "d", shape, x.dtype, x.device)
    return s, d


def _inv_out(s, d, out):
    check_rows(s, "s")
    B, nh = s.shape
    if nh < 1:
        raise ValueError("level1d_inv needs non-empty bands")
    check_rows(d, "d", (B, nh), s.dtype, s.device)
    shape = (B, 2 * nh)
    if out is None:
        return torch.empty(shape, dtype=s.dtype, device=s.device)
    check_rows(out, "out", shape, s.dtype, s.device)
    return out


# --- plain versions ----------------------------------------------------------

def level1d_fw_plain(x, wt, s=None, d=None):
    """Plain PyTorch version of :func:`level1d_fw` (same outputs, same
    layout), computed with index_select gathers in the arithmetic type."""
    check_rows(x, "x")
    s, d = _fw_outs(x, s, d)
    PLAIN_CALLS["level1d_fw"] += 1
    a, dt = _analysis(x.to(acc_dtype(x.dtype)), wt, -1)
    s.copy_(a)
    d.copy_(dt)
    return s, d


def level1d_inv_plain(s, d, wt, out=None):
    """Plain PyTorch version of :func:`level1d_inv`."""
    out = _inv_out(s, d, out)
    PLAIN_CALLS["level1d_inv"] += 1
    a = acc_dtype(s.dtype)
    out.copy_(_synthesis(s.to(a), d.to(a), wt, -1))
    return out


# --- kernels -----------------------------------------------------------------

def inv1d_window(wt) -> int:
    """The window bound of kernel F's tiled form for ``wt``'s synthesis
    bands: the smallest of INV1D_WINDOWS above their span, or 0 where the
    span is 16 or more and the first form runs.  csrc/level1d.cu
    (level1d_inv) makes the same choice."""
    offs = [int(o) for d, _ in synthesis_bands(wt) for o in d]
    span = max(offs) - min(offs)
    return next((w for w in INV1D_WINDOWS if span < w), 0)


def inv1d_smem(wt, dtype) -> int:
    """Shared bytes of one block of kernel F in the form
    :func:`inv1d_window` picks; mirrors csrc/level1d.cu: the tiled form's
    two stages, each room for the s and d rows of a full tile whatever the
    shape (inv1d_tiled_smem), or the first form's windows for a row of at
    least ``_F_TK`` pairs."""
    bands = synthesis_bands(wt)
    offs = [int(o) for d, _ in bands for o in d]
    acc = acc_dtype(dtype).itemsize
    table = len(offs) * (acc + 4)
    if not inv1d_window(wt):
        return 2 * (_F_TK + max(offs) - min(offs)) * acc + table
    size = torch.empty((), dtype=dtype).element_size()
    stage = 2 * (_FI_GROUPS * (8 // size) + _FI_SLACK) + _FI_PAD
    return 2 * stage * size + table


def _ana_table(wt):
    ds, _, dd, _ = level_bands(wt)
    offs = [int(o) for o in ds] + [int(o) for o in dd]
    return min(offs), max(offs) - min(offs), len(offs)


def fw1d_window(wt) -> int:
    """The window bound of kernel E's tiled form for ``wt``'s analysis
    bands: the smallest of FW1D_WINDOWS above their span (both bands'
    offsets fit it), or 0 where the span is 16 or more and the first form
    runs.  csrc/level1d.cu (level1d_fw) makes the same choice, as kernel A
    does for the same bands (level2d.fw_window)."""
    span = _ana_table(wt)[1]
    return next((w for w in FW1D_WINDOWS if span < w), 0)


def fw1d_smem(wt, dtype, tiled=True) -> int:
    """Shared bytes of one block of kernel E in the form
    :func:`fw1d_window` picks (the first form where ``tiled`` is false,
    as for a level below ``FW1D_MIN_PAIRS``); mirrors csrc/level1d.cu:
    the tiled form's two stages, each room for one row of a full tile (2
    FE_GROUPS V samples, V = 16 bytes of the arithmetic type) plus slack
    and pad whatever the shape (fw1d_tiled_smem), or the first form's
    window for a row of at least ``_E_TK`` pairs; and the band table."""
    _, span, taps = _ana_table(wt)
    acc = acc_dtype(dtype).itemsize
    table = taps * (acc + 4)
    if not (tiled and fw1d_window(wt)):
        return (2 * _E_TK + span) * acc + table
    size = torch.empty((), dtype=dtype).element_size()
    stage = 2 * _FE_GROUPS * (16 // acc) + _FE_SLACK + _FE_PAD
    return 2 * stage * size + table


class Fw1dPlan(NamedTuple):
    """Kernel E's launch as csrc/level1d.cu (level1d_fw) plans it: the
    window (0: the first form, no other field set), the staging path (16
    or 4 bytes), and the tiled form's geometry (Fw1dGeom): pairs per
    tile (a full tile, or a 512th of a small level), tiles per row, rows
    per work item, log2 pair groups of a row, staged elements per row,
    their shift, log2 threads per staged row."""
    window: int
    staging: int = 0
    tk: int = 0
    tiles: int = 0
    rpb: int = 0
    gsh: int = 0
    ps: int = 0
    sh: int = 0
    lsh: int = 0
    items: int = 0
    smem: int = 0


def fw1d_plan(x, wt, min_pairs=FW1D_MIN_PAIRS) -> Fw1dPlan:
    """How kernel E runs the level of ``x (B, n)``: a pure function of its
    shape, row stride and data pointer, mirroring csrc/level1d.cu.  A
    level of fewer than ``min_pairs`` output pairs takes the first form.
    The 16-byte staging path needs x's base, row stride and n in whole
    16-byte words."""
    window = fw1d_window(wt)
    B, n = x.shape
    if not window or B * (n // 2) < min_pairs:
        return Fw1dPlan(0, smem=fw1d_smem(wt, x.dtype, tiled=False))
    dmin, span, _ = _ana_table(wt)
    e, v = 16 // x.element_size(), 16 // acc_dtype(x.dtype).itemsize
    full, nh = _FE_GROUPS * v, n // 2
    vec = n % e == 0 and x.data_ptr() % 16 == 0 and x.stride(0) % e == 0
    sh = dmin % e if vec else 0
    want = -(-(B * nh // _FE_SPREAD) // v) * v     # a 512th of the level
    per = min(full, max(_FE_MIN_GROUPS * v, want))
    tk = min(nh, per)
    tiles = -(-nh // tk)
    gsh = (-(-tk // v) - 1).bit_length()
    ps = -(-(sh + 2 * tk - 1 + span) // e) * e
    rpb = max(1, min(_FE_GROUPS >> gsh, (2 * full + _FE_SLACK) // ps,
                     per // tk))
    lsh = min(((ps // e if vec else ps) - 1).bit_length(), 8)
    return Fw1dPlan(window, 16 if vec else 4, tk, tiles, rpb, gsh, ps, sh,
                    lsh, -(-B // rpb) * tiles, fw1d_smem(wt, x.dtype))


def _fw_plan(wt, x, s, d, min_pairs=FW1D_MIN_PAIRS):
    """Kernel E's launch plan for this call's signature."""
    table = band_table(wt, False, x.dtype, x.device)
    B, n = x.shape
    return build.Plan(_FW, (
        build.dtype_code(x.dtype), B, n, x, x.stride(0), s, s.stride(0), d,
        d.stride(0), table.offs.data_ptr(), table.coefs.data_ptr(),
        *table.counts, table.dmin, table.span, min_pairs), keep=table)


def _inv_plan(wt, s, d, out):
    """Kernel F's launch plan for this call's signature."""
    table = band_table(wt, True, s.dtype, s.device)
    B, nh = s.shape
    return build.Plan(_INV, (
        build.dtype_code(s.dtype), B, nh, s, s.stride(0), d, d.stride(0),
        out, out.stride(0), table.offs.data_ptr(), table.coefs.data_ptr(),
        (ctypes.c_int * 4)(*table.counts), table.dmin, table.span),
        keep=table)


def _fw_check(wt, x, s, d):
    check_rows(x, "x")
    return (x, *_fw_outs(x, s, d))


_FW = build.Site(
    "level1d_fw", _fw_check, lambda x, s, d: (x, s, d),
    lambda wt, x, s, d: level1d_fw_plain(x, wt, s, d), _fw_plan,
    result=slice(1, 3), writes=slice(1, None),
    outs=lambda wt, x, s, d: (x, *_fw_outs(x, None, None)))
_INV = build.Site(
    "level1d_inv", lambda wt, s, d, out: (s, d, _inv_out(s, d, out)),
    lambda s, d, out: (s, d, out),
    lambda wt, s, d, out: level1d_inv_plain(s, d, wt, out), _inv_plan,
    result=2, writes=slice(-1, None))


def level1d_fw(x, wt, s=None, d=None):
    """Forward 1-D level of ``x (B, n)`` into the planes ``s`` and ``d``
    (``(B, n/2)``, unit column stride, any row stride; allocated when both
    are None).  The outputs may not overlap ``x``.  Returns ``(s, d)``."""
    return build.run(_FW, wt, (x, s, d))


def level1d_inv(s, d, wt, out=None):
    """Inverse 1-D level: the planes ``s`` and ``d`` ``(B, nh)`` (unit
    column stride, any row stride) -> ``out (B, 2nh)`` (allocated when
    None), which may not overlap them.  Returns ``out``."""
    return build.run(_INV, wt, (s, d, out))
