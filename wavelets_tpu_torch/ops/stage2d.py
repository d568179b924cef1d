"""Levels 1 and 2 of the periodic 2-D forward DWT in one launch: CUDA
kernel N and its plain version.

``stage2_fw`` takes ``x (B, m, n)`` (m and n divisible by 4) through two
levels and writes seven planes, each with unit column stride: LL2, the
level-1 details LH1, HL1, HH1 (``(B, m/2, n/2)``) and the level-2 details
LH2, HL2, HH2 (``(B, m/4, n/4)``).  The pyramid driver (ops/pyramid2d.py)
passes ``level2d.detail_planes(y, 1)`` and ``(y, 2)`` of the packed output
and, for LL2, a scratch view, or ``y[:, :m>>2, :n>>2]`` when the transform
has two levels (the JAX package's ``last=True``).  LL1 never leaves the
card's shared memory.

The kernel is driven by the wavelet's bands (ops/bands.py), as kernel A is,
and replaces the TPU kernel ``wavelets_tpu/ops/pallas/stage2d.py``
``_stage2_kernel`` (see csrc/stage2d.cu).  Where the bands' span is below
16 (:func:`stage_window`) it runs its strip form: persistent blocks walk
strips of the image downward, a level-2 row pair per step, staging the
next steps' rows of x with 16-byte copies while this one's taps run, with
rings of the row passes in shared memory and the bands in registers as
windows of 8 or 16 offsets; :func:`stage_plan` mirrors its geometry.
Above, the first form runs: one block per tile of level-2 quads, its side
:func:`stage_tile`'s.  A tensor on the CPU takes the
plain version (``stage2_fw_plain``: two levels of ``level2d.quads_fw`` with
LL1 rounded to the storage type in between, as the kernel and two
launches of kernel A round it); a CUDA tensor launches the kernel or
raises.  Arithmetic runs in float32 for float32 and bfloat16 storage and
in float64 for float64.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from . import build
from .bands import acc_dtype, band_table, level_bands, tap_count
from .level2d import (SMEM_LIMIT, _check_input, _check_plane, _planes_args,
                      quads_fw)

__all__ = ["LAUNCHES", "PLAIN_CALLS", "stage2_fw", "stage2_fw_plain",
           "stage_tile", "stage_window", "stage_plan", "OUT_NAMES"]

LAUNCHES = build.counter("stage2_fw")
PLAIN_CALLS = {"stage2_fw": 0}

OUT_NAMES = ("LL2", "LH1", "HL1", "HH1", "LH2", "HL2", "HH2")
# sides of the level-2 tile that csrc/stage2d.cu's first form may take,
# largest first
TILES = (32, 16, 8, 4, 2, 1)
# the strip form's window bounds, level-2 rows per step, staged steps, the
# work items its segment height aims at, and the bytes of an LL1 window
# row at most
STRIP_WINDOWS = (8, 16)
_SN_RS, _SN_STAGES, _SN_ITEMS, _SN_WIDTH = 2, 3, 2048, 512


def _geometry(tile: int, dmin: int, span: int):
    """csrc/stage2d.cu's StageGeom: (W1, XR, XH) of one tile."""
    lo, hi = min(dmin, 0), max(dmin + span, 1)
    w1 = 2 * tile - 1 + hi - lo
    xr = 2 * w1 - 1 + span
    return w1, xr, (xr + 1) // 2


def smem_bytes(wt, dtype, tile: int) -> int:
    """Shared memory of one block of kernel N at this tile side."""
    ds, _, dd, _ = level_bands(wt)
    dmin = int(min(ds.min(), dd.min()))
    span = int(max(ds.max(), dd.max())) - dmin
    w1, xr, xh = _geometry(tile, dmin, span)
    size = acc_dtype(dtype).itemsize
    return (2 * xr * xh + 2 * xr * w1) * size + \
        tap_count(wt, False) * (size + 16)


@lru_cache(maxsize=None)
def stage_tile(wt, dtype) -> int | None:
    """The largest tile side whose window fits one block's shared memory,
    or None where even a one-quad tile does not (a band reach of about 60
    samples and more, such as batt4's and batt6's)."""
    return next((t for t in TILES if smem_bytes(wt, dtype, t) <= SMEM_LIMIT),
                None)


def _ana_table(wt):
    ds, _, dd, _ = level_bands(wt)
    dmin = int(min(ds.min(), dd.min()))
    return dmin, int(max(ds.max(), dd.max())) - dmin


def stage_window(wt) -> int:
    """The window bound of kernel N's strip form for ``wt``'s analysis
    bands: the smallest of STRIP_WINDOWS above their span, or 0 where the
    span is 16 or more and the first form runs.  csrc/stage2d.cu
    (stage2_fw, stage2_strip) makes the same choice, as kernel A does for
    the same bands (level2d.fw_window)."""
    span = _ana_table(wt)[1]
    return next((w for w in STRIP_WINDOWS if span < w), 0)


class StagePlan(NamedTuple):
    """Kernel N's launch as csrc/stage2d.cu plans it: the window (0: the
    first form, with its tile side), the staging path (16 or 4 bytes), and
    the strip form's geometry (StripGeom): lo and hi bound the LL1 rows
    and columns a strip reads, lov is lo rounded down to a multiple of V;
    level-2 columns per strip, LL1 window columns, staged elements per x
    row and their shift, the two ring depths, warm-up steps, level-2 rows
    per segment, segments, strips, work items; the planes (bits of
    OUT_NAMES' order) that take V-element stores; shared bytes."""
    window: int
    tile: int = 0
    staging: int = 0
    lo: int = 0
    hi: int = 0
    lov: int = 0
    q2: int = 0
    w1: int = 0
    ps: int = 0
    sh: int = 0
    r1: int = 0
    r2: int = 0
    warm: int = 0
    seg: int = 0
    segs: int = 0
    strips: int = 0
    items: int = 0
    vmask: int = 0
    smem: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stage_plan(x, wt, outs=None, strips=True) -> StagePlan:
    """How kernel N runs the two levels of ``x (B, m, n)``: a pure function
    of its shape, strides and data pointer (and of the output planes',
    for the stores), mirroring csrc/stage2d.cu.  ``strips=False`` asks for
    the first form, as the C entry's ``strips`` argument does.  The 16-byte
    staging path needs x's base, strides and n in whole 16-byte words."""
    window = stage_window(wt) if strips else 0
    if not window:
        tile = stage_tile(wt, x.dtype)
        return StagePlan(0, tile=tile or 0,
                         smem=smem_bytes(wt, x.dtype, tile) if tile else 0)
    B, m, n = x.shape
    dmin, span = _ana_table(wt)
    size, acc = x.element_size(), acc_dtype(x.dtype).itemsize
    e, v = 16 // size, 16 // acc
    vec = (n % e == 0 and x.data_ptr() % 16 == 0 and x.stride(0) % e == 0
           and x.stride(1) % e == 0)
    lo, hi = min(dmin, 0), max(dmin + span, 1)
    lov = -_cdiv(-lo, v) * v
    q2 = (_SN_WIDTH // acc + 1 - hi + lov) // 2 // 4 * 4
    w1 = _cdiv(2 * q2 - 1 + hi - lov, 4 * v) * 4 * v
    sh = (2 * lov + dmin) % e if vec else 0
    ps = _cdiv(sh + 2 * w1 - 1 + span, e) * e
    if 2 * v * size == 32 and ps * size % 32 == 0:
        ps += e
    r1, r2 = 4 * _SN_RS + span - 1, 2 * _SN_RS - 1 + hi - dmin
    reach = 2 * (hi - lo) + span - 3
    warm = 0 if reach <= 0 else _cdiv(_cdiv(reach, 4), _SN_RS)
    m4, n4 = m // 4, n // 4
    nstrips = _cdiv(n4, q2)
    want = _cdiv(m4 * B * nstrips, _SN_ITEMS)
    seg = _cdiv(max(want, 1), _SN_RS) * _SN_RS
    segs = _cdiv(m4, seg)
    vmask = 0
    for i, o in enumerate(outs or ()):
        if (o.data_ptr() % (v * size) == 0 and o.stride(0) % v == 0
                and o.stride(1) % v == 0):
            vmask |= 1 << i
    smem = ((2 * r1 * w1 + 2 * _SN_RS * w1 + 2 * r2 * q2) * acc
            + _SN_STAGES * 4 * _SN_RS * ps * size
            + tap_count(wt, False) * (acc + 4))
    return StagePlan(window, 0, 16 if vec else 4, lo, hi, lov, q2, w1, ps,
                     sh, r1, r2, warm, seg, segs, nstrips, B * segs * nstrips,
                     vmask, smem)


def _outs(x, outs):
    B, m, n = x.shape
    if m % 4 or n % 4 or m == 0 or n == 0:
        raise ValueError(f"stage2_fw needs sizes divisible by 4, got {(m, n)}")
    half, quarter = (B, m // 2, n // 2), (B, m // 4, n // 4)
    shapes = (quarter, half, half, half, quarter, quarter, quarter)
    if outs is None:
        return tuple(torch.empty(s, dtype=x.dtype, device=x.device)
                     for s in shapes)
    if len(outs) != 7:
        raise ValueError("outs must be the seven planes " + ", ".join(OUT_NAMES))
    for name, o, s in zip(OUT_NAMES, outs, shapes):
        _check_plane(o, name, s, x.dtype, x.device)
    return tuple(outs)


def stage2_fw_plain(x, wt, outs=None):
    """Plain PyTorch version of :func:`stage2_fw` (same outputs, same
    layout): two levels of index_select gathers in the arithmetic type,
    LL1 rounded to the storage type in between.  In bfloat16 each level
    sums as kernel A does (``quads_fw(..., fused=True)``: one fma per tap
    in table order, the row pass then the column pass), so that LL1
    rounds to bfloat16 from the float32 value that the kernel rounds;
    float32 and float64 sum each tap's product."""
    _check_input(x)
    outs = _outs(x, outs)
    PLAIN_CALLS["stage2_fw"] += 1
    acc = acc_dtype(x.dtype)
    fused = x.dtype == torch.bfloat16
    ll1, *details1 = quads_fw(x.to(acc), wt, fused)
    ll2, *details2 = quads_fw(ll1.to(x.dtype).to(acc), wt, fused)
    for o, v in zip(outs, (ll2, *details1, *details2)):
        o.copy_(v)
    return outs


def _plan(wt, x, outs, strips=True):
    """Kernel N's launch plan for this call's signature (``strips=False``:
    the first form); raises for a wavelet whose window fits no tile."""
    tile = stage_tile(wt, x.dtype)
    if tile is None:
        raise ValueError(f"stage2_fw: the bands of {wt.name} reach too far "
                         "for the kernel's shared-memory window")
    table = band_table(wt, False, x.dtype, x.device)
    B, m, n = x.shape
    return build.Plan(_SITE, (
        build.dtype_code(x.dtype), B, m, n, x, x.stride(0), x.stride(1),
        *_planes_args(outs), table.offs.data_ptr(), table.coefs.data_ptr(),
        *table.counts, table.dmin, table.span, tile, int(strips)),
        keep=table)


def _check(wt, x, outs):
    _check_input(x)
    return x, _outs(x, outs)


_SITE = build.Site(
    "stage2_fw", _check, lambda x, outs: (x, *outs),
    lambda wt, x, outs: stage2_fw_plain(x, wt, outs), _plan, result=1,
    writes=slice(1, None), outs=lambda wt, x, outs: (x, _outs(x, None)))


def stage2_fw(x, wt, outs=None):
    """Levels 1 and 2 of ``x (B, m, n)`` into ``outs`` = (LL2, LH1, HL1,
    HH1, LH2, HL2, HH2) planes with unit column stride (allocated when
    None), which may not overlap ``x``.  The kernel runs its strip form
    where :func:`stage_window` gives a window, else its first form with
    :func:`stage_tile`'s tile.  Raises for a wavelet whose window fits no
    tile.  Returns the seven planes."""
    return build.run(_SITE, wt, (x, outs if outs is None else tuple(outs)))
