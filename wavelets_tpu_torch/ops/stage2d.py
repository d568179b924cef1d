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
``_stage2_kernel`` (see csrc/stage2d.cu).  A tensor on the CPU takes the
plain version (``stage2_fw_plain``: two levels of ``level2d.quads_fw`` with
LL1 rounded to the storage type in between, as the kernel and two
launches of kernel A round it); a CUDA tensor launches the kernel or
raises.  Arithmetic runs in float32 for float32 and bfloat16 storage and
in float64 for float64.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from . import build
from .bands import acc_dtype, band_table, level_bands, tap_count
from .level2d import (SMEM_LIMIT, _check_disjoint, _check_input, _check_plane,
                      _planes_args, quads_fw)

__all__ = ["LAUNCHES", "PLAIN_CALLS", "stage2_fw", "stage2_fw_plain",
           "stage_tile", "OUT_NAMES"]

LAUNCHES = {"stage2_fw": 0}
PLAIN_CALLS = {"stage2_fw": 0}

OUT_NAMES = ("LL2", "LH1", "HL1", "HH1", "LH2", "HL2", "HH2")
# sides of the level-2 tile that csrc/stage2d.cu may take, largest first
TILES = (32, 16, 8, 4, 2, 1)


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
    LL1 rounded to the storage type in between."""
    _check_input(x)
    outs = _outs(x, outs)
    PLAIN_CALLS["stage2_fw"] += 1
    acc = acc_dtype(x.dtype)
    ll1, *details1 = quads_fw(x.to(acc), wt)
    ll2, *details2 = quads_fw(ll1.to(x.dtype).to(acc), wt)
    for o, v in zip(outs, (ll2, *details1, *details2)):
        o.copy_(v)
    return outs


def _launch(x, wt, outs, tile, stream):
    table = band_table(wt, False, x.dtype, x.device)
    B, m, n = x.shape
    ptrs, sb, sr = _planes_args(outs)
    build.check(build.library().wtt_stage2_fw(
        build.dtype_code(x.dtype), B, m, n, x.data_ptr(), x.stride(0),
        x.stride(1), ptrs, sb, sr, table.offs.data_ptr(),
        table.coefs.data_ptr(), *table.counts, table.dmin, table.span, tile,
        stream), "stage2_fw")


def stage2_fw(x, wt, outs=None):
    """Levels 1 and 2 of ``x (B, m, n)`` into ``outs`` = (LL2, LH1, HL1,
    HH1, LH2, HL2, HH2) planes with unit column stride (allocated when
    None), which may not overlap ``x``.  The kernel's level-2 tile is
    :func:`stage_tile`'s.  Raises for a wavelet whose window fits no tile.
    Returns the seven planes."""
    _check_input(x)
    outs = _outs(x, outs)
    _check_disjoint((x,), outs, "stage2_fw")
    if x.device.type == "cpu":
        return stage2_fw_plain(x, wt, outs)
    tile = stage_tile(wt, x.dtype)
    if tile is None:
        raise ValueError(f"stage2_fw: the bands of {wt.name} reach too far "
                         "for the kernel's shared-memory window")
    if x.shape[0]:
        with torch.cuda.device(x.device):
            _launch(x, wt, outs, tile, torch.cuda.current_stream().cuda_stream)
        LAUNCHES["stage2_fw"] += 1
    return outs
