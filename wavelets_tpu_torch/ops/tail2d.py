"""All remaining levels of a small periodic 2-D DWT in one launch.

``tail_fw`` takes the active array ``x (B, m, n)`` through ``L`` levels and
writes the packed result (each level's LH/HL/HH at its offsets, the final
LL in the corner) to ``out (B, m, n)``; ``tail_inv`` is its inverse.  The
array of each image stays in shared memory, in the arithmetic type, for
all its levels, so the size limit is the card's (:func:`tail_fits`: what
one block can hold), not the TPU's.  They replace the TPU kernels of
``wavelets_tpu/ops/pallas/tail2d.py`` (see csrc/tail2d.cu).

:func:`tail_plan` is the launch plan, a pure function of the call: a
thread-block cluster of P blocks per image (P = 1 once the batch alone
fills the card's 132 SMs), the leading levels spread over the cluster by
bands of rows, the rest on its first block, the tap template and the
shared bytes per block.  A table of more than 32 taps takes the one-block
kernel with wrapped taps.

A tensor on the CPU takes the plain PyTorch version (``tail_fw_plain``,
``tail_inv_plain``); a CUDA tensor launches the kernel or raises.  Both
keep the intermediate LL in the arithmetic type and round only the outputs
(bfloat16 storage computes in float32).  Input and output may be the same
memory: every block of an image reads its rows before any block writes.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import build
from .bands import (acc_dtype, band_table, level_bands, synthesis_bands,
                    tap_count)
from .level2d import (SMEM_LIMIT, _check_input, _check_plane, detail_planes,
                      merge_inv, quads_fw)

__all__ = ["LAUNCHES", "PLAIN_CALLS", "TailPlan", "tail_fits", "tail_plan",
           "cluster_plan", "tail_fw", "tail_fw_plain", "tail_inv",
           "tail_inv_plain"]

LAUNCHES = build.counter("tail_fw", "tail_inv")
PLAIN_CALLS = {"tail_fw": 0, "tail_inv": 0}


def tail_fits(m: int, n: int, wt, dtype, inverse: bool = False) -> bool:
    """Can one block hold an (m, n) array, its scratch and the band table in
    shared memory?  (128 x 128 in float32 and bfloat16, 64 x 128 in
    float64.)  The same limit holds on the CPU, so both route alike."""
    size = acc_dtype(dtype).itemsize
    return 2 * m * n * size + tap_count(wt, inverse) * (size + 4) <= SMEM_LIMIT


SMS = 132          # streaming multiprocessors of the H100
MAX_CLUSTER = 8    # blocks per image: the portable cluster size
# A cluster of 16 (a non-portable size: most of one of the card's GPCs)
# for batches of up to WIDE_BATCH images: on the H100 it measured faster
# than 8 for one image and slower for eight, whose clusters of 16 the
# card cannot all place at once (chip_smoke.py, PERF.md).
WIDE_CLUSTER, WIDE_BATCH = 16, 3
MIN_ROWS = 2       # output rows (half-rows inverse) per block on a level
TAP_TEMPLATES = (16, 32)   # compile-time tap bounds of csrc/tail2d.cu


class TailPlan(NamedTuple):
    """How :func:`tail_fw` / :func:`tail_inv` launch (csrc/tail2d.cu)."""
    cluster: int       # P: blocks per image, a power of two
    split: int         # levels 1 .. split run on all P blocks, the rest on rank 0
    taps: int          # compile-time tap bound, or 0: one block, wrapped taps
    rows: tuple        # per level 1 .. L: (rows per block, blocks it runs on)
    halo: tuple        # (left, right) columns and (above, below) rows
    smem: int          # shared bytes per block


def _halo(wt, inverse):
    """Periodic halos of the wrap-free layout: (left, right) columns of the
    row pass's input and (above, below) rows of the column pass's."""
    if inverse:
        offs = np.concatenate([d for d, _ in synthesis_bands(wt)])
        lo, hi = int(offs.min()), int(offs.max())
        return max(0, -lo), max(0, hi), max(0, -lo), max(0, hi)
    ds, _, dd, _ = level_bands(wt)
    offs = np.concatenate([ds, dd])
    half = offs >> 1        # the offset in the even / odd column planes
    return (max(0, -int(half.min())), max(0, int(half.max())),
            max(0, -int(offs.min())), max(0, int(offs.max()) - 1))


def _split(m, L, P):
    """Levels 1 .. k whose rows P blocks share evenly, MIN_ROWS or more of
    them each (output rows forward, half-rows inverse)."""
    if P == 1:
        return L
    k = 0
    while k < L and (m >> (k + 1)) % P == 0 and (m >> (k + 1)) // P >= MIN_ROWS:
        k += 1
    return k


def _elems(m, n, L, P, split, halo, vec, inverse):
    """Shared memory of one block in arithmetic-type elements; mirrors
    TailGeom::elems in csrc/tail2d.cu.  Rank 0 holds the levels after
    ``split`` whole, so every block gets its size."""
    hl, hr, hu, hd = halo

    def up(v):
        return -(-v // vec) * vec

    act = tmp = secs = 0
    for l in range(1, L + 1):
        blocks = P if l <= split else 1
        nh = n >> l
        part = hl + nh + hr           # a row of one column plane or quadrant
        pitch = up(2 * nh)            # a row of the column pass's input
        rows = (m >> l) // blocks     # output rows / half-rows per block
        if inverse:
            secs += up(4 * rows * part)
            tmp = max(tmp, 2 * (hu + rows + hd) * pitch)
        else:
            act = max(act, 2 * 2 * rows * part)
            tmp = max(tmp, (hu + 2 * rows + hd) * pitch)
    # two buffers of the row pass's output when blocks share levels
    return (secs if inverse else up(act)) + tmp * (2 if P > 1 else 1)


@lru_cache(maxsize=None)
def tail_plan(B: int, m: int, n: int, L: int, wt, dtype,
              inverse: bool = False) -> TailPlan:
    """The launch plan of ``B`` images of ``(m, n)`` through ``L`` levels.

    P is the largest power of two up to MAX_CLUSTER (WIDE_CLUSTER for up
    to WIDE_BATCH images) with ``B * P`` blocks within the card's SMs (1
    for B >= 132) whose first level gives every block MIN_ROWS rows or
    more, and whose layout fits a block's shared memory; a band table of
    more than 32 taps, or a layout that fits no P, takes the one-block
    kernel with wrapped taps (the generic route)."""
    P, most = 1, WIDE_CLUSTER if B <= WIDE_BATCH else MAX_CLUSTER
    while P * 2 <= most and B * P * 2 <= SMS:
        P *= 2
    while P >= 1:
        plan = cluster_plan(P, m, n, L, wt, dtype, inverse)
        if plan is not None:
            return plan
        P //= 2
    size = acc_dtype(dtype).itemsize
    return TailPlan(1, L, 0, tuple((m >> l, 1) for l in range(1, L + 1)),
                    _halo(wt, inverse),
                    2 * m * n * size + tap_count(wt, inverse) * (size + 4))


def cluster_plan(P: int, m: int, n: int, L: int, wt, dtype,
                 inverse: bool = False) -> TailPlan | None:
    """The plan with a cluster of ``P`` blocks per image, or None where the
    cluster kernels cannot take it (more than 32 taps, no level that P
    blocks share, or more shared memory than a block has)."""
    size = acc_dtype(dtype).itemsize
    taps = next((t for t in TAP_TEMPLATES if tap_count(wt, inverse) <= t), 0)
    halo = _halo(wt, inverse)
    split = _split(m, L, P)
    smem = _elems(m, n, L, P, split, halo, 16 // size, inverse) * size
    if not taps or split < 1 or smem > SMEM_LIMIT:
        return None
    rows = tuple(((m >> l) // (P if l <= split else 1),
                  P if l <= split else 1) for l in range(1, L + 1))
    return TailPlan(P, split, taps, rows, halo, smem)


def _check(x, L, out, name):
    _check_input(x, f"{name} input")
    B, m, n = x.shape
    if L < 1 or m % (1 << L) or n % (1 << L):
        raise ValueError(f"{name}: {(m, n)} lacks a 2^{L} factor (L >= 1)")
    if out is None:
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    _check_plane(out, f"{name} out", (B, m, n), x.dtype, x.device)
    return out


def _check_fits(x, wt, inverse, name):
    _, m, n = x.shape
    if not tail_fits(m, n, wt, x.dtype, inverse):
        raise ValueError(f"{name}: {(m, n)} {x.dtype} does not fit one "
                         "block's shared memory")


def tail_fw_plain(x, wt, L: int, out=None):
    """Plain PyTorch version of :func:`tail_fw` (without its size limit)."""
    out = _check(x, L, out, "tail_fw")
    PLAIN_CALLS["tail_fw"] += 1
    _, m, n = x.shape
    v = x.to(acc_dtype(x.dtype))
    for l in range(1, L + 1):
        v, *details = quads_fw(v, wt)
        for o, d in zip(detail_planes(out, l), details):
            o.copy_(d)
    out[:, :m >> L, :n >> L] = v
    return out


def tail_inv_plain(y, wt, L: int, out=None):
    """Plain PyTorch version of :func:`tail_inv` (without its size
    limit)."""
    out = _check(y, L, out, "tail_inv")
    PLAIN_CALLS["tail_inv"] += 1
    _, m, n = y.shape
    a = acc_dtype(y.dtype)
    v = y[:, :m >> L, :n >> L].to(a)
    for l in range(L, 0, -1):
        lh, hl, hh = (q.to(a) for q in detail_planes(y, l))
        v = merge_inv(v, lh, hl, hh, wt)
    out.copy_(v)
    return out


@lru_cache(maxsize=None)
def _plan_args(plan):
    """The plan as the C interface takes it: int32[7] and the bytes."""
    return ((ctypes.c_int * 7)(plan.cluster, plan.split, plan.taps,
                               *plan.halo), plan.smem)


def _fw_plan(wt, L, x, out, plan=None):
    """Kernel C's launch plan for this call's signature (``plan``: the
    tail's, else :func:`tail_plan`'s)."""
    B, m, n = x.shape
    plan = plan or tail_plan(B, m, n, L, wt, x.dtype)
    table = band_table(wt, False, x.dtype, x.device)
    return build.Plan(_FW, (
        build.dtype_code(x.dtype), B, m, n, L, x, x.stride(0), x.stride(1),
        out, out.stride(0), out.stride(1), table.offs.data_ptr(),
        table.coefs.data_ptr(), *table.counts, *_plan_args(plan)),
        keep=table)


def _inv_plan(wt, L, y, out, plan=None):
    """Kernel D's launch plan for this call's signature."""
    B, m, n = y.shape
    plan = plan or tail_plan(B, m, n, L, wt, y.dtype, True)
    table = band_table(wt, True, y.dtype, y.device)
    return build.Plan(_INV, (
        build.dtype_code(y.dtype), B, m, n, L, y, y.stride(0), y.stride(1),
        out, out.stride(0), out.stride(1), table.offs.data_ptr(),
        table.coefs.data_ptr(), (ctypes.c_int * 4)(*table.counts),
        *_plan_args(plan)), keep=table)


def _tensors(L, x, out):
    return x, out


_FW = build.Site(
    "tail_fw", lambda wt, L, x, out: (L, x, _check(x, L, out, "tail_fw")),
    _tensors, lambda wt, L, x, out: tail_fw_plain(x, wt, L, out), _fw_plan,
    result=2, fits=lambda wt, L, x, out: _check_fits(x, wt, False, "tail_fw"))
_INV = build.Site(
    "tail_inv", lambda wt, L, y, out: (L, y, _check(y, L, out, "tail_inv")),
    _tensors, lambda wt, L, y, out: tail_inv_plain(y, wt, L, out), _inv_plan,
    result=2, fits=lambda wt, L, y, out: _check_fits(y, wt, True, "tail_inv"))


def tail_fw(x, wt, L: int, out=None):
    """L forward levels of ``x (B, m, n)`` in one launch -> packed ``out``
    ``(B, m, n)`` (allocated when None).  Raises for an array that does not
    fit (:func:`tail_fits`).  Returns ``out``."""
    return build.run(_FW, wt, (L, x, out))


def tail_inv(y, wt, L: int, out=None):
    """Inverse of :func:`tail_fw`: packed ``y (B, m, n)`` -> ``out``
    ``(B, m, n)`` (allocated when None), in one launch.  Returns ``out``."""
    return build.run(_INV, wt, (L, y, out))
