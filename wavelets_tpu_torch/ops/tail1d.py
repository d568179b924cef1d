"""All remaining levels of a periodic 1-D DWT over ``(B, n)`` rows in one
launch: CUDA kernels G (forward) and H (inverse) and their plain versions.

``tail1d_fw`` takes the active rows ``x (B, n)`` through ``L`` levels and
writes each row's packed result (level l's detail at ``[n>>l : n>>(l-1)]``,
the final scaling band at ``[:n>>L]``) to ``out (B, n)``; ``tail1d_inv``
is its inverse.  One CUDA block per row holds the row, plus one scratch
row, in shared memory in the arithmetic type, so the size limit is the
card's (:func:`tail1d_fits`; the staged forms take no more).  They
replace the TPU pyramid kernels of
``wavelets_tpu/ops/pallas/pyramid1d.py`` (see csrc/tail1d.cu).  Where the
bands' span is below 16 (:func:`fw_window`, :func:`inv_window`), both run
their staged forms: each block stages its rows once with 16-byte copies,
short rows several to a block, and every level reads shared memory only,
V output pairs per thread from windows in registers, into one of two
scaling buffers (the forward's details go straight to their packed
offsets); :func:`fw_plan` and :func:`inv_plan` mirror their geometry.

A tensor on the CPU takes the plain PyTorch version (``tail1d_fw_plain``,
``tail1d_inv_plain``); a CUDA tensor launches the kernel or raises.  Both
keep the intermediate scaling band in the arithmetic type and round only
the outputs (bfloat16 storage computes in float32).  Input and output may
be the same memory: each block reads its row before it writes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from .bands import (acc_dtype, band_table, level_bands, synthesis_bands,
                    tap_count)
from .level2d import SMEM_LIMIT, _analysis, _synthesis
from .level1d import check_rows, fw1d_window

__all__ = ["LAUNCHES", "PLAIN_CALLS", "tail1d_fits", "tail1d_fw",
           "tail1d_fw_plain", "tail1d_inv", "tail1d_inv_plain", "fw_window",
           "fw_plan", "inv_window", "inv_plan", "TailPlan"]

LAUNCHES = build.counter("tail1d_fw", "tail1d_inv")
PLAIN_CALLS = {"tail1d_fw": 0, "tail1d_inv": 0}

# the staged forms of kernels G and H (csrc/tail1d.cu): their window
# bounds (G's in output pairs, H's in offsets), threads per block at most,
# items per thread at the first level that set the rows a block holds; the
# first forms' threads at most
FW_WINDOWS = (4, 8)
INV_WINDOWS = (4, 8)
_HS_THREADS, _HS_IPT = 256, 2
_H_THREADS = 256
# G's staged form takes blocks of 128 threads (twice the items each) where
# the launch has at least _GS_WIDE blocks (the H100's SMs)
_GS_WIDE = 132


def tail1d_fits(n: int, wt, dtype, inverse: bool = False) -> bool:
    """Can one block hold a length-n row, its scratch row and the band
    table in shared memory?  (2^14 in float32 and bfloat16, 2^13 in
    float64.)  The same limit holds on the CPU, so both route alike."""
    size = acc_dtype(dtype).itemsize
    return 2 * n * size + tap_count(wt, inverse) * (size + 4) <= SMEM_LIMIT


def inv_window(wt) -> int:
    """The window of kernel H's staged form for ``wt``'s synthesis bands:
    the smallest of INV_WINDOWS that holds each source's taps (the S
    bands' offsets of both parities, and the D bands'), or 0, the first
    form, where none does or the bands' span is 16 or more.  The wrapper
    passes it to csrc/tail1d.cu, whose kernel checks that the bands fit
    it."""
    (s0, _), (d0, _), (s1, _), (d1, _) = synthesis_bands(wt)
    offs = [int(o) for o in (*s0, *d0, *s1, *d1)]
    if max(offs) - min(offs) >= 16:
        return 0
    ext = max(int(max(a.max(), b.max()) - min(a.min(), b.min())) + 1
              for a, b in ((s0, s1), (d0, d1)))
    return next((w for w in INV_WINDOWS if ext <= w), 0)


def fw_window(wt) -> int:
    """The window of kernel G's staged form for ``wt``'s analysis bands, in
    output pairs: half the smallest of level1d's FW1D_WINDOWS (8 or 16
    samples) that holds each band's offsets (so haar, db2 and db4 take 4,
    cdf97 8), or 0, the first form, where :func:`level1d.fw1d_window` gives
    none (a span of 16 or more: sym5, db10), where an offset lies more
    than 16 from the pair, or where a band's taps are not in the order the
    kernel sums them (the S band ascending, the D band ascending or
    descending).  The wrapper passes it to csrc/tail1d.cu, whose kernel
    checks that the bands fit it."""
    ds, _, dd, _ = level_bands(wt)
    offs = [int(o) for o in (*ds, *dd)]
    if not fw1d_window(wt) or min(offs) < -16 or max(offs) > 16:
        return 0
    steps = (list(map(int, ds[1:] - ds[:-1])), list(map(int, dd[1:] - dd[:-1])))
    if any(s <= 0 for s in steps[0]) or not (
            all(s > 0 for s in steps[1]) or all(s < 0 for s in steps[1])):
        return 0
    ext = max(int(b.max() - b.min()) + 1 for b in (ds, dd))  # samples
    return next((w for w in FW_WINDOWS if ext <= 2 * w), 0)


class TailPlan(NamedTuple):
    """Kernel G's or H's launch as csrc/tail1d.cu plans it: the window (0:
    the first form, one row per block), the staging path (16 or 4 bytes;
    0 for the first form), rows per block, threads per block, blocks,
    staged elements per row, scaling-buffer elements per row (X and Y; the
    first form's scratch row), shared bytes."""
    window: int
    staging: int
    rows: int
    threads: int
    blocks: int
    ps: int
    pa: int
    smem: int


def _plan(x, window, taps, mt=_HS_THREADS, ipt=_HS_IPT) -> TailPlan:
    """The plan of either staged form (or of the first form, ``window`` 0)
    for the rows ``x (B, n)``: the same geometry in both directions, at
    most ``ipt`` items a thread at the first level of at most ``mt``
    threads."""
    B, n = x.shape
    size, acc = x.element_size(), acc_dtype(x.dtype).itemsize
    table = taps * (acc + 4)
    if not window:
        threads = min(max(-(-(n // 2) // 32) * 32, 32), _H_THREADS)
        return TailPlan(0, 0, 1, threads, B, n, n, 2 * n * acc + table)
    e, v = 16 // size, 16 // acc
    per = -(-(n // 2) // v)
    rows = max(1, min(B, ipt * mt // per))
    threads = min(-(-(rows * per) // (ipt * 32)) * 32, mt)
    ps = -(-n // e) * e
    pa = -(-(n // 2) // v) * v + -(-(n // 4) // v) * v
    vec = n % e == 0 and x.data_ptr() % 16 == 0 and x.stride(0) % e == 0
    return TailPlan(window, 16 if vec else 4, rows, threads, -(-B // rows),
                    ps, pa, rows * (ps * size + pa * acc) + table)


def fw_plan(x, wt, L: int, staged: bool = True) -> TailPlan:
    """How kernel G runs the L levels of the rows ``x (B, n)``: a pure
    function of their shape, row stride and data pointer, mirroring
    csrc/tail1d.cu.  ``staged=False`` asks for the first form, as a window
    of 0 does at the C entry.  The staged form's geometry is H's
    (:func:`inv_plan`): as many rows as keep its first level within two
    items (V pairs each) per thread of 256 threads (one row where a row
    has more), each staged whole, with its two scaling buffers of half and
    a quarter of a row in the arithmetic type; but where that makes 132
    blocks or more, blocks of 128 threads of four items each (the same
    rows), and Y in the row's stage, which no level reads after the
    first: a row takes n storage elements and X's n/2 in the arithmetic
    type, less than the first form's bytes.  The 16-byte staging path
    needs x's base, row stride and n in whole 16-byte words."""
    window, taps = (fw_window(wt) if staged else 0), tap_count(wt, False)
    plan = _plan(x, window, taps, _HS_THREADS // 2, 2 * _HS_IPT)
    if plan.blocks < _GS_WIDE:
        plan = _plan(x, window, taps)
    if not window:
        return plan
    acc = acc_dtype(x.dtype).itemsize
    xa = -(-(x.shape[1] // 2) // (16 // acc)) * (16 // acc)
    return plan._replace(pa=xa, smem=plan.smem - plan.rows * (plan.pa - xa)
                         * acc)


def inv_plan(y, wt, L: int, staged: bool = True) -> TailPlan:
    """How kernel H runs the L levels of the packed rows ``y (B, n)``: a
    pure function of their shape, row stride and data pointer, mirroring
    csrc/tail1d.cu.  ``staged=False`` asks for the first form, as a window
    of 0 does at the C entry.  The staged form holds as many rows as keep
    its first level within two items (V pairs each) per thread of 256
    threads (one row where a row has more), each staged whole, with its
    two scaling buffers of half and a quarter of a row in the arithmetic
    type.  Its 16-byte staging path needs y's base, row stride and n in
    whole 16-byte words."""
    return _plan(y, inv_window(wt) if staged else 0, tap_count(wt, True))


def _check(x, L, out, name):
    check_rows(x, f"{name} input")
    B, n = x.shape
    if L < 1 or n % (1 << L):
        raise ValueError(f"{name}: length {n} lacks a 2^{L} factor (L >= 1)")
    if out is None:
        return torch.empty((B, n), dtype=x.dtype, device=x.device)
    check_rows(out, f"{name} out", (B, n), x.dtype, x.device)
    return out


def _check_fits(x, wt, inverse, name):
    n = x.shape[1]
    if not tail1d_fits(n, wt, x.dtype, inverse):
        raise ValueError(f"{name}: a row of {n} {x.dtype} does not fit one "
                         "block's shared memory")


def tail1d_fw_plain(x, wt, L: int, out=None):
    """Plain PyTorch version of :func:`tail1d_fw` (without its size
    limit)."""
    out = _check(x, L, out, "tail1d_fw")
    PLAIN_CALLS["tail1d_fw"] += 1
    n = x.shape[1]
    v = x.to(acc_dtype(x.dtype))
    for l in range(1, L + 1):
        v, d = _analysis(v, wt, -1)
        out[:, n >> l: n >> (l - 1)] = d
    out[:, : n >> L] = v
    return out


def tail1d_inv_plain(y, wt, L: int, out=None):
    """Plain PyTorch version of :func:`tail1d_inv` (without its size
    limit)."""
    out = _check(y, L, out, "tail1d_inv")
    PLAIN_CALLS["tail1d_inv"] += 1
    n = y.shape[1]
    a = acc_dtype(y.dtype)
    v = y[:, : n >> L].to(a)
    for l in range(L, 0, -1):
        v = _synthesis(v, y[:, n >> l: n >> (l - 1)].to(a), wt, -1)
    out.copy_(v)
    return out


def _fw_plan(wt, L, x, out, staged=True):
    """Kernel G's launch plan for this call's signature (``staged=False``:
    the first form)."""
    B, n = x.shape
    table = band_table(wt, False, x.dtype, x.device)
    return build.Plan(_FW, (
        build.dtype_code(x.dtype), B, n, L, x, x.stride(0), out,
        out.stride(0), table.offs.data_ptr(), table.coefs.data_ptr(),
        *table.counts, table.dmin, table.span,
        fw_window(wt) if staged else 0), keep=table)


def _inv_plan(wt, L, y, out, staged=True):
    """Kernel H's launch plan for this call's signature."""
    B, n = y.shape
    table = band_table(wt, True, y.dtype, y.device)
    return build.Plan(_INV, (
        build.dtype_code(y.dtype), B, n, L, y, y.stride(0), out,
        out.stride(0), table.offs.data_ptr(), table.coefs.data_ptr(),
        (ctypes.c_int * 4)(*table.counts), table.dmin, table.span,
        inv_window(wt) if staged else 0), keep=table)


def _tensors(L, x, out):
    return x, out


_FW = build.Site(
    "tail1d_fw",
    lambda wt, L, x, out: (L, x, _check(x, L, out, "tail1d_fw")), _tensors,
    lambda wt, L, x, out: tail1d_fw_plain(x, wt, L, out), _fw_plan, result=2,
    fits=lambda wt, L, x, out: _check_fits(x, wt, False, "tail1d_fw"))
_INV = build.Site(
    "tail1d_inv",
    lambda wt, L, y, out: (L, y, _check(y, L, out, "tail1d_inv")), _tensors,
    lambda wt, L, y, out: tail1d_inv_plain(y, wt, L, out), _inv_plan,
    result=2,
    fits=lambda wt, L, y, out: _check_fits(y, wt, True, "tail1d_inv"))


def tail1d_fw(x, wt, L: int, out=None):
    """L forward levels of ``x (B, n)`` in one launch -> packed ``out``
    ``(B, n)`` (allocated when None): the staged form where
    :func:`fw_window` gives a window, else the first form.  Raises for a
    row that does not fit (:func:`tail1d_fits`).  Returns ``out``."""
    return build.run(_FW, wt, (L, x, out))


def tail1d_inv(y, wt, L: int, out=None):
    """Inverse of :func:`tail1d_fw`: packed ``y (B, n)`` -> ``out (B, n)``
    (allocated when None), in one launch: the staged form where
    :func:`inv_window` gives a window, else the first form.  Returns
    ``out``."""
    return build.run(_INV, wt, (L, y, out))
