"""All remaining levels of a small periodic 2-D DWT in one launch.

``tail_fw`` takes the active array ``x (B, m, n)`` through ``L`` levels and
writes the packed result (each level's LH/HL/HH at its offsets, the final
LL in the corner) to ``out (B, m, n)``; ``tail_inv`` is its inverse.  One
CUDA block per image holds the whole array, plus one scratch array of the
same size, in shared memory in the arithmetic type, so the size limit is
the card's (:func:`tail_fits`), not the TPU's.  They replace the TPU
kernels of ``wavelets_tpu/ops/pallas/tail2d.py`` (see csrc/tail2d.cu).

A tensor on the CPU takes the plain PyTorch version (``tail_fw_plain``,
``tail_inv_plain``); a CUDA tensor launches the kernel or raises.  Both
keep the intermediate LL in the arithmetic type and round only the outputs
(bfloat16 storage computes in float32).  Input and output may be the same
memory: each block reads its whole image before it writes.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .bands import acc_dtype, band_table, level_bands, synthesis_bands
from .level2d import (SMEM_LIMIT, _check_input, _check_plane, detail_planes,
                      merge_inv, quads_fw)

__all__ = ["LAUNCHES", "PLAIN_CALLS", "tail_fits", "tail_fw", "tail_fw_plain",
           "tail_inv", "tail_inv_plain"]

LAUNCHES = {"tail_fw": 0, "tail_inv": 0}
PLAIN_CALLS = {"tail_fw": 0, "tail_inv": 0}


def _taps(wt, inverse: bool) -> int:
    if inverse:
        return sum(len(d) for d, _ in synthesis_bands(wt))
    ds, _, dd, _ = level_bands(wt)
    return len(ds) + len(dd)


def tail_fits(m: int, n: int, wt, dtype, inverse: bool = False) -> bool:
    """Can one block hold an (m, n) array, its scratch and the band table in
    shared memory?  (128 x 128 in float32 and bfloat16, 64 x 128 in
    float64.)  The same limit holds on the CPU, so both route alike."""
    size = acc_dtype(dtype).itemsize
    return 2 * m * n * size + _taps(wt, inverse) * (size + 4) <= SMEM_LIMIT


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


def _launch_fw(x, wt, L, out, stream):
    B, m, n = x.shape
    table = band_table(wt, False, x.dtype, x.device)
    build.check(build.library().wtt_tail_fw(
        build.dtype_code(x.dtype), B, m, n, L, x.data_ptr(), x.stride(0),
        x.stride(1), out.data_ptr(), out.stride(0), out.stride(1),
        table.offs.data_ptr(), table.coefs.data_ptr(), *table.counts,
        stream), "tail_fw")


def _launch_inv(y, wt, L, out, stream):
    B, m, n = y.shape
    table = band_table(wt, True, y.dtype, y.device)
    build.check(build.library().wtt_tail_inv(
        build.dtype_code(y.dtype), B, m, n, L, y.data_ptr(), y.stride(0),
        y.stride(1), out.data_ptr(), out.stride(0), out.stride(1),
        table.offs.data_ptr(), table.coefs.data_ptr(),
        (ctypes.c_int * 4)(*table.counts), stream), "tail_inv")


def tail_fw(x, wt, L: int, out=None):
    """L forward levels of ``x (B, m, n)`` in one launch -> packed ``out``
    ``(B, m, n)`` (allocated when None).  Raises for an array that does not
    fit (:func:`tail_fits`).  Returns ``out``."""
    out = _check(x, L, out, "tail_fw")
    _check_fits(x, wt, False, "tail_fw")
    if x.device.type == "cpu":
        return tail_fw_plain(x, wt, L, out)
    if x.shape[0]:
        with torch.cuda.device(x.device):
            _launch_fw(x, wt, L, out, torch.cuda.current_stream().cuda_stream)
        LAUNCHES["tail_fw"] += 1
    return out


def tail_inv(y, wt, L: int, out=None):
    """Inverse of :func:`tail_fw`: packed ``y (B, m, n)`` -> ``out``
    ``(B, m, n)`` (allocated when None), in one launch.  Returns ``out``."""
    out = _check(y, L, out, "tail_inv")
    _check_fits(y, wt, True, "tail_inv")
    if y.device.type == "cpu":
        return tail_inv_plain(y, wt, L, out)
    if y.shape[0]:
        with torch.cuda.device(y.device):
            _launch_inv(y, wt, L, out, torch.cuda.current_stream().cuda_stream)
        LAUNCHES["tail_inv"] += 1
    return out
