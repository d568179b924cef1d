"""All remaining levels of a periodic 1-D DWT over ``(B, n)`` rows in one
launch: CUDA kernels G (forward) and H (inverse) and their plain versions.

``tail1d_fw`` takes the active rows ``x (B, n)`` through ``L`` levels and
writes each row's packed result (level l's detail at ``[n>>l : n>>(l-1)]``,
the final scaling band at ``[:n>>L]``) to ``out (B, n)``; ``tail1d_inv``
is its inverse.  One CUDA block per row holds the row, plus one scratch
row, in shared memory in the arithmetic type, so the size limit is the
card's (:func:`tail1d_fits`).  They replace the TPU pyramid kernels of
``wavelets_tpu/ops/pallas/pyramid1d.py`` (see csrc/tail1d.cu).

A tensor on the CPU takes the plain PyTorch version (``tail1d_fw_plain``,
``tail1d_inv_plain``); a CUDA tensor launches the kernel or raises.  Both
keep the intermediate scaling band in the arithmetic type and round only
the outputs (bfloat16 storage computes in float32).  Input and output may
be the same memory: each block reads its row before it writes.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .bands import acc_dtype, band_table, tap_count
from .level2d import SMEM_LIMIT, _analysis, _synthesis
from .level1d import check_rows

__all__ = ["LAUNCHES", "PLAIN_CALLS", "tail1d_fits", "tail1d_fw",
           "tail1d_fw_plain", "tail1d_inv", "tail1d_inv_plain"]

LAUNCHES = {"tail1d_fw": 0, "tail1d_inv": 0}
PLAIN_CALLS = {"tail1d_fw": 0, "tail1d_inv": 0}


def tail1d_fits(n: int, wt, dtype, inverse: bool = False) -> bool:
    """Can one block hold a length-n row, its scratch row and the band
    table in shared memory?  (2^14 in float32 and bfloat16, 2^13 in
    float64.)  The same limit holds on the CPU, so both route alike."""
    size = acc_dtype(dtype).itemsize
    return 2 * n * size + tap_count(wt, inverse) * (size + 4) <= SMEM_LIMIT


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


def _launch_fw(x, wt, L, out, stream):
    B, n = x.shape
    table = band_table(wt, False, x.dtype, x.device)
    build.check(build.library().wtt_tail1d_fw(
        build.dtype_code(x.dtype), B, n, L, x.data_ptr(), x.stride(0),
        out.data_ptr(), out.stride(0), table.offs.data_ptr(),
        table.coefs.data_ptr(), *table.counts, table.dmin, table.span,
        stream), "tail1d_fw")


def _launch_inv(y, wt, L, out, stream):
    B, n = y.shape
    table = band_table(wt, True, y.dtype, y.device)
    build.check(build.library().wtt_tail1d_inv(
        build.dtype_code(y.dtype), B, n, L, y.data_ptr(), y.stride(0),
        out.data_ptr(), out.stride(0), table.offs.data_ptr(),
        table.coefs.data_ptr(), (ctypes.c_int * 4)(*table.counts),
        table.dmin, table.span, stream), "tail1d_inv")


def tail1d_fw(x, wt, L: int, out=None):
    """L forward levels of ``x (B, n)`` in one launch -> packed ``out``
    ``(B, n)`` (allocated when None).  Raises for a row that does not fit
    (:func:`tail1d_fits`).  Returns ``out``."""
    out = _check(x, L, out, "tail1d_fw")
    _check_fits(x, wt, False, "tail1d_fw")
    if x.device.type == "cpu":
        return tail1d_fw_plain(x, wt, L, out)
    if x.shape[0]:
        with torch.cuda.device(x.device):
            _launch_fw(x, wt, L, out, torch.cuda.current_stream().cuda_stream)
        LAUNCHES["tail1d_fw"] += 1
    return out


def tail1d_inv(y, wt, L: int, out=None):
    """Inverse of :func:`tail1d_fw`: packed ``y (B, n)`` -> ``out (B, n)``
    (allocated when None), in one launch.  Returns ``out``."""
    out = _check(y, L, out, "tail1d_inv")
    _check_fits(y, wt, True, "tail1d_inv")
    if y.device.type == "cpu":
        return tail1d_inv_plain(y, wt, L, out)
    if y.shape[0]:
        with torch.cuda.device(y.device):
            _launch_inv(y, wt, L, out,
                        torch.cuda.current_stream().cuda_stream)
        LAUNCHES["tail1d_inv"] += 1
    return out
