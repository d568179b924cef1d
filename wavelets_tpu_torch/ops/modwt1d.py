"""One level of the periodic MODWT over ``(B, N)`` rows: CUDA kernels K
(forward) and M (inverse), their plain versions, and the multi-level
driver.

``modwt_fw`` takes the level-(j-1) scaling band ``v (B, N)`` to
``(v_j, w_j)`` from one read of ``v``; ``modwt_inv`` takes ``(v_j, w_j)``
back to ``v``.  The taps are ``2^(j-1)`` apart and wrap with a true modulo,
so any ``N >= 2^j`` runs.  Every plane is a view with a row stride and an
element stride, so the driver writes each ``w_j`` straight into its column
of the ``(B, N, L+1)`` output (element stride L+1) and the inverse reads it
from there.

The filters are ``ops/modwt.modwt_filter_pair``'s and the plain versions
are ``ops/modwt.modwt_step`` / ``imodwt_step``.  The kernels replace
``wavelets_tpu/ops/pallas/modwt1d.py``'s (see csrc/modwt1d.cu).  A tensor
on the CPU takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.  Arithmetic runs in float32 for float32 and bfloat16
storage (bfloat16 outputs are rounded once per level) and in float64 for
float64.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import build
from .bands import acc_dtype
from .level2d import DTYPES, _check_disjoint
from .modwt import check_levels, imodwt_step, modwt_filter_pair, modwt_step
from .scratch import Scratch

__all__ = ["LAUNCHES", "PLAIN_CALLS", "modwt_fw", "modwt_fw_plain",
           "modwt_inv", "modwt_inv_plain", "modwt", "imodwt"]

LAUNCHES = {"modwt_fw": 0, "modwt_inv": 0}
PLAIN_CALLS = {"modwt_fw": 0, "modwt_inv": 0}


def _check_rows(t, name, shape=None, dtype=None, device=None):
    """``t`` must be a ``(B, N)`` tensor (any strides), of the given shape,
    dtype and device where given."""
    if not isinstance(t, torch.Tensor) or t.dim() != 2:
        raise ValueError(f"{name} must be a (B, N) tensor")
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


def _check_level(N: int, j: int):
    if j < 1 or N < 1:
        raise ValueError(f"level {j} of length {N}: need j >= 1 and N >= 1")


def _fw_outs(v, j, v1, w1):
    _check_rows(v, "v")
    _check_level(v.shape[1], j)
    if v1 is None and w1 is None:
        return torch.empty_like(v), torch.empty_like(v)
    if v1 is None or w1 is None:
        raise ValueError("give both output planes v1 and w1, or neither")
    _check_rows(v1, "v1", v.shape, v.dtype, v.device)
    _check_rows(w1, "w1", v.shape, v.dtype, v.device)
    return v1, w1


def _inv_out(v1, w1, j, out):
    _check_rows(v1, "v1")
    _check_level(v1.shape[1], j)
    _check_rows(w1, "w1", v1.shape, v1.dtype, v1.device)
    if out is None:
        return torch.empty(v1.shape, dtype=v1.dtype, device=v1.device)
    _check_rows(out, "out", v1.shape, v1.dtype, v1.device)
    return out


# --- plain versions ----------------------------------------------------------

def modwt_fw_plain(v, wt, j: int, v1=None, w1=None):
    """Plain PyTorch version of :func:`modwt_fw` (``ops/modwt.modwt_step``
    in the arithmetic type)."""
    v1, w1 = _fw_outs(v, j, v1, w1)
    g, h = modwt_filter_pair(wt)
    PLAIN_CALLS["modwt_fw"] += 1
    sv, sw = modwt_step(v.to(acc_dtype(v.dtype)), j, h, g)
    v1.copy_(sv)
    w1.copy_(sw)
    return v1, w1


def modwt_inv_plain(v1, w1, wt, j: int, out=None):
    """Plain PyTorch version of :func:`modwt_inv`."""
    out = _inv_out(v1, w1, j, out)
    g, h = modwt_filter_pair(wt)
    PLAIN_CALLS["modwt_inv"] += 1
    a = acc_dtype(v1.dtype)
    out.copy_(imodwt_step(v1.to(a), w1.to(a), j, h, g))
    return out


# --- kernels -----------------------------------------------------------------

@lru_cache(maxsize=None)
def _taps(wt, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """g then h in the arithmetic type, on the device, built once per
    (wavelet, dtype, device)."""
    g, h = modwt_filter_pair(wt)
    return torch.as_tensor(np.concatenate([g, h]), device=device).to(
        acc_dtype(dtype))


def _rows_args(t):
    return t.data_ptr(), t.stride(0), t.stride(1)


def _launch_fw(v, wt, j, v1, w1, stream):
    taps = _taps(wt, v.dtype, v.device)
    B, N = v.shape
    build.check(build.library().wtt_modwt_fw(
        build.dtype_code(v.dtype), B, N, 2 ** (j - 1) % N, *_rows_args(v),
        *_rows_args(v1), *_rows_args(w1), taps.data_ptr(), taps.numel() // 2,
        stream), "modwt_fw")


def _launch_inv(v1, w1, wt, j, out, stream):
    taps = _taps(wt, v1.dtype, v1.device)
    B, N = v1.shape
    build.check(build.library().wtt_modwt_inv(
        build.dtype_code(v1.dtype), B, N, 2 ** (j - 1) % N, *_rows_args(v1),
        *_rows_args(w1), *_rows_args(out), taps.data_ptr(), taps.numel() // 2,
        stream), "modwt_inv")


def modwt_fw(v, wt, j: int, v1=None, w1=None):
    """MODWT level ``j`` of ``v (B, N)``: the planes ``v1`` (scaling) and
    ``w1`` (detail), ``(B, N)`` views with any strides (allocated when both
    are None), which may not overlap ``v``.  Returns ``(v1, w1)``."""
    v1, w1 = _fw_outs(v, j, v1, w1)
    _check_disjoint((v,), (v1, w1), "modwt_fw")
    if v.device.type == "cpu":
        return modwt_fw_plain(v, wt, j, v1, w1)
    if v.numel():
        with torch.cuda.device(v.device):
            _launch_fw(v, wt, j, v1, w1,
                       torch.cuda.current_stream().cuda_stream)
        LAUNCHES["modwt_fw"] += 1
    return v1, w1


def modwt_inv(v1, w1, wt, j: int, out=None):
    """Inverse of :func:`modwt_fw`: ``(v1, w1)`` -> ``out (B, N)`` (any
    strides; allocated when None), which may not overlap them."""
    out = _inv_out(v1, w1, j, out)
    _check_disjoint((v1, w1), (out,), "modwt_inv")
    if v1.device.type == "cpu":
        return modwt_inv_plain(v1, w1, wt, j, out)
    if v1.numel():
        with torch.cuda.device(v1.device):
            _launch_inv(v1, w1, wt, j, out,
                        torch.cuda.current_stream().cuda_stream)
        LAUNCHES["modwt_inv"] += 1
    return out


# --- the multi-level driver ----------------------------------------------------

def modwt(x, wt, L: int, *, plain: bool = False):
    """L-level MODWT of ``x (B, N)`` -> ``(B, N, L+1)``: detail j in column
    j-1, the scaling band in column L.  One K launch per level; the scaling
    bands take turns in two scratch rows, and each detail lands in its
    column.  ``plain=True`` runs the plain versions on any device."""
    B, N = x.shape
    check_levels(N, L)
    fw = modwt_fw_plain if plain else modwt_fw
    out = torch.empty((B, N, L + 1), dtype=x.dtype, device=x.device)
    scratch = Scratch(x, (B * N, B * N))
    v = x
    for j in range(1, L + 1):
        v1 = out[..., L] if j == L else scratch.view((j - 1) % 2, B, N)
        fw(v, wt, j, v1, out[..., j - 1])
        v = v1
    return out


def imodwt(xw, wt, *, plain: bool = False):
    """Inverse of :func:`modwt`: ``xw (B, N, L+1)`` -> ``(B, N)``; one M
    launch per level, reading each column in place."""
    B, N, L1 = xw.shape
    L = L1 - 1
    inv = modwt_inv_plain if plain else modwt_inv
    out = torch.empty((B, N), dtype=xw.dtype, device=xw.device)
    if L == 0:
        return out.copy_(xw[..., 0])
    scratch = Scratch(xw, (B * N, B * N))
    v = xw[..., L]
    for j in range(L, 0, -1):
        dest = out if j == 1 else scratch.view(j % 2, B, N)
        v = inv(v, xw[..., j - 1], wt, j, out=dest)
    return out
