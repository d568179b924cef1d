"""One periodic DWT level along the middle axis of ``(B, R, C)`` views:
CUDA kernels I (forward) and J (inverse) and their plain versions.

``axis0_fw`` takes ``x (B, R, C)`` to the scaling and detail planes ``a``
and ``d`` (each ``(B, R/2, C)``), where each batch item is transformed
along its rows.  Every input and output is any strided view with a unit
column stride, so the 3-D driver (ops/dwt3d.py) runs the pass along axis 0
of a sub-cube (B = m', R = d', C = n') from its scratch straight into the
packed output, and the JAX package's ``axis0_level_fw(x (R, C))`` is
B = 1 with ``[a; d]`` the two halves of the output.  ``axis0_inv`` is its
inverse: the two planes in, one ``(B, 2Rh, C)`` view out.  It may read
``a``'s leading ``(Bc, Rh, Cc)`` block from a separate ``corner`` view,
which is how the 3-D inverse joins the deeper level's result to the stored
details without a copy.

Both are driven by the wavelet's bands (ops/bands.py), as kernels A-H are;
the plain versions are the 1-D passes of ops/level2d.py along dim -2.
They replace the TPU kernels of ``wavelets_tpu/ops/pallas/axis0.py`` (see
csrc/axis0.cu).  A tensor on the CPU takes the plain PyTorch version
(``axis0_fw_plain``, ``axis0_inv_plain``); a CUDA tensor launches the
kernel or raises.  Arithmetic runs in float32 for float32 and bfloat16
storage (bfloat16 outputs are rounded once) and in float64 for float64.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .bands import acc_dtype, band_table
from .level2d import _analysis, _check_disjoint, _check_input, _check_plane, \
    _synthesis

__all__ = ["LAUNCHES", "PLAIN_CALLS", "axis0_fw", "axis0_fw_plain",
           "axis0_inv", "axis0_inv_plain"]

LAUNCHES = {"axis0_fw": 0, "axis0_inv": 0}
PLAIN_CALLS = {"axis0_fw": 0, "axis0_inv": 0}


def _fw_outs(x, a, d):
    B, R, C = x.shape
    if R < 2 or R % 2:
        raise ValueError(f"axis0_fw needs an even row count, got {R}")
    shape = (B, R // 2, C)
    if a is None and d is None:
        return (torch.empty(shape, dtype=x.dtype, device=x.device),
                torch.empty(shape, dtype=x.dtype, device=x.device))
    if a is None or d is None:
        raise ValueError("give both output planes a and d, or neither")
    _check_plane(a, "a", shape, x.dtype, x.device)
    _check_plane(d, "d", shape, x.dtype, x.device)
    return a, d


def _inv_args(a, d, out, corner):
    _check_input(a, "a")
    B, Rh, C = a.shape
    if Rh < 1:
        raise ValueError("axis0_inv needs non-empty planes")
    _check_plane(d, "d", (B, Rh, C), a.dtype, a.device)
    if corner is not None:
        if (not isinstance(corner, torch.Tensor) or corner.dim() != 3
                or corner.shape[1] != Rh or corner.shape[0] > B
                or corner.shape[2] > C):
            raise ValueError(f"corner must be a (Bc <= {B}, {Rh}, Cc <= {C}) "
                             "tensor")
        _check_plane(corner, "corner", corner.shape, a.dtype, a.device)
    shape = (B, 2 * Rh, C)
    if out is None:
        return torch.empty(shape, dtype=a.dtype, device=a.device)
    _check_plane(out, "out", shape, a.dtype, a.device)
    return out


# --- plain versions ----------------------------------------------------------

def axis0_fw_plain(x, wt, a=None, d=None):
    """Plain PyTorch version of :func:`axis0_fw` (same outputs, same
    layout), computed with index_select gathers in the arithmetic type."""
    _check_input(x)
    a, d = _fw_outs(x, a, d)
    PLAIN_CALLS["axis0_fw"] += 1
    sa, sd = _analysis(x.to(acc_dtype(x.dtype)), wt, -2)
    a.copy_(sa)
    d.copy_(sd)
    return a, d


def axis0_inv_plain(a, d, wt, out=None, corner=None):
    """Plain PyTorch version of :func:`axis0_inv`."""
    out = _inv_args(a, d, out, corner)
    PLAIN_CALLS["axis0_inv"] += 1
    acc = acc_dtype(a.dtype)
    s = a.to(acc, copy=True)
    if corner is not None:
        Bc, _, Cc = corner.shape
        s[:Bc, :, :Cc] = corner
    out.copy_(_synthesis(s, d.to(acc), wt, -2))
    return out


# --- kernels -----------------------------------------------------------------

def _launch_fw(x, wt, a, d, stream):
    table = band_table(wt, False, x.dtype, x.device)
    B, R, C = x.shape
    build.check(build.library().wtt_axis0_fw(
        build.dtype_code(x.dtype), B, R, C, x.data_ptr(), x.stride(0),
        x.stride(1), a.data_ptr(), a.stride(0), a.stride(1), d.data_ptr(),
        d.stride(0), d.stride(1), table.offs.data_ptr(),
        table.coefs.data_ptr(), *table.counts, table.dmin, table.span,
        stream), "axis0_fw")


def _launch_inv(a, d, wt, out, corner, stream):
    table = band_table(wt, True, a.dtype, a.device)
    B, Rh, C = a.shape
    if corner is None:
        cptr, csb, csr, Bc, Cc = None, 0, 0, 0, 0
    else:
        cptr, csb, csr = corner.data_ptr(), corner.stride(0), corner.stride(1)
        Bc, Cc = corner.shape[0], corner.shape[2]
    build.check(build.library().wtt_axis0_inv(
        build.dtype_code(a.dtype), B, Rh, C, a.data_ptr(), a.stride(0),
        a.stride(1), d.data_ptr(), d.stride(0), d.stride(1), cptr, csb, csr,
        Bc, Cc, out.data_ptr(), out.stride(0), out.stride(1),
        table.offs.data_ptr(), table.coefs.data_ptr(),
        (ctypes.c_int * 4)(*table.counts), table.dmin, table.span, stream),
        "axis0_inv")


def axis0_fw(x, wt, a=None, d=None):
    """Forward level along the middle axis of ``x (B, R, C)`` into the
    planes ``a`` and ``d`` (``(B, R/2, C)``, unit column stride, any other
    strides; allocated when both are None).  The outputs may not overlap
    ``x``.  Returns ``(a, d)``."""
    _check_input(x)
    a, d = _fw_outs(x, a, d)
    _check_disjoint((x,), (a, d), "axis0_fw")
    if x.device.type == "cpu":
        return axis0_fw_plain(x, wt, a, d)
    if x.numel():
        with torch.cuda.device(x.device):
            _launch_fw(x, wt, a, d, torch.cuda.current_stream().cuda_stream)
        LAUNCHES["axis0_fw"] += 1
    return a, d


def axis0_inv(a, d, wt, out=None, corner=None):
    """Inverse level along the middle axis: the planes ``a`` and ``d``
    ``(B, Rh, C)`` -> ``out (B, 2Rh, C)`` (allocated when None).  Where
    ``corner (Bc, Rh, Cc)`` is given, ``a[:Bc, :, :Cc]`` is read from it
    instead.  Every view has unit column stride; ``out`` may not overlap
    the inputs.  Returns ``out``."""
    out = _inv_args(a, d, out, corner)
    reads = (a, d) if corner is None else (a, d, corner)
    _check_disjoint(reads, (out,), "axis0_inv")
    if a.device.type == "cpu":
        return axis0_inv_plain(a, d, wt, out, corner)
    if a.numel():
        with torch.cuda.device(a.device):
            _launch_inv(a, d, wt, out, corner,
                        torch.cuda.current_stream().cuda_stream)
        LAUNCHES["axis0_inv"] += 1
    return out
