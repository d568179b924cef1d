"""The periodic MODWT over ``(B, N)`` rows: the CUDA kernels (all forward
levels of a row in one launch, and all inverse levels; one level forward,
K, and inverse, M), their plain versions, and the multi-level driver.

``modwt_fw_levels`` takes ``x (B, N)`` through levels 1..L into the
``(B, N, L+1)`` result in one launch: a thread-block cluster per row keeps
the scaling band in shared memory for every level and writes each block's
span of the result once, contiguously (:func:`modwt_plan` picks the
cluster).  ``modwt_inv_levels`` is its inverse, in the same layout: each
block reads its span of ``(B, N, L+1)`` once, contiguously, and writes
its span of the ``(B, N)`` result once (:func:`modwt_inv_plan`).
``modwt_fw`` takes the level-(j-1) scaling band ``v (B, N)`` to
``(v_j, w_j)`` from one read of ``v``; ``modwt_inv`` takes ``(v_j, w_j)``
back to ``v``.  The taps are ``2^(j-1)`` apart and wrap with a true modulo,
so any ``N >= 2^j`` runs.  Every plane of K and M is a view with a row
stride and an element stride, so the driver writes each ``w_j`` of a row
too long for the plan straight into its column of the ``(B, N, L+1)``
output (element stride L+1), and the inverse reads it from there.

The filters are ``ops/modwt.modwt_filter_pair``'s and the plain versions
are ``ops/modwt.modwt_step`` / ``imodwt_step``.  The kernels replace
``wavelets_tpu/ops/pallas/modwt1d.py``'s (see csrc/modwt1d.cu).  A tensor
on the CPU takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.  Arithmetic runs in float32 for float32 and bfloat16
storage (bfloat16 outputs are rounded once per level) and in float64 for
float64.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from . import build
from .bands import acc_dtype
from .level2d import DTYPES, SMEM_LIMIT
from .modwt import check_levels, imodwt_step, modwt_filter_pair, modwt_step
from .scratch import Scratch

__all__ = ["LAUNCHES", "PLAIN_CALLS", "ModwtPlan", "modwt_plan",
           "modwt_inv_plan", "cluster_plan", "modwt_fw_levels",
           "modwt_fw_levels_plain", "modwt_inv_levels",
           "modwt_inv_levels_plain", "modwt_fw", "modwt_fw_plain",
           "modwt_inv", "modwt_inv_plain", "modwt", "imodwt"]

LAUNCHES = build.counter("modwt_fw_levels", "modwt_inv_levels", "modwt_fw",
                         "modwt_inv")
PLAIN_CALLS = {"modwt_fw_levels": 0, "modwt_inv_levels": 0, "modwt_fw": 0,
               "modwt_inv": 0}

SMS = 132              # streaming multiprocessors of the H100
MAX_CLUSTER = 8        # blocks per row: the portable cluster size
# a cluster of 16 (non-portable) only for batches of up to WIDE_BATCH
# rows, as ops/tail2d.py takes it
WIDE_CLUSTER, WIDE_BATCH = 16, 3
MIN_SPAN = 128         # samples per block below which no block is added
TAP_TEMPLATES = (8, 16, 32)   # compile-time tap bounds of csrc/modwt1d.cu


class ModwtPlan(NamedTuple):
    """How :func:`modwt_fw_levels` launches (csrc/modwt1d.cu)."""
    fits: bool     # False: the row takes one K launch per level
    cluster: int   # P: blocks per row, a power of two
    span: int      # R: samples per block (the last block takes the rest)
    halo: int      # H: level L's reach, (taps - 1) 2^(L-1) samples
    taps: int      # compile-time tap bound
    smem: int      # shared bytes per block


def _layout_bytes(N, L, P, H, size):
    """Shared bytes of one block; mirrors ModwtGeom::elems in
    csrc/modwt1d.cu: two scaling buffers of H + R, and the output stage of
    R (L + 1) samples plus one 16-byte word, each rounded to 16 bytes."""
    e = 16 // size
    R = -(-N // P)

    def up(v):
        return -(-v // e) * e

    return (2 * up(H + R) + up(R * (L + 1) + e)) * size


@lru_cache(maxsize=None)
def modwt_plan(N: int, L: int, taps: int, dtype, B: int = 1) -> ModwtPlan:
    """The launch plan of ``B`` rows of ``N`` samples through ``L`` levels
    of a ``taps``-tap filter pair, a pure function of its arguments.

    P is the smallest power of two whose layout fits half a block's shared
    memory (two blocks per SM), else the smallest that fits one block; it
    then doubles while ``B * P`` blocks stay within the card's SMs, up to
    MAX_CLUSTER (WIDE_CLUSTER for up to WIDE_BATCH rows), while each block
    keeps MIN_SPAN samples or more.  A row that no cluster holds, or a
    filter of more than 32 taps, does not fit: it runs one K launch per
    level, on the CPU as on the card."""
    most = WIDE_CLUSTER if B <= WIDE_BATCH else MAX_CLUSTER
    plans = [plan for plan in (cluster_plan(P, N, L, taps, dtype)
                               for P in (1, 2, 4, 8, 16) if P <= most)
             if plan is not None]
    pick = [p for p in plans if p.smem <= SMEM_LIMIT // 2] or plans
    if not pick:
        return ModwtPlan(False, 0, 0, (taps - 1) * 2 ** (L - 1), 0, 0)
    plan = pick[0]
    sizes = {p.cluster: p for p in plans}
    while 2 * plan.cluster in sizes and B * 2 * plan.cluster <= SMS:
        plan = sizes[2 * plan.cluster]
    return plan


def modwt_inv_plan(N: int, L: int, taps: int, dtype, B: int = 1) -> ModwtPlan:
    """The launch plan of :func:`modwt_inv_levels` for ``B`` rows of ``N``
    samples through ``L`` levels: :func:`modwt_plan`'s, a pure function of
    its arguments.  The inverse's shared layout is the forward's byte for
    byte (csrc/modwt1d.cu, ModwtGeom): two scaling buffers of H + R
    samples (the block's v_j, then v_j's halo of level j's reach; the free
    buffer's tail holds w_j's halo) and a stage of R (L + 1) + E samples
    (the block's span of the input, in its (t, j) layout), so the same
    cluster fits the same rows."""
    return modwt_plan(N, L, taps, dtype, B)


def cluster_plan(P: int, N: int, L: int, taps: int,
                 dtype) -> ModwtPlan | None:
    """The plan with a cluster of ``P`` blocks per row, or None where the
    kernel cannot take it: more than 32 taps, blocks of fewer than
    MIN_SPAN samples (for P > 1), or more shared memory than a block has."""
    size = torch.empty((), dtype=dtype).element_size()
    H = (taps - 1) * 2 ** (L - 1)
    K = next((k for k in TAP_TEMPLATES if taps <= k), 0)
    R = -(-N // P)
    smem = _layout_bytes(N, L, P, H, size)
    if not K or (P > 1 and R < MIN_SPAN) or smem > SMEM_LIMIT:
        return None
    return ModwtPlan(True, P, R, H, K, smem)


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


def _levels_out(x, L, out):
    _check_rows(x, "x")
    B, N = x.shape
    check_levels(N, L)
    shape = (B, N, L + 1)
    if out is None:
        return torch.empty(shape, dtype=x.dtype, device=x.device)
    if not isinstance(out, torch.Tensor) or tuple(out.shape) != shape:
        raise ValueError(f"out must be a {shape} tensor")
    if out.dtype != x.dtype or out.device != x.device:
        raise ValueError(f"out is {out.dtype} on {out.device}, expected "
                         f"{x.dtype} on {x.device}")
    if out.stride(2) != 1 or out.stride(1) != L + 1:
        raise ValueError("out needs rows of L+1 contiguous samples")
    return out


def _plan_of(x, wt, L):
    B, N = x.shape
    return modwt_plan(N, L, len(modwt_filter_pair(wt)[0]), x.dtype, B)


def _inv_levels_in(xw, out):
    """``xw`` must be a ``(B, N, L+1)`` tensor (L >= 1) with rows of L+1
    contiguous samples, any batch stride; ``out`` a ``(B, N)`` tensor of
    its dtype and device with unit element stride (allocated when None)."""
    if not isinstance(xw, torch.Tensor) or xw.dim() != 3 or xw.shape[2] < 2:
        raise ValueError("xw must be a (B, N, L+1) tensor with L >= 1")
    B, N, L1 = xw.shape
    _check_rows(xw[..., 0], "xw")
    check_levels(N, L1 - 1)
    if not _inv_layout(xw):
        raise ValueError("xw needs rows of L+1 contiguous samples")
    if out is None:
        return torch.empty((B, N), dtype=xw.dtype, device=xw.device)
    _check_rows(out, "out", (B, N), xw.dtype, xw.device)
    if N > 1 and out.stride(1) != 1:
        raise ValueError("out needs a unit element stride")
    return out


def _inv_layout(xw):
    """Does ``xw (B, N, L+1)`` hold rows of L+1 contiguous samples?"""
    return xw.shape[1] == 1 or (xw.stride(2) == 1
                                and xw.stride(1) == xw.shape[2])


def _inv_plan_of(xw, wt):
    B, N, L1 = xw.shape
    return modwt_inv_plan(N, L1 - 1, len(modwt_filter_pair(wt)[0]),
                          xw.dtype, B)


# --- plain versions ----------------------------------------------------------

def _step(v, wt, j):
    """(v_j, w_j) of ``v`` in the arithmetic type."""
    g, h = modwt_filter_pair(wt)
    return modwt_step(v.to(acc_dtype(v.dtype)), j, h, g)


def modwt_fw_plain(v, wt, j: int, v1=None, w1=None):
    """Plain PyTorch version of :func:`modwt_fw` (``ops/modwt.modwt_step``
    in the arithmetic type)."""
    v1, w1 = _fw_outs(v, j, v1, w1)
    PLAIN_CALLS["modwt_fw"] += 1
    sv, sw = _step(v, wt, j)
    v1.copy_(sv)
    w1.copy_(sw)
    return v1, w1


def modwt_fw_levels_plain(x, wt, L: int, out=None):
    """Plain PyTorch version of :func:`modwt_fw_levels`: the chain of
    :func:`modwt_fw_plain` levels into the ``(B, N, L+1)`` layout, each
    scaling band rounded to the storage type between levels (without the
    plan's size limit)."""
    out = _levels_out(x, L, out)
    PLAIN_CALLS["modwt_fw_levels"] += 1
    v = x
    for j in range(1, L + 1):
        sv, sw = _step(v, wt, j)
        out[..., j - 1].copy_(sw)
        v = sv.to(x.dtype)
    out[..., L].copy_(v)
    return out


def modwt_inv_plain(v1, w1, wt, j: int, out=None):
    """Plain PyTorch version of :func:`modwt_inv`."""
    out = _inv_out(v1, w1, j, out)
    g, h = modwt_filter_pair(wt)
    PLAIN_CALLS["modwt_inv"] += 1
    a = acc_dtype(v1.dtype)
    out.copy_(imodwt_step(v1.to(a), w1.to(a), j, h, g))
    return out


def modwt_inv_levels_plain(xw, wt, out=None):
    """Plain PyTorch version of :func:`modwt_inv_levels`: the chain of
    :func:`modwt_inv_plain` levels from ``(B, N, L+1)``, each scaling band
    rounded to the storage type between levels (without the plan's size
    limit)."""
    out = _inv_levels_in(xw, out)
    PLAIN_CALLS["modwt_inv_levels"] += 1
    g, h = modwt_filter_pair(wt)
    a = acc_dtype(xw.dtype)
    L = xw.shape[2] - 1
    v = xw[..., L]
    for j in range(L, 0, -1):
        v = imodwt_step(v.to(a), xw[..., j - 1].to(a), j, h, g).to(xw.dtype)
    out.copy_(v)
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
    return t, t.stride(0), t.stride(1)


def _fw_plan(wt, j, v, v1, w1):
    """Kernel K's launch plan for this call's signature."""
    taps = _taps(wt, v.dtype, v.device)
    B, N = v.shape
    return build.Plan(_FW, (
        build.dtype_code(v.dtype), B, N, 2 ** (j - 1) % N, *_rows_args(v),
        *_rows_args(v1), *_rows_args(w1), taps.data_ptr(), taps.numel() // 2),
        keep=taps)


def _inv_plan(wt, j, v1, w1, out):
    """Kernel M's launch plan for this call's signature."""
    taps = _taps(wt, v1.dtype, v1.device)
    B, N = v1.shape
    return build.Plan(_INV, (
        build.dtype_code(v1.dtype), B, N, 2 ** (j - 1) % N, *_rows_args(v1),
        *_rows_args(w1), *_rows_args(out), taps.data_ptr(),
        taps.numel() // 2), keep=taps)


@lru_cache(maxsize=None)
def _plan_args(plan):
    """The plan as the C interface takes it: int32[4] and the bytes."""
    return ((ctypes.c_int * 4)(plan.cluster, plan.span, plan.halo,
                               plan.taps), plan.smem)


def _levels_plan(wt, L, x, out, plan=None):
    """The all-levels forward's launch plan for this call's signature."""
    taps = _taps(wt, x.dtype, x.device)
    B, N = x.shape
    plan = plan or _plan_of(x, wt, L)
    return build.Plan(_LEVELS, (
        build.dtype_code(x.dtype), B, N, L, *_rows_args(x), out,
        out.stride(0), taps.data_ptr(), taps.numel() // 2, *_plan_args(plan)),
        keep=taps)


def _inv_levels_plan(wt, xw, out, plan=None):
    """The all-levels inverse's launch plan for this call's signature."""
    taps = _taps(wt, xw.dtype, xw.device)
    B, N, L1 = xw.shape
    plan = plan or _inv_plan_of(xw, wt)
    return build.Plan(_INV_LEVELS, (
        build.dtype_code(xw.dtype), B, N, L1 - 1, xw, xw.stride(0), out,
        out.stride(0), taps.data_ptr(), taps.numel() // 2, *_plan_args(plan)),
        keep=taps)


def _levels_fits(wt, L, x, out):
    if not _plan_of(x, wt, L).fits:
        raise ValueError(f"modwt_fw_levels: rows of {x.shape[1]} {x.dtype} "
                         f"through {L} levels fit no cluster (modwt_plan)")


def _inv_levels_fits(wt, xw, out):
    if not _inv_plan_of(xw, wt).fits:
        raise ValueError(f"modwt_inv_levels: rows of {xw.shape[1]} "
                         f"{xw.dtype} through {xw.shape[2] - 1} levels fit "
                         "no cluster (modwt_inv_plan)")


_LEVELS = build.Site(
    "modwt_fw_levels", lambda wt, L, x, out: (L, x, _levels_out(x, L, out)),
    lambda L, x, out: (x, out),
    lambda wt, L, x, out: modwt_fw_levels_plain(x, wt, L, out), _levels_plan,
    result=2, writes=slice(1, None), fits=_levels_fits)
_INV_LEVELS = build.Site(
    "modwt_inv_levels", lambda wt, xw, out: (xw, _inv_levels_in(xw, out)),
    lambda xw, out: (xw, out),
    lambda wt, xw, out: modwt_inv_levels_plain(xw, wt, out),
    _inv_levels_plan, result=1, writes=slice(1, None),
    fits=_inv_levels_fits)
_FW = build.Site(
    "modwt_fw", lambda wt, j, v, v1, w1: (j, v, *_fw_outs(v, j, v1, w1)),
    lambda j, v, v1, w1: (v, v1, w1),
    lambda wt, j, v, v1, w1: modwt_fw_plain(v, wt, j, v1, w1), _fw_plan,
    result=slice(2, 4), writes=slice(1, None))
_INV = build.Site(
    "modwt_inv", lambda wt, j, v1, w1, out: (j, v1, w1,
                                             _inv_out(v1, w1, j, out)),
    lambda j, v1, w1, out: (v1, w1, out),
    lambda wt, j, v1, w1, out: modwt_inv_plain(v1, w1, wt, j, out),
    _inv_plan, result=3, writes=slice(-1, None))


def modwt_fw_levels(x, wt, L: int, out=None):
    """Levels 1..L of ``x (B, N)`` (any strides) in one launch -> ``out``
    ``(B, N, L+1)``, rows of L+1 contiguous samples (allocated when None),
    which may not overlap ``x``: detail j in column j-1, the scaling band
    in column L.  Raises for rows that :func:`modwt_plan` does not fit;
    :func:`modwt` runs those one level at a time.  Returns ``out``."""
    return build.run(_LEVELS, wt, (L, x, out))


def modwt_inv_levels(xw, wt, out=None):
    """All L levels of the inverse of ``xw (B, N, L+1)`` (rows of L+1
    contiguous samples, any batch stride) in one launch -> ``out (B, N)``
    (unit element stride; allocated when None), which may not overlap
    ``xw``.  Raises for rows that :func:`modwt_inv_plan` does not fit;
    :func:`imodwt` runs those one level at a time.  Returns ``out``."""
    return build.run(_INV_LEVELS, wt, (xw, out))


def modwt_fw(v, wt, j: int, v1=None, w1=None):
    """MODWT level ``j`` of ``v (B, N)``: the planes ``v1`` (scaling) and
    ``w1`` (detail), ``(B, N)`` views with any strides (allocated when both
    are None), which may not overlap ``v``.  Returns ``(v1, w1)``."""
    return build.run(_FW, wt, (j, v, v1, w1), j)


def modwt_inv(v1, w1, wt, j: int, out=None):
    """Inverse of :func:`modwt_fw`: ``(v1, w1)`` -> ``out (B, N)`` (any
    strides; allocated when None), which may not overlap them."""
    return build.run(_INV, wt, (j, v1, w1, out), j)


# --- the multi-level driver ----------------------------------------------------

def modwt(x, wt, L: int, *, plain: bool = False):
    """L-level MODWT of ``x (B, N)`` -> ``(B, N, L+1)``: detail j in column
    j-1, the scaling band in column L.  Rows that :func:`modwt_plan` fits
    take one :func:`modwt_fw_levels` launch; longer rows one K launch per
    level, the scaling bands taking turns in two scratch rows and each
    detail landing in its column.  ``plain=True`` runs the plain versions
    on any device."""
    with tracing.span("modwt1d.modwt", L):
        B, N = x.shape
        check_levels(N, L)
        out = torch.empty((B, N, L + 1), dtype=x.dtype, device=x.device)
        if _plan_of(x, wt, L).fits:
            levels = modwt_fw_levels_plain if plain else modwt_fw_levels
            return levels(x, wt, L, out)
        fw = modwt_fw_plain if plain else modwt_fw
        scratch = Scratch(x, (B * N, B * N))
        v = x
        for j in range(1, L + 1):
            v1 = out[..., L] if j == L else scratch.view((j - 1) % 2, B, N)
            fw(v, wt, j, v1, out[..., j - 1])
            v = v1
        return out


def imodwt(xw, wt, *, plain: bool = False):
    """Inverse of :func:`modwt`: ``xw (B, N, L+1)`` -> ``(B, N)``.  Rows of
    L+1 contiguous samples that :func:`modwt_inv_plan` fits (with 2^L <=
    N) take one :func:`modwt_inv_levels` launch; others one M launch per
    level, reading each column in place, the scaling bands taking turns
    in two scratch rows.  ``plain=True`` runs the plain versions on any
    device."""
    with tracing.span("modwt1d.imodwt", xw.shape[-1] - 1):
        B, N, L1 = xw.shape
        L = L1 - 1
        out = torch.empty((B, N), dtype=xw.dtype, device=xw.device)
        if L == 0:
            return out.copy_(xw[..., 0])
        if 2 ** L <= N and _inv_layout(xw) and _inv_plan_of(xw, wt).fits:
            levels = modwt_inv_levels_plain if plain else modwt_inv_levels
            return levels(xw, wt, out)
        inv = modwt_inv_plain if plain else modwt_inv
        scratch = Scratch(xw, (B * N, B * N))
        v = xw[..., L]
        for j in range(L, 0, -1):
            dest = out if j == 1 else scratch.view(j % 2, B, N)
            v = inv(v, xw[..., j - 1], wt, j, out=dest)
        return out
