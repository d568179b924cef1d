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

Halo mode: given ``above=``/``below=`` (``axis0_fw``) or ``halos=``
(``axis0_inv``), the rows that the level reads beyond the view come from
those ``(B, H, C)`` views instead of a periodic wrap: row ``r < 0`` from
``above[H + r]``, row ``r >= R`` from ``below[r - R]``.  The sharded drivers
(parallel/sharded.py) run each shard's level so, with the neighbours' edge
rows.  :func:`halo_reach` gives the rows each side needs, from the bands
(not the TPU kernels' sublane-rounded halo); a shorter halo raises.

Both are driven by the wavelet's bands (ops/bands.py), as kernels A-H are;
the plain versions are the 1-D passes of ops/level2d.py along dim -2 (in
halo mode over ``[above; x; below]``, without a wrap).  They replace the
TPU kernels of ``wavelets_tpu/ops/pallas/axis0.py``, the halo mode its
``_ext`` variants (see csrc/axis0.cu).  Both run on persistent blocks
that stage work items (32 output pairs of a strip of columns of one or
several batch items) with 16-byte copies, the next item's while this
one's taps run, each staged row's source (wrap, halo, corner) picked
while staging, with the bands in registers as windows of 8 or 16 offsets
(:func:`fw_window`, :func:`inv_window`); a span of 16 or more takes the
first form, one block per tile, as does a forward level of fewer than
``FW_A0_MIN_PAIRS`` output pairs.  :func:`fw_plan`, :func:`fw_smem`,
:func:`inv_plan` and :func:`inv_smem` mirror their launches.
A tensor on the CPU takes the plain PyTorch version
(``axis0_fw_plain``, ``axis0_inv_plain``); a CUDA tensor launches the
kernel or raises.  Arithmetic runs in float32 for float32 and bfloat16
storage (bfloat16 outputs are rounded once) and in float64 for float64.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch

from . import build
from .bands import acc_dtype, band_reach, band_table, level_bands, \
    syn_reach, synthesis_bands
from .level2d import _analysis, _check_input, _check_plane, _synthesis

__all__ = ["LAUNCHES", "PLAIN_CALLS", "axis0_fw", "axis0_fw_plain",
           "axis0_inv", "axis0_inv_plain", "halo_reach", "fw_window",
           "fw_smem", "fw_plan", "inv_window", "inv_smem", "inv_plan",
           "FW_A0_MIN_PAIRS"]

# the halo mode counts apart from the periodic one
LAUNCHES = build.counter("axis0_fw", "axis0_inv", "axis0_fw_halo",
                         "axis0_inv_halo")
PLAIN_CALLS = {"axis0_fw": 0, "axis0_inv": 0, "axis0_fw_halo": 0,
               "axis0_inv_halo": 0}

# kernels I and J (csrc/axis0.cu): the tiled forms' window bounds, output
# pairs of a work item and column groups of a strip; the first forms'
# output pairs and lanes per block
FW_WINDOWS = INV_WINDOWS = (8, 16)
_JT_TR, _JT_MIN_TR, _JT_GROUPS, _JT_SPREAD = 32, 8, 32, 512
_A0_TR, _A0_LANES = 32, 32
# kernel I takes its first form for a level of fewer output pairs (B R/2 C)
# than this: below it the size sweep of chip_smoke.py (i_form_times)
# found the first form as fast or faster (levels of a few microseconds,
# where the tiled form's fixed costs show), above it the tiled form faster
FW_A0_MIN_PAIRS = 1 << 20


@lru_cache(maxsize=None)
def halo_reach(wt, inverse: bool) -> tuple[int, int]:
    """(rows above, rows below) that one level reads beyond the view: the
    analysis bands reach ``2k + delta`` (k < R/2), the synthesis bands
    ``k + delta`` (k < Rh)."""
    if inverse:
        left, right = syn_reach(wt)
        return max(0, left), max(0, right)
    left, right = band_reach(wt)
    return max(0, left), max(0, right - 1)


def _check_halos(halos, ref, reach, inverse):
    """None without halos; else the halo views, checked: each ``(B, H, C)``
    like ``ref``, above at least ``reach[0]`` rows tall and below
    ``reach[1]`` (for the inverse the two above-halos of equal height)."""
    if all(h is None for h in halos):
        return None
    if any(h is None for h in halos):
        raise ValueError("give every halo view, or none")
    B, _, C = ref.shape
    names = (("a_above", "a_below", "d_above", "d_below") if inverse
             else ("above", "below"))
    for k, (name, h) in enumerate(zip(names, halos)):
        if not isinstance(h, torch.Tensor) or h.dim() != 3:
            raise ValueError(f"{name} must be a (B, H, C) tensor")
        _check_plane(h, name, (B, h.shape[1], C), ref.dtype, ref.device)
        need = reach[k % 2]
        if h.shape[1] < need:
            raise ValueError(f"{name} has {h.shape[1]} rows, shorter than "
                             f"the bands' reach of {need}")
    if inverse and halos[0].shape[1] != halos[2].shape[1]:
        raise ValueError("a_above and d_above need the same height")
    return tuple(halos)


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

def axis0_fw_plain(x, wt, a=None, d=None, *, above=None, below=None):
    """Plain PyTorch version of :func:`axis0_fw` (same outputs, same
    layout), computed with index_select gathers in the arithmetic type."""
    _check_input(x)
    a, d = _fw_outs(x, a, d)
    halos = _check_halos((above, below), x, halo_reach(wt, False), False)
    acc = acc_dtype(x.dtype)
    if halos is None:
        PLAIN_CALLS["axis0_fw"] += 1
        sa, sd = _analysis(x.to(acc), wt, -2)
    else:
        PLAIN_CALLS["axis0_fw_halo"] += 1
        ext = torch.cat([above, x, below], dim=1).to(acc)
        sa, sd = _analysis(ext, wt, -2, (above.shape[1], x.shape[1]))
    a.copy_(sa)
    d.copy_(sd)
    return a, d


def axis0_inv_plain(a, d, wt, out=None, corner=None, *, halos=None):
    """Plain PyTorch version of :func:`axis0_inv`."""
    out = _inv_args(a, d, out, corner)
    halos = _inv_halos(a, wt, corner, halos)
    acc = acc_dtype(a.dtype)
    if halos is not None:
        PLAIN_CALLS["axis0_inv_halo"] += 1
        a_above, a_below, d_above, d_below = halos
        s = torch.cat([a_above, a, a_below], dim=1).to(acc)
        dd = torch.cat([d_above, d, d_below], dim=1).to(acc)
        out.copy_(_synthesis(s, dd, wt, -2, (a_above.shape[1], a.shape[1])))
        return out
    PLAIN_CALLS["axis0_inv"] += 1
    s = a.to(acc, copy=True)
    if corner is not None:
        Bc, _, Cc = corner.shape
        s[:Bc, :, :Cc] = corner
    out.copy_(_synthesis(s, d.to(acc), wt, -2))
    return out


def _inv_halos(a, wt, corner, halos):
    if halos is None:
        return None
    if corner is not None:
        raise ValueError("axis0_inv takes a corner or halos, not both")
    if len(halos) != 4:
        raise ValueError("halos must be (a_above, a_below, d_above, d_below)")
    return _check_halos(halos, a, halo_reach(wt, True), True)


# --- kernel I's and J's forms (mirrors of csrc/axis0.cu) --------------------

def _syn_table(wt):
    offs = [int(o) for d, _ in synthesis_bands(wt) for o in d]
    return min(offs), max(offs) - min(offs), len(offs)


def _ana_table(wt):
    ds, _, dd, _ = level_bands(wt)
    offs = [int(o) for o in ds] + [int(o) for o in dd]
    return min(offs), max(offs) - min(offs), len(offs)


def fw_window(wt) -> int:
    """The window bound of kernel I's tiled form for ``wt``'s analysis
    bands: the smallest of FW_WINDOWS above their span (both bands'
    offsets fit it), or 0 where the span is 16 or more and the first form
    runs.  csrc/axis0.cu (axis0_fw) makes the same choice, for the
    periodic and the halo mode alike, as kernel E does for the same
    bands."""
    span = _ana_table(wt)[1]
    return next((w for w in FW_WINDOWS if span < w), 0)


def fw_smem(wt, dtype, tiled=True) -> int:
    """Shared bytes of one block of kernel I in the form :func:`fw_window`
    picks (the first form where ``tiled`` is false, as for a level below
    ``FW_A0_MIN_PAIRS``); mirrors csrc/axis0.cu: the tiled form's two
    stages, each the 2 JT_TR - 1 + span rows of x of a full item's window,
    a strip (JT_GROUPS V columns) wide, whatever the shape
    (fw_tiled_smem), or the first form's window of 2 A0_TR + span rows of
    A0_LANES lanes in the arithmetic type; and the band table."""
    _, span, taps = _ana_table(wt)
    acc = acc_dtype(dtype).itemsize
    table = taps * (acc + 4)
    if not (tiled and fw_window(wt)):
        return (2 * _A0_TR + span) * _A0_LANES * acc + table
    size = torch.empty((), dtype=dtype).element_size()
    strip = _JT_GROUPS * (16 // acc)
    return 2 * (2 * _JT_TR - 1 + span) * strip * size + table


def inv_window(wt) -> int:
    """The window bound of kernel J's tiled form for ``wt``'s synthesis
    bands: the smallest of INV_WINDOWS above their span, or 0 where the
    span is 16 or more and the first form runs.  csrc/axis0.cu (axis0_inv)
    makes the same choice, for the periodic and the halo mode alike."""
    span = _syn_table(wt)[1]
    return next((w for w in INV_WINDOWS if span < w), 0)


def inv_smem(wt, dtype) -> int:
    """Shared bytes of one block of kernel J in the form
    :func:`inv_window` picks; mirrors csrc/axis0.cu: the tiled form's two
    stages, each the a and d rows of a full item's window (JT_TR + span
    rows of a strip, JT_GROUPS V columns, whatever the shape), or the
    first form's two windows of A0_TR + span rows of A0_LANES lanes in the
    arithmetic type; and the band table."""
    _, span, taps = _syn_table(wt)
    acc = acc_dtype(dtype).itemsize
    table = taps * (acc + 4)
    if not inv_window(wt):
        return 2 * (_A0_TR + span) * _A0_LANES * acc + table
    size = torch.empty((), dtype=dtype).element_size()
    strip = _JT_GROUPS * (16 // acc)
    return 2 * 2 * (_JT_TR + span) * strip * size + table


class InvPlan(NamedTuple):
    """Kernel J's launch as csrc/axis0.cu (axis0_inv_tiled) plans it: the
    window (0: the first form, no other field set), the staging path
    (16 or 4 bytes), and the tiled form's geometry (InvA0Geom)."""
    window: int
    staging: int = 0
    tr: int = 0         # output pairs of a work item
    cw: int = 0         # columns of a strip
    ctiles: int = 0
    rtiles: int = 0
    items: int = 0
    bsh: int = 0        # log2 batch items of a work item
    gsh: int = 0        # log2 column groups of a batch item's row
    ps: int = 0         # staged elements of one row of one batch item
    lsh: int = 0        # log2 threads per staged row
    smem: int = 0


class FwPlan(NamedTuple):
    """Kernel I's launch as csrc/axis0.cu (axis0_fw) plans it: the window
    (0: the first form, no other field set), the staging path (16 or 4
    bytes), whether each output plane takes word stores of V columns
    (``wide_a``, ``wide_d``), and the tiled form's work items (FwA0Geom,
    as in :class:`InvPlan`)."""
    window: int
    staging: int = 0
    wide_a: bool = False
    wide_d: bool = False
    tr: int = 0
    cw: int = 0
    ctiles: int = 0
    rtiles: int = 0
    items: int = 0
    bsh: int = 0
    gsh: int = 0
    ps: int = 0
    lsh: int = 0
    smem: int = 0


def _ceil_log2(v):
    return (v - 1).bit_length()


def _words16(t, e):
    return (t.data_ptr() % 16 == 0 and t.stride(0) % e == 0
            and t.stride(1) % e == 0)


def _words_out(t):
    """An output plane that takes a word store of V columns (csrc/axis0.cu
    words_out): base and batch and row strides whole words of V
    elements."""
    v = 16 // acc_dtype(t.dtype).itemsize
    return (t.data_ptr() % (v * t.element_size()) == 0
            and t.stride(0) % v == 0 and t.stride(1) % v == 0)


def _items(B, pairs, C, dtype, vec):
    """The work items of a tiled form (csrc/axis0.cu a0_items): (tr, cw,
    ctiles, rtiles, items, bsh, gsh, ps, lsh)."""
    e = 16 // torch.empty((), dtype=dtype).element_size()
    v = 16 // acc_dtype(dtype).itemsize
    strip = _JT_GROUPS * v
    cw = min(C, strip)
    ps = -(-cw // e) * e
    gsh = _ceil_log2(-(-cw // v))
    bsh = 0
    while ((2 << bsh) <= (_JT_GROUPS >> gsh) and (2 << bsh) * ps <= strip
           and (1 << bsh) < B):
        bsh += 1
    ctiles = -(-C // cw)

    def count(tr, bsh):
        return ctiles * -(-pairs // tr) * -(-B // (1 << bsh))

    tr = _JT_TR        # a small level: fewer batch items, then fewer pairs
    while count(tr, bsh) < _JT_SPREAD and (bsh > 0 or tr > _JT_MIN_TR):
        if bsh > 0:
            bsh -= 1
        else:
            tr //= 2
    return (tr, cw, ctiles, -(-pairs // tr), count(tr, bsh), bsh, gsh, ps,
            min(_ceil_log2(ps // e if vec else ps), 8))


def inv_plan(a, d, wt, corner=None, halos=None) -> InvPlan:
    """How kernel J runs the level of the planes ``a`` and ``d`` ``(B, Rh,
    C)`` (with a corner or halos, as :func:`axis0_inv` takes them): a pure
    function of their shapes, strides and data pointers, mirroring
    csrc/axis0.cu.  The 16-byte staging path needs C and every view it
    reads in whole 16-byte words (base, batch and row stride)."""
    window = inv_window(wt)
    if not window:
        return InvPlan(0, smem=inv_smem(wt, a.dtype))
    B, Rh, C = a.shape
    e = 16 // a.element_size()
    views = [a, d] + ([corner] if corner is not None and corner.numel()
                      else []) + list(halos or ())
    vec = C % e == 0 and all(_words16(t, e) for t in views)
    return InvPlan(window, 16 if vec else 4,
                   *_items(B, Rh, C, a.dtype, vec), inv_smem(wt, a.dtype))


def fw_plan(x, a, d, wt, halos=None, min_pairs=None) -> FwPlan:
    """How kernel I runs the level of ``x (B, R, C)`` into the planes ``a``
    and ``d`` (with halos ``(above, below)``, as :func:`axis0_fw` takes
    them): a pure function of their shapes, strides and data pointers,
    mirroring csrc/axis0.cu.  A level of fewer than ``min_pairs`` output
    pairs (default ``FW_A0_MIN_PAIRS``) takes the first form.  The 16-byte
    staging path needs C and every view it reads (x, the halos) in whole
    16-byte words (base, batch and row stride)."""
    if min_pairs is None:
        min_pairs = FW_A0_MIN_PAIRS
    window = fw_window(wt)
    B, R, C = x.shape
    if not window or B * (R // 2) * C < min_pairs:
        return FwPlan(0, smem=fw_smem(wt, x.dtype, tiled=False))
    e = 16 // x.element_size()
    vec = C % e == 0 and all(_words16(t, e) for t in [x, *(halos or ())])
    return FwPlan(window, 16 if vec else 4, _words_out(a), _words_out(d),
                  *_items(B, R // 2, C, x.dtype, vec), fw_smem(wt, x.dtype))


# --- kernels -----------------------------------------------------------------

def _halo_args(halos):
    """The C interface's halo arrays: the views (their pointers), their
    batch and row strides, and their height."""
    n = len(halos)
    return (tuple(halos), (ctypes.c_int64 * n)(*[h.stride(0) for h in halos]),
            (ctypes.c_int64 * n)(*[h.stride(1) for h in halos]),
            halos[0].shape[1])


def _fw_plan(wt, x, a, d, above, below, min_pairs=None):
    """Kernel I's launch plan for this call's signature; a level of fewer
    than ``min_pairs`` output pairs (default ``FW_A0_MIN_PAIRS``) takes
    the first form, so 0 forces the tiled form where the span allows it,
    and a bound above the level the first form."""
    if min_pairs is None:
        min_pairs = FW_A0_MIN_PAIRS
    table = band_table(wt, False, x.dtype, x.device)
    B, R, C = x.shape
    halos = () if above is None else _halo_args((above, below))
    return build.Plan(_FW_HALO if halos else _FW, (
        build.dtype_code(x.dtype), B, R, C, x, x.stride(0), x.stride(1), a,
        a.stride(0), a.stride(1), d, d.stride(0), d.stride(1), *halos,
        table.offs.data_ptr(), table.coefs.data_ptr(), *table.counts,
        table.dmin, table.span, min_pairs), keep=table)


def _inv_plan(wt, a, d, out, corner, halos):
    """Kernel J's launch plan for this call's signature: with a corner
    view (or None), or with halos."""
    table = band_table(wt, True, a.dtype, a.device)
    B, Rh, C = a.shape
    if halos is not None:
        site, middle = _INV_HALO, _halo_args(halos)
    elif corner is None:
        site, middle = _INV, (None, 0, 0, 0, 0)
    else:
        site, middle = _INV, (corner, corner.stride(0), corner.stride(1),
                              corner.shape[0], corner.shape[2])
    return build.Plan(site, (
        build.dtype_code(a.dtype), B, Rh, C, a, a.stride(0), a.stride(1), d,
        d.stride(0), d.stride(1), *middle, out, out.stride(0), out.stride(1),
        table.offs.data_ptr(), table.coefs.data_ptr(),
        (ctypes.c_int * 4)(*table.counts), table.dmin, table.span),
        keep=table)


def _fw_check(wt, x, a, d, above, below):
    _check_input(x)
    a, d = _fw_outs(x, a, d)
    _check_halos((above, below), x, halo_reach(wt, False), False)
    return x, a, d, above, below


def _fw_plain(wt, x, a, d, above, below):
    return axis0_fw_plain(x, wt, a, d, above=above, below=below)


def _fw_alloc(wt, x, a, d, above, below):
    return (x, *_fw_outs(x, None, None), above, below)


def _inv_check(wt, a, d, out, corner, halos):
    out = _inv_args(a, d, out, corner)
    return a, d, out, corner, _inv_halos(a, wt, corner, halos)


def _inv_plain(wt, a, d, out, corner, halos):
    return axis0_inv_plain(a, d, wt, out, corner, halos=halos)


def _inv_alloc(wt, a, d, out, corner, halos):
    return a, d, _inv_args(a, d, None, corner), corner, halos


def _inv_tensors(a, d, out, corner, halos):
    return (a, d, out) if corner is None else (a, d, corner, out)


_FW = build.Site(
    "axis0_fw", _fw_check, lambda x, a, d, above, below: (x, a, d),
    _fw_plain, _fw_plan, result=slice(1, 3), writes=slice(1, 3),
    outs=_fw_alloc)
_FW_HALO = build.Site(
    "axis0_fw_halo", _fw_check,
    lambda x, a, d, above, below: (x, a, d, above, below), _fw_plain,
    _fw_plan, result=slice(1, 3), writes=slice(1, 3), outs=_fw_alloc)
_INV = build.Site(
    "axis0_inv", _inv_check, _inv_tensors, _inv_plain, _inv_plan, result=2,
    writes=slice(-1, None), outs=_inv_alloc)
_INV_HALO = build.Site(
    "axis0_inv_halo", _inv_check,
    lambda a, d, out, corner, halos: (a, d, *halos, out), _inv_plain,
    _inv_plan, result=2, writes=slice(-1, None), outs=_inv_alloc)


def axis0_fw(x, wt, a=None, d=None, *, above=None, below=None):
    """Forward level along the middle axis of ``x (B, R, C)`` into the
    planes ``a`` and ``d`` (``(B, R/2, C)``, unit column stride, any other
    strides; allocated when both are None).  With ``above`` and ``below``
    (``(B, H, C)`` views covering :func:`halo_reach`) the level reads the
    rows beyond ``x`` from them instead of wrapping.  The outputs may not
    overlap the inputs.  Returns ``(a, d)``."""
    site = _FW if above is None and below is None else _FW_HALO
    return build.run(site, wt, (x, a, d, above, below))


def axis0_inv(a, d, wt, out=None, corner=None, *, halos=None):
    """Inverse level along the middle axis: the planes ``a`` and ``d``
    ``(B, Rh, C)`` -> ``out (B, 2Rh, C)`` (allocated when None).  Where
    ``corner (Bc, Rh, Cc)`` is given, ``a[:Bc, :, :Cc]`` is read from it
    instead.  With ``halos = (a_above, a_below, d_above, d_below)``
    (``(B, H, C)`` views covering :func:`halo_reach`, no corner) the rows
    beyond the planes come from them instead of wrapping.  Every view has
    unit column stride; ``out`` may not overlap the inputs.  Returns
    ``out``."""
    site = _INV if halos is None else _INV_HALO
    return build.run(site, wt, (a, d, out, corner, halos))
