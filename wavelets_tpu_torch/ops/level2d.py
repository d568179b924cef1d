"""One level of the periodic 2-D DWT: CUDA kernels and their plain versions.

``level_fw`` takes ``x (B, m, n)`` to the four quadrants LL, LH, HL, HH
(each ``(B, m/2, n/2)``); LH is axis-0 scaling by axis-1 detail and HL the
reverse.  The outputs are any four planes with unit column stride, so
quads mode passes four arrays and packed mode passes views into the
full-size packed array (ops/pyramid2d.py).  ``level_inv`` is its inverse:
it reads the four quadrant planes, again in place from the packed array if
the caller wishes, and writes the merged ``(B, 2mh, 2nh)`` array.

Both are driven by the wavelet's bands (ops/bands.py), so one kernel serves
filter and lifting wavelets.  They replace the TPU kernels of
``wavelets_tpu/ops/pallas/mxu2d.py`` (see csrc/level2d.cu).  Both run on
persistent blocks that stage each tile (the input's, or the four
quadrants') into shared memory with 16-byte copies, the next tile's while
this one's taps run, and keep the bands in registers as windows of 8 or 16
offsets (:func:`fw_window`, :func:`inv_window`); a span of 16 or more takes
the first form, one block per tile with wrapped taps.  A tensor on
the CPU takes the plain PyTorch version (``level_fw_plain``,
``level_inv_plain``); a CUDA tensor launches the kernel or raises.
Arithmetic runs in float32 for float32 and bfloat16 storage (bfloat16
outputs are rounded once) and in float64 for float64.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .bands import acc_dtype, band_table, level_bands, synthesis_bands

__all__ = ["DTYPES", "LAUNCHES", "PLAIN_CALLS", "level_fw", "level_fw_plain",
           "level_inv", "level_inv_plain", "quads_fw", "merge_inv",
           "detail_planes"]

DTYPES = (torch.float32, torch.float64, torch.bfloat16)
# kernel launches and plain-version calls, per entry point
LAUNCHES = build.counter("level_fw", "level_inv")
PLAIN_CALLS = {"level_fw": 0, "level_inv": 0}

# tile of csrc/level2d.cu: TR x TC quads per block
_TR, _TC = 32, 32
SMEM_LIMIT = 232448   # bytes of shared memory a block may use on the H100
INV_WINDOWS = (8, 16)   # the tiled inverse's window bounds (csrc/level2d.cu)
FW_WINDOWS = (8, 16)    # the tiled forward's window bounds
_FW_PAD = 64            # staged elements past a stage's last row (FW_PAD)


def _check_plane(t, name, shape, dtype, device):
    if not isinstance(t, torch.Tensor) or t.dim() != 3:
        raise ValueError(f"{name} must be a (B, rows, cols) tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"{name} is {t.dtype} on {t.device}, expected "
                         f"{dtype} on {device}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs unit column stride")


def _check_input(x, name="x"):
    if not isinstance(x, torch.Tensor) or x.dim() != 3:
        raise ValueError(f"{name} must be a (B, m, n) tensor")
    if x.dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not in {DTYPES}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name} needs unit column stride")


def detail_planes(y, l):
    """Views of level l's (LH, HL, HH) in the packed array ``y (B, M, N)``."""
    _, M, N = y.shape
    mh, nh = M >> l, N >> l
    return (y[:, :mh, nh:2 * nh], y[:, mh:2 * mh, :nh],
            y[:, mh:2 * mh, nh:2 * nh])


def _planes_args(planes):
    """The C interface's plane arrays: the planes (their pointers) and
    their batch and row strides."""
    k = len(planes)
    return (tuple(planes),
            (ctypes.c_int64 * k)(*[p.stride(0) for p in planes]),
            (ctypes.c_int64 * k)(*[p.stride(1) for p in planes]))


# --- plain versions ----------------------------------------------------------

def _analysis(v, wt, dim, ext=None, fused=False):
    """(a, d) of one periodic level of ``v`` along ``dim``, from the bands.
    With ``ext = (lead, n)``, ``v`` holds ``lead`` halo rows, then the n
    rows to transform, then halo rows below them: the level reads row
    ``lead + 2k + delta`` of ``v`` and never wraps.

    ``fused`` (``v`` in float32) sums as the kernels do: one fma per tap,
    taps in table order, the coefficient first rounded to float32 as the
    band table holds it.  The fma is emulated in float64, where the
    product of two float32 values is exact; the float64 sum rounded to
    float32 equals the fma except at a double rounding: an inexact
    float64 sum that lands exactly halfway between two float32 values."""
    n, lead, wrap = v.shape[dim], 0, True
    if ext is not None:
        (lead, n), wrap = ext, False
    k2 = 2 * torch.arange(n // 2, device=v.device) + lead
    ds, cs, dd, cd = level_bands(wt)

    def corr(deltas, coefs):
        acc = None
        for dl, c in zip(deltas, coefs):
            idx = k2 + int(dl)
            x = v.index_select(dim, idx % n if wrap else idx)
            if fused:
                t = float(torch.tensor(c, dtype=torch.float32)) * x.double()
                acc = (t if acc is None else t + acc.double()).to(v.dtype)
            else:
                t = float(c) * x
                acc = t if acc is None else acc + t
        return acc

    return corr(ds, cs), corr(dd, cd)


def _synthesis(s, d, wt, dim, ext=None):
    """Inverse of _analysis: (s, d) of half length -> the merged signal.
    With ``ext = (lead, half)`` the planes hold ``lead`` halo rows above and
    some below the ``half`` rows, which are read without a wrap."""
    dim = dim % s.dim()
    half, lead, wrap = s.shape[dim], 0, True
    if ext is not None:
        (lead, half), wrap = ext, False
    k = torch.arange(half, device=s.device) + lead
    bands = synthesis_bands(wt)
    parts = []
    for p in (0, 1):
        acc = None
        for src, (deltas, coefs) in ((s, bands[2 * p]), (d, bands[2 * p + 1])):
            for dl, c in zip(deltas, coefs):
                idx = k + int(dl)
                t = float(c) * src.index_select(dim, idx % half if wrap
                                                else idx)
                acc = t if acc is None else acc + t
        parts.append(acc)
    return torch.stack(parts, dim=dim + 1).flatten(dim, dim + 1)


def quads_fw(v, wt, fused=False):
    """(LL, LH, HL, HH) of one level of ``v (..., m, n)``, in v's dtype:
    the row pass, then the column pass on its two bands (not rounded in
    between), each summed as ``_analysis`` sums with ``fused``."""
    a, d = _analysis(v, wt, -1, fused=fused)
    ll, hl = _analysis(a, wt, -2, fused=fused)
    lh, hh = _analysis(d, wt, -2, fused=fused)
    return ll, lh, hl, hh


def merge_inv(ll, lh, hl, hh, wt):
    """Inverse of quads_fw, in the quadrants' dtype."""
    return _synthesis(_synthesis(ll, lh, wt, -1), _synthesis(hl, hh, wt, -1),
                      wt, -2)


def _fw_outs(x, outs):
    B, m, n = x.shape
    if m % 2 or n % 2:
        raise ValueError(f"level_fw needs even sizes, got {(m, n)}")
    shape = (B, m // 2, n // 2)
    if outs is None:
        return tuple(torch.empty(shape, dtype=x.dtype, device=x.device)
                     for _ in range(4))
    if len(outs) != 4:
        raise ValueError("outs must be the four planes (LL, LH, HL, HH)")
    for name, o in zip(("LL", "LH", "HL", "HH"), outs):
        _check_plane(o, name, shape, x.dtype, x.device)
    return tuple(outs)


def level_fw_plain(x, wt, outs=None):
    """Plain PyTorch version of :func:`level_fw` (same outputs, same
    layout), computed with index_select gathers in the arithmetic type.
    In bfloat16 it sums as kernel A does (``quads_fw(..., fused=True)``),
    so that an output rounds to bfloat16 from A's float32 sum; float32
    and float64 sum each tap's product (within their tolerances of A's
    sums, and cheaper on the CPU)."""
    _check_input(x)
    outs = _fw_outs(x, outs)
    PLAIN_CALLS["level_fw"] += 1
    for o, v in zip(outs, quads_fw(x.to(acc_dtype(x.dtype)), wt,
                                   fused=x.dtype == torch.bfloat16)):
        o.copy_(v)
    return outs


def _inv_args(quads, out):
    names = ("LL", "LH", "HL", "HH")
    if len(quads) != 4:
        raise ValueError("level_inv takes the four planes (LL, LH, HL, HH)")
    _check_input(quads[0], "LL")
    ll = quads[0]
    B, mh, nh = ll.shape
    for name, q in zip(names, quads):
        _check_plane(q, name, (B, mh, nh), ll.dtype, ll.device)
    shape = (B, 2 * mh, 2 * nh)
    if out is None:
        return torch.empty(shape, dtype=ll.dtype, device=ll.device)
    _check_plane(out, "out", shape, ll.dtype, ll.device)
    return out


def level_inv_plain(ll, lh, hl, hh, wt, out=None):
    """Plain PyTorch version of :func:`level_inv`."""
    quads = (ll, lh, hl, hh)
    out = _inv_args(quads, out)
    PLAIN_CALLS["level_inv"] += 1
    a = acc_dtype(ll.dtype)
    out.copy_(merge_inv(*(q.to(a) for q in quads), wt))
    return out


# --- kernels -----------------------------------------------------------------

def _smem(table, rows_ext, cols):
    return 2 * rows_ext * cols * table.coefs.element_size() + table.nbytes


def _syn_span(wt) -> int:
    offs = [int(o) for d, _ in synthesis_bands(wt) for o in d]
    return max(offs) - min(offs)


def inv_window(wt) -> int:
    """The window bound of the tiled inverse for ``wt``'s synthesis bands:
    the smallest of INV_WINDOWS above their span (the offsets of each
    source fit it), or 0 where the span is 16 or more and the first form
    runs.  csrc/level2d.cu (level_inv) makes the same choice."""
    span = _syn_span(wt)
    return next((w for w in INV_WINDOWS if span < w), 0)


def inv_smem(wt, dtype) -> int:
    """Shared bytes of one block of the inverse, in the form
    :func:`inv_window` picks; mirrors inv_tiled_smem in csrc/level2d.cu
    (on the 16-byte path, the widest staged row)."""
    span, taps = _syn_span(wt), sum(len(d) for d, _ in synthesis_bands(wt))
    acc = acc_dtype(dtype).itemsize
    table = taps * (acc + 4)
    rows = _TR + span
    if not inv_window(wt):
        return 2 * rows * 2 * _TC * acc + table
    size = torch.empty((), dtype=dtype).element_size()
    e = 16 // size
    ps = -(-(e - 1 + _TC + span) // e) * e
    return 2 * rows * 2 * _TC * acc + 2 * 4 * rows * ps * size + table


def _ana_reach(wt):
    """(smallest offset, span) of ``wt``'s analysis bands."""
    ds, _, dd, _ = level_bands(wt)
    offs = [int(o) for o in ds] + [int(o) for o in dd]
    return min(offs), max(offs) - min(offs)


def fw_window(wt) -> int:
    """The window bound of the tiled forward for ``wt``'s analysis bands:
    the smallest of FW_WINDOWS above their span (both bands' offsets fit
    it), or 0 where the span is 16 or more and the first form runs.
    csrc/level2d.cu (level_fw) makes the same choice."""
    span = _ana_reach(wt)[1]
    return next((w for w in FW_WINDOWS if span < w), 0)


def fw_smem(wt, dtype) -> int:
    """Shared bytes of one block of the forward, in the form
    :func:`fw_window` picks; mirrors fw_tiled_smem in csrc/level2d.cu (on
    the 16-byte path, whose staged row is the wider)."""
    dmin, span = _ana_reach(wt)
    ds, _, dd, _ = level_bands(wt)
    acc = acc_dtype(dtype).itemsize
    table = (len(ds) + len(dd)) * (acc + 4)
    if not fw_window(wt):
        return 2 * (2 * _TR + span) * _TC * acc + table
    size = torch.empty((), dtype=dtype).element_size()
    e, v = 16 // size, 16 // acc
    rows = 2 * (16 if acc == 8 else 32) - 1 + span
    ps = -(-(dmin % e + 2 * _TC - 1 + span) // e) * e
    if 2 * v * size == 32 and ps * size % 32 == 0:
        ps += e
    return 2 * rows * _TC * acc + 2 * (rows * ps + _FW_PAD) * size + table


def _fw_plan(wt, x, outs):
    """Kernel A's launch plan for this call's signature."""
    table = band_table(wt, False, x.dtype, x.device)
    if fw_smem(wt, x.dtype) > SMEM_LIMIT:
        raise ValueError(f"level_fw: the bands of {wt.name} reach too far "
                         "for the kernel's shared-memory tile")
    B, m, n = x.shape
    return build.Plan(_FW, (
        build.dtype_code(x.dtype), B, m, n, x, x.stride(0), x.stride(1),
        *_planes_args(outs), table.offs.data_ptr(), table.coefs.data_ptr(),
        *table.counts, table.dmin, table.span), keep=table)


def _inv_plan(wt, quads, out):
    """Kernel B's launch plan for this call's signature."""
    ll = quads[0]
    table = band_table(wt, True, ll.dtype, ll.device)
    if inv_smem(wt, ll.dtype) > SMEM_LIMIT:
        raise ValueError(f"level_inv: the bands of {wt.name} reach too far "
                         "for the kernel's shared-memory tile")
    B, mh, nh = ll.shape
    return build.Plan(_INV, (
        build.dtype_code(ll.dtype), B, mh, nh, *_planes_args(quads), out,
        out.stride(0), out.stride(1), table.offs.data_ptr(),
        table.coefs.data_ptr(), (ctypes.c_int * 4)(*table.counts),
        table.dmin, table.span), keep=table)


def _fw_check(wt, x, outs):
    _check_input(x)
    return x, _fw_outs(x, outs)


_FW = build.Site(
    "level_fw", _fw_check, lambda x, outs: (x, *outs),
    lambda wt, x, outs: level_fw_plain(x, wt, outs), _fw_plan, result=1,
    writes=slice(1, None), outs=lambda wt, x, outs: (x, _fw_outs(x, None)))
_INV = build.Site(
    "level_inv", lambda wt, quads, out: (quads, _inv_args(quads, out)),
    lambda quads, out: (*quads, out),
    lambda wt, quads, out: level_inv_plain(*quads, wt, out), _inv_plan,
    result=1, writes=slice(-1, None))


def level_fw(x, wt, outs=None):
    """Forward 2-D level of ``x (B, m, n)`` into ``outs`` = (LL, LH, HL, HH)
    planes of ``(B, m/2, n/2)`` with unit column stride (allocated when
    None).  The outputs may not overlap ``x``.  Returns the four planes."""
    return build.run(_FW, wt, (x, outs if outs is None else tuple(outs)))


def level_inv(ll, lh, hl, hh, wt, out=None):
    """Inverse 2-D level: the (LL, LH, HL, HH) planes ``(B, mh, nh)`` with
    unit column stride -> ``out (B, 2mh, 2nh)`` (allocated when None),
    which may not overlap the planes.  Returns ``out``."""
    return build.run(_INV, wt, ((ll, lh, hl, hh), out))
