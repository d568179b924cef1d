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
``wavelets_tpu/ops/pallas/mxu2d.py`` (see csrc/level2d.cu).  A tensor on
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
LAUNCHES = {"level_fw": 0, "level_inv": 0}
PLAIN_CALLS = {"level_fw": 0, "level_inv": 0}

# tile of csrc/level2d.cu: TR x TC quads per block
_TR, _TC = 32, 32
SMEM_LIMIT = 232448   # bytes of shared memory a block may use on the H100


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


def _extent(t):
    """[first, last] byte address that a (B, rows, cols) view spans."""
    (B, R, C), (sb, sr, _) = t.shape, t.stride()
    first = t.data_ptr()
    return first, first + ((B - 1) * sb + (R - 1) * sr + C) * \
        t.element_size() - 1


def _check_disjoint(reads, writes, name):
    """A kernel reads its inputs while it writes its outputs: refuse an
    output whose memory may overlap an input's."""
    for r in reads:
        storage = r.untyped_storage().data_ptr()
        for w in writes:
            if (w.untyped_storage().data_ptr() == storage and r.numel()
                    and w.numel()):
                (r0, r1), (w0, w1) = _extent(r), _extent(w)
                if r0 <= w1 and w0 <= r1:
                    raise ValueError(f"{name}: an output overlaps an input")


def detail_planes(y, l):
    """Views of level l's (LH, HL, HH) in the packed array ``y (B, M, N)``."""
    _, M, N = y.shape
    mh, nh = M >> l, N >> l
    return (y[:, :mh, nh:2 * nh], y[:, mh:2 * mh, :nh],
            y[:, mh:2 * mh, nh:2 * nh])


def _planes_args(planes):
    return ((ctypes.c_void_p * 4)(*[p.data_ptr() for p in planes]),
            (ctypes.c_int64 * 4)(*[p.stride(0) for p in planes]),
            (ctypes.c_int64 * 4)(*[p.stride(1) for p in planes]))


# --- plain versions ----------------------------------------------------------

def _analysis(v, wt, dim):
    """(a, d) of one periodic level of ``v`` along ``dim``, from the bands."""
    n = v.shape[dim]
    k2 = 2 * torch.arange(n // 2, device=v.device)
    ds, cs, dd, cd = level_bands(wt)

    def corr(deltas, coefs):
        acc = None
        for dl, c in zip(deltas, coefs):
            t = float(c) * v.index_select(dim, (k2 + int(dl)) % n)
            acc = t if acc is None else acc + t
        return acc

    return corr(ds, cs), corr(dd, cd)


def _synthesis(s, d, wt, dim):
    """Inverse of _analysis: (s, d) of half length -> the merged signal."""
    dim = dim % s.dim()
    half = s.shape[dim]
    k = torch.arange(half, device=s.device)
    bands = synthesis_bands(wt)
    parts = []
    for p in (0, 1):
        acc = None
        for src, (deltas, coefs) in ((s, bands[2 * p]), (d, bands[2 * p + 1])):
            for dl, c in zip(deltas, coefs):
                t = float(c) * src.index_select(dim, (k + int(dl)) % half)
                acc = t if acc is None else acc + t
        parts.append(acc)
    return torch.stack(parts, dim=dim + 1).flatten(dim, dim + 1)


def quads_fw(v, wt):
    """(LL, LH, HL, HH) of one level of ``v (..., m, n)``, in v's dtype."""
    a, d = _analysis(v, wt, -1)
    ll, hl = _analysis(a, wt, -2)
    lh, hh = _analysis(d, wt, -2)
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
    layout), computed with index_select gathers in the arithmetic type."""
    _check_input(x)
    outs = _fw_outs(x, outs)
    PLAIN_CALLS["level_fw"] += 1
    for o, v in zip(outs, quads_fw(x.to(acc_dtype(x.dtype)), wt)):
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


def _launch_fw(x, wt, outs, stream):
    table = band_table(wt, False, x.dtype, x.device)
    if _smem(table, 2 * _TR + table.span, _TC) > SMEM_LIMIT:
        raise ValueError(f"level_fw: the bands of {wt.name} reach too far "
                         "for the kernel's shared-memory tile")
    B, m, n = x.shape
    ptrs, sb, sr = _planes_args(outs)
    build.check(build.library().wtt_level_fw(
        build.dtype_code(x.dtype), B, m, n, x.data_ptr(), x.stride(0),
        x.stride(1), ptrs, sb, sr, table.offs.data_ptr(),
        table.coefs.data_ptr(), *table.counts, table.dmin, table.span,
        stream), "level_fw")


def _launch_inv(quads, wt, out, stream):
    ll = quads[0]
    table = band_table(wt, True, ll.dtype, ll.device)
    if _smem(table, _TR + table.span, 2 * _TC) > SMEM_LIMIT:
        raise ValueError(f"level_inv: the bands of {wt.name} reach too far "
                         "for the kernel's shared-memory tile")
    B, mh, nh = ll.shape
    ptrs, sb, sr = _planes_args(quads)
    build.check(build.library().wtt_level_inv(
        build.dtype_code(ll.dtype), B, mh, nh, ptrs, sb, sr, out.data_ptr(),
        out.stride(0), out.stride(1), table.offs.data_ptr(),
        table.coefs.data_ptr(), (ctypes.c_int * 4)(*table.counts),
        table.dmin, table.span, stream), "level_inv")


def level_fw(x, wt, outs=None):
    """Forward 2-D level of ``x (B, m, n)`` into ``outs`` = (LL, LH, HL, HH)
    planes of ``(B, m/2, n/2)`` with unit column stride (allocated when
    None).  The outputs may not overlap ``x``.  Returns the four planes."""
    _check_input(x)
    outs = _fw_outs(x, outs)
    _check_disjoint((x,), outs, "level_fw")
    if x.device.type == "cpu":
        return level_fw_plain(x, wt, outs)
    if x.shape[0]:
        with torch.cuda.device(x.device):
            _launch_fw(x, wt, outs, torch.cuda.current_stream().cuda_stream)
        LAUNCHES["level_fw"] += 1
    return outs


def level_inv(ll, lh, hl, hh, wt, out=None):
    """Inverse 2-D level: the (LL, LH, HL, HH) planes ``(B, mh, nh)`` with
    unit column stride -> ``out (B, 2mh, 2nh)`` (allocated when None),
    which may not overlap the planes.  Returns ``out``."""
    quads = (ll, lh, hl, hh)
    out = _inv_args(quads, out)
    _check_disjoint(quads, (out,), "level_inv")
    if ll.device.type == "cpu":
        return level_inv_plain(ll, lh, hl, hh, wt, out)
    if ll.shape[0]:
        with torch.cuda.device(ll.device):
            _launch_inv(quads, wt, out,
                        torch.cuda.current_stream().cuda_stream)
        LAUNCHES["level_inv"] += 1
    return out
