"""Build and load the CUDA kernels of ``wavelets_tpu_torch/csrc``.

At first use each source is compiled with ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together), and the objects are linked
into one shared library with a plain C interface, which is loaded with
``ctypes``.
The library goes into ``wavelets_tpu_torch/_build/<key>/``, where ``<key>``
hashes the sources and the flags, so an edited source rebuilds.  Importing
this module builds nothing and needs no ``nvcc``.

Every C entry point returns the launch's ``cudaError_t``; :func:`check`
raises on anything but 0.

Every launch wrapper of ``ops/`` makes its call through :func:`run`, the
one launch protocol: a :class:`Site` holds what differs between wrappers
(checks, plain version, plan, tensor order).  A :class:`Plan` is
one launch's C arguments for a call signature: :func:`run` builds it at
the first call of a signature, after the wrapper's checks, and keeps it
under :func:`key` (:func:`planned`, :func:`store`; at most
``PLAN_LIMIT``, the least recently used dropped first); a later call of
that signature writes its tensors' data pointers and the stream into the
plan's slots, checks the overlap of its outputs and inputs from their
byte extents, calls, and counts the launch in its module's ``LAUNCHES``
(:func:`counter`).  ``PLANS`` counts the hits and misses.  Plans are used
from one thread, as the port's calls are.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import itertools
import time
from functools import lru_cache
from pathlib import Path

import torch

from .. import tracing

__all__ = ["library", "build", "build_log", "check", "dtype_code",
           "DTYPE_CODES", "SOURCES", "Site", "run", "Plan", "counter", "key",
           "planned", "store", "mark", "used_since", "extent", "COUNTED",
           "PLANS", "PLAN_LIMIT"]

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C interface (csrc/common.cuh, enum DType)
DTYPE_CODES = {"float32": 0, "float64": 1, "bfloat16": 2}


def dtype_code(dtype) -> int:
    """The C interface's code for a torch dtype."""
    return DTYPE_CODES[str(dtype).removeprefix("torch.")]


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # dtype, B, m, n, x, xsb, xsr, planes, sb[], sr[], offs, coefs, ns, nd,
    # dmin, span, stream
    "wtt_level_fw": [_I, _I, _I, _I, _P, _L, _L, _P, _P, _P, _P, _P, _I, _I,
                     _I, _I, _P],
    # dtype, B, mh, nh, planes, sb[], sr[], out, osb, osr, offs, coefs,
    # counts[], smin, span, stream
    "wtt_level_inv": [_I, _I, _I, _I, _P, _P, _P, _P, _L, _L, _P, _P, _P, _I,
                      _I, _P],
    # dtype, B, m, n, x, xsb, xsr, planes, sb[], sr[], offs, coefs, ns, nd,
    # dmin, span, tile, strips, stream
    "wtt_stage2_fw": [_I, _I, _I, _I, _P, _L, _L, _P, _P, _P, _P, _P, _I, _I,
                      _I, _I, _I, _I, _P],
    # dtype, B, m, n, L, x, xsb, xsr, y, ysb, ysr, offs, coefs, ns, nd,
    # plan[7], smem, stream
    "wtt_tail_fw": [_I, _I, _I, _I, _I, _P, _L, _L, _P, _L, _L, _P, _P, _I,
                    _I, _P, _L, _P],
    # dtype, B, m, n, L, y, ysb, ysr, out, osb, osr, offs, coefs, counts[],
    # plan[7], smem, stream
    "wtt_tail_inv": [_I, _I, _I, _I, _I, _P, _L, _L, _P, _L, _L, _P, _P, _P,
                     _P, _L, _P],
    # dtype, B, n, x, xs, s, ss, d, ds, offs, coefs, ns, nd, dmin, span,
    # min_pairs, stream
    "wtt_level1d_fw": [_I, _I, _I, _P, _L, _P, _L, _P, _L, _P, _P, _I, _I, _I,
                       _I, _L, _P],
    # dtype, B, nh, s, ss, d, ds, x, xs, offs, coefs, counts[], smin, span,
    # stream
    "wtt_level1d_inv": [_I, _I, _I, _P, _L, _P, _L, _P, _L, _P, _P, _P, _I,
                        _I, _P],
    # dtype, B, n, L, x, xs, y, ys, offs, coefs, ns, nd, dmin, span, window,
    # stream
    "wtt_tail1d_fw": [_I, _I, _I, _I, _P, _L, _P, _L, _P, _P, _I, _I, _I, _I,
                      _I, _P],
    # dtype, B, n, L, y, ys, out, os, offs, coefs, counts[], smin, span,
    # window, stream
    "wtt_tail1d_inv": [_I, _I, _I, _I, _P, _L, _P, _L, _P, _P, _P, _I, _I,
                       _I, _P],
    # dtype, B, R, C, x, xsb, xsr, a, asb, asr, d, dsb, dsr, offs, coefs,
    # ns, nd, dmin, span, min_pairs, stream
    "wtt_axis0_fw": [_I, _I, _I, _I, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P,
                     _P, _I, _I, _I, _I, _L, _P],
    # dtype, B, R, C, x, xsb, xsr, a, asb, asr, d, dsb, dsr, halos[2],
    # hsb[], hsr[], ha, offs, coefs, ns, nd, dmin, span, min_pairs, stream
    "wtt_axis0_fw_halo": [_I, _I, _I, _I, _P, _L, _L, _P, _L, _L, _P, _L, _L,
                          _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _L, _P],
    # dtype, B, Rh, C, a, asb, asr, d, dsb, dsr, corner, csb, csr, Bc, Cc,
    # x, xsb, xsr, offs, coefs, counts[], smin, span, stream
    "wtt_axis0_inv": [_I, _I, _I, _I, _P, _L, _L, _P, _L, _L, _P, _L, _L, _I,
                      _I, _P, _L, _L, _P, _P, _P, _I, _I, _P],
    # dtype, B, Rh, C, a, asb, asr, d, dsb, dsr, halos[4], hsb[], hsr[], ha,
    # x, xsb, xsr, offs, coefs, counts[], smin, span, stream
    "wtt_axis0_inv_halo": [_I, _I, _I, _I, _P, _L, _L, _P, _L, _L, _P, _P, _P,
                           _I, _P, _L, _L, _P, _P, _P, _I, _I, _P],
    # dtype, dh, mh, nh, x, xsd, xsr, y, ysd, ysr, lll, lsd, lsr, offs,
    # coefs, ns, nd, stream
    "wtt_level3_fw": [_I, _I, _I, _I, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P,
                      _P, _I, _I, _P],
    # dtype, dh, mh, nh, y, ysd, ysr, lll, lsd, lsr, x, xsd, xsr, offs,
    # coefs, counts[], stream
    "wtt_level3_inv": [_I, _I, _I, _I, _P, _L, _L, _P, _L, _L, _P, _L, _L,
                       _P, _P, _P, _P],
    # dtype, B, N, dil, v, vsr, vse, v1, v1sr, v1se, w1, w1sr, w1se, taps,
    # nt, stream
    "wtt_modwt_fw": [_I, _I, _I, _I, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P,
                     _I, _P],
    # dtype, B, N, L, x, xsr, xse, out, osb, taps, nt, plan[4], smem, stream
    "wtt_modwt_fw_levels": [_I, _I, _I, _I, _P, _L, _L, _P, _L, _P, _I, _P,
                            _L, _P],
    # dtype, B, N, dil, v1, v1sr, v1se, w1, w1sr, w1se, v, vsr, vse, taps,
    # nt, stream
    "wtt_modwt_inv": [_I, _I, _I, _I, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P,
                      _I, _P],
    # dtype, B, N, L, xw, xwsb, out, osr, taps, nt, plan[4], smem, stream
    "wtt_modwt_inv_levels": [_I, _I, _I, _I, _P, _L, _P, _L, _P, _I, _P, _L,
                             _P],
    # the graphs of a driver's launch chain (csrc/graph.cu, ops/graph.py):
    # stream; stream, *handle, *nodes; handle, node, out, cap; words, n,
    # flags; handle, patches, npatches, bases, nbases; handle, bases,
    # stream; handle; stream
    "wtt_graph_begin": [_P],
    "wtt_graph_end": [_P, ctypes.POINTER(_P), ctypes.POINTER(_I)],
    "wtt_graph_block": [_P, _I, _P, _L],
    "wtt_device_pointers": [_P, _I, _P],
    "wtt_graph_instantiate": [_P, _P, _I, _P, _I],
    "wtt_graph_replay": [_P, _P, _P],
    "wtt_graph_free": [_P],
    "wtt_graph_abort": [_P],
}


def _key() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in SOURCES + HEADERS:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "wavelets_tpu_torch need the CUDA toolkit")
    return found


def _compile(target: Path) -> None:
    """One ``nvcc -c`` per source, all running at once, then one link."""
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    tmpdir = Path(tempfile.mkdtemp(dir=target.parent))
    objs = [tmpdir / (src.stem + ".o") for src in SOURCES]
    cmds = [[nvcc, *FLAGS, "-c", "-o", str(o), str(src)]
            for src, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    link = [nvcc, "-shared", "-o", tmp, *map(str, objs)]
    res = (subprocess.run(link, capture_output=True, text=True)
           if all(p.returncode == 0 for p in procs) else None)
    log = [" ".join(c) + "\n" + o for c, o in zip(cmds, outs)]
    if res is not None:
        log.append(" ".join(link) + "\n" + res.stdout + res.stderr)
    (target.parent / "build.log").write_text("".join(log))
    shutil.rmtree(tmpdir)
    if res is None or res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed:\n" + "".join(log))
    os.replace(tmp, target)


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    target = BUILD / _key() / "libwavelets_tpu_torch.so"
    if not target.exists():
        _compile(target)
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.wtt_error_string.argtypes = [ctypes.c_int]
    lib.wtt_error_string.restype = ctypes.c_char_p
    return lib


def build() -> float:
    """Build (if needed) and load the library; returns the seconds taken."""
    t0 = time.perf_counter()
    library()
    return time.perf_counter() - t0


def build_log() -> str:
    """nvcc's command line and output (with ``-Xptxas -v``: each kernel's
    registers, shared memory and spills) for the current sources."""
    path = BUILD / _key() / "build.log"
    return path.read_text() if path.exists() else ""


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        msg = library().wtt_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


# --- launch plans ------------------------------------------------------------

_Tensor = torch.Tensor
PLAN_LIMIT = 512          # plans kept; the least recently used goes first
PLANS = {"hits": 0, "misses": 0}
COUNTED: dict = {}       # launch key -> the LAUNCHES dict that counts it
_PLAIN_DEVICE = "cpu"    # the device type that takes the plain versions
_plans: dict = {}
_clock = itertools.count()       # a plan's last use, for the eviction
_wavelets: dict = {}             # id(wavelet) -> (the wavelet, its token)
_tokens: dict = {}               # wavelet -> token; equal wavelets share one
_next_token = itertools.count()


def counter(*keys):
    """A launch wrapper module's ``LAUNCHES``: a count for each launch key,
    zero, registered in :data:`COUNTED` under each key, so that
    :meth:`Plan.launch` raises it."""
    counts = dict.fromkeys(keys, 0)
    COUNTED.update(dict.fromkeys(keys, counts))
    return counts


def _remember(wt):
    """``(wt, token)``: the token is a small int standing for the wavelet
    ``wt`` in a key, whose hash costs nothing (a carrier hashes all its
    coefficients).  ``_wavelets`` holds each wavelet it has seen, so no
    other object can take its id while it is there; at ``PLAN_LIMIT``
    wavelets both maps are emptied, and a wavelet seen again takes a new
    token."""
    if len(_wavelets) >= PLAN_LIMIT:
        _wavelets.clear()
        _tokens.clear()
    token = _tokens.setdefault(wt, next(_next_token))
    _wavelets[id(wt)] = (wt, token)
    return wt, token


def key(name, wt, *parts):
    """A plan's key: the ``LAUNCHES`` key ``name``, the wavelet's token and
    ``parts`` (levels and the call's tensors), each tensor replaced by its
    shape, strides, dtype and device, and each list or tuple by the tuple
    of its items' (None kept).  None where a part is no such thing, so
    that the call misses and the wrapper's own checks judge it."""
    return _plan_key(name, wt, parts)


def _plan_key(name, wt, parts):
    try:
        return (name, (_wavelets.get(id(wt)) or _remember(wt))[1], *[
            (p.shape, p.stride(), p.dtype, p.device)
            if isinstance(p, _Tensor) else
            tuple([None if t is None else (t.shape, t.stride(), t.dtype,
                                           t.device) for t in p])
            if isinstance(p, (tuple, list)) else p for p in parts])
    except (AttributeError, TypeError):
        return None


def planned(key):
    """The plan kept under ``key`` (a hit), or None."""
    try:
        plan = _plans.get(key)
    except TypeError:          # an unhashable part: the checks judge it
        return None
    if plan is not None:
        plan.used = next(_clock)
        PLANS["hits"] += 1
    return plan


def store(key, plan):
    """Keep ``plan`` under ``key`` (a miss), dropping the least recently
    used plan beyond ``PLAN_LIMIT``, and return it."""
    PLANS["misses"] += 1
    plan.used = next(_clock)
    if key is not None:
        _plans[key] = plan
        if len(_plans) > PLAN_LIMIT:
            del _plans[min(_plans, key=lambda k: _plans[k].used)]
    return plan


def mark():
    """A stamp of the plans' clock, for :func:`used_since`."""
    return next(_clock)


def used_since(stamp):
    """The kept plans looked up or stored after ``stamp``."""
    return [p for p in _plans.values() if p.used > stamp]


def extent(t):
    """``(base, size)``: a strided view's data pointer and the bytes it
    spans from there; (0, 0) for None or an empty view."""
    if t is None or not t.numel():
        return 0, 0
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return t.data_ptr(), (last + 1) * t.element_size()


def _pairs(tensors, writes):
    """``(input, output, bytes of each)`` for each non-empty input and
    output among ``tensors``, by index (:func:`extent`); ``writes``
    slices the outputs out of them (None: no pair)."""
    if writes is None:
        return ()
    index = range(len(tensors))
    outs, size = index[writes], [extent(t)[1] for t in tensors]
    return tuple((r, w, size[r], size[w]) for r in index if r not in outs
                 for w in outs if size[r] and size[w])


def _overlap(ptrs, pairs, what):
    """The overlap rule: a kernel reads its inputs while it writes its
    outputs, so raise where the bytes of an output (from its data pointer
    in ``ptrs``, :func:`_pairs`) meet an input's."""
    for r, w, sr, sw in pairs:
        if ptrs[r] < ptrs[w] + sw and ptrs[w] < ptrs[r] + sr:
            raise ValueError(f"{what}: an output overlaps an input")


class Site:
    """What one launch wrapper brings to :func:`run` for the launch key
    ``key`` (its span, its ``LAUNCHES`` key, the entry point
    ``wtt_<key>``; errors name it without ``_halo``).  The hooks take the
    wavelet and the call's ``parts``, the plan key's parts in its order:
    ``check`` runs the wrapper's checks and hands back the parts with the
    outputs allocated, ``outs`` (default ``check``) allocates on a hit
    the outputs the caller did not give (where ``parts[result]``, or its
    first, is None), ``fits`` raises for a call the kernel cannot take
    on any device, ``plain`` runs the plain version and ``plan`` builds the
    :class:`Plan`.  ``order(*parts)`` is the launch's tensors in the entry
    point's order, the input that picks the device first; ``writes``
    slices its outputs out of them (None: the launch may write its input,
    as the tails do).  The wrapper hands back ``parts[result]``."""

    __slots__ = ("key", "what", "check", "order", "plain", "plan", "result",
                 "given", "writes", "outs", "fits")

    def __init__(self, key, check, order, plain, plan, result, writes=None,
                 outs=None, fits=None):
        self.key, self.what = key, key.removesuffix("_halo")
        self.check, self.order, self.plain = check, order, plain
        self.plan, self.result, self.writes = plan, result, writes
        self.outs, self.fits = outs or check, fits
        self.given = result if isinstance(result, int) else result.start


def run(site, wt, parts, tag=-1):
    """A launch wrapper's call, inside the span ``site.key`` (``tag``):
    look up the plan of its signature (:func:`key` of ``parts``).  On a
    miss run the checks, refuse an output that overlaps an input, hand a
    CPU tensor to the plain version and an empty call back unlaunched,
    then build and keep the plan; on a hit allocate the outputs the caller
    did not give.  Launch, counting it (:meth:`Plan.launch`), and hand
    back ``parts[site.result]``."""
    with tracing.span(site.key, tag):
        k = _plan_key(site.key, wt, parts)
        plan = planned(k)
        if plan is None:
            parts = site.check(wt, *parts)
            tensors = site.order(*parts)
            _overlap([t.data_ptr() for t in tensors],
                     _pairs(tensors, site.writes), site.what)
            if site.fits is not None:
                site.fits(wt, *parts)
            if tensors[0].device.type == _PLAIN_DEVICE:
                return site.plain(wt, *parts)
            if not tensors[0].numel():
                return parts[site.result]
            plan = store(k, site.plan(wt, *parts))
        else:
            if parts[site.given] is None:
                parts = site.outs(wt, *parts)
            tensors = site.order(*parts)
        plan.launch(tensors)
        return parts[site.result]


class Plan:
    """The C arguments of one launch of ``wtt_<site.key>``, for a
    signature.

    ``args`` are the entry point's arguments but the stream, as the
    site's ``plan`` computes them from a call: each tensor and each list
    or tuple of tensors (a pointer array) becomes a slot that
    :meth:`call` overwrites with a call's data pointers, the call's
    tensors taken in the order the slots have in ``args``
    (``site.order``); None is a null pointer; a ctypes value is kept; any
    other value is converted once to its ctypes type.  ``keep`` holds what
    the constant pointers point into (a band table), so a plan never
    depends on a tensor of a call."""

    __slots__ = ("key", "call_span", "fn", "args", "stream", "scalars",
                 "cells", "pairs", "device", "what", "counts", "keep", "used")

    def __init__(self, site, args, keep=None):
        entry = "wtt_" + site.key
        self.key, self.what, self.keep = site.key, site.what, keep
        self.call_span, self.counts = site.key + ".call", COUNTED[site.key]
        self.fn = getattr(library(), entry)
        tensors, scalars, cells, out = [], [], [], []
        for argtype, a in zip(_SIGNATURES[entry], args):
            if isinstance(a, torch.Tensor):
                scalars.append((ctypes.c_void_p(), len(tensors)))
                tensors.append(a)
                a = scalars[-1][0]
            elif isinstance(a, (tuple, list)):
                array = (ctypes.c_void_p * len(a))()
                for i, t in enumerate(a):
                    cells.append((array, i, len(tensors)))
                    tensors.append(t)
                a = array
            elif a is None:
                a = ctypes.c_void_p()
            elif not isinstance(a, (ctypes.Array, ctypes._SimpleCData)):
                a = argtype(a)
            out.append(a)
        if len(out) + 1 != len(_SIGNATURES[entry]):
            raise TypeError(f"{site.key}: {len(out)} arguments do not fit "
                            "the entry point")
        self.stream = ctypes.c_void_p()
        self.args = (*out, self.stream)
        self.scalars, self.cells = tuple(scalars), tuple(cells)
        self.pairs = _pairs(tensors, site.writes)
        self.device = tensors[0].device.index

    def call(self, tensors, stream):
        """Launch on ``tensors`` (the signature's, in the slots' order) and
        the raw ``stream`` (the current device's), inside the span
        ``<key>.call``: write their data pointers and the stream into the
        arguments, raise ValueError where an output overlaps an input, and
        raise on the launch's status.  Counts nothing."""
        ptrs = [t.data_ptr() for t in tensors]
        if self.pairs:
            _overlap(ptrs, self.pairs, self.what)
        for slot, k in self.scalars:
            slot.value = ptrs[k]
        for array, i, k in self.cells:
            array[i] = ptrs[k]
        self.stream.value = stream
        with tracing.span(self.call_span):
            status = self.fn(*self.args)
            if status:
                check(status, self.key)

    def launch(self, tensors):
        """:meth:`call` on the current stream of the plan's device, made
        the current device only where it is not, counted in ``LAUNCHES``."""
        device = self.device
        if _current_device() == device:
            self.call(tensors, _raw_stream(device))
        else:
            with torch.cuda.device(device):
                self.call(tensors, _raw_stream(device))
        self.counts[self.key] += 1


# The current device's index, and the raw handle of a device's current
# stream (``torch.cuda.current_stream(index).cuda_stream`` without making a
# Stream object: the call torch's own generated code uses), bound once; a
# plan exists only once CUDA is up.  None in a build of torch without CUDA.
_current_device = getattr(torch._C, "_cuda_getDevice", None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
