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

A :class:`Plan` is one launch's C arguments for a call signature: the
launch wrappers of ``ops/`` build it at the first call of a signature,
after their checks, and keep it under :func:`key` (:func:`planned`,
:func:`store`; at most ``PLAN_LIMIT``, the least recently used dropped
first); a later call of that signature writes its tensors' data pointers
and the stream into the plan's slots, checks the overlap of its outputs
and inputs from their byte extents, and calls.  ``PLANS`` counts the hits
and misses.  Plans are used from one thread, as the port's calls are.
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

__all__ = ["library", "build", "build_log", "check", "launch", "dtype_code",
           "DTYPE_CODES", "SOURCES", "Plan", "key", "planned", "store",
           "mark", "used_since", "last_byte", "PLANS", "PLAN_LIMIT"]

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


# launch key -> (C entry point, span name)
_ENTRIES = {name[4:]: (name, name[4:] + ".call") for name in _SIGNATURES}


def launch(key: str, *args) -> None:
    """Call the C entry point ``wtt_<key>`` with ``args`` and raise on its
    status (:func:`check`), inside the span ``<key>.call``."""
    entry, name = _ENTRIES[key]
    with tracing.span(name):
        check(getattr(library(), entry)(*args), key)


# --- launch plans ------------------------------------------------------------

_Tensor = torch.Tensor
PLAN_LIMIT = 512          # plans kept; the least recently used goes first
PLANS = {"hits": 0, "misses": 0}
_plans: dict = {}
_clock = itertools.count()       # a plan's last use, for the eviction
_wavelets: dict = {}             # id(wavelet) -> (the wavelet, its token)
_tokens: dict = {}               # wavelet -> token; equal wavelets share one
_next_token = itertools.count()


def _token(wt):
    """A small int standing for the wavelet ``wt`` in a key, whose hash
    costs nothing (a carrier hashes all its coefficients).  ``_wavelets``
    holds each wavelet it has seen, so no other object can take its id
    while it is there; at ``PLAN_LIMIT`` wavelets both maps are emptied,
    and a wavelet seen again takes a new token."""
    seen = _wavelets.get(id(wt))
    if seen is None:
        if len(_wavelets) >= PLAN_LIMIT:
            _wavelets.clear()
            _tokens.clear()
        seen = _wavelets[id(wt)] = (
            wt, _tokens.setdefault(wt, next(_next_token)))
    return seen[1]


def key(name, wt, *parts):
    """A plan's key: the ``LAUNCHES`` key ``name``, the wavelet's token and
    ``parts`` (levels and the call's tensors), each tensor replaced by its
    shape, strides, dtype and device, and each list or tuple by the tuple
    of its items' (None kept).  None where a part is no such thing, so
    that the call misses and the wrapper's own checks judge it."""
    try:
        return (name, _token(wt), *[
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


def last_byte(t):
    """The offset of the last byte a strided view spans from its data
    pointer, or None for an empty view."""
    if not t.numel():
        return None
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return (last + 1) * t.element_size() - 1


class Plan:
    """The C arguments of one launch of ``wtt_<key>``, for a signature.

    ``args`` are the entry point's arguments but the stream, as a launch
    wrapper computes them at the first call: each tensor of ``tensors``
    (a pointer argument, in the order of ``tensors``) and each list or
    tuple of them (a pointer array) becomes a slot that :meth:`fill`
    overwrites with the call's data pointers; None is a null pointer; a
    ctypes value is kept; any other value is converted once to its ctypes
    type.  ``keep`` holds what the constant pointers point into (a band
    table), so a plan never depends on a tensor of a call.  ``reads``
    are the indices into ``tensors`` of the inputs that no other tensor
    may overlap (none: no check); ``what`` names the launch in its
    errors."""

    __slots__ = ("key", "call_span", "fn", "args", "stream", "scalars",
                 "cells", "pairs", "device", "what", "keep", "used")

    def __init__(self, key, args, tensors, reads=(), keep=None, what=None):
        entry, self.call_span = _ENTRIES[key]
        self.key, self.what, self.keep = key, what or key, keep
        self.fn = getattr(library(), entry)
        scalars, cells, out, k = [], [], [], 0
        for argtype, a in zip(_SIGNATURES[entry], args):
            if isinstance(a, torch.Tensor):
                assert a is tensors[k], f"{key}: argument out of order"
                a = ctypes.c_void_p()
                scalars.append((a, k))
                k += 1
            elif isinstance(a, (tuple, list)):
                array = (ctypes.c_void_p * len(a))()
                for i, t in enumerate(a):
                    assert t is tensors[k], f"{key}: argument out of order"
                    cells.append((array, i, k))
                    k += 1
                a = array
            elif a is None:
                a = ctypes.c_void_p()
            elif not isinstance(a, (ctypes.Array, ctypes._SimpleCData)):
                a = argtype(a)
            out.append(a)
        if k != len(tensors) or len(out) + 1 != len(_SIGNATURES[entry]):
            raise TypeError(f"{key}: {len(out)} arguments and {k} tensors "
                            "do not fit the entry point")
        self.stream = ctypes.c_void_p()
        self.args = (*out, self.stream)
        self.scalars, self.cells = tuple(scalars), tuple(cells)
        last = [last_byte(t) for t in tensors]
        self.pairs = tuple((r, w, last[r], last[w]) for r in reads
                           for w in range(len(tensors))
                           if w not in reads and last[r] is not None
                           and last[w] is not None)
        self.device = tensors[0].device.index

    def fill(self, tensors, stream):
        """The arguments for ``tensors`` (the signature's) and the raw
        ``stream``; raises ValueError where an output overlaps an
        input."""
        ptrs = [t.data_ptr() for t in tensors]
        for r, w, lr, lw in self.pairs:
            a, b = ptrs[r], ptrs[w]
            if a <= b + lw and b <= a + lr:
                raise ValueError(f"{self.what}: an output overlaps an input")
        for slot, k in self.scalars:
            slot.value = ptrs[k]
        for array, i, k in self.cells:
            array[i] = ptrs[k]
        self.stream.value = stream
        return self.args

    def call(self, tensors, stream):
        """Launch on ``tensors`` and the raw ``stream`` (the current
        device's), inside the span ``<key>.call``; raise on its status."""
        args = self.fill(tensors, stream)
        with tracing.span(self.call_span):
            check(self.fn(*args), self.key)

    def launch(self, tensors):
        """:meth:`call` on the current stream of the plan's device, made
        the current device only where it is not."""
        device = self.device
        if _current_device() == device:
            return self.call(tensors, _raw_stream(device))
        with torch.cuda.device(device):
            self.call(tensors, _raw_stream(device))


# The current device's index, and the raw handle of a device's current
# stream (``torch.cuda.current_stream(index).cuda_stream`` without making a
# Stream object: the call torch's own generated code uses), bound once; a
# plan exists only once CUDA is up.  None in a build of torch without CUDA.
_current_device = getattr(torch._C, "_cuda_getDevice", None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
