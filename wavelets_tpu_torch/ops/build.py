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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache
from pathlib import Path

from .. import tracing

__all__ = ["library", "build", "build_log", "check", "launch", "dtype_code",
           "DTYPE_CODES", "SOURCES"]

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
