"""Build and load the CUDA kernels of ``wavelets_tpu_torch/csrc``.

At first use the sources are compiled with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, which is loaded with ``ctypes``.
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

__all__ = ["library", "build", "build_log", "check", "dtype_code",
           "DTYPE_CODES", "SOURCES"]

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    # dtype, B, m, n, L, x, xsb, xsr, y, ysb, ysr, offs, coefs, ns, nd, stream
    "wtt_tail_fw": [_I, _I, _I, _I, _I, _P, _L, _L, _P, _L, _L, _P, _P, _I,
                    _I, _P],
    # dtype, B, m, n, L, y, ysb, ysr, out, osb, osr, offs, coefs, counts[],
    # stream
    "wtt_tail_inv": [_I, _I, _I, _I, _I, _P, _L, _L, _P, _L, _L, _P, _P, _P,
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
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    cmd = [_nvcc(), *FLAGS, "-o", tmp, *map(str, SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (target.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
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
