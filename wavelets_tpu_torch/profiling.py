"""Timing on the CUDA card: chained loops measured with CUDA events.

``time_fn`` keeps the semantics of ``wavelets_tpu/profiling.py``: the mean
seconds per call of ``fn`` over ``iters`` calls, chained (each call takes
the previous output when it has the input's shape and dtype), after one
warm-up call.  The card needs no barrier calibration: CUDA events recorded
on the stream bracket the loop, and ``torch.cuda.synchronize()`` waits for
the end.  ``copy_bandwidth`` is the same-run streaming floor (a
chained ``x + 1``) and ``med3`` the median of three such measurements, the
estimator of ``bench.py``.  ``enqueue_time`` is the host's side: the
seconds the host takes to enqueue one call, which bounds the call's time
from below when the host, not the card, is the bottleneck.  Every
function here needs a CUDA tensor: a timing taken on the CPU is not a
device time.
"""

from __future__ import annotations

import time

import torch

__all__ = ["time_fn", "med3", "enqueue_time", "copy_bandwidth",
           "sol_fraction", "geometric1d", "geometric3d", "geometric_modwt"]


def _check_cuda(x):
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("timing needs a CUDA tensor")


def time_fn(fn, x, iters: int = 10, chain: bool = True) -> float:
    """Mean seconds per call of ``fn`` over ``iters`` chained calls on the
    card, measured with CUDA events after one warm-up call."""
    _check_cuda(x)
    y = fn(x)
    same = isinstance(y, torch.Tensor) and y.shape == x.shape \
        and y.dtype == x.dtype
    torch.cuda.synchronize(x.device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    v = x
    for _ in range(iters):
        v = fn(v) if (chain and same) else fn(x)
    stop.record()
    torch.cuda.synchronize(x.device)
    return start.elapsed_time(stop) / 1e3 / iters


def med3(fn, x, iters: int = 10) -> float:
    """Median of three :func:`time_fn` measurements, in seconds."""
    return sorted(time_fn(fn, x, iters) for _ in range(3))[1]


def enqueue_time(fn, x, iters: int = 10) -> float:
    """Mean host seconds to enqueue one call of ``fn(x)`` (the card keeps
    running behind), over ``iters`` calls after one warm-up call."""
    _check_cuda(x)
    fn(x)
    torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    seconds = (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(x.device)
    return seconds


def copy_bandwidth(x, iters: int = 10) -> tuple[float, float]:
    """Same-run streaming floor: the :func:`med3` seconds of a chained
    ``x + 1`` (one read and one write of ``x``) and the bytes per second it
    moves."""
    dt = med3(lambda v: v + 1, x, iters)
    return dt, 2 * x.numel() * x.element_size() / dt


def sol_fraction(seconds: float, x, copy_bytes_per_s: float,
                 geometric: float = 4 / 3) -> float:
    """Speed-of-light share of a multi-level pyramid on ``x``, as
    ``bench.py`` defines it: one read and one write of the active array per
    level, at the copy floor's rate, divided by the measured time.
    ``geometric`` is the active array's size summed over the levels, as a
    multiple of ``x``: 4/3 for a 2-D pyramid (the default),
    :func:`geometric1d` for a 1-D one and :func:`geometric3d` for a 3-D
    one; :func:`geometric_modwt` states the MODWT's traffic the same way."""
    floor = 2 * x.numel() * x.element_size() * geometric / copy_bytes_per_s
    return floor / seconds


def geometric1d(L: int) -> float:
    """Active row summed over the L levels of a 1-D pyramid, as a multiple
    of the row: 1 + 1/2 + ... = 2 (1 - 2^-L)."""
    return 2 * (1 - 2.0 ** -L)


def geometric3d(L: int) -> float:
    """Active volume summed over the L levels of a 3-D pyramid, as a
    multiple of the volume: 1 + 1/8 + ... = (8/7) (1 - 8^-L)."""
    return (8 / 7) * (1 - 8.0 ** -L)


def geometric_modwt(L: int) -> float:
    """The MODWT's floor in the same units: the least traffic of either
    direction, one plane of ``x``'s size read and L + 1 written (forward),
    or L + 1 read and one written (inverse), so L + 2 planes move, which
    :func:`sol_fraction` counts as 2 * ((L + 2) / 2)."""
    return (L + 2) / 2
