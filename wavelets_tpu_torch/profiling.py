"""Timing on the CUDA card: chained loops measured with CUDA events.

``time_fn`` keeps the semantics of ``wavelets_tpu/profiling.py``: the mean
seconds per call of ``fn`` over ``iters`` calls, chained (each call takes
the previous output when it has the input's shape and dtype), after one
warm-up call.  The card needs no barrier calibration: CUDA events recorded
on the stream bracket the loop, and ``torch.cuda.synchronize()`` waits for
the end.  ``copy_bandwidth`` is the same-run streaming floor (a
chained ``x + 1``) and ``med3`` the median of three such measurements, the
estimator of ``bench.py``.  Every function here needs a CUDA tensor: a
timing taken on the CPU is not a device time.
"""

from __future__ import annotations

import torch

__all__ = ["time_fn", "med3", "copy_bandwidth", "sol_fraction"]


def time_fn(fn, x, iters: int = 10, chain: bool = True) -> float:
    """Mean seconds per call of ``fn`` over ``iters`` chained calls on the
    card, measured with CUDA events after one warm-up call."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("time_fn times work on a CUDA tensor")
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


def copy_bandwidth(x, iters: int = 10) -> tuple[float, float]:
    """Same-run streaming floor: the :func:`med3` seconds of a chained
    ``x + 1`` (one read and one write of ``x``) and the bytes per second it
    moves."""
    dt = med3(lambda v: v + 1, x, iters)
    return dt, 2 * x.numel() * x.element_size() / dt


def sol_fraction(seconds: float, x, copy_bytes_per_s: float) -> float:
    """Speed-of-light share of a multi-level 2-D pyramid on ``x``, as
    ``bench.py`` defines it: one read and one write of the active array per
    level, geometric over levels (4/3 of the image), at the copy floor's
    rate, divided by the measured time."""
    floor = 2 * x.numel() * x.element_size() * (4 / 3) / copy_bytes_per_s
    return floor / seconds
