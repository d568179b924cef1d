"""One ``torch.profiler`` session over a sub-window of jobs, reduced to what
the per-layer readers need: the device's operations, the benchmark's host
spans, the busy union, and the idle gaps named by the span the host was in.

The session records the host and the card (CUPTI).  Its raw events are
read from ``kineto_results``, which takes a fraction of a second where
``prof.events()`` takes many seconds for a trace of a few hundred thousand
host operations.  Nothing is written to disk unless a path is given.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass

import torch

__all__ = ["Tracer", "Trace", "reduce", "union", "short_name", "is_library",
           "BETWEEN"]

# the host span of an idle gap that opens outside every benchmark span
BETWEEN = "between calls"


def short_name(name: str) -> str:
    """A kernel's name without ``void``, namespaces, template arguments or
    parameters (a copy or fill keeps its name)."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.removeprefix("void ").replace("(anonymous namespace)", "")
    return name.split("<")[0].split("(")[0].split("::")[-1]


def is_library(name: str) -> bool:
    """A PyTorch library kernel (namespace ``at::``), not one of the
    program's own."""
    return "at::" in name


def union(intervals) -> list:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


@dataclass
class Trace:
    """A reduced trace, times in seconds on the trace's clock.

    ``kernels``: ``(name, start, end)`` of each device kernel (copies and
    fills excluded); ``busy``: the union of all device operations within
    the window; ``window``: from the first span's start to the last event's
    end; ``gaps``: idle seconds summed by host span; ``ops``: device
    seconds summed by short kernel name."""
    kernels: list
    busy: float
    window: float
    gaps: dict
    ops: dict


def reduce(device, spans) -> Trace:
    """``device``: ``(name, start, end)`` of every operation on the card;
    ``spans``: ``(label, start, end)`` of the benchmark's host spans.
    Gaps are named by the span open at the gap's start."""
    if not spans or not device:
        raise ValueError("the trace holds no spans or no device operations")
    lo = min(s for _, s, _ in spans)
    hi = max(max(e for _, _, e in spans), max(e for _, _, e in device))
    busy = union((max(s, lo), min(e, hi)) for _, s, e in device
                 if e > lo and s < hi)
    ops = defaultdict(float)
    for name, s, e in device:
        ops[short_name(name)] += e - s
    kernels = [d for d in device
               if not d[0].startswith(("Memcpy", "Memset"))]
    order = sorted(spans, key=lambda sp: sp[1])
    starts = [s for _, s, _ in order]
    gaps = defaultdict(float)
    edge = lo
    for s, e in busy + [[hi, hi]]:
        if s > edge:
            gaps[_open_span(order, starts, edge)] += s - edge
        edge = max(edge, e)
    return Trace(kernels, sum(e - s for s, e in busy), hi - lo, dict(gaps),
                 dict(ops))


def _open_span(order, starts, t) -> str:
    """The label of the span open at ``t`` (the benchmark's spans follow
    one another, none inside another)."""
    i = bisect.bisect_right(starts, t)
    if i and t < order[i - 1][2]:
        return order[i - 1][0]
    return BETWEEN


class Tracer:
    """One profiler session: :meth:`start`, spans named by
    :meth:`span`, then :meth:`stop` (after the card is drained), which
    returns the reduced :class:`Trace`."""

    def __init__(self, labels, export: str | None = None):
        self.labels = set(labels)
        self.export = export
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self.prof.start()

    def span(self, label: str):
        return torch.profiler.record_function(label)

    def stop(self) -> Trace:
        self.prof.stop()
        if self.export:
            self.prof.export_chrome_trace(self.export)
        cuda = torch.autograd.DeviceType.CUDA
        raw = [(e.name(), e.device_type() == cuda, e.start_ns(), e.end_ns())
               for e in self.prof.profiler.kineto_results.events()]
        base = min((r[2] for r in raw), default=0)
        device, spans = [], []
        for name, on_card, s, e in raw:
            item = (name, (s - base) * 1e-9, (e - base) * 1e-9)
            if name in self.labels:
                if not on_card:
                    spans.append(item)
            elif on_card:
                device.append(item)
        return reduce(device, spans)
