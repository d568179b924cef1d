"""The program's own spans and counters (``wavelets_tpu_torch.tracing``) over
sub-windows that a traced run adds after its judgement, read by the
per-layer metrics of the program's layers.

``run.py`` passes a reader only the run's record, and reads the metrics
inside ``main``, whose local ``run`` is the cell's :class:`loop.Run`;
:func:`of` finds it there, makes the pool again from the seed and runs,
each with the card drained at both ends, ``trace_jobs`` jobs three times:

1. on a card, under one profiler session with program tracing on: the
   idle gaps named ``<benchmark span> / <program span>`` by the innermost
   program span open in each part of a gap (parts no program span covers
   keep the benchmark span's name, so the totals per benchmark span are
   ``trace.reduce``'s), each program kernel put down to the launch span
   whose CUDA runtime call launched it (the profiler's correlation id), and
   the device time a job by launch and level; all on standard error;
2. with program tracing on and the profiler off: the self times of the
   root spans (front end), the driver spans (drivers) and the launch spans
   with their ``.call`` (launch wrappers), and the rise of
   ``scratch.ALLOCATED`` (the program's counters are read around it);
3. with all tracing off: the host time a job, against which 2.'s is its
   on-cost.  2. and 3. run in alternating blocks (off, on, on, off, ...),
   since the host's speed drifts within a process.

These jobs run after the window, so the window's records and the
metrics read from them are those of a run without them.  Where the
program has no tracing module or no scratch counter, :func:`of` returns
None and runs nothing.
"""

from __future__ import annotations

import bisect
import statistics
import sys
import time
import traceback
from collections import defaultdict, deque
from contextlib import nullcontext
from dataclasses import dataclass

import torch

from . import loop
from .trace import BETWEEN, Tracer, is_library, short_name, union

__all__ = ["Program", "of", "innermost", "split_gaps", "attribute",
           "level_labels", "by_name", "host_layers", "TOP"]

TOP = 10
MIB = 2 ** 20
BLOCKS = 10       # of each side of sub-windows 2 and 3


@dataclass
class Program:
    """What the program's spans and counters say, per job of the
    program-traced sub-window: ``front_us`` (root spans' self time),
    ``driver_us`` (driver spans' self time), ``launch_us`` (mean duration
    of a launch span, its ``.call`` included), ``prep_us`` / ``call_us``
    (the mean launch's self time and its ``.call``), ``launches`` (launch
    spans a job), ``scratch_mib`` (the rise of ``scratch.ALLOCATED``),
    ``host_on_us`` / ``host_off_us`` (host time a job's two calls take
    with program tracing on and off) and ``dropped`` spans."""
    jobs: int
    front_us: float
    driver_us: float
    launch_us: float | None
    prep_us: float | None
    call_us: float | None
    launches: float
    scratch_mib: float
    host_on_us: float
    host_off_us: float
    dropped: int = 0


# --- pure reductions (tested on synthetic spans and events) ----------------

def innermost(spans) -> list:
    """``(start, end, name)`` of the innermost span open at each time, for
    nested ``(name, start, end)`` spans: sorted, disjoint, and absent
    where no span is open."""
    out, stack, t = [], [], None
    for name, s, e in sorted(spans, key=lambda sp: (sp[1], -sp[2])):
        while stack and stack[-1][2] <= s:
            top = stack.pop()
            if top[2] > t:
                out.append((t, top[2], top[0]))
                t = top[2]
        if stack and s > t:
            out.append((t, s, stack[-1][0]))
        stack.append((name, s, e))
        t = s
    while stack:
        top = stack.pop()
        if top[2] > t:
            out.append((t, top[2], top[0]))
            t = top[2]
    return out


def _gaps(device, spans):
    """The idle intervals of ``trace.reduce``'s walk, each with the
    benchmark span open at its start."""
    lo = min(s for _, s, _ in spans)
    hi = max(max(e for _, _, e in spans), max(e for _, _, e in device))
    busy = union((max(s, lo), min(e, hi)) for _, s, e in device
                 if e > lo and s < hi)
    order = sorted(spans, key=lambda sp: sp[1])
    starts = [s for _, s, _ in order]
    out, edge = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > edge:
            i = bisect.bisect_right(starts, edge)
            label = order[i - 1][0] if i and edge < order[i - 1][2] \
                else BETWEEN
            out.append((edge, s, label))
        edge = max(edge, e)
    return out


def split_gaps(device, spans, segments) -> dict:
    """Idle seconds by ``<benchmark span> / <program span>``: each idle gap
    of ``trace.reduce(device, spans)``, named there by the benchmark span
    open at its start, split by the innermost program span (``segments``,
    from :func:`innermost`) over each part; parts outside every program
    span keep the benchmark span's name."""
    starts = [s for s, _, _ in segments]
    out = defaultdict(float)
    for a, b, label in _gaps(device, spans):
        covered = 0.0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segments) and segments[i][0] < b:
            s, e, name = segments[i]
            part = min(e, b) - max(s, a)
            if part > 0:
                out[f"{label} / {name}"] += part
                covered += part
            i += 1
        if b - a - covered > 0:
            out[label] += b - a - covered
    return dict(out)


def attribute(kernels, runtime, launches):
    """Put each program kernel ``(name, start, end, correlation)`` down to
    the launch span ``(index, start, end)`` (launch spans do not overlap)
    open when its runtime call ``{correlation: time}`` was made.  Returns
    ``({launch index: [kernel, ...]}, [unclaimed kernel, ...])``."""
    order = sorted(launches, key=lambda sp: sp[1])
    starts = [s for _, s, _ in order]
    claimed, unclaimed = defaultdict(list), []
    for k in kernels:
        t = runtime.get(k[3])
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= order[i][2]:
            claimed[order[i][0]].append(k)
        else:
            unclaimed.append(k)
    return dict(claimed), unclaimed


def level_labels(spans, keys) -> dict:
    """The level each launch span runs, as a label, by launch span index:
    its own tag where it has one; else, among the launches of one driver
    span, the n-th forward launch of a key runs level n and the n-th of
    an inverse key (``_inv`` in it) level count - n + 1, as the level
    route orders them; a tail runs from the level after the most
    launches of any other key to the driver's tag."""
    by_driver = defaultdict(lambda: defaultdict(list))
    for i, s in enumerate(spans):
        if s.name in keys:
            by_driver[s.parent][s.name].append(i)
    out = {}
    for parent, groups in by_driver.items():
        levels = max((len(v) for k, v in groups.items() if "tail" not in k),
                     default=0)
        top = spans[parent].tag if parent >= 0 else -1
        for key, idx in groups.items():
            for n, i in enumerate(idx):
                if spans[i].tag >= 0:
                    out[i] = str(spans[i].tag)
                elif "tail" in key:
                    last = str(top) if top >= 0 else "L"
                    out[i] = str(levels + 1) if last == str(levels + 1) \
                        else f"{levels + 1}-{last}"
                elif "_inv" in key:
                    out[i] = str(len(idx) - n)
                else:
                    out[i] = str(n + 1)
    return out


def by_name(spans, own) -> list:
    """``(name, (count, total ns, self ns))`` of each span name, the
    longest total first."""
    out = {}
    for s, o in zip(spans, own):
        c, t, so = out.get(s.name, (0, 0, 0))
        out[s.name] = (c + 1, t + s.end - s.start, so + o)
    return sorted(out.items(), key=lambda kv: -kv[1][1])


def host_layers(spans, own, keys) -> dict:
    """Host ns by layer over ``spans`` (with their self times ``own``):
    ``front`` (roots), ``driver`` (non-launch spans below a root),
    ``launch`` (each launch span's duration), ``prep`` (their self
    times), ``call`` (their ``.call`` children), ``other``."""
    out = {"front": 0, "driver": 0, "launch": [], "prep": 0, "call": 0,
           "other": 0}
    for s, o in zip(spans, own):
        if s.parent < 0:
            out["front"] += o
        elif s.name in keys:
            out["launch"].append(s.end - s.start)
            out["prep"] += o
        elif s.name.endswith(".call") and spans[s.parent].name in keys:
            out["call"] += s.end - s.start
        elif spans[s.parent].parent < 0:
            out["driver"] += o
        else:
            out["other"] += o
    return out


# --- the sub-windows --------------------------------------------------------

def _program():
    """The program's tracing module and scratch counter, or None where the
    program has neither (an older checkout)."""
    try:
        from wavelets_tpu_torch import tracing
        from wavelets_tpu_torch.ops import scratch
    except ImportError:
        return None
    if not hasattr(scratch, "ALLOCATED"):
        return None
    return tracing, scratch


def _the_run():
    """The :class:`loop.Run` of the caller's ``run`` local, or None."""
    frame = sys._getframe(1)
    while frame is not None:
        run = frame.f_locals.get("run")
        if isinstance(run, loop.Run):
            return run
        frame = frame.f_back
    return None


def of(rec) -> Program | None:
    """The program's spans and counters for the run of ``rec`` (measured at
    the first call, kept on ``rec``), or None."""
    if not hasattr(rec, "program"):
        found, run = _program(), _the_run()
        rec.program = None if found is None or run is None \
            else measure(run, *found, window=rec.host_s)
    return rec.program


def _jobs(run, pool, n, span=None):
    """``n`` jobs in the window's closed loop, the card drained at both
    ends; the host seconds of each job's two calls."""
    pending, host = deque(), []
    span = span or (lambda _: nullcontext())
    run._sync()
    for k in range(n):
        if len(pending) == run.in_flight:
            with span(run.wait_label):
                run.stamps.wait(pending.popleft()[0])
        t = time.perf_counter()
        out = run._job(pool[k % len(pool)], span)
        host.append(time.perf_counter() - t)
        pending.append((run.stamps.now(), out))
    while pending:
        run.stamps.wait(pending.popleft()[0])
    run._sync()
    return host


def _launch_keys(tracing) -> set:
    return {k.rsplit(".", 1)[1] for k in tracing.counters()
            if ".LAUNCHES." in k}


def measure(run, tracing, scratch, window=()) -> Program:
    """Sub-windows 1-3 of the module docstring for ``run``, logged on
    standard error with the host seconds of the window's jobs
    (``window``) beside them: the host's speed drifts within a process."""
    n = run.cell.traffic["trace_jobs"]
    pool = [loop.make_input(run.seed, i, run.shape, run.device).to(run.dtype)
            for i in range(run.cell.traffic["pool"])]
    keys = _launch_keys(tracing)
    lines = []
    if run.device.type == "cuda":
        try:
            lines += _profiled(run, pool, n, tracing, keys)
        except Exception:      # the diagnostics must not cost the run
            lines.append("program: the profiled sub-window failed:\n"
                         + traceback.format_exc())
    on, off, ratios, blocks, allocated = [], [], [], [], 0
    tracing.take()
    for b, size in enumerate(n // BLOCKS + (b < n % BLOCKS)
                             for b in range(BLOCKS)):
        host = {}
        for traced in ((False, True) if b % 2 == 0 else (True, False)):
            if not traced:
                host[traced] = _jobs(run, pool, size)
                continue
            before = scratch.ALLOCATED["bytes"]
            tracing.enable()
            try:
                host[traced] = _jobs(run, pool, size)
            finally:
                tracing.disable()
            allocated += scratch.ALLOCATED["bytes"] - before
        off += host[False]
        on += host[True]
        if size:
            ratios.append(sum(host[True]) / sum(host[False]))
            blocks.append((host[False], host[True]))
    taken = tracing.take()
    spans = taken["spans"]
    own = tracing.self_ns(spans)
    layers = host_layers(spans, own, keys)
    launch = layers["launch"]
    k = len(launch)
    p = Program(
        jobs=n, front_us=layers["front"] / n / 1e3,
        driver_us=layers["driver"] / n / 1e3,
        launch_us=sum(launch) / k / 1e3 if k else None,
        prep_us=layers["prep"] / k / 1e3 if k else None,
        call_us=layers["call"] / k / 1e3 if k else None,
        launches=k / n,
        scratch_mib=allocated / n / MIB,
        host_on_us=1e6 * sum(on) / n, host_off_us=1e6 * sum(off) / n,
        dropped=taken["dropped"])
    sum_us = p.front_us + p.driver_us + p.launches * (p.launch_us or 0.0)
    lines.append(
        f"program: {n} jobs with program tracing on (profiler off): front "
        f"{p.front_us:.2f} us a job, driver {p.driver_us:.2f}, "
        f"{p.launches:g} launches of {p.launch_us or 0:.2f} us (prep "
        f"{p.prep_us or 0:.2f}, call {p.call_us or 0:.2f}); sum "
        f"{sum_us:.2f} us against {p.host_on_us:.2f} us of host a job "
        f"(other {layers['other'] / n / 1e3:.2f}); off {p.host_off_us:.2f} "
        f"us, on-cost {100 * (p.host_on_us / p.host_off_us - 1):.2f}% "
        f"(median of {len(ratios)} block pairs "
        f"{100 * (statistics.median(ratios) - 1):.2f}%); scratch "
        f"{p.scratch_mib:g} MiB a job; {p.dropped} spans dropped")
    q = len(window) // 4
    lines.append(
        "program: host us a job, medians: the window's quarters "
        f"{_medians_us(window[i * q:(i + 1) * q] for i in range(4))}; "
        f"the sub-window's blocks off {_medians_us(b[0] for b in blocks)}, "
        f"on {_medians_us(b[1] for b in blocks)}")
    lines.append("program: spans a job (count x mean us, self us): "
                 + ", ".join(f"{name} {c / n:g} x {t / c / 1e3:.2f} "
                             f"({o / c / 1e3:.2f})"
                             for name, (c, t, o) in by_name(spans, own)))
    for line in lines:
        print(line, file=sys.stderr)
    return p


def _medians_us(groups) -> list:
    return [round(1e6 * statistics.median(g), 1) for g in groups if g]


class _Profiled(Tracer):
    """The benchmark's profiler session, keeping the raw events too."""

    def stop(self):
        trace = super().stop()
        cuda = torch.autograd.DeviceType.CUDA
        self.raw = [(e.name(), e.device_type() == cuda, e.start_ns(),
                     e.end_ns(), (e.correlation_id(),
                                  e.linked_correlation_id()))
                    for e in self.prof.profiler.kineto_results.events()]
        return trace


def _profiled(run, pool, n, tracing, keys) -> list:
    """Sub-window 1: the idle gaps split by program span, the kernels put
    down to launch spans, and the device time by launch and level."""
    labels = ["dwt call", "idwt call", run.wait_label]
    tracer = _Profiled(labels)
    run._sync()
    tracing.take()
    tracing.enable()
    tracer.start()
    try:
        _jobs(run, pool, n, tracer.span)
    finally:
        tracing.disable()
        trace = tracer.stop()
    taken = tracing.take()
    base = min(r[2] for r in tracer.raw)
    sec = lambda ns: (ns - base) * 1e-9      # noqa: E731
    shift = taken["offset_ns"]
    spans = taken["spans"]
    prog = [(s.name, sec(s.start + shift), sec(s.end + shift)) for s in spans]
    bench = [(name, sec(s), sec(e)) for name, card, s, e, _ in tracer.raw
             if name in labels and not card]
    device = [(name, sec(s), sec(e)) for name, card, s, e, _ in tracer.raw
              if card and name not in labels]
    gaps = split_gaps(device, bench, innermost(prog))
    total = sum(gaps.values())
    inside = sum(v for k, v in gaps.items() if " / " in k)
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    lines = [f"program: profiled sub-window of {n} jobs; idle {total:.6f} s, "
             f"{100 * inside / total if total else 0:.1f}% under program "
             f"spans; idle gaps {[[k, round(v, 6)] for k, v in top]}; "
             f"benchmark span totals as trace.reduce: "
             f"{ {k: round(v, 6) for k, v in trace.gaps.items()} }"]
    # the clock: each program root inside its benchmark span
    roots = [p for p, s in zip(prog, spans) if s.parent < 0]
    order = sorted(bench, key=lambda b: b[1])
    starts = [b[1] for b in order]
    worst, fit = 0.0, 0
    for _, s, e in roots:
        i = bisect.bisect_right(starts, (s + e) / 2) - 1
        if i >= 0:
            over = max(order[i][1] - s, e - order[i][2], 0.0)
            worst = max(worst, over)
            fit += over <= 20e-6
    lines.append(f"program: clock: {fit} of {len(roots)} root spans inside "
                 f"their benchmark span within 20 us; worst overhang "
                 f"{worst * 1e6:.1f} us")
    # kernels to launch spans
    runtime = {c: sec(s) for name, card, s, _, ids in tracer.raw
               if not card and name.startswith("cu") for c in ids if c}
    kernels = [(name, sec(s), sec(e),
                next((c for c in ids if c in runtime), None))
               for name, card, s, e, ids in tracer.raw
               if card and not name.startswith(("Memcpy", "Memset"))
               and not is_library(name) and name not in labels]
    launch_idx = [(i, p[1], p[2]) for i, (p, s) in enumerate(zip(prog, spans))
                  if s.name in keys]
    claimed, unclaimed = attribute(kernels, runtime, launch_idx)
    empty = [spans[i].name for i, _, _ in launch_idx if i not in claimed]
    many = sum(len(v) > 1 for v in claimed.values())
    lines.append(f"program: {len(kernels)} program kernels, "
                 f"{len(kernels) - len(unclaimed)} claimed by launch spans, "
                 f"{len(unclaimed)} unclaimed "
                 f"{sorted({short_name(k[0]) for k in unclaimed})}; "
                 f"{len(empty)} of {len(launch_idx)} launch spans with no "
                 f"kernel {sorted(set(empty))}, {many} with more than one")
    labels_of = level_labels(spans, keys)
    per = defaultdict(float)
    for i, ks in claimed.items():
        per[(spans[i].name, labels_of.get(i, "?"))] += sum(e - s for _, s, e, _
                                                           in ks)
    lines.append("program: device us a job by (launch, level): "
                 + ", ".join(f"{key} {lv}: {1e6 * v / n:.2f}"
                             for (key, lv), v in sorted(per.items())))
    return lines
