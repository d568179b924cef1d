"""One run of one cell: set-up, the measured window, and the judgement.

A job is one ``wavelets_tpu_torch.dwt`` and one ``idwt`` of its output,
called as users call them (the wavelet carrier, ``L`` and the family's
transformed axes ``ndt`` given, the default route).  The inputs are a
pool of distinct arrays made on the device from the seed; job k takes
input ``k mod pool``.  The loop is closed: it keeps
``in_flight`` jobs enqueued and waits for the oldest before it enqueues
the next.  A job's latency runs from the host starting its first call (an
event recorded on an idle side stream) to an event recorded after its last
launch, both on the device's clock.

The outputs of ``check_jobs`` jobs, drawn from the seed by reservoir
sampling over all jobs of the window, are kept and judged after the window
by the float64 reference of the configuration's family: the forward
coefficients band by band, and the inverse's output by its exact forward
transform, band by band, against the program's coefficients.  The kept
outputs are the harness's, not the library's: the memory peak is taken
from the moment the reservoir is full, and ``kept_bytes`` says what it
holds.

A job's outputs go to blocks that the caching allocator freed when an
earlier job retired, so a launch that leaves its output unwritten hands
back that earlier job's answer.  A cell's ``pool`` therefore never
divides its ``in_flight``: job k takes the blocks of job k - in_flight,
whose input differs, and such a launch fails the judgement.

On a CPU device the same loop runs the kernels' plain versions, with host
stamps in place of events: the tests rehearse it so.  ``run.py`` refuses
to run without a card, so no number from a CPU run is reported.
"""

from __future__ import annotations

import hashlib
import math
import random
import sys
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field

import torch

from . import spec
from .trace import Tracer

__all__ = ["Run", "Record", "input_seed", "make_input"]


def input_seed(seed: int, i: int) -> int:
    """The generator seed of pool input ``i`` of run ``seed`` (63 bits)."""
    digest = hashlib.sha256(f"{seed}:{i}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_input(seed: int, i: int, shape, device) -> torch.Tensor:
    """Pool input ``i``: standard normal float32 samples, made on
    ``device`` by one generator call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(input_seed(seed, i))
    return torch.randn(tuple(shape), generator=gen, device=device,
                       dtype=torch.float32)


class _Stamps:
    """Device-clock stamps (CUDA events) or, on the CPU, host stamps."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.side = torch.cuda.Stream(device) if self.cuda else None

    def now(self, side: bool = False):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.side if side else None)
        return ev

    def wait(self, stamp) -> None:
        if self.cuda:
            stamp.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


@dataclass
class _Job:
    k: int
    start: object
    end: object
    out: tuple


class _Reservoir:
    """A uniform sample of ``size`` jobs out of all offered, drawn by
    ``rng`` (reservoir sampling); what it drops is freed."""

    def __init__(self, size: int, rng: random.Random):
        self.size, self.rng, self.slots = size, rng, []

    def full(self) -> bool:
        return len(self.slots) >= self.size

    def nbytes(self) -> int:
        """The bytes of the kept tensors, each storage once, as the caching
        allocator counts them (in blocks of 512)."""
        seen = {}
        for _, item in self.slots:
            for t in item or ():
                st = t.untyped_storage()
                seen[st.data_ptr()] = -(-st.nbytes() // 512) * 512
        return sum(seen.values())

    def offer(self, k: int, item) -> None:
        if len(self.slots) < self.size:
            self.slots.append((k, item))
        else:
            j = self.rng.randrange(k + 1)
            if j < self.size:
                self.slots[j] = (k, item)


@dataclass
class Record:
    """What the metric readers read.  Window: ``seconds`` (host clock, from
    the first job's start to the last job's end), ``jobs``,
    ``samples_per_job``, ``latency_ms`` (every job), ``host_s`` (each
    job's two calls, enqueue only), ``peak_bytes`` (from the moment the
    reservoir of kept jobs is full), ``kept_bytes`` (what it holds),
    ``setup_s``.  Traced
    runs add ``trace`` (a :class:`trace.Trace` of the sub-window),
    ``trace_jobs``, ``launches`` (the program's launch counters' rise
    over the sub-window), ``host_s_untraced`` (the jobs outside it),
    ``untraced_s`` (the window's host seconds outside it, the profiler's
    start and stop excluded),
    ``work`` (least bytes and operations of one job) and ``peaks`` (the
    device's published peaks, or None)."""
    seconds: float = 0.0
    jobs: int = 0
    samples_per_job: int = 0
    latency_ms: list = field(default_factory=list)
    host_s: list = field(default_factory=list)
    peak_bytes: int = 0
    kept_bytes: int = 0
    setup_s: float | None = None
    trace: object = None
    trace_jobs: int = 0
    launches: dict = field(default_factory=dict)
    host_s_untraced: list = field(default_factory=list)
    untraced_s: float = 0.0
    work: tuple = (0.0, 0.0)
    peaks: dict | None = None


def launch_counts() -> dict:
    """The program's launch counters (every ``LAUNCHES`` of its ops
    modules), by module and kernel entry."""
    out = {}
    for name, mod in list(sys.modules.items()):
        counts = getattr(mod, "LAUNCHES", None)
        if name.startswith("wavelets_tpu_torch.ops.") and counts:
            for key, n in counts.items():
                out[f"{name.rsplit('.', 1)[-1]}.{key}"] = n
    return out


class Run:
    """One run of ``cell`` on ``device``: :meth:`setup`, :meth:`window`,
    :meth:`judge`.  ``dtype`` overrides the configuration's (the control
    runs the program's bfloat16 path)."""

    def __init__(self, cell: spec.Cell, seed: int, device, dtype=None,
                 tracing: bool = False, export: str | None = None):
        cfg, traffic = cell.config, cell.traffic
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.dtype = getattr(torch, dtype or cfg["dtype"])
        self.tracing, self.export = tracing, export
        self.ref = spec.module("reference", cfg["family"], cell.root)
        self.work = spec.module("work", cfg["family"], cell.root)
        self.sch = self.ref.scheme(cfg["wavelet"])
        self.shape = tuple(traffic["shape"])
        self.L = traffic["levels"]
        self.in_flight = traffic["in_flight"]
        if self.in_flight % traffic["pool"] == 0:
            raise ValueError(
                f"cell {cell.name}: a pool of {traffic['pool']} divides "
                f"{self.in_flight} jobs in flight, so a job would reuse the "
                f"blocks of a job of the same input")
        self.wait_label = f"waiting for job k-{self.in_flight}"
        self.stamps = _Stamps(self.device)
        self.kept = _Reservoir(traffic["check_jobs"], random.Random(seed))
        self.pool = None

    # --- set-up ------------------------------------------------------------

    def setup(self) -> None:
        """Load the program (on a card, its kernels' library, built at the
        first use in a checkout), make the pool, and warm up every shape
        the window uses, holding as many jobs' outputs at once as the
        window does, so that the window finds them in the allocator's
        cache.  ``phases`` keeps the seconds of each step."""
        t = time.perf_counter()
        import wavelets_tpu_torch as wtt
        from wavelets_tpu_torch.ops import build
        cfg, traffic = self.cell.config, self.cell.traffic
        self.dwt, self.idwt = wtt.dwt, wtt.idwt
        self.wt = wtt.wavelet(getattr(wtt.wt, cfg["wavelet"]), cfg["engine"],
                              cfg["boundary"])
        if self.device.type == "cuda":
            build.library()
        self.phases = {"program": time.perf_counter() - t}
        t = time.perf_counter()
        self.pool = [make_input(self.seed, i, self.shape, self.device)
                     .to(self.dtype) for i in range(traffic["pool"])]
        self._sync()
        self.phases["pool"] = time.perf_counter() - t
        t = time.perf_counter()
        held = [self._job(self.pool[i % len(self.pool)])
                for i in range(self.in_flight + traffic["check_jobs"] + 1)]
        self._sync()
        del held
        self.phases["warm-up"] = time.perf_counter() - t

    def _job(self, x, span=None):
        span = span or (lambda _: nullcontext())
        with span("dwt call"):
            y = self.dwt(x, self.wt, self.L, ndt=self.ref.NDT)
        with span("idwt call"):
            xr = self.idwt(y, self.wt, self.L, ndt=self.ref.NDT)
        return y, xr

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- the window ----------------------------------------------------------

    def window(self, seconds: float) -> Record:
        """Run jobs for ``seconds`` of host time, then finish those in
        flight.  A traced run profiles ``trace_jobs`` jobs from a quarter
        of the window on, in one session, with the card drained at both
        ends of it."""
        rec = Record(samples_per_job=self.pool[0].numel())
        pending = deque()
        P, F = len(self.pool), self.in_flight
        trace_at = seconds / 4 if self.tracing else float("inf")
        tracer, k_first, counts0, traced_s = None, None, None, 0.0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self._sync()
        t0 = time.perf_counter()
        k = 0
        while True:
            now = time.perf_counter() - t0
            if tracer is None and k_first is None and now >= trace_at:
                self._drain(pending, rec)
                traced_from = time.perf_counter()
                tracer = Tracer(["dwt call", "idwt call", self.wait_label],
                                self.export)
                k_first, counts0 = k, launch_counts()
                tracer.start()
            elif tracer is not None and k - k_first >= \
                    self.cell.traffic["trace_jobs"]:
                self._drain(pending, rec)
                rec.trace = tracer.stop()
                rec.trace_jobs = k - k_first
                counts1 = launch_counts()
                rec.launches = {key: n - counts0.get(key, 0)
                                for key, n in counts1.items()
                                if n != counts0.get(key, 0)}
                tracer = None
                traced_s = time.perf_counter() - traced_from
            if now >= seconds and tracer is None:
                break
            span = tracer.span if tracer else None
            if len(pending) == F:
                with (span(self.wait_label) if span else nullcontext()):
                    self._retire(pending.popleft(), rec)
            start = self.stamps.now(side=True)
            ta = time.perf_counter()
            out = self._job(self.pool[k % P], span)
            rec.host_s.append(time.perf_counter() - ta)
            pending.append(_Job(k, start, self.stamps.now(), out))
            k += 1
        self._drain(pending, rec)
        rec.seconds = time.perf_counter() - t0
        rec.jobs = k
        if self.device.type == "cuda":
            rec.peak_bytes = torch.cuda.max_memory_allocated(self.device)
        rec.kept_bytes = self.kept.nbytes()
        if rec.trace is not None:
            rec.untraced_s = rec.seconds - traced_s
            inside = range(k_first, k_first + rec.trace_jobs)
            rec.host_s_untraced = [h for j, h in enumerate(rec.host_s)
                                   if j not in inside]
        rec.work = self.work.job(self.shape, self.L,
                                 self.pool[0].element_size(), self.sch)
        self.pool = None
        return rec

    def _retire(self, job: _Job, rec: Record) -> None:
        self.stamps.wait(job.end)
        rec.latency_ms.append(self.stamps.ms(job.start, job.end))
        full = self.kept.full()
        self.kept.offer(job.k, job.out)
        if not full and self.kept.full() and self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def _drain(self, pending, rec: Record) -> None:
        while pending:
            self._retire(pending.popleft(), rec)

    # --- the judgement -------------------------------------------------------

    def judge(self, limits: dict) -> dict:
        """Judge the kept jobs against the float64 reference.  Returns
        ``{"judged", "failed", "checks": {name: (worst value, limit,
        where)}}``; a value above its limit, or not a number, fails."""
        worst = {name: (0.0, "") for name in limits}
        failed = 0
        bands = self.ref.regions(self.shape, self.L)
        kept = sorted(self.kept.slots, key=lambda s: s[0])
        self.kept.slots = []
        for k, (y, xr) in kept:
            x = make_input(self.seed, k % self.cell.traffic["pool"],
                           self.shape, self.device)
            found = {"fw_err": _by_band(y, self.ref.dwt(x, self.sch, self.L),
                                        bands)}
            del x
            found["inv_err"] = _by_band(self.ref.dwt(xr, self.sch, self.L), y,
                                        bands)
            bad = False
            for name, (value, where) in found.items():
                if not value <= limits[name]:
                    bad = True
                if _worse(value, worst[name][0]):
                    worst[name] = (value, f"job {k}, {where}")
            failed += bad
        return {"judged": len(kept), "failed": failed,
                "checks": {name: (v, limits[name], where)
                           for name, (v, where) in worst.items()}}


def _by_band(got, want, bands) -> tuple[float, str]:
    """The worst band's ``max |got - want|`` over the largest ``|want|`` of
    its level's scope, in float64, and the band's label."""
    worst, where, scales = 0.0, "", {}
    for label, idx, scope in bands:
        if label not in scales:
            scales[label] = want[scope].abs().max().item()
        err = (got[idx].to(torch.float64)
               - want[idx].to(torch.float64)).abs().max().item()
        scale = scales[label]
        rel = err / scale if scale > 0 else (0.0 if err == 0 else
                                             float("inf"))
        if _worse(rel, worst):
            worst, where = rel, label
    return worst, where


def _worse(value: float, than: float) -> bool:
    """Whether ``value`` is worse than ``than``: larger, or a NaN where
    ``than`` is none."""
    return (math.isnan(value) and not math.isnan(than)) or value > than
