"""The port's spans and counters.

Spans: ``with tracing.span(name, tag):`` at each layer boundary of a call.
The public calls of ``transforms.py`` open the root spans (``dwt``,
``idwt``, ...), the drivers one span each (``pyramid2d.dwt2``, ...), and
every launch wrapper of ``ops/`` one span named as its ``LAUNCHES`` key
(:func:`ops.build.run`), with one child ``<key>.call`` around the call
into the kernels' library (:meth:`ops.build.Plan.call`).  Tracing is off
at import; :func:`enable` and :func:`disable` switch it.  Off,
:func:`span` makes one global check and hands back a shared context that
does nothing.  On, each span is kept in memory, up to a bound (beyond it
spans are counted as dropped), until :func:`take` hands them over and
clears them.

A span is its ``name``, a small integer ``tag`` (the levels of a public
call or a driver, a launch's level where the caller has it, else -1), its
``start`` and ``end`` from ``time.perf_counter_ns()``, the index of its
``parent`` in the list :func:`take` returns (-1 for a root) and the index
of its ``root``, the public call that caused it.  ``take()["offset_ns"]``
maps a stamp onto the Unix-epoch clock of the profiler's host events
(``stamp + offset_ns``).

Counters are the ops modules' dicts, incremented whether tracing is on or
not: ``LAUNCHES`` (raised by :meth:`ops.build.Plan.launch`) and
``PLAIN_CALLS`` of each launch wrapper's module, ``scratch.ALLOCATED``
(bytes the drivers' scratch buffers took),
``parallel.sharded.STATS``, ``parallel.mesh.COPIES``, ``build.PLANS``
(the launch plans' hits and misses, :class:`ops.build.Plan`) and
``pyramid2d.GRAPHS`` (the 2-D driver's CUDA calls by how they ran:
graph captures, replays, refused captures, and calls through the
wrappers; ops/graph.py).  A replay runs inside the driver's child span
``pyramid2d.replay``.
:func:`counters` reads them all at once.

Spans are recorded for the thread that calls; the port's calls are made
from one thread.
"""

from __future__ import annotations

import importlib
import time
from typing import NamedTuple

__all__ = ["Span", "span", "enable", "disable", "enabled", "take",
           "self_ns", "counters", "COUNTERS", "LIMIT"]

# the most spans kept between two take()s; more are counted as dropped
LIMIT = 1 << 20

# module (under wavelets_tpu_torch) -> its counter dicts
COUNTERS = {
    "ops.level2d": ("LAUNCHES", "PLAIN_CALLS"),
    "ops.tail2d": ("LAUNCHES", "PLAIN_CALLS"),
    "ops.stage2d": ("LAUNCHES", "PLAIN_CALLS"),
    "ops.level1d": ("LAUNCHES", "PLAIN_CALLS"),
    "ops.tail1d": ("LAUNCHES", "PLAIN_CALLS"),
    "ops.axis0": ("LAUNCHES", "PLAIN_CALLS"),
    "ops.level3d": ("LAUNCHES", "PLAIN_CALLS"),
    "ops.modwt1d": ("LAUNCHES", "PLAIN_CALLS"),
    "ops.scratch": ("ALLOCATED",),
    "parallel.sharded": ("STATS",),
    "parallel.mesh": ("COPIES",),
    "ops.build": ("PLANS",),
    "ops.pyramid2d": ("GRAPHS",),
}


class Span(NamedTuple):
    name: str
    tag: int
    start: int
    end: int
    parent: int
    root: int


class _Nothing:
    """The context :func:`span` hands back while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


class _Close:
    """The context of a recorded span: stamps the end of the innermost open
    span when it exits."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        i = _stack.pop()
        if i >= 0:
            _ends[i] = _clock()
        return None


_NOTHING, _CLOSE = _Nothing(), _Close()
_clock = time.perf_counter_ns
_on = False
# the spans, one field a list (no object a span, so nothing for the
# garbage collector to walk)
_names: list = []
_tags: list = []
_starts: list = []
_ends: list = []
_parents: list = []
_stack: list = []     # open spans: an index, or -2 - parent for a dropped one
_dropped = 0
_offset_ns = 0


def span(name: str, tag: int = -1):
    """A context recording the span ``name`` while tracing is on."""
    global _dropped
    if not _on:
        return _NOTHING
    parent = -1
    if _stack:
        parent = _stack[-1]
        if parent < 0:
            parent = -2 - parent
    i = len(_names)
    if i >= LIMIT:
        _dropped += 1
        _stack.append(-2 - parent)
        return _CLOSE
    _names.append(name)
    _tags.append(tag)
    _parents.append(parent)
    _ends.append(0)
    _stack.append(i)
    _starts.append(_clock())
    return _CLOSE


def _epoch_offset(pairs: int = 9) -> int:
    """``time.time_ns() - time.perf_counter_ns()`` from the tightest of
    ``pairs`` bracketed reads."""
    best = None
    for _ in range(pairs):
        a = time.perf_counter_ns()
        e = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, e - (a + b) // 2)
    return best[1]


def enable() -> None:
    """Start recording spans (at most :data:`LIMIT` until the next
    :func:`take`)."""
    global _on, _offset_ns
    _offset_ns = _epoch_offset()
    _on = True


def disable() -> None:
    """Stop recording spans; those recorded stay until :func:`take`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def take() -> dict:
    """Hand over the recorded spans and clear them: ``{"spans": [Span],
    "dropped": count, "offset_ns": stamp -> Unix-epoch ns}``.  Call it
    outside every span."""
    global _dropped
    if _stack:
        raise RuntimeError(f"take() inside {len(_stack)} open span(s)")
    roots = []
    for i, parent in enumerate(_parents):      # a parent precedes its child
        roots.append(i if parent < 0 else roots[parent])
    fields = (_names, _tags, _starts, _ends, _parents)
    out = {"spans": list(map(Span, *fields, roots)), "dropped": _dropped,
           "offset_ns": _offset_ns}
    for f in fields:
        f.clear()
    _dropped = 0
    return out


def self_ns(spans) -> list:
    """Each span's duration less the time its children cover (children
    follow one another inside their parent), in ns, in the spans' order."""
    own = [s.end - s.start for s in spans]
    for s in spans:
        if s.parent >= 0:
            own[s.parent] -= s.end - s.start
    return own


def counters() -> dict:
    """One reading of every counter of :data:`COUNTERS`, keyed
    ``<module>.<dict>.<key>`` (``level2d.LAUNCHES.level_fw``,
    ``scratch.ALLOCATED.bytes``)."""
    out = {}
    for module, names in COUNTERS.items():
        mod = importlib.import_module(f"{__package__}.{module}")
        short = module.rsplit(".", 1)[-1]
        for name in names:
            for key, n in getattr(mod, name).items():
                out[f"{short}.{name}.{key}"] = n
    return out
