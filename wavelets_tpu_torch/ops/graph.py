"""CUDA graphs of a driver's launch chain, one per call signature.

The launch wrappers' plans (ops/build.py) leave each launch of a known
signature little more than its pointers to fill in; what a driver call
still does in Python is the chain itself: the level views, a plan lookup
and a ctypes call per launch.  A :class:`Store` records that chain once as
a CUDA graph and later sends it whole:

1. The first call of a signature runs the chain through the wrappers,
   which build their plans and tables; the store notes the order in which
   the chain took its scratch buffers.
2. The second takes its scratch buffers first, in that order, and
   captures the chain on a private stream (``cudaStreamBeginCapture``,
   thread-local mode: the legacy default stream cannot be captured, and
   the chain reads the current stream).  Each kernel node's argument
   block comes back from the library, and :func:`patch_table` finds the
   words that point into the call's buffers (input, output, scratch 0
   and 1).  A word that points at other device memory, unless into a
   table of a plan the chain used (which the entry then holds), refuses
   the capture: the signature runs the wrappers for good.  The graph is
   instantiated and launched once on the caller's stream, for this call.
3. A later call allocates its output and scratch exactly as the chain
   would and makes one call into the library (``wtt_graph_replay``),
   which writes the moved words of each node, hands them to
   ``cudaGraphExecKernelNodeSetParams`` and launches the graph on the
   current stream.  That update applies to later launches only, not to
   those in flight, which is what lets jobs overlap.  It raises each
   kernel's ``LAUNCHES`` counter (``build.COUNTED``) by what the graph
   ran.

A call on a stream under capture (a caller's own ``torch.cuda.graph``)
runs the wrappers, so the caller's capture records them as before.  At
most ``limit`` signatures are kept, the least recently used dropped
first; a dropped graph, and the tables it reads, are freed once the event
recorded after its last launch has completed.  A store is used from one
thread, as the port's calls are.
"""

from __future__ import annotations

import ctypes
import itertools

import torch

from .. import tracing
from . import build

__all__ = ["Store", "Refused", "signature", "patch_table", "rebase",
           "GRAPH_LIMIT", "CAPTURING", "MISALIGNED"]

GRAPH_LIMIT = 64          # signatures kept; the least recently used goes
# statuses of csrc/graph.cu that are not CUDA errors
CAPTURING, MISALIGNED = -1, -2
_BLOCK = 1 << 15          # the largest argument block of a kernel (32 KiB)


class Refused(Exception):
    """A capture whose graph could not be replayed safely."""


def signature(name, wt, x, *parts):
    """A driver call's key: ``name`` (the direction), the wavelet's token,
    ``parts`` (route, levels) and the input's shape, strides, dtype and
    device (:func:`build.key`), and its address mod 16, from which the
    kernels choose their staging path.  The output and scratch come fresh
    from the caching allocator, aligned to 512 bytes."""
    return build.key(name, wt, *parts, x, x.data_ptr() & 15)


def _inside(ranges, word):
    for i, (base, size) in enumerate(ranges):
        if base <= word < base + size:
            return i
    return None


def patch_table(blocks, buffers, held, is_device):
    """The patch table of a captured chain: ``(node, offset, buffer,
    delta)`` for each 8-byte word, at an 8-byte ``offset`` of node
    ``node``'s argument block (``blocks``: bytes), whose value lies in
    ``buffers[buffer]`` (``(base, size)`` byte ranges), ``delta`` bytes
    past its base.  Raises :class:`Refused` where another word is an
    address of device memory (``is_device(words)``: a flag a word)
    outside every range of ``held``."""
    patches, others = [], []
    for node, block in enumerate(blocks):
        for offset in range(0, len(block) - 7, 8):
            word = int.from_bytes(block[offset:offset + 8], "little")
            b = _inside(buffers, word)
            if b is not None:
                patches.append((node, offset, b, word - buffers[b][0]))
            elif word and _inside(held, word) is None:
                others.append(word)
    if others and any(is_device(others)):
        raise Refused("a kernel argument points at device memory outside "
                      "the call's buffers and the plans' tables")
    return patches


def rebase(blocks, patches, bases):
    """The argument blocks with each patched word rewritten for buffers at
    ``bases``: the words ``wtt_graph_replay`` hands the graph."""
    out = [bytearray(b) for b in blocks]
    for node, offset, b, delta in patches:
        out[node][offset:offset + 8] = (bases[b] + delta).to_bytes(8, "little")
    return out


def _tensors(obj):
    """The tensors in ``obj``: a tensor, or tuples and lists of them (a
    plan's ``keep``)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)


class _Entry:
    """One signature: the scratch buffers' order; once captured its graph
    (the library's handle), the ``bases`` array of its buffers' addresses,
    the ``counts`` its launches add and the tables it reads (``keep``);
    once refused, why (``refused``)."""
    __slots__ = ("order", "graph", "refused", "bases", "counts", "keep",
                 "used")

    def __init__(self, order):
        self.order, self.graph, self.refused = tuple(order), None, None
        self.bases, self.counts, self.keep, self.used = None, (), (), 0


class Store:
    """The graphs of one driver's signatures.  ``counter`` is the driver's
    ``GRAPHS`` dict: ``captures`` (calls that captured their graph),
    ``replays``, ``fallbacks`` (calls whose capture was refused; they ran
    the wrappers) and ``plain`` (every other CUDA call: a signature's
    first, a refused signature's, one on a stream under capture, and
    those the driver sends past the store).  ``span`` names the span
    around a replay."""

    def __init__(self, counter, span, limit=GRAPH_LIMIT):
        self.counter, self.span, self.limit = counter, span, limit
        self.entries: dict = {}
        self.retired: list = []    # dropped entries whose graph may run
        self.clock = itertools.count()
        self.streams: dict = {}    # device index -> the capture stream

    def run(self, key, chain, x, out, scratch):
        """Make a driver call's launches: ``chain()`` through the wrappers,
        or the graph of ``key`` (the call's :func:`signature`; None runs
        the chain) for input ``x``, output ``out`` and ``scratch`` (an
        ops/scratch.py ``Scratch``)."""
        entry = None if key is None else self.entries.get(key)
        if entry is not None:
            entry.used = next(self.clock)
            if entry.graph is not None:
                if self._replay(entry, x, out, scratch):
                    return
            elif entry.refused is None \
                    and not torch.cuda.is_current_stream_capturing():
                self._capture(entry, chain, x, out, scratch)
                return
        chain()
        self.counter["plain"] += 1
        if key is not None and entry is None:
            self._keep(key, _Entry(scratch.order))

    def _keep(self, key, entry):
        entry.used = next(self.clock)
        self.entries[key] = entry
        if len(self.entries) > self.limit:
            old = min(self.entries, key=lambda k: self.entries[k].used)
            dropped = self.entries.pop(old)
            if dropped.graph is not None:
                self.retired.append(dropped)
        if self.retired:
            free = build.library().wtt_graph_free
            self.retired = [e for e in self.retired if free(e.graph)]

    @staticmethod
    def _buffers(entry, x, out, scratch):
        """The call's buffers, the scratch taken in the chain's order."""
        for i in entry.order:
            scratch.buffer(i)
        return (x, out, *scratch.bufs)

    def _launch(self, entry, bufs, device) -> bool:
        """Launch ``entry``'s graph for ``bufs`` on the device's current
        stream; False where the library launched nothing (a stream under
        capture)."""
        entry.bases[:] = [0 if t is None else t.data_ptr() for t in bufs]
        with tracing.span(self.span):
            if build._current_device() == device:
                status = build.library().wtt_graph_replay(
                    entry.graph, entry.bases, build._raw_stream(device))
            else:
                with torch.cuda.device(device):
                    status = build.library().wtt_graph_replay(
                        entry.graph, entry.bases, build._raw_stream(device))
        if status in (CAPTURING, MISALIGNED):
            return False
        build.check(status, "graph_replay")
        for counts, k, n in entry.counts:
            counts[k] += n
        return True

    def _replay(self, entry, x, out, scratch) -> bool:
        if not self._launch(entry, self._buffers(entry, x, out, scratch),
                            x.device.index):
            return False
        self.counter["replays"] += 1
        return True

    def _capture(self, entry, chain, x, out, scratch):
        """The second call of a signature: capture, check, instantiate and
        launch the graph; a refused capture marks the signature and runs
        the chain."""
        bufs = self._buffers(entry, x, out, scratch)
        try:
            with torch.cuda.device(x.device):
                entry.graph, entry.counts, entry.keep = self._record(chain,
                                                                     bufs)
        except Refused as e:
            entry.refused = str(e)
            self.counter["fallbacks"] += 1
            chain()
            return
        entry.bases = (ctypes.c_uint64 * len(bufs))()
        if not self._launch(entry, bufs, x.device.index):
            raise RuntimeError("graph_replay: a new graph did not launch")
        self.counter["captures"] += 1

    def _record(self, chain, bufs):
        """Capture ``chain`` on the device's capture stream; returns the
        instantiated graph, the launch counts it adds and the tables it
        reads, or raises :class:`Refused`.  The launch counters are left
        as they were."""
        lib = build.library()
        device = torch.cuda.current_device()
        stream = self.streams.get(device)
        if stream is None:
            stream = self.streams[device] = torch.cuda.Stream(device)
        before = {k: d[k] for k, d in build.COUNTED.items()}
        mark = build.mark()
        status = lib.wtt_graph_begin(stream.cuda_stream)
        if status != 0:
            raise Refused(f"graph_begin: status {status}")
        try:
            with torch.cuda.stream(stream):
                chain()
        except RuntimeError as e:   # a CUDA call the capture does not take
            lib.wtt_graph_abort(stream.cuda_stream)
            _restore(before)
            raise Refused(str(e)) from e
        handle, nodes = ctypes.c_void_p(), ctypes.c_int()
        status = lib.wtt_graph_end(stream.cuda_stream, ctypes.byref(handle),
                                   ctypes.byref(nodes))
        counts = tuple((d, k, d[k] - before[k])
                       for k, d in build.COUNTED.items() if d[k] != before[k])
        _restore(before)
        if status != 0:
            raise Refused(f"graph_end: status {status}")
        try:
            keep = tuple(p.keep for p in build.used_since(mark))
            held = [build.extent(t) for t in _tensors(keep)]
            ranges = [build.extent(t) for t in bufs]
            block = ctypes.create_string_buffer(_BLOCK)
            blocks = []
            for i in range(nodes.value):
                size = lib.wtt_graph_block(handle, i, block, _BLOCK)
                if not 0 <= size <= _BLOCK:
                    raise Refused(f"argument block of {size} bytes")
                blocks.append(block.raw[:size])
            patches = patch_table(blocks, ranges, held, _device_words)
            rows = (ctypes.c_int64 * (4 * len(patches) or 1))(
                *itertools.chain.from_iterable(patches))
            bases = (ctypes.c_uint64 * len(ranges))(*[r[0] for r in ranges])
            status = lib.wtt_graph_instantiate(handle, rows, len(patches),
                                               bases, len(ranges))
            if status != 0:
                raise Refused(f"graph_instantiate: status {status}")
        except Refused:
            lib.wtt_graph_free(handle)
            raise
        return handle, counts, keep


def _restore(before):
    for k, n in before.items():
        build.COUNTED[k][k] = n


def _device_words(words):
    """Which of ``words`` are addresses of device memory (the library
    asks the runtime)."""
    n = len(words)
    flags = (ctypes.c_uint8 * n)()
    build.check(build.library().wtt_device_pointers(
        (ctypes.c_uint64 * n)(*words), n, flags), "device_pointers")
    return [bool(f) for f in flags]
