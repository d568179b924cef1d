"""The 2-D driver's CUDA graphs (ops/graph.py) on the CPU.

A CPU tensor never reaches the graph path, so these tests drive its pure
parts with stand-in buffers and argument blocks: the signature key, the
patch table (which words of a captured launch point into the call's
buffers, and which capture is refused), the rewriting of those words for
new buffers, and the store (a signature's first call runs the wrappers,
its second captures, later ones replay; the LRU bound; a dropped graph's
tables held until its last launch has run) against a stand-in for the
kernels' library that records what it is handed.  Last, the driver's
calls that must never reach the store.
"""

import ctypes
import struct
import weakref
from contextlib import nullcontext
from types import SimpleNamespace

import pytest
import torch

import wavelets_tpu_torch as T
from wavelets_tpu_torch.ops import build, graph, level2d, pyramid2d, scratch
from wavelets_tpu_torch.ops.scratch import Scratch

CDF97 = T.wavelet(T.wt.cdf97, "lifting")
HAAR = T.wavelet(T.wt.haar)


# --- the signature key -------------------------------------------------------

def _key(x, wt=CDF97, route="level", L=4, name="dwt2"):
    return graph.signature(name, wt, x, route, L)


def test_equal_calls_share_a_key():
    a, b = torch.randn(2, 64, 64), torch.randn(2, 64, 64)
    assert _key(a) == _key(b)
    assert hash(_key(a)) == hash(_key(b))


@pytest.mark.parametrize("change", [
    "shape", "strides", "dtype", "route", "levels", "wavelet", "direction",
    "alignment"])
def test_each_part_makes_a_new_key(change):
    x = torch.randn(2, 64, 64)
    other = {
        "shape": lambda: _key(torch.randn(2, 64, 32)),
        "strides": lambda: _key(torch.randn(2, 64, 128)[:, :, :64]),
        "dtype": lambda: _key(x.double()),
        "route": lambda: _key(x, route="split"),
        "levels": lambda: _key(x, L=3),
        "wavelet": lambda: _key(x, wt=HAAR),
        "direction": lambda: _key(x, name="idwt2"),
        # one element in: the kernels stage it on another path
        "alignment": lambda: _key(torch.randn(2 * 64 * 64 + 1)[1:]
                                  .view(2, 64, 64)),
    }[change]()
    assert other != _key(x)


# --- the patch table ---------------------------------------------------------

def _block(*words):
    return struct.pack(f"<{len(words)}Q", *words)


BUFFERS = [(0x10000, 0x1000), (0x20000, 0x800), (0x30000, 0x400), (0, 0)]
TABLE = (0x90000, 0x100)


def _never(words):
    return [False] * len(words)


def test_words_inside_a_call_buffer_map_to_buffer_and_offset():
    blocks = [_block(0x10000, 7 | 9 << 32, 0x20010),
              _block(0x30000 + 0x3f8),
              struct.pack("<ii", 3, 4) + _block(0x10ff8)]
    patches = graph.patch_table(blocks, BUFFERS, [TABLE], _never)
    assert patches == [(0, 0, 0, 0), (0, 16, 1, 0x10), (1, 0, 2, 0x3f8),
                       (2, 8, 0, 0xff8)]


def test_a_word_past_a_buffer_is_not_patched():
    blocks = [_block(0x11000, 0x20800, 0x30400)]
    assert graph.patch_table(blocks, BUFFERS, [], _never) == []


def test_a_device_pointer_outside_buffers_and_tables_refuses():
    def device(words):
        return [w >= 0x10000 for w in words]

    held_ok = [_block(0x10000, TABLE[0] + 8, 12)]
    assert graph.patch_table(held_ok, BUFFERS, [TABLE], device) == [
        (0, 0, 0, 0)]
    foreign = [_block(0x10000), _block(0x50000)]
    with pytest.raises(graph.Refused):
        graph.patch_table(foreign, BUFFERS, [TABLE], device)
    # the same word, not device memory (a pair of sizes), is left alone
    assert graph.patch_table(foreign, BUFFERS, [TABLE], _never) == [
        (0, 0, 0, 0)]


def test_rebase_writes_new_bases():
    blocks = [_block(0x10000, 5, 0x20010), _block(0x30008)]
    patches = graph.patch_table(blocks, BUFFERS, [], _never)
    same = graph.rebase(blocks, patches, [b for b, _ in BUFFERS])
    assert same == [bytearray(b) for b in blocks]
    moved = graph.rebase(blocks, patches, [0xa0000, 0xb0000, 0xc0000, 0])
    assert moved == [bytearray(_block(0xa0000, 5, 0xb0010)),
                     bytearray(_block(0xc0008))]


# --- the store, against a stand-in library ------------------------------------

def _ptr(v):
    return v.value if isinstance(v, ctypes.c_void_p) else v


class _Library:
    """A stand-in for the library's graph entries.  A capture keeps the
    argument blocks the test's chain records; the device memory is the
    tensors in ``memory``; a replay records its bases and the blocks
    :func:`graph.rebase` makes of them; a graph in ``running`` is not
    freed."""

    def __init__(self):
        self.recording, self.graphs, self.memory = None, {}, []
        self.replays, self.running, self.capturing = [], set(), False
        self.next = 1

    def wtt_graph_begin(self, stream):
        self.recording = []
        return 0

    def wtt_graph_abort(self, stream):
        self.recording = None
        return 0

    def wtt_graph_end(self, stream, handle, nodes):
        h, self.next = self.next, self.next + 1
        self.graphs[h] = {"blocks": self.recording}
        handle._obj.value, nodes._obj.value = h, len(self.recording)
        self.recording = None
        return 0

    def wtt_graph_block(self, handle, node, out, cap):
        block = self.graphs[_ptr(handle)]["blocks"][node]
        ctypes.memmove(out, block, len(block))
        return len(block)

    def wtt_device_pointers(self, words, n, flags):
        for i in range(n):
            flags[i] = any(t.data_ptr() <= words[i] < t.data_ptr() + t.nbytes
                           for t in self.memory)
        return 0

    def wtt_graph_instantiate(self, handle, rows, n, bases, nb):
        g = self.graphs[_ptr(handle)]
        g["patches"] = [tuple(rows[4 * i:4 * i + 4]) for i in range(n)]
        g["bases"] = list(bases[:nb])
        return 0

    def wtt_graph_replay(self, handle, bases, stream):
        if self.capturing:
            return graph.CAPTURING
        g = self.graphs[_ptr(handle)]
        self.replays.append((_ptr(handle), list(bases), graph.rebase(
            g["blocks"], g["patches"], list(bases))))
        return 0

    def wtt_graph_free(self, handle):
        h = _ptr(handle)
        if h in self.running:
            return 1
        del self.graphs[h]
        return 0


@pytest.fixture
def lib(monkeypatch):
    """The stand-in library, fresh plan cache and launch counter (level2d's
    ``LAUNCHES``, registered in ``build.COUNTED``, which the store reads),
    and the CUDA calls of the store answered for a CPU tensor."""
    stub = _Library()
    monkeypatch.setattr(build, "library", lambda: stub)
    monkeypatch.setattr(build, "_plans", {})
    monkeypatch.setattr(build, "_current_device", lambda: None)
    monkeypatch.setattr(build, "_raw_stream", lambda index: 77)
    counts = {"level_fw": 0, "level_inv": 0}
    monkeypatch.setattr(level2d, "LAUNCHES", counts)
    for k in counts:
        monkeypatch.setitem(build.COUNTED, k, counts)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: stub.capturing)
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda d: SimpleNamespace(cuda_stream=55))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return stub


class _Call:
    """One driver call of a signature: input, output and scratch, and a
    chain that takes scratch 1 then 0, counts two launches, looks up the
    plan that keeps ``table``, and records (while captured) or runs two
    argument blocks: one pointing into x, scratch 1 and the table, one
    into scratch 0 and the output; ``extra`` adds a word to the first."""

    def __init__(self, stub, table, shape=(1, 16, 16), extra=None):
        self.stub = stub
        self.x, self.out = torch.randn(shape), torch.empty(shape)
        self.scratch = Scratch(self.x, (64, 16))
        self.table, self.extra, self.ran = table, extra, 0
        stub.memory += [self.x, self.out, table]

    def chain(self):
        s1 = self.scratch.view(1, 16)
        s0 = self.scratch.view(0, 64)
        self.stub.memory += [s0, s1]
        build.planned("table")
        level2d.LAUNCHES["level_fw"] += 2
        words = [self.x.data_ptr() + 4, s1.data_ptr(), self.table.data_ptr(),
                 3 | 5 << 32] + ([self.extra] if self.extra else [])
        blocks = [_block(*words), _block(s0.data_ptr() + 8,
                                         self.out.data_ptr())]
        if self.stub.recording is not None:
            self.stub.recording.extend(blocks)
        else:
            self.ran += 1

    def run(self, store, key):
        store.run(key, self.chain, self.x, self.out, self.scratch)


def _plan(table):
    build._plans["table"] = SimpleNamespace(used=0, keep=(table, (3, 4)))


def test_first_call_runs_second_captures_then_replays(lib):
    counter = dict.fromkeys(pyramid2d.GRAPHS, 0)
    store = graph.Store(counter, "test.replay")
    table = torch.randn(8)
    _plan(table)
    allocated = scratch.ALLOCATED["bytes"]
    calls = [_Call(lib, table) for _ in range(4)]
    key = _key(calls[0].x)
    calls[0].run(store, key)
    first = scratch.ALLOCATED["bytes"] - allocated
    assert calls[0].ran == 1 and counter["plain"] == 1
    assert level2d.LAUNCHES["level_fw"] == 2
    calls[1].run(store, key)
    assert calls[1].ran == 0 and counter["captures"] == 1
    assert level2d.LAUNCHES["level_fw"] == 4   # the graph's first launch
    for c in calls[2:]:
        c.run(store, key)
    assert counter == {"captures": 1, "replays": 2, "fallbacks": 0,
                       "plain": 1}
    assert level2d.LAUNCHES["level_fw"] == 8
    assert scratch.ALLOCATED["bytes"] - allocated == 4 * first
    (h, captured), = lib.graphs.items()
    assert captured["patches"] == [(0, 0, 0, 4), (0, 8, 3, 0), (1, 0, 2, 8),
                                   (1, 8, 1, 0)]
    for c, (handle, bases, blocks) in zip(calls[1:], lib.replays):
        # scratch taken as the chain takes it: buffer 1, then 0
        assert c.scratch.order == [1, 0] and handle == h
        s0, s1 = c.scratch.bufs
        assert bases == [c.x.data_ptr(), c.out.data_ptr(), s0.data_ptr(),
                         s1.data_ptr()]
        assert blocks[0][:16] == _block(c.x.data_ptr() + 4, s1.data_ptr())
        assert blocks[0][16:24] == _block(table.data_ptr())
        assert blocks[1] == _block(s0.data_ptr() + 8, c.out.data_ptr())
    entry, = store.entries.values()
    assert entry.keep == ((table, (3, 4)),)


def test_a_foreign_device_pointer_refuses_for_good(lib):
    counter = dict.fromkeys(pyramid2d.GRAPHS, 0)
    store = graph.Store(counter, "test.replay")
    table, foreign = torch.randn(8), torch.randn(4)
    lib.memory.append(foreign)
    _plan(table)
    calls = [_Call(lib, table, extra=foreign.data_ptr()) for _ in range(4)]
    key = _key(calls[0].x)
    for c in calls:
        c.run(store, key)
    assert [c.ran for c in calls] == [1, 1, 1, 1]
    assert counter == {"captures": 0, "replays": 0, "fallbacks": 1,
                       "plain": 3}
    assert level2d.LAUNCHES["level_fw"] == 8
    assert not lib.graphs and not lib.replays
    assert "outside" in store.entries[key].refused


def test_an_unheld_table_refuses(lib):
    counter = dict.fromkeys(pyramid2d.GRAPHS, 0)
    store = graph.Store(counter, "test.replay")
    table = torch.randn(8)      # no plan keeps it
    calls = [_Call(lib, table) for _ in range(3)]
    key = _key(calls[0].x)
    for c in calls:
        c.run(store, key)
    assert counter["fallbacks"] == 1 and counter["captures"] == 0


def test_a_stream_under_capture_runs_the_wrappers(lib):
    counter = dict.fromkeys(pyramid2d.GRAPHS, 0)
    store = graph.Store(counter, "test.replay")
    table = torch.randn(8)
    _plan(table)
    calls = [_Call(lib, table) for _ in range(5)]
    key = _key(calls[0].x)
    lib.capturing = True
    calls[0].run(store, key)
    calls[1].run(store, key)          # no capture while one is under way
    lib.capturing = False
    calls[2].run(store, key)
    lib.capturing = True
    calls[3].run(store, key)          # the replay launches nothing
    lib.capturing = False
    calls[4].run(store, key)
    assert [c.ran for c in calls] == [1, 1, 0, 1, 0]
    assert counter == {"captures": 1, "replays": 1, "fallbacks": 0,
                       "plain": 3}
    assert level2d.LAUNCHES["level_fw"] == 10


def test_the_store_keeps_at_most_limit_signatures(lib):
    counter = dict.fromkeys(pyramid2d.GRAPHS, 0)
    store = graph.Store(counter, "test.replay", limit=2)
    table = torch.randn(8)
    _plan(table)
    shapes = [(1, 16, 16), (2, 16, 16), (3, 16, 16)]
    for shape in shapes:
        for _ in range(3):
            c = _Call(lib, table, shape)
            c.run(store, _key(c.x))
    keys = [_key(torch.empty(s)) for s in shapes]
    assert list(store.entries) == keys[1:]
    c = _Call(lib, table, shapes[0])     # dropped: its first call again
    c.run(store, _key(c.x))
    assert c.ran == 1 and list(store.entries) == [keys[2], keys[0]]


def test_a_dropped_graph_keeps_its_tables_until_its_last_launch(lib):
    counter = dict.fromkeys(pyramid2d.GRAPHS, 0)
    store = graph.Store(counter, "test.replay", limit=1)
    table = torch.randn(8)
    _plan(table)
    for _ in range(3):
        c = _Call(lib, table)
        c.run(store, _key(c.x))
    (h, _), = lib.graphs.items()
    lib.running.add(h)               # its last launch has not completed
    held = store.entries[_key(c.x)].keep
    watch = weakref.ref(held[0][0])
    del table, held, c
    build._plans.clear()
    lib.memory.clear()
    other = torch.randn(8)
    _plan(other)
    c = _Call(lib, other, (2, 16, 16))
    c.run(store, _key(c.x))           # drops the first signature
    assert len(store.retired) == 1 and watch() is not None
    assert h in lib.graphs
    lib.running.clear()
    c = _Call(lib, other, (3, 16, 16))
    c.run(store, _key(c.x))           # the next store frees it
    assert not store.retired and h not in lib.graphs
    assert watch() is None


# --- calls that never reach the store ---------------------------------------

class _NoStore:
    def run(self, *args):
        raise AssertionError("the call reached the graph store")


@pytest.mark.parametrize("route", pyramid2d.ROUTES)
@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("L", [0, 3])
def test_cpu_plain_and_zero_levels_never_reach_the_store(monkeypatch, route,
                                                         plain, L):
    monkeypatch.setattr(pyramid2d, "_graphs", _NoStore())
    before = dict(pyramid2d.GRAPHS)
    x = torch.randn(1, 32, 32)
    y = pyramid2d.dwt2(x, CDF97, L, route=route, plain=plain)
    back = pyramid2d.idwt2(y, CDF97, L, route="level" if route == "stage"
                           else route, plain=plain)
    assert torch.allclose(back, x, atol=1e-4)
    assert pyramid2d.GRAPHS == before


def test_plain_cuda_calls_are_counted_and_skip_the_store(monkeypatch):
    monkeypatch.setattr(pyramid2d, "_graphs", _NoStore())
    monkeypatch.setattr(pyramid2d, "GRAPHS",
                        dict.fromkeys(pyramid2d.GRAPHS, 0))
    ran = []
    card = SimpleNamespace(device=SimpleNamespace(type="cuda", index=0))
    pyramid2d._run("dwt2", card, CDF97, 3, "level", True,
                   lambda: ran.append(1), None, None)
    assert ran == [1]
    assert pyramid2d.GRAPHS == {"captures": 0, "replays": 0, "fallbacks": 0,
                                "plain": 1}


def test_graphs_is_a_counter_of_tracing():
    from wavelets_tpu_torch import tracing
    assert tracing.COUNTERS["ops.pyramid2d"] == ("GRAPHS",)
    got = tracing.counters()
    assert {f"pyramid2d.GRAPHS.{k}" for k in pyramid2d.GRAPHS} <= set(got)
