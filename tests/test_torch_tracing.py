"""The port's spans and counters (wavelets_tpu_torch/tracing.py) on the CPU.

Off, a span records nothing.  On, a public call opens a root span, its
driver one span below it, and each launch wrapper one span below the
driver, named as its ``LAUNCHES`` key (on the CPU the wrapper takes its
kernel's plain version inside that span).  Self times plus children give
each parent's duration; ``scratch.ALLOCATED`` counts the drivers' scratch
bytes exactly; the span list is bounded; and stamps mapped through
``take()``'s offset share the profiler's clock.
"""

import importlib
import pkgutil

import pytest
import torch

import wavelets_tpu_torch as T
from wavelets_tpu_torch import tracing
from wavelets_tpu_torch.ops import build, level2d, pyramid2d, scratch

# (family, shape, levels, wavelet, driver spans, launch keys)
CASES = {
    "2d": ((2, 256, 256), 2, 4, "cdf97",
           ("pyramid2d.dwt2", "pyramid2d.idwt2"),
           {"level_fw", "tail_fw", "level_inv", "tail_inv"}),
    "3d": ((16, 16, 8), 3, 2, "haar", ("dwt3d.dwt3", "dwt3d.idwt3"),
           {"level3_fw", "level3_inv"}),
    "3d_chain": ((16, 16, 8), 3, 2, "cdf97", ("dwt3d.dwt3", "dwt3d.idwt3"),
                 {"level_fw", "axis0_fw", "axis0_inv", "level_inv"}),
}


@pytest.fixture(autouse=True)
def _tracing_off():
    """Every test starts and ends with tracing off and no spans kept."""
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _carrier(name):
    return T.wavelet(getattr(T.wt, name), "lifting")


def _round_trip(case):
    shape, ndt, L, name, _, _ = CASES[case]
    wt = _carrier(name)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(5))
    return T.idwt(T.dwt(x, wt, L, ndt=ndt), wt, L, ndt=ndt)


def _traced(case):
    before = tracing.counters()
    tracing.enable()
    _round_trip(case)
    tracing.disable()
    after = tracing.counters()
    rise = {k: n - before[k] for k, n in after.items() if n != before[k]}
    return tracing.take(), rise


def test_off_records_nothing():
    assert tracing.span("x") is tracing.span("y", 3)
    _round_trip("2d")
    assert tracing.take() == {"spans": [], "dropped": 0,
                              "offset_ns": tracing.take()["offset_ns"]}
    assert not tracing.enabled()


@pytest.mark.parametrize("case", sorted(CASES))
def test_roots_drivers_and_launches_nest(case):
    _, _, L, _, drivers, keys = CASES[case]
    spans = _traced(case)[0]["spans"]
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in roots] == ["dwt", "idwt"]
    for i in roots:
        assert spans[i].root == i and spans[i].tag == L
    for i, s in enumerate(spans):
        if s.parent < 0:
            continue
        parent = spans[s.parent]
        assert s.parent < i and s.root == parent.root
        assert parent.start <= s.start <= s.end <= parent.end
        if parent.parent == -1:       # a driver, below its root
            assert s.name == drivers[parent.name == "idwt"] and s.tag == L
        else:                         # a launch wrapper, below its driver
            assert parent.name in drivers and s.name in keys
    assert {s.name for s in spans} == {"dwt", "idwt", *drivers, *keys}


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_launch_span_per_counted_launch(case):
    """On the CPU every wrapper call takes its plain version: the launch
    spans, by name, equal the rise of ``LAUNCHES`` + ``PLAIN_CALLS``."""
    taken, rise = _traced(case)
    counted = {}
    for key, n in rise.items():
        module, kind, name = key.split(".")
        if kind in ("LAUNCHES", "PLAIN_CALLS"):
            counted[name] = counted.get(name, 0) + n
    spans = {}
    for s in taken["spans"]:
        if s.name in CASES[case][5]:
            spans[s.name] = spans.get(s.name, 0) + 1
    assert spans == counted and sum(spans.values()) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_self_time_and_children_make_the_duration(case):
    spans = _traced(case)[0]["spans"]
    own = tracing.self_ns(spans)
    children = [0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            children[s.parent] += s.end - s.start
    for s, o, c in zip(spans, own, children):
        assert o >= 0 and o + c == s.end - s.start


# (shape, levels, wavelet, ndt): the cells' level structure at a CPU size
SCRATCH = {
    # 1024^2 L10 as in the cell: A at levels 1-3, the tail for 4-10
    "img1k_L10": ((1024, 1024), 10, "cdf97", 2),
    # 16384^2 L8 runs A at levels 1-7, then the tail; 512^2 L6 runs A at
    # levels 1-2, then the tail: both ping-pong through two buffers
    "img16k_L8": ((512, 512), 6, "cdf97", 2),
    # 512^3 L3 (haar: one pass a level): per direction an eighth and a
    # sixty-fourth of the volume
    "vol512_L3": ((32, 32, 32), 3, "haar", 3),
    # a wider wavelet (two launches a level): forward the volume, inverse
    # the volume and its eighth
    "vol_cdf97_L3": ((32, 32, 32), 3, "cdf97", 3),
}


@pytest.mark.parametrize("cell", sorted(SCRATCH))
def test_scratch_bytes_are_counted_exactly(cell):
    shape, L, name, ndt = SCRATCH[cell]
    wt = _carrier(name)
    x = torch.zeros(shape)
    one = x.nbytes
    if ndt == 2:
        m, n = shape
        assert 2 <= pyramid2d.kernel_levels(m, n, L, wt, x.dtype, False) < L
        # per direction: an (m/2, n/2) and an (m/4, n/4) buffer
        want = 2 * (one // 4 + one // 16)
    elif name == "haar":
        want = 2 * (one // 8 + one // 64)
    else:
        want = one + one + one // 8
    before = scratch.ALLOCATED["bytes"]
    T.idwt(T.dwt(x, wt, L, ndt=ndt), wt, L, ndt=ndt)
    assert scratch.ALLOCATED["bytes"] - before == want
    if cell == "img1k_L10":
        assert want == 2.5 * 2 ** 20


def test_dropped_spans_are_counted_at_the_bound(monkeypatch):
    monkeypatch.setattr(tracing, "LIMIT", 3)
    tracing.enable()
    _round_trip("2d")        # 2 roots, 2 drivers, 2 + 2 launches
    taken = tracing.take()
    names = [s.name for s in taken["spans"]]
    assert names == ["dwt", "pyramid2d.dwt2", "level_fw"]
    assert taken["dropped"] == 5
    with tracing.span("a"):
        with tracing.span("b", 7):
            pass
    assert [(s.name, s.tag, s.parent, s.root)
            for s in tracing.take()["spans"]] == [("a", -1, -1, 0),
                                                 ("b", 7, 0, 0)]


def test_children_of_a_dropped_span_attach_to_its_parent(monkeypatch):
    monkeypatch.setattr(tracing, "LIMIT", 2)
    tracing.enable()
    with tracing.span("a"):
        with tracing.span("b"):
            pass
        with tracing.span("c"):       # dropped
            monkeypatch.setattr(tracing, "LIMIT", 3)   # room again, inside
            with tracing.span("d"):
                pass
    taken = tracing.take()
    assert [(s.name, s.parent) for s in taken["spans"]] == \
        [("a", -1), ("b", 0), ("d", 0)]
    assert taken["dropped"] == 1


def test_take_inside_a_span_is_refused():
    tracing.enable()
    with tracing.span("open"):
        with pytest.raises(RuntimeError, match="open span"):
            tracing.take()


def test_stamps_share_the_profilers_clock():
    """A ``record_function`` range opened inside a program span lies inside
    that span once its stamps are mapped through ``take()``'s offset, within
    20 us at each end."""
    tracing.enable()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(5):
            with tracing.span("outer", i):
                with torch.profiler.record_function(f"inner{i}"):
                    torch.ones(64).sum()
    tracing.disable()
    taken = tracing.take()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    slack = 20_000
    for s in taken["spans"]:
        e = events[f"inner{s.tag}"]
        assert s.start + taken["offset_ns"] - slack <= e.start_ns()
        assert e.end_ns() <= s.end + taken["offset_ns"] + slack


def test_counters_name_every_counting_module():
    ops = importlib.import_module("wavelets_tpu_torch.ops")
    counting = set()
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"wavelets_tpu_torch.ops.{info.name}")
        if hasattr(mod, "LAUNCHES"):
            counting.add(f"ops.{info.name}")
            assert tracing.COUNTERS[f"ops.{info.name}"] == ("LAUNCHES",
                                                            "PLAIN_CALLS")
    assert len(counting) == 8
    got = tracing.counters()
    assert got["scratch.ALLOCATED.bytes"] == scratch.ALLOCATED["bytes"]
    assert "sharded.STATS.sharded_levels" in got
    assert "mesh.COPIES.moved" in got
    assert "level2d.LAUNCHES.level_fw" in got
    assert "level2d.PLAIN_CALLS.level_fw" in got


def test_counters_list_the_launch_plans():
    got = tracing.counters()
    assert tracing.COUNTERS["ops.build"] == ("PLANS",)
    assert got["build.PLANS.hits"] == build.PLANS["hits"]
    assert got["build.PLANS.misses"] == build.PLANS["misses"]


class _Library:
    """A stand-in for the kernels' library: entry points return ``status``."""

    def __init__(self, status):
        self.status, self.calls = status, []

    def __getattr__(self, name):
        if name == "wtt_error_string":
            return lambda status: b"a test error"
        return lambda *args: self.calls.append((name, args)) or self.status


@pytest.mark.parametrize("status", [0, 7])
def test_launch_calls_the_entry_point_inside_its_call_span(status,
                                                           monkeypatch):
    """``Plan.call`` (what a launch wrapper's plan runs) calls its entry
    point inside the span ``<key>.call`` and raises on its status; it
    counts no launch."""
    lib = _Library(status)
    monkeypatch.setattr(build, "library", lambda: lib)
    x = torch.randn(1, 8, 8)
    outs = tuple(torch.empty(1, 4, 4) for _ in range(4))
    plan = level2d._fw_plan(_carrier("cdf97"), x, outs)
    launches = dict(level2d.LAUNCHES)
    tracing.enable()
    with tracing.span("level_fw"):
        if status:
            with pytest.raises(RuntimeError, match="level_fw: CUDA error 7"):
                plan.call((x, *outs), 77)
        else:
            plan.call((x, *outs), 77)
    spans = tracing.take()["spans"]
    [(entry, args)] = lib.calls
    assert entry == "wtt_level_fw" and args[4].value == x.data_ptr()
    assert args[-1].value == 77 and level2d.LAUNCHES == launches
    assert [(s.name, s.parent) for s in spans] == [("level_fw", -1),
                                                   ("level_fw.call", 0)]
