"""The program's spans in the benchmark (``spans.py`` and the metrics that
read it): idle gaps split by the innermost program span, kernels put down
to launch spans, levels, host time by layer and the four readers, on
synthetic spans and events; then a rehearsal on the CPU of a traced run's
per-layer metrics, and of an untraced run, which never turns the
program's tracing on."""

import copy
import sys

import pytest

from portbench import loop, spans, spec
from portbench.trace import BETWEEN, reduce
from wavelets_tpu_torch import tracing
from wavelets_tpu_torch.tracing import Span

NEW = ("front_us_per_job", "driver_us_per_job", "launch_us_per_launch",
       "scratch_mib_per_job")


def test_innermost_spans_tile_the_timeline():
    prog = [("dwt", 0.0, 10.0), ("pyramid2d.dwt2", 1.0, 9.0),
            ("level_fw", 2.0, 4.0), ("level_fw.call", 3.0, 3.5),
            ("tail_fw", 5.0, 8.0), ("idwt", 12.0, 13.0)]
    assert spans.innermost(prog) == [
        (0.0, 1.0, "dwt"), (1.0, 2.0, "pyramid2d.dwt2"),
        (2.0, 3.0, "level_fw"), (3.0, 3.5, "level_fw.call"),
        (3.5, 4.0, "level_fw"),
        (4.0, 5.0, "pyramid2d.dwt2"), (5.0, 8.0, "tail_fw"),
        (8.0, 9.0, "pyramid2d.dwt2"), (9.0, 10.0, "dwt"),
        (12.0, 13.0, "idwt")]


def test_gaps_split_by_the_innermost_program_span():
    bench = [("dwt call", 0.0, 10.0), ("idwt call", 10.0, 20.0),
             ("waiting for job k-1", 20.0, 22.0)]
    device = [("void level_fw_tiled_kernel<float>(x)", 3.6, 6.0),
              ("void tail_fw_kernel(x)", 8.5, 12.0),
              ("void level_inv_tiled_kernel(x)", 19.0, 21.0)]
    prog = [("dwt", 0.5, 9.5), ("pyramid2d.dwt2", 1.0, 9.0),
            ("level_fw", 2.0, 4.0), ("level_fw.call", 3.0, 3.5),
            ("tail_fw", 5.0, 8.0), ("idwt", 12.5, 19.5)]
    got = spans.split_gaps(device, bench, spans.innermost(prog))
    assert got == pytest.approx({
        "dwt call": 0.5,                          # [0, 0.5): no program span
        "dwt call / dwt": 0.5,                    # [0.5, 1)
        "dwt call / pyramid2d.dwt2": 1.0 + 0.5,   # [1, 2), [8, 8.5)
        "dwt call / level_fw": 1.0 + 0.1,         # [2, 3), [3.5, 3.6)
        "dwt call / level_fw.call": 0.5,          # the innermost wins
        "dwt call / tail_fw": 2.0,                # [6, 8)
        # a gap is named by the benchmark span open at its start, as
        # trace.reduce names it: [12, 19) opens in the idwt call
        "idwt call": 0.5, "idwt call / idwt": 6.5,
        "waiting for job k-1": 1.0,               # [21, 22)
    })
    # the totals per benchmark span are trace.reduce's
    totals = {}
    for name, v in got.items():
        key = name.split(" / ")[0]
        totals[key] = totals.get(key, 0.0) + v
    assert totals == pytest.approx(reduce(device, bench).gaps)


def test_a_gap_outside_every_benchmark_span():
    bench = [("dwt call", 0.0, 1.0), ("idwt call", 3.0, 4.0)]
    device = [("k", 0.0, 1.5), ("k", 3.5, 4.0)]
    got = spans.split_gaps(device, bench, [(1.5, 2.0, "dwt")])
    assert got == pytest.approx({f"{BETWEEN} / dwt": 0.5, BETWEEN: 1.5})
    assert sum(got.values()) == pytest.approx(reduce(device, bench)
                                              .gaps[BETWEEN])


def test_kernels_are_put_down_to_the_launch_of_their_runtime_call():
    launches = [(4, 1.0, 2.0), (7, 3.0, 5.0), (9, 6.0, 7.0)]
    runtime = {11: 1.5, 12: 4.9, 13: 5.5, 14: 6.5}
    kernels = [("a", 2.0, 2.5, 11), ("b", 5.0, 6.0, 12),
               ("c", 6.0, 6.2, 13),       # its call falls between launches
               ("d", 8.0, 9.0, None),     # no runtime call in the trace
               ("e", 9.0, 9.5, 14)]
    claimed, unclaimed = spans.attribute(kernels, runtime, launches)
    assert claimed == {4: [kernels[0]], 7: [kernels[1]], 9: [kernels[4]]}
    assert unclaimed == [kernels[2], kernels[3]]


def _span(name, parent, tag=-1, start=0, end=0):
    return Span(name, tag, start, end, parent, 0)


def test_levels_follow_the_level_route():
    keys = {"level_fw", "tail_fw", "level_inv", "tail_inv", "modwt_fw"}
    s = [_span("dwt", -1, 10), _span("pyramid2d.dwt2", 0, 10),
         _span("level_fw", 1), _span("level_fw", 1), _span("level_fw", 1),
         _span("tail_fw", 1),
         _span("idwt", -1, 10), _span("pyramid2d.idwt2", 6, 10),
         _span("tail_inv", 7), _span("level_inv", 7), _span("level_inv", 7),
         _span("level_inv", 7),
         _span("modwt", -1, 2), _span("modwt1d.modwt", 12, 2),
         _span("modwt_fw", 13, 1), _span("modwt_fw", 13, 2),
         _span("dwt", -1, 2), _span("pyramid2d.dwt2", 16, 2),
         _span("level_fw", 17), _span("tail_fw", 17)]
    assert spans.level_labels(s, keys) == {
        2: "1", 3: "2", 4: "3", 5: "4-10", 8: "4-10", 9: "3", 10: "2",
        11: "1", 14: "1", 15: "2", 18: "1", 19: "2"}


def test_host_time_by_layer():
    keys = {"level_fw"}
    s = [_span("dwt", -1, 2, 0, 100), _span("pyramid2d.dwt2", 0, 2, 10, 90),
         _span("level_fw", 1, -1, 20, 50), _span("level_fw.call", 2, -1, 30,
                                                 45),
         _span("level_fw", 1, -1, 60, 80), _span("level_fw.call", 4, -1, 70,
                                                 75)]
    own = tracing.self_ns(s)
    assert spans.host_layers(s, own, keys) == {
        "front": 20, "driver": 30, "launch": [30, 20], "prep": 30,
        "call": 20, "other": 0}


def _program(**kw):
    base = dict(jobs=4, front_us=30.0, driver_us=40.0, launch_us=100.0,
                prep_us=70.0, call_us=30.0, launches=8.0, scratch_mib=2.5,
                host_on_us=880.0, host_off_us=860.0)
    base.update(kw)
    return spans.Program(**base)


@pytest.mark.parametrize("name, want", [
    ("front_us_per_job", 30.0), ("driver_us_per_job", 40.0),
    ("launch_us_per_launch", 100.0), ("scratch_mib_per_job", 2.5)])
def test_the_readers_read_the_programs_record(name, want):
    rec = loop.Record()
    rec.program = _program()
    assert spec.module("metrics", name).read(rec) == want
    rec.program = None
    assert spec.module("metrics", name).read(rec) is None


def test_a_program_without_spans_gives_no_reading(monkeypatch):
    """An older program, with no tracing module: the readers give None
    and run no sub-window."""
    monkeypatch.setitem(sys.modules, "wavelets_tpu_torch.tracing", None)
    run = "not a run"     # noqa: F841 (where run.py keeps it)
    rec = loop.Record()
    for name in NEW:
        assert spec.module("metrics", name).read(rec) is None


def _small(name):
    cell = copy.deepcopy(spec.cell(name))
    t = cell.traffic
    ndt = spec.module("reference", cell.config["family"]).NDT
    t["shape"] = [512 if ndt == 2 else 16] * ndt
    t["levels"] = min(t["levels"], 6 if ndt == 2 else 3)
    t["pool"] = min(t["pool"], 3)
    t["check_jobs"] = min(t["check_jobs"], 2)
    t["trace_jobs"] = 3
    return cell


def _metrics(run, rec, wanted):
    """run.py's loop over a cell's metrics (its local ``run`` included)."""
    out = {}
    for m in wanted:
        value = spec.module("metrics", m["name"], run.cell.root).read(rec)
        if value is not None:
            out[m["name"]] = value
    return out


@pytest.mark.parametrize("name", sorted(spec.cells()))
def test_rehearsal_of_a_traced_runs_program_metrics(name):
    """The per-layer metrics of each cell after a CPU window: those the
    program's spans feed are all reported (the profiler's do not read on
    the CPU, where the window ran untraced), and the sub-windows leave
    tracing off."""
    cell = _small(name)
    run = loop.Run(cell, 2 ** 33 + 5, "cpu")
    run.setup()
    rec = run.window(0.2)
    run.judge(cell.traffic["limits"])
    got = _metrics(run, rec, cell.per_layer)
    listed = {m["name"] for m in cell.per_layer if m["name"] in NEW}
    assert set(got) == listed and listed
    assert not tracing.enabled()
    program = rec.program
    assert program.jobs == 3 and program.dropped == 0
    shape, L = cell.traffic["shape"], cell.traffic["levels"]
    samples = 1
    for s in shape:
        samples *= s
    # float32 scratch a job, as the drivers size it (see the program's
    # tests/test_torch_tracing.py)
    one = 4 * samples
    want = 2 * (one // 4 + one // 16) if len(shape) == 2 \
        else one + one + one // 8
    assert program.scratch_mib == want / 2 ** 20
    if "launch_us_per_launch" in listed:
        assert program.launches == 6      # A x2, C; D, B x2 at 512^2 L6
        total = program.front_us + program.driver_us + \
            program.launches * program.launch_us
        assert total <= program.host_on_us


def test_an_untraced_run_never_turns_program_tracing_on(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("program tracing turned on")
    monkeypatch.setattr(tracing, "enable", refuse)
    cell = _small("dwt2_cdf97.img1k_L10")
    run = loop.Run(cell, 2 ** 33 + 6, "cpu", tracing=False)
    run.setup()
    rec = run.window(0.2)
    run.judge(cell.traffic["limits"])
    _metrics(run, rec, cell.end_to_end)
    assert not hasattr(rec, "program") and not tracing.enabled()
