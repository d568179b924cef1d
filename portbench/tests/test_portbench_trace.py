"""The reduction of a profiler session to busy time, idle gaps by host
span, kernel counts and the device operations' breakdown, on synthetic
events."""

import pytest

from portbench.trace import BETWEEN, is_library, reduce, short_name, union


def test_union_merges_overlaps():
    assert union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [[0, 4], [5, 6]]
    assert union([]) == []


def test_kernel_names():
    assert short_name("void level_fw_tiled_kernel<float, 8, 4>(Args)") == \
        "level_fw_tiled_kernel"
    lib = ("void at::native::(anonymous namespace)::CatArrayBatchedCopy"
           "<float, unsigned int, 4, 64, 64>(float*, ...)")
    assert is_library(lib) and short_name(lib) == "CatArrayBatchedCopy"
    assert not is_library("void tail_fw_kernel<float>(int)")


def test_reduce_busy_gaps_and_ops():
    spans = [("dwt call", 0.0, 1.0), ("idwt call", 1.0, 2.0),
             ("waiting for job k-1", 2.0, 5.0), ("dwt call", 5.5, 6.0)]
    device = [("void a_kernel<1>(x)", 0.5, 1.5),
              ("void b_kernel(x)", 1.2, 3.0),
              ("Memset (Device)", 3.0, 3.5),
              ("void a_kernel<2>(y)", 4.0, 6.5)]
    tr = reduce(device, spans)
    assert tr.window == pytest.approx(6.5)
    assert tr.busy == pytest.approx(3.0 + 2.5)
    # idle: [0, 0.5) in the dwt call, [3.5, 4.0) while waiting
    assert tr.gaps == pytest.approx({"dwt call": 0.5,
                                     "waiting for job k-1": 0.5})
    assert len(tr.kernels) == 3
    assert tr.ops == pytest.approx({"a_kernel": 3.5, "b_kernel": 1.8,
                                    "Memset (Device)": 0.5})


def test_a_gap_outside_every_span():
    spans = [("dwt call", 0.0, 1.0), ("idwt call", 3.0, 4.0)]
    device = [("k", 0.0, 1.5), ("k", 3.5, 4.0)]
    tr = reduce(device, spans)
    # named by the span open at the gap's start, none at 1.5
    assert tr.gaps == pytest.approx({BETWEEN: 2.0})


def test_an_empty_trace_is_refused():
    with pytest.raises(ValueError):
        reduce([], [("dwt call", 0, 1)])
