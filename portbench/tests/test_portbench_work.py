"""The work reckoning and the readers that turn a run's record into
numbers, on hand-worked values."""

import json

import pytest

from portbench import spec
from portbench.loop import Record
from portbench.reference import lifting
from portbench.trace import Trace
from portbench.work import dwt2, dwt3
from portbench.work.lifting import geometric, one_direction

PEAK_BW = 3.35e12


def test_geometric_sums():
    assert geometric(8, 2) == pytest.approx((4 / 3) * (1 - 4.0 ** -8))
    assert geometric(3, 3) == pytest.approx((8 / 7) * (1 - 8.0 ** -3))
    assert geometric(1, 2) == 1.0


def test_img16k_cdf97_L8_f32_moves_2_8633_gb_a_direction():
    nbytes, flops = one_direction((16384, 16384), 8, 4,
                                  lifting.scheme("cdf97"), 2)
    assert nbytes / 1e9 == pytest.approx(2.8633, abs=1e-4)
    assert nbytes / PEAK_BW * 1e3 == pytest.approx(0.855, abs=1e-3)
    # four two-tap steps and one scaling: 9 operations a sample a pass
    assert flops == pytest.approx(16384 ** 2 * geometric(8, 2) * 2 * 9)
    job = dwt2.job((16384, 16384), 8, 4, lifting.scheme("cdf97"))
    assert job == (2 * nbytes, 2 * flops)


def test_vol512_haar_L3_f32_moves_1_2247_gb_a_direction():
    nbytes, flops = one_direction((512, 512, 512), 3, 4,
                                  lifting.scheme("haar"), 3)
    assert nbytes / 1e9 == pytest.approx(1.2247, abs=1e-4)
    assert nbytes / PEAK_BW * 1e3 == pytest.approx(0.366, abs=1e-3)
    # two one-tap steps and one scaling: 3 operations a sample a pass
    assert flops == pytest.approx(512 ** 3 * geometric(3, 3) * 3 * 3)


def test_a_batch_scales_the_work():
    one = dwt3.job((128, 128, 128), 3, 4, lifting.scheme("haar"))
    many = dwt3.job((16, 128, 128, 128), 3, 4, lifting.scheme("haar"))
    assert many == pytest.approx((16 * one[0], 16 * one[1]))


def _reader(name):
    return spec.module("metrics", name)


def _traced(busy, window, jobs, nbytes, flops, peaks):
    """A traced run whose untraced jobs, as many as the traced ones, took
    ``window`` seconds in all."""
    return Record(jobs=2 * jobs, untraced_s=window,
                  trace=Trace([("k", 0, 1)] * 3 * jobs, busy, window, {}, {}),
                  trace_jobs=jobs, work=(nbytes, flops), peaks=peaks,
                  host_s_untraced=[1e-3, 3e-3])


def test_roofline_against_the_published_peak():
    peaks = {"bytes_per_s": PEAK_BW, "flops_per_s": 67e12}
    nbytes, flops = dwt2.job((16384, 16384), 8, 4, lifting.scheme("cdf97"))
    # 100 jobs of 3.29 ms busy each: 1.709 ms least / 3.29 ms
    rec = _traced(0.329, 0.332, 100, nbytes, flops, peaks)
    got = _reader("kernel_roofline").read(rec)
    assert got == pytest.approx(100 * (nbytes / PEAK_BW) / 3.29e-3)
    assert 51 < got < 53
    assert _reader("device_idle_share").read(rec) == pytest.approx(
        100 * (1 - 0.329 / 0.332))
    assert _reader("kernels_per_job").read(rec) == 3
    assert _reader("host_ms_per_job").read(rec) == pytest.approx(2.0)


def test_an_operation_bound_job_takes_the_operation_time():
    peaks = {"bytes_per_s": PEAK_BW, "flops_per_s": 1e9}
    rec = _traced(1.0, 1.0, 1, 1e6, 5e8, peaks)
    assert _reader("kernel_roofline").read(rec) == pytest.approx(50.0)


def test_readers_find_nothing_where_there_is_nothing():
    untraced = Record(jobs=10, seconds=1.0, samples_per_job=4)
    for name in ("kernel_roofline", "device_idle_share", "kernels_per_job",
                 "host_ms_per_job"):
        assert _reader(name).read(untraced) is None
    # an unknown card: no roofline, never a zero
    rec = _traced(0.5, 1.0, 10, 1e9, 1e9, None)
    assert _reader("kernel_roofline").read(rec) is None
    assert _reader("job_ms_p95").read(Record(latency_ms=[1.0] * 5)) is None
    assert _reader("peak_mem_gib").read(Record()) is None


def test_end_to_end_readers():
    rec = Record(seconds=2.0, jobs=100, samples_per_job=2 ** 20,
                 latency_ms=[float(i) for i in range(1, 101)],
                 peak_bytes=3 * 2 ** 30, kept_bytes=2 ** 29, setup_s=12.5)
    assert _reader("gsamples_per_s").read(rec) == pytest.approx(
        100 * 2 ** 20 / 2.0 / 1e9)
    assert _reader("job_ms_p95").read(rec) == pytest.approx(95.05)
    # the jobs kept for the check are the harness's, not the library's
    assert _reader("peak_mem_gib").read(rec) == 2.5
    assert _reader("setup_s").read(rec) == 12.5


def test_peaks_table_names_the_h100():
    table = json.loads((spec.HERE / "peaks.json").read_text())
    h100 = table["NVIDIA H100 80GB HBM3"]
    assert h100["bytes_per_s"] == PEAK_BW
    assert h100["flops_per_s"]["float32"] == 67e12
