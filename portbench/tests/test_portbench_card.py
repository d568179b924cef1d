"""On the card: the control and a planted fault against sound runs through
the benchmark's own loop, at a size a test run holds (2048^2 images, 128^3
volumes, at most four a job), on three seeds each.  Sound runs are
correct; the control, the program's bfloat16 path, is not, and nor is a
run whose inverse level launch leaves the job's output unwritten.  Skips
without a card."""

import copy

import pytest

from portbench import faults, spec
from portbench.calibrate import readings

SEEDS = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]


def moderate(name: str) -> spec.Cell:
    cell = copy.deepcopy(spec.cell(name))
    t = cell.traffic
    ndt = spec.module("reference", cell.config["family"]).NDT
    t["shape"] = [min(b, 4) for b in t["shape"][:-ndt]] + \
        [min(s, 2048 if ndt == 2 else 128) for s in t["shape"][-ndt:]]
    t["pool"] = min(t["pool"], 4)
    t["check_jobs"] = min(t["check_jobs"], 4)
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(spec.cells()))
def test_control_fails_where_sound_runs_pass(name, card):
    cell = moderate(name)
    sound = readings(cell, SEEDS, 1.0, device=card)
    control = readings(cell, SEEDS, 1.0, dtype=cell.config["control_dtype"],
                       device=card)
    assert all(r["correct"] and r["judged"] for r in sound), sound
    assert not any(r["correct"] for r in control), control


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(spec.cells()))
def test_an_unwritten_output_fails(name, card):
    cell = moderate(name)
    with faults.planted(cell, "unwritten"):
        got = readings(cell, SEEDS, 1.0, device=card)
    assert not any(r["correct"] for r in got), got
