"""A rehearsal of every cell's run on the CPU, at a small size, through the
kernels' plain versions (which a CPU tensor takes): set-up, the closed
loop, the reservoir of kept jobs and the judgement.  Sound runs come out
correct; the control (the program's bfloat16 path) and the program with
its timed path broken underneath come out not correct.  No cell has a
batch of images or volumes, or a second card, so no fault leaves out half
of a batch or an exchange between cards.  The look for a card is
``run.py``'s and is skipped here; no number of these runs is a device
metric."""

import copy

import pytest
import torch

import wavelets_tpu_torch.ops.dwt3d as dwt3d
import wavelets_tpu_torch.ops.pyramid2d as pyramid2d
from portbench import faults, loop, spec

CELLS = sorted(spec.cells())


def small(name: str) -> spec.Cell:
    """The cell at a size the CPU holds: 256^2 images (a level launch, then
    the tail) or 16^3 volumes, its levels capped, at most four images or
    volumes a job."""
    cell = copy.deepcopy(spec.cell(name))
    t = cell.traffic
    ndt = spec.module("reference", cell.config["family"]).NDT
    batch = [min(b, 4) for b in t["shape"][:-ndt]]
    t["shape"] = batch + [256 if ndt == 2 else 16] * ndt
    t["levels"] = min(t["levels"], 4 if ndt == 2 else 3)
    t["pool"] = min(t["pool"], 3)
    t["check_jobs"] = min(t["check_jobs"], 4)
    return cell


def judged(cell, seed=2 ** 31 + 77, dtype=None):
    run = loop.Run(cell, seed, "cpu", dtype=dtype)
    run.setup()
    rec = run.window(0.3)
    assert len(rec.latency_ms) == rec.jobs > 0
    kept = min(rec.jobs, cell.traffic["check_jobs"])
    one = rec.samples_per_job * run.dtype.itemsize
    assert rec.kept_bytes == kept * 2 * one     # each job's y and xr
    verdict = run.judge(cell.traffic["limits"])
    assert verdict["judged"] == kept
    return verdict


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    verdict = judged(small(name))
    assert verdict["failed"] == 0, verdict


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = small(name)
    verdict = judged(cell, dtype=cell.config["control_dtype"])
    assert verdict["failed"] == verdict["judged"] > 0, verdict


def _patched(monkeypatch, module, i, fn):
    kernels = list(module._KERNELS)
    kernels[i] = fn(kernels[i])
    monkeypatch.setattr(module, "_KERNELS", tuple(kernels))


def _driver(cell):
    return pyramid2d if cell.config["family"] == "dwt2" else dwt3d


@pytest.mark.parametrize("name", CELLS)
def test_a_launch_that_returns_its_state_unchanged(name, monkeypatch):
    """The deepest inverse launch hands its input back as its output: the
    2-D tail (D) copies the packed coefficients, or the 3-D driver's last
    axis-0 inverse level (J) writes its two halves unmerged."""
    cell = small(name)
    if cell.config["family"] == "dwt2":
        _patched(monkeypatch, pyramid2d, 3,
                 lambda real: lambda y, wt, L, out=None: out.copy_(y))
    else:
        deepest = cell.traffic["shape"][-3] >> cell.traffic["levels"]

        def unchanged(real):
            def fn(a, d, wt, out=None, corner=None):
                if a.shape[1] != deepest:
                    return real(a, d, wt, out=out, corner=corner)
                out[:, :deepest] = a if corner is None else corner
                out[:, deepest:] = d
                return out
            return fn
        _patched(monkeypatch, dwt3d, 3, unchanged)
    verdict = judged(cell)
    assert verdict["failed"] == verdict["judged"] > 0, verdict


@pytest.mark.parametrize("name", CELLS)
def test_a_launch_that_leaves_its_output_unwritten(name):
    """The inverse level launch (B) that writes the job's output returns
    without writing it; the cell's pool, which never divides its jobs in
    flight, leaves another input's answer in that output's block."""
    cell = small(name)
    with faults.planted(cell, "unwritten"):
        verdict = judged(cell)
    assert verdict["failed"] == verdict["judged"] > 0, verdict


def test_a_pool_that_divides_the_jobs_in_flight_is_refused():
    cell = small("dwt2_cdf97.img16k_L8")
    cell.traffic["pool"] = cell.traffic["in_flight"]
    with pytest.raises(ValueError, match="divides"):
        loop.Run(cell, 1, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_it_is_made(name, monkeypatch):
    """The inverse level launch (B) changes one sample of what it
    writes."""
    cell = small(name)

    def altered(real):
        def fn(*args, **kwargs):
            out = real(*args, **kwargs)
            flat = out.view(-1)
            flat[0] += 0.01 * (1 + flat[0].abs())
            return out
        return fn
    _patched(monkeypatch, _driver(cell), 1, altered)
    verdict = judged(cell)
    assert verdict["failed"] == verdict["judged"] > 0, verdict


def test_the_kept_jobs_are_drawn_from_the_seed():
    cell = small("dwt2_cdf97.img1k_L10")
    picks = []
    for seed in (5, 5, 6):
        run = loop.Run(cell, seed, "cpu")
        for k in range(200):
            run.kept.offer(k, None)
        picks.append(sorted(k for k, _ in run.kept.slots))
    assert picks[0] == picks[1] != picks[2]
    assert max(picks[0]) >= cell.traffic["check_jobs"]


def test_inputs_are_drawn_from_the_seed():
    a = loop.make_input(2 ** 32 + 5, 0, (8, 8), "cpu")
    assert torch.equal(a, loop.make_input(2 ** 32 + 5, 0, (8, 8), "cpu"))
    assert not torch.equal(a, loop.make_input(2 ** 32 + 5, 1, (8, 8), "cpu"))
    assert not torch.equal(a, loop.make_input(2 ** 32 + 6, 0, (8, 8), "cpu"))
