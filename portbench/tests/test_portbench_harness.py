"""The harness's layout: ``BENCHMARK.json`` against the benchmark's
contract, every name found as a file, a cell added by files and entries
alone, the import closure free of JAX and of the JAX package, and no
result without a card."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import loop, spec

ROOT = spec.ROOT
HERE = spec.HERE
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == [HERE.name]
    assert BENCH["command"] == ["python3", f"{HERE.name}/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and c["file"].startswith(HERE.name + "/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)


def test_every_cell_reports_what_its_metrics_move():
    for name, cell in spec.cells().items():
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, name
        assert cell.per_layer, name
        for m in cell.per_layer:
            assert m["moves"] in e2e, (name, m["name"])
    listed = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", listed)) <= listed, m["name"]


def test_every_name_is_a_file():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (HERE / "reference" / f"{cfg['family']}.py").exists()
        assert (HERE / "work" / f"{cfg['family']}.py").exists()
        assert cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        traffic = json.loads((HERE / "workloads" / f"{w['name']}.json")
                             .read_text())
        assert traffic["pool"] >= 2
        assert set(traffic["limits"]) == {"fw_err", "inv_err"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.module("metrics", m["name"]).read)


def test_a_split_metric_is_read_by_its_quantity():
    """``job_ms_p95.host`` has no file of its own: ``job_ms_p95.py`` reads
    it."""
    assert not (HERE / "metrics" / "job_ms_p95.host.py").exists()
    split = spec.module("metrics", "job_ms_p95.host")
    assert split.__file__ == spec.module("metrics", "job_ms_p95").__file__


def test_a_cell_is_added_by_files_and_entries(tmp_path):
    """A copy of the benchmark gains a configuration, a cell and a per-layer
    metric by new files and new entries; the harness lists the cell and
    runs it (on the CPU, through the plain versions) with no other edit."""
    shutil.copytree(HERE, tmp_path / HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    new = tmp_path / HERE.name
    cfg = json.loads((HERE / "configs" / "dwt2_cdf97_lifting_f32.json")
                     .read_text())
    cfg["wavelet"] = "haar"
    (new / "configs" / "dwt2_haar_lifting_f32.json").write_text(
        json.dumps(cfg))
    (new / "workloads" / "dwt2_haar.tiny.json").write_text(json.dumps(
        {"shape": [2, 64, 64], "levels": 3, "pool": 3, "in_flight": 2,
         "check_jobs": 2, "trace_jobs": 4,
         "limits": {"fw_err": 1e-4, "inv_err": 1e-4}}))
    (new / "metrics" / "jobs_done.py").write_text(
        "def read(rec):\n    return float(rec.jobs)\n")
    bench["configs"].append(
        {"name": "dwt2_haar_lifting_f32", "source": "https://example.org",
         "file": f"{HERE.name}/configs/dwt2_haar_lifting_f32.json",
         "reduced": [], "why": "a test"})
    bench["workloads"].append(
        {"name": "dwt2_haar.tiny", "config": "dwt2_haar_lifting_f32",
         "traffic": "tiny", "chips": 1, "why": "a test"})
    bench["per_layer"].append(
        {"name": "jobs_done", "unit": "jobs", "better": "higher",
         "source": "host_clock", "layer": "front end: transforms.py",
         "moves": "gsamples_per_s", "workloads": ["dwt2_haar.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cells = spec.cells(tmp_path)
    assert set(cells) == set(spec.cells()) | {"dwt2_haar.tiny"}
    cell = cells["dwt2_haar.tiny"]
    assert [m["name"] for m in cell.per_layer][-1] == "jobs_done"
    assert "jobs_done" not in [m["name"] for m in
                               cells["dwt2_cdf97.img16k_L8"].per_layer]
    run = loop.Run(cell, 11, "cpu")
    run.setup()
    rec = run.window(0.2)
    assert run.judge(cell.traffic["limits"])["failed"] == 0
    reader = spec.module("metrics", "jobs_done", cell.root)
    assert reader.read(rec) == rec.jobs > 0


def _imports(path: Path):
    """(top-level names, files of this folder) that ``path`` imports."""
    tree = ast.parse(path.read_text())
    names, files = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [(a.name, 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [(node.module or "", node.level)]
            if node.level:
                mods += [((node.module + "." if node.module else "") + a.name,
                          node.level) for a in node.names]
        else:
            continue
        for mod, level in mods:
            if level:
                base = path.parent
                for _ in range(level - 1):
                    base = base.parent
                target = base.joinpath(*mod.split(".")) if mod else base
            elif mod.split(".")[0] == HERE.name:
                target = ROOT.joinpath(*mod.split("."))
            else:
                names.add(mod.split(".")[0])
                continue
            for f in (target.with_suffix(".py"), target / "__init__.py"):
                if f.exists():
                    files.append(f)
    return names, files


def _closure(starts):
    names, seen, todo = set(), set(), list(starts)
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        found, files = _imports(f)
        names |= found
        todo += files
    return names


@pytest.mark.parametrize("part", ["run.py", "calibrate.py", "configs",
                                  "workloads", "metrics", "reference",
                                  "work"])
def test_no_jax_in_the_import_closure(part):
    target = HERE / part
    starts = [target] if target.is_file() else sorted(target.rglob("*.py"))
    names = _closure(starts)
    assert "jax" not in names and "wavelets_tpu" not in names, names
    if part == "reference":
        assert "wavelets_tpu_torch" not in names, names
        assert names <= {"torch", "itertools", "json", "pathlib",
                         "__future__"}, names


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, f"{HERE.name}/run.py", "--workload",
         "dwt2_cdf97.img1k_L10", "--seed", str(2 ** 31 + 9), "--seconds",
         "1", "--trace", "0", *extra], cwd=cwd, capture_output=True,
        text=True, timeout=300)


def test_no_result_without_a_card():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
