"""Run one cell of ``BENCHMARK.json`` once, on the CUDA card, and print one
JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--export-trace <file.json>]

From the root of a checkout.  Set-up (process start to the first timed
job) loads ``wavelets_tpu_torch`` (its ``nvcc`` build lives in the
checkout, under ``wavelets_tpu_torch/_build``), makes the cell's input
pool on the card from the seed and warms up its shapes.  The window runs
jobs for ``--seconds``; then the kept jobs are judged against the float64
reference.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from one profiler session over a
sub-window.  Every metric is read from the run's record by
``metrics/<name>.py``.  Standard error ends with each compared number
beside its limit; the JSON line carries them last, under ``checks``.

Exits non-zero, printing no result, without a card (or with fewer cards
than the cell asks for), or when JAX, ``jaxlib``, ``flax`` or the JAX
package ``wavelets_tpu`` is loaded in the process once the window has
closed.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "wavelets_tpu")
TOP = 10


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--export-trace", default=None,
                   help="write the profiler's chrome trace here (traced "
                        "runs only)")
    return p.parse_args(argv)


def _environment() -> None:
    """No route switch of the port set, so ``routes2d()`` picks the level
    route; any cache a library keeps at a path it is given, inside the
    checkout."""
    for key in [k for k in os.environ if k.startswith("WAVELETS_TPU_")]:
        del os.environ[key]
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / ".portbench_cache" / sub))
    sys.path.insert(0, str(ROOT))


def _card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not available ({e})"


def _peaks(kind: str, dtype: str):
    table = json.loads((ROOT / "portbench" / "peaks.json").read_text())
    entry = table.get(kind)
    if entry is None or dtype not in entry["flops_per_s"]:
        return None
    return {"bytes_per_s": entry["bytes_per_s"],
            "flops_per_s": entry["flops_per_s"][dtype]}


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])][:TOP]


def main(argv=None) -> int:
    args = _args(argv)
    _environment()
    import torch
    from portbench import loop, spec
    from portbench.trace import is_library, short_name
    imported_s = time.perf_counter() - _T0

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    t = time.perf_counter()
    torch.cuda.init()
    torch.empty(1, device=device)
    cuda_s = time.perf_counter() - t
    run = loop.Run(cell, args.seed, device, tracing=bool(args.trace),
                   export=args.export_trace)
    run.setup()
    setup_s = time.perf_counter() - _T0
    rec = run.window(args.seconds)
    rec.setup_s = setup_s
    kind = torch.cuda.get_device_name(device)
    rec.peaks = _peaks(kind, cell.config["dtype"])
    verdict = run.judge(cell.traffic["limits"])

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"portbench: the process loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3

    log = lambda *a: print(*a, file=sys.stderr)  # noqa: E731
    log(f"card: {_card_line()}")
    phases = {"imports": imported_s, "CUDA": cuda_s, **run.phases}
    log(f"set-up {setup_s:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
        + f"); window {rec.seconds:.3f} s, {rec.jobs} jobs")
    device_info = {"platform": "gpu", "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": rec.peak_bytes}
    result = {"correct": verdict["failed"] == 0 and verdict["judged"] > 0,
              "attempted": rec.jobs, "failed": verdict["failed"]}
    metrics = {}
    wanted = cell.per_layer if args.trace else cell.end_to_end
    for m in wanted:
        value = spec.module("metrics", m["name"], cell.root).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info
    if rec.trace is not None:
        tr = rec.trace
        device_info.update(busy_s=tr.busy, window_s=tr.window)
        library = [k[0] for k in tr.kernels if is_library(k[0])]
        ours = len(tr.kernels) - len(library)
        launched = sum(rec.launches.values())
        log(f"trace: {rec.trace_jobs} jobs, {len(tr.kernels)} kernels "
            f"({ours} of the program, {len(library)} library: "
            f"{sorted(set(map(short_name, library)))}); launch "
            f"counters {launched} {rec.launches}")
        if ours != launched:
            log(f"trace: MISMATCH, the trace holds {ours} of the program's "
                f"kernels where its counters rose by {launched}")
        result["breakdown"] = {"device_ops": _top(tr.ops),
                               "idle_gaps": _top(tr.gaps)}
    checks = {name: {"value": v, "limit": lim}
              for name, (v, lim, _) in verdict["checks"].items()}
    checks["judged_jobs"] = {"value": verdict["judged"], "limit": 1}
    result["checks"] = checks
    for name, (v, lim, where) in verdict["checks"].items():
        log(f"check {name} {v!r} limit {lim!r} (worst: {where})")
    log(f"check judged_jobs {verdict['judged']} of {rec.jobs} (at least 1)")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
