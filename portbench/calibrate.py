"""Read the numbers that decide ``correct`` over many seeds in one process,
for setting a cell's limits: sound runs in the configuration's dtype, and
the control, the program's own path in the configuration's
``control_dtype``.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--seconds 2] [--fault unwritten]

Each seed is a whole run of ``loop.Run`` (set-up, a window of
``--seconds`` at the cell's own size and load, the judgement), as
``run.py`` makes it; set-up is paid once per seed, the process start
once.  With ``--fault``, the runs of ``--seeds`` have that fault of
``faults.py`` planted in the program, and are no sound runs.  Prints one
JSON line a seed, then one summary line: for each number the largest
reading of ``--seeds`` and the smallest control reading.  Needs the card,
as ``run.py`` does.
"""

import argparse
import json
import sys
from contextlib import nullcontext
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import faults, loop, spec  # noqa: E402
from portbench.run import _environment  # noqa: E402


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def readings(cell, seeds, seconds: float, dtype=None, device="cuda",
             fault=None):
    """One dict a seed: its jobs, the judged jobs, each compared number
    with where it was worst, and whether the cell's limits held; with
    ``fault`` (a name of ``faults.NAMES``) planted in the program."""
    import torch
    out = []
    for seed in seeds:
        run = loop.Run(cell, seed, device, dtype=dtype)
        with faults.planted(cell, fault) if fault else nullcontext():
            run.setup()
            rec = run.window(seconds)
        verdict = run.judge(cell.traffic["limits"])
        out.append({"seed": seed, "dtype": str(run.dtype), "jobs": rec.jobs,
                    "judged": verdict["judged"],
                    "correct": verdict["failed"] == 0,
                    **{name: [v, where] for name, (v, _, where)
                       in verdict["checks"].items()}})
        del run, rec
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, required=True)
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", choices=faults.NAMES, default=None)
    args = p.parse_args(argv)
    _environment()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    sound = readings(cell, args.seeds, args.seconds, fault=args.fault)
    control = readings(cell, args.control_seeds, args.seconds,
                       dtype=cell.config["control_dtype"])
    for row in sound + control:
        print(json.dumps(row))
    names = list(cell.traffic["limits"])
    print(json.dumps({
        "cell": cell.name, "card": torch.cuda.get_device_name(0),
        "fault": args.fault,
        "sound_max": {n: max((r[n][0] for r in sound), default=None)
                      for n in names},
        "control_min": {n: min((r[n][0] for r in control), default=None)
                        for n in names},
        "limits": cell.traffic["limits"],
        "sound_correct": sum(r["correct"] for r in sound),
        "control_correct": sum(r["correct"] for r in control)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
