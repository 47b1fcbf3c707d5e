#!/usr/bin/env python3
"""Read the numbers that set a cell's limits, on the card, at the cell's size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 3]

For each seed, in one process: a run of the cell with a short window and
its check (the program's readings), then the control, the plain reference
computed in fp8 in the program's place and read the same way; for a train
cell also a train step that leaves out half of its batch and one that
returns its state unchanged (the reference in the program's place), and
what each number is made of. One JSON line per seed, then one with each number's
largest program reading and smallest control and fault readings. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def readings(cell: str, seed: int, seconds: float, device: str = "cuda",
             overrides=None) -> dict:
    """One seed's program, control and (train) half-batch readings."""
    from portbench.harness import core

    def after(entry):
        out = {"control": entry.control()}
        if hasattr(entry, "half_batch"):
            out["half_batch"] = entry.half_batch()
            out["frozen"] = entry.frozen()
            out["details"] = entry.details()
        return out

    ctx = core.Context(cell, seed, seconds, False, device=device, overrides=overrides)
    record = core.run(ctx, after=after)
    return {"seed": seed, "program": record["checks"], **record["after"]}


def summary(rows) -> dict:
    out = {"program_max": {}, "control_min": {}, "half_batch_min": {}, "frozen_min": {}}
    for row in rows:
        for group, key, pick in (("program", "program_max", max),
                                 ("control", "control_min", min),
                                 ("half_batch", "half_batch_min", min),
                                 ("frozen", "frozen_min", min)):
            for name, v in row.get(group, {}).items():
                d = out[key]
                d[name] = v if name not in d else pick(d[name], v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        row = readings(args.workload, seed, args.seconds)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": args.workload, **summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
