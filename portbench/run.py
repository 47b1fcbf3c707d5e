#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights and traffic drawn from the seed, the program built and
warmed up), then the measured window, then with ``--trace 1`` a profiled
slice, then the check against the plain reference. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each compared number beside its limit, which also end
standard error. Exits non-zero without a result when there is no CUDA
device, too few of them, or a module of JAX or of the JAX package is loaded.
See ``portbench/README.md``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def say(*args):
    print(*args, file=sys.stderr, flush=True)


def cell_metrics(bench: dict, group: str, cell: str) -> list:
    return [m for m in bench[group] if cell in m.get("workloads", [cell])]


def report(bench: dict, cell: str, seed: int, seconds: float, trace: bool,
           device: str = "cuda", overrides=None, plant=None, t0=None, phases=None) -> dict:
    """One run of ``cell`` and its result line as a dict (everything but the
    look for a chip)."""
    from portbench.harness import core
    from portbench.harness import trace as tracing

    ctx = core.Context(cell, seed, seconds, trace, device=device, overrides=overrides, t0=t0,
                       phases=phases)
    record = core.run(ctx, plant=plant)
    say("set-up phases (s since start): " + json.dumps(
        {k: round(v, 3) for k, v in record["setup_phases"].items()}))
    say("host over the window: " + json.dumps(record["host"]))
    judged = core.judge(record["checks"], ctx.limits)
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, group, cell):
        reader = core.load_module(core.ROOT / "metrics" / f"{m['name']}.py",
                                  "portbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(judged) and all(j["ok"] for j in judged.values()),
           "attempted": record["samples"], "failed": record.get("failed", 0),
           "metrics": metrics, "device": record["device"]}
    if trace:
        out["breakdown"] = tracing.breakdown(record["trace"])
    if record.get("checked_rows_distinct") is not None:
        say(f"rows in the checked steps: {record['checked_rows_distinct']} distinct")
    out["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in judged.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import core

    bench_path = REPO / "BENCHMARK.json"
    if not bench_path.exists():
        say("no BENCHMARK.json at the root of the checkout")
        return 2
    bench = core.load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        say(f"BENCHMARK.json has no workload {args.workload!r}")
        return 2
    chips = int(cells[args.workload]["chips"])

    import torch

    phases = {"torch": time.perf_counter() - T0}
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"the cell needs {chips} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.cuda.reset_peak_memory_stats()
    phases["cuda"] = time.perf_counter() - T0
    out = report(bench, args.workload, args.seed, args.seconds, bool(args.trace), t0=T0,
                 phases=phases)
    found = core.forbidden_modules()
    if found:
        say("modules of JAX or of the JAX package are loaded: " + ", ".join(found))
        return 3
    for name, c in out["checks"].items():
        say(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
