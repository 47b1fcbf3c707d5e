"""The run loop: one run of one cell, from its files to the result line.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``) and the
entry it drives (``entries/<entry>.py``); ``BENCHMARK.json`` at the root says
which metrics it reports, and each metric is read from the run's record by
``metrics/<metric>.py``. A new cell, configuration, traffic mix or metric is
a new file and a new entry in ``BENCHMARK.json``.

A run: set-up (weights, traffic, the program, warm-up), the measured window
of ``--seconds``, with ``--trace 1`` a profiled slice of the cell's
``trace_units`` further units, then the program is released and its
outputs are held to the plain reference (``entry.check``).
"""

from __future__ import annotations

import importlib.util
import json
import os
import resource
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "voxactb_tpu")


class RunError(Exception):
    """A run that cannot give a result."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise RunError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each random stream of a run."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(2, np.uint64)[0] >> 1)


class Context:
    """What one run needs: the cell's files, the seed and the device.
    ``overrides`` (tests only) replaces keys of the configuration's
    ``method`` group, of the traffic and of the cell."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", overrides: Optional[dict] = None,
                 t0: Optional[float] = None, phases: Optional[dict] = None):
        self.t0 = time.perf_counter() if t0 is None else t0
        self.cell_name = cell
        path = ROOT / "workloads" / f"{cell}.json"
        if not path.exists():
            raise RunError(f"no cell file {path}")
        overrides = overrides or {}
        self.cell = {**load_json(path), **overrides.get("cell", {})}
        self.config = load_json(ROOT / "configs" / f"{self.cell['config']}.json")
        self.traffic = {**load_json(ROOT / "traffic" / f"{self.cell['traffic']}.json"),
                        **overrides.get("traffic", {})}
        self.method_overrides = overrides.get("method", {})
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.limits = self.cell.get("limits", {})
        self.phases = dict(phases or {})

    def mark(self, phase: str) -> None:
        """Note the seconds since process start at the end of a set-up phase."""
        self.phases[phase] = time.perf_counter() - self.t0

    def method(self, policy: str) -> dict:
        """A policy's ``MethodConfig`` keys: the configuration's ``method``
        group, the policy's own keys, then any overrides."""
        pol = self.config["policies"][policy]
        return {**self.config["method"], **pol["method"], **self.method_overrides}

    def low_dim_size(self, policy: str) -> int:
        return self.config["policies"][policy]["low_dim_size"]

    def spec(self, policy: str):
        from portbench.reference.qnet import spec_from

        return spec_from(self.method(policy), self.config["model"], self.low_dim_size(policy))

    def rng(self, stream: int) -> np.random.Generator:
        return np.random.default_rng(sub_seed(self.seed, stream))


def device_info(device: str, chips: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}
    keys = ("power_limit_w", "clock_sm_mhz", "temperature_c")
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit,clocks.sm,temperature.gpu",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout.splitlines()[0]
        info.update(zip(keys, (float(v) for v in out.split(","))))
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info.update(dict.fromkeys(keys))
    return info


def cpu_ticks() -> dict:
    """The machine's CPU time by kind, in clock ticks (``/proc/stat``; empty
    where there is none): ``steal`` is time a hypervisor gave to others."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()[1:]
    except OSError:
        return {}
    names = ("user", "nice", "system", "idle", "iowait", "irq", "softirq", "steal")
    return dict(zip(names, (int(v) for v in fields)))


def host_diagnostics(usage0, usage1, ticks0: dict, ticks1: dict, host_s: float,
                     window_s: float, units: int) -> dict:
    """What the host did over the window, to tell a slow host from a slow
    device: the seconds until the last unit was handed over (before the
    closing synchronise), the process's CPU seconds, its context switches
    forced by other work, the machine's stolen CPU seconds, the load
    average and the cores it may run on."""
    hz = os.sysconf("SC_CLK_TCK")
    stolen = (ticks1.get("steal", 0) - ticks0.get("steal", 0)) / hz if ticks0 else None
    return {"dispatch_s": host_s, "drain_s": window_s - host_s,
            "cpu_s": (usage1.ru_utime - usage0.ru_utime) + (usage1.ru_stime - usage0.ru_stime),
            "forced_switches": usage1.ru_nivcsw - usage0.ru_nivcsw, "stolen_s": stolen,
            "loadavg_1m": os.getloadavg()[0], "cores": len(os.sched_getaffinity(0)),
            "units": units}


def reservoir_keep(rng: np.random.Generator, kept: list, item, seen: int, k: int) -> None:
    """Reservoir sampling: after ``seen`` items (this one included) ``kept``
    holds a uniform sample of ``k`` of them."""
    if len(kept) < k:
        kept.append(item)
    else:
        j = int(rng.integers(seen))
        if j < k:
            kept[j] = item


def run(ctx: Context, plant=None, after=None) -> Dict:
    """One run of ``ctx``'s cell. ``plant``, when given, is called with the
    entry after its set-up (tests plant faults there); ``after`` with the
    entry once its check is done, and what it returns is kept as the
    record's ``after``. Returns the record: the window's counts and times,
    the trace, the checks and the device."""
    import torch

    entry_mod = load_module(ROOT / "entries" / f"{ctx.cell['entry']}.py",
                            f"portbench_entry_{ctx.cell['entry']}")
    entry = entry_mod.Entry(ctx)
    if plant is not None:
        plant(entry)
    entry.warm()
    entry.sync()
    setup_s = time.perf_counter() - ctx.t0
    ctx.mark("warm")

    units = samples = 0
    latencies = []
    usage0, ticks0 = resource.getrusage(resource.RUSAGE_SELF), cpu_ticks()
    start = time.perf_counter()
    while time.perf_counter() - start < ctx.seconds:
        n, latency = entry.unit(window=True)
        units += 1
        samples += n
        if latency is not None:
            latencies.append(latency)
    host_s = time.perf_counter() - start
    entry.sync()
    window_s = time.perf_counter() - start
    usage1, ticks1 = resource.getrusage(resource.RUSAGE_SELF), cpu_ticks()
    record = {"cell": ctx.cell_name, "setup_s": setup_s, "window_s": window_s,
              "units": units, "samples": samples, "latencies_s": latencies,
              "flops_per_unit": entry.flops_per_unit(), **entry.window_extras(),
              "setup_phases": dict(ctx.phases),
              "host": host_diagnostics(usage0, usage1, ticks0, ticks1, host_s, window_s,
                                       units)}
    if ctx.trace:
        from portbench.harness import trace

        k = int(ctx.cell["trace_units"])

        def slice_units():
            for _ in range(k):
                entry.unit(window=False)
            return k

        rec = trace.traced(slice_units, ctx.device)
        rec.update(entry.trace_extras(rec))
        record["trace"] = rec
    chips = int(ctx.cell.get("chips", 1))
    record["device"] = device_info(ctx.device, chips)
    if ctx.trace and "trace" in record:
        record["device"]["busy_s"] = record["trace"]["busy_s"]
        record["device"]["window_s"] = record["trace"]["window_s"]
    entry.release()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    record["checks"] = entry.check()
    if after is not None:
        record["after"] = after(entry)
    return record


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit; a number without a limit, or
    one that is not finite, fails."""
    out = {}
    for name, value in checks.items():
        limit = limits.get(name)
        ok = limit is not None and np.isfinite(value) and value <= limit
        out[name] = {"value": float(value), "limit": limit, "ok": bool(ok)}
    return out


def p95(values) -> float:
    return statistics.quantiles(values, n=100, method="inclusive")[94]
