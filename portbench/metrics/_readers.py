"""Readers shared by the metric files: each takes a run's record (see
``harness/core.run``) and returns a number, or None where the record holds
nothing to read."""

from __future__ import annotations

from portbench.harness import flops, trace
from portbench.harness.core import p95


def per_second(record):
    return record["samples"] / record["window_s"]


def act_ms_p95(record):
    lat = record["latencies_s"]
    return p95(lat) * 1e3 if len(lat) >= 20 else None


def mfu_pct(record):
    """Model FLOPs of the window's completed units over the window at the
    bf16 peak."""
    return 100.0 * record["flops_per_unit"] * record["units"] / (
        record["window_s"] * flops.PEAK_BF16_FLOPS)


def _busy_per_unit(record):
    """Device seconds per unit from the traced slice, or None."""
    t = record.get("trace")
    if not t or t["busy_s"] <= 0.0 or not t["units"]:
        return None
    return t["busy_s"] / t["units"]


def device_idle_pct(record):
    """Share of the window with no kernel on the device: the traced slice's
    device busy time per unit against the untraced window's wall time per
    unit (the profiler's own host cost stays out of the wall time)."""
    busy = _busy_per_unit(record)
    if busy is None:
        return None
    return 100.0 * (1.0 - busy * record["units"] / record["window_s"])


def host_ms_per_act(record):
    """(window wall - device busy time) per act: the untraced window's wall
    time per act less the traced slice's device time per act."""
    busy = _busy_per_unit(record)
    if busy is None:
        return None
    per_unit = record["window_s"] / record["units"] - busy
    return 1e3 * per_unit * record["units"] / record["samples"]


def roofline_pct(record, bound_key, device_s):
    t = record.get("trace")
    if not t or bound_key not in t or device_s(t) <= 0.0:
        return None
    return 100.0 * t[bound_key] / device_s(t)


def k4_device_s(t):
    return trace.kernel_seconds(t, "train_fwd", "train_bwd_dq", "train_bwd_dkv")


def k3_device_s(t):
    return (trace.kernel_seconds(t, "tail_conv", "tail_trans_stats")
            + trace.seconds_following(t, "stats_combine", "tail_trans_stats"))
