"""The per-layer metrics that read the program's own spans and counters
(``metrics/_program.py``) read a number in a ``--trace 1`` run of their
cell at tiny widths on the CPU, and nothing in a run of a program that
keeps no collection."""

import pytest
from conftest import tiny

from portbench import run

PROGRAM_METRICS = {
    "scene100_act_b1": ("act_prep_ms.latency", "act_dispatch_ms.latency",
                        "d2h_copies_per_act.latency"),
    "crop50_train_b8": ("update_host_ms.train", "feed_worker_ms.train",
                        "feed_stall_pct.train"),
}


@pytest.mark.parametrize("cell", sorted(PROGRAM_METRICS))
def test_program_metrics_read_in_a_traced_run(bench, cell):
    names = PROGRAM_METRICS[cell]
    assert {m["name"] for m in run.cell_metrics(bench, "per_layer", cell)} >= set(names)
    out = run.report(bench, cell, 2_900_000_017, 0.3, True, device="cpu",
                     overrides=tiny(cell))
    got = {k: out["metrics"][k]["value"] for k in names}
    assert all(v is not None and v >= 0 for v in got.values()), got
    if cell == "scene100_act_b1":
        assert got["d2h_copies_per_act.latency"] == 6
        assert 0 < got["act_prep_ms.latency"] < got["act_dispatch_ms.latency"]
    else:
        assert got["update_host_ms.train"] > 0 and got["feed_worker_ms.train"] > 0
        assert 0 <= got["feed_stall_pct.train"] <= 100


def test_program_metrics_read_nothing_without_a_collection(bench, monkeypatch):
    from voxactb_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "last_collection")  # a program without the spans
    out = run.report(bench, "scene100_act_b1", 5, 0.2, True, device="cpu",
                     overrides=tiny("scene100_act_b1"))
    assert not set(out["metrics"]) & set(PROGRAM_METRICS["scene100_act_b1"])
