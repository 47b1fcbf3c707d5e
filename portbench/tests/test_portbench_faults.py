"""A run with the timed path broken underneath reads ``correct`` false.

Each test skips the look for a chip and drives the rest of a run of a
cell at tiny widths on the CPU, with its committed limits, a fault planted
in the program after set-up: a train step that returns its state
unchanged; a train step that leaves out half of its batch (the loss
averaged over the rest); an act whose voxel is mirrored where the argmax
produces it. (No cell spans chips, so no exchange can be left out.)"""

import pytest
from conftest import tiny

from portbench import run

ACT_CELLS = ("scene100_act_b8", "crop50_dual_b1", "scene100_act_b1")


def frozen_step(entry):
    real = entry.agent._train_step

    def step(state, batch, generator):
        _, metrics = real(state, batch, generator)
        return state, metrics

    entry.agent._train_step = step


def half_batch(entry):
    real = entry.agent._train_step

    def step(state, batch, generator):
        b = batch["reward"].shape[0]
        kept = {k: v[: b // 2] if getattr(v, "ndim", 0) and v.shape[0] == b else v
                for k, v in batch.items()}
        return real(state, kept, generator)

    entry.agent._train_step = step


def failing(out):
    return [k for k, c in out["checks"].items() if c["limit"] is not None
            and c["value"] > c["limit"]]


@pytest.mark.parametrize("plant", (frozen_step, half_batch))
def test_train_fault_fails(bench, plant):
    out = run.report(bench, "crop50_train_b8", 21, 0.3, False, device="cpu",
                     overrides=tiny("crop50_train_b8"), plant=plant)
    assert out["correct"] is False
    assert failing(out), out["checks"]


@pytest.mark.parametrize("cell", ACT_CELLS)
def test_altered_voxel_fails(bench, cell, monkeypatch):
    from voxactb_tpu_torch.agents import qfunction

    real = qfunction._flat_argmax_3d

    def mirrored(q):
        return q.shape[1] - 1 - real(q)

    monkeypatch.setattr(qfunction, "_flat_argmax_3d", mirrored)
    out = run.report(bench, cell, 22, 0.3, False, device="cpu", overrides=tiny(cell))
    assert out["correct"] is False
    assert "gap" in failing(out), out["checks"]
