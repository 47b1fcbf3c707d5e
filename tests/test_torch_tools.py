"""The port's tools (voxactb_tpu_torch/tools, utils/profiling.py): the cost
model held equal to tools/cost_model.py and to its invariants; every stage of
the JAX profilers has a counterpart or a stated reason; the profilers and
probes run small on the CPU; the entry points refuse to fall back to the CPU;
the profiling instrumentation's gauges and trace (its spans and counters:
tests/test_torch_tracing.py)."""

import ast
import importlib.util
import json
import os
import pathlib

import pytest
import torch

from voxactb_tpu_torch.tools import cost_model, probe_smem, profile_quick, profile_stages, roofline
from voxactb_tpu_torch.utils.profiling import device_trace, host_gauges


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_COST = _load("tools/cost_model.py", "jax_tools_cost_model")


# -- cost model --------------------------------------------------------------------


@pytest.mark.parametrize("n", [20, 50, 100])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("heads_t", [1, 2])
def test_act_cost_equals_the_jax_tool(n, batch, fused, heads_t):
    kw = dict(n=n, batch=batch, fused_decoder=fused, fused_front=fused, heads_t=heads_t)
    assert cost_model.act_cost(**kw) == JAX_COST.act_cost(**kw)


@pytest.mark.parametrize("kw", [dict(), dict(n=100, batch=1), dict(remat=True),
                                dict(n=50, batch=16, param_count=10e6, depth=4)])
def test_train_cost_equals_the_jax_tool(kw):
    assert cost_model.train_cost(**kw) == JAX_COST.train_cost(**kw)


@pytest.mark.parametrize("kw", [dict(), dict(img=512, depth=12, dim=768, heads=12,
                                             n_global=2)])
def test_sam_encoder_cost_equals_the_jax_tool(kw):
    assert cost_model.sam_encoder_cost(**kw) == JAX_COST.sam_encoder_cost(**kw)


def test_speed_of_light_equals_the_jax_tool_and_defaults_to_the_h100():
    c = cost_model.act_cost(n=100, batch=8, fused_decoder=True, fused_front=True)
    for peaks in ((989e12, 3.35e12), (67e12, 3.35e12), (197e12, 819e9)):
        assert cost_model.speed_of_light(c, *peaks) == JAX_COST.speed_of_light(c, *peaks)
    assert cost_model.H100_PEAK_BF16_FLOPS == 989e12
    assert cost_model.H100_PEAK_F32_FLOPS == 67e12
    assert cost_model.H100_HBM_BW == 3.35e12
    assert cost_model.speed_of_light(c) == JAX_COST.speed_of_light(c, 989e12, 3.35e12)


# tests/test_cost_model.py's invariants, on the port's copy


@pytest.mark.parametrize("fused", [False, True])
def test_act_cost_scales_linearly_with_batch(fused):
    c1 = cost_model.act_cost(n=50, batch=1, fused_decoder=fused, fused_front=fused)
    c8 = cost_model.act_cost(n=50, batch=8, fused_decoder=fused, fused_front=fused)
    assert c8["flops"] == pytest.approx(8 * c1["flops"])
    assert c8["activation_bytes"] == pytest.approx(8 * c1["activation_bytes"])
    assert c8["weight_bytes"] == pytest.approx(c1["weight_bytes"])


@pytest.mark.parametrize("batch", [1, 8])
def test_stage_dicts_sum_to_totals(batch):
    c = cost_model.act_cost(n=100, batch=batch)
    assert sum(c["flops_by_stage"].values()) == pytest.approx(c["flops"])
    assert sum(c["bytes_by_stage"].values()) == pytest.approx(c["activation_bytes"])
    assert c["bytes"] == pytest.approx(c["activation_bytes"] + c["weight_bytes"])


def test_train_cost_remat_trades_bytes_for_flops():
    base = cost_model.train_cost(n=50, batch=8)
    remat = cost_model.train_cost(n=50, batch=8, remat=True)
    assert remat["activation_bytes"] < base["activation_bytes"]
    assert remat["flops"] > base["flops"]
    assert base["fwd_flops"] < base["flops"]


def test_speed_of_light_bound_labels():
    c = cost_model.act_cost(n=100, batch=1)
    sol = cost_model.speed_of_light(c)
    assert sol["sol_ms"] == pytest.approx(max(sol["compute_ms"], sol["memory_ms"]))
    assert sol["bound"] in ("compute", "memory")


# -- stage tables ------------------------------------------------------------------


def _jax_stage_names(rel):
    """The keys of the ``stages = {...}`` dict in a JAX profiler's source."""
    tree = ast.parse((ROOT / rel).read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "stages" for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError(f"{rel} has no stages dict")


@pytest.mark.parametrize("rel, port", [("tools/profile_stages.py", profile_stages.STAGES),
                                       ("tools/profile_quick.py", profile_quick.STAGES)])
def test_every_jax_stage_has_a_counterpart_or_a_reason(rel, port):
    names = _jax_stage_names(rel)
    assert len(names) >= 7
    missing = [s for s in names if s not in port and s not in profile_stages.NO_COUNTERPART]
    assert not missing, missing
    assert not set(port) - set(names), "a port stage the JAX tool does not have"
    assert not set(port) & set(profile_stages.NO_COUNTERPART)


def test_only_the_scatter_variants_have_no_counterpart():
    assert set(profile_stages.NO_COUNTERPART) == {
        "front_fused_cap64@100", "front_fused_unroll8@100", "front_fused_matmul@100"}
    for name, knob in (("cap64", "row_cap"), ("unroll8", "scatter_unroll"),
                       ("matmul", "scatter_matmul")):
        assert knob in profile_stages.NO_COUNTERPART[f"front_fused_{name}@100"]


# -- the tools run small on the CPU -------------------------------------------------


def _json_lines(out):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_profile_stages_runs_small(capsys):
    only = ["front_fused@", "decoder_v2_tail", "grid_copy_1row", "voxelize", "ss0",
            "globalmax", "patchify", "trans_k3", "attention_trunk"]
    got = profile_stages.main(device="cpu", n=10, n_chain=2, only=only)
    lines = _json_lines(capsys.readouterr().out)
    assert lines[0] == {"device": "cpu"}
    stages = [r for r in lines if "stage" in r]
    want = [s for s in profile_stages.STAGES if any(o in s for o in only)
            and not s.startswith("real_")]
    assert [r["stage"] for r in stages] == want == list(got)
    assert all(set(r) == {"stage", "per_step_ms", "compile_s"} and r["per_step_ms"] > 0
               for r in stages)
    assert lines[-1]["batch"] == 1 and set(lines[-1]["all"]) == set(want)


def test_profile_quick_runs_small(capsys):
    got = profile_quick.main(device="cpu", n=10, n_chain=2,
                             only=["preprocess", "voxelize", "ss0", "final", "trans"])
    assert set(got) == set(profile_quick.STAGES) - {"full_qforward@100",
                                                    "fused_upsample20->100"}
    assert all(v > 0 for v in got.values())


def test_probe_smem_and_roofline_run_small(capsys):
    res = probe_smem.main(device="cpu", reps=1)
    # the plain version takes any scratch: every size passes on the CPU
    assert res["device"] == "cpu" and all(res["scratch_kb"].values())
    assert list(res["scratch_kb"]) == list(probe_smem.SCRATCH_KB)
    assert res["shifted_einsum"]["rel_err"] < 1e-5
    out = roofline.main(device="cpu", n_chain=2, rows=8, mm=64)
    assert set(out) == {"read_reduce", "rw_elementwise", "matmul"}
    assert out["matmul"]["probe"] == "matmul64"
    assert "shifted einsum ok" in capsys.readouterr().out


@pytest.mark.parametrize("entry", [
    lambda: profile_stages.main(), lambda: profile_quick.main(), lambda: roofline.main(),
    lambda: probe_smem.main(), lambda: probe_smem.probe_scratch(4096),
    lambda: probe_smem.probe_shifted_einsum()])
def test_entry_points_raise_without_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


# -- utils/profiling: host gauges and the device trace -------------------------------


def test_host_gauges():
    g = host_gauges()
    assert isinstance(g, dict)  # psutil optional; present -> has rss
    if g:
        assert g["host/rss_gb"] > 0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(None) as prof:
        assert prof is None
    for _ in range(2):
        with device_trace(str(tmp_path), device="cpu") as prof:
            torch.ones(64, 64) @ torch.ones(64, 64)
        assert prof is not None
    traces = sorted(f for f in os.listdir(tmp_path) if f.startswith("trace_"))
    assert len(traces) == 2
    events = json.loads((tmp_path / traces[0]).read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
