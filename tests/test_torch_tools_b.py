"""The six root probes of the port (``voxactb_tpu_torch/tools/probe_op_floor``,
``probe_act_ab``, ``probe_decoder_ab``, ``probe_decoder_parts``,
``probe_front_batch``, ``probe_front_matmul``) on the CPU at 10^3 with one
chain: every JSON key of the JAX tool is printed or listed in the tool's
``NO_COUNTERPART``, the A/B tools' action and argmax checks hold, and the
entry points raise without CUDA."""

import importlib
import json
import pathlib
import re

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TINY = dict(num_latents=16, latent_dim=32, transformer_depth=1, cross_dim_head=16,
            latent_dim_head=16, latent_heads=2)

# the keys each JAX tool prints (dict keys, stage names before their '@N_bB',
# the variants it names), each checked to stand in the JAX tool's source
JAX_KEYS = {
    "probe_op_floor": ["op_floor", "act_program", "chain16_ms", "chain128_ms", "per_op_ms",
                       "fixed_fetch_ms", "entry_ops", "by_kind", "error"],
    "probe_act_ab": ["base", "flash", "v2c", "unroll8", "all", "compiled", "n", "batch",
                     "action_mismatch", "elements"],
    "probe_decoder_ab": ["v1", "v2", "v3"],
    "probe_decoder_parts": ["full", "nostats", "notrans", "tap1", "dma", "n", "medians_ms",
                            "shares", "stats_ms", "trans_ms", "eight_taps_ms", "dma_floor_ms",
                            "--cpu", "compiled", "cpu_smoke"],
    "probe_front_batch": ["stage", "per_step_ms", "compile_s", "front_fused", "sort_prepass",
                          "voxelize_xla", "decoder_v2", "all"],
    "probe_front_matmul": ["front_stage", "serial8", "matmul", "compiled", "n", "batch",
                           "action_mismatch", "compile_fail", "err", "all"],
}

# keys both tools print only when their check fails: the port's tool must print them then
ON_FAILURE = {"probe_act_ab": ["action_mismatch", "elements"],
              "probe_front_matmul": ["action_mismatch"]}

RUNS = {
    "probe_op_floor": dict(n=10, img=16, **TINY),
    "probe_act_ab": dict(grids=((10, 1), (10, 2)), n_chain=1, img=16, reps=1, **TINY),
    "probe_decoder_ab": dict(n=10, chain=1, reps=1),
    "probe_decoder_parts": dict(n=10, reps=1),
    "probe_front_batch": dict(chain=1, front_grids=((10, 1), (10, 2)), decoder_batches=(1, 2),
                              decoder_n=10, points=500),
    "probe_front_matmul": dict(grids=((10, 1),), n_chain=1, stage_chain=1, img=16, **TINY),
}


def _printed_keys(lines):
    """Every key of every JSON line, with the names that stand as values
    (stages, variants built) and without their grid suffixes."""
    keys = set()

    def walk(obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                keys.add(re.sub(r"(@.*|_?n\d+_b\d+)$", "", k))
                if k in ("stage", "front_stage", "compiled", "argmax_check") and \
                        isinstance(v, str):
                    keys.add(re.sub(r"(@.*| argmax.*)$", "", v))
                walk(v)

    for line in lines:
        walk(json.loads(line))
    return keys - {""}


@pytest.fixture(scope="module")
def runs():
    """Each tool's return value, JSON lines and module, run once."""
    import contextlib
    import io

    out = {}
    for name, kw in RUNS.items():
        mod = importlib.import_module(f"voxactb_tpu_torch.tools.{name}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = mod.main(device="cpu", **kw)
        out[name] = (result, [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")],
                     mod)
    return out


@pytest.mark.parametrize("name", list(JAX_KEYS))
def test_keys_are_the_jax_tools_or_have_no_counterpart(runs, name):
    src = (ROOT / "tools" / f"{name}.py").read_text()
    for k in JAX_KEYS[name]:
        assert k in src, (name, k)
    _, lines, mod = runs[name]
    printed = _printed_keys(lines)
    ours = pathlib.Path(mod.__file__).read_text()
    printed |= {k for k in ON_FAILURE.get(name, ()) if f'"{k}"' in ours}
    missing = [k for k in JAX_KEYS[name] if k not in printed and k not in mod.NO_COUNTERPART]
    assert not missing, (name, missing, sorted(printed))
    # a key listed as having no counterpart is not printed after all
    assert not set(mod.NO_COUNTERPART) & printed, name
    assert all(isinstance(v, str) and v for v in mod.NO_COUNTERPART.values())


def test_act_ab_variants_decode_the_same_actions(runs):
    result, lines, _ = runs["probe_act_ab"]
    assert result["mismatches"] == []
    assert set(result["results"]) == {"n10_b1", "n10_b2"}
    for row in result["results"].values():
        assert set(row) == {"base", "flash", "all"} and row["all"] == row["flash"]


def test_decoder_ab_argmax_agrees(runs):
    result, _, _ = runs["probe_decoder_ab"]
    assert result["argmax_equal"] == {"v3": True}
    assert set(result["ms"]) == {"v1", "v3"}


def test_front_matmul_action_check_holds(runs):
    result, _, _ = runs["probe_front_matmul"]
    assert result["mismatches"] == []
    assert set(result["results"]) == {"front_n10_b1", "act_n10_b1"}


def test_op_floor_counts_the_act(runs):
    result, _, _ = runs["probe_op_floor"]
    assert result["act_program"]["entry_ops"] > 10
    assert len(result["act_program"]["by_kind"]) == 12
    assert set(result["op_floor"]) == {"chain16_ms", "chain128_ms", "per_op_ms",
                                       "fixed_fetch_ms"}


def test_front_batch_and_decoder_parts_report_every_stage(runs):
    fb, _, _ = runs["probe_front_batch"]
    assert set(fb) == {f"{k}@10_b{b}" for k in ("front_fused", "front_plain", "voxelize_xla")
                       for b in (1, 2)} | {"decoder_v2@10_b1", "decoder_v2@10_b2"}
    parts, _, _ = runs["probe_decoder_parts"]
    med = parts["medians_ms"]
    # off the card the launches have no device time
    assert med["conv"] is None and med["trans_stats"] is None and med["full"] > 0


@pytest.mark.parametrize("name", list(RUNS))
def test_entry_points_raise_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"voxactb_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main()
