"""The port's policy-diagnosis probes (voxactb_tpu_torch/tools/probe_*.py)
against the JAX package's tools/ on the same inputs: the same tiny open_jar
config (2 sim demos, 16^2 cameras, a 10^3 grid, a narrow Perceiver), the
same replay contents, and agents with the same weights (the port's seeded
weights handed to the JAX agents through ``weights.tensors_to_flax_tree``).
The JAX tools are loaded by path, their ``load_agent`` replaced by one that
hands back those agents; their printed output is parsed. Integer outputs are
exact: pair counts, exact-match rates and misses, ``trans_idx_err``,
``rot_idx_err``, grip bits, the hybrid rows, the live rollout's reward. The
live log's continuous actions match to 5 decimals and the input-diff
distances within the JAX tool's printed rounding (stated below)."""

import ast
import contextlib
import importlib.util
import io
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from voxactb_tpu_torch.tools import (probe_hybrid_inputs, probe_input_diff,
                                    probe_policy_open_loop, probe_replay_accuracy,
                                    probe_replay_ambiguity)

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOOLS = os.path.join(ROOT, "tools")
TASK = "open_jar"
TINY = ["rlbench.task_name=open_jar", 'rlbench.tasks=["open_jar"]', "rlbench.demo_path=sim",
        "rlbench.demos=2", 'rlbench.cameras=["wrist","wrist2"]',
        "rlbench.camera_resolution=[16,16]", "method.voxel_sizes=[10]",
        "method.num_latents=16", "method.latent_dim=32", "method.transformer_depth=1",
        "method.cross_dim_head=16", "method.latent_dim_head=16", "method.final_dim=8",
        "method.crop_target_obj_voxel=True", "method.crop_radius=0.3",
        "method.keypoint_discovery_no_duplicate=True", "framework.tensorboard_logging=False"]
ARMS = {"dominant": ["method.which_arm=dominant", "method.arm_pred_loss=True"],
        "assistive": ["method.which_arm=assistive"]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_tool(name):
    """``tools/<name>.py`` as a module of its own, with ``tools/`` importable
    (the probes import their siblings by name). The JAX compilation cache
    directory the tools set at import is put back."""
    cache_dir = jax.config.jax_compilation_cache_dir
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    spec = importlib.util.spec_from_file_location(name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return mod


def _printed(fn, *args, **kw):
    """``fn``'s return value and what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(*args, **kw)
    return ret, out.getvalue()


def _language(text):
    r = np.random.default_rng(len(text))
    return (r.normal(size=(1024,)).astype(np.float32),
            r.normal(size=(77, 512)).astype(np.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_sim_language():
    """The two sims' default language towers are random-init CLIP text
    encoders drawn by each framework (their embeddings differ by design):
    both sides' sims take one seeded encoder here."""
    import voxactb_tpu.sim.environment as jax_sim
    import voxactb_tpu_torch.sim.environment as sim

    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_sim, sim):
            mp.setattr(mod, "default_sim_language_encoder", lambda: _language)
        yield


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Per arm: the JAX and the port seed dir (each side's ``config.json``;
    the port's with ``weights/0``), and the two agents with the port's seeded
    weights."""
    from voxactb_tpu.agents.qattention_agent import QAttentionBCAgent as JaxAgent
    from voxactb_tpu.cli.train import parse_overrides as jax_overrides
    from voxactb_tpu.config import Config as JaxConfig
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.cli.train import parse_overrides
    from voxactb_tpu_torch.config import Config
    from voxactb_tpu_torch.weights import tensors_to_flax_tree

    root = tmp_path_factory.mktemp("diagnose")
    out = {}
    for arm, extra in ARMS.items():
        dirs = {}
        for side, (config, parse) in {"jax": (JaxConfig, jax_overrides),
                                      "port": (Config, parse_overrides)}.items():
            d = root / side / arm
            d.mkdir(parents=True)
            cfg = config().override(**parse(TINY + extra + [f"log_dir={d}"]))
            cfg.save(str(d / "config.json"))
            dirs[side] = (str(d), cfg)
        pcfg = dirs["port"][1]
        agent = QAttentionBCAgent(pcfg.method, pcfg.rlbench.cameras, pcfg.rlbench.scene_bounds,
                                  device="cpu", seed=3 if arm == "dominant" else 4)
        agent.build(training=False)
        # seeded noise on every weight: at initialisation some heads' logits
        # lie within f32 noise of each other, and an argmax there would be a
        # tie, not a finding
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for p in agent.params.parameters():
                p.add_(0.2 * torch.randn(p.shape, generator=g))
        agent.save_weights(os.path.join(dirs["port"][0], "weights", "0"))
        jcfg = dirs["jax"][1]
        jagent = JaxAgent(jcfg.method, jcfg.rlbench.cameras, jcfg.rlbench.scene_bounds)
        jagent.build(training=False)
        tree = tensors_to_flax_tree(agent.params, dict(agent.params.named_parameters()))
        jagent.params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
        out[arm] = dict(jax_dir=dirs["jax"][0], port_dir=dirs["port"][0], jcfg=jcfg,
                        jagent=jagent)
    return out


def _decimals(lines):
    """Log lines with every decimal number to 5 places: the continuous
    actions each framework decodes from the same indices in f32 (a targets'
    f32 ulp apart at most) print alike."""
    return [re.sub(r"-?\d+\.\d+(e-?\d+)?", lambda m: f"{float(m.group()):.5f}", line)
            for line in lines]


def _jax_load_agent(setup):
    """The JAX tools' ``load_agent``, handing back the agents of ``setup``."""
    def load_agent(seed_dir, step, which):
        arm = next(a for a, s in setup.items() if s["jax_dir"] == seed_dir)
        return setup[arm]["jagent"], setup[arm]["jcfg"]
    return load_agent


def test_replay_ambiguity_equals_the_jax_tool(setup, monkeypatch):
    """Near-duplicate and conflicting pair counts, their examples and the
    points in bounds, exactly, from each side's own replay rebuild."""
    tool = _jax_tool("probe_replay_ambiguity")
    s = setup["dominant"]
    monkeypatch.setattr(sys, "argv", ["x", "--task", TASK, "--seed-dir", s["jax_dir"],
                                      "--voxel", "10", "--near", "4"])
    _, text = _printed(tool.main)
    ref = json.loads(text[text.index("{"):])
    got, _ = _printed(probe_replay_ambiguity.main, ["--task", TASK, "--seed-dir", s["port_dir"],
                                                    "--voxel", "10", "--near", "4"],
                      device="cpu")
    assert got == ref
    assert got["samples"] > 0 and got["near_duplicate_pairs"] > 0


def test_replay_accuracy_equals_the_jax_tool(setup, monkeypatch):
    """The policy on its own replay: exact-match rates and misses (the
    summed index error of each), exactly."""
    tool = _jax_tool("probe_replay_accuracy")
    jax_open_loop = _jax_tool("probe_policy_open_loop")
    monkeypatch.setattr(jax_open_loop, "load_agent", _jax_load_agent(setup))
    monkeypatch.setitem(sys.modules, "probe_policy_open_loop", jax_open_loop)
    s = setup["dominant"]
    monkeypatch.setattr(sys, "argv", ["x", "--task", TASK, "--seed-dir", s["jax_dir"],
                                      "--ckpt-step", "0"])
    _, text = _printed(tool.main)
    ref = json.loads(text[text.index("{"):])
    got, _ = _printed(probe_replay_accuracy.main, ["--task", TASK, "--seed-dir",
                                                   s["port_dir"], "--ckpt-step", "0"],
                      device="cpu")
    assert got == ref
    assert got["samples"] > 0


def test_open_loop_and_live_episodes_equal_the_jax_tool(setup):
    """Per keyframe along the oracle path, with and without the train-side
    time channel: the index errors and grip bits exactly (the position error
    in cm to 1e-9); the live rollout's reward and its log line per step.
    Then the port's ``main`` on its checkpoints prints those rows and a
    summary that counts them."""
    from voxactb_tpu.sim.environment import BimanualTaskEnvironment as JaxEnv
    from voxactb_tpu.sim.tasks import TASK_REGISTRY as JAX_TASKS
    from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment
    from voxactb_tpu_torch.sim.tasks import TASK_REGISTRY

    tool = _jax_tool("probe_policy_open_loop")
    jagents = {arm: s["jagent"] for arm, s in setup.items()}
    agents = {arm: probe_policy_open_loop.load_agent(s["port_dir"], 0, arm, "cpu")[0]
              for arm, s in setup.items()}
    kw = dict(cameras=["wrist", "wrist2"], image_size=16, episode_length=25, seed=43)
    jenv, env = JaxEnv(JAX_TASKS[TASK], **kw), BimanualTaskEnvironment(TASK_REGISTRY[TASK], **kw)
    for train_time in (False, True):
        args = (0, 10, 5, 0.3, 25)
        ref = tool.probe_episode(jenv, jagents, *args, no_duplicate=True, train_time=train_time)
        got = probe_policy_open_loop.probe_episode(env, agents, *args, no_duplicate=True,
                                                   train_time=train_time)
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            assert g.pop("pos_err_cm") == pytest.approx(r.pop("pos_err_cm"), abs=1e-9)
            assert g == r
    ref = tool.live_episode(jenv, jagents, 0, 0.3, 25)
    got = probe_policy_open_loop.live_episode(env, agents, 0, 0.3, 25)
    assert got[0] == ref[0] and _decimals(got[1]) == _decimals(ref[1])

    argv = ["--task", TASK, "--acting-dir", setup["dominant"]["port_dir"], "--stab-dir",
            setup["assistive"]["port_dir"], "--ckpt-step", "0", "--episodes", "1", "--live"]
    rec, text = _printed(probe_policy_open_loop.main, argv, device="cpu")
    (ep,) = rec["episodes"]
    assert ep["live_reward"] == ref[0] and _decimals(ep["live_log"]) == _decimals(ref[1])
    (summary,) = rec["summary"]
    rows = ep["rows"]
    assert summary["keyframes"] == len(rows)
    assert summary["trans_exact"] == sum(r["trans_idx_err"] == [0, 0, 0] for r in rows)
    assert summary["live_steps"] == len(ref[1])
    assert json.loads(text.strip().splitlines()[-1])["open_loop"]["episodes"] == rec["summary"]


def test_input_diff_equals_the_jax_tool(monkeypatch):
    """Per keyframe: the proprio vectors to the JAX tool's printed 3
    decimals, and per camera tensor max|d|, mean|d| and the share above 0.05
    to its printed 4, 5 and 3 decimals (half a unit of the last, plus 1e-6
    for f32 rounding across the frameworks)."""
    tool = _jax_tool("probe_input_diff")
    monkeypatch.setattr(sys, "argv", ["x", "--task", TASK, "--voxel-size", "10"])
    _, text = _printed(tool.main)
    blocks = text.split("\n=== step ")[1:]
    rows, _ = _printed(probe_input_diff.main, ["--task", TASK, "--voxel-size", "10"],
                       device="cpu")
    assert len(rows) == len(blocks) > 0
    for row, block in zip(rows, blocks):
        head, *lines = block.strip().splitlines()
        assert head.startswith(f"{row['step']} arm={row['arm']} ({row['role']}) "
                               f"kf#{row['kf']} (demo frame {row['demo_frame']})")
        fields = dict(line.strip().split(": ", 1) for line in lines)
        for side in ("probe", "train"):
            ref = ast.literal_eval(fields[f"low_dim_state {side}"])
            np.testing.assert_allclose(row[f"low_dim_state_{side}"], ref, atol=5e-4 + 1e-6)
        for cam in ("wrist", "wrist2"):
            for kind in ("rgb", "point_cloud"):
                got = row[f"{cam}_{kind}"]
                parts = dict(p.split("=") for p in fields[f"{cam}_{kind}"].split())
                assert got["max"] == pytest.approx(float(parts["max|d|"]), abs=5e-5 + 1e-6)
                assert got["mean"] == pytest.approx(float(parts["mean|d|"]), abs=5e-6 + 1e-6)
                assert got["frac"] == pytest.approx(float(parts["frac>0.05"]), abs=5e-4 + 1e-6)


def test_hybrid_inputs_equal_the_jax_tool(setup, monkeypatch):
    """The four input variants' rows (summed trans index error, predicted and
    target grip bits), exactly."""
    tool = _jax_tool("probe_hybrid_inputs")
    monkeypatch.setattr(tool, "load_agent", _jax_load_agent(setup))
    argv = ["--task", TASK, "--ckpt-step", "0", "--episodes", "1"]
    monkeypatch.setattr(sys, "argv", ["x", *argv, "--acting-dir", setup["dominant"]["jax_dir"],
                                      "--stab-dir", setup["assistive"]["jax_dir"]])
    _, text = _printed(tool.main)
    ref = [ast.literal_eval(line) for line in text.splitlines() if line.startswith("{")]
    rows, _ = _printed(probe_hybrid_inputs.main, [*argv, "--acting-dir",
                                                  setup["dominant"]["port_dir"], "--stab-dir",
                                                  setup["assistive"]["port_dir"]], device="cpu")
    assert [{k: v for k, v in r.items() if k != "episode"} for r in rows] == ref
    assert len(ref) > 0
