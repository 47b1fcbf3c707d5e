"""The port's protocol tools (voxactb_tpu_torch/tools/oracle_protocol_check.py,
run_protocol_eval.py, train_pair.py) against the JAX package's tools/, loaded
by path as tests/test_oracle_protocol.py loads them: the oracle's episodes on
the four protocol tasks, ``COMMON``, checkpoint lookup, the stabilizing
sweep's tie rule and the summary's layout on fixed CSVs; a tiny run of every
stage on the CPU; and the device rule. Every check here is exact."""

import csv
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from voxactb_tpu_torch.tools import oracle_protocol_check, run_protocol_eval, train_pair

ROOT = os.path.join(os.path.dirname(__file__), "..")
TASKS = ["open_jar", "open_drawer", "put_item_in_drawer", "hand_over_item"]
# the tiny widths of the CPU run: 16^2 images, a 10^3 grid, narrow towers
TINY = ["rlbench.camera_resolution=[16,16]", "method.voxel_sizes=[10]",
        "method.num_latents=16", "method.latent_dim=32", "method.transformer_depth=1",
        "method.cross_dim_head=16", "method.latent_dim_head=16", "method.final_dim=8",
        "framework.tensorboard_logging=False"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_tool(name):
    """``tools/<name>.py`` as a module of its own. The protocol tool sets JAX's
    compilation cache directory when it is imported; it is put back."""
    cache_dir = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return mod


@pytest.fixture(scope="module")
def jax_protocol():
    return _jax_tool("run_protocol_eval")


def _language(text):
    r = np.random.default_rng(len(text))
    return (r.normal(size=(1024,)).astype(np.float32),
            r.normal(size=(77, 512)).astype(np.float32))


# -- the oracle ------------------------------------------------------------------------


@pytest.mark.parametrize("task", TASKS)
def test_oracle_episodes_equal_the_jax_oracle(task):
    """The calibration invariant on the port: discretized demo keyframes at
    voxel 50 and radius 0.3 clear the task; each episode's dict equals the
    JAX oracle's on the JAX sim at the same env seed."""
    from voxactb_tpu.sim.environment import BimanualTaskEnvironment as JaxEnv
    from voxactb_tpu.sim.tasks import TASK_REGISTRY as JAX_REGISTRY
    from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment
    from voxactb_tpu_torch.sim.tasks import TASK_REGISTRY

    jax_oracle = _jax_tool("oracle_protocol_check")
    kw = dict(cameras=["wrist", "wrist2"], image_size=32, episode_length=25, seed=43,
              lang_encoder=_language)
    port_env = BimanualTaskEnvironment(TASK_REGISTRY[task], **kw)
    jax_env = JaxEnv(JAX_REGISTRY[task], **kw)
    for ep in range(2):
        out = oracle_protocol_check.oracle_episode(
            port_env, voxel_size=50, rotation_resolution=5, crop_radius=0.3, ep=ep)
        assert out["success"], (task, ep, out)
        assert out == jax_oracle.oracle_episode(
            jax_env, voxel_size=50, rotation_resolution=5, crop_radius=0.3, ep=ep)


def test_continuous_from_discrete_equals_the_jax_tool():
    jax_oracle = _jax_tool("oracle_protocol_check")
    r = np.random.default_rng(0)
    bounds = [-0.3, -0.2, 0.6, 0.3, 0.4, 1.2]
    for _ in range(5):
        t_idx = r.integers(0, 50, 3)
        rot_grip = np.r_[r.integers(0, 72, 3), r.integers(0, 2)]
        np.testing.assert_array_equal(
            oracle_protocol_check.continuous_from_discrete(t_idx, rot_grip, bounds, 50, 5),
            jax_oracle.continuous_from_discrete(t_idx, rot_grip, bounds, 50, 5))


def test_the_done_run_config_is_round_5s(tmp_path):
    """``protocol_done.py``'s overrides on top of ``COMMON`` give the config
    round 5 recorded for open_jar (``eval_artifacts/``), but for ``log_dir``
    and the port's own keys, which are off."""
    import dataclasses

    from voxactb_tpu_torch.cli.train import parse_overrides
    from voxactb_tpu_torch.config import Config

    spec = importlib.util.spec_from_file_location(
        "protocol_done", os.path.join(ROOT, "protocol_done.py"))
    done = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(done)
    task = "open_jar"
    argv = run_protocol_eval.COMMON + done.round5_extra(task) + [
        f"rlbench.task_name={task}", f'rlbench.tasks=["{task}"]', "rlbench.demos=10",
        "method.which_arm=dominant", "framework.training_iterations=6000",
        "framework.save_freq=2000", "framework.log_freq=100", f"log_dir={tmp_path}"]
    got = json.loads(json.dumps(dataclasses.asdict(Config().override(**parse_overrides(argv)))))
    with open(os.path.join(ROOT, "eval_artifacts", task, "train_dominant", task, "PERACT_BC",
                           "seed0", "config.json")) as f:
        want = json.load(f)
    port_only = {k: got["method"].pop(k) for k in set(got["method"]) - set(want["method"])}
    assert port_only == {"front_scatter_matmul": False, "pallas_attention_train": False}
    got.pop("log_dir"), want.pop("log_dir")
    assert got == want


# -- the protocol tool on fixed files --------------------------------------------------


def test_common_equals_the_jax_tool(jax_protocol):
    assert run_protocol_eval.COMMON == jax_protocol.COMMON
    assert run_protocol_eval.TASKS == jax_protocol.TASKS


def _weights(seed_dir, steps):
    """Weight dirs holding both packages' checkpoint files."""
    for s in steps:
        d = os.path.join(seed_dir, "weights", str(s))
        os.makedirs(d, exist_ok=True)
        for name in ("QAttentionAgent_layer0.pt", "QAttentionAgent_layer0.msgpack"):
            open(os.path.join(d, name), "w").close()


def test_ckpt_file_equals_the_jax_tool(tmp_path, jax_protocol):
    seed_dir = str(tmp_path / "seed0")
    for tool in (run_protocol_eval, jax_protocol):
        with pytest.raises(FileNotFoundError, match="no saved weight steps"):
            tool.ckpt_file(seed_dir)
    _weights(seed_dir, [0, 2, 3])
    for step in (None, 0, 2, 3):
        port, jax_path = run_protocol_eval.ckpt_file(seed_dir, step), \
            jax_protocol.ckpt_file(seed_dir, step)
        assert os.path.dirname(port) == os.path.dirname(jax_path)
        assert port.endswith(".pt") and jax_path.endswith(".msgpack")
    os.makedirs(os.path.join(seed_dir, "weights", "4"))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        run_protocol_eval.ckpt_file(seed_dir)
    # a JAX run's weights directory: the .msgpack the JAX tool picks
    jax_ckpt = os.path.join(seed_dir, "weights", "4", "QAttentionAgent_layer0.msgpack")
    open(jax_ckpt, "wb").close()
    assert run_protocol_eval.ckpt_file(seed_dir) == jax_protocol.ckpt_file(seed_dir) == jax_ckpt


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def _eval_row(step, ret, **kw):
    return {"step": step, **kw, "eval_envs/return": ret, "eval_envs/length": 7.0,
            "eval_envs/episodes": 2.0}


# val returns with a tie at the top (select_checkpoints keeps the last: step 3),
# and a sweep of the stabilizing checkpoints with a tie (the last argmax: 3)
VAL_ROWS = [_eval_row(0, 0.0), _eval_row(2, 50.0), _eval_row(3, 50.0)]
SWEEP_ROWS = [_eval_row(3, 50.0, left_step=0), _eval_row(3, 100.0, left_step=2),
              _eval_row(3, 100.0, left_step=3), _eval_row(2, 100.0, left_step=9)]
TEST_ROWS = [_eval_row(3, 25.0)]


class _StubRunner:
    """Replays fixed rows where the tool's EvalRunner would score episodes."""

    calls = []

    def __init__(self, task, acting_dir, stab_ckpt, episodes, seed, csv_name=None,
                 selection_csv=None, crop_source="gt", **kw):
        self._call = dict(seed=seed, csv_name=csv_name, selection_csv=selection_csv,
                          crop_source=crop_source,
                          stab_ckpt=stab_ckpt and os.path.dirname(stab_ckpt))
        self._acting_dir = acting_dir

    def start(self, eval_type):
        _StubRunner.calls.append(dict(self._call, eval_type=eval_type))
        if eval_type == "missing":
            _write_csv(os.path.join(self._acting_dir, "eval_data.csv"), VAL_ROWS)
            return VAL_ROWS
        return TEST_ROWS

    def sweep_stabilizing(self, acting_step, weightsdir):
        _StubRunner.calls.append(dict(self._call, sweep=acting_step))
        _write_csv(os.path.join(self._acting_dir, "stabilizing_sweep.csv"), SWEEP_ROWS)
        return SWEEP_ROWS


def _run_tool(tool, out, monkeypatch, vlm=False, jax_tool=False):
    def train_policy(task, arm, out_root, *a, **kw):
        seed_dir = os.path.join(out_root, f"train_{arm}", task, "PERACT_BC", "seed0")
        _weights(seed_dir, [0, 2, 3])
        return seed_dir

    monkeypatch.setattr(tool, "train_policy", train_policy)
    monkeypatch.setattr(tool, "make_runner", _StubRunner)
    argv = ["--out", str(out), "--tasks", "open_jar"] + (["--vlm-eval"] if vlm else [])
    _StubRunner.calls = []
    if jax_tool:
        monkeypatch.setattr("sys.argv", ["run_protocol_eval.py"] + argv)
        tool.main()
    else:
        tool.main(argv, device="cpu")
    with open(os.path.join(out, "summary.json")) as f:
        return json.load(f), _StubRunner.calls


def test_stab_sweep_keeps_the_last_argmax_like_the_jax_tool(tmp_path, monkeypatch,
                                                           jax_protocol):
    got = {}
    for name, tool in (("port", run_protocol_eval), ("jax", jax_protocol)):
        acting = tmp_path / name / "acting"
        _weights(str(acting), [0, 2, 3])
        _write_csv(acting / "eval_data.csv", VAL_ROWS)
        monkeypatch.setattr(tool, "make_runner", _StubRunner)
        got[name] = tool.run_stab_sweep("open_jar", str(acting), str(tmp_path / "stab"), 2,
                                        43)
    assert got["port"] == got["jax"]
    acting_step, rows, best_left = got["port"]
    assert acting_step == 3 and best_left == 3
    assert [int(r["left_step"]) for r in rows] == [0, 2, 3]


def test_summary_layout_equals_the_jax_tool(tmp_path, monkeypatch, jax_protocol):
    """Both tools' ``summary.json`` (and the calls their runners get) on the
    same fixed rows, for the protocol and then for ``--vlm-eval``."""
    results = {}
    for name, tool in (("port", run_protocol_eval), ("jax", jax_protocol)):
        out = tmp_path / name
        results[name] = [_run_tool(tool, out, monkeypatch, vlm=vlm,
                                   jax_tool=name == "jax") for vlm in (False, True)]
    for (port_summary, port_calls), (jax_summary, jax_calls) in zip(
            results["port"], results["jax"]):
        text = json.dumps(port_summary).replace(str(tmp_path / "port"), "OUT")
        assert text == json.dumps(jax_summary).replace(str(tmp_path / "jax"), "OUT")
        assert json.dumps(port_calls).replace(str(tmp_path / "port"), "OUT") == \
            json.dumps(jax_calls).replace(str(tmp_path / "jax"), "OUT")
    summary = results["port"][1][0]
    assert set(summary) == {"open_jar", "open_jar_vlmcrop"}
    assert summary["open_jar"]["stab_sweep"]["best_left_step"] == 3
    assert summary["open_jar"]["test"] == [{"step": 3, "return": 25.0}]


# -- a tiny run of every stage ---------------------------------------------------------


def test_tiny_protocol_run_writes_every_stage(tmp_path):
    """``main`` at a tiny config on the CPU (2 iterations, 1 demo, 1 episode,
    16^2 images): both policies train, and stage 1's, stage 2's, stage 3's and
    ``--vlm-eval``'s CSVs and summary entries are written."""
    out = str(tmp_path / "out")
    common = ["--tasks", "open_jar", "--episodes", "1", "--out", out]
    summary = run_protocol_eval.main(
        common + ["--iters", "2", "--save-freq", "1", "--demos", "1", "--extra", *TINY],
        device="cpu")
    acting = summary["open_jar"]["acting_dir"]
    stab = acting.replace("train_dominant", "train_assistive")
    for seed_dir in (acting, stab):
        for step in (0, 1):
            assert os.path.exists(os.path.join(seed_dir, "weights", str(step),
                                               "QAttentionAgent_layer0.pt"))
    with open(os.path.join(acting, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["rlbench"]["cameras"] == ["front", "wrist", "wrist2"]
    assert cfg["rlbench"]["camera_resolution"] == [16, 16]
    assert [r["step"] for r in summary["open_jar"]["val"]] == ["0", "1"]
    assert [r["left_step"] for r in summary["open_jar"]["stab_sweep"]["rows"]] == ["0", "1"]
    assert len(summary["open_jar"]["test"]) == 1

    summary = run_protocol_eval.main(common + ["--vlm-eval"], device="cpu")
    vlm = summary["open_jar_vlmcrop"]
    assert len(vlm["val"]) == 1 and len(vlm["test"]) == 1
    for name in ("eval_data.csv", "stabilizing_sweep.csv", "test_data.csv",
                 "eval_data_vlm.csv", "test_data_vlm.csv"):
        with open(os.path.join(acting, name)) as f:
            rows = list(csv.DictReader(f))
        assert rows and all(np.isfinite(float(r["eval_envs/return"])) for r in rows), name
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f) == summary


# -- the protocol's training, step after step ------------------------------------------


TRACKED_STEPS = 20


def test_train_steps_track_the_jax_steps_from_a_fresh_state():
    """The protocol trains 6000 steps from fresh moments: both packages' train
    steps at the protocol's optimizer settings (LAMB, lr 5e-4, no schedule),
    from the same initial parameters and zero moments, on the same cycle of
    six batches, with dropout and augmentation off (their random streams
    cannot match), give the same loss at every one of 20 steps within 1e-4
    relative (f32 reordering grows by about 10x every few steps past that)."""
    import sys

    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(__file__))
    import test_torch_train_step as T
    from voxactb_tpu.agents import qfunction as JQ
    from voxactb_tpu.config import MethodConfig as JaxConfig
    from voxactb_tpu_torch.agents import qfunction as Q
    from voxactb_tpu_torch.config import MethodConfig
    from voxactb_tpu_torch.weights import flax_tree_to_tensors, opt_state_from_optax

    kw = dict(T.TINY, **T.MODES["single_arm_arm_loss"], apply_se3=False, input_dropout=0.0,
              attn_dropout=0.0, lr=5e-4, lambda_weight_l2=1e-6)
    jcfg, cfg = JaxConfig(**kw), MethodConfig(**kw)
    assert cfg.optimizer == "lamb" and not cfg.lr_scheduler
    rng = np.random.default_rng(0)
    batches = [T._batch(rng, cfg, b=4) for _ in range(6)]
    _, jinit, jstep = JQ.make_train_step(jcfg, JQ.make_optimizer(jcfg, 6000), T.CAMERAS)
    jstate = jinit(jax.random.key(0), {k: jnp.asarray(v) for k, v in batches[0].items()})
    params = T._np_tree(jstate.params)
    zeros = jax.tree_util.tree_map(lambda p: np.zeros(p.shape, np.float32), params)
    model, _, step = Q.make_train_step(cfg, Q.make_optimizer(cfg, 6000), T.CAMERAS,
                                       device="cpu")
    state = Q.TrainState(torch.tensor(0), flax_tree_to_tensors(model, params),
                         opt_state_from_optax(model, 0, zeros, zeros))
    generator = torch.Generator().manual_seed(0)
    losses = []
    for i in range(TRACKED_STEPS):
        b = batches[i % len(batches)]
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.key(1))
        state, m = step(state, b, generator)
        losses.append((float(m["total_loss"]), float(jm["total_loss"])))
    np.testing.assert_allclose(*np.asarray(losses).T, rtol=1e-4)
    assert losses[-1][1] < losses[0][1]  # the steps learn


# -- the device ------------------------------------------------------------------------


@pytest.mark.parametrize("tool", [run_protocol_eval, train_pair])
def test_tools_raise_without_cuda(tool, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--out", str(tmp_path)] + (["--task", "open_jar"] if tool is train_pair else [])
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(argv)
    assert not os.listdir(tmp_path)
