"""The port stands alone: no module under voxactb_tpu_torch/ imports jax, flax,
optax, msgpack, transformers or the JAX package; importing it and running a small act on the CPU
loads none of them; and its entry points refuse to fall back to the CPU."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "voxactb_tpu_torch"
# the card's machine has none of these: the port reads flax's msgpack and the
# upstream checkpoints itself (utils/msgpack_codec, utils/pretrained)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "transformers", "voxactb_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_forbidden_import_in_the_package():
    files = sorted(PACKAGE.rglob("*.py"))
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    smoke = list(_imported_modules(ROOT / "chip_smoke.py"))
    assert not [m for m in smoke if m.split(".")[0] in FORBIDDEN], smoke


def test_import_and_cpu_act_load_no_jax():
    script = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from voxactb_tpu_torch.agents.qfunction import make_infer_fn
        from voxactb_tpu_torch.config import MethodConfig
        import voxactb_tpu_torch.weights, voxactb_tpu_torch.agents.qattention_agent
        import voxactb_tpu_torch.ops.cuda.build, voxactb_tpu_torch.optim
        import voxactb_tpu_torch.ops.augmentation
        import voxactb_tpu_torch.ops.cuda.flash_attention_train
        import voxactb_tpu_torch.vlm.pipeline, voxactb_tpu_torch.models.sam_encoder
        import voxactb_tpu_torch.models.sam_decoder, voxactb_tpu_torch.models.owlvit
        import voxactb_tpu_torch.ops.cuda.sam_attention
        import voxactb_tpu_torch.ops.cuda.encoder_stats, voxactb_tpu_torch.ops.cuda.stats_head
        import voxactb_tpu_torch.ops.cuda.decoder_head_v3
        from voxactb_tpu_torch.models.clip_text import ClipLanguageEncoder

        # the tokenizer reads the port's own copy of the BPE vocab
        import os
        from voxactb_tpu_torch.utils import bpe
        vocab = os.path.realpath(bpe._DEFAULT_VOCAB_PATHS[1])
        assert vocab.endswith("voxactb_tpu_torch/assets/bpe_simple_vocab_16e6.txt.gz"), vocab
        enc = ClipLanguageEncoder(device="cpu")
        assert list(enc.tokenize("open the jar")[0][:5]) == [49406, 1488, 518, 10837, 49407]

        cfg = MethodConfig(voxel_sizes=[10], num_latents=8, latent_dim=16,
                           transformer_depth=1, latent_heads=1, latent_dim_head=8,
                           cross_dim_head=8, compute_dtype="bfloat16",
                           pallas_front=True, pallas_attention=True,
                           pallas_decoder=True)
        model, infer = make_infer_fn(cfg, device="cpu")
        rng = np.random.default_rng(0)
        out = infer(model, (rng.integers(0, 255, (1, 8, 8, 3)),),
                    (rng.uniform(-0.5, 1.5, (1, 8, 8, 3)),),
                    rng.normal(size=(1, 4)), rng.normal(size=(1, 1024)),
                    rng.normal(size=(1, 77, 512)), [0, 0, 0, 1, 1, 1])
        assert out.continuous_action.shape == (1, 9)
        # the dense-grid act path (encoder front, stats and inline-upsample
        # tail kernels' plain versions)
        import dataclasses
        dense = dataclasses.replace(cfg, pallas_front=False, pallas_decoder=False,
                                    pallas_encoder=True, pallas_stats=True,
                                    pallas_decoder_v3=True)
        model, infer = make_infer_fn(dense, device="cpu")
        out = infer(model, (rng.integers(0, 255, (1, 8, 8, 3)),),
                    (rng.uniform(-0.5, 1.5, (1, 8, 8, 3)),),
                    rng.normal(size=(1, 4)), rng.normal(size=(1, 1024)),
                    rng.normal(size=(1, 77, 512)), [0, 0, 0, 1, 1, 1])
        assert out.voxel_grid.shape == (1, 10, 10, 10, 10)

        # the agent's train path: two updates, then an act, on the CPU
        from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
        cfg = dataclasses.replace(cfg, pallas_attention_train=True, which_arm="dominant",
                                  arm_pred_loss=True)
        agent = QAttentionBCAgent(cfg, ["wrist"], [0, 0, 0, 1, 1, 1], device="cpu")
        agent.build(training=True)
        b = 2
        pose = rng.normal(size=(b, 7)).astype(np.float32)
        pose[:, :3] = 0.5
        batch = {"trans_action_indicies": rng.integers(0, 10, (b, 3)),
                 "rot_grip_action_indicies": rng.integers(0, 2, (b, 4)),
                 "ignore_collisions": rng.integers(0, 2, (b, 1)),
                 "gripper_pose": pose, "label": rng.integers(0, 2, (b, 1)),
                 "lang_goal_emb": rng.normal(size=(b, 1024)),
                 "lang_token_embs": rng.normal(size=(b, 77, 512)),
                 "low_dim_state": rng.normal(size=(b, 7)),
                 "wrist_rgb": rng.integers(0, 255, (b, 8, 8, 3)),
                 "wrist_point_cloud": rng.uniform(0, 1, (b, 8, 8, 3))}
        for i in range(2):
            loss = float(agent.update(i, batch)["total_loss"])
            assert np.isfinite(loss)

        # the JAX format both ways, the importers and the reference-checkpoint tool
        import tempfile
        import voxactb_tpu_torch.utils.pretrained, voxactb_tpu_torch.models.clip_image
        import voxactb_tpu_torch.tools.port_torch_checkpoint
        with tempfile.TemporaryDirectory() as d:
            agent.save_weight(os.path.join(d, "QAttentionAgent_layer0.msgpack"))
            agent.load_weights(d)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in %r)
        print("LOADED", loaded)
        assert not loaded, loaded
    """ % (FORBIDDEN,))
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def test_entry_points_raise_without_cuda(monkeypatch):
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.agents.qfunction import (
        build_encoder, make_infer_fn, make_optimizer, make_train_step)
    from voxactb_tpu_torch.config import MethodConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = MethodConfig(voxel_sizes=[10], num_latents=8, latent_dim=16,
                       transformer_depth=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_infer_fn(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_encoder(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        QAttentionBCAgent(cfg, ["wrist"], [0, 0, 0, 1, 1, 1]).build(training=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        QAttentionBCAgent(cfg, ["wrist"], [0, 0, 0, 1, 1, 1]).build(training=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg, make_optimizer(cfg), ["wrist"])
    # the caller may ask for the CPU
    QAttentionBCAgent(cfg, ["wrist"], [0, 0, 0, 1, 1, 1], device="cpu").build(training=True)

    # the act entry point and the six probes
    import importlib

    from voxactb_tpu_torch import graft_entry

    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
    for name in ("probe_op_floor", "probe_act_ab", "probe_decoder_ab", "probe_decoder_parts",
                 "probe_front_batch", "probe_front_matmul"):
        with pytest.raises(RuntimeError, match="CUDA"):
            importlib.import_module(f"voxactb_tpu_torch.tools.{name}").main()

    # the baseline zoo's agent: build, and update / act (which build when
    # build was not called)
    from voxactb_tpu_torch.agents.baseline_agents import BCLangAgent

    rng = np.random.default_rng(0)
    sample = {"wrist_rgb": rng.integers(0, 255, (1, 8, 8, 3)),
              "wrist_point_cloud": rng.normal(size=(1, 8, 8, 3)),
              "low_dim_state": rng.normal(size=(1, 4)),
              "lang_goal_emb": rng.normal(size=(1, 1024)),
              "gripper_pose": rng.normal(size=(1, 7)),
              "rot_grip_action_indicies": np.zeros((1, 4), np.int64)}
    for network in ("cnn", "vit"):
        with pytest.raises(RuntimeError, match="CUDA"):
            BCLangAgent(["wrist"], network=network).build(training=True)
        with pytest.raises(RuntimeError, match="CUDA"):
            BCLangAgent(["wrist"], network=network).update(0, sample)
        with pytest.raises(RuntimeError, match="CUDA"):
            BCLangAgent(["wrist"], network=network).act(0, sample)
        agent = BCLangAgent(["wrist"], network=network, device="cpu")
        agent.update(0, sample)
        assert agent.act(0, sample).action.shape == (9,)
        assert next(agent.network.parameters()).device.type == "cpu"


def test_parallel_and_probe_modules_load_no_jax(tmp_path):
    """The train step over ranks (``parallel/``), ``graft_entry`` and the six
    probes import nothing of JAX or the JAX package, and a one-rank gloo step
    and a small act of ``entry()`` on the CPU load none of it."""
    script = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(1)
        import torch.distributed as dist
        import voxactb_tpu_torch.parallel.collectives
        from voxactb_tpu_torch import graft_entry
        from voxactb_tpu_torch.parallel import dryrun, mesh
        import voxactb_tpu_torch.tools.probe_op_floor, voxactb_tpu_torch.tools.probe_act_ab
        import voxactb_tpu_torch.tools.probe_decoder_ab
        import voxactb_tpu_torch.tools.probe_decoder_parts
        import voxactb_tpu_torch.tools.probe_front_batch
        import voxactb_tpu_torch.tools.probe_front_matmul
        dist.init_process_group("gloo", init_method="file://%s", rank=0, world_size=1)
        _, init_fn, step, batch = dryrun.tiny_train_setup(2)
        state, place, pstep = mesh.make_parallel_train_step(
            mesh.make_mesh({"dp": 1}), init_fn, step, batch, torch.Generator().manual_seed(1))
        state, metrics = pstep(state, place(batch))
        assert torch.isfinite(metrics["total_loss"])
        dist.destroy_process_group()
        infer, args = graft_entry.entry(device="cpu", img=8, voxel_sizes=[10], num_latents=8,
                                        latent_dim=16, transformer_depth=1, final_dim=8)
        assert infer(*args).continuous_action.shape == (1, 9)
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in %r)
        print("LOADED", loaded)
        assert not loaded, loaded
    """ % (str(tmp_path / "rendezvous"), FORBIDDEN))
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def test_host_modules_load_no_jax():
    """The slices' host modules (sim, replay, data, runners, CLIs, the native
    replay, the protocol and data tools) import nothing of JAX or the JAX
    package, and a sim demo, an oracle episode and a native store load none
    of it."""
    script = textwrap.dedent("""
        import os, sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import voxactb_tpu_torch.cli.train, voxactb_tpu_torch.cli.eval
        import voxactb_tpu_torch.runners.rollout, voxactb_tpu_torch.runners.env_runner
        import voxactb_tpu_torch.runners.train_runner, voxactb_tpu_torch.runners.eval_runner
        import voxactb_tpu_torch.sim, voxactb_tpu_torch.sim.tasks
        import voxactb_tpu_torch.sim.randomization, voxactb_tpu_torch.sim.planning
        import voxactb_tpu_torch.replay, voxactb_tpu_torch.replay.dataset
        import voxactb_tpu_torch.replay.prioritized
        import voxactb_tpu_torch.data, voxactb_tpu_torch.data.rlbench_format
        import voxactb_tpu_torch.envs.fake_env, voxactb_tpu_torch.utils.keypoints
        import voxactb_tpu_torch.utils.loggers, voxactb_tpu_torch.utils.observation
        # the protocol slice's modules: the native disk replay, the protocol
        # tools, the validator and the data tools
        import voxactb_tpu_torch.native, voxactb_tpu_torch.replay.native_buffer
        import voxactb_tpu_torch.tools.oracle_protocol_check
        import voxactb_tpu_torch.tools.run_protocol_eval, voxactb_tpu_torch.tools.train_pair
        import voxactb_tpu_torch.sim.validator, voxactb_tpu_torch.sim.pyrep_backend
        import voxactb_tpu_torch.tools.task_builder, voxactb_tpu_torch.tools.dataset_generator
        import voxactb_tpu_torch.tools.make_synthetic_dataset
        import voxactb_tpu_torch.envs.gym_adapter
        # the baseline zoo, VoxPoser, the real-robot stack and the host
        # utilities
        import voxactb_tpu_torch.models.baselines, voxactb_tpu_torch.agents.baseline_agents
        import voxactb_tpu_torch.voxposer, voxactb_tpu_torch.voxposer.interface
        import voxactb_tpu_torch.voxposer.controller, voxactb_tpu_torch.voxposer.lmp
        import voxactb_tpu_torch.voxposer.llm_http, voxactb_tpu_torch.voxposer.planner
        import voxactb_tpu_torch.voxposer.value_maps, voxactb_tpu_torch.voxposer.heuristics
        import voxactb_tpu_torch.realrobot, voxactb_tpu_torch.realrobot.robot_env
        import voxactb_tpu_torch.realrobot.monitor, voxactb_tpu_torch.realrobot.urscript
        import voxactb_tpu_torch.realrobot.robot
        import voxactb_tpu_torch.utils.recovery, voxactb_tpu_torch.utils.video
        import voxactb_tpu_torch.utils.visualize
        from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment
        from voxactb_tpu_torch.sim.tasks import TASK_REGISTRY

        # the sim with its own (torch) language encoder
        env = BimanualTaskEnvironment(TASK_REGISTRY["open_jar"], cameras=["wrist"],
                                      image_size=8, episode_length=4)
        frames, _ = env.get_demo(0)
        obs = env.reset()
        assert obs["lang_goal_emb"].shape == (1024,) and len(frames) > 5
        # the oracle's episode and a store of the native replay
        import tempfile
        from voxactb_tpu_torch.tools.oracle_protocol_check import oracle_episode
        assert oracle_episode(env, 50, 5, 0.3, 0)["steps"] > 0
        from voxactb_tpu_torch.replay import bc_replay_signature
        from voxactb_tpu_torch.replay.native_buffer import NativeReplayBuffer
        with tempfile.TemporaryDirectory() as d:
            buf = NativeReplayBuffer(4, bc_replay_signature(["wrist"], (8, 8)),
                                     os.path.join(d, "r.bin"))
            buf.add({"reward": 1.0})
            assert buf.gather(np.zeros(1))["reward"][0] == 1.0
            buf.close()
        # a VoxPoser plan on the fake env, a baseline act, a real-robot step
        from voxactb_tpu_torch.envs.fake_env import FakeBimanualEnv
        from voxactb_tpu_torch.voxposer.interface import DetectedObject, VoxPoserPlanner
        from voxactb_tpu_torch.voxposer.lmp import ScriptedBackend
        from voxactb_tpu_torch.voxposer.value_maps import VoxelMapSpec
        llm_cache = tempfile.TemporaryDirectory()
        fake = FakeBimanualEnv(image_size=8, episode_length=10, seed=0)
        fake.launch()
        obs = fake.reset()
        program = ("aff = get_empty_affordance_map()\\n"
                   "set_voxel_by_radius(aff, pointat2index(detect('cube').position), 4)\\n"
                   "ret_val = execute('ee', aff)\\n")
        planner = VoxPoserPlanner(
            ScriptedBackend({"hand": program}), VoxelMapSpec([-0.4, -0.5, 0.6, 0.6, 0.5, 1.4], 20),
            lambda name: DetectedObject(name, np.asarray(fake.target_object_world_coords())),
            cache_dir=llm_cache.name)
        assert len(list(planner.plan(fake, obs))) > 0
        llm_cache.cleanup()
        from voxactb_tpu_torch.agents.baseline_agents import BCLangAgent
        agent = BCLangAgent(["wrist"], network="vit", device="cpu", dim=16, depth=1, heads=2)
        assert agent.act(0, obs).action.shape == (9,)
        from voxactb_tpu_torch.realrobot.robot_env import RealRobotEnv
        class Robots:
            def move_arm(self, *a, **k): pass
            def observation(self):
                return {f"gripper_{s}_pose": np.zeros(7, np.float32) for s in ("right", "left")}
        K = np.array([[10.0, 0, 4], [0, 10.0, 4], [0, 0, 1]])
        cam = lambda: (np.zeros((8, 8, 3), np.uint8), np.ones((8, 8), np.float32), K)
        real = RealRobotEnv(Robots(), {"front": cam}, {"right": np.eye(4), "left": np.eye(4)})
        real.reset()
        assert "lang_goal_tokens" in real.step(np.r_[0.3, 0, 1, 0, 1, 0, 0, 1, 0], "right").observation
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in %r)
        print("LOADED", loaded)
        assert not loaded, loaded
    """ % (FORBIDDEN,))
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


@pytest.mark.parametrize("cli", ["train", "eval"])
def test_cli_mains_raise_without_cuda(cli, monkeypatch, tmp_path):
    """Both entry points refuse to fall back to the CPU; ``device="cpu"``
    is the caller's own choice."""
    import importlib

    mod = importlib.import_module(f"voxactb_tpu_torch.cli.{cli}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [f"log_dir={tmp_path}"] if cli == "train" else [f"seed_dir={tmp_path}"]
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)
    # with the CPU asked for, the CLI gets past the device: train finds no
    # demos, eval no config snapshot
    with pytest.raises(SystemExit if cli == "train" else FileNotFoundError):
        mod.main(argv + ["framework.tensorboard_logging=False"] if cli == "train"
                 else argv, device="cpu")
