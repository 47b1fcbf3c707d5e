"""The port stands alone: no module under voxactb_tpu_torch/ imports jax, flax,
optax or the JAX package; importing it and running a small act on the CPU
loads none of them; and its entry points refuse to fall back to the CPU."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "voxactb_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "voxactb_tpu")


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
        from voxactb_tpu_torch.agents.qfunction import make_infer_fn
        from voxactb_tpu_torch.config import MethodConfig
        import voxactb_tpu_torch.weights, voxactb_tpu_torch.agents.qattention_agent
        import voxactb_tpu_torch.ops.cuda.build, voxactb_tpu_torch.optim
        import voxactb_tpu_torch.ops.augmentation
        import voxactb_tpu_torch.ops.cuda.flash_attention_train

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

        # the agent's train path: two updates, then an act, on the CPU
        from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
        import dataclasses
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
