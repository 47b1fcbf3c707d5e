"""QAttentionBCAgent of the port: update / save / load / resume through the
Agent contract, on the CPU at a tiny size (the cases of tests/test_agent.py)."""

import numpy as np
import pytest
import torch

from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
from voxactb_tpu_torch.agents.qfunction import make_infer_fn
from voxactb_tpu_torch.config import MethodConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

CAMERAS = ["wrist", "wrist2"]
BOUNDS = [-0.8, -1.0, 0.1, 1.2, 1.0, 2.1]
IMG = 16


def tiny_cfg(**kw):
    base = dict(voxel_sizes=[10], num_latents=16, latent_dim=32, transformer_depth=1,
                cross_dim_head=16, latent_dim_head=16, final_dim=8, lr=1e-3,
                which_arm="dominant", arm_pred_loss=True, apply_se3=True)
    base.update(kw)
    return MethodConfig(**base)


def synthetic_batch(rng, cfg, b=2):
    batch = {
        "trans_action_indicies": rng.integers(0, 10, (b, 3)).astype(np.int32),
        "rot_grip_action_indicies": np.concatenate(
            [rng.integers(0, 72, (b, 3)), rng.integers(0, 2, (b, 1))], -1).astype(np.int32),
        "ignore_collisions": rng.integers(0, 2, (b, 1)).astype(np.int32),
        "gripper_pose": np.concatenate(
            [rng.uniform([-0.3, -0.5, 0.5], [0.7, 0.5, 1.5], (b, 3)),
             rng.normal(size=(b, 4))], -1).astype(np.float32),
        "lang_goal_emb": rng.normal(size=(b, 1024)).astype(np.float32),
        "lang_token_embs": rng.normal(size=(b, 77, 512)).astype(np.float32),
        "low_dim_state": rng.normal(size=(b, cfg.low_dim_size())).astype(np.float32),
        "label": rng.integers(0, 2, (b, 1)).astype(np.int32),
        "scene_bounds": np.asarray(BOUNDS, np.float32),
        "task": "open_drawer",  # replay samples carry non-array entries too
    }
    batch["gripper_pose"][:, 3:] /= np.linalg.norm(
        batch["gripper_pose"][:, 3:], axis=-1, keepdims=True)
    for c in CAMERAS:
        batch[f"{c}_rgb"] = rng.integers(0, 255, (b, IMG, IMG, 3)).astype(np.float32)
        batch[f"{c}_point_cloud"] = rng.uniform(
            -0.5, 1.5, (b, IMG, IMG, 3)).astype(np.float32)
    return batch


def synthetic_obs(rng):
    obs = {"lang_goal_emb": rng.normal(size=(1024,)).astype(np.float32),
           "lang_token_embs": rng.normal(size=(77, 512)).astype(np.float32),
           "low_dim_state_left_arm": rng.normal(size=(1, 4)).astype(np.float32),
           "low_dim_state_right_arm": rng.normal(size=(1, 5)).astype(np.float32)}
    for c in CAMERAS:
        obs[f"{c}_rgb"] = rng.integers(0, 255, (1, IMG, IMG, 3)).astype(np.float32)
        obs[f"{c}_point_cloud"] = rng.uniform(-0.5, 1.5, (1, IMG, IMG, 3)).astype(np.float32)
    return obs


def _agent(cfg=None, training=True, **kw):
    agent = QAttentionBCAgent(cfg or tiny_cfg(), CAMERAS, BOUNDS, batch_size=2,
                              training_iterations=100, device="cpu", **kw)
    agent.build(training=training)
    return agent


def _act(agent, obs):
    return np.asarray(agent.act(0, obs, which_arm="dominant",
                                dominant_assitive_policy=True).action)


@pytest.fixture(scope="module")
def trained_agent():
    rng = np.random.default_rng(0)
    agent = _agent()
    batch = synthetic_batch(rng, tiny_cfg())
    batch.pop("scene_bounds")  # the agent supplies its own
    losses = [float(agent.update(i, dict(batch))["total_loss"]) for i in range(4)]
    return agent, losses


def test_update_decreases_loss(trained_agent):
    agent, losses = trained_agent
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]  # same batch repeated -> loss must drop
    names = {s.name for s in agent.update_summaries()}
    assert {f"{agent._name}/losses/{k}" for k in
            ("total_loss", "trans_loss", "rot_loss", "grip_loss", "collision_loss",
             "arm_loss", "grad_norm")} <= names
    assert all(np.isfinite(s.value) for s in agent.update_summaries())


def test_act_after_update_uses_the_trained_weights(trained_agent):
    agent, _ = trained_agent
    obs = synthetic_obs(np.random.default_rng(1))
    res = agent.act(0, obs, which_arm="dominant", dominant_assitive_policy=True,
                    new_scene_bounds=[0.0, 0.0, 0.0, 1.0, 1.0, 1.0])
    action = np.asarray(res.action)
    assert action.shape == (9,)
    assert (action[:3] >= 0).all() and (action[:3] <= 1).all()
    np.testing.assert_allclose(np.linalg.norm(action[3:7]), 1.0, atol=1e-5)
    # the module the act ran on holds the train state's weights, not the seed's
    fresh = _agent(training=False)
    k = "latents"
    assert torch.equal(agent.params.state_dict()[k], agent._state.params[k])
    assert not torch.equal(agent.params.state_dict()[k], fresh.params.state_dict()[k])


def test_save_load_roundtrip(trained_agent, tmp_path):
    agent, _ = trained_agent
    obs = synthetic_obs(np.random.default_rng(2))
    before = _act(agent, obs)
    agent.save_weights(str(tmp_path))
    fresh = _agent(training=False)
    assert not np.allclose(_act(fresh, obs), before)
    fresh.load_weights(str(tmp_path))
    np.testing.assert_allclose(_act(fresh, obs), before, atol=1e-6)


def test_resume_restores_optimizer_state_and_step(trained_agent, tmp_path):
    """The train runner loads a checkpoint BEFORE the first update, when no
    train state exists yet: the optimizer state and step must survive into
    the rebuilt state."""
    agent, _ = trained_agent
    agent.save_weights(str(tmp_path))
    saved_step = int(agent._state.step)
    assert saved_step > 0
    batch = synthetic_batch(np.random.default_rng(0), tiny_cfg())

    fresh = _agent()
    fresh.load_weights(str(tmp_path))  # resume path: before any update
    assert fresh._state is None
    fresh.update(saved_step, dict(batch))
    assert int(fresh._state.step) == saved_step + 1
    assert int(fresh._state.opt_state.count) == saved_step + 1
    # the moments are the checkpoint's, moved on by one step: not a restart
    restart = _agent()
    restart.params = agent.params.state_dict()
    restart.update(0, dict(batch))
    k = "latents"
    assert float(fresh._state.opt_state.nu[k].abs().sum()) > 0
    assert not torch.allclose(fresh._state.opt_state.nu[k], restart._state.opt_state.nu[k])
    # loading into an agent that already trains replaces its state as well
    restart.load_weights(str(tmp_path))
    assert int(restart._state.step) == saved_step
    for name, v in agent._state.opt_state.mu.items():
        assert torch.equal(restart._state.opt_state.mu[name], v)
        assert torch.equal(restart._state.params[name], agent._state.params[name])


def test_agent_memorizes_training_batch():
    """Enough updates on one batch drive the translation argmax to the
    ground-truth voxel: loss, gradients, optimizer and decode are consistent.
    How far the updates get depends on the initial draw (of four seeds of
    either package's initialiser two end near 6 after 60 updates, from the
    same draw the two packages follow one curve) and on the f32 summation
    order, which changes with torch's thread count: on one thread seed 1's
    loss is 2e-4 after 60 updates with sample 0's translation argmax still
    off, and the argmax is exact from 80 updates on (loss 7e-5 at 100)."""
    cfg = tiny_cfg(apply_se3=False, lr=5e-3, arm_pred_loss=False, input_dropout=0.0,
                   attn_dropout=0.0)
    agent = _agent(cfg, seed=1)
    batch = synthetic_batch(np.random.default_rng(0), cfg)
    batch.pop("label")
    for i in range(100):
        out = agent.update(i, dict(batch))
    assert float(out["total_loss"]) < 2.0
    _, infer = make_infer_fn(cfg, device="cpu", model=agent.params)
    res = infer(agent.params, tuple(batch[f"{c}_rgb"] for c in CAMERAS),
                tuple(batch[f"{c}_point_cloud"] for c in CAMERAS), batch["low_dim_state"],
                batch["lang_goal_emb"], batch["lang_token_embs"], BOUNDS)
    np.testing.assert_array_equal(res.trans_idx.numpy(), batch["trans_action_indicies"])
    np.testing.assert_array_equal(res.rot_grip_idx.numpy(),
                                  batch["rot_grip_action_indicies"])


def test_remat_train_step_runs_and_matches():
    batch = synthetic_batch(np.random.default_rng(0), tiny_cfg())
    losses = {}
    for remat in (False, True):
        agent = _agent(tiny_cfg(remat=remat))
        losses[remat] = float(agent.update(0, dict(batch))["total_loss"])
    assert np.isfinite(losses[True]) and losses[True] == losses[False]


def test_what_the_agent_refuses(tmp_path):
    agent = _agent(training=False)
    with pytest.raises(RuntimeError, match="training=True"):
        agent.update(0, {})
    with pytest.raises(FileNotFoundError):
        agent.load_weight(str(tmp_path / "QAttentionAgent_layer0.msgpack"))
    # a JAX-format checkpoint of another model: refused before a weight is written
    from voxactb_tpu_torch.utils import msgpack_codec

    before = {k: v.clone() for k, v in agent.params.state_dict().items()}
    msgpack_codec.save(str(tmp_path / "other.msgpack"),
                       {"params": {"params": {"latents": np.zeros((2, 2), np.float32)}},
                        "step": 0})
    with pytest.raises(ValueError, match="does not match"):
        agent.load_weight(str(tmp_path / "other.msgpack"))
    assert all(torch.equal(v, before[k]) for k, v in agent.params.state_dict().items())
    # an untrained agent saves its seeded weights, with step 0 and no optimizer state
    agent.save_weights(str(tmp_path))
    payload = torch.load(tmp_path / "QAttentionAgent_layer0.pt", weights_only=True)
    assert payload["step"] == 0 and "opt_state" not in payload
    assert set(payload["params"]) == set(agent.params.state_dict())
