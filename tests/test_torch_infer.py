"""The act path end to end: the port's make_infer_fn and QAttentionBCAgent.act
against the JAX package's on the same flax parameters and numpy-seeded
observations (CPU, small widths).

- f32, kernel flags off: the integer actions (trans_idx, rot_grip_idx,
  collision_idx) are exactly the JAX ones.
- bf16 with pallas_front/attention/decoder on (the port takes the kernels'
  plain versions on the CPU; JAX runs its Pallas kernels in interpret mode):
  Q-field and logits within a stated tolerance, and an action may flip only
  where the JAX output's top-two gap is inside that tolerance.
- the agent's act() on a dominant/assistive observation.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.agents import qfunction as JQ
from voxactb_tpu.agents.qattention_agent import QAttentionBCAgent as JaxAgent
from voxactb_tpu.config import MethodConfig as JaxMethodConfig
from voxactb_tpu_torch.agents import qfunction as Q
from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
from voxactb_tpu_torch.config import MethodConfig
from voxactb_tpu_torch.weights import load_flax_params

TINY = dict(voxel_sizes=[10], num_latents=16, latent_dim=32, transformer_depth=1,
            latent_heads=2, latent_dim_head=16, cross_dim_head=16)
KERNELS = dict(compute_dtype="bfloat16", pallas_front=True, pallas_attention=True,
               pallas_decoder=True)
BOUNDS = np.array([[-0.5, -0.5, 0.2, 1.2, 1.2, 1.4],
                   [-0.4, -0.6, 0.1, 1.0, 1.1, 1.5]], np.float32)


def random_params(cfg_kw, seed):
    """The JAX Q-net's parameter tree (structure from ``jax.eval_shape`` of its
    init, no compile) filled with numpy-seeded values at init-like scales."""
    jcfg = JaxMethodConfig(**cfg_kw)
    model = JQ.build_encoder(jcfg)
    n, ld = jcfg.voxel_size, jcfg.proprio_width()
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, n, n, n, 10)),
                            jnp.zeros((1, ld)), jnp.zeros((1, 1024)),
                            jnp.zeros((1, 77, 512)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1])
        if "kernel" in name:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(size=leaf.shape).astype(np.float32) / np.sqrt(fan_in)
        if "scale" in name:
            return (1.0 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        if "bias" in name:
            return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        return rng.normal(size=leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def observation_batch(rng, b, low_dim, img=16):
    rgbs = tuple(rng.integers(0, 255, (b, img, img, 3)).astype(np.float32)
                 for _ in range(2))
    pcds = tuple(rng.uniform(-0.4, 1.2, (b, img, img, 3)).astype(np.float32)
                 for _ in range(2))
    return (rgbs, pcds, rng.normal(size=(b, low_dim)).astype(np.float32),
            rng.normal(size=(b, 1024)).astype(np.float32),
            rng.normal(size=(b, 77, 512)).astype(np.float32), BOUNDS[:b])


def _port_model(kw, params):
    model, infer = Q.make_infer_fn(MethodConfig(**kw), device="cpu")
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return model, infer


@pytest.fixture(scope="module")
def dominant():
    kw = dict(TINY, which_arm="dominant", arm_pred_loss=True)
    return kw, random_params(kw, 0)


def test_f32_integer_actions_exact(dominant):
    kw, params = dominant
    _, jinfer = JQ.make_infer_fn(JaxMethodConfig(**kw))
    model, infer = _port_model(kw, params)
    rng = np.random.default_rng(1)
    obs = observation_batch(rng, 2, 7)
    ref = jinfer(params, tuple(map(jnp.asarray, obs[0])), tuple(map(jnp.asarray, obs[1])),
                 *map(jnp.asarray, obs[2:]))
    got = infer(model, *obs)
    for field in ("trans_idx", "rot_grip_idx", "collision_idx"):
        g, r = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, r, err_msg=field)
    # the decode's sin/cos and the f32 sum orders: last-bit differences
    np.testing.assert_allclose(got.continuous_action.numpy(),
                               np.asarray(ref.continuous_action), atol=1e-5)
    np.testing.assert_allclose(got.q_trans.numpy(), np.asarray(ref.q_trans), atol=1e-5)
    np.testing.assert_allclose(got.voxel_grid.numpy(), np.asarray(ref.voxel_grid),
                               atol=1e-5)
    assert (got.front_overflow.numpy() == 0).all()


def test_bf16_kernel_flags_within_tolerance():
    kw = dict(TINY, which_arm="right", **KERNELS)
    params = random_params(kw, 2)
    jcfg = JaxMethodConfig(**kw, pallas_interpret=True)
    cfg = MethodConfig(**kw)
    model, infer = _port_model(kw, params)
    rng = np.random.default_rng(3)
    rgbs, pcds, proprio, lg, lt, bounds = observation_batch(rng, 2, 4)

    jmodel = JQ.build_encoder(jcfg)
    coords, feats = JQ.flatten_camera_observations(
        [JQ.normalize_rgb(jnp.asarray(r)) for r in rgbs], [jnp.asarray(p) for p in pcds])
    ref, _, _ = jax.jit(lambda p, c, f: JQ.apply_with_front(
        jcfg, jmodel, p, c, f, jnp.asarray(bounds), jnp.asarray(proprio),
        jnp.asarray(lg), jnp.asarray(lt)))(params, coords, feats)
    with torch.no_grad():
        tc, tf = Q.flatten_camera_observations(
            [Q.normalize_rgb(torch.tensor(r)) for r in rgbs],
            [torch.tensor(p) for p in pcds])
        got, _, overflow = Q.apply_with_front(cfg, model, tc, tf, torch.tensor(bounds),
                                              torch.tensor(proprio), torch.tensor(lg),
                                              torch.tensor(lt))
    assert (overflow.numpy() == 0).all()
    tols = {}
    for k in ref:
        r = np.asarray(ref[k], np.float32)
        g = got[k].float().numpy()
        # both sides round at the same points; one-ulp differences (f32 sum
        # orders, P of attention, trans kept f32 by the tail kernel) carry
        # through the random-weight network: 5% of the output's range
        tols[k] = 0.05 * max(1.0, np.abs(r).max())
        np.testing.assert_allclose(g, r, atol=tols[k], rtol=0, err_msg=k)

    out = infer(model, rgbs, pcds, proprio, lg, lt, bounds)
    _, jinfer = JQ.make_infer_fn(jcfg)
    jout = jinfer(params, tuple(map(jnp.asarray, rgbs)), tuple(map(jnp.asarray, pcds)),
                  *map(jnp.asarray, (proprio, lg, lt, bounds)))
    nr = cfg.num_rotation_classes
    r_trans = np.asarray(ref["trans"]).reshape(2, -1)
    r_rg = np.asarray(ref["rot_grip"])
    heads = [("trans", r_trans, tols["trans"])] + [
        (f"rot{i}", r_rg[:, i * nr:(i + 1) * nr], tols["rot_grip"]) for i in range(3)] + [
        ("grip", r_rg[:, 3 * nr:], tols["rot_grip"]),
        ("collision", np.asarray(ref["collision"]), tols["collision"])]
    g_idx = np.concatenate([out.rot_grip_idx.numpy(), out.collision_idx.numpy()], 1)
    j_idx = np.concatenate([np.asarray(jout.rot_grip_idx),
                            np.asarray(jout.collision_idx)], 1)
    g_trans = out.trans_idx.numpy()
    j_trans = np.asarray(jout.trans_idx)
    for bi in range(2):
        for hi, (name, logits, tol) in enumerate(heads):
            if name == "trans":
                same = (g_trans[bi] == j_trans[bi]).all()
            else:
                same = g_idx[bi, hi - 1] == j_idx[bi, hi - 1]
            if not same:
                top2 = np.sort(logits[bi])[-2:]
                assert top2[1] - top2[0] <= tol, (name, bi, top2)


def _agent_observation(rng, img=16):
    obs = {"lang_goal_emb": rng.normal(size=(1024,)).astype(np.float32),
           "lang_token_embs": rng.normal(size=(77, 512)).astype(np.float32),
           "low_dim_state_left_arm": np.asarray([1.0, 0.02, 0.01, 0.5], np.float32),
           "low_dim_state_right_arm": np.asarray([0.0, 0.03, 0.04, 0.5], np.float32),
           "wrist_camera_extrinsics": np.eye(4, dtype=np.float32),
           "wrist_camera_intrinsics": np.asarray(
               [[100, 0, 8], [0, 100, 8], [0, 0, 1]], np.float32)}
    for cam in ("wrist", "wrist2"):
        obs[f"{cam}_rgb"] = rng.integers(0, 255, (img, img, 3)).astype(np.float32)
        obs[f"{cam}_point_cloud"] = rng.uniform(-0.4, 1.2, (img, img, 3)).astype(
            np.float32)
    return obs


@pytest.mark.parametrize("which_arm", ["dominant", "assistive"])
def test_agent_act_dominant_assistive(dominant, which_arm):
    kw, params = dominant
    kw = dict(kw, which_arm=which_arm, arm_pred_loss=which_arm == "dominant")
    if which_arm == "assistive":
        params = random_params(kw, 5)
    cams = ["wrist", "wrist2"]
    crop = [-0.1, -0.3, 0.5, 0.5, 0.3, 1.1]
    jagent = JaxAgent(JaxMethodConfig(**kw), cams, [-0.8, -1.0, 0.1, 1.2, 1.0, 2.1])
    jagent.build(training=False)
    jagent.params = params
    agent = QAttentionBCAgent(MethodConfig(**kw), cams, [-0.8, -1.0, 0.1, 1.2, 1.0, 2.1],
                              device="cpu")
    agent.build(training=False)
    agent.params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(6)
    for step in range(2):
        obs = _agent_observation(rng)
        args = dict(which_arm=which_arm, new_scene_bounds=crop,
                    dominant_assitive_policy=True)
        ref = jagent.act(step, obs, **args)
        got = agent.act(step, obs, **args)
        for key in ("trans_action_indicies", "rot_grip_action_indicies"):
            np.testing.assert_array_equal(got.observation_elements[key],
                                          np.asarray(ref.observation_elements[key]))
        np.testing.assert_allclose(np.asarray(got.action), np.asarray(ref.action),
                                   atol=1e-5)
        assert got.observation_elements["wrist_pixel_coord"] == \
            ref.observation_elements["wrist_pixel_coord"]
        assert got.info["front_overflow"] == 0


def test_agent_training_and_checkpoints_are_a_later_slice(tmp_path):
    """Training and the port's own checkpoints are in (tests/
    test_torch_agent_train.py drives them); what still waits for a later slice
    is reading the JAX package's msgpack checkpoints, and that raises."""
    agent = QAttentionBCAgent(MethodConfig(**TINY), ["wrist"], [0, 0, 0, 1, 1, 1],
                              device="cpu")
    with pytest.raises(RuntimeError, match="training=True"):
        agent.update(0, {})  # built for acting only (lazily, by nothing yet)
    agent.build(training=True)
    agent.save_weights(str(tmp_path))
    assert (tmp_path / "QAttentionAgent_layer0.pt").exists()
    with pytest.raises(NotImplementedError, match="msgpack"):
        agent.load_weight(str(tmp_path / "QAttentionAgent_layer0.msgpack"))


def test_unported_kernel_flags_raise():
    for flag in ("pallas_stats", "pallas_decoder_v3", "pallas_encoder"):
        cfg = MethodConfig(**TINY, compute_dtype="bfloat16", **{flag: True})
        with pytest.raises(NotImplementedError, match=flag):
            Q.build_encoder(cfg, device="cpu")
    # pallas_encoder is inert where the fused front takes over, as in JAX
    cfg = dataclasses.replace(MethodConfig(**TINY, **KERNELS), pallas_encoder=True)
    Q.build_encoder(cfg, device="cpu")
