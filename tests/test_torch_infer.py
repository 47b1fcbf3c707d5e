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
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.agents import qfunction as JQ
from voxactb_tpu.agents.qattention_agent import QAttentionBCAgent as JaxAgent
from voxactb_tpu.config import MethodConfig as JaxMethodConfig
from voxactb_tpu.ops.pallas import stats_head as jax_stats_module
from voxactb_tpu_torch.agents import qfunction as Q
from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
from voxactb_tpu_torch.config import MethodConfig
from voxactb_tpu_torch.weights import load_flax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

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
    test_torch_agent_train.py drives them), and so is the JAX package's
    msgpack format (tests/test_torch_checkpoint_interop.py holds it to the
    JAX agent): a ``.msgpack`` the agent writes reads back to the same
    weights, and a missing one raises."""
    agent = QAttentionBCAgent(MethodConfig(**TINY), ["wrist"], [0, 0, 0, 1, 1, 1],
                              device="cpu")
    with pytest.raises(RuntimeError, match="training=True"):
        agent.update(0, {})  # built for acting only (lazily, by nothing yet)
    agent.build(training=True)
    agent.save_weights(str(tmp_path))
    assert (tmp_path / "QAttentionAgent_layer0.pt").exists()
    with pytest.raises(FileNotFoundError):
        agent.load_weight(str(tmp_path / "QAttentionAgent_layer0.msgpack"))
    agent.save_weight(str(tmp_path / "QAttentionAgent_layer0.msgpack"))
    other = QAttentionBCAgent(MethodConfig(**TINY), ["wrist"], [0, 0, 0, 1, 1, 1],
                              device="cpu", seed=1)
    other.load_weight(str(tmp_path / "QAttentionAgent_layer0.msgpack"))
    want = agent.params.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in other.params.state_dict().items())


# the dense-grid act path's kernel flags (pallas_front off: voxelize builds the
# real grid), alone, together, and together on the two-head variant
DENSE_CASES = {
    "encoder": dict(pallas_encoder=True),
    "stats": dict(pallas_stats=True),
    "decoder_v3": dict(pallas_decoder_v3=True),
    "all": dict(pallas_encoder=True, pallas_stats=True, pallas_decoder_v3=True),
    "all_two_heads": dict(pallas_encoder=True, pallas_stats=True, pallas_decoder_v3=True,
                          variant="one_policy_more_heads", which_arm="both"),
}


def _argmax_groups(out, nr):
    """(key, columns) of every integer action the decode takes from ``out``."""
    rot = [slice(i * nr, (i + 1) * nr) for i in range(3)] + [slice(3 * nr, None)]
    return [(k, sl) for k in out for sl in (rot if k.startswith("rot_grip") else [slice(None)])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_grid_kernel_flags_match_jax(case, dtype, monkeypatch):
    """The port's dense-grid act with K5, K6 and K8 (their plain versions on
    the CPU) against the JAX package's with the same flags, its Pallas kernels
    in interpret mode. The kernels take the JAX package's gates: K5 only at
    bf16, K6 and K8 at either dtype.

    - f32: the integer actions are exact; K6 and K8 compute in f32 on both
      sides, so the Q-field differs by f32 summation order only.
    - bf16: the Q-field and the logits (two groups) within twice the JAX
      package's own bf16-vs-f32 distance over the group, the f32 side from
      the port's f32 path (which the f32 cases hold to the JAX one): if the
      port is no less accurate at bf16 than the reference, the triangle
      inequality keeps the two within it. An action may flip only where the
      JAX output's top-two gap is inside that tolerance.

    The JAX model calls its stats kernel without ``pallas_interpret``; here
    it runs in interpret mode, as tests/test_pallas_stats.py runs it.
    """
    monkeypatch.setattr(jax_stats_module, "stats_head",
                        functools.partial(jax_stats_module.stats_head, interpret=True))
    kw = dict(TINY, which_arm="right", compute_dtype=dtype, pallas_interpret=True)
    kw.update(DENSE_CASES[case])
    params = random_params(kw, 7)
    jcfg = JaxMethodConfig(**kw)
    cfg = MethodConfig(**kw)
    model, infer = _port_model(kw, params)
    rng = np.random.default_rng(8)
    obs = observation_batch(rng, 2, cfg.proprio_width())

    if dtype == "float32":
        _, jinfer = JQ.make_infer_fn(jcfg)
        ref = jinfer(params, tuple(map(jnp.asarray, obs[0])),
                     tuple(map(jnp.asarray, obs[1])), *map(jnp.asarray, obs[2:]))
        got = infer(model, *obs)
        for field in ("trans_idx", "rot_grip_idx", "collision_idx"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(ref, field)), err_msg=field)
        q = np.asarray(ref.q_trans)
        np.testing.assert_allclose(got.q_trans.numpy(), q, atol=1e-5 * np.abs(q).max(),
                                   rtol=0)
        # the dense path hands out the real grid
        np.testing.assert_allclose(got.voxel_grid.numpy(), np.asarray(ref.voxel_grid),
                                   atol=1e-5)
        assert got.voxel_grid.shape == (2, 10, 10, 10, 10)
        assert (got.front_overflow.numpy() == 0).all()
        return

    rgbs, pcds, proprio, lg, lt, bounds = obs
    jmodel = JQ.build_encoder(jcfg)
    coords, feats = JQ.flatten_camera_observations(
        [JQ.normalize_rgb(jnp.asarray(r)) for r in rgbs], [jnp.asarray(p) for p in pcds])
    ref, _, _ = jax.jit(lambda p, c, f: JQ.apply_with_front(
        jcfg, jmodel, p, c, f, jnp.asarray(bounds), jnp.asarray(proprio),
        jnp.asarray(lg), jnp.asarray(lt)))(params, coords, feats)
    kw32 = dict(kw, compute_dtype="float32")
    model32, _ = _port_model(kw32, params)
    args = tuple(torch.tensor(a) for a in (bounds, proprio, lg, lt))
    with torch.no_grad():
        tc, tf = Q.flatten_camera_observations(
            [Q.normalize_rgb(torch.tensor(r)) for r in rgbs],
            [torch.tensor(p) for p in pcds])
        got, grid, overflow = Q.apply_with_front(cfg, model, tc, tf, *args)
        f32, _, _ = Q.apply_with_front(MethodConfig(**kw32), model32, tc, tf, *args)
    assert grid.shape == (2, 10, 10, 10, 10) and (overflow.numpy() == 0).all()
    assert set(got) == set(ref)
    ref = {k: np.asarray(v, np.float32) for k, v in ref.items()}
    group = lambda k: "trans" if k.startswith("trans") else "logits"  # noqa: E731
    plain = {}
    for k in ref:
        d = np.abs(ref[k] - f32[k].numpy()).max()
        plain[group(k)] = max(plain.get(group(k), 0.0), d)
    tols = {k: 2.0 * plain[group(k)] for k in ref}
    for k in ref:
        np.testing.assert_allclose(got[k].float().numpy(), ref[k], atol=tols[k], rtol=0,
                                   err_msg=k)
    for k, cols in _argmax_groups(ref, cfg.num_rotation_classes):
        r = ref[k].reshape(2, -1)[:, cols]
        g = got[k].float().numpy().reshape(2, -1)[:, cols]
        for bi in range(2):
            if g[bi].argmax() != r[bi].argmax():
                top2 = np.sort(r[bi])[-2:]
                assert top2[1] - top2[0] <= tols[k], (k, bi, top2)


def test_pallas_encoder_inert_under_fused_front(monkeypatch):
    """Where the fused front (K1) is eligible, ``pallas_encoder`` takes no
    part, as in the JAX package: the act never reaches K5."""
    import voxactb_tpu_torch.ops.cuda.encoder_stats as K5

    def refuse(*args, **kwargs):
        raise AssertionError("K5 ran under the fused front")

    monkeypatch.setattr(K5, "encoder_stats", refuse)
    cfg = dataclasses.replace(MethodConfig(**TINY, **KERNELS), pallas_encoder=True)
    assert Q.front_eligible(cfg)
    model, infer = Q.make_infer_fn(cfg, device="cpu")
    out = infer(model, *observation_batch(np.random.default_rng(9), 2, 4))
    assert out.voxel_grid.shape == (2, 1, 1, 1, 10)  # the dense grid was never built
