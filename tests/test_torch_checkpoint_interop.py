"""The JAX package's msgpack checkpoints in the port, both ways, on the CPU:
the port's pure-Python codec (``utils/msgpack_codec``) against flax's bytes,
a JAX ``QAttentionBCAgent`` checkpoint read, acted on and trained on by the
port's agent, the port's JAX-format checkpoint read by the JAX agent, and
``cli.eval`` / ``cli.train`` of the port on a seed directory the JAX
``cli.train`` wrote."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from voxactb_tpu_torch.utils import msgpack_codec


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


def _bf16(a):
    """numpy bf16 bits (through jnp) as a ``torch.bfloat16`` tensor."""
    bits = np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.int16).copy()
    return torch.from_numpy(bits).view(torch.bfloat16)


def _same(got, want, path=""):
    """Leaf for leaf: same keys, dtypes, shapes and bits (bf16 compared as its
    16-bit pattern, numpy scalars and Python scalars by type and value)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, (np.ndarray, np.generic, jax.Array)) and \
            str(np.asarray(want).dtype) == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16), err_msg=path)
        return
    if isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, (path, type(got))
        np.testing.assert_array_equal(got, want, err_msg=path)
        return
    assert type(got) is type(want) and got == want, (path, got, want)


def _tree(rng):
    """A tree of every leaf kind a checkpoint holds."""
    nt = serialization.to_state_dict((np.arange(3, dtype=np.int32), {"x": np.float32(2.0)}))
    return {"params": {"dense": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                                 "bias": np.zeros(4, np.float32)},
                       "ids": rng.integers(-9, 9, (2, 5)).astype(np.int32),
                       "mask": rng.integers(0, 2, (7,)).astype(bool),
                       "strided": rng.normal(size=(4, 3)).astype(np.float32).T},
            "bf16": rng.normal(size=(2, 3)).astype(np.float32),
            "step": 12345, "neg": -70000, "big": 2 ** 40, "lr": 1e-3, "flag": True,
            "none": None, "name": "QAttentionAgent_layer0", "long": "x" * 300,
            "npscalar": np.float32(0.5), "count": np.asarray(3, np.int32),
            "u8": np.arange(300, dtype=np.uint8), "f16": np.ones((2, 2), np.float16),
            "tuple_state": nt, "empty": {}, "list": [1, 2.5, "a"]}


def _flax_and_port(tree):
    """The same tree as flax takes it (bf16 a jnp array) and as the port does
    (bf16 a torch tensor)."""
    theirs = dict(tree, bf16=jnp.asarray(tree["bf16"], jnp.bfloat16))
    return theirs, dict(tree, bf16=_bf16(tree["bf16"]))


def test_writer_gives_flax_bytes():
    theirs, mine = _flax_and_port(_tree(np.random.default_rng(0)))
    assert msgpack_codec.serialize(mine) == serialization.msgpack_serialize(theirs)
    # tuples and named tuples go through to_state_dict, as flax's do
    st = (np.ones(2, np.float32), {"a": [np.int32(1)]})
    assert msgpack_codec.to_state_dict(st) == {"0": st[0], "1": {"a": {"0": np.int32(1)}}}
    with pytest.raises(TypeError, match="tuple"):
        msgpack_codec.serialize({"t": (1, 2)})


def test_reader_restores_flax_bytes_leaf_for_leaf():
    theirs, _ = _flax_and_port(_tree(np.random.default_rng(1)))
    data = serialization.msgpack_serialize(theirs)
    _same(msgpack_codec.restore(data), serialization.msgpack_restore(data))


def test_chunked_arrays_both_ways(monkeypatch):
    """Arrays above flax's ``MAX_CHUNK_SIZE`` (made small on both sides) are
    written as flat chunks and read back whole; a dropped chunk raises."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_codec, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(2)
    tree = {"w": rng.normal(size=(10, 7)).astype(np.float32),
            "nested": {"ids": np.arange(41, dtype=np.int64),
                       "bf": rng.normal(size=(70,)).astype(np.float32)},
            "small": np.ones(3, np.float32)}
    theirs = {**tree, "nested": dict(tree["nested"],
                                     bf=jnp.asarray(tree["nested"]["bf"], jnp.bfloat16))}
    mine = {**tree, "nested": dict(tree["nested"], bf=_bf16(tree["nested"]["bf"]))}
    data = serialization.msgpack_serialize(theirs)
    assert msgpack_codec.serialize(mine) == data
    raw = msgpack_codec.unpackb(data)
    assert raw["w"][msgpack_codec.CHUNKED] and len(raw["w"]["chunks"]) == 5
    _same(msgpack_codec.restore(data), serialization.msgpack_restore(data))
    del raw["w"]["chunks"]["4"]
    with pytest.raises(ValueError, match="chunked array"):
        msgpack_codec._unchunk_leaves(raw)


def test_a_planted_bf16_byte_swap_is_seen():
    """A bf16 leaf written with its bytes swapped reads back as other
    values: the bit-level comparison the chip phase makes must see it."""
    x = _bf16(np.random.default_rng(3).normal(size=(16,)).astype(np.float32))
    good = msgpack_codec.restore(msgpack_codec.serialize({"x": x}))["x"]
    swapped = x.view(torch.int16).numpy().byteswap().copy()
    bad = msgpack_codec.restore(msgpack_codec.serialize(
        {"x": torch.from_numpy(swapped).view(torch.bfloat16)}))["x"]
    assert torch.equal(good.view(torch.int16), x.view(torch.int16))
    assert not torch.equal(bad.view(torch.int16), x.view(torch.int16))


# -- a JAX run's checkpoints in the port ------------------------------------------------

# the tiny configuration of tests/test_torch_cli.py; f32, dropout and
# augmentation off, so that an update is a function of the state and the batch
CLI = [
    "rlbench.demo_path=sim", 'rlbench.tasks=["open_jar"]',
    "rlbench.task_name=open_jar", "rlbench.demos=2",
    'rlbench.cameras=["wrist", "wrist2"]', "rlbench.camera_resolution=[12,12]",
    "rlbench.episode_length=6",
    "method.voxel_sizes=[10]", "method.num_latents=16",
    "method.latent_dim=32", "method.transformer_depth=1",
    "method.cross_dim_head=16", "method.latent_dim_head=16",
    "method.final_dim=8", "method.which_arm=dominant",
    "method.crop_target_obj_voxel=True", "method.crop_radius=0.3",
    "method.arm_pred_loss=True", "method.lr=0.001",
    "method.input_dropout=0.0", "method.attn_dropout=0.0", "method.apply_se3=False",
    "replay.batch_size=2", "framework.log_freq=1",
    "framework.tensorboard_logging=False",
]
CKPT = "QAttentionAgent_layer0.msgpack"


def _language(text):
    r = np.random.default_rng(len(text))
    return (r.normal(size=(1, 1024)).astype(np.float32),
            r.normal(size=(1, 77, 512)).astype(np.float32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX ``cli.train`` at the tiny config, 3 updates with checkpoints at
    steps 0 and 2: its seed directory, its agent (the train state the last
    checkpoint holds, the train step compiled) and its replay. The agent's
    init runs under ``jax.jit`` here (op by op it compiles every primitive
    alone, about 30 s more)."""
    import voxactb_tpu.agents.qattention_agent as jax_agent_module
    from voxactb_tpu.cli import train as jax_train

    made = {}
    build, build_replay = jax_agent_module.QAttentionBCAgent.build, jax_train.build_replay_and_agent

    def jitted_build(self, training, device=None):
        build(self, training, device)
        if training:
            self._init_fn = jax.jit(self._init_fn)

    def keep(*args, **kwargs):
        made["replay"], made["agent"] = build_replay(*args, **kwargs)
        return made["replay"], made["agent"]

    root = tmp_path_factory.mktemp("jax_cli_run")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_agent_module.QAttentionBCAgent, "build", jitted_build)
        mp.setattr(jax_train, "build_replay_and_agent", keep)
        seed_dir = jax_train.main(CLI + ["framework.training_iterations=3",
                                         "framework.save_freq=2", f"log_dir={root}"],
                                  lang_encoder=_language)
    return seed_dir, made["agent"], made["replay"]


def _port_agent(seed_dir, training):
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.config import Config

    cfg = Config.load(os.path.join(seed_dir, "config.json"))
    agent = QAttentionBCAgent(cfg.method, cfg.rlbench.cameras, cfg.rlbench.scene_bounds,
                              batch_size=2, training_iterations=cfg.framework.training_iterations,
                              device="cpu")
    agent.build(training=training)
    return agent


def test_jax_run_wrote_msgpack_checkpoints(jax_run):
    seed_dir, jagent, _ = jax_run
    weights = sorted(glob.glob(os.path.join(seed_dir, "weights", "*", "*")))
    assert [os.path.relpath(w, seed_dir) for w in weights] == [
        os.path.join("weights", s, CKPT) for s in ("0", "2")]
    payload = serialization.msgpack_restore(open(weights[-1], "rb").read())
    assert int(payload["step"]) == int(jagent._state.step) == 3
    assert set(payload) == {"params", "step", "opt_state"}


def test_port_reads_the_jax_checkpoint_and_acts_alike(jax_run):
    """Every parameter bit-equal to the JAX agent's; acts on the first two
    observations of the sim inside its crop: the integer outputs exact, the
    Q-field within the f32 tolerance of test_torch_infer.py (1e-5)."""
    from voxactb_tpu.sim.environment import BimanualTaskEnvironment as JaxEnv
    from voxactb_tpu.sim.tasks import TASK_REGISTRY
    from voxactb_tpu_torch.ops.geometry import scene_bounds_from_crop
    from voxactb_tpu_torch.weights import tensors_to_flax_tree

    seed_dir, jagent, _ = jax_run
    ckpt_dir = os.path.join(seed_dir, "weights", "2")
    agent = _port_agent(seed_dir, training=False)
    agent.load_weights(ckpt_dir)  # no .pt there: the .msgpack of the same name
    got = tensors_to_flax_tree(agent.params, dict(agent.params.named_parameters()))
    _same(got, _np(jagent._state.params))

    jagent.build(training=False)
    jagent.params = jagent._state.params
    env = JaxEnv(TASK_REGISTRY["open_jar"], cameras=CAMERAS, image_size=12,
                 episode_length=6, seed=0,
                 lang_encoder=lambda t: tuple(a[0] for a in _language(t)))
    for demo in (0, 1):
        obs = env.reset_to_demo(demo)
        bounds = scene_bounds_from_crop(env.target_object_world_coords(), 0.3).tolist()
        kw = dict(deterministic=True, which_arm="dominant", new_scene_bounds=bounds,
                  dominant_assitive_policy=True)
        ref = jagent.act(0, dict(obs), **kw)
        res = agent.act(0, dict(obs), **kw)
        for key in ("trans_action_indicies", "rot_grip_action_indicies"):
            np.testing.assert_array_equal(res.observation_elements[key],
                                          ref.observation_elements[key], err_msg=key)
        np.testing.assert_allclose(np.asarray(res.info["q_depth0"]).reshape(-1),
                                   np.asarray(ref.info["q_depth0"]).reshape(-1), atol=1e-5)


def test_resume_from_the_jax_checkpoint_matches_the_jax_update(jax_run, tmp_path):
    """The port's agent, loaded before its first update (the train runner's
    resume order), takes the JAX agent's next update on the same replay
    batch from the restored LAMB state and step: losses within 1e-4, every
    parameter within 1e-6 of its leaf's largest value plus 1e-3 of the leaf's
    largest move (the f32 noise of the gradients reaches an update at that
    size; test_torch_train_step), the moments within 3e-5 of a leaf's largest
    plus 1e-6 of the tree's largest (a leaf whose gradient vanishes in exact
    arithmetic, as the translation decoder's bias does, since the softmax
    less its one-hot sums to zero, holds only the rounding of its sum, which
    scales with the whole tree's gradients), step and count exact. Then the
    port writes the JAX format, and the JAX agent reads the same parameters,
    optimizer state and step and writes the same bytes back."""
    from voxactb_tpu_torch.weights import optax_state_tree, tensors_to_flax_tree

    seed_dir, jagent, jreplay = jax_run
    agent = _port_agent(seed_dir, training=True)
    agent.load_weights(os.path.join(seed_dir, "weights", "2"))
    saved = _np(jagent._state.params)
    batch = jreplay.sample_transition_batch(2)
    batch["scene_bounds"] = np.asarray(BOUNDS, np.float32)
    jagent._training = True  # after the act test's build: its train step stays compiled
    jloss = float(jagent.update(3, dict(batch))["total_loss"])
    loss = float(agent.update(3, dict(batch))["total_loss"])
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    assert int(agent._state.step) == int(jagent._state.step) == 4
    jadam = jagent._state.opt_state[0]
    assert int(agent._state.opt_state.count) == int(jadam.count) == 4
    got = tensors_to_flax_tree(agent.params, agent._state.params)["params"]
    ref = dict(jax.tree_util.tree_leaves_with_path(_np(jagent._state.params)["params"]))
    old = dict(jax.tree_util.tree_leaves_with_path(saved["params"]))
    moved = 0.0
    for path, a in jax.tree_util.tree_leaves_with_path(got):
        move = float(np.abs(ref[path] - old[path]).max())
        np.testing.assert_allclose(a, ref[path], rtol=0,
                                   atol=1e-6 * np.abs(ref[path]).max() + 1e-3 * move,
                                   err_msg=jax.tree_util.keystr(path))
        moved = max(moved, move)
    assert moved > 1e-5
    for mine, theirs in ((agent._state.opt_state.mu, jadam.mu),
                         (agent._state.opt_state.nu, jadam.nu)):
        want = dict(jax.tree_util.tree_leaves_with_path(_np(theirs)))
        largest = max(float(np.abs(w).max()) for w in want.values())
        for path, a in jax.tree_util.tree_leaves_with_path(
                tensors_to_flax_tree(agent.params, mine)):
            np.testing.assert_allclose(
                a, want[path], rtol=0,
                atol=3e-5 * np.abs(want[path]).max() + 1e-6 * largest,
                err_msg=jax.tree_util.keystr(path))

    out = str(tmp_path / "port")
    os.makedirs(out)
    agent.save_weight(os.path.join(out, CKPT))
    jagent.load_weights(out)
    _same(_np(jagent._state.params), tensors_to_flax_tree(agent.params, agent._state.params))
    _same(_np(serialization.to_state_dict(jagent._state.opt_state)),
          optax_state_tree(agent.params, agent._state.opt_state, "lamb", scheduled=False))
    assert int(jagent._state.step) == 4
    again = str(tmp_path / "jax")
    jagent.save_weights(again)
    with open(os.path.join(out, CKPT), "rb") as a, open(os.path.join(again, CKPT), "rb") as b:
        assert a.read() == b.read()


def test_adam_state_paths_round_trip():
    """The Adam chain keeps its moments under '1' and the schedule's count
    under '2'; LAMB under '0' and '3' (optax's own trees)."""
    import optax

    from voxactb_tpu_torch.agents.qfunction import build_encoder
    from voxactb_tpu_torch.config import MethodConfig
    from voxactb_tpu_torch.weights import (
        opt_state_from_flax, optax_state_tree, tensors_to_flax_tree)

    model = build_encoder(MethodConfig(voxel_sizes=[10], num_latents=16, latent_dim=32,
                                       transformer_depth=1, cross_dim_head=16,
                                       latent_dim_head=16), device="cpu", seed=0)
    params = tensors_to_flax_tree(model, dict(model.named_parameters()))
    rng = np.random.default_rng(4)
    for kind, opt in (("adam", optax.chain(optax.add_decayed_weights(1e-6),
                                           optax.scale_by_adam(),
                                           optax.scale_by_learning_rate(lambda s: 1e-3))),
                      ("lamb", optax.lamb(lambda s: 1e-3, weight_decay=1e-6))):
        state = list(opt.init(jax.tree_util.tree_map(jnp.asarray, params)))
        adam_at = 1 if kind == "adam" else 0
        moments = [jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params) for _ in range(2)]
        state[adam_at] = state[adam_at]._replace(count=jnp.asarray(7, jnp.int32),
                                                 mu=moments[0], nu=moments[1])
        state[-1] = state[-1]._replace(count=jnp.asarray(7, jnp.int32))
        tree = _np(serialization.to_state_dict(tuple(state)))
        mine = opt_state_from_flax(model, tree)
        assert int(mine.count) == 7
        _same(optax_state_tree(model, mine, kind, scheduled=True), tree)


def test_port_clis_on_the_jax_seed_dir(jax_run):
    """The port's ``cli.eval`` scores every checkpoint of the JAX run with a
    .msgpack stabilizing checkpoint, and its ``cli.train`` resumes the run
    from the last one with its optimizer state and step."""
    from voxactb_tpu_torch.cli import eval as eval_cli
    from voxactb_tpu_torch.cli import train

    seed_dir = jax_run[0]
    left = os.path.join(seed_dir, "weights", "2", CKPT)
    results = eval_cli.main([f"seed_dir={seed_dir}", "framework.eval_type=missing",
                             "framework.eval_episodes=1",
                             f"framework.left_arm_ckpt={left}"], device="cpu")
    assert [r["step"] for r in results] == [0, 2]
    assert all(np.isfinite(r["eval_envs/return"]) for r in results)

    root = os.path.dirname(os.path.dirname(os.path.dirname(seed_dir)))
    again = train.main(CLI + ["framework.training_iterations=5", "framework.save_freq=2",
                              f"log_dir={root}"], lang_encoder=_language, device="cpu")
    assert again == seed_dir
    payload = torch.load(os.path.join(seed_dir, "weights", "4", "QAttentionAgent_layer0.pt"),
                         map_location="cpu", weights_only=True)
    # 3 steps in JAX, then 2 more from the restored optimizer state and step
    assert payload["step"] == 5 and int(payload["opt_state"]["count"]) == 5
