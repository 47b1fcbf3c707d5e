"""The slice as a whole: the port's ``cli.train`` -> ``cli.eval`` on the
kinematic sim at a tiny config on the CPU (config, ``.pt`` checkpoints, both
CSVs, resume), against the JAX package's CLIs on the same overrides: equal
replays from ``build_replay_and_agent``, the first ``update``'s losses from
carried-over weights at f32, and the act on the first eval observation."""

import csv
import glob
import os

import jax
import numpy as np
import pytest
import torch

OVERRIDES = [
    "rlbench.demo_path=sim", 'rlbench.tasks=["open_jar"]',
    "rlbench.task_name=open_jar", "rlbench.demos=2",
    'rlbench.cameras=["wrist", "wrist2"]', "rlbench.camera_resolution=[12,12]",
    "rlbench.episode_length=6",
    "method.voxel_sizes=[10]", "method.num_latents=16",
    "method.latent_dim=32", "method.transformer_depth=1",
    "method.cross_dim_head=16", "method.latent_dim_head=16",
    "method.final_dim=8", "method.which_arm=dominant",
    "method.crop_target_obj_voxel=True", "method.crop_radius=0.3",
    "method.arm_pred_loss=True",
    "replay.batch_size=2", "framework.log_freq=1",
    "framework.tensorboard_logging=False",
]
# f32, dropout and augmentation off: the first update is deterministic
EXACT = ["method.input_dropout=0.0", "method.attn_dropout=0.0", "method.apply_se3=False",
         "method.demo_augmentation_every_n=3"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _language(text):
    r = np.random.default_rng(len(text))
    return (r.normal(size=(1, 1024)).astype(np.float32),
            r.normal(size=(1, 77, 512)).astype(np.float32))


@pytest.fixture(scope="module")
def seed_dir(tmp_path_factory):
    from voxactb_tpu_torch.cli import train

    root = tmp_path_factory.mktemp("torch_cli_run")
    return train.main(OVERRIDES + ["framework.training_iterations=3",
                                   "framework.save_freq=2", f"log_dir={root}"],
                      lang_encoder=_language, device="cpu")


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_train_writes_config_pt_weights_and_log(seed_dir):
    from voxactb_tpu.config import Config as JaxConfig

    # the JAX package reads the port's snapshot
    cfg = JaxConfig.load(os.path.join(seed_dir, "config.json"))
    assert cfg.method.which_arm == "dominant" and cfg.rlbench.cameras == ["wrist", "wrist2"]
    weights = sorted(glob.glob(os.path.join(seed_dir, "weights", "*", "*")))
    assert [os.path.relpath(w, seed_dir) for w in weights] == [
        os.path.join("weights", s, "QAttentionAgent_layer0.pt") for s in ("0", "2")]
    payload = torch.load(weights[-1], map_location="cpu", weights_only=True)
    assert payload["step"] == 3 and "opt_state" in payload
    rows = _rows(os.path.join(seed_dir, "train_data.csv"))
    assert [int(r["step"]) for r in rows] == [0, 1, 2]
    assert all(np.isfinite(float(r["QAttentionAgent_layer0/losses/total_loss"]))
               for r in rows)


def test_eval_scores_every_checkpoint(seed_dir):
    from voxactb_tpu_torch.cli import eval as eval_cli

    left = os.path.join(seed_dir, "weights", "2", "QAttentionAgent_layer0.pt")
    results = eval_cli.main([f"seed_dir={seed_dir}", "framework.eval_type=missing",
                             "framework.eval_episodes=1",
                             f"framework.left_arm_ckpt={left}"], device="cpu")
    rows = _rows(os.path.join(seed_dir, "eval_data.csv"))
    assert [int(float(r["step"])) for r in rows] == [r["step"] for r in results] == [0, 2]
    assert all(np.isfinite(float(r["eval_envs/return"])) for r in rows)
    # everything scored: a second sweep finds nothing
    assert eval_cli.main([f"seed_dir={seed_dir}", f"framework.left_arm_ckpt={left}"],
                         device="cpu") == []


def test_train_resumes_from_its_last_checkpoint(seed_dir):
    from voxactb_tpu_torch.cli import train

    root = os.path.dirname(os.path.dirname(os.path.dirname(seed_dir)))
    again = train.main(OVERRIDES + ["framework.training_iterations=5",
                                    "framework.save_freq=2", f"log_dir={root}"],
                       lang_encoder=_language, device="cpu")
    assert again == seed_dir
    assert sorted(int(s) for s in os.listdir(os.path.join(seed_dir, "weights"))) == [0, 2, 4]
    payload = torch.load(os.path.join(seed_dir, "weights", "4", "QAttentionAgent_layer0.pt"),
                         map_location="cpu", weights_only=True)
    # 3 steps, then 2 more from the restored optimizer state and step
    assert payload["step"] == 5
    rows = _rows(os.path.join(seed_dir, "train_data.csv"))
    assert [int(r["step"]) for r in rows] == [0, 1, 2, 3, 4]


def test_make_env_builds_the_sim_task_for_every_registered_name():
    from voxactb_tpu.sim.tasks import TASK_REGISTRY as JAX_REGISTRY
    from voxactb_tpu_torch.cli.eval import make_env
    from voxactb_tpu_torch.config import Config
    from voxactb_tpu_torch.envs.fake_env import FakeBimanualEnv
    from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment

    for name in ("open_jar", "hand_over_item", list(JAX_REGISTRY)[-1]):
        env = make_env(Config().override(**{"rlbench.task_name": name,
                                            "rlbench.camera_resolution": [8, 8]}))
        assert isinstance(env, BimanualTaskEnvironment), name
    env = make_env(Config().override(**{"rlbench.task_name": "not_a_sim_task"}))
    assert isinstance(env, FakeBimanualEnv)


def test_use_disk_raises_not_implemented(tmp_path):
    """``replay.use_disk=True`` no longer raises ``NotImplementedError``: it
    trains from the native store at ``replay.path/seed0.replay``, and stops
    with a message where the store holds fewer rows than a batch (its C++
    sampler would wait for them forever)."""
    from voxactb_tpu_torch.cli import train
    from voxactb_tpu_torch.replay.native_buffer import NativeReplayBuffer

    stores = []
    disk = OVERRIDES + ["replay.use_disk=True", f"replay.path={tmp_path / 'replay'}",
                        "framework.training_iterations=2", "framework.save_freq=1"]
    seed_dir = train.main(disk + [f"log_dir={tmp_path / 'run'}"], lang_encoder=_language,
                          device="cpu")
    assert os.path.exists(os.path.join(seed_dir, "weights", "1", "QAttentionAgent_layer0.pt"))
    assert (tmp_path / "replay" / "seed0.replay").exists()
    original = NativeReplayBuffer.__init__

    def keep(self, *a, **kw):
        original(self, *a, **kw)
        stores.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(NativeReplayBuffer, "__init__", keep)
        with pytest.raises(SystemExit, match="fewer than a batch of 100000"):
            train.main(disk + ["replay.batch_size=100000", f"log_dir={tmp_path / 'big'}",
                               f"replay.path={tmp_path / 'big_replay'}"],
                       lang_encoder=_language, device="cpu")
    assert len(stores) == 1 and stores[0]._handle is None  # closed on the way out


def test_language_encoder_failure_stops_training(tmp_path, monkeypatch):
    """Only a missing BPE merge table falls back to zero embeddings; an error
    building the encoder (a device fault, out of memory) ends the run."""
    from voxactb_tpu_torch.cli import train
    from voxactb_tpu_torch.models import clip_text

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(clip_text, "ClipLanguageEncoder", broken)
    with pytest.raises(RuntimeError, match="out of memory"):
        train.main(OVERRIDES + [f"log_dir={tmp_path}"], device="cpu")


def test_missing_bpe_table_falls_back_to_zero_embeddings(tmp_path, monkeypatch):
    from voxactb_tpu_torch.cli import train
    from voxactb_tpu_torch.models import clip_text
    from voxactb_tpu_torch.utils import bpe

    def no_table(*args, **kwargs):
        raise FileNotFoundError("CLIP BPE merge table not found")

    def unused(*args, **kwargs):
        raise AssertionError("the encoder is built without a tokenizer")

    seen = {}

    def build(cfg, lang_encoder, demos=None, device=None):
        seen["lang_encoder"] = lang_encoder
        raise SystemExit("stop after the encoder choice")

    monkeypatch.setattr(bpe, "SimpleTokenizer", no_table)
    monkeypatch.setattr(clip_text, "ClipLanguageEncoder", unused)
    monkeypatch.setattr(train, "build_replay_and_agent", build)
    with pytest.raises(SystemExit, match="encoder choice"):
        train.main(OVERRIDES + [f"log_dir={tmp_path}"], device="cpu")
    assert seen == {"lang_encoder": None}


# -- the port against the JAX package -------------------------------------------------


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Both packages' ``build_replay_and_agent`` on the same overrides."""
    from voxactb_tpu.cli import train as jax_train
    from voxactb_tpu.config import Config as JaxConfig
    from voxactb_tpu_torch.cli import train
    from voxactb_tpu_torch.config import Config

    over = train.parse_overrides(OVERRIDES + EXACT + ["framework.training_iterations=10"])
    assert over == jax_train.parse_overrides(OVERRIDES + EXACT
                                             + ["framework.training_iterations=10"])
    jreplay, jagent = jax_train.build_replay_and_agent(JaxConfig().override(**over),
                                                       _language)
    replay, agent = train.build_replay_and_agent(Config().override(**over), _language,
                                                 device="cpu")
    return (jreplay, jagent), (replay, agent)


def test_build_replay_and_agent_equal_replays(both):
    (jreplay, _), (replay, _) = both
    assert replay.size == jreplay.size > 4
    assert sorted(replay._store) == sorted(jreplay._store)
    for k, v in jreplay._store.items():
        np.testing.assert_array_equal(replay._store[k][: replay.size], v[: jreplay.size],
                                      err_msg=k)
    assert replay._task_indices == jreplay._task_indices


@pytest.fixture(scope="module")
def batches(both):
    """Seeded batches of the two replays (equal), with the scene bounds."""
    (jreplay, _), (replay, _) = both
    bounds = np.asarray([-0.8, -1.0, 0.1, 1.2, 1.0, 2.1], np.float32)
    batch = replay.sample_transition_batch(2)
    jbatch = jreplay.sample_transition_batch(2)
    batch["scene_bounds"] = jbatch["scene_bounds"] = bounds
    return batch, jbatch


@pytest.fixture(scope="module")
def init_params(both, batches):
    """The JAX agent's initial weights (its train state's init from key 0).
    The init runs under ``jax.jit``: op by op it compiles every primitive on
    its own, about 20 s on the CPU. The state is kept, so ``update`` does not
    run the init again."""
    (_, jagent), _ = both
    jagent.build(training=True)
    state = jax.jit(jagent._init_fn)(jax.random.key(0), {k: jax.numpy.asarray(v)
                                                          for k, v in batches[1].items()})
    jagent._state = state
    return state.params


def test_first_update_losses_match_jax_f32(both, batches, init_params):
    (_, jagent), (_, agent) = both
    batch, jbatch = batches
    for k in jbatch:
        np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
    jagent.build(training=True)
    jagent.params = init_params
    agent.build(training=True)
    agent.params = jax.tree_util.tree_map(np.asarray, init_params)
    jloss = float(jagent.update(0, jbatch)["total_loss"])
    loss = float(agent.update(0, batch)["total_loss"])
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    ref = {s.name: float(s.value) for s in jagent.update_summaries()}
    got = {s.name: float(s.value) for s in agent.update_summaries()}
    for name in ("trans_loss", "rot_loss", "grip_loss", "collision_loss", "arm_loss"):
        key = f"QAttentionAgent_layer0/losses/{name}"
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, err_msg=name)


def test_first_eval_act_matches_jax(both, init_params):
    """One act on the first eval observation of the sim, inside its crop: the
    same voxel index wherever the JAX Q-field's top-two gap exceeds
    test_torch_infer.py's f32 tolerance (1e-5), the same rotation and grip bins."""
    from voxactb_tpu.sim.environment import BimanualTaskEnvironment as JaxEnv
    from voxactb_tpu.sim.tasks import TASK_REGISTRY
    from voxactb_tpu_torch.ops.geometry import scene_bounds_from_crop

    (_, jagent), (_, agent) = both
    jagent.build(training=False)
    jagent.params = init_params
    agent.build(training=False)
    agent.params = jax.tree_util.tree_map(np.asarray, init_params)
    env = JaxEnv(TASK_REGISTRY["open_jar"], cameras=["wrist", "wrist2"], image_size=12,
                 episode_length=6, seed=0,
                 lang_encoder=lambda t: tuple(a[0] for a in _language(t)))
    obs = env.reset_to_demo(0)
    bounds = scene_bounds_from_crop(env.target_object_world_coords(), 0.3).tolist()
    kw = dict(deterministic=True, which_arm="left", new_scene_bounds=bounds,
              dominant_assitive_policy=True)
    ref = jagent.act(0, dict(obs), **kw)
    got = agent.act(0, dict(obs), **kw)
    q = np.asarray(ref.info["q_depth0"]).reshape(-1)
    top2 = np.sort(q)[-2:]
    if top2[1] - top2[0] > 1e-5:
        np.testing.assert_array_equal(got.observation_elements["trans_action_indicies"],
                                      ref.observation_elements["trans_action_indicies"])
    np.testing.assert_array_equal(got.observation_elements["rot_grip_action_indicies"],
                                  ref.observation_elements["rot_grip_action_indicies"])
    np.testing.assert_allclose(np.asarray(got.info["q_depth0"]).reshape(-1), q, atol=1e-5)
