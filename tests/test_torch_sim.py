"""The port's kinematic sim (voxactb_tpu_torch/sim/) against the JAX package's:
the same task registry, scripted demos bit-equal frame by frame, the same
rewards and terminals under a scripted step sequence, and the sim's language
encoder within an f32 tolerance on the JAX encoder's weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxactb_tpu.sim import environment as jax_env
from voxactb_tpu.sim.tasks import TASK_REGISTRY as JAX_REGISTRY
from voxactb_tpu_torch.sim import environment as port_env
from voxactb_tpu_torch.sim.tasks import TASK_REGISTRY

PROTOCOL_TASKS = ["open_jar", "open_drawer", "put_item_in_drawer", "hand_over_item"]
CAMERAS = ["front", "wrist", "wrist2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _stub_language(text):
    """A fixed embedding per description: the demos and steps under test do
    not depend on the encoder, which has its own test below."""
    seed = sum(map(ord, text))
    r = np.random.default_rng(seed)
    return (r.normal(size=(1024,)).astype(np.float32),
            r.normal(size=(77, 512)).astype(np.float32))


def _envs(task, seed=43, image_size=32):
    kw = dict(cameras=CAMERAS, image_size=image_size, episode_length=25, seed=seed,
              lang_encoder=_stub_language)
    return (jax_env.BimanualTaskEnvironment(JAX_REGISTRY[task], **kw),
            port_env.BimanualTaskEnvironment(TASK_REGISTRY[task], **kw))


def _assert_same(a, b, where):
    """Bit-equal: same type, dtype, shape and bytes for arrays."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        assert np.array_equal(a, b, equal_nan=True), where
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def test_registry_names_equal_the_jax_package():
    assert list(TASK_REGISTRY) == list(JAX_REGISTRY)
    assert [c.__name__ for c in TASK_REGISTRY.values()] == \
        [c.__name__ for c in JAX_REGISTRY.values()]


def test_arm_pose_rounds_through_f32_like_the_jax_sim():
    from voxactb_tpu.ops import geometry as JG
    from voxactb_tpu_torch.sim.backend import normalize_quaternion_f32

    r = np.random.default_rng(0)
    q = r.normal(size=(4096, 4))
    got = normalize_quaternion_f32(q)
    want = np.asarray(JG.normalize_quaternion(np.asarray(q, np.float64)))
    assert got.dtype == np.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # normalizing in float64 drifts from the JAX sim
    f64 = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    assert not np.array_equal(f64, want)


@pytest.mark.parametrize("task", PROTOCOL_TASKS)
def test_demo_frames_bit_equal(task):
    jenv, penv = _envs(task)
    for ep in range(2):
        jframes, jdesc = jenv.get_demo(ep)
        pframes, pdesc = penv.get_demo(ep)
        assert jdesc == pdesc and len(jframes) == len(pframes) > 10
        for i, (jf, pf) in enumerate(zip(jframes, pframes)):
            _assert_same(vars(jf), vars(pf), f"{task} demo {ep} frame {i}")
        assert jenv.dominant_arm() == penv.dominant_arm()


def _scripted_actions(frames, dominant):
    """Alternating assistive/dominant actions toward poses the demo visits."""
    assistive = "left" if dominant == "right" else "right"
    out = []
    for k, i in enumerate(range(4, len(frames), max(1, len(frames) // 8))):
        arm = assistive if k % 2 == 0 else dominant
        f = frames[i]
        out.append((np.concatenate([getattr(f, f"gripper_{arm}_pose"),
                                    [getattr(f, f"gripper_{arm}_open")], [k % 3 == 0]]),
                    arm))
    # one action outside the workspace ends the episode in both
    out.append((np.r_[5.0, 5.0, 5.0, 0, 0, 0, 1, 1.0, 1.0], dominant))
    return out


@pytest.mark.parametrize("task", PROTOCOL_TASKS)
def test_scripted_steps_give_equal_rewards_and_terminals(task):
    jenv, penv = _envs(task, seed=7)
    frames, _ = jenv.get_demo(1)
    actions = _scripted_actions(frames, jenv.dominant_arm())
    _assert_same(jenv.reset_to_demo(1), penv.reset_to_demo(1), f"{task} reset")
    for k, (action, arm) in enumerate(actions):
        outs = []
        for env, mod in ((jenv, jax_env), (penv, port_env)):
            try:
                outs.append(env.step(action, arm))
            except mod.InvalidActionError as e:
                outs.append(("invalid", str(e)))
        jt, pt = outs
        if isinstance(jt, tuple):
            assert pt == jt, (task, k)
            break
        assert (jt.reward, jt.terminal, jt.info) == (pt.reward, pt.terminal, pt.info), \
            (task, k)
        _assert_same(jt.observation, pt.observation, f"{task} step {k}")
        if jt.terminal:
            break
    else:
        pytest.fail("the scripted sequence should end the episode")


def test_language_encoder_matches_jax_weights():
    """The port's sim encoder (2 layers, RN50 widths) given the JAX encoder's
    weights, against the JAX tower on the same descriptions, at f32."""
    from voxactb_tpu.models.clip_text import ClipTextEncoder as JaxTextEncoder
    from voxactb_tpu.utils.bpe import SimpleTokenizer as JaxTokenizer

    model = JaxTextEncoder(layers=2)
    params = model.init(jax.random.key(0), jnp.zeros((1, 77), jnp.int32))
    encode = port_env._make_text_encoder(jax.tree_util.tree_map(np.asarray, params), {})
    tok = JaxTokenizer()
    for text in ("grasp the jar with left hand and unscrew the lid with right hand",
                 "hand over the item"):
        ref_sent, ref_tok = (np.asarray(a)[0] for a in model.apply(params, tok.tokenize(text)))
        sent, toks = encode(text)
        assert sent.shape == (1024,) and toks.shape == (77, 512)
        assert sent.dtype == toks.dtype == np.float32
        # f32 sums in another order through two layers
        np.testing.assert_allclose(sent, ref_sent, atol=1e-5 * np.abs(ref_sent).max(), rtol=0)
        np.testing.assert_allclose(toks, ref_tok, atol=1e-5 * np.abs(ref_tok).max(), rtol=0)
        assert encode(text)[0] is sent  # cached per description


def test_default_language_encoder_is_seeded_and_shared():
    enc = port_env.default_sim_language_encoder()
    a = enc("open the jar")
    b = port_env.default_sim_language_encoder()("open the jar")
    assert a[0] is b[0]
    assert np.abs(a[0]).max() > 0
    assert not np.array_equal(a[0], enc("open the drawer")[0])


def test_sim_environment_vends_registered_tasks():
    sim = port_env.SimEnvironment(cameras=["wrist"], image_size=16,
                                  lang_encoder=_stub_language)
    env = sim.get_task("open_jar")
    assert env.task_name == JAX_REGISTRY["open_jar"].__name__
    obs = env.reset()
    assert obs["wrist_rgb"].shape == (1, 16, 16, 3)
    assert dataclasses.is_dataclass(port_env.SimObservation)
