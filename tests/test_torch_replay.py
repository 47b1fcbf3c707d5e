"""The port's replay path (voxactb_tpu_torch/utils/keypoints.py, data/,
replay/) against the JAX package's on the same sim demos: equal keyframes,
equal replay contents after ``fill_multi_task_replay``, equal seeded batches;
and ``PrefetchIterator`` on the CPU."""

import importlib
import threading
import time

import numpy as np
import pytest
import torch

from voxactb_tpu.data.rlbench_format import LoadedDemo as JaxLoadedDemo
from voxactb_tpu.replay import TaskUniformReplayBuffer as JaxBuffer
from voxactb_tpu.replay import bc_replay_signature as jax_signature
from voxactb_tpu.sim.environment import BimanualTaskEnvironment
from voxactb_tpu.sim.tasks import TASK_REGISTRY
from voxactb_tpu.utils import keypoints as jax_keypoints
from voxactb_tpu_torch.data.rlbench_format import LoadedDemo
from voxactb_tpu_torch.replay import TaskUniformReplayBuffer, bc_replay_signature
from voxactb_tpu_torch.utils import keypoints

# the modules, not the functions that the ``data`` packages export
jax_fill = importlib.import_module("voxactb_tpu.data.fill_replay")
port_fill = importlib.import_module("voxactb_tpu_torch.data.fill_replay")

CAMERAS = ["wrist", "wrist2"]
IMG = 16
BOUNDS = [-0.8, -1.0, 0.1, 1.2, 1.0, 2.1]


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
def demos():
    """Two demos of two protocol tasks from the JAX sim (the port's are
    bit-equal to them, tests/test_torch_sim.py)."""
    out = {}
    for task in ("open_jar", "hand_over_item"):
        env = BimanualTaskEnvironment(TASK_REGISTRY[task], cameras=CAMERAS, image_size=IMG,
                                      episode_length=25, seed=3, lang_encoder=_language)
        out[task] = [(*env.get_demo(i), i, env.dominant_arm()) for i in range(2)]
    return out


def _fill(fill_mod, buffer_cls, signature_fn, demo_cls, demos, which_arm, **kw):
    m = dict(crop=which_arm in ("dominant", "assistive"),
             arm_pred=which_arm in ("dominant", "assistive", "multiarm"))
    low_dim = {"dominant": 7, "assistive": 7, "both": 8}.get(which_arm, 4)
    replay = buffer_cls(capacity=256, signature=signature_fn(
        CAMERAS, (IMG, IMG), low_dim_size=low_dim, crop_target_obj_voxel=m["crop"],
        arm_pred_loss=m["arm_pred"], two_arm=which_arm == "both"), seed=5)
    task_demos = {t: [demo_cls(f, d, i, f"sim:{t}:{i}", dominant_arm=arm)
                      for f, d, i, arm in ds] for t, ds in demos.items()}
    counts = fill_mod.fill_multi_task_replay(
        replay, task_demos, max_workers=1, cameras=CAMERAS, scene_bounds=BOUNDS,
        voxel_size=20, rotation_resolution=5, which_arm=which_arm,
        lang_encoder=_language, dominant_assistive_arm_fn=lambda d: d.dominant_arm,
        demo_augmentation=True, demo_augmentation_every_n=5,
        crop_target_obj_voxel=m["crop"], crop_radius=0.3, arm_pred_loss=m["arm_pred"],
        episode_length=25, **kw)
    return replay, counts


ARM_MODES = ["dominant", "assistive", "right", "both", "multiarm"]


@pytest.mark.parametrize("which_arm", ARM_MODES)
def test_keypoints_equal(demos, which_arm):
    for frames, _, _, arm in demos["open_jar"] + demos["hand_over_item"]:
        da = "" if which_arm in ("right", "both", "multiarm") else arm
        for cfg in (dict(), dict(no_duplicate=True), dict(saved_every_last_inserted=3)):
            got = keypoints.keypoint_discovery(
                frames, which_arm=which_arm, dominant_assistive_arm=da,
                cfg=keypoints.KeypointConfig(**cfg))
            want = jax_keypoints.keypoint_discovery(
                frames, which_arm=which_arm, dominant_assistive_arm=da,
                cfg=jax_keypoints.KeypointConfig(**cfg))
            assert got == want and len(got[0] if isinstance(got, tuple) else got) > 1


@pytest.mark.parametrize("which_arm", ["dominant", "assistive", "both"])
def test_fill_multi_task_replay_equal_contents(demos, which_arm):
    replay, counts = _fill(port_fill, TaskUniformReplayBuffer, bc_replay_signature,
                           LoadedDemo, demos, which_arm)
    ref, ref_counts = _fill(jax_fill, JaxBuffer, jax_signature, JaxLoadedDemo, demos,
                            which_arm)
    assert counts == ref_counts and replay.size == ref.size > 10
    assert sorted(replay._store) == sorted(ref._store)
    for k, v in ref._store.items():
        got = replay._store[k]
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got[: ref.size], v[: ref.size], err_msg=k)
    assert replay._task_indices == ref._task_indices
    if which_arm == "dominant":
        assert np.abs(replay._store["lang_goal_emb"][: replay.size]).max() > 0
        assert np.abs(replay._store["target_object_scene_bounds"][: replay.size]).max() > 0


@pytest.mark.parametrize("which_arm", ["dominant", "right"])
def test_seeded_batches_equal(demos, which_arm):
    replay, _ = _fill(port_fill, TaskUniformReplayBuffer, bc_replay_signature, LoadedDemo,
                      demos, which_arm)
    ref, _ = _fill(jax_fill, JaxBuffer, jax_signature, JaxLoadedDemo, demos, which_arm)
    for _ in range(3):
        got, want = replay.sample_transition_batch(8), ref.sample_transition_batch(8)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_discretize_keyframe_equal(demos):
    frames = demos["open_jar"][0][0]
    for i in range(1, len(frames), 3):
        for arm in ("right", "left"):
            got = port_fill.discretize_keyframe(frames[i], frames[i - 1], BOUNDS, 50, 5, arm)
            want = jax_fill.discretize_keyframe(frames[i], frames[i - 1], BOUNDS, 50, 5, arm)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


# -- PrefetchIterator on the CPU ---------------------------------------------------


def _counting_sampler(n_fail=None):
    state = {"i": 0}

    def sample():
        i = state["i"]
        state["i"] += 1
        if n_fail is not None and i == n_fail:
            raise ValueError("sampler broke")
        return {"x": np.full((2, 3), i, np.float32), "idx": np.array([i, i], np.int32),
                "flag": np.array([True, False])}

    return sample


def test_prefetch_iterator_cpu_device_and_order():
    from voxactb_tpu_torch.replay.dataset import PrefetchIterator

    it = PrefetchIterator(_counting_sampler(), device="cpu")
    try:
        for i in range(5):
            batch = next(it)
            assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                       for v in batch.values())
            assert batch["x"].dtype == torch.float32 and batch["idx"].dtype == torch.int32
            assert batch["flag"].dtype == torch.bool
            assert float(batch["x"][0, 0]) == i and batch["idx"].tolist() == [i, i]
    finally:
        it.close()


def test_prefetch_iterator_forwards_worker_errors():
    from voxactb_tpu_torch.replay.dataset import PrefetchIterator

    it = PrefetchIterator(_counting_sampler(n_fail=0), device="cpu")
    try:
        with pytest.raises(RuntimeError, match="prefetch worker failed") as e:
            next(it)
        assert isinstance(e.value.__cause__, ValueError)
    finally:
        it.close()


def test_prefetch_iterator_close_stops_a_blocked_worker():
    from voxactb_tpu_torch.replay.dataset import PrefetchIterator

    it = PrefetchIterator(_counting_sampler(), device="cpu")
    next(it)
    time.sleep(0.1)  # the worker now waits on a full queue
    it.close()
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)
    assert threading.active_count() >= 1


def test_prefetch_iterator_raises_without_cuda(monkeypatch):
    from voxactb_tpu_torch.replay.dataset import PrefetchIterator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PrefetchIterator(_counting_sampler())
