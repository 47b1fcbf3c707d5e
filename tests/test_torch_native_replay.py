"""The port's native disk replay (voxactb_tpu_torch/native, replay/native_buffer.py)
against the JAX package's: the cases of tests/test_native_replay.py on the port;
stores that open in either package with the same rows, byte-equal store files
and equal sampling streams at the same seed; ``cli.train`` with
``replay.use_disk=True`` on the CPU filling the store the JAX setup fills; and
the sampler closed while its consumers wait. Every check here is exact."""

import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

from voxactb_tpu.replay import bc_replay_signature as jax_signature  # noqa: E402
from voxactb_tpu.replay.native_buffer import AsyncBatchSampler as JaxSampler  # noqa: E402
from voxactb_tpu.replay.native_buffer import NativeReplayBuffer as JaxBuffer  # noqa: E402
from voxactb_tpu_torch.replay import bc_replay_signature  # noqa: E402
from voxactb_tpu_torch.replay.native_buffer import (  # noqa: E402
    AsyncBatchSampler,
    NativeReplayBuffer,
)

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def sig(size=8):
    return bc_replay_signature(["wrist"], (size, size), low_dim_size=4)


def trans(rng, i):
    return {
        "low_dim_state": rng.normal(size=(4,)).astype(np.float32),
        "trans_action_indicies": rng.integers(0, 50, (3,)).astype(np.int32),
        "rot_grip_action_indicies": rng.integers(0, 72, (4,)).astype(np.int32),
        "ignore_collisions": np.array([1], np.int32),
        "gripper_pose": rng.normal(size=(7,)).astype(np.float32),
        "lang_goal_emb": rng.normal(size=(1024,)).astype(np.float32),
        "lang_token_embs": rng.normal(size=(77, 512)).astype(np.float32),
        "task_id": i, "demo": True, "terminal": False, "timeout": False,
        "reward": float(i),
        "wrist_rgb": rng.integers(0, 255, (8, 8, 3)).astype(np.uint8),
        "wrist_point_cloud": rng.normal(size=(8, 8, 3)).astype(np.float32),
        "wrist_camera_extrinsics": np.eye(4, dtype=np.float32),
        "wrist_camera_intrinsics": np.eye(3, dtype=np.float32),
    }


def assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- tests/test_native_replay.py's cases, on the port ----------------------------------


def test_native_roundtrip(tmp_path, rng):
    buf = NativeReplayBuffer(32, sig(), str(tmp_path / "replay.bin"))
    ts = [trans(rng, i) for i in range(6)]
    buf.extend(ts)
    assert buf.size == 6

    got = buf.gather(np.arange(6))
    for i in range(6):
        np.testing.assert_array_equal(got["wrist_rgb"][i], ts[i]["wrist_rgb"])
        np.testing.assert_array_equal(got["gripper_pose"][i], ts[i]["gripper_pose"])
        assert got["reward"][i] == float(i)
        assert got["task_id"][i] == i
    assert got["lang_token_embs"].shape == (6, 77, 512)
    buf.close()


def test_native_persistence(tmp_path, rng):
    path = str(tmp_path / "replay.bin")
    buf = NativeReplayBuffer(16, sig(), path)
    ts = [trans(rng, i) for i in range(4)]
    buf.extend(ts)
    buf.flush()
    buf.close()

    # reopen: the file IS the buffer
    buf2 = NativeReplayBuffer(16, sig(), path)
    assert buf2.size == 4
    got = buf2.gather(np.array([2]))
    np.testing.assert_array_equal(got["wrist_rgb"][0], ts[2]["wrist_rgb"])
    buf2.close()


def test_native_ring_overwrite(tmp_path, rng):
    buf = NativeReplayBuffer(4, sig(), str(tmp_path / "replay.bin"))
    for i in range(10):
        buf.add(trans(rng, i))
    assert buf.size == 4 and buf.add_count == 10
    rewards = sorted(buf.gather(np.arange(4))["reward"].tolist())
    assert rewards == [6.0, 7.0, 8.0, 9.0]
    buf.close()


def test_native_threaded_gather_large_batch(tmp_path, rng):
    buf = NativeReplayBuffer(64, sig(), str(tmp_path / "replay.bin"),
                             gather_threads=4)
    ts = [trans(rng, i) for i in range(64)]
    buf.extend(ts)
    idx = rng.integers(0, 64, 256)
    got = buf.gather(idx)
    for j in (0, 100, 255):
        np.testing.assert_array_equal(
            got["wrist_rgb"][j], ts[idx[j]]["wrist_rgb"])
    buf.close()


def test_a_closed_store_raises_instead_of_crashing(tmp_path, rng):
    """The C++ functions take a null handle after ``close``: every entry point
    checks for it and raises."""
    buf = NativeReplayBuffer(8, sig(), str(tmp_path / "replay.bin"))
    buf.add(trans(rng, 0))
    buf.close()
    buf.close()  # closing twice is harmless
    for call in (lambda: buf.size, lambda: buf.add_count, lambda: buf.add(trans(rng, 1)),
                 lambda: buf.gather(np.zeros(1)), buf.flush,
                 lambda: AsyncBatchSampler(buf, batch_size=1)):
        with pytest.raises(RuntimeError, match="is closed"):
            call()


def test_native_stride_mismatch_detected(tmp_path, rng):
    path = str(tmp_path / "replay.bin")
    buf = NativeReplayBuffer(8, sig(), path)
    buf.add(trans(rng, 0))
    buf.close()
    with pytest.raises(IOError, match="row stride"):
        NativeReplayBuffer(8, sig(16), path)


def test_async_batch_sampler(tmp_path, rng):
    """C++ producer threads deliver valid batches concurrently with writes."""
    buf = NativeReplayBuffer(64, sig(), str(tmp_path / "replay.bin"))
    ts = [trans(rng, i) for i in range(16)]
    buf.extend(ts)

    sampler = AsyncBatchSampler(buf, batch_size=8, ring_size=3, num_threads=2,
                                seed=7)
    try:
        rewards = {float(t["reward"]) for t in ts}
        for _ in range(20):
            batch = sampler.next()
            assert batch["wrist_rgb"].shape == (8, 8, 8, 3)
            assert batch["lang_token_embs"].shape == (8, 77, 512)
            # every sampled row must be one of the written transitions
            assert set(np.asarray(batch["reward"]).tolist()) <= rewards
        # writes during sampling are picked up (monotone add counter)
        buf.add(trans(rng, 99))
        seen_new = any(99.0 in np.asarray(sampler.next()["reward"]).tolist()
                       for _ in range(50))
        assert seen_new
    finally:
        sampler.close()
        buf.close()


def test_async_batch_sampler_blocks_until_filled(tmp_path, rng):
    """Producers wait for the store to hold a full batch before publishing."""
    buf = NativeReplayBuffer(32, sig(), str(tmp_path / "replay.bin"))
    sampler = AsyncBatchSampler(buf, batch_size=4, ring_size=2, num_threads=1)
    got = {}

    def consume():
        got["batch"] = sampler.next()

    th = threading.Thread(target=consume, daemon=True)
    th.start()
    time.sleep(0.15)
    assert "batch" not in got  # nothing written yet -> sampler must block
    for i in range(4):
        buf.add(trans(rng, i))
    th.join(timeout=5.0)
    assert "batch" in got and got["batch"]["wrist_rgb"].shape[0] == 4
    sampler.close()
    buf.close()


# -- the two packages' stores ----------------------------------------------------------


def _filled(cls, signature, path, rng_seed, n=12, capacity=8, seed=0):
    buf = cls(capacity, signature, str(path), seed=seed)
    r = np.random.default_rng(rng_seed)
    ts = [trans(r, i) for i in range(n)]
    buf.extend(ts)
    buf.flush()
    return buf, ts


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_store_opens_in_the_other_package(tmp_path, writer):
    """A store written (past its capacity) by one package opens in the
    other with the same add_count, size and rows."""
    classes = {"jax": (JaxBuffer, jax_signature(["wrist"], (8, 8), low_dim_size=4)),
               "port": (NativeReplayBuffer, sig())}
    reader = "port" if writer == "jax" else "jax"
    path = tmp_path / "replay.bin"
    wbuf, _ = _filled(*classes[writer], path, rng_seed=3)
    want = wbuf.gather(np.arange(8))
    count = wbuf.add_count
    wbuf.close()
    rbuf = classes[reader][0](8, classes[reader][1], str(path))
    assert rbuf.add_count == count == 12 and rbuf.size == 8
    assert_batches_equal(rbuf.gather(np.arange(8)), want)
    rbuf.close()


def test_store_files_are_byte_equal(tmp_path):
    jax_buf, _ = _filled(JaxBuffer, jax_signature(["wrist"], (8, 8), low_dim_size=4),
                         tmp_path / "jax.bin", rng_seed=4)
    port_buf, _ = _filled(NativeReplayBuffer, sig(), tmp_path / "port.bin", rng_seed=4)
    assert port_buf.row_bytes == jax_buf.row_bytes
    jax_buf.close()
    port_buf.close()
    assert (tmp_path / "jax.bin").read_bytes() == (tmp_path / "port.bin").read_bytes()


def test_sample_transition_batch_equal_at_the_same_seed(tmp_path):
    jax_buf, _ = _filled(JaxBuffer, jax_signature(["wrist"], (8, 8), low_dim_size=4),
                         tmp_path / "jax.bin", rng_seed=5, seed=11)
    port_buf, _ = _filled(NativeReplayBuffer, sig(), tmp_path / "port.bin", rng_seed=5,
                          seed=11)
    for _ in range(3):
        assert_batches_equal(port_buf.sample_transition_batch(5),
                             jax_buf.sample_transition_batch(5))
    jax_buf.close()
    port_buf.close()


def test_async_sampler_one_thread_gives_the_jax_batches_in_order(tmp_path):
    jax_buf, _ = _filled(JaxBuffer, jax_signature(["wrist"], (8, 8), low_dim_size=4),
                         tmp_path / "jax.bin", rng_seed=6, n=20, capacity=32)
    port_buf, _ = _filled(NativeReplayBuffer, sig(), tmp_path / "port.bin", rng_seed=6,
                          n=20, capacity=32)
    jax_feed = JaxSampler(jax_buf, batch_size=4, ring_size=3, num_threads=1, seed=9)
    port_feed = AsyncBatchSampler(port_buf, batch_size=4, ring_size=3, num_threads=1,
                                  seed=9)
    try:
        for _ in range(8):
            assert_batches_equal(port_feed.next(), jax_feed.next())
    finally:
        jax_feed.close()
        port_feed.close()
        jax_buf.close()
        port_buf.close()


def test_unpacked_batches_feed_torch_without_a_copy_or_warning(tmp_path, rng, recwarn):
    """``_unpack``'s arrays are writable and C-contiguous, so the prefetch
    feed's ``torch.from_numpy`` shares their memory and does not warn."""
    from voxactb_tpu_torch.replay.dataset import _host_tensor

    buf = NativeReplayBuffer(16, sig(), str(tmp_path / "replay.bin"))
    buf.extend([trans(rng, i) for i in range(6)])
    feed = AsyncBatchSampler(buf, batch_size=4, num_threads=1)
    try:
        batch = feed.next()
    finally:
        feed.close()
    for k, v in batch.items():
        assert v.flags.writeable and v.flags.c_contiguous, k
        t = _host_tensor(v, pin=False)
        assert t.data_ptr() == v.ctypes.data, k
    assert not [w for w in recwarn if "not writable" in str(w.message)]
    buf.close()


# -- teardown ----------------------------------------------------------------------------


def test_close_while_a_consumer_waits_for_rows(tmp_path):
    """A consumer waiting on an empty store is released by ``close`` with a
    RuntimeError; a ``next`` after it raises too."""
    buf = NativeReplayBuffer(16, sig(), str(tmp_path / "replay.bin"))
    feed = AsyncBatchSampler(buf, batch_size=4, num_threads=2)
    errors = []

    def consume():
        try:
            feed.next()
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=consume) for _ in range(2)]
    for th in threads:
        th.start()
    time.sleep(0.05)
    feed.close()
    for th in threads:
        th.join(timeout=5.0)
        assert not th.is_alive()
    assert len(errors) == 2 and all("stopped" in e for e in errors)
    with pytest.raises(RuntimeError, match="stopped"):
        feed.next()
    buf.close()


def test_close_while_consumers_take_batches(tmp_path, rng):
    """``close`` while more consumer threads than cores take batches as fast
    as they can, the interpreter switching threads every 10 us: every batch
    they got is whole rows of the store, every consumer ends with
    RuntimeError, and the process survives, twenty times over."""
    buf = NativeReplayBuffer(32, sig(), str(tmp_path / "replay.bin"))
    ts = [trans(rng, i) for i in range(8)]
    buf.extend(ts)
    rewards = {float(t["reward"]) for t in ts}
    n_threads = (os.cpu_count() or 1) + 2
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for round_ in range(20):
            feed = AsyncBatchSampler(buf, batch_size=4, ring_size=2, num_threads=2,
                                     seed=round_)
            got, ended = [], []

            def consume():
                try:
                    while True:
                        got.append(feed.next())
                except RuntimeError:
                    ended.append(True)

            threads = [threading.Thread(target=consume) for _ in range(n_threads)]
            for th in threads:
                th.start()
            time.sleep(0.002 * (round_ % 5))
            feed.close()
            for th in threads:
                th.join(timeout=5.0)
                assert not th.is_alive()
            assert len(ended) == n_threads
            for b in got:
                assert set(b["reward"].tolist()) <= rewards
                assert b["wrist_rgb"].shape == (4, 8, 8, 3)
    finally:
        sys.setswitchinterval(interval)
    buf.close()


def test_prefetch_then_sampler_then_store_teardown(tmp_path, rng):
    """cli.train's teardown order with the prefetch thread running ahead of
    its consumer: the thread is joined first, then the sampler stops, then
    the store closes."""
    from voxactb_tpu_torch.replay.dataset import PrefetchIterator

    buf = NativeReplayBuffer(32, sig(), str(tmp_path / "replay.bin"))
    buf.extend([trans(rng, i) for i in range(8)])
    for _ in range(10):
        feed = AsyncBatchSampler(buf, batch_size=4, num_threads=2)
        it = PrefetchIterator(feed.next, device="cpu")
        assert next(it)["wrist_rgb"].shape == (4, 8, 8, 3)
        time.sleep(0.01)  # the worker fills its queue and waits to put
        it.close()
        feed.close()
    buf.flush()
    buf.close()


def test_the_build_writes_nothing_under_the_jax_package():
    from voxactb_tpu_torch import native

    jax_tree = os.path.join(ROOT, "voxactb_tpu")

    def listing():
        # the JAX package's own build of its library (the JAX tests, maybe in
        # another worker) and bytecode caches aside
        return sorted((os.path.relpath(os.path.join(d, f), jax_tree),
                       os.stat(os.path.join(d, f)).st_mtime_ns)
                      for d, _, fs in os.walk(jax_tree) for f in fs
                      if "__pycache__" not in d and f != "libvoxactb_native.so")

    before = listing()
    path = native.build_native(force=True)
    assert os.path.commonpath([path, str(native.BUILD_DIR)]) == str(native.BUILD_DIR)
    assert os.path.basename(os.path.dirname(path)) == "native"
    assert os.path.exists(path) and listing() == before
    # the source the port builds is its own copy, byte for byte the JAX one
    with open(os.path.join(ROOT, "voxactb_tpu_torch", "native", "replay_store.cpp"),
              "rb") as f, open(os.path.join(jax_tree, "native", "replay_store.cpp"),
                               "rb") as g:
        assert f.read() == g.read()


# -- cli.train on the disk replay ---------------------------------------------------------


def _language(text):
    r = np.random.default_rng(len(text))
    return (r.normal(size=(1, 1024)).astype(np.float32),
            r.normal(size=(1, 77, 512)).astype(np.float32))


STORE_HEADER_BYTES = 64  # replay_store.cpp's Header: eight 8-byte words

TRAIN_OVERRIDES = [
    "rlbench.task_name=open_jar", "rlbench.tasks=['open_jar']", "rlbench.demo_path=sim",
    "rlbench.demos=1", "rlbench.cameras=['wrist']", "rlbench.camera_resolution=[16,16]",
    "rlbench.episode_length=25", "method.voxel_sizes=[10]", "method.num_latents=16",
    "method.latent_dim=32", "method.transformer_depth=1", "method.cross_dim_head=16",
    "method.latent_dim_head=16", "method.final_dim=8", "method.which_arm=dominant",
    "method.crop_target_obj_voxel=True", "method.crop_radius=0.3",
    "method.arm_pred_loss=True", "method.apply_se3=False", "replay.batch_size=2",
    "replay.use_disk=True", "framework.training_iterations=2", "framework.save_freq=1",
    "framework.tensorboard_logging=False",
]


def test_cli_train_fills_the_store_the_jax_setup_fills(tmp_path):
    """``cli.train`` with ``replay.use_disk=True`` on the CPU trains through the
    native store and its C++ feed, and leaves a store byte-equal to the one the
    JAX ``cli.train`` fills (its ``build_replay_and_agent``: the store is written
    there only) from the same sim demos and language stub."""
    from voxactb_tpu.cli import train as jax_train
    from voxactb_tpu.config import Config as JaxConfig
    from voxactb_tpu_torch.cli import train

    seed_dir = train.main(TRAIN_OVERRIDES + [f"log_dir={tmp_path / 'port'}",
                                             f"replay.path={tmp_path / 'port_replay'}"],
                          lang_encoder=_language, device="cpu")
    assert os.path.exists(os.path.join(seed_dir, "weights", "1",
                                       "QAttentionAgent_layer0.pt"))
    cfg = JaxConfig().override(**jax_train.parse_overrides(
        TRAIN_OVERRIDES + [f"log_dir={tmp_path / 'jax'}",
                           f"replay.path={tmp_path / 'jax_replay'}"]))
    replay, _ = jax_train.build_replay_and_agent(cfg, _language)
    rows, row_bytes = replay.size, replay.row_bytes
    assert rows > 0
    replay.flush()
    replay.close()
    # the stores are sparse files of cli.train's 1e5 rows: compare their
    # sizes, then the header and the rows written, not gigabytes of zeros
    files = [tmp_path / d / "seed0.replay" for d in ("port_replay", "jax_replay")]
    assert files[0].stat().st_size == files[1].stat().st_size
    used = STORE_HEADER_BYTES + rows * row_bytes
    heads = []
    for path in files:
        with path.open("rb") as f:
            heads.append(f.read(used))
    assert len(heads[0]) == used and heads[0] == heads[1]
