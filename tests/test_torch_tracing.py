"""The port's spans and counters (voxactb_tpu_torch/utils/profiling.py) and
where the program opens them: off, a span is one shared no-op that enters no
``record_function``; on, spans nest with their self time, each profiler
session or ``collect()`` block has a collection of its own, and a worker's
spans stay off the profiler's timeline. The act, the update and the replay
feed record their phases on the CPU at tiny widths, and the train runner
logs its step time from the wall clock between its syncs."""

import csv
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from voxactb_tpu_torch.agents.base import Agent
from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
from voxactb_tpu_torch.config import MethodConfig
from voxactb_tpu_torch.replay.dataset import PrefetchIterator
from voxactb_tpu_torch.runners.train_runner import OfflineTrainRunner
from voxactb_tpu_torch.utils import profiling
from voxactb_tpu_torch.utils.profiling import collect, count, device_trace, span


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
ACT_PHASES = {"vx.act.prep", "vx.act.sync_model", "vx.act.infer", "vx.act.d2h",
              "vx.act.post"}
INFER_PHASES = {"vx.act.h2d", "vx.act.front", "vx.act.decode", "vx.qnet.encode",
                "vx.qnet.trunk", "vx.qnet.decoder", "vx.qnet.heads"}
UPDATE_PHASES = {"vx.update.h2d", "vx.update.aug", "vx.update.forward",
                 "vx.update.backward", "vx.update.optim"}


def tiny_cfg(**kw):
    base = dict(voxel_sizes=[10], num_latents=16, latent_dim=32, transformer_depth=1,
                cross_dim_head=16, latent_dim_head=16, final_dim=8, lr=1e-3,
                which_arm="dominant", arm_pred_loss=True, apply_se3=True)
    base.update(kw)
    return MethodConfig(**base)


def synthetic_obs(rng):
    obs = {"lang_goal_emb": rng.normal(size=(1024,)).astype(np.float32),
           "lang_token_embs": rng.normal(size=(77, 512)).astype(np.float32),
           "low_dim_state_left_arm": rng.normal(size=(1, 4)).astype(np.float32),
           "low_dim_state_right_arm": rng.normal(size=(1, 5)).astype(np.float32)}
    for c in CAMERAS:
        obs[f"{c}_rgb"] = rng.integers(0, 255, (1, IMG, IMG, 3)).astype(np.float32)
        obs[f"{c}_point_cloud"] = rng.uniform(-0.5, 1.5, (1, IMG, IMG, 3)).astype(np.float32)
    return obs


def synthetic_batch(rng, cfg, b=2):
    batch = {
        "trans_action_indicies": rng.integers(0, 10, (b, 3)).astype(np.int32),
        "rot_grip_action_indicies": np.concatenate(
            [rng.integers(0, 72, (b, 3)), rng.integers(0, 2, (b, 1))], -1).astype(np.int32),
        "ignore_collisions": rng.integers(0, 2, (b, 1)).astype(np.int32),
        "gripper_pose": np.concatenate(
            [rng.uniform([-0.3, -0.5, 0.5], [0.7, 0.5, 1.5], (b, 3)),
             np.tile([0.0, 0.0, 0.0, 1.0], (b, 1))], -1).astype(np.float32),
        "lang_goal_emb": rng.normal(size=(b, 1024)).astype(np.float32),
        "lang_token_embs": rng.normal(size=(b, 77, 512)).astype(np.float32),
        "low_dim_state": rng.normal(size=(b, cfg.low_dim_size())).astype(np.float32),
        "label": rng.integers(0, 2, (b, 1)).astype(np.int32),
    }
    for c in CAMERAS:
        batch[f"{c}_rgb"] = rng.integers(0, 255, (b, IMG, IMG, 3)).astype(np.float32)
        batch[f"{c}_point_cloud"] = rng.uniform(-0.5, 1.5, (b, IMG, IMG, 3)).astype(np.float32)
    return batch


def _agent(training):
    agent = QAttentionBCAgent(tiny_cfg(), CAMERAS, BOUNDS, batch_size=2,
                              training_iterations=100, device="cpu")
    agent.build(training=training)
    return agent


def _act(agent, step, obs):
    return agent.act(step, obs, which_arm="dominant", dominant_assitive_policy=True)


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


# -- the module ------------------------------------------------------------------------


def test_off_path_records_nothing_and_enters_no_record_function(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("record_function entered while tracing is off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    before = profiling.last_collection()
    assert span("vx.a") is span("vx.b", 3)  # one shared no-op, nothing allocated
    with span("vx.a", 7) as s:
        count("n", 5)
    assert s is None
    assert profiling.last_collection() is before
    with collect() as coll:
        with span("vx.a"):
            pass
    assert coll.calls("vx.a") == 1  # on without a profiler: collected, no record_function


def test_nested_spans_give_self_time():
    with collect() as coll:
        with span("outer"):
            time.sleep(0.02)
            with span("inner"):
                time.sleep(0.03)
        with span("after"):
            pass
    d = coll.as_dict()["spans"]
    outer, inner, after = d["outer"], d["inner"], d["after"]
    assert outer["calls"] == inner["calls"] == after["calls"] == 1
    assert (outer["parent"], inner["parent"], after["parent"]) == (None, "outer", None)
    assert inner["total_s"] >= 0.03 and outer["self_s"] >= 0.02
    # the outer span's own time is its total less what its child covers
    assert outer["total_s"] - outer["self_s"] == pytest.approx(inner["total_s"], rel=1e-9)
    assert inner["self_s"] == inner["total_s"]


def test_two_profiler_sessions_give_two_collections():
    got = []
    for n in (1, 2):
        with _profile() as prof:
            for _ in range(n):
                with span("vx.s", n):
                    torch.ones(4) + 1
                count("c", 2)
        got.append(profiling.last_collection())
        assert sum(e.name == "vx.s" for e in prof.events()) == n
        with span("vx.between"):  # the program runs on with the profiler idle
            pass
    first, second = got
    assert first is not second
    assert (first.calls("vx.s"), first.counts["c"]) == (1, 2)
    assert (second.calls("vx.s"), second.counts["c"]) == (2, 4)
    assert "vx.between" not in first.spans and "vx.between" not in second.spans


def test_collect_works_without_a_profiler_and_nests():
    with collect() as outer:
        count("n")
        with collect() as inner:
            with span("vx.in"):
                count("n", 3)
        assert profiling.last_collection() is inner
        with span("vx.out"):
            pass
    with span("vx.after"):
        count("n")
    assert outer.counts == {"n": 1} and set(outer.spans) == {"vx.out"}
    assert inner.counts == {"n": 3} and set(inner.spans) == {"vx.in"}
    assert profiling.last_collection() is inner


def test_worker_thread_span_is_collected_off_the_profilers_timeline():
    def work():
        with span("vx.worker", timeline=False):
            time.sleep(0.01)

    with _profile() as prof:
        with span("vx.main"):
            t = threading.Thread(target=work, name="feed-worker")
            t.start()
            t.join(timeout=10)
    assert not t.is_alive()
    coll = profiling.last_collection()
    worker = coll.as_dict()["spans"]["vx.worker"]
    assert worker["calls"] == 1 and worker["thread"] == "feed-worker"
    assert worker["parent"] is None  # the main thread's span is not its parent
    names = {e.name for e in prof.events()}
    assert "vx.main" in names and "vx.worker" not in names


def test_spans_and_counts_from_many_threads_all_land():
    threads, per = 2 * (os.cpu_count() or 4), 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with collect() as coll:
            def work():
                for _ in range(per):
                    with span("vx.t", timeline=False):
                        count("n")

            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert coll.calls("vx.t") == threads * per and coll.counts["n"] == threads * per


def test_device_trace_writes_the_collection(tmp_path):
    for _ in range(2):
        with device_trace(str(tmp_path), device="cpu"):
            with span("vx.block", 1):
                torch.ones(8, 8) @ torch.ones(8, 8)
                count("n", 2)
    pid = os.getpid()
    assert {f for f in os.listdir(tmp_path) if f.startswith("spans_")} == {
        f"spans_{pid}_0.json", f"spans_{pid}_1.json"}
    spans = json.loads((tmp_path / f"spans_{pid}_1.json").read_text())
    assert spans["counts"] == {"n": 2}
    assert spans["spans"]["vx.block"]["calls"] == 1
    events = json.loads((tmp_path / f"trace_{pid}_1.json").read_text())["traceEvents"]
    assert any(e.get("name") == "vx.block" for e in events)


# -- the program -----------------------------------------------------------------------


def test_act_records_every_phase_and_six_copies():
    rng = np.random.default_rng(0)
    agent = _agent(training=False)
    obs = synthetic_obs(rng)
    _act(agent, 0, obs)  # the first act loads the module's weights
    acts = 3
    with collect() as coll:
        for i in range(acts):
            _act(agent, i + 1, obs)
    d = coll.as_dict()
    spans = d["spans"]
    assert spans["vx.act"]["calls"] == acts and spans["vx.act"]["parent"] is None
    assert ACT_PHASES | INFER_PHASES <= set(spans)
    assert all(spans[k]["parent"] == "vx.act" for k in ACT_PHASES)
    assert all(spans[k]["parent"] == "vx.act.infer" for k in INFER_PHASES)
    assert d["counts"]["act.d2h_copies"] == 6 * acts
    covered = sum(spans[k]["total_s"] for k in ACT_PHASES)
    assert covered >= 0.95 * spans["vx.act"]["total_s"]
    assert covered == pytest.approx(spans["vx.act"]["total_s"] - spans["vx.act"]["self_s"])


def test_act_spans_sit_on_the_profilers_timeline():
    rng = np.random.default_rng(1)
    agent = _agent(training=False)
    obs = synthetic_obs(rng)
    _act(agent, 0, obs)
    with _profile() as prof:
        res = _act(agent, 1, obs)
    names = {e.name for e in prof.events()}
    assert {"vx.act"} | ACT_PHASES | INFER_PHASES <= names
    coll = profiling.last_collection()
    assert coll.calls("vx.act") == 1 and coll.counts["act.d2h_copies"] == 6
    assert res.info["front_overflow"] == 0


def test_update_records_its_five_phases():
    rng = np.random.default_rng(2)
    cfg = tiny_cfg()
    agent = _agent(training=True)
    agent.update(0, synthetic_batch(rng, cfg))
    with collect() as coll:
        for step in (1, 2):
            agent.update(step, synthetic_batch(rng, cfg))
    spans = coll.as_dict()["spans"]
    assert spans["vx.update"]["calls"] == 2
    assert all(spans[k]["calls"] == 2 and spans[k]["parent"] == "vx.update"
               for k in UPDATE_PHASES)
    assert spans["vx.qnet.trunk"]["parent"] == "vx.update.forward"
    covered = sum(spans[k]["total_s"] for k in UPDATE_PHASES)
    assert covered <= spans["vx.update"]["total_s"]


def test_prefetch_iterator_counts_stalls():
    def slow():
        time.sleep(0.2)
        return {"x": np.zeros(3, np.float32)}

    with collect() as coll:
        feed = PrefetchIterator(slow, device="cpu")
        try:
            for _ in range(3):  # each call finds the queue empty
                next(feed)
        finally:
            feed.close()
    spans = coll.as_dict()["spans"]
    assert coll.counts["feed.batches"] == 3 and coll.counts["feed.stalls"] == 3
    assert spans["vx.feed.next"]["calls"] == 3
    assert spans["vx.feed.sample"]["calls"] >= 3
    assert spans["vx.feed.sample"]["thread"] != threading.current_thread().name
    assert spans["vx.feed.sample"]["total_s"] >= 3 * 0.2

    feed = PrefetchIterator(lambda: {"x": np.zeros(3, np.float32)}, device="cpu")
    try:
        deadline = time.monotonic() + 10
        while not feed._queue.full() and time.monotonic() < deadline:
            time.sleep(0.01)
        with collect() as coll:
            next(feed)
    finally:
        feed.close()
    assert coll.counts == {"feed.batches": 1}  # a batch was ready: no stall


class _TimedLoss:
    """A loss whose ``float()`` (the runner's sync at a log point) notes the
    time."""

    def __init__(self, marks, step):
        self.marks, self.step = marks, step

    def __float__(self):
        self.marks[self.step] = time.perf_counter()
        return 0.5


class _SleepingAgent(Agent):
    def __init__(self, marks):
        self.marks = marks

    def build(self, training=False, device=None):
        pass

    def update(self, step, batch):
        with span("vx.update", step):
            time.sleep(0.01)
        return {"total_loss": _TimedLoss(self.marks, step)}

    def act(self, step, observation, **kw):
        raise NotImplementedError

    def update_summaries(self):
        return []

    def load_weights(self, savedir):
        pass

    def save_weights(self, savedir):
        pass


def test_train_runner_logs_wall_time_between_syncs(tmp_path):
    marks = {}
    runner = OfflineTrainRunner(
        _SleepingAgent(marks), iter(lambda: {}, None), str(tmp_path / "logs"), None,
        training_iterations=7, save_freq=0, log_freq=3, tensorboard_logging=False)
    runner.start()
    with open(tmp_path / "logs" / "train_data.csv") as f:
        rows = {int(r["step"]): r for r in csv.DictReader(f)}
    assert sorted(rows) == [0, 3, 6]
    assert rows[0]["train/time/step_s"] == ""  # no interval before the first sync
    for step in (3, 6):
        wall = (marks[step] - marks[step - 3]) / 3
        logged = float(rows[step]["train/time/step_s"])
        assert logged == pytest.approx(wall, abs=2e-3)
        assert logged >= 0.01
        update_ms = float(rows[step]["train/time/update_ms"])
        assert 10.0 <= update_ms <= 1e3 * logged
        assert float(rows[step]["train/feed/stalls"]) == 0.0
