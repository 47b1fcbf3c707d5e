"""The port's runners (voxactb_tpu_torch/runners/): the counterparts of
tests/test_runners.py's cases with the same fake agents and the port's agent
on the CPU; a scripted agent that replays keyframe actions through both
packages' ``EvalRunner`` on the four protocol tasks, with equal CSV rows; and
the JAX tool's oracle, handed the port's sim, succeeding on those tasks."""

import csv
import importlib.util
import os
import time

import numpy as np
import pytest
import torch

from voxactb_tpu_torch.agents.base import ActResult, Agent
from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
from voxactb_tpu_torch.config import MethodConfig
from voxactb_tpu_torch.envs.fake_env import FakeBimanualEnv
from voxactb_tpu_torch.replay import UniformReplayBuffer, bc_replay_signature
from voxactb_tpu_torch.replay.dataset import PrefetchIterator
from voxactb_tpu_torch.runners.eval_runner import EvalRunner, select_checkpoints
from voxactb_tpu_torch.runners.rollout import RolloutGenerator
from voxactb_tpu_torch.runners.train_runner import OfflineTrainRunner

CAMERAS = ["wrist", "wrist2"]
BOUNDS = [-0.8, -1.0, 0.1, 1.2, 1.0, 2.1]
IMG = 16
PROTOCOL_TASKS = ["open_jar", "open_drawer", "put_item_in_drawer", "hand_over_item"]
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread: at these sizes its intra-op pool only contends
    with itself and with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tiny_cfg(**kw):
    base = dict(
        voxel_sizes=[10], num_latents=16, latent_dim=32, transformer_depth=1,
        cross_dim_head=16, latent_dim_head=16, final_dim=8, lr=1e-3,
        which_arm="dominant", arm_pred_loss=True, apply_se3=False,
    )
    base.update(kw)
    return MethodConfig(**base)


def agent_of(cfg, **kw):
    return QAttentionBCAgent(cfg, CAMERAS, BOUNDS, device="cpu", **kw)


def fill_buffer(rng, cfg, n=6):
    buf = UniformReplayBuffer(
        32, bc_replay_signature(CAMERAS, (IMG, IMG), cfg.low_dim_size(),
                                arm_pred_loss=True))
    for i in range(n):
        t = {
            "low_dim_state": rng.normal(size=(cfg.low_dim_size(),)),
            "trans_action_indicies": rng.integers(0, 10, (3,)),
            "rot_grip_action_indicies": np.r_[rng.integers(0, 72, 3),
                                              rng.integers(0, 2)],
            "ignore_collisions": [1],
            "gripper_pose": np.r_[rng.uniform(-0.3, 0.7, 3), 0, 0, 0, 1],
            "lang_goal_emb": rng.normal(size=(1024,)),
            "lang_token_embs": rng.normal(size=(77, 512)),
            "task_id": 0, "label": [i % 2],
        }
        for c in CAMERAS:
            t[f"{c}_rgb"] = rng.integers(0, 255, (IMG, IMG, 3))
            t[f"{c}_point_cloud"] = rng.uniform(-0.5, 1.5, (IMG, IMG, 3))
        buf.add(t)
    return buf


def make_dataset(buf, batch=2):
    def sample():
        b = buf.sample_transition_batch(batch)
        b["scene_bounds"] = np.asarray(BOUNDS, np.float32)
        return b
    return PrefetchIterator(sample, device="cpu")


def test_train_runner_saves_rotates_and_resumes(tmp_path, rng):
    cfg = tiny_cfg()
    buf = fill_buffer(rng, cfg)
    agent = agent_of(cfg, batch_size=2, training_iterations=6)
    ds = make_dataset(buf)
    runner = OfflineTrainRunner(
        agent, ds, str(tmp_path / "logs"), str(tmp_path / "weights"),
        training_iterations=6, save_freq=2, log_freq=2, num_weights_to_keep=2,
        tensorboard_logging=False,
    )
    runner.start()
    ds.close()
    saved = sorted(os.listdir(tmp_path / "weights"), key=int)
    # rotation keeps 2 plus the final save
    assert len(saved) <= 3 and "5" in saved
    assert os.listdir(tmp_path / "weights" / "5") == ["QAttentionAgent_layer0.pt"]

    # resume: a fresh runner should pick up from the last save and do nothing more
    agent2 = agent_of(cfg, batch_size=2, training_iterations=6)
    ds2 = make_dataset(buf)
    runner2 = OfflineTrainRunner(
        agent2, ds2, str(tmp_path / "logs"), str(tmp_path / "weights"),
        training_iterations=6, save_freq=2, log_freq=2, tensorboard_logging=False,
    )
    agent2.build(training=True)
    assert runner2.resume_step() == 6
    ds2.close()
    assert os.path.exists(tmp_path / "logs" / "train_data.csv")
    with open(tmp_path / "logs" / "train_data.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [0, 2, 4]
    assert all(np.isfinite(float(r["QAttentionAgent_layer0/losses/total_loss"]))
               for r in rows)


def test_rollout_dominant_assistive_alternation(rng):
    cfg = tiny_cfg()
    env = FakeBimanualEnv(image_size=IMG, episode_length=6, seed=3)
    env.launch()
    acting = agent_of(cfg)
    stabilizing = agent_of(cfg)
    acting.build(training=False)
    stabilizing.build(training=False)

    gen = RolloutGenerator()
    transitions = list(gen.generator(
        env, acting, episode_length=4, left_arm_agent=stabilizing,
        which_arm="dominant_assistive", crop_target_obj_voxel=True,
        crop_radius=0.3,
    ))
    assert len(transitions) >= 1
    dom = env.dominant_arm()
    assistive = "left" if dom == "right" else "right"
    arms = [arm for _, arm, _ in env.step_log]
    # assistive acts on even steps, dominant on odd (rollout_generator.py:233-239)
    expected = [assistive if i % 2 == 0 else dom for i in range(len(arms))]
    assert arms == expected
    # actions stay inside the cropped scene bounds
    crop = np.asarray(env.target_object_world_coords())
    for _, _, action in env.step_log:
        assert np.all(np.abs(action[:3] - np.round(crop, 2)) <= 0.3 + 1e-6)
    # last transition is terminal (success or timeout)
    assert transitions[-1].terminal


def test_rollout_hands_act_the_crop_bounds_of_the_jax_rollout():
    """The bounds each act receives are the f32 values the JAX rollout passes
    (its ``scene_bounds_from_crop`` returns an f32 array)."""
    from voxactb_tpu.ops.geometry import scene_bounds_from_crop as jax_bounds

    seen = []

    class Spy:
        def act(self, step, obs, **kw):
            seen.append(kw["new_scene_bounds"])
            return ActResult(np.r_[0.3, 0.0, 1.0, 0, 0, 0, 1, 1.0, 1.0])

    env = FakeBimanualEnv(image_size=8, episode_length=3, seed=11)
    env.launch()
    list(RolloutGenerator().generator(env, Spy(), 3, left_arm_agent=Spy(),
                                      crop_radius=0.3))
    want = np.asarray(jax_bounds(env.target_object_world_coords(), 0.3)).tolist()
    assert seen and all(b == want for b in seen)
    assert all(isinstance(x, float) for x in seen[0])


def test_rollout_single_arm_branch(rng):
    cfg = tiny_cfg(which_arm="right", arm_pred_loss=False)
    env = FakeBimanualEnv(image_size=IMG, episode_length=3, seed=1)
    env.launch()
    agent = agent_of(cfg)
    agent.build(training=False)
    gen = RolloutGenerator()
    transitions = list(gen.generator(
        env, agent, episode_length=3, which_arm="right",
        crop_target_obj_voxel=False,
    ))
    assert transitions and transitions[-1].terminal
    assert all(arm == "right" for _, arm, _ in env.step_log)


def test_eval_runner_sweep_and_skip(tmp_path, rng):
    cfg = tiny_cfg()
    # save two fake checkpoints
    agent = agent_of(cfg)
    agent.build(training=False)
    env = FakeBimanualEnv(image_size=IMG, episode_length=3, seed=2)
    env.launch()
    # initialize params via one act
    obs = env.reset()
    agent.act(0, obs, which_arm="dominant", dominant_assitive_policy=True)
    for step in (0, 2):
        d = tmp_path / "weights" / str(step)
        agent.save_weights(str(d))

    stabilizing = agent_of(cfg)
    runner = EvalRunner(
        env, agent, str(tmp_path / "weights"), str(tmp_path / "logs"),
        left_arm_agent=stabilizing, eval_episodes=2, episode_length=3,
    )
    results = runner.start("missing")
    assert [r["step"] for r in results] == [0, 2]
    assert all("eval_envs/return" in r for r in results)

    # second run: everything already scored
    results2 = runner.start("missing")
    assert results2 == []

    # best/last selection
    assert select_checkpoints(str(tmp_path / "weights"), "last",
                              str(tmp_path / "logs" / "eval_data.csv")) == [2]
    best = select_checkpoints(str(tmp_path / "weights"), "best",
                              str(tmp_path / "logs" / "eval_data.csv"))
    assert best and best[0] in (0, 2)


def test_rollout_both_arms_branch(rng):
    """crop + which_arm='both': two policies, fixed left/right alternation
    (rollout_generator.py:131-207)."""
    cfg = tiny_cfg(which_arm="right", arm_pred_loss=False)
    env = FakeBimanualEnv(image_size=IMG, episode_length=4, seed=5)
    env.launch()
    right = agent_of(cfg)
    left = agent_of(cfg)
    right.build(training=False)
    left.build(training=False)
    gen = RolloutGenerator()
    transitions = list(gen.generator(
        env, right, episode_length=4, left_arm_agent=left, which_arm="both",
        crop_target_obj_voxel=True, crop_radius=0.3,
    ))
    assert transitions and transitions[-1].terminal
    arms = [arm for _, arm, _ in env.step_log]
    expected = ["left" if i % 2 == 0 else "right" for i in range(len(arms))]
    assert arms == expected


def test_rollout_multiarm_branch(rng):
    """crop + multiarm: one policy, per-arm lang instruction keys
    (rollout_generator.py:299-374)."""
    cfg = tiny_cfg(which_arm="right", arm_pred_loss=False)
    env = FakeBimanualEnv(image_size=IMG, episode_length=4, seed=6)
    env.launch()
    agent = agent_of(cfg)
    agent.build(training=False)
    gen = RolloutGenerator()
    transitions = list(gen.generator(
        env, agent, episode_length=4, which_arm="multiarm",
        crop_target_obj_voxel=True, crop_radius=0.3,
    ))
    assert transitions and transitions[-1].terminal
    # the agent sees multiarm_{left,right}; the env is stepped with the plain arm
    arms = [arm for _, arm, _ in env.step_log]
    expected = ["left" if i % 2 == 0 else "right" for i in range(len(arms))]
    assert arms == expected


def test_auto_crop_uses_env_radius(rng):
    """auto_crop pulls the env's object-derived radius (vlm.py:182-192 path)."""
    cfg = tiny_cfg()
    env = FakeBimanualEnv(image_size=IMG, episode_length=3, seed=7)
    env.launch()
    acting = agent_of(cfg)
    stabilizing = agent_of(cfg)
    acting.build(training=False)
    stabilizing.build(training=False)
    list(RolloutGenerator().generator(
        env, acting, episode_length=2, left_arm_agent=stabilizing,
        which_arm="dominant_assistive", crop_target_obj_voxel=True,
        crop_radius=999.0, auto_crop=True,  # huge manual radius must be ignored
    ))
    crop = np.round(np.asarray(env.target_object_world_coords()), 2)
    for _, _, action in env.step_log:
        assert np.all(np.abs(action[:3] - crop) <= env.auto_crop_radius() + 1e-6)


def test_stabilizing_sweep(tmp_path, rng):
    """best-acting x sweep-stabilizing dual selection (eval.py:206-241)."""
    cfg = tiny_cfg()
    env = FakeBimanualEnv(image_size=IMG, episode_length=3, seed=9)
    env.launch()
    acting = agent_of(cfg)
    acting.build(training=False)
    obs = env.reset()
    acting.act(0, obs, which_arm="dominant", dominant_assitive_policy=True)
    acting.save_weights(str(tmp_path / "acting" / "0"))
    for s in (0, 1):
        acting.save_weights(str(tmp_path / "stab" / str(s)))

    stabilizing = agent_of(cfg)
    runner = EvalRunner(
        env, acting, str(tmp_path / "acting"), str(tmp_path / "logs"),
        left_arm_agent=stabilizing, eval_episodes=1, episode_length=3,
    )
    rows = runner.sweep_stabilizing(0, str(tmp_path / "stab"))
    assert [r["left_step"] for r in rows] == [0, 1]
    assert all(r["step"] == 0 for r in rows)
    assert os.path.exists(tmp_path / "logs" / "stabilizing_sweep.csv")

    # resume: a fresh runner skips the already-scored left steps and the CSV
    # keeps both original rows (restart mid-sweep must not rescore/truncate)
    acting.save_weights(str(tmp_path / "stab" / "2"))
    env2 = FakeBimanualEnv(image_size=IMG, episode_length=3, seed=9)
    env2.launch()
    runner2 = EvalRunner(
        env2, acting, str(tmp_path / "acting"), str(tmp_path / "logs"),
        left_arm_agent=stabilizing, eval_episodes=1, episode_length=3,
    )
    rows2 = runner2.sweep_stabilizing(0, str(tmp_path / "stab"))
    assert [r["left_step"] for r in rows2] == [2]
    with open(tmp_path / "logs" / "stabilizing_sweep.csv") as f:
        all_rows = list(csv.DictReader(f))
    assert [r["left_step"] for r in all_rows] == ["0", "1", "2"]


def test_time_limit_terminal_is_marked_timeout(rng):
    """The env terminates on its own time limit, so the rollout must still
    flag the transition as a timeout in replay (YARR rollout_generator.py:53)."""

    class _MissAgent:
        def build(self, training=False):
            pass

        def act(self, step, obs, **kw):
            # never reaches the target, never closes the gripper
            return ActResult(np.r_[0.3, 0.0, 1.0, 0, 0, 0, 1, 1.0, 1.0])

    env = FakeBimanualEnv(image_size=IMG, episode_length=3, seed=1)
    env.launch()
    rts = list(RolloutGenerator().generator(
        env, _MissAgent(), episode_length=3, eval=True, which_arm="dominant"))
    assert rts[-1].terminal and rts[-1].timeout
    assert not any(r.timeout for r in rts[:-1])


class _ScriptedPlanner:
    """Fake VoxPoser planner: moves both arms toward the target."""

    def __init__(self):
        self.plan_calls = 0

    def plan(self, env, obs):
        self.plan_calls += 1
        target = env.target_object_world_coords()
        for arm in ("left", "right"):
            yield np.r_[target + [0, 0, 0.1], 0, 0, 0, 1, 1.0, 1.0], arm


class _SpyAgent:
    """Minimal agent recording when act() is first called relative to env steps."""

    def __init__(self, env, grip_flip_at=None):
        self._env = env
        self.first_act_step_count = None
        self._grip_flip_at = grip_flip_at
        self._n = 0

    def build(self, training=False):
        pass

    def act(self, step, obs, **kw):
        if self.first_act_step_count is None:
            self.first_act_step_count = len(self._env.step_log)
        grip = 1.0
        if self._grip_flip_at is not None and self._n >= self._grip_flip_at:
            grip = 0.0
        self._n += 1
        return ActResult(np.r_[0.3, 0.0, 1.0, 0, 0, 0, 1, grip, 1.0])


def test_voxposer_prepositioning_runs_before_policy(rng):
    """VoxPoser pre-positioning (rollout_generator.py:103-110): planner actions
    move the arms BEFORE the first agent.act, without consuming episode budget."""
    env = FakeBimanualEnv(image_size=IMG, episode_length=4, seed=5)
    env.launch()
    planner = _ScriptedPlanner()
    agent = _SpyAgent(env)
    transitions = list(RolloutGenerator().generator(
        env, agent, episode_length=2, left_arm_agent=agent,
        which_arm="dominant_assistive", crop_target_obj_voxel=True,
        crop_radius=0.3, no_voxposer=False, planner=planner,
    ))
    assert planner.plan_calls == 1
    # the planner's 2 arm motions landed in the env BEFORE the first act
    assert agent.first_act_step_count == 2
    planner_arms = [arm for _, arm, _ in env.step_log[:2]]
    assert set(planner_arms) == {"left", "right"}
    assert transitions  # the learned policy still ran its episode


def test_no_voxposer_flag_skips_prepositioning(rng):
    env = FakeBimanualEnv(image_size=IMG, episode_length=4, seed=5)
    env.launch()
    planner = _ScriptedPlanner()
    agent = _SpyAgent(env)
    list(RolloutGenerator().generator(
        env, agent, episode_length=2, left_arm_agent=agent,
        which_arm="dominant_assistive", crop_target_obj_voxel=True,
        no_voxposer=True, planner=planner,
    ))
    assert planner.plan_calls == 0
    assert agent.first_act_step_count == 0


def test_openjar_gripper_switch_heuristic(rng):
    """Plain branch + OpenJar: left arm acts until its gripper bit flips, then
    control switches to the right arm (rollout_generator.py:540-608)."""
    env = FakeBimanualEnv(image_size=IMG, episode_length=8, seed=7,
                          task_name="OpenJar", success_radius=0.0)
    env.launch()
    agent = _SpyAgent(env, grip_flip_at=3)  # gripper closes on the 4th act
    list(RolloutGenerator().generator(env, agent, episode_length=8, which_arm="right",
                                      crop_target_obj_voxel=False))
    arms = [arm for _, arm, _ in env.step_log]
    # steps 0-3 left (flip happens at step 3), 4+ right
    assert arms[:4] == ["left"] * 4
    assert set(arms[4:]) == {"right"}


class _SleepAgent(Agent):
    def __init__(self, spans_dir):
        self._spans_dir = spans_dir

    def build(self, training=False, device=None):
        pass

    def update(self, step, batch):
        return {}

    def act(self, step, observation, **kw):
        t0 = time.time()
        time.sleep(0.5)
        # record (pid, start, end) so overlap can be asserted from actual
        # execution intervals — robust to process-startup jitter under load
        with open(self._spans_dir / f"{os.getpid()}.log", "a") as f:
            f.write(f"{t0} {time.time()}\n")
        return ActResult(np.r_[0.3, 0.0, 1.0, 0, 0, 0, 1, 1.0, 1.0])

    def load_weights(self, savedir):
        pass

    def save_weights(self, savedir):
        pass


def _parallel_runner(tmp_path):
    spans_dir = tmp_path / "spans"
    os.makedirs(spans_dir, exist_ok=True)
    for step in (0, 1, 2):
        os.makedirs(tmp_path / "weights" / str(step), exist_ok=True)
    env = FakeBimanualEnv(image_size=8, episode_length=2, seed=1)
    runner = EvalRunner(
        env, _SleepAgent(spans_dir), str(tmp_path / "weights"), str(tmp_path / "logs"),
        eval_episodes=1, episode_length=2, which_arm="right",
        crop_target_obj_voxel=False,
    )
    return runner, spans_dir


def test_parallel_eval_overlaps_and_keeps_csv_contract(tmp_path, rng):
    """One process per checkpoint (eval.py:242-261): ≥2 ckpts overlap in wall
    clock, rows land in the same skip-scored CSV."""
    runner, spans_dir = _parallel_runner(tmp_path)
    results = runner.start("missing", num_procs=3)
    assert [r["step"] for r in results] == [0, 1, 2]
    spans = {}
    for fn in os.listdir(spans_dir):
        with open(spans_dir / fn) as f:
            spans[fn] = [tuple(map(float, ln.split())) for ln in f if ln.strip()]
    assert len(spans) >= 2, f"expected >=2 worker processes, saw {list(spans)}"
    pids = list(spans)
    overlapped = any(
        s0 < e1 and s1 < e0
        for i, a in enumerate(pids) for b in pids[i + 1:]
        for (s0, e0) in spans[a] for (s1, e1) in spans[b]
    )
    assert overlapped, f"no wall-clock overlap between workers: {spans}"
    # skip-scored contract intact: a second 'missing' run finds nothing
    assert runner.start("missing", num_procs=3) == []


def test_parallel_eval_refuses_an_initialised_cuda_context(tmp_path, monkeypatch):
    """Forked children cannot use their parent's CUDA context: the parallel
    eval raises instead of forking (or of going serial)."""
    runner, spans_dir = _parallel_runner(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="CUDA is already initialised"):
        runner.start("missing", num_procs=3)
    assert not os.listdir(spans_dir)
    assert not os.path.exists(tmp_path / "logs" / "eval_data.csv")


# -- the protocol tasks, both packages -------------------------------------------------


def _oracle_module():
    spec = importlib.util.spec_from_file_location(
        "oracle_protocol_check", os.path.join(ROOT, "tools", "oracle_protocol_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stub_language(text):
    r = np.random.default_rng(len(text))
    return (r.normal(size=(1024,)).astype(np.float32),
            r.normal(size=(77, 512)).astype(np.float32))


class _KeyframePlan:
    """Per episode, the discretized next-keyframe actions of each arm, as the
    oracle builds them; shared by the acting and the stabilizing agent."""

    def __init__(self, plans):
        self._plans = list(plans)
        self.queues = None

    def start_episode(self):
        self.queues = {arm: list(q) for arm, q in self._plans.pop(0).items()}


class _ScriptedAgent(Agent):
    """Replays the plan's actions for the arm it is asked to move; holds the
    arm's pose when its queue is empty."""

    def __init__(self, plan, first):
        self._plan, self._first = plan, first

    def build(self, training=False, device=None):
        pass

    def update(self, step, batch):
        return {}

    def act(self, step, observation, which_arm=None, **kw):
        if step == 0 and self._first:
            self._plan.start_episode()
        q = self._plan.queues[which_arm]
        if q:
            return ActResult(q.pop(0))
        pose = np.asarray(observation[f"gripper_{which_arm}_pose"], np.float64).reshape(-1)
        grip = float(np.asarray(observation[f"low_dim_state_{which_arm}_arm"]).reshape(-1)[0])
        return ActResult(np.concatenate([pose, [grip, 1.0]]))

    def load_weights(self, savedir):
        pass

    def save_weights(self, savedir):
        pass


def _plans(task, episodes, oracle):
    """The oracle's action queues of each episode, from the JAX sim's demos."""
    from voxactb_tpu.data.fill_replay import discretize_keyframe, scene_bounds_from_crop_np
    from voxactb_tpu.sim.environment import BimanualTaskEnvironment as JaxEnv
    from voxactb_tpu.sim.tasks import TASK_REGISTRY as JAX_REGISTRY
    from voxactb_tpu.utils.keypoints import keypoint_discovery

    env = JaxEnv(JAX_REGISTRY[task], cameras=CAMERAS, image_size=IMG, episode_length=25,
                 seed=43, lang_encoder=_stub_language)
    out = []
    for ep in range(episodes):
        frames, _ = env.get_demo(ep)
        dom = env.dominant_arm()
        env.reset_to_demo(ep)
        bounds = scene_bounds_from_crop_np(0.3, env.target_object_world_coords())
        queues = {}
        for arm, mode in ((dom, "dominant"), ("left" if dom == "right" else "right",
                                              "assistive")):
            kps = keypoint_discovery(frames, which_arm=mode, dominant_assistive_arm=arm)[0]
            queues[arm] = []
            for kp in kps:
                t_idx, rot_grip, _, _ = discretize_keyframe(
                    frames[kp], frames[max(kp - 1, 0)], bounds, 50, 5, arm)
                queues[arm].append(oracle.continuous_from_discrete(
                    t_idx, rot_grip, bounds, 50, 5))
        out.append(queues)
    return out


@pytest.mark.parametrize("task", PROTOCOL_TASKS)
def test_scripted_agent_eval_rows_equal(tmp_path, task):
    from voxactb_tpu.runners.eval_runner import EvalRunner as JaxEvalRunner
    from voxactb_tpu.sim.environment import BimanualTaskEnvironment as JaxEnv
    from voxactb_tpu.sim.tasks import TASK_REGISTRY as JAX_REGISTRY
    from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment
    from voxactb_tpu_torch.sim.tasks import TASK_REGISTRY

    episodes = 2
    # the runner replays demo indices 0..episodes-1 for each of two checkpoints
    plans = _plans(task, episodes, _oracle_module()) * 2
    rows = {}
    for name, runner_cls, env_cls, registry in (
            ("jax", JaxEvalRunner, JaxEnv, JAX_REGISTRY),
            ("port", EvalRunner, BimanualTaskEnvironment, TASK_REGISTRY)):
        for step in (0, 1):
            os.makedirs(tmp_path / name / "weights" / str(step), exist_ok=True)
        plan = _KeyframePlan(plans)
        env = env_cls(registry[task], cameras=CAMERAS, image_size=IMG, episode_length=25,
                      seed=43, lang_encoder=_stub_language)
        runner = runner_cls(
            env, _ScriptedAgent(plan, first=False), str(tmp_path / name / "weights"),
            str(tmp_path / name), left_arm_agent=_ScriptedAgent(plan, first=True),
            eval_episodes=episodes, episode_length=25, crop_radius=0.3)
        runner.start("missing")
        with open(tmp_path / name / "eval_data.csv") as f:
            rows[name] = list(csv.DictReader(f))
    assert rows["port"] == rows["jax"]
    assert len(rows["port"]) == 2
    # the keyframe script solves the task, as the oracle does
    assert all(float(r["eval_envs/return"]) > 0 for r in rows["port"]), rows["port"]


@pytest.mark.parametrize("task", PROTOCOL_TASKS)
def test_oracle_succeeds_on_the_port_sim(task):
    """tests/test_oracle_protocol.py's invariant on the port's sim: the JAX
    tool's oracle, handed the port's environment, clears every task."""
    from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment
    from voxactb_tpu_torch.sim.tasks import TASK_REGISTRY

    mod = _oracle_module()
    env = BimanualTaskEnvironment(
        TASK_REGISTRY[task], cameras=["wrist", "wrist2"], image_size=32,
        episode_length=25, seed=43, lang_encoder=_stub_language)
    for ep in range(2):
        out = mod.oracle_episode(env, voxel_size=50, rotation_resolution=5,
                                 crop_radius=0.3, ep=ep)
        assert out["success"], (task, ep, out)
