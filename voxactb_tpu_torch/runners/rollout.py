"""Episode rollout generation — the behavioral API surface of VoxAct-B evaluation.

Counterpart of YARR's ``RolloutGenerator`` (yarr/utils/rollout_generator.py:19-741) and
its six control branches (SURVEY §3.3). The branch logic is preserved; the torch
obs-history tensor plumbing is not needed (agents consume numpy dicts directly and
all math happens inside their device programs).

Branches:
- ``crop + dominant_assistive``  — THE VoxAct-B method (:208-297): VLM crop once per
  episode -> new scene bounds; dominant-arm selection; assistive policy acts on even
  steps, acting (dominant) policy on odd steps.
- ``crop + both``                — two independent single-arm policies, fixed
  right/left alternation (:131-207).
- ``crop + multiarm``            — one policy, per-arm language instructions (:299-374).
- ``dominant_assistive`` w/o crop (:375-459).
- plain single-arm / baselines (:460-741).
- ``voxposer_only``              — LLM planner drives both arms, no learned policy (:66).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Generator, Optional

import numpy as np

from voxactb_tpu_torch.agents.base import ActResult, Agent
from voxactb_tpu_torch.envs.base import BimanualEnv
from voxactb_tpu_torch.ops.geometry import scene_bounds_from_crop


@dataclass
class ReplayTransition:
    """yarr/utils/transition.py:18-30."""

    observation: Dict[str, Any]
    action: Any
    reward: float
    terminal: bool
    timeout: bool
    summaries: list = field(default_factory=list)
    info: Dict[str, Any] = field(default_factory=dict)
    final_observation: Optional[Dict[str, Any]] = None



def _safe_step(env, action, which_arm):
    """Step tolerating invalid actions: an out-of-workspace / unplannable action
    ends the episode with zero reward instead of crashing the runner — the
    reference wrapper's catch of (IKError, ConfigurationPathError,
    InvalidActionError) (custom_rlbench_env_two_robots.py:179-193)."""
    from voxactb_tpu_torch.envs.base import Transition
    from voxactb_tpu_torch.sim.environment import InvalidActionError

    try:
        return env.step(action, which_arm)
    except InvalidActionError as e:
        # episode over; the observation is unused past a terminal transition
        return Transition({}, reward=0.0, terminal=True,
                          info={"error": "InvalidActionError",
                                "detail": str(e)})


class RolloutGenerator:
    def __init__(self, scene_bounds=None):
        self._scene_bounds = scene_bounds

    def generator(
        self,
        env: BimanualEnv,
        agent: Agent,
        episode_length: int,
        eval: bool = True,
        left_arm_agent: Optional[Agent] = None,
        which_arm: str = "dominant_assistive",
        crop_target_obj_voxel: bool = True,
        crop_radius: float = 0.3,
        auto_crop: bool = False,
        no_acting_stabilizing: bool = False,
        voxposer_only_eval: bool = False,
        no_voxposer: bool = True,
        planner=None,
        demo_index: Optional[int] = None,
        max_preposition_steps: int = 10,
    ) -> Generator[ReplayTransition, None, None]:
        obs = (env.reset_to_demo(demo_index) if demo_index is not None
               else env.reset())

        if voxposer_only_eval:
            yield from self._voxposer_only(env, planner, obs, episode_length)
            return

        # VoxPoser pre-positioning: the LMP plans coarse approach motions that
        # move both arms near the object BEFORE the learned policy acts
        # (rollout_generator.py:103-110 `env.voxposer_ui(description)`; skipped
        # with the eval scripts' `no_voxposer=True` VLM-only-crop mode).
        if crop_target_obj_voxel and not no_voxposer and planner is not None:
            obs = self._voxposer_preposition(
                env, planner, obs, max_preposition_steps)

        new_scene_bounds = None
        if crop_target_obj_voxel:
            crop_point = env.target_object_world_coords()
            radius = env.auto_crop_radius() if auto_crop else crop_radius
            # a CPU f32 tensor: .tolist() hands act the f32 values' bits
            new_scene_bounds = scene_bounds_from_crop(crop_point, radius).tolist()

        if which_arm == "dominant_assistive":
            yield from self._dominant_assistive(
                env, agent, left_arm_agent, obs, episode_length, eval,
                new_scene_bounds, not no_acting_stabilizing,
            )
        elif which_arm == "both":
            yield from self._both_arms(
                env, agent, left_arm_agent, obs, episode_length, eval,
                new_scene_bounds,
            )
        elif which_arm == "multiarm":
            yield from self._multiarm(
                env, agent, obs, episode_length, eval, new_scene_bounds)
        else:  # plain single-arm baseline
            yield from self._single_arm(
                env, agent, obs, episode_length, eval, which_arm, new_scene_bounds)

    # -- branch bodies -----------------------------------------------------------

    def _step_once(self, env, agent_, step, obs, which_arm, act_kwargs,
                   episode_length):
        act_result: ActResult = agent_.act(step, dict(obs), **act_kwargs)
        transition = _safe_step(env, act_result.action, which_arm)
        timeout = False
        if step == episode_length - 1 and not transition.terminal:
            timeout = True
            transition.terminal = True
        elif transition.terminal and step == episode_length - 1:
            # the env itself terminates on its own time limit (success or
            # timeout); a last-step terminal that is neither a success nor a
            # collision failure IS the time limit — keep it distinguishable in
            # replay (YARR's timeout flag, rollout_generator.py:53-56)
            info = transition.info or {}
            if not info.get("success", transition.reward > 0) \
                    and not info.get("arm_collision", False):
                timeout = True

        combined = dict(obs)
        combined.update({k: np.asarray(v)
                         for k, v in act_result.observation_elements.items()})
        combined.update({k: np.asarray(v)
                         for k, v in act_result.replay_elements.items()})
        rt = ReplayTransition(
            combined, act_result.action, transition.reward, transition.terminal,
            timeout, summaries=transition.summaries, info=transition.info,
        )
        if transition.terminal:
            rt.final_observation = dict(transition.observation)
        return rt, transition

    def _dominant_assistive(self, env, agent, left_arm_agent, obs,
                            episode_length, eval, new_scene_bounds,
                            dominant_assistive_policy):
        """rollout_generator.py:208-297: assistive on even steps, acting on odd."""
        dominant_arm = env.dominant_arm()
        assistive_arm = "left" if dominant_arm == "right" else "right"
        dominant_agent, assistive_agent = agent, left_arm_agent

        for step in range(episode_length):
            if step % 2 == 0:
                curr_agent, arm = assistive_agent, assistive_arm
            else:
                curr_agent, arm = dominant_agent, dominant_arm
            rt, transition = self._step_once(
                env, curr_agent, step, obs, arm,
                dict(deterministic=eval, which_arm=arm,
                     new_scene_bounds=new_scene_bounds,
                     dominant_assitive_policy=dominant_assistive_policy),
                episode_length,
            )
            obs = dict(transition.observation)
            yield rt
            if transition.terminal:
                return

    def _both_arms(self, env, right_agent, left_agent, obs, episode_length,
                   eval, new_scene_bounds):
        """rollout_generator.py:131-207: fixed left/right alternation, two policies."""
        for step in range(episode_length):
            if step % 2 == 0:
                curr_agent, arm = left_agent, "left"
            else:
                curr_agent, arm = right_agent, "right"
            rt, transition = self._step_once(
                env, curr_agent, step, obs, arm,
                dict(deterministic=eval, which_arm=arm,
                     new_scene_bounds=new_scene_bounds),
                episode_length,
            )
            obs = dict(transition.observation)
            yield rt
            if transition.terminal:
                return

    def _multiarm(self, env, agent, obs, episode_length, eval, new_scene_bounds):
        """rollout_generator.py:299-374: one policy, per-arm language instructions."""
        for step in range(episode_length):
            arm = "left" if step % 2 == 0 else "right"
            rt, transition = self._step_once(
                env, agent, step, obs, arm,
                dict(deterministic=eval, which_arm=f"multiarm_{arm}",
                     new_scene_bounds=new_scene_bounds),
                episode_length,
            )
            obs = dict(transition.observation)
            yield rt
            if transition.terminal:
                return

    def _single_arm(self, env, agent, obs, episode_length, eval, which_arm,
                    new_scene_bounds):
        """rollout_generator.py:460-741 (plain/baseline path).

        OpenJar gripper-switch heuristic (:540-608): a single policy drives the
        LEFT arm until its gripper bit flips (the jar is held), then control
        switches to the RIGHT arm for the remainder of the episode."""
        gripper_switch = getattr(env, "task_name", "") == "OpenJar"
        arm = "left" if gripper_switch else which_arm
        prev_gripper = None
        for step in range(episode_length):
            rt, transition = self._step_once(
                env, agent, step, obs, arm,
                dict(deterministic=eval, which_arm=arm,
                     new_scene_bounds=new_scene_bounds),
                episode_length,
            )
            obs = dict(transition.observation)
            yield rt
            if transition.terminal:
                return
            if gripper_switch and arm == "left":
                action = np.asarray(rt.action)
                grip = float(action[7]) if action.shape[-1] > 7 else None
                if (prev_gripper is not None and grip is not None
                        and grip != prev_gripper):
                    arm = "right"  # 'Switch to right arm' (:605-608)
                prev_gripper = grip

    def _voxposer_preposition(self, env, planner, obs, max_steps):
        """Execute up to ``max_steps`` planner actions as the episode prologue.

        These motions happen 'inside reset' from the learned policy's point of
        view — no replay transitions are emitted, mirroring the reference where
        ``voxposer_ui`` runs before the policy loop starts emitting
        (rollout_generator.py:103-121)."""
        step_fn = getattr(env, "preposition_step", env.step)
        for step, (action, arm) in enumerate(planner.plan(env, obs)):
            if step >= max_steps:
                break
            transition = step_fn(action, arm)
            obs = dict(transition.observation)
            if transition.terminal:
                break
        return obs

    def _voxposer_only(self, env, planner, obs, episode_length):
        """rollout_generator.py:66-130: the LLM planner drives both arms directly."""
        if planner is None:
            raise ValueError("voxposer_only_eval needs a planner")
        for step, (action, arm) in enumerate(planner.plan(env, obs)):
            if step >= episode_length:
                return
            transition = _safe_step(env, action, arm)
            yield ReplayTransition(dict(obs), action, transition.reward,
                                   transition.terminal,
                                   timeout=step == episode_length - 1,
                                   info=transition.info)
            obs = dict(transition.observation)
            if transition.terminal:
                return
