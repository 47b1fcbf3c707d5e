"""Classic gym-style adapter over the bimanual envs.

Counterpart of RLBench's gym wrapper (rlbench/gym/rlbench_env.py, unused by VoxAct-B
but part of the benchmark surface). Standalone API (reset/step/render/close with
gymnasium return conventions) that also registers with gymnasium when it is
importable.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from voxactb_tpu_torch.envs.base import BimanualEnv


class BimanualGymEnv:
    """step() returns (obs, reward, terminated, truncated, info)."""

    metadata = {"render_modes": ["rgb_array"]}
    render_mode = "rgb_array"
    spec = None

    def __init__(self, env: BimanualEnv, which_arm: str = "dominant",
                 render_camera: str = "wrist"):
        self._env = env
        self._which_arm = which_arm
        self._render_camera = render_camera
        self._last_obs: Optional[Dict] = None
        self._steps = 0
        env.launch()
        # spaces so gymnasium's default wrappers (PassiveEnvChecker,
        # OrderEnforcing) accept the env; observation is a dict of arrays
        # whose exact keys depend on the camera set, so it is typed loosely
        try:
            import gymnasium.spaces as spaces

            self.action_space = spaces.Box(-np.inf, np.inf, (self.action_dim,),
                                           np.float32)
            self.observation_space = spaces.Dict({})
        except ImportError:
            self.action_space = None
            self.observation_space = None

    @property
    def action_dim(self) -> int:
        return 9  # xyz + quat + grip + ignore_collision

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None
              ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        if seed is not None and hasattr(self._env, "_rng"):
            # gymnasium reset contract: reseeding must make episodes
            # reproducible through the adapter
            self._env._rng = np.random.default_rng(seed)
        self._steps = 0
        self._last_obs = self._env.reset()
        return self._last_obs, {}

    def step(self, action) -> Tuple[Dict, float, bool, bool, Dict]:
        # route through the same invalid-action policy as the internal rollout
        # stack (_safe_step): an out-of-bounds random action ends the episode
        # with zero reward instead of crashing the gym consumer
        from voxactb_tpu_torch.runners.rollout import _safe_step

        t = _safe_step(self._env, np.asarray(action, np.float32),
                       self._which_arm)
        self._steps += 1
        self._last_obs = t.observation
        # gymnasium semantics: `terminated` = the MDP ended (success OR
        # failure — e.g. an arm collision); `truncated` = the time limit cut
        # the episode. Bootstrapping at failure states would be wrong.
        ep_len = getattr(self._env, "episode_length", None)
        truncated = bool(t.terminal and ep_len is not None
                         and self._steps >= ep_len
                         and not t.info.get("success", False)
                         and not t.info.get("arm_collision", False)
                         and "error" not in t.info)
        terminated = bool(t.terminal and not truncated)
        return t.observation, t.reward, terminated, truncated, t.info

    def render(self) -> Optional[np.ndarray]:
        if self._last_obs is None:
            return None
        frame = self._last_obs.get(f"{self._render_camera}_rgb")
        return None if frame is None else np.asarray(frame)[0]

    def close(self) -> None:
        self._env.shutdown()


def register_gymnasium(task_name: str = "open_jar", **env_kw) -> Optional[str]:
    """Register 'VoxActB/<task>-v0' with gymnasium when present; returns the id."""
    try:
        import gymnasium as gym
    except ImportError:
        return None

    env_id = f"VoxActB/{task_name}-v0"

    def make(**kw):
        from voxactb_tpu_torch.sim.environment import SimEnvironment

        sim = SimEnvironment(**env_kw)
        sim.launch()
        # make-time kwargs (which_arm, render_camera) reach the adapter
        return BimanualGymEnv(sim.get_task(task_name), **kw)

    gym.register(env_id, make)
    return env_id
