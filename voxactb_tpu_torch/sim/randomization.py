"""Visual domain randomization for sim observations.

Counterpart of RLBench's sim2real wrappers (rlbench/sim2real/domain_randomization*.py):
per-episode resampling of object colors, lighting gain, camera noise. Applied as a
wrapper around a task environment so tasks stay randomization-agnostic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from voxactb_tpu_torch.envs.base import BimanualEnv, Transition


@dataclass
class VisualRandomizationConfig:
    randomize_colors: bool = True
    brightness_range: tuple = (0.7, 1.3)
    rgb_noise_std: float = 4.0        # uint8 units
    depth_noise_std: float = 0.003    # meters, applied to point clouds
    randomize_every: str = "episode"  # 'episode' | 'transition'


class DomainRandomizedEnv(BimanualEnv):
    def __init__(self, env, cfg: VisualRandomizationConfig = None, seed: int = 0):
        self._env = env
        self._cfg = cfg or VisualRandomizationConfig()
        self._rng = np.random.default_rng(seed)
        self._gain = 1.0

    def _resample(self) -> None:
        self._gain = self._rng.uniform(*self._cfg.brightness_range)
        backend = getattr(self._env, "backend", None)
        if self._cfg.randomize_colors and backend is not None:
            for name in backend.object_names():
                backend.get_object(name).color = tuple(
                    self._rng.uniform(0.1, 0.9, 3))

    def _augment(self, obs: Dict) -> Dict:
        out = dict(obs)
        for k, v in obs.items():
            if k.endswith("_rgb"):
                noisy = np.asarray(v, np.float32) * self._gain
                noisy += self._rng.normal(0, self._cfg.rgb_noise_std, v.shape)
                out[k] = np.clip(noisy, 0, 255).astype(np.asarray(v).dtype)
            elif k.endswith("_point_cloud") and self._cfg.depth_noise_std > 0:
                out[k] = np.asarray(v) + self._rng.normal(
                    0, self._cfg.depth_noise_std, np.shape(v)).astype(np.float32)
        return out

    # -- BimanualEnv ---------------------------------------------------------------

    def launch(self):
        self._env.launch()

    def shutdown(self):
        self._env.shutdown()

    def _rerender(self, obs: Dict) -> Dict:
        # the inner reset rendered BEFORE _resample recolored the scene; the
        # first frame is exactly the one the VLM crop / dominant-arm choice
        # and the policy's first act condition on, so re-render it with the
        # randomized colors when the env can
        render = getattr(self._env, "_observation_dict", None)
        return render() if callable(render) else obs

    def reset(self):
        obs = self._env.reset()       # task placement first (recreates objects)
        self._resample()              # then randomize their appearance
        return self._augment(self._rerender(obs))

    def reset_to_demo(self, i):
        obs = self._env.reset_to_demo(i)
        self._resample()
        return self._augment(self._rerender(obs))

    def step(self, action, which_arm: str) -> Transition:
        if self._cfg.randomize_every == "transition":
            self._resample()
        t = self._env.step(action, which_arm)
        t.observation = self._augment(t.observation)
        return t

    def target_object_world_coords(self):
        return self._env.target_object_world_coords()

    def auto_crop_radius(self):
        return self._env.auto_crop_radius()

    def dominant_arm(self):
        return self._env.dominant_arm()

    @property
    def task_name(self):
        # without this the base default '' would disable task-keyed rollout
        # heuristics (e.g. the OpenJar gripper switch) under the wrapper
        return getattr(self._env, "task_name", "")

    def preposition_step(self, action, which_arm: str) -> Transition:
        # delegate so VoxPoser prologue actions keep the inner env's
        # don't-consume-the-episode-budget contract (environment.py) instead
        # of falling back to the base default that routes through step()
        inner = getattr(self._env, "preposition_step", self._env.step)
        t = inner(action, which_arm)
        t.observation = self._augment(t.observation)
        return t

    def get_demo(self, demo_index: int):
        return self._env.get_demo(demo_index)

    def set_variation(self, v: int) -> None:
        if hasattr(self._env, "set_variation"):
            self._env.set_variation(v)

    @property
    def env_language_goal(self):
        return self._env.env_language_goal

    @property
    def episode_length(self):
        return self._env.episode_length
