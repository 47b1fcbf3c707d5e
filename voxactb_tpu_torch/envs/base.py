"""The bimanual environment contract the runners/rollout generators drive.

Counterpart of YARR's Env/Transition types (yarr/utils/transition.py:7-30,
yarr/envs/rlbench_env_two_robots.py:193-326) distilled to what the VoxAct-B control
flow actually uses: reset (optionally to a stored demo's initial state), a step routed
to one arm, per-episode VLM crop info, and the dominant-arm decision.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Transition:
    observation: Dict[str, Any]
    reward: float
    terminal: bool
    info: Dict[str, Any] = field(default_factory=dict)
    summaries: List = field(default_factory=list)


class BimanualEnv(abc.ABC):
    """Two-arm environment with per-arm stepping."""

    @abc.abstractmethod
    def launch(self) -> None:
        ...

    def shutdown(self) -> None:
        pass

    @abc.abstractmethod
    def reset(self) -> Dict[str, Any]:
        """New episode; returns the first observation dict."""

    def reset_to_demo(self, demo_index: int) -> Dict[str, Any]:
        """Reset to a stored demo's initial configuration (task_environment
        _two_robots.py:207). Defaults to a plain reset for envs without demos."""
        return self.reset()

    @abc.abstractmethod
    def step(self, action, which_arm: str) -> Transition:
        """Apply a 9-DoF action [xyz, quat(xyzw), grip, ignore_collision] to one arm
        (task_environment_two_robots.py:118)."""

    def preposition_step(self, action, which_arm: str) -> Transition:
        """A step taken during VoxPoser pre-positioning (the episode prologue,
        rollout_generator.py:103-110): same motion as :meth:`step` but it must
        not consume the learned policy's episode budget. Default: plain step."""
        return self.step(action, which_arm)

    # -- VoxAct-B hooks -----------------------------------------------------------

    @property
    def task_name(self) -> str:
        """Class name of the active task ('OpenJar', ...) for task-conditional
        rollout heuristics (rollout_generator.py:540)."""
        return ""

    def target_object_world_coords(self) -> Optional[Any]:
        """VLM-localized crop point (rlbench/backend/vlm.py:144). None if no VLM."""
        return None

    def auto_crop_radius(self) -> float:
        """Object-size-derived crop radius (vlm.py:182-192); 0 means 'use config'."""
        return 0.0

    def dominant_arm(self) -> str:
        """'right' or 'left' (voxposer/envs/rlbench_env.py:530-615 heuristics)."""
        return "right"

    @property
    def env_language_goal(self) -> str:
        return ""

    @property
    def episode_length(self) -> int:
        return 25
