"""The bimanual task authoring contract.

Counterpart of ``Task2Robots`` (rlbench/backend/task_two_robots.py:25-601):
``init_task`` builds the scene objects once, ``init_episode`` places them per
variation and registers success conditions, and scripted demos come from per-arm
labeled waypoint sequences (``get_waypoints_dominant_assistive`` — the machinery
behind the per-task demo recorders in scene_two_robots.py:793-2800).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from voxactb_tpu_torch.sim.backend import SimBackend
from voxactb_tpu_torch.sim.conditions import Condition


@dataclass
class Waypoint:
    """One scripted step: where to move which arm and what the gripper does after."""

    arm: str                              # 'right' | 'left'
    position: np.ndarray
    quaternion: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, 0.0, 1.0]))
    gripper_open: Optional[float] = None  # None = leave unchanged
    dwell: int = 3                        # settle ticks at the waypoint (keyframes)
    label: str = ""

    @property
    def arm_label(self) -> int:
        return 0 if self.arm == "right" else 1


class BimanualTask(abc.ABC):
    """Subclass per task; register objects, waypoints and success conditions."""

    name: str = "bimanual_task"
    num_variations: int = 1
    # False for classic single-arm RLBench tasks (rlbench/tasks/*.py drives one
    # Panda); the validator then requires exactly one waypoint arm instead of two
    bimanual: bool = True

    def __init__(self, backend: SimBackend):
        self.backend = backend
        self._success_conditions: List[Condition] = []

    # -- authoring API (task_two_robots.py behavior) -----------------------------------

    def register_success_conditions(self, conditions: Sequence[Condition]) -> None:
        self._success_conditions = list(conditions)

    def success(self) -> bool:
        return bool(self._success_conditions) and all(
            c.satisfied(self.backend) for c in self._success_conditions)

    # -- to implement -------------------------------------------------------------------

    @abc.abstractmethod
    def init_task(self) -> None:
        """Create the scene objects (called once after load)."""

    @abc.abstractmethod
    def init_episode(self, variation: int, rng: np.random.Generator) -> List[str]:
        """Place objects for an episode; returns language descriptions."""

    @abc.abstractmethod
    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        """Scripted bimanual demo for the given dominant arm (the per-task
        dominant/assistive recorders of scene_two_robots.py)."""

    # -- optional hooks -----------------------------------------------------------------

    def target_object_name(self) -> Optional[str]:
        """Object the VLM would localize (drives crop bounds)."""
        return None

    def dominant_arm(self) -> str:
        """Ground-truth acting arm for the current episode placement."""
        return "right"

    def base_rotation_bounds(self) -> Tuple[float, float]:
        return (-np.pi / 4, np.pi / 4)


class PlacementError(RuntimeError):
    """Episode placement sampling failed — the kinematic counterpart of RLBench's
    BoundaryError; BimanualTaskEnvironment.reset retries init_episode on it
    (scene_two_robots.py's MAX_RESET_ATTEMPTS loop)."""


def sample_disjoint_position(backend, rng: np.random.Generator, low, high, size,
                             max_attempts: int = 50) -> np.ndarray:
    """Sample a position whose AABB avoids every object already in the scene.

    The kinematic stand-in for SpawnBoundary.sample's collision-checked placement
    (rlbench/backend/spawn_boundary.py): draw uniformly in [low, high], reject on
    AABB overlap, raise PlacementError when the budget is exhausted.
    """
    half = np.asarray(size, np.float64) / 2
    low = np.asarray(low, np.float64)
    high = np.asarray(high, np.float64)
    for _ in range(max_attempts):
        pos = rng.uniform(low, high)
        clear = True
        for name in backend.object_names():
            bb = backend.get_object(name).aabb()
            if np.all(pos + half > bb[:3]) and np.all(bb[3:] > pos - half):
                clear = False
                break
        if clear:
            return pos
    raise PlacementError(
        f"no collision-free placement in {max_attempts} draws "
        f"(bounds {low}..{high}, size {size})")
