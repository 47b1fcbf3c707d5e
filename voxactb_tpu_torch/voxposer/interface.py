"""The voxel value-map API exposed to LMP-generated code + waypoint execution.

Counterpart of ``LMP_interface`` (peract/voxposer/interfaces.py:15-530) and the
waypoint half of ``Controller`` (controllers.py:11-102): generated code calls
``detect`` / map factories / ``execute``; ``execute`` builds cost maps, runs the
greedy planner and walks the end effector of the commanded arm along the path.
Object-centric motion ("push the jar to ...") routes through the random-shooting
MPC (controllers.py:103+) which plans a contact point + push direction and
executes it with the commanded arm.

``make_sim_object_lookup`` bridges a sim environment to ``detect``-able objects
with surface point/normal queries — the role of the reference env's
object-query layer (voxposer/envs/rlbench_env.py:867-991).

``VoxPoserPlanner.plan`` adapts the whole stack to the rollout generator's
``voxposer_only`` branch (yields (9-DoF action, arm) pairs).

A copy of ``voxactb_tpu.voxposer.interface``, kept in the port so that it imports nothing
of the JAX package; host code, the same on every device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np

from voxactb_tpu_torch.envs.base import BimanualEnv
from voxactb_tpu_torch.voxposer.lmp import DEFAULT_CACHE_DIR, LMP, LLMBackend, LMPConfig
from voxactb_tpu_torch.voxposer.planner import GreedyPathPlanner
from voxactb_tpu_torch.voxposer.value_maps import VoxelMapSpec, set_voxel_by_radius

EE_ALIAS = ("ee", "endeffector", "end_effector", "end effector", "gripper",
            "hand", "right hand", "left hand")


@dataclass
class DetectedObject:
    name: str
    position: np.ndarray           # world frame
    normals: Optional[np.ndarray] = None
    aabb: Optional[np.ndarray] = None
    points: Optional[np.ndarray] = None  # surface samples (object point query)


def aabb_surface_points_and_normals(aabb: np.ndarray, m: int = 4
                                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Sample points on an AABB's six faces with outward normals — the sim
    stand-in for the reference's mesh-derived object point/normal queries
    (rlbench_env.py:867-991, which reads CoppeliaSim mesh vertices)."""
    lo, hi = np.asarray(aabb[:3], np.float64), np.asarray(aabb[3:], np.float64)
    center, half = (lo + hi) / 2, (hi - lo) / 2
    lin = np.linspace(-1.0, 1.0, m)
    u, v = np.meshgrid(lin, lin, indexing="ij")
    u, v = u.ravel(), v.ravel()
    pts, nrm = [], []
    for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)):
        f = np.empty((u.size, 3))
        f[:, axis] = sign
        f[:, (axis + 1) % 3] = u
        f[:, (axis + 2) % 3] = v
        pts.append(center + f * half)
        n = np.zeros((u.size, 3))
        n[:, axis] = sign
        nrm.append(n)
    return np.concatenate(pts, 0), np.concatenate(nrm, 0)


def make_sim_object_lookup(env) -> Callable[[str], "DetectedObject"]:
    """``detect``-style lookup over a kinematic-sim environment's objects.

    Resolves names fuzzily (substring both ways, like the reference's
    name-normalization layer) and fills position/aabb/normals from the live
    backend state at call time."""

    def lookup(name: str) -> DetectedObject:
        backend = env.backend
        key = name.strip().lower().replace(" ", "_")
        names = list(backend.object_names())
        match = next((n for n in names if n == key), None)
        if match is None:
            match = next(
                (n for n in names if key in n or n in key), None)
        if match is None:
            raise KeyError(f"no object matching {name!r}; have {names}")
        obj = backend.get_object(match)
        points, normals = aabb_surface_points_and_normals(obj.aabb())
        return DetectedObject(match, obj.position.copy(), normals=normals,
                              aabb=obj.aabb(), points=points)

    return lookup


class LMPInterface:
    """What the generated code sees (interfaces.py:42-314)."""

    def __init__(self, env: BimanualEnv, spec: VoxelMapSpec,
                 object_lookup: Callable[[str], DetectedObject],
                 planner: Optional[GreedyPathPlanner] = None,
                 arm: str = "right", execute_in_env: bool = True):
        self._env = env
        self._spec = spec
        self._lookup = object_lookup
        self._planner = planner or GreedyPathPlanner(map_size=spec.map_size)
        self._arm = arm
        self._execute_in_env = execute_in_env
        self.executed_paths: List[np.ndarray] = []
        self.planned_actions: List[np.ndarray] = []

    # -- API surface for generated code --------------------------------------------

    def detect(self, name: str) -> DetectedObject:
        return self._lookup(name)

    def get_empty_affordance_map(self):
        return self._spec.affordance_map()

    def get_empty_avoidance_map(self):
        return self._spec.avoidance_map()

    def get_empty_rotation_map(self):
        return self._spec.rotation_map()

    def get_default_velocity_map(self):
        return self._spec.velocity_map()

    def get_default_gripper_map(self):
        return self._spec.gripper_map()

    def cm2index(self, cm, direction=None):
        return self._spec.cm2index(cm, direction)

    def pointat2index(self, point):
        return self._spec.world_to_voxel(point)

    def index2point(self, idx):
        return self._spec.voxel_to_world(idx)

    def set_voxel_by_radius(self, voxel_map, center_idx, radius_cm=0.0, value=1.0):
        return set_voxel_by_radius(voxel_map, center_idx, radius_cm, self._spec,
                                   value)

    def execute(self, movable, affordance_map, avoidance_map=None,
                rotation_map=None, velocity_map=None, gripper_map=None,
                start_position=None) -> List[np.ndarray]:
        """Plan through the value maps and walk the arm's EE along the path
        (interfaces.py:85-242 condensed to the EE-motion case)."""
        name = (movable.name if isinstance(movable, DetectedObject)
                else str(movable)).lower()
        object_centric = name not in EE_ALIAS
        if object_centric:
            return self._execute_object_centric(movable, affordance_map)

        if avoidance_map is None:
            avoidance_map = self._spec.avoidance_map()
        if rotation_map is None:
            rotation_map = self._spec.rotation_map()
        if gripper_map is None:
            gripper_map = self._spec.gripper_map()

        if start_position is None:
            pose = self._ee_pose()
            start_position = pose[:3]
        start_idx = self._spec.world_to_voxel(start_position)

        path, _info = self._planner.optimize(
            start_idx.astype(np.float64), affordance_map, avoidance_map)
        self.executed_paths.append(path)

        actions = []
        for wp in path:
            i = np.round(wp).clip(0, self._spec.map_size - 1).astype(int)
            pos = self._spec.voxel_to_world(wp)
            quat = rotation_map[i[0], i[1], i[2]]
            grip = gripper_map[i[0], i[1], i[2]]
            action = np.concatenate(
                [pos, quat, [float(grip)], [1.0]]).astype(np.float32)
            actions.append(action)
            if self._execute_in_env:
                self._env.step(action, self._arm)
        self.planned_actions.extend(actions)
        return actions

    def _execute_object_centric(self, movable, affordance_map) -> List[np.ndarray]:
        """Pushing motion via random-shooting MPC (controllers.py:103+)."""
        from voxactb_tpu_torch.voxposer.controller import RandomShootingMPC

        obj = (movable if isinstance(movable, DetectedObject)
               else self._lookup(str(movable)))
        targets = np.argwhere(affordance_map == affordance_map.max())
        target_world = self._spec.voxel_to_world(targets.mean(axis=0))
        mpc = RandomShootingMPC()
        radius = 0.03
        if obj.aabb is not None:
            radius = float(np.max(obj.aabb[3:] - obj.aabb[:3]) / 2)
        contact, direction, dist = mpc.plan_push(
            obj.position, radius, target_world)
        if self._execute_in_env:
            mpc.execute_push(self._env, self._arm, contact, direction, dist)
        action = np.concatenate(
            [contact + direction * dist, [0, 1, 0, 0], [0.0], [1.0]]
        ).astype(np.float32)
        self.planned_actions.append(action)
        return [action]

    def _ee_pose(self) -> np.ndarray:
        obs = getattr(self._env, "_observation", None)
        if callable(obs):
            o = obs()
            key = f"gripper_{self._arm}_pose"
            if key in o:
                return np.asarray(o[key], np.float32)
        return np.concatenate([self._spec.mins + (self._spec.maxs -
                                                  self._spec.mins) / 2, [0, 0, 0, 1]])


class VoxPoserPlanner:
    """voxposer_only rollouts: LMP stack -> per-arm EE paths -> env actions.

    Plugs into RolloutGenerator's ``planner`` hook (rollout_generator.py:66-130).
    """

    def __init__(self, backend: LLMBackend, spec: VoxelMapSpec,
                 object_lookup: Callable[[str], DetectedObject],
                 lmp_cfg: Optional[LMPConfig] = None,
                 cache_dir: str = DEFAULT_CACHE_DIR):
        self._spec = spec
        self._lookup = object_lookup
        self._backend = backend
        self._lmp_cfg = lmp_cfg or LMPConfig()
        self._cache_dir = cache_dir

    def plan(self, env: BimanualEnv, obs) -> Iterable[Tuple[np.ndarray, str]]:
        goal = obs.get("lang_goal", "") if isinstance(obs, dict) else ""
        for arm in ("left", "right"):
            # plan only — the rollout generator owns env stepping
            iface = LMPInterface(env, self._spec, self._lookup, arm=arm,
                                 execute_in_env=False)
            lmp = LMP(
                f"planner_{arm}", self._lmp_cfg, self._backend,
                variable_vars={
                    "detect": iface.detect,
                    "execute": iface.execute,
                    "get_empty_affordance_map": iface.get_empty_affordance_map,
                    "get_empty_avoidance_map": iface.get_empty_avoidance_map,
                    "get_empty_rotation_map": iface.get_empty_rotation_map,
                    "get_default_velocity_map": iface.get_default_velocity_map,
                    "get_default_gripper_map": iface.get_default_gripper_map,
                    "cm2index": iface.cm2index,
                    "pointat2index": iface.pointat2index,
                    "set_voxel_by_radius": iface.set_voxel_by_radius,
                    "np": np,
                },
                cache_dir=self._cache_dir,
            )
            lmp(f"{goal} ({arm} hand)")
            for action in iface.planned_actions:
                yield action, arm
