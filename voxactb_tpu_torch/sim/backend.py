"""Simulator backend protocol + the kinematic reference implementation.

Plays the role PyRep plays for RLBench (SURVEY §1 L0): scene objects with poses,
two arms with grippers, proximity/grasp queries, camera rendering, stepping. The
``KinematicBackend`` is deliberately dynamics-free — arms move along interpolated
paths, grasped objects ride the gripper — which is exactly enough for waypoint-scripted
demo generation, observation streams and success conditions without a physics engine.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

ARMS = ("right", "left")


def normalize_quaternion_f32(quat) -> np.ndarray:
    """Unit-normalize an xyzw quaternion in float32, stored as float32.

    The arm poses of the JAX sim round through float32 at every move (its
    ``normalize_quaternion`` runs with 64-bit types off), so this copy does
    the same, in XLA's CPU order: the input is rounded to f32, the squares
    are summed in index order with each square fused into its add, and the
    quotient is taken in f32. The fused multiply-add is a float64 sum of the
    exact square and the f32 partial, rounded to f32: one rounding, as an
    FMA's, except where that float64 sum is inexact and rounds onto an f32
    midpoint, which the tests have not met. A float64 normalization would
    drift from those demos by an ulp per move, enough to flip a grasp
    threshold.
    """
    q = np.asarray(quat, np.float32)
    acc = np.zeros(q.shape[:-1], np.float32)
    for i in range(q.shape[-1]):
        x = q[..., i].astype(np.float64)
        acc = (x * x + acc).astype(np.float32)
    return q / np.sqrt(acc)[..., None]


@dataclass
class SceneObject:
    name: str
    position: np.ndarray                     # [3]
    quaternion: np.ndarray = field(
        default_factory=lambda: np.array([0, 0, 0, 1.0]))  # xyzw
    size: np.ndarray = field(default_factory=lambda: np.full(3, 0.04))
    color: Tuple[float, float, float] = (0.8, 0.2, 0.2)
    static: bool = False
    grasped_by: Optional[str] = None         # arm name when held

    def aabb(self) -> np.ndarray:
        half = self.size / 2
        return np.concatenate([self.position - half, self.position + half])


@dataclass
class ArmState:
    tcp_position: np.ndarray
    tcp_quaternion: np.ndarray = field(
        default_factory=lambda: np.array([0, 0, 0, 1.0]))
    gripper_open: float = 1.0
    joint_velocity_norm: float = 0.0          # drives keypoint 'stopped' heuristics
    base_position: np.ndarray = field(default_factory=lambda: np.zeros(3))


class SimBackend(abc.ABC):
    """What Scene/Task/ActionMode layers require of a simulator."""

    # axis-aligned reachable bounds (xmin, ymin, zmin, xmax, ymax, zmax);
    # backends override to their scene's limits — the environment's workspace
    # check and the camera rig read THIS, never a concrete backend's constant
    workspace = np.array([-0.45, -0.6, 0.55, 0.65, 0.6, 1.5], np.float32)

    @abc.abstractmethod
    def reset_arms(self) -> None:
        """Return both arms to their home poses, open grippers, drop grasps."""

    @abc.abstractmethod
    def add_object(self, obj: SceneObject) -> None: ...

    @abc.abstractmethod
    def get_object(self, name: str) -> SceneObject: ...

    @abc.abstractmethod
    def remove_all_objects(self) -> None: ...

    @abc.abstractmethod
    def arm(self, which: str) -> ArmState: ...

    @abc.abstractmethod
    def move_arm_towards(self, which: str, position, quaternion,
                         max_step: float) -> bool:
        """One control tick toward a pose; True when reached."""

    @abc.abstractmethod
    def set_gripper(self, which: str, open_amount: float) -> None: ...

    @abc.abstractmethod
    def step(self) -> None: ...


class KinematicBackend(SimBackend):
    def __init__(self, seed: int = 0):
        self._objects: Dict[str, SceneObject] = {}
        self._arms = {
            "right": ArmState(np.array([0.35, -0.35, 1.1]),
                              base_position=np.array([0.1, -0.55, 0.75])),
            "left": ArmState(np.array([0.35, 0.35, 1.1]),
                             base_position=np.array([0.1, 0.55, 0.75])),
        }
        self.rng = np.random.default_rng(seed)
        self.time = 0
        self.arm_collision = False

    # -- objects ---------------------------------------------------------------------

    def add_object(self, obj: SceneObject) -> None:
        self._objects[obj.name] = obj

    def get_object(self, name: str) -> SceneObject:
        return self._objects[name]

    def has_object(self, name: str) -> bool:
        return name in self._objects

    def object_names(self) -> List[str]:
        return list(self._objects)

    def remove_all_objects(self) -> None:
        self._objects.clear()

    # -- arms ------------------------------------------------------------------------

    def arm(self, which: str) -> ArmState:
        return self._arms[which]

    def reset_arms(self) -> None:
        self._arms["right"].tcp_position = np.array([0.35, -0.35, 1.1])
        self._arms["left"].tcp_position = np.array([0.35, 0.35, 1.1])
        for a in self._arms.values():
            a.tcp_quaternion = np.array([0.0, 0.0, 0.0, 1.0])
            a.gripper_open = 1.0
            a.joint_velocity_norm = 0.0
            # release anything held
        for o in self._objects.values():
            o.grasped_by = None
        self.arm_collision = False

    def move_arm_towards(self, which: str, position, quaternion,
                         max_step: float = 0.05) -> bool:
        a = self._arms[which]
        target = np.asarray(position, np.float64)
        delta = target - a.tcp_position
        dist = float(np.linalg.norm(delta))
        if dist <= max_step:
            a.tcp_position = target.copy()
            a.joint_velocity_norm = dist / max(max_step, 1e-9)
        else:
            a.tcp_position = a.tcp_position + delta / dist * max_step
            a.joint_velocity_norm = 1.0
        a.tcp_quaternion = normalize_quaternion_f32(quaternion)
        self._carry_grasped(which)
        return dist <= max_step

    # grasp model knobs: objects inside ENCLOSE_RADIUS are between the fingers
    # and grab regardless of orientation; out to GRASP_RADIUS the object must lie
    # within APPROACH_CONE_DEG of the tool approach axis (palm +z) — the
    # kinematic stand-in for Robotiq finger-contact geometry
    # (pyrep/robots/end_effectors/gripper.py grasp requires actuated touch).
    ENCLOSE_RADIUS = 0.02
    GRASP_RADIUS = 0.06
    APPROACH_CONE_DEG = 40.0

    @staticmethod
    def _approach_axis(quat_xyzw: np.ndarray) -> np.ndarray:
        """Tool +z axis in world frame (the palm direction; scripted grasps use
        DOWN = [0,1,0,0] whose approach axis is world -z)."""
        x, y, z, w = np.asarray(quat_xyzw, np.float64)
        return np.array([2 * (x * z + w * y), 2 * (y * z - w * x),
                         1.0 - 2 * (x * x + y * y)])

    def _graspable(self, a: ArmState, o: "ObjectState") -> bool:
        d = o.position - a.tcp_position
        dist = float(np.linalg.norm(d))
        if dist >= self.GRASP_RADIUS:
            return False
        if dist <= self.ENCLOSE_RADIUS:
            return True
        cos_angle = float(d @ self._approach_axis(a.tcp_quaternion)) / dist
        return cos_angle >= np.cos(np.deg2rad(self.APPROACH_CONE_DEG))

    def set_gripper(self, which: str, open_amount: float) -> None:
        a = self._arms[which]
        was_open = a.gripper_open >= 0.5
        a.gripper_open = float(np.clip(open_amount, 0.0, 1.0))
        if a.gripper_open < 0.5:
            if not was_open:
                return  # fingers already shut: closing again cannot contain anything
            if any(o.grasped_by == which for o in self._objects.values()):
                return  # already holding something; re-closing grabs nothing new
            # closing transition: grab the nearest free object that is within
            # range AND aligned with the approach axis (see _graspable)
            for o in sorted(self._objects.values(),
                            key=lambda o: np.linalg.norm(
                                o.position - a.tcp_position)):
                if o.static or o.grasped_by:
                    continue
                if self._graspable(a, o):
                    o.grasped_by = which
                    break
        else:
            for o in self._objects.values():
                if o.grasped_by == which:
                    o.grasped_by = None

    def _carry_grasped(self, which: str) -> None:
        a = self._arms[which]
        for o in self._objects.values():
            if o.grasped_by == which:
                o.position = a.tcp_position.copy()

    # TCP separation below which the two arms are considered collided — a
    # kinematic stand-in for arm-arm collision, which the dynamics-free backend
    # otherwise cannot produce (CoppeliaSim reports real contacts). Sticky for
    # the episode; reset_arms clears it.
    ARM_MIN_SEPARATION = 0.025

    def step(self) -> None:
        self.time += 1
        sep = float(np.linalg.norm(self._arms["right"].tcp_position
                                   - self._arms["left"].tcp_position))
        if sep < self.ARM_MIN_SEPARATION:
            self.arm_collision = True
        # decay stopped-ness when no command arrives
        for a in self._arms.values():
            a.joint_velocity_norm *= 0.5
