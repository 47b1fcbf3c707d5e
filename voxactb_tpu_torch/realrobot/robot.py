"""UR robot control: motion commands over the monitors + bimanual composition.

Counterpart of urx's ``URRobot``/``Robot`` (urx/urrobot.py, urx/robot.py:18 — pose
math via math3d there; plain 4x4 numpy here) and the bimanual pair
``CB2BimanualRobot`` (peract/eval_real.py:365-411). Motion commands format URScript
(realrobot/urscript.py) and ship over the secondary monitor; completion is detected by
joint/TCP convergence from the realtime monitor — the reference's wait loop.

A copy of ``voxactb_tpu.realrobot.robot``, kept in the port so that it imports nothing
of the JAX package; host code, the same on every device.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
from scipy.spatial.transform import Rotation

from voxactb_tpu_torch.ops import geometry as G  # noqa: F401  (quaternion helpers for users)
from voxactb_tpu_torch.realrobot import urscript as urs
from voxactb_tpu_torch.realrobot.monitor import RealtimeMonitor, SecondaryMonitor


def quat_to_axis_angle(quat_xyzw: np.ndarray) -> np.ndarray:
    """xyzw quaternion -> UR axis-angle rotation vector."""
    q = np.asarray(quat_xyzw, np.float64)
    q = q / np.linalg.norm(q)
    if q[3] < 0:
        q = -q
    angle = 2.0 * np.arccos(np.clip(q[3], -1.0, 1.0))
    s = np.sqrt(max(1.0 - q[3] * q[3], 1e-12))
    axis = q[:3] / s if s > 1e-6 else np.array([1.0, 0.0, 0.0])
    return axis * angle


def axis_angle_to_quat(rv: np.ndarray) -> np.ndarray:
    rv = np.asarray(rv, np.float64)
    angle = np.linalg.norm(rv)
    if angle < 1e-12:
        return np.array([0.0, 0.0, 0.0, 1.0])
    axis = rv / angle
    return np.concatenate([axis * np.sin(angle / 2), [np.cos(angle / 2)]])


class URRobot:
    """One UR arm: URScript dispatch + state, with blocking motion helpers."""

    def __init__(self, host: str, secondary_port: Optional[int] = None,
                 realtime_port: Optional[int] = None, use_rt: bool = True):
        self.host = host
        self.secmon = SecondaryMonitor(host, secondary_port)
        self.rtmon = RealtimeMonitor(host, realtime_port) if use_rt else None
        self.csys = np.eye(4)  # user coordinate system (robot.py csys behavior)

    # -- low level -------------------------------------------------------------------

    def send_program(self, prog: str) -> None:
        self.secmon.send_program(prog)

    def getj(self) -> np.ndarray:
        if self.rtmon is not None:
            return self.rtmon.q_actual()
        return self.secmon.get_state().joint_positions

    def get_pose(self) -> np.ndarray:
        """TCP pose [x y z rx ry rz] in the user csys (urx robot.py semantics:
        the csys maps the FULL pose, orientation included)."""
        raw = (self.rtmon.tcp_pose() if self.rtmon is not None
               else self.secmon.get_state().tcp_pose)
        inv = np.linalg.inv(self.csys)
        t = inv @ np.concatenate([raw[:3], [1.0]])
        rot = Rotation.from_matrix(inv[:3, :3]) * Rotation.from_rotvec(raw[3:])
        return np.concatenate([t[:3], rot.as_rotvec()])

    def set_csys(self, transform_4x4: np.ndarray) -> None:
        self.csys = np.asarray(transform_4x4, np.float64)

    def set_tcp(self, pose6: Sequence[float]) -> None:
        self.send_program(urs.set_tcp(pose6))

    def set_payload(self, weight: float, cog=(0, 0, 0)) -> None:
        self.send_program(urs.set_payload(weight, cog))

    # -- motion ----------------------------------------------------------------------

    def _to_base(self, pose6: Sequence[float]) -> np.ndarray:
        p = np.asarray(pose6, np.float64)
        t = self.csys @ np.concatenate([p[:3], [1.0]])
        rot = Rotation.from_matrix(self.csys[:3, :3]) \
            * Rotation.from_rotvec(p[3:])
        return np.concatenate([t[:3], rot.as_rotvec()])

    def movel(self, pose6: Sequence[float], acc=0.01, vel=0.01, wait=True,
              timeout=30.0, tol=5e-3) -> None:
        base = self._to_base(pose6)
        self.send_program(urs.movel(base, acc, vel))
        if wait:
            self._wait_tcp(base, timeout, tol)

    def movej(self, joints: Sequence[float], acc=0.1, vel=0.05, wait=True,
              timeout=30.0, tol=1e-2) -> None:
        self.send_program(urs.movej(joints, acc, vel))
        if wait:
            self._wait_joints(np.asarray(joints), timeout, tol)

    def speedl(self, velocities, acc=0.01, min_time=1.0) -> None:
        self.send_program(urs.speedl(velocities, acc, min_time))

    def stopl(self, acc: float = 0.5) -> None:
        self.send_program(urs.stopl(acc))

    def _wait_tcp(self, target6, timeout, tol, rot_tol=2e-2) -> None:
        target6 = np.asarray(target6)
        tq = axis_angle_to_quat(target6[3:])
        deadline = time.time() + timeout
        while time.time() < deadline:
            raw = (self.rtmon.tcp_pose() if self.rtmon is not None
                   else self.secmon.get_state().tcp_pose)
            # both position AND orientation must converge: a rotation-dominant
            # movel (e.g. the open-jar unscrew twist) is otherwise declared
            # done instantly and the next program preempts it mid-rotation
            ang = 2.0 * np.arccos(np.clip(
                abs(float(np.dot(axis_angle_to_quat(raw[3:]), tq))), 0.0, 1.0))
            if np.linalg.norm(raw[:3] - target6[:3]) < tol and ang < rot_tol:
                return
            time.sleep(0.01)
        raise TimeoutError(f"movel did not converge to {target6[:3]}")

    def _wait_joints(self, target, timeout, tol) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if np.abs(self.getj() - target).max() < tol:
                return
            time.sleep(0.01)
        raise TimeoutError("movej did not converge")

    # -- gripper (Robotiq two-finger over the controller) -------------------------------

    def gripper_activate(self) -> None:
        self.send_program(urs.robotiq_activate())

    def gripper_set(self, open_amount: float, wait: bool = True,
                    settle_s: float = 1.0) -> None:
        """1.0 = fully open, 0.0 = fully closed. ``wait`` blocks for the finger
        travel time — the Robotiq program has no completion feedback over this
        channel, and the NEXT program load would preempt it mid-actuation
        (urx sleeps after gripper commands for the same reason)."""
        pos = int(round((1.0 - float(np.clip(open_amount, 0, 1))) * 255))
        self.send_program(urs.robotiq_set_position(pos))
        if wait:
            time.sleep(settle_s)

    def close(self) -> None:
        self.secmon.close()
        if self.rtmon is not None:
            self.rtmon.close()


class BimanualURRobot:
    """Two UR arms behind one facade (eval_real.py:365-411 CB2BimanualRobot)."""

    def __init__(self, right: URRobot, left: URRobot):
        self.right = right
        self.left = left

    @classmethod
    def connect(cls, right_host: str, left_host: str, **kw) -> "BimanualURRobot":
        return cls(URRobot(right_host, **kw), URRobot(left_host, **kw))

    def arm(self, which: str) -> URRobot:
        return self.right if which == "right" else self.left

    def move_arm(self, which: str, position, quat_xyzw, gripper_open: float,
                 acc=0.1, vel=0.1, wait=True) -> None:
        """The eval_real action application: position + quaternion + grip
        (eval_real.py:702-788 move_robot condensed)."""
        rv = quat_to_axis_angle(quat_xyzw)
        pose6 = np.concatenate([np.asarray(position, np.float64), rv])
        robot = self.arm(which)
        robot.movel(pose6, acc=acc, vel=vel, wait=wait)
        robot.gripper_set(gripper_open, wait=wait)

    def observation(self) -> dict:
        """Sim-proprio-shaped state (eval_real.py:267-364 UR5Robot.get_obs)."""
        out = {}
        for name, robot in (("right", self.right), ("left", self.left)):
            pose6 = robot.get_pose()
            quat = axis_angle_to_quat(pose6[3:])
            out[f"gripper_{name}_pose"] = np.concatenate([pose6[:3], quat])
            out[f"joint_positions_{name}"] = robot.getj()
        return out

    def close(self) -> None:
        self.right.close()
        self.left.close()
