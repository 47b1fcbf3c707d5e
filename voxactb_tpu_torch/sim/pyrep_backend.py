"""SimBackend adapter over PyRep/CoppeliaSim (used when the simulator is installed).

The reference's L0 is PyRep's cffi binding over libcoppeliaSim (SURVEY §1,
PyRep/pyrep/pyrep.py:18 lifecycle; objects/shape.py; robots/arms/arm.py RRT paths).
This adapter implements the same ``SimBackend`` protocol the kinematic backend does,
so every layer above (tasks, scene, action modes, demo recording, validators) runs
unchanged against the real simulator: objects map to PyRep Shapes, arms execute via
``get_path`` (RRT-Connect) stepped through ``pyrep.step()``, grippers actuate and
grasp via PyRep's gripper API.

Everything is gated on ``import pyrep`` succeeding; this module imports cleanly (and
reports availability) in environments without CoppeliaSim.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from voxactb_tpu_torch.sim.backend import ArmState, SceneObject, SimBackend


def pyrep_available() -> bool:
    try:
        import pyrep  # noqa: F401

        return True
    except ImportError:
        return False


class PyRepBackend(SimBackend):
    """Real-simulator backend. Requires CoppeliaSim + PyRep at runtime.

    Args:
      scene_file: a .ttt scene containing two Panda arms named
        ``Panda_rightArm`` / ``Panda_leftArm`` with grippers (the naming used by the
        two-robot scenes, environments_two_robots.py:29-160).
      headless: run CoppeliaSim without a UI.
    """

    def __init__(self, scene_file: str, headless: bool = True,
                 arm_names: Optional[Dict[str, str]] = None):
        if not pyrep_available():
            raise RuntimeError(
                "PyRepBackend needs CoppeliaSim + PyRep installed; use "
                "KinematicBackend otherwise")
        from pyrep import PyRep
        from pyrep.robots.arms.panda import Panda
        from pyrep.robots.end_effectors.panda_gripper import PandaGripper

        self._pr = PyRep()
        self._pr.launch(scene_file, headless=headless)
        self._pr.start()

        names = arm_names or {"right": 0, "left": 1}
        self._arms_sim = {}
        self._grippers = {}
        for arm, count in names.items():
            self._arms_sim[arm] = Panda(count)
            self._grippers[arm] = PandaGripper(count)
        self._objects: Dict[str, object] = {}
        self._grasped: Dict[str, Optional[str]] = {}
        self._paths = {a: None for a in names}
        # home configuration for reset_arms (Scene2Robots restores the arms'
        # starting joint state between episodes)
        self._home_joints = {a: arm.get_joint_positions()
                             for a, arm in self._arms_sim.items()}

    # -- objects -------------------------------------------------------------------

    def add_object(self, obj: SceneObject) -> None:
        from pyrep.objects.shape import Shape
        from pyrep.const import PrimitiveShape

        shape = Shape.create(
            type=PrimitiveShape.CUBOID, size=list(obj.size),
            color=list(obj.color), static=obj.static, respondable=True)
        shape.set_position(list(obj.position))
        shape.set_quaternion(list(obj.quaternion))
        shape.set_name(obj.name)
        self._objects[obj.name] = shape
        self._grasped[obj.name] = None

    def get_object(self, name: str) -> SceneObject:
        shape = self._objects[name]
        return SceneObject(
            name=name,
            position=np.asarray(shape.get_position()),
            quaternion=np.asarray(shape.get_quaternion()),
            size=np.asarray(shape.get_bounding_box()[1::2]) * 2
            if hasattr(shape, "get_bounding_box") else np.full(3, 0.04),
            grasped_by=self._grasped.get(name),
        )

    def has_object(self, name: str) -> bool:
        return name in self._objects

    def object_names(self) -> List[str]:
        return list(self._objects)

    def remove_all_objects(self) -> None:
        for shape in self._objects.values():
            shape.remove()
        self._objects.clear()
        self._grasped.clear()

    # -- arms ----------------------------------------------------------------------

    def reset_arms(self) -> None:
        for which, sim_arm in self._arms_sim.items():
            self._paths[which] = None
            self._grippers[which].release()
            sim_arm.set_joint_positions(self._home_joints[which],
                                        disable_dynamics=True)
            while not self._grippers[which].actuate(1.0, velocity=0.2):
                self._pr.step()
        self._grasped = {k: None for k in self._grasped}

    def arm(self, which: str) -> ArmState:
        sim_arm = self._arms_sim[which]
        tip = sim_arm.get_tip()
        vel = np.asarray(sim_arm.get_joint_velocities())
        return ArmState(
            tcp_position=np.asarray(tip.get_position()),
            tcp_quaternion=np.asarray(tip.get_quaternion()),
            gripper_open=1.0 - float(self._grippers[which].get_open_amount()[0]
                                     < 0.5),
            joint_velocity_norm=float(np.abs(vel).max()),
        )

    def move_arm_towards(self, which: str, position, quaternion,
                         max_step: float = 0.05) -> bool:
        """One control tick: (re)plan an RRT path if needed, step it once
        (arm_action_modes.py:388-435 behavior)."""
        sim_arm = self._arms_sim[which]
        if self._paths[which] is None:
            try:
                self._paths[which] = sim_arm.get_path(
                    position=list(position), quaternion=list(quaternion))
            except Exception:
                self._paths[which] = sim_arm.get_linear_path(
                    position=list(position), quaternion=list(quaternion))
        done = self._paths[which].step()
        self._pr.step()
        if done:
            self._paths[which] = None
        return bool(done)

    def set_gripper(self, which: str, open_amount: float) -> None:
        gripper = self._grippers[which]
        while not gripper.actuate(float(np.clip(open_amount, 0, 1)),
                                  velocity=0.2):
            self._pr.step()
        if open_amount < 0.5:
            for name, shape in self._objects.items():
                if gripper.grasp(shape):
                    self._grasped[name] = which
                    break
        else:
            for name, holder in self._grasped.items():
                if holder == which:
                    gripper.release()
                    self._grasped[name] = None

    def step(self) -> None:
        self._pr.step()

    def shutdown(self) -> None:
        self._pr.stop()
        self._pr.shutdown()
