"""Extended task set: coordinated bimanual + classic single-arm RLBench tasks.

Counterparts of the broader ``rlbench/tasks/`` catalogue the reference ships
(111 task files): the coordinated two-arm family (lift_tray/push_box/lift_ball/
dual_push_buttons/put_bottle_in_fridge/take_tray_out_of_oven, in the spirit of the
bimanual PerAct task suite) and the classic single-arm tasks (push_button,
pick_up_cup, put_rubbish_in_bin, slide_block_to_target, stack_blocks,
take_lid_off_saucepan, reach_target). Geometry is simplified to the kinematic
backend's model; contracts (placement randomization, per-arm labeled waypoints,
success conditions, language variants) match the reference's task API.
"""

from __future__ import annotations

from typing import List

import numpy as np

from voxactb_tpu_torch.sim.backend import SceneObject
from voxactb_tpu_torch.sim.conditions import (
    DetectedCondition,
    GraspedCondition,
    GripperNearCondition,
    ObjectAboveCondition,
    ObjectDisplacedCondition,
)
from voxactb_tpu_torch.sim.task import (
    BimanualTask,
    Waypoint,
    sample_disjoint_position,
)
from voxactb_tpu_torch.sim.tasks import DOWN, TABLE_Z, HandOverItem, _assistive


# ---------------------------------------------------------------------------------
# coordinated bimanual family
# ---------------------------------------------------------------------------------


class CoordinatedLiftTray(BimanualTask):
    """Both arms grasp a tray handle each and lift the tray together."""

    name = "coordinated_lift_tray"
    num_variations = 2

    def init_task(self) -> None:
        pass

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        center = np.array([rng.uniform(0.25, 0.4), rng.uniform(-0.05, 0.05),
                           TABLE_Z + 0.02])
        half = 0.14
        self.backend.add_object(SceneObject(
            "tray", center, size=np.array([0.18, 0.3, 0.02]),
            color=(0.7, 0.5, 0.3), static=True))
        self.backend.add_object(SceneObject(
            "tray_handle_left", center + [0, half, 0.02],
            size=np.full(3, 0.03), color=(0.3, 0.3, 0.3)))
        self.backend.add_object(SceneObject(
            "tray_handle_right", center + [0, -half, 0.02],
            size=np.full(3, 0.03), color=(0.3, 0.3, 0.3)))
        self._dominant = "right" if variation % 2 == 0 else "left"
        self.register_success_conditions([
            ObjectAboveCondition("tray_handle_left", TABLE_Z + 0.15),
            ObjectAboveCondition("tray_handle_right", TABLE_Z + 0.15),
        ])
        return ["lift the tray with both hands"]

    def target_object_name(self):
        return "tray"

    def dominant_arm(self) -> str:
        return self._dominant

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        hl = self.backend.get_object("tray_handle_left")
        hr = self.backend.get_object("tray_handle_right")
        return [
            Waypoint("left", hl.position + [0, 0, 0.08], DOWN, 1.0,
                     label="approach_left_handle"),
            Waypoint("left", hl.position, DOWN, 0.0, label="grasp_left_handle"),
            Waypoint("right", hr.position + [0, 0, 0.08], DOWN, 1.0,
                     label="approach_right_handle"),
            Waypoint("right", hr.position, DOWN, 0.0, label="grasp_right_handle"),
            Waypoint("left", hl.position + [0, 0, 0.2], DOWN, None,
                     label="lift_left"),
            Waypoint("right", hr.position + [0, 0, 0.2], DOWN, None,
                     label="lift_right"),
        ]


class CoordinatedPushBox(BimanualTask):
    """Dominant arm drags the box across the table while the other braces it."""

    name = "coordinated_push_box"
    num_variations = 2

    def init_task(self) -> None:
        pass

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        start = np.array([rng.uniform(0.2, 0.3), rng.uniform(-0.1, 0.1),
                          TABLE_Z + 0.05])
        self.backend.add_object(SceneObject(
            "box", start, size=np.array([0.1, 0.1, 0.1]), color=(0.8, 0.4, 0.1)))
        self._dominant = "right" if variation % 2 == 0 else "left"
        self._start = start.copy()
        self.register_success_conditions([
            ObjectDisplacedCondition("box", self._start, 0.15, axis=0),
        ])
        return ["push the box across the table with both hands"]

    def target_object_name(self):
        return "box"

    def dominant_arm(self) -> str:
        return self._dominant

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        box = self.backend.get_object("box")
        a, d = _assistive(dominant_arm), dominant_arm
        goal = box.position + [0.2, 0, 0]
        side = 1.0 if a == "left" else -1.0
        return [
            Waypoint(a, box.position + [0, side * 0.12, 0.02], DOWN, 1.0,
                     label="brace_side"),
            Waypoint(d, box.position + [0, 0, 0.10], DOWN, 1.0,
                     label="approach_box"),
            Waypoint(d, box.position, DOWN, 0.0, label="grip_box"),
            Waypoint(d, goal, DOWN, None, label="push"),
            Waypoint(d, goal, DOWN, 1.0, dwell=4, label="release"),
        ]


class CoordinatedLiftBall(BimanualTask):
    """Dominant grasps the large ball, assistive supports it from the side."""

    name = "coordinated_lift_ball"
    num_variations = 2

    def init_task(self) -> None:
        pass

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        pos = np.array([rng.uniform(0.25, 0.4), rng.uniform(-0.1, 0.1),
                        TABLE_Z + 0.06])
        self.backend.add_object(SceneObject(
            "ball", pos, size=np.full(3, 0.11), color=(0.9, 0.1, 0.5)))
        self._dominant = "right" if variation % 2 == 0 else "left"
        self.register_success_conditions([
            ObjectAboveCondition("ball", TABLE_Z + 0.25),
            GraspedCondition("ball", self._dominant),
        ])
        return ["lift the big ball with both hands"]

    def target_object_name(self):
        return "ball"

    def dominant_arm(self) -> str:
        return self._dominant

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        ball = self.backend.get_object("ball")
        a, d = _assistive(dominant_arm), dominant_arm
        side = 1.0 if a == "left" else -1.0
        return [
            Waypoint(a, ball.position + [0, side * 0.1, 0.0], DOWN, 1.0,
                     label="support_side"),
            Waypoint(d, ball.position + [0, 0, 0.12], DOWN, 1.0,
                     label="approach_ball"),
            Waypoint(d, ball.position, DOWN, 0.0, label="grasp_ball"),
            Waypoint(d, ball.position + [0, 0, 0.3], DOWN, None, label="lift"),
        ]


class DualPushButtons(BimanualTask):
    """Each arm presses its own button simultaneously (dual_push_buttons)."""

    name = "dual_push_buttons"
    num_variations = 3

    COLORS = {0: ("red", (0.9, 0.1, 0.1)), 1: ("green", (0.1, 0.8, 0.1)),
              2: ("blue", (0.1, 0.1, 0.9))}

    def init_task(self) -> None:
        pass

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        cname, rgb = self.COLORS[variation % 3]
        x = rng.uniform(0.25, 0.4)
        self._left_pos = np.array([x, rng.uniform(0.15, 0.3), TABLE_Z + 0.02])
        self._right_pos = np.array([x, rng.uniform(-0.3, -0.15), TABLE_Z + 0.02])
        self.backend.add_object(SceneObject(
            "button_left", self._left_pos, size=np.full(3, 0.04), color=rgb,
            static=True))
        self.backend.add_object(SceneObject(
            "button_right", self._right_pos, size=np.full(3, 0.04), color=rgb,
            static=True))
        self._dominant = "right"
        self.register_success_conditions([
            GripperNearCondition("left", self._left_pos + [0, 0, 0.02], 0.06),
            GripperNearCondition("right", self._right_pos + [0, 0, 0.02], 0.06),
        ])
        return [f"push the two {cname} buttons at the same time"]

    def target_object_name(self):
        return "button_right"

    def dominant_arm(self) -> str:
        return self._dominant

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        return [
            Waypoint("left", self._left_pos + [0, 0, 0.08], DOWN, 0.0,
                     label="approach_left_button"),
            Waypoint("right", self._right_pos + [0, 0, 0.08], DOWN, 0.0,
                     label="approach_right_button"),
            Waypoint("left", self._left_pos + [0, 0, 0.02], DOWN, None, dwell=4,
                     label="press_left"),
            Waypoint("right", self._right_pos + [0, 0, 0.02], DOWN, None, dwell=4,
                     label="press_right"),
        ]


class CoordinatedPutBottleInFridge(BimanualTask):
    """Assistive holds the fridge door open; dominant puts the bottle inside."""

    name = "coordinated_put_bottle_in_fridge"
    num_variations = 2

    def init_task(self) -> None:
        pass

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        fridge = np.array([rng.uniform(0.35, 0.45), rng.uniform(-0.05, 0.05),
                           TABLE_Z + 0.2])
        self.backend.add_object(SceneObject(
            "fridge", fridge, size=np.array([0.2, 0.25, 0.4]),
            color=(0.85, 0.85, 0.9), static=True))
        door_side = -1.0 if variation % 2 == 0 else 1.0
        self.backend.add_object(SceneObject(
            "fridge_door_handle", fridge + [-0.12, door_side * 0.12, 0.0],
            size=np.full(3, 0.03), color=(0.4, 0.4, 0.4)))
        bottle = np.array([rng.uniform(0.15, 0.25),
                           -door_side * rng.uniform(0.2, 0.35), TABLE_Z + 0.06])
        self.backend.add_object(SceneObject(
            "bottle", bottle, size=np.array([0.05, 0.05, 0.14]),
            color=(0.2, 0.6, 0.2)))
        self._dominant = "right" if door_side > 0 else "left"
        self._fridge_center = fridge
        self.register_success_conditions([
            DetectedCondition("bottle", fridge, np.array([0.12, 0.14, 0.22])),
        ])
        d = self._dominant
        return [f"hold the fridge door with {_assistive(d)} hand and put the "
                f"bottle in the fridge with {d} hand"]

    def target_object_name(self):
        return "bottle"

    def dominant_arm(self) -> str:
        return self._dominant

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        handle = self.backend.get_object("fridge_door_handle")
        bottle = self.backend.get_object("bottle")
        a, d = _assistive(dominant_arm), dominant_arm
        inside = self._fridge_center + [-0.02, 0, -0.05]
        return [
            Waypoint(a, handle.position + [0, 0, 0.08], DOWN, 1.0,
                     label="approach_door"),
            Waypoint(a, handle.position, DOWN, 0.0, label="grasp_door"),
            Waypoint(a, handle.position + [-0.1, 0, 0], DOWN, None,
                     label="open_door"),
            Waypoint(d, bottle.position + [0, 0, 0.12], DOWN, 1.0,
                     label="approach_bottle"),
            Waypoint(d, bottle.position, DOWN, 0.0, label="grasp_bottle"),
            Waypoint(d, inside + [0, 0, 0.1], DOWN, None, label="carry"),
            Waypoint(d, inside, DOWN, 1.0, dwell=4, label="place_inside"),
        ]


class CoordinatedTakeTrayOutOfOven(BimanualTask):
    """Assistive holds the oven door down; dominant pulls the tray out."""

    name = "coordinated_take_tray_out_of_oven"
    num_variations = 2

    def init_task(self) -> None:
        pass

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        oven = np.array([rng.uniform(0.35, 0.45), rng.uniform(-0.05, 0.05),
                         TABLE_Z + 0.15])
        self.backend.add_object(SceneObject(
            "oven", oven, size=np.array([0.25, 0.3, 0.3]), color=(0.2, 0.2, 0.2),
            static=True))
        self.backend.add_object(SceneObject(
            "oven_door_handle", oven + [-0.15, 0, -0.05], size=np.full(3, 0.03),
            color=(0.6, 0.6, 0.6)))
        tray = oven + [-0.05, 0.0, 0.0]
        self.backend.add_object(SceneObject(
            "oven_tray", tray, size=np.array([0.15, 0.2, 0.02]),
            color=(0.7, 0.7, 0.75)))
        self._dominant = "right" if variation % 2 == 0 else "left"
        self._tray_start = tray.copy()
        self.register_success_conditions([
            ObjectDisplacedCondition("oven_tray", self._tray_start, 0.15, axis=0),
        ])
        d = self._dominant
        return [f"hold the oven door with {_assistive(d)} hand and take the tray "
                f"out of the oven with {d} hand"]

    def target_object_name(self):
        return "oven_tray"

    def dominant_arm(self) -> str:
        return self._dominant

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        handle = self.backend.get_object("oven_door_handle")
        tray = self.backend.get_object("oven_tray")
        a, d = _assistive(dominant_arm), dominant_arm
        return [
            Waypoint(a, handle.position + [0, 0, 0.08], DOWN, 1.0,
                     label="approach_door"),
            Waypoint(a, handle.position, DOWN, 0.0, label="hold_door"),
            Waypoint(d, tray.position + [0, 0, 0.10], DOWN, 1.0,
                     label="approach_tray"),
            Waypoint(d, tray.position, DOWN, 0.0, label="grasp_tray"),
            Waypoint(d, tray.position + [-0.2, 0, 0.02], DOWN, None,
                     label="pull_out"),
        ]


class HandOverItemEasy(HandOverItem):
    """Hand-over with a fixed central item spawn (the 'easy' curriculum cut)."""

    name = "hand_over_item_easy"
    num_variations = 2

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        side = -1.0 if variation % 2 == 0 else 1.0
        item_pos = np.array([0.3, side * 0.25, TABLE_Z + 0.02])
        self.backend.add_object(SceneObject(
            "cube", item_pos, size=np.full(3, 0.05), color=(0.9, 0.2, 0.9)))
        self._dominant = "left" if side < 0 else "right"
        self.register_success_conditions([
            GraspedCondition("cube", self._dominant),
        ])
        d = self._dominant
        return [f"pass the item from the {_assistive(d)} hand to the {d} hand"]


class BimanualPickPlate(BimanualTask):
    """Dominant lifts the plate off the stand while the other steadies the stand."""

    name = "bimanual_pick_plate"
    num_variations = 2

    def init_task(self) -> None:
        pass

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        stand = np.array([rng.uniform(0.25, 0.4), rng.uniform(-0.1, 0.1),
                          TABLE_Z + 0.03])
        self.backend.add_object(SceneObject(
            "stand", stand, size=np.array([0.12, 0.12, 0.06]),
            color=(0.4, 0.4, 0.45), static=True))
        self.backend.add_object(SceneObject(
            "plate", stand + [0, 0, 0.05], size=np.array([0.16, 0.16, 0.02]),
            color=(0.95, 0.95, 0.95)))
        self._dominant = "right" if variation % 2 == 0 else "left"
        self.register_success_conditions([
            ObjectAboveCondition("plate", TABLE_Z + 0.2),
            GraspedCondition("plate", self._dominant),
        ])
        d = self._dominant
        return [f"steady the stand with {_assistive(d)} hand and pick up the "
                f"plate with {d} hand"]

    def target_object_name(self):
        return "plate"

    def dominant_arm(self) -> str:
        return self._dominant

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        stand = self.backend.get_object("stand")
        plate = self.backend.get_object("plate")
        a, d = _assistive(dominant_arm), dominant_arm
        side = 1.0 if a == "left" else -1.0
        return [
            Waypoint(a, stand.position + [0, side * 0.1, 0.02], DOWN, 1.0,
                     label="steady_stand"),
            Waypoint(d, plate.position + [0, 0, 0.1], DOWN, 1.0,
                     label="approach_plate"),
            Waypoint(d, plate.position, DOWN, 0.0, label="grasp_plate"),
            Waypoint(d, plate.position + [0, 0, 0.25], DOWN, None, label="lift"),
        ]


# ---------------------------------------------------------------------------------
# classic single-arm tasks (rlbench/tasks/*.py equivalents)
# ---------------------------------------------------------------------------------


class _SingleArmTask(BimanualTask):
    bimanual = False

    def init_task(self) -> None:
        pass

    def dominant_arm(self) -> str:
        return "right"


class PushButton(_SingleArmTask):
    """Press the button (rlbench/tasks/push_button.py; 3 color variations)."""

    name = "push_button"
    num_variations = 3

    COLORS = {0: ("red", (0.9, 0.1, 0.1)), 1: ("green", (0.1, 0.8, 0.1)),
              2: ("blue", (0.1, 0.1, 0.9))}

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        cname, rgb = self.COLORS[variation % 3]
        self._pos = np.array([rng.uniform(0.2, 0.45), rng.uniform(-0.3, 0.3),
                              TABLE_Z + 0.02])
        self.backend.add_object(SceneObject(
            "button", self._pos, size=np.full(3, 0.04), color=rgb, static=True))
        self.register_success_conditions([
            GripperNearCondition("right", self._pos + [0, 0, 0.02], 0.06),
        ])
        return [f"push the {cname} button"]

    def target_object_name(self):
        return "button"

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        return [
            Waypoint("right", self._pos + [0, 0, 0.1], DOWN, 0.0,
                     label="approach_button"),
            Waypoint("right", self._pos + [0, 0, 0.02], DOWN, None, dwell=4,
                     label="press"),
        ]


class PickUpCup(_SingleArmTask):
    """Grasp the cup and lift it (rlbench/tasks/pick_up_cup.py)."""

    name = "pick_up_cup"
    num_variations = 2

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        pos = np.array([rng.uniform(0.2, 0.45), rng.uniform(-0.3, 0.3),
                        TABLE_Z + 0.05])
        self.backend.add_object(SceneObject(
            "cup", pos, size=np.array([0.06, 0.06, 0.1]), color=(0.9, 0.3, 0.1)))
        self.register_success_conditions([
            ObjectAboveCondition("cup", TABLE_Z + 0.25),
            GraspedCondition("cup", "right"),
        ])
        return ["pick up the cup"]

    def target_object_name(self):
        return "cup"

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        cup = self.backend.get_object("cup")
        return [
            Waypoint("right", cup.position + [0, 0, 0.12], DOWN, 1.0,
                     label="approach_cup"),
            Waypoint("right", cup.position, DOWN, 0.0, label="grasp_cup"),
            Waypoint("right", cup.position + [0, 0, 0.3], DOWN, None,
                     label="lift_cup"),
        ]


class PutRubbishInBin(_SingleArmTask):
    """Drop the rubbish into the bin (rlbench/tasks/put_rubbish_in_bin.py)."""

    name = "put_rubbish_in_bin"
    num_variations = 2

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        bin_pos = np.array([rng.uniform(0.3, 0.45), rng.uniform(-0.35, -0.2),
                            TABLE_Z + 0.08])
        self.backend.add_object(SceneObject(
            "bin", bin_pos, size=np.array([0.12, 0.12, 0.16]),
            color=(0.3, 0.3, 0.3), static=True))
        # collision-checked spawn (SpawnBoundary.sample semantics)
        rubbish = sample_disjoint_position(
            self.backend, rng, [0.2, -0.35, TABLE_Z + 0.02],
            [0.45, 0.3, TABLE_Z + 0.02], np.full(3, 0.03))
        self.backend.add_object(SceneObject(
            "rubbish", rubbish, size=np.full(3, 0.03), color=(0.6, 0.6, 0.5)))
        self._bin = bin_pos
        self.register_success_conditions([
            DetectedCondition("rubbish", bin_pos + [0, 0, 0.04],
                              np.array([0.08, 0.08, 0.12])),
        ])
        return ["put the rubbish in the bin"]

    def target_object_name(self):
        return "rubbish"

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        rubbish = self.backend.get_object("rubbish")
        drop = self._bin + [0, 0, 0.14]
        return [
            Waypoint("right", rubbish.position + [0, 0, 0.1], DOWN, 1.0,
                     label="approach_rubbish"),
            Waypoint("right", rubbish.position, DOWN, 0.0, label="grasp_rubbish"),
            Waypoint("right", drop, DOWN, None, label="carry_to_bin"),
            Waypoint("right", drop, DOWN, 1.0, dwell=5, label="drop"),
        ]


class SlideBlockToTarget(_SingleArmTask):
    """Slide the block onto the target square (rlbench/tasks/slide_block_to_target.py)."""

    name = "slide_block_to_target"
    num_variations = 2

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        block = np.array([rng.uniform(0.2, 0.3), rng.uniform(-0.2, 0.2),
                          TABLE_Z + 0.03])
        target = block + [rng.uniform(0.1, 0.18),
                          rng.uniform(-0.1, 0.1), 0.0]
        self.backend.add_object(SceneObject(
            "block", block, size=np.full(3, 0.05), color=(0.9, 0.1, 0.1)))
        self.backend.add_object(SceneObject(
            "target", target - [0, 0, 0.025], size=np.array([0.1, 0.1, 0.005]),
            color=(0.1, 0.9, 0.1), static=True))
        self._target = target
        self.register_success_conditions([
            DetectedCondition("block", target, np.array([0.06, 0.06, 0.06])),
        ])
        return ["slide the block to the green target"]

    def target_object_name(self):
        return "block"

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        block = self.backend.get_object("block")
        return [
            Waypoint("right", block.position + [0, 0, 0.1], DOWN, 1.0,
                     label="approach_block"),
            Waypoint("right", block.position, DOWN, 0.0, label="grip_block"),
            Waypoint("right", self._target, DOWN, None, label="slide"),
            Waypoint("right", self._target, DOWN, 1.0, dwell=4, label="release"),
        ]


class StackBlocks(_SingleArmTask):
    """Stack the red block on the base block (rlbench/tasks/stack_blocks.py cut
    to one pick-place)."""

    name = "stack_blocks"
    num_variations = 2

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        base = np.array([rng.uniform(0.3, 0.4), rng.uniform(-0.1, 0.1),
                         TABLE_Z + 0.03])
        self.backend.add_object(SceneObject(
            "base_block", base, size=np.full(3, 0.05), color=(0.2, 0.9, 0.2),
            static=True))
        block = sample_disjoint_position(
            self.backend, rng, [0.15, -0.3, TABLE_Z + 0.03],
            [0.45, 0.3, TABLE_Z + 0.03], np.full(3, 0.05))
        self.backend.add_object(SceneObject(
            "red_block", block, size=np.full(3, 0.05), color=(0.9, 0.1, 0.1)))
        self._base = base
        self.register_success_conditions([
            DetectedCondition("red_block", base + [0, 0, 0.05],
                              np.array([0.05, 0.05, 0.05])),
        ])
        return ["stack the red block on the green block"]

    def target_object_name(self):
        return "red_block"

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        block = self.backend.get_object("red_block")
        place = self._base + [0, 0, 0.06]
        return [
            Waypoint("right", block.position + [0, 0, 0.1], DOWN, 1.0,
                     label="approach_block"),
            Waypoint("right", block.position, DOWN, 0.0, label="grasp_block"),
            Waypoint("right", place + [0, 0, 0.08], DOWN, None, label="carry"),
            Waypoint("right", place, DOWN, 1.0, dwell=4, label="place"),
        ]


class TakeLidOffSaucepan(_SingleArmTask):
    """Lift the lid off the saucepan (rlbench/tasks/take_lid_off_saucepan.py)."""

    name = "take_lid_off_saucepan"
    num_variations = 2

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        pan = np.array([rng.uniform(0.25, 0.4), rng.uniform(-0.15, 0.15),
                        TABLE_Z + 0.04])
        self.backend.add_object(SceneObject(
            "saucepan", pan, size=np.array([0.14, 0.14, 0.08]),
            color=(0.3, 0.3, 0.35), static=True))
        self.backend.add_object(SceneObject(
            "lid", pan + [0, 0, 0.06], size=np.array([0.15, 0.15, 0.02]),
            color=(0.7, 0.7, 0.75)))
        self.register_success_conditions([
            ObjectAboveCondition("lid", TABLE_Z + 0.25),
            GraspedCondition("lid", "right"),
        ])
        return ["take the lid off the saucepan"]

    def target_object_name(self):
        return "lid"

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        lid = self.backend.get_object("lid")
        return [
            Waypoint("right", lid.position + [0, 0, 0.1], DOWN, 1.0,
                     label="approach_lid"),
            Waypoint("right", lid.position, DOWN, 0.0, label="grasp_lid"),
            Waypoint("right", lid.position + [0, 0, 0.3], DOWN, None,
                     label="lift_lid"),
        ]


class ReachTarget(_SingleArmTask):
    """Touch the target sphere (rlbench/tasks/reach_target.py)."""

    name = "reach_target"
    num_variations = 3

    COLORS = {0: ("red", (0.9, 0.1, 0.1)), 1: ("green", (0.1, 0.8, 0.1)),
              2: ("blue", (0.1, 0.1, 0.9))}

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        cname, rgb = self.COLORS[variation % 3]
        self._pos = np.array([rng.uniform(0.2, 0.45), rng.uniform(-0.3, 0.3),
                              TABLE_Z + rng.uniform(0.1, 0.3)])
        self.backend.add_object(SceneObject(
            "target_sphere", self._pos, size=np.full(3, 0.05), color=rgb,
            static=True))
        self.register_success_conditions([
            GripperNearCondition("right", self._pos, 0.06),
        ])
        return [f"reach the {cname} target"]

    def target_object_name(self):
        return "target_sphere"

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        return [
            Waypoint("right", self._pos + [0, 0, 0.12], DOWN, 1.0,
                     label="approach"),
            Waypoint("right", self._pos, DOWN, None, dwell=4, label="touch"),
        ]


EXTRA_TASKS = (
    CoordinatedLiftTray, CoordinatedPushBox, CoordinatedLiftBall,
    DualPushButtons, CoordinatedPutBottleInFridge, CoordinatedTakeTrayOutOfOven,
    HandOverItemEasy, BimanualPickPlate,
    PushButton, PickUpCup, PutRubbishInBin, SlideBlockToTarget, StackBlocks,
    TakeLidOffSaucepan, ReachTarget,
)
