"""Broad task catalogue: press / pick-lift / pick-place / slide / hinge families.

Counterparts of the classic single-arm RLBench catalogue (rlbench/tasks/ — 111
formulaic task files built from a small vocabulary of waypoint patterns and
success conditions). Each family base reproduces one recurring recipe:

- ``_PressTask``           press_switch.py, lamp_on.py, tv_on.py style
- ``_PickLiftTask``        pick_and_lift.py, take_usb_out_of_computer.py style
- ``_PickPlaceTask``       phone_on_base.py, put_money_in_safe.py style
- ``_SlideTask``           slide_block_to_color_target.py, reach_and_drag.py style
- ``_HingeTask``           open_box.py, open_door.py, close_microwave.py style

Subclasses are scene recipes: objects, placement ranges, language variants and
success geometry. The kinematic backend supplies grasp/move dynamics; demos are
scripted labeled waypoints (the per-task recorders of scene_two_robots.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from voxactb_tpu_torch.sim.backend import SceneObject
from voxactb_tpu_torch.sim.conditions import (
    DetectedCondition,
    GraspedCondition,
    GripperNearCondition,
    ObjectAboveCondition,
    ObjectDisplacedCondition,
)
from voxactb_tpu_torch.sim.task import BimanualTask, Waypoint, sample_disjoint_position

# duplicated from tasks.py (importing them back would be circular: tasks.py's
# registry tail imports this module)
TABLE_Z = 0.76
DOWN = np.array([0.0, 1.0, 0.0, 0.0])  # gripper pointing down (xyzw)

COLORS = {
    "red": (0.9, 0.1, 0.1), "green": (0.1, 0.8, 0.1), "blue": (0.1, 0.1, 0.9),
    "yellow": (0.9, 0.9, 0.1), "white": (0.95, 0.95, 0.95),
    "black": (0.05, 0.05, 0.05), "gray": (0.5, 0.5, 0.5),
    "orange": (0.95, 0.55, 0.1), "purple": (0.6, 0.2, 0.8),
    "brown": (0.55, 0.35, 0.15),
}


class _CatalogueTask(BimanualTask):
    bimanual = False

    def init_task(self) -> None:
        pass

    def dominant_arm(self) -> str:
        return "right"


# -----------------------------------------------------------------------------------
# press family: approach a fixture and touch its actuation point
# -----------------------------------------------------------------------------------


class _PressTask(_CatalogueTask):
    """Move to a static fixture and press its actuation point (press_switch.py
    recipe: waypoint above the switch, then a touch waypoint; success is a
    proximity sensor on the tip)."""

    fixture_size = (0.05, 0.05, 0.05)
    fixture_color = (0.5, 0.5, 0.5)
    press_offset = (0.0, 0.0, 0.03)     # actuation point relative to fixture center
    languages: Sequence[str] = ()       # one per variation
    num_variations = 1

    def fixture_position(self, rng) -> np.ndarray:
        return np.array([rng.uniform(0.2, 0.45), rng.uniform(-0.3, 0.3),
                         TABLE_Z + self.fixture_size[2] / 2])

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        self._pos = self.fixture_position(rng)
        self.backend.add_object(SceneObject(
            "fixture", self._pos, size=np.asarray(self.fixture_size),
            color=self.fixture_color, static=True))
        self._press = self._pos + np.asarray(self.press_offset)
        self.register_success_conditions([
            GripperNearCondition("right", self._press, 0.06),
        ])
        langs = list(self.languages) or [f"press the {self.name.replace('_', ' ')}"]
        return [langs[variation % len(langs)]]

    def target_object_name(self):
        return "fixture"

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        return [
            Waypoint("right", self._press + [0, 0, 0.1], DOWN, 0.0,
                     label="approach"),
            Waypoint("right", self._press, DOWN, None, dwell=4, label="press"),
        ]


class LampOn(_PressTask):
    """rlbench/tasks/lamp_on.py — press the button at the lamp base."""

    name = "lamp_on"
    fixture_size = (0.08, 0.08, 0.16)
    fixture_color = (0.9, 0.85, 0.5)
    press_offset = (0.06, 0.0, -0.05)
    languages = ("turn on the light", "press the button to light the lamp")
    num_variations = 2


class LampOff(_PressTask):
    name = "lamp_off"
    fixture_size = (0.08, 0.08, 0.16)
    fixture_color = (0.9, 0.85, 0.5)
    press_offset = (-0.06, 0.0, -0.05)
    languages = ("turn off the light", "press the button to switch off the lamp")
    num_variations = 2


class PressSwitch(_PressTask):
    name = "press_switch"
    fixture_size = (0.04, 0.08, 0.12)
    fixture_color = (0.9, 0.9, 0.9)
    press_offset = (0.0, 0.0, 0.04)
    languages = ("press the switch", "flip the light switch")
    num_variations = 2


class TvOn(_PressTask):
    """rlbench/tasks/tv_on.py — press power on the remote in front of the TV."""

    name = "tv_on"
    fixture_size = (0.05, 0.12, 0.02)
    fixture_color = (0.05, 0.05, 0.05)
    press_offset = (0.0, -0.04, 0.02)
    languages = ("turn on the TV", "press the power button on the remote")
    num_variations = 2

    def init_episode(self, variation, rng):
        langs = super().init_episode(variation, rng)
        # the television screen the remote points at (scenery, occludes nothing)
        self.backend.add_object(SceneObject(
            "tv", np.array([0.55, 0.0, TABLE_Z + 0.2]),
            size=np.array([0.05, 0.5, 0.3]), color=(0.1, 0.1, 0.12), static=True))
        return langs


class BeatTheBuzz(_PressTask):
    name = "beat_the_buzz"
    fixture_size = (0.04, 0.04, 0.18)
    fixture_color = (0.8, 0.2, 0.2)
    press_offset = (0.0, 0.0, 0.1)
    languages = ("beat the buzz",)


class TurnOvenOn(_PressTask):
    name = "turn_oven_on"
    fixture_size = (0.3, 0.4, 0.25)
    fixture_color = (0.2, 0.2, 0.2)
    press_offset = (-0.12, 0.1, 0.14)
    languages = ("turn on the oven", "grip the oven knob and turn it")

    def fixture_position(self, rng):
        return np.array([0.45, rng.uniform(-0.15, 0.15),
                         TABLE_Z + self.fixture_size[2] / 2])


class TurnTap(_PressTask):
    """rlbench/tasks/turn_tap.py — left/right handle by variation."""

    name = "turn_tap"
    fixture_size = (0.1, 0.24, 0.12)
    fixture_color = (0.75, 0.75, 0.8)
    num_variations = 2
    languages = ("turn the left tap", "turn the right tap")

    def init_episode(self, variation, rng):
        self.backend.remove_all_objects()
        self._pos = np.array([rng.uniform(0.3, 0.45), rng.uniform(-0.2, 0.2),
                              TABLE_Z + self.fixture_size[2] / 2])
        self.backend.add_object(SceneObject(
            "fixture", self._pos, size=np.asarray(self.fixture_size),
            color=self.fixture_color, static=True))
        side = 1.0 if variation % 2 == 0 else -1.0   # left handle at +y
        self._press = self._pos + np.array([0.0, side * 0.1, 0.08])
        self.register_success_conditions([
            GripperNearCondition("right", self._press, 0.06),
        ])
        return [self.languages[variation % 2]]


class ChangeChannel(_PressTask):
    name = "change_channel"
    fixture_size = (0.05, 0.12, 0.02)
    fixture_color = (0.1, 0.1, 0.1)
    press_offset = (0.0, 0.04, 0.02)
    languages = ("change the channel to the next one",
                 "press the channel up button on the remote")
    num_variations = 2


# -----------------------------------------------------------------------------------
# pushed-down buttons: movable caps that must each end displaced downward
# -----------------------------------------------------------------------------------


class PushButtons(_CatalogueTask):
    """rlbench/tasks/push_buttons.py — press 2-3 colored buttons in sequence.

    Buttons are movable caps the demo pushes ~1.5 cm down; success = every
    commanded cap displaced downward (the kinematic stand-in for the reference's
    joint-limit press detection)."""

    name = "push_buttons"
    num_variations = 3

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        n = 2 + variation % 2
        names = list(COLORS)[variation:variation + n]
        self._buttons = []
        conds = []
        for i, cname in enumerate(names):
            pos = sample_disjoint_position(
                self.backend, rng, [0.2, -0.3, TABLE_Z + 0.025],
                [0.45, 0.3, TABLE_Z + 0.025], np.full(3, 0.09))
            nm = f"button_{cname}"
            self.backend.add_object(SceneObject(
                nm, pos, size=np.array([0.05, 0.05, 0.03]),
                color=COLORS[cname]))
            self._buttons.append(nm)
            conds.append(ObjectDisplacedCondition(nm, pos.copy(), 0.01, axis=2))
        self.register_success_conditions(conds)
        pretty = ", then ".join(n.split("_")[1] for n in self._buttons)
        return [f"push the {pretty} buttons"]

    def target_object_name(self):
        return self._buttons[0]

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        wps = []
        for nm in self._buttons:
            p = self.backend.get_object(nm).position
            wps += [
                Waypoint("right", p + [0, 0, 0.08], DOWN, 1.0,
                         label=f"approach_{nm}"),
                Waypoint("right", p, DOWN, 0.0, label=f"grip_{nm}"),
                Waypoint("right", p - [0, 0, 0.018], DOWN, None,
                         label=f"press_{nm}"),
                Waypoint("right", p - [0, 0, 0.018], DOWN, 1.0, dwell=2,
                         label=f"release_{nm}"),
                Waypoint("right", p + [0, 0, 0.08], DOWN, None,
                         label=f"retract_{nm}"),
            ]
        return wps


# -----------------------------------------------------------------------------------
# pick-lift family: grasp a (possibly fixtured) item and raise it
# -----------------------------------------------------------------------------------


class _PickLiftTask(_CatalogueTask):
    """Grasp the item and lift it clear (pick_and_lift.py recipe: grasp waypoint,
    lift waypoint, success = DetectedCondition in a hovering success zone +
    GraspedCondition)."""

    item_size = (0.04, 0.04, 0.04)
    item_color = (0.9, 0.1, 0.1)
    lift = 0.2
    languages: Sequence[str] = ()
    num_variations = 1

    def build_scene(self, variation: int, rng) -> np.ndarray:
        """Place fixtures; returns the item position."""
        return sample_disjoint_position(
            self.backend, rng, [0.2, -0.3, TABLE_Z + self.item_size[2] / 2],
            [0.45, 0.3, TABLE_Z + self.item_size[2] / 2],
            np.asarray(self.item_size))

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        pos = self.build_scene(variation, rng)
        self.backend.add_object(SceneObject(
            "item", pos, size=np.asarray(self.item_size), color=self.item_color))
        self.register_success_conditions([
            GraspedCondition("item", "any"),
            ObjectAboveCondition("item", float(pos[2]) + self.lift * 0.6),
        ])
        langs = list(self.languages) or [self.name.replace("_", " ")]
        return [langs[variation % len(langs)]]

    def target_object_name(self):
        return "item"

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        p = self.backend.get_object("item").position
        return [
            Waypoint("right", p + [0, 0, 0.1], DOWN, 1.0, label="approach"),
            Waypoint("right", p, DOWN, 0.0, label="grasp"),
            Waypoint("right", p + [0, 0, self.lift], DOWN, None, dwell=4,
                     label="lift"),
        ]


class PickAndLift(_PickLiftTask):
    name = "pick_and_lift"
    num_variations = 4

    def init_episode(self, variation, rng):
        cname = list(COLORS)[variation % 4]
        self.item_color = COLORS[cname]
        self.languages = (f"pick up the {cname} block and lift it up to the target",)
        return super().init_episode(variation, rng)


class TakeUsbOutOfComputer(_PickLiftTask):
    name = "take_usb_out_of_computer"
    item_size = (0.015, 0.015, 0.04)
    item_color = (0.7, 0.7, 0.75)
    lift = 0.12
    languages = ("take the usb out of the computer",)

    def build_scene(self, variation, rng):
        tower = np.array([rng.uniform(0.3, 0.45), rng.uniform(-0.2, 0.2),
                          TABLE_Z + 0.15])
        self.backend.add_object(SceneObject(
            "computer", tower, size=np.array([0.15, 0.08, 0.3]),
            color=(0.15, 0.15, 0.15), static=True))
        return tower + np.array([0.0, 0.06, -0.05])


class UnplugCharger(_PickLiftTask):
    name = "unplug_charger"
    item_size = (0.03, 0.04, 0.03)
    item_color = (0.95, 0.95, 0.95)
    lift = 0.1
    languages = ("unplug the charger",)

    def build_scene(self, variation, rng):
        wall = np.array([0.5, rng.uniform(-0.2, 0.2), TABLE_Z + 0.12])
        self.backend.add_object(SceneObject(
            "socket", wall, size=np.array([0.03, 0.1, 0.12]),
            color=(0.9, 0.9, 0.85), static=True))
        return wall + np.array([-0.035, 0.0, 0.0])


class LightBulbOut(_PickLiftTask):
    name = "light_bulb_out"
    item_size = (0.05, 0.05, 0.07)
    item_color = (0.98, 0.95, 0.7)
    languages = ("remove the bulb from the lamp", "take out the light bulb")
    num_variations = 2

    def build_scene(self, variation, rng):
        base = np.array([rng.uniform(0.25, 0.4), rng.uniform(-0.25, 0.25),
                         TABLE_Z + 0.05])
        self.backend.add_object(SceneObject(
            "lamp_stand", base, size=np.array([0.1, 0.1, 0.1]),
            color=(0.4, 0.4, 0.45), static=True))
        return base + np.array([0.0, 0.0, 0.09])


class TakeToiletRollOffStand(_PickLiftTask):
    name = "take_toilet_roll_off_stand"
    item_size = (0.1, 0.05, 0.1)
    item_color = (0.98, 0.98, 0.98)
    lift = 0.15
    languages = ("take the toilet roll off the stand",)

    def build_scene(self, variation, rng):
        stand = np.array([rng.uniform(0.3, 0.45), rng.uniform(-0.2, 0.2),
                          TABLE_Z + 0.1])
        self.backend.add_object(SceneObject(
            "stand", stand, size=np.array([0.04, 0.16, 0.2]),
            color=(0.3, 0.3, 0.35), static=True))
        return stand + np.array([0.0, 0.11, 0.05])


class TakeFrameOffHanger(_PickLiftTask):
    name = "take_frame_off_hanger"
    item_size = (0.12, 0.02, 0.16)
    item_color = (0.55, 0.35, 0.15)
    lift = 0.12
    languages = ("take the frame off the hanger",)

    def build_scene(self, variation, rng):
        wall = np.array([0.5, rng.uniform(-0.2, 0.2), TABLE_Z + 0.35])
        self.backend.add_object(SceneObject(
            "hanger_peg", wall, size=np.array([0.04, 0.04, 0.04]),
            color=(0.4, 0.4, 0.4), static=True))
        return wall + np.array([-0.04, 0.0, -0.08])


class TakeMoneyOutSafe(_PickLiftTask):
    name = "take_money_out_safe"
    item_size = (0.08, 0.04, 0.01)
    item_color = (0.2, 0.6, 0.3)
    lift = 0.15
    num_variations = 2
    languages = ("take the money out of the bottom shelf and place it on the table",
                 "take the money out of the top shelf and place it on the table")

    def build_scene(self, variation, rng):
        safe = np.array([rng.uniform(0.35, 0.45), rng.uniform(-0.15, 0.15),
                         TABLE_Z + 0.15])
        self.backend.add_object(SceneObject(
            "safe", safe, size=np.array([0.2, 0.24, 0.3]),
            color=(0.25, 0.25, 0.3), static=True))
        dz = -0.08 if variation % 2 == 0 else 0.08
        return safe + np.array([-0.13, 0.0, dz])


class TakeUmbrellaOutOfUmbrellaStand(_PickLiftTask):
    name = "take_umbrella_out_of_umbrella_stand"
    item_size = (0.03, 0.03, 0.3)
    item_color = (0.2, 0.2, 0.7)
    lift = 0.25
    languages = ("take the umbrella out of the umbrella stand",)

    def build_scene(self, variation, rng):
        stand = np.array([rng.uniform(0.3, 0.42), rng.uniform(-0.25, 0.25),
                          TABLE_Z + 0.12])
        self.backend.add_object(SceneObject(
            "stand", stand, size=np.array([0.12, 0.12, 0.24]),
            color=(0.1, 0.1, 0.1), static=True))
        return stand + np.array([0.0, 0.0, 0.16])


# -----------------------------------------------------------------------------------
# pick-place family: grasp the item and carry it into a receptacle region
# -----------------------------------------------------------------------------------


class _PickPlaceTask(_CatalogueTask):
    """Grasp the item, carry it into the receptacle's success region and release
    (phone_on_base.py recipe: grasp, hover over base, lower, release; success =
    DetectedCondition of the item inside the receptacle's proximity region)."""

    item_size = (0.04, 0.04, 0.04)
    item_color = (0.9, 0.2, 0.2)
    region_half = (0.07, 0.07, 0.1)
    drop_height = 0.12            # carry height above the success point
    release = True
    languages: Sequence[str] = ()
    num_variations = 1

    def build_scene(self, variation: int, rng) -> Tuple[np.ndarray, np.ndarray]:
        """Place fixtures; returns (item_position, success_point)."""
        raise NotImplementedError

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        item_pos, target = self.build_scene(variation, rng)
        self.backend.add_object(SceneObject(
            "item", np.asarray(item_pos, np.float64),
            size=np.asarray(self.item_size), color=self.item_color))
        self._target = np.asarray(target, np.float64)
        self.register_success_conditions([
            DetectedCondition("item", self._target, np.asarray(self.region_half)),
        ])
        langs = list(self.languages) or [self.name.replace("_", " ")]
        return [langs[variation % len(langs)]]

    def target_object_name(self):
        return "item"

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        p = self.backend.get_object("item").position
        wps = [
            Waypoint("right", p + [0, 0, 0.1], DOWN, 1.0, label="approach_item"),
            Waypoint("right", p, DOWN, 0.0, label="grasp_item"),
            Waypoint("right", p + [0, 0, self.drop_height], DOWN, None,
                     label="lift_item"),
            Waypoint("right", self._target + [0, 0, self.drop_height], DOWN, None,
                     label="carry"),
            Waypoint("right", self._target, DOWN, None, label="lower"),
        ]
        if self.release:
            wps.append(Waypoint("right", self._target, DOWN, 1.0, dwell=4,
                                label="release"))
        return wps


class PhoneOnBase(_PickPlaceTask):
    name = "phone_on_base"
    item_size = (0.05, 0.1, 0.02)
    item_color = (0.05, 0.05, 0.05)
    languages = ("put the phone on the base",)

    def build_scene(self, variation, rng):
        base = np.array([rng.uniform(0.3, 0.45), rng.uniform(0.1, 0.3),
                         TABLE_Z + 0.015])
        self.backend.add_object(SceneObject(
            "base", base, size=np.array([0.07, 0.12, 0.03]),
            color=(0.3, 0.3, 0.3), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.2, -0.3, TABLE_Z + 0.01],
            [0.45, 0.0, TABLE_Z + 0.01], np.asarray(self.item_size))
        return item, base + np.array([0.0, 0.0, 0.04])


class PutKnifeOnChoppingBoard(_PickPlaceTask):
    name = "put_knife_on_chopping_board"
    item_size = (0.02, 0.16, 0.02)
    item_color = (0.8, 0.8, 0.85)
    languages = ("put the knife on the chopping board",)

    def build_scene(self, variation, rng):
        board = np.array([rng.uniform(0.3, 0.45), rng.uniform(-0.3, -0.1),
                          TABLE_Z + 0.01])
        self.backend.add_object(SceneObject(
            "board", board, size=np.array([0.18, 0.26, 0.02]),
            color=(0.75, 0.55, 0.3), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.2, 0.0, TABLE_Z + 0.01],
            [0.45, 0.3, TABLE_Z + 0.01], np.asarray(self.item_size))
        return item, board + np.array([0.0, 0.0, 0.04])


class PutMoneyInSafe(_PickPlaceTask):
    name = "put_money_in_safe"
    item_size = (0.08, 0.04, 0.01)
    item_color = (0.2, 0.6, 0.3)
    region_half = (0.08, 0.1, 0.06)
    num_variations = 2
    languages = ("put the money away in the safe on the bottom shelf",
                 "put the money away in the safe on the top shelf")

    def build_scene(self, variation, rng):
        safe = np.array([rng.uniform(0.35, 0.45), rng.uniform(-0.1, 0.1),
                         TABLE_Z + 0.15])
        self.backend.add_object(SceneObject(
            "safe", safe, size=np.array([0.2, 0.24, 0.3]),
            color=(0.25, 0.25, 0.3), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.15, -0.35, TABLE_Z + 0.005],
            [0.3, 0.35, TABLE_Z + 0.005], np.asarray(self.item_size))
        dz = -0.08 if variation % 2 == 0 else 0.08
        return item, safe + np.array([-0.13, 0.0, dz])


class PutUmbrellaInUmbrellaStand(_PickPlaceTask):
    name = "put_umbrella_in_umbrella_stand"
    item_size = (0.03, 0.03, 0.3)
    item_color = (0.2, 0.2, 0.7)
    region_half = (0.08, 0.08, 0.2)
    drop_height = 0.3
    languages = ("put the umbrella in the umbrella stand",)

    def build_scene(self, variation, rng):
        stand = np.array([rng.uniform(0.32, 0.42), rng.uniform(0.1, 0.3),
                          TABLE_Z + 0.12])
        self.backend.add_object(SceneObject(
            "stand", stand, size=np.array([0.12, 0.12, 0.24]),
            color=(0.1, 0.1, 0.1), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.2, -0.3, TABLE_Z + 0.15],
            [0.4, -0.05, TABLE_Z + 0.15], np.asarray(self.item_size))
        return item, stand + np.array([0.0, 0.0, 0.18])


class BasketballInHoop(_PickPlaceTask):
    name = "basketball_in_hoop"
    item_size = (0.05, 0.05, 0.05)
    item_color = (0.95, 0.55, 0.1)
    region_half = (0.07, 0.07, 0.08)
    languages = ("put the ball in the hoop", "dunk the basketball")
    num_variations = 2

    def build_scene(self, variation, rng):
        post = np.array([0.5, rng.uniform(-0.2, 0.2), TABLE_Z + 0.3])
        self.backend.add_object(SceneObject(
            "backboard", post, size=np.array([0.02, 0.25, 0.18]),
            color=(0.9, 0.9, 0.9), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.15, -0.3, TABLE_Z + 0.025],
            [0.4, 0.3, TABLE_Z + 0.025], np.asarray(self.item_size))
        return item, post + np.array([-0.08, 0.0, -0.1])


class InsertOntoSquarePeg(_PickPlaceTask):
    name = "insert_onto_square_peg"
    item_size = (0.07, 0.07, 0.03)
    region_half = (0.05, 0.05, 0.08)
    num_variations = 4

    def build_scene(self, variation, rng):
        cname = list(COLORS)[variation % 4]
        self.item_color = COLORS[cname]
        self.languages = (f"put the ring on the {cname} spoke",)
        base = np.array([rng.uniform(0.3, 0.45), rng.uniform(0.0, 0.25),
                         TABLE_Z + 0.02])
        self.backend.add_object(SceneObject(
            "peg_base", base, size=np.array([0.2, 0.1, 0.04]),
            color=(0.4, 0.4, 0.45), static=True))
        self.backend.add_object(SceneObject(
            "peg", base + [0, 0, 0.08], size=np.array([0.025, 0.025, 0.12]),
            color=COLORS[cname], static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.15, -0.3, TABLE_Z + 0.015],
            [0.4, -0.05, TABLE_Z + 0.015], np.asarray(self.item_size))
        return item, base + np.array([0.0, 0.0, 0.1])


class PutToiletRollOnStand(_PickPlaceTask):
    name = "put_toilet_roll_on_stand"
    item_size = (0.1, 0.05, 0.1)
    item_color = (0.98, 0.98, 0.98)
    languages = ("put the toilet roll on the stand",)

    def build_scene(self, variation, rng):
        stand = np.array([rng.uniform(0.32, 0.45), rng.uniform(-0.3, -0.1),
                          TABLE_Z + 0.1])
        self.backend.add_object(SceneObject(
            "stand", stand, size=np.array([0.04, 0.16, 0.2]),
            color=(0.3, 0.3, 0.35), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.2, 0.0, TABLE_Z + 0.05],
            [0.45, 0.3, TABLE_Z + 0.05], np.asarray(self.item_size))
        return item, stand + np.array([0.0, 0.11, 0.05])


class StackWine(_PickPlaceTask):
    name = "stack_wine"
    item_size = (0.06, 0.06, 0.24)
    item_color = (0.3, 0.05, 0.1)
    region_half = (0.08, 0.08, 0.14)
    drop_height = 0.25
    languages = ("stack the wine bottle to the left of the rack",)

    def build_scene(self, variation, rng):
        rack = np.array([rng.uniform(0.32, 0.45), rng.uniform(0.1, 0.3),
                         TABLE_Z + 0.08])
        self.backend.add_object(SceneObject(
            "rack", rack, size=np.array([0.16, 0.3, 0.16]),
            color=(0.45, 0.3, 0.15), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.18, -0.3, TABLE_Z + 0.12],
            [0.42, -0.05, TABLE_Z + 0.12], np.asarray(self.item_size))
        return item, rack + np.array([0.0, -0.18, 0.04])


class PlaceHangerOnRack(_PickPlaceTask):
    name = "place_hanger_on_rack"
    item_size = (0.02, 0.2, 0.08)
    item_color = (0.8, 0.8, 0.85)
    drop_height = 0.2
    languages = ("pick up the hanger and place in on the rack",)

    def build_scene(self, variation, rng):
        rail = np.array([0.45, rng.uniform(-0.1, 0.1), TABLE_Z + 0.4])
        self.backend.add_object(SceneObject(
            "rack_rail", rail, size=np.array([0.03, 0.4, 0.03]),
            color=(0.5, 0.5, 0.55), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.15, -0.3, TABLE_Z + 0.04],
            [0.4, 0.3, TABLE_Z + 0.04], np.asarray(self.item_size))
        return item, rail + np.array([0.0, 0.0, -0.06])


class LightBulbIn(_PickPlaceTask):
    name = "light_bulb_in"
    item_size = (0.05, 0.05, 0.07)
    item_color = (0.98, 0.95, 0.7)
    region_half = (0.06, 0.06, 0.08)
    languages = ("screw in the light bulb", "put the light bulb into the lamp")
    num_variations = 2

    def build_scene(self, variation, rng):
        base = np.array([rng.uniform(0.28, 0.42), rng.uniform(0.05, 0.3),
                         TABLE_Z + 0.05])
        self.backend.add_object(SceneObject(
            "lamp_stand", base, size=np.array([0.1, 0.1, 0.1]),
            color=(0.4, 0.4, 0.45), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.18, -0.3, TABLE_Z + 0.035],
            [0.45, -0.05, TABLE_Z + 0.035], np.asarray(self.item_size))
        return item, base + np.array([0.0, 0.0, 0.1])


class PlugChargerInPowerSupply(_PickPlaceTask):
    name = "plug_charger_in_power_supply"
    item_size = (0.03, 0.04, 0.03)
    item_color = (0.95, 0.95, 0.95)
    region_half = (0.05, 0.06, 0.06)
    languages = ("plug the charger into the power supply",)

    def build_scene(self, variation, rng):
        wall = np.array([0.5, rng.uniform(-0.2, 0.2), TABLE_Z + 0.12])
        self.backend.add_object(SceneObject(
            "socket", wall, size=np.array([0.03, 0.1, 0.12]),
            color=(0.9, 0.9, 0.85), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.2, -0.3, TABLE_Z + 0.015],
            [0.42, 0.3, TABLE_Z + 0.015], np.asarray(self.item_size))
        return item, wall + np.array([-0.035, 0.0, 0.0])


class InsertUsbInComputer(_PickPlaceTask):
    name = "insert_usb_in_computer"
    item_size = (0.015, 0.015, 0.04)
    item_color = (0.7, 0.7, 0.75)
    region_half = (0.04, 0.05, 0.06)
    languages = ("insert the usb stick into the computer",)

    def build_scene(self, variation, rng):
        tower = np.array([rng.uniform(0.35, 0.45), rng.uniform(-0.15, 0.15),
                          TABLE_Z + 0.15])
        self.backend.add_object(SceneObject(
            "computer", tower, size=np.array([0.15, 0.08, 0.3]),
            color=(0.15, 0.15, 0.15), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.15, -0.35, TABLE_Z + 0.02],
            [0.35, 0.35, TABLE_Z + 0.02], np.asarray(self.item_size))
        return item, tower + np.array([0.0, 0.06, -0.05])


class PutKnifeInKnifeBlock(_PickPlaceTask):
    name = "put_knife_in_knife_block"
    item_size = (0.02, 0.16, 0.02)
    item_color = (0.8, 0.8, 0.85)
    region_half = (0.06, 0.1, 0.1)
    drop_height = 0.2
    languages = ("put the knife in the knife block",)

    def build_scene(self, variation, rng):
        block = np.array([rng.uniform(0.32, 0.45), rng.uniform(-0.3, -0.1),
                          TABLE_Z + 0.08])
        self.backend.add_object(SceneObject(
            "knife_block", block, size=np.array([0.1, 0.14, 0.16]),
            color=(0.45, 0.3, 0.15), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.2, 0.0, TABLE_Z + 0.01],
            [0.45, 0.3, TABLE_Z + 0.01], np.asarray(self.item_size))
        return item, block + np.array([0.0, 0.0, 0.14])


class MeatOnGrill(_PickPlaceTask):
    name = "meat_on_grill"
    item_size = (0.08, 0.06, 0.025)
    num_variations = 2

    def build_scene(self, variation, rng):
        meat = ("chicken", (0.95, 0.85, 0.7)) if variation % 2 == 0 else \
            ("steak", (0.6, 0.2, 0.15))
        self.item_color = meat[1]
        self.languages = (f"put the {meat[0]} on the grill",)
        grill = np.array([rng.uniform(0.32, 0.45), rng.uniform(0.05, 0.25),
                          TABLE_Z + 0.06])
        self.backend.add_object(SceneObject(
            "grill", grill, size=np.array([0.25, 0.3, 0.12]),
            color=(0.15, 0.15, 0.15), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.15, -0.3, TABLE_Z + 0.015],
            [0.4, -0.05, TABLE_Z + 0.015], np.asarray(self.item_size))
        return item, grill + np.array([0.0, 0.0, 0.1])


class MeatOffGrill(_PickPlaceTask):
    name = "meat_off_grill"
    item_size = (0.08, 0.06, 0.025)
    num_variations = 2

    def build_scene(self, variation, rng):
        meat = ("chicken", (0.95, 0.85, 0.7)) if variation % 2 == 0 else \
            ("steak", (0.6, 0.2, 0.15))
        self.item_color = meat[1]
        self.languages = (f"take the {meat[0]} off the grill",)
        grill = np.array([rng.uniform(0.32, 0.45), rng.uniform(0.05, 0.25),
                          TABLE_Z + 0.06])
        self.backend.add_object(SceneObject(
            "grill", grill, size=np.array([0.25, 0.3, 0.12]),
            color=(0.15, 0.15, 0.15), static=True))
        plate = np.array([rng.uniform(0.25, 0.4), rng.uniform(-0.3, -0.1),
                          TABLE_Z + 0.01])
        self.backend.add_object(SceneObject(
            "plate", plate, size=np.array([0.14, 0.14, 0.02]),
            color=(0.95, 0.95, 0.95), static=True))
        return grill + np.array([0.0, 0.0, 0.135]), plate + np.array([0, 0, 0.04])


class PutTrayInOven(_PickPlaceTask):
    name = "put_tray_in_oven"
    item_size = (0.16, 0.22, 0.015)
    item_color = (0.7, 0.7, 0.75)
    region_half = (0.12, 0.15, 0.08)
    drop_height = 0.18
    languages = ("put the tray in the oven",)

    def build_scene(self, variation, rng):
        oven = np.array([0.45, rng.uniform(-0.1, 0.1), TABLE_Z + 0.15])
        self.backend.add_object(SceneObject(
            "oven", oven, size=np.array([0.3, 0.4, 0.3]),
            color=(0.2, 0.2, 0.2), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.1, -0.35, TABLE_Z + 0.01],
            [0.25, 0.35, TABLE_Z + 0.01], np.asarray(self.item_size))
        return item, oven + np.array([-0.2, 0.0, -0.05])


class PutGroceriesInCupboard(_PickPlaceTask):
    name = "put_groceries_in_cupboard"
    item_size = (0.05, 0.05, 0.09)
    num_variations = 3
    region_half = (0.12, 0.15, 0.1)
    drop_height = 0.2

    def build_scene(self, variation, rng):
        grocery = [("crackers", (0.8, 0.6, 0.2)), ("soup", (0.85, 0.2, 0.2)),
                   ("mustard", (0.85, 0.75, 0.1))][variation % 3]
        self.item_color = grocery[1]
        self.languages = (f"put the {grocery[0]} in the cupboard",)
        cupboard = np.array([0.45, rng.uniform(-0.1, 0.1), TABLE_Z + 0.45])
        self.backend.add_object(SceneObject(
            "cupboard", cupboard, size=np.array([0.25, 0.5, 0.25]),
            color=(0.5, 0.35, 0.2), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.15, -0.3, TABLE_Z + 0.045],
            [0.4, 0.3, TABLE_Z + 0.045], np.asarray(self.item_size))
        return item, cupboard + np.array([-0.1, 0.0, -0.08])


class PutBooksOnBookshelf(_PickPlaceTask):
    name = "put_books_on_bookshelf"
    item_size = (0.04, 0.12, 0.16)
    item_color = (0.2, 0.3, 0.6)
    region_half = (0.1, 0.2, 0.12)
    drop_height = 0.22
    languages = ("put the book on the bookshelf",)

    def build_scene(self, variation, rng):
        shelf = np.array([0.48, rng.uniform(-0.1, 0.1), TABLE_Z + 0.35])
        self.backend.add_object(SceneObject(
            "bookshelf", shelf, size=np.array([0.2, 0.45, 0.05]),
            color=(0.5, 0.35, 0.2), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.15, -0.3, TABLE_Z + 0.08],
            [0.4, 0.3, TABLE_Z + 0.08], np.asarray(self.item_size))
        return item, shelf + np.array([0.0, 0.0, 0.12])


class PutShoesInBox(_PickPlaceTask):
    """Two shoes, both must end inside the box (put_shoes_in_box.py)."""

    name = "put_shoes_in_box"
    item_size = (0.05, 0.1, 0.04)
    item_color = (0.3, 0.2, 0.1)
    region_half = (0.1, 0.13, 0.08)
    languages = ("put the shoes in the box",)

    def build_scene(self, variation, rng):
        box = np.array([rng.uniform(0.3, 0.42), rng.uniform(0.1, 0.3),
                        TABLE_Z + 0.05])
        self.backend.add_object(SceneObject(
            "box", box, size=np.array([0.18, 0.24, 0.1]),
            color=(0.8, 0.75, 0.6), static=True))
        shoe2 = sample_disjoint_position(
            self.backend, rng, [0.15, -0.3, TABLE_Z + 0.02],
            [0.4, -0.05, TABLE_Z + 0.02], np.asarray(self.item_size))
        self.backend.add_object(SceneObject(
            "shoe2", shoe2, size=np.asarray(self.item_size),
            color=self.item_color))
        item = sample_disjoint_position(
            self.backend, rng, [0.15, -0.3, TABLE_Z + 0.02],
            [0.4, -0.05, TABLE_Z + 0.02], np.asarray(self.item_size))
        self._drop = box + np.array([0.0, 0.0, 0.09])
        return item, box + np.array([0.0, 0.0, 0.04])

    def init_episode(self, variation, rng):
        langs = super().init_episode(variation, rng)
        self._success = list(self._success_conditions)
        self._success.append(DetectedCondition(
            "shoe2", self._target, np.asarray(self.region_half)))
        self.register_success_conditions(self._success)
        return langs

    def get_waypoints(self, dominant_arm):
        wps = super().get_waypoints(dominant_arm)
        s2 = self.backend.get_object("shoe2").position
        wps += [
            Waypoint("right", s2 + [0, 0, 0.1], DOWN, 1.0, label="approach_shoe2"),
            Waypoint("right", s2, DOWN, 0.0, label="grasp_shoe2"),
            Waypoint("right", self._drop + [0, 0, 0.08], DOWN, None,
                     label="carry_shoe2"),
            Waypoint("right", self._drop, DOWN, 1.0, dwell=4,
                     label="release_shoe2"),
        ]
        return wps


class PutPlateInColoredDishRack(_PickPlaceTask):
    name = "put_plate_in_colored_dish_rack"
    item_size = (0.12, 0.12, 0.015)
    item_color = (0.95, 0.95, 0.95)
    region_half = (0.09, 0.09, 0.08)
    num_variations = 3

    def build_scene(self, variation, rng):
        cname = list(COLORS)[variation % 3]
        self.languages = (f"put the plate in the {cname} dish rack",)
        rack = np.array([rng.uniform(0.3, 0.42), rng.uniform(0.1, 0.3),
                         TABLE_Z + 0.04])
        self.backend.add_object(SceneObject(
            "rack", rack, size=np.array([0.16, 0.16, 0.08]),
            color=COLORS[cname], static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.15, -0.3, TABLE_Z + 0.01],
            [0.4, -0.05, TABLE_Z + 0.01], np.asarray(self.item_size))
        return item, rack + np.array([0.0, 0.0, 0.08])


class ScoopWithSpatula(_PickPlaceTask):
    name = "scoop_with_spatula"
    item_size = (0.03, 0.03, 0.03)
    item_color = (0.9, 0.2, 0.2)
    languages = ("scoop up the cube and lift it with the spatula",)
    region_half = (0.1, 0.1, 0.12)

    def build_scene(self, variation, rng):
        item = sample_disjoint_position(
            self.backend, rng, [0.2, -0.25, TABLE_Z + 0.015],
            [0.42, 0.25, TABLE_Z + 0.015], np.asarray(self.item_size))
        return item, item + np.array([0.0, 0.0, 0.18])

    def get_waypoints(self, dominant_arm):
        p = self.backend.get_object("item").position
        return [
            Waypoint("right", p + [0, 0, 0.1], DOWN, 1.0, label="approach"),
            Waypoint("right", p, DOWN, 0.0, label="scoop"),
            Waypoint("right", self._target, DOWN, None, dwell=5, label="lift"),
        ]


# -----------------------------------------------------------------------------------
# slide family: grasp-drag an object along the table into a region
# -----------------------------------------------------------------------------------


class _SlideTask(_CatalogueTask):
    """Drag the object along the table into the target region without lifting
    (slide_block_to_color_target.py recipe)."""

    item_size = (0.05, 0.05, 0.05)
    item_color = (0.9, 0.1, 0.1)
    region_half = (0.06, 0.06, 0.06)
    languages: Sequence[str] = ()
    num_variations = 1
    target_color = (0.1, 0.9, 0.1)

    def target_offset(self, variation: int, rng) -> np.ndarray:
        return np.array([rng.uniform(0.1, 0.18), rng.uniform(-0.1, 0.1), 0.0])

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        start = np.array([rng.uniform(0.2, 0.3), rng.uniform(-0.2, 0.2),
                          TABLE_Z + self.item_size[2] / 2])
        target = start + self.target_offset(variation, rng)
        self.backend.add_object(SceneObject(
            "item", start, size=np.asarray(self.item_size),
            color=self.item_color))
        self.backend.add_object(SceneObject(
            "target_mark", target - [0, 0, self.item_size[2] / 2],
            size=np.array([0.1, 0.1, 0.005]), color=self.target_color,
            static=True))
        self._target = target
        self.register_success_conditions([
            DetectedCondition("item", target, np.asarray(self.region_half)),
        ])
        langs = list(self.languages) or [self.name.replace("_", " ")]
        return [langs[variation % len(langs)]]

    def target_object_name(self):
        return "item"

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        p = self.backend.get_object("item").position
        return [
            Waypoint("right", p + [0, 0, 0.1], DOWN, 1.0, label="approach"),
            Waypoint("right", p, DOWN, 0.0, label="grip"),
            Waypoint("right", self._target, DOWN, None, label="slide"),
            Waypoint("right", self._target, DOWN, 1.0, dwell=4, label="release"),
        ]


class SlideBlockToColorTarget(_SlideTask):
    name = "slide_block_to_color_target"
    num_variations = 4

    def init_episode(self, variation, rng):
        cname = list(COLORS)[variation % 4]
        self.target_color = COLORS[cname]
        self.languages = (f"slide the block to the {cname} target",)
        return super().init_episode(variation, rng)


class ReachAndDrag(_SlideTask):
    name = "reach_and_drag"
    item_size = (0.06, 0.06, 0.06)
    item_color = (0.2, 0.4, 0.85)
    languages = ("use the stick to drag the cube onto the target",)

    def init_episode(self, variation, rng):
        langs = super().init_episode(variation, rng)
        stick = sample_disjoint_position(
            self.backend, rng, [0.12, -0.35, TABLE_Z + 0.02],
            [0.45, 0.35, TABLE_Z + 0.02], np.array([0.02, 0.02, 0.25]))
        self.backend.add_object(SceneObject(
            "stick", stick, size=np.array([0.02, 0.02, 0.25]),
            color=(0.7, 0.5, 0.2)))
        return langs

    def get_waypoints(self, dominant_arm):
        stick = self.backend.get_object("stick").position
        item = self.backend.get_object("item").position
        return [
            Waypoint("right", stick + [0, 0, 0.12], DOWN, 1.0,
                     label="approach_stick"),
            Waypoint("right", stick, DOWN, 0.0, label="grasp_stick"),
            Waypoint("right", item + [0, 0, 0.02], DOWN, None,
                     label="reach_cube"),
        ] + [
            # drag: the cube rides in front of the stick (kinematic backend moves
            # whatever the closed gripper last contacted — re-grip at the cube)
            Waypoint("right", item, DOWN, 1.0, label="drop_stick"),
            Waypoint("right", item, DOWN, 0.0, label="push_grip"),
            Waypoint("right", self._target, DOWN, None, label="drag"),
            Waypoint("right", self._target, DOWN, 1.0, dwell=4, label="release"),
        ]


class Hockey(_SlideTask):
    name = "hockey"
    item_size = (0.04, 0.04, 0.025)
    item_color = (0.05, 0.05, 0.05)
    region_half = (0.08, 0.08, 0.06)
    languages = ("hit the ball into the net",)

    def target_offset(self, variation, rng):
        return np.array([rng.uniform(0.15, 0.22), rng.uniform(-0.05, 0.05), 0.0])


class MoveHanger(_SlideTask):
    name = "move_hanger"
    item_size = (0.02, 0.2, 0.08)
    item_color = (0.8, 0.8, 0.85)
    region_half = (0.08, 0.1, 0.1)
    languages = ("move the hanger onto the other rack",)

    def target_offset(self, variation, rng):
        return np.array([0.0, rng.uniform(0.18, 0.25), 0.0])


class WipeDesk(_SlideTask):
    name = "wipe_desk"
    item_size = (0.07, 0.05, 0.03)
    item_color = (0.95, 0.9, 0.3)
    region_half = (0.08, 0.08, 0.06)
    languages = ("wipe the dirt off the desk", "use the sponge to clean the desk")
    num_variations = 2

    def init_episode(self, variation, rng):
        langs = super().init_episode(variation, rng)
        # dirt patch between sponge and target (scenery the wipe passes over)
        mid = (self.backend.get_object("item").position + self._target) / 2
        self.backend.add_object(SceneObject(
            "dirt", mid - [0, 0, self.item_size[2] / 2 - 0.002],
            size=np.array([0.08, 0.08, 0.004]), color=(0.35, 0.25, 0.15),
            static=True))
        return langs


# -----------------------------------------------------------------------------------
# hinge family: grasp a door/lid slab and pull it open (or push it closed)
# -----------------------------------------------------------------------------------


class _HingeTask(_CatalogueTask):
    """Grasp the door/lid handle and displace the panel along its opening axis
    (open_box.py / open_door.py recipe; the kinematic backend models the panel
    as a movable slab, success = panel displaced by ``travel``)."""

    panel_size = (0.02, 0.2, 0.2)
    panel_color = (0.5, 0.35, 0.2)
    frame_size = (0.2, 0.24, 0.24)
    frame_color = (0.35, 0.25, 0.15)
    travel = 0.12                 # required displacement
    open_axis = 0                 # world axis the panel moves along
    open_sign = -1.0              # direction (pull toward the robot = -x)
    languages: Sequence[str] = ()
    num_variations = 1

    def frame_position(self, rng) -> np.ndarray:
        return np.array([0.45, rng.uniform(-0.15, 0.15),
                         TABLE_Z + self.frame_size[2] / 2])

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        frame = self.frame_position(rng)
        self.backend.add_object(SceneObject(
            "frame", frame, size=np.asarray(self.frame_size),
            color=self.frame_color, static=True))
        offset = np.zeros(3)
        offset[self.open_axis] = self.open_sign * (
            self.frame_size[self.open_axis] / 2 + self.panel_size[self.open_axis])
        panel = frame + offset
        self.backend.add_object(SceneObject(
            "panel", panel, size=np.asarray(self.panel_size),
            color=self.panel_color))
        self._start = panel.copy()
        self.register_success_conditions([
            ObjectDisplacedCondition("panel", self._start, self.travel,
                                     axis=self.open_axis),
        ])
        langs = list(self.languages) or [self.name.replace("_", " ")]
        return [langs[variation % len(langs)]]

    def target_object_name(self):
        return "panel"

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        p = self.backend.get_object("panel").position
        pull = np.zeros(3)
        pull[self.open_axis] = self.open_sign * (self.travel + 0.05)
        return [
            Waypoint("right", p + [0, 0, 0.12], DOWN, 1.0, label="approach"),
            Waypoint("right", p, DOWN, 0.0, label="grip_handle"),
            Waypoint("right", p + pull, DOWN, None, label="swing"),
            Waypoint("right", p + pull, DOWN, 1.0, dwell=4, label="release"),
        ]


class OpenBox(_HingeTask):
    name = "open_box"
    panel_size = (0.2, 0.24, 0.02)
    frame_size = (0.2, 0.24, 0.12)
    open_axis = 2
    open_sign = 1.0
    travel = 0.1
    languages = ("open box",)

    def frame_position(self, rng):
        return np.array([rng.uniform(0.3, 0.42), rng.uniform(-0.2, 0.2),
                         TABLE_Z + 0.06])


class CloseBox(OpenBox):
    name = "close_box"
    languages = ("close box",)

    def init_episode(self, variation, rng):
        langs = super().init_episode(variation, rng)
        # lid starts propped open above the box; closing lowers it onto the rim
        panel = self.backend.get_object("panel")
        panel.position = panel.position + np.array([0.0, 0.0, 0.12])
        self._start = panel.position.copy()
        self.register_success_conditions([
            ObjectDisplacedCondition("panel", self._start, 0.08, axis=2),
        ])
        return langs

    def get_waypoints(self, dominant_arm):
        p = self.backend.get_object("panel").position
        return [
            Waypoint("right", p + [0, 0, 0.1], DOWN, 1.0, label="approach"),
            Waypoint("right", p, DOWN, 0.0, label="grip_lid"),
            Waypoint("right", p - [0, 0, 0.11], DOWN, None, label="lower"),
            Waypoint("right", p - [0, 0, 0.11], DOWN, 1.0, dwell=4,
                     label="release"),
        ]


class OpenDoor(_HingeTask):
    name = "open_door"
    panel_size = (0.02, 0.3, 0.5)
    frame_size = (0.04, 0.34, 0.55)
    frame_color = (0.6, 0.6, 0.65)
    travel = 0.15
    languages = ("open the door",)

    def frame_position(self, rng):
        return np.array([0.5, rng.uniform(-0.1, 0.1), TABLE_Z + 0.28])


class CloseDoor(OpenDoor):
    name = "close_door"
    open_sign = 1.0
    languages = ("close the door",)

    def init_episode(self, variation, rng):
        # door starts ajar at -x; closing pushes it back toward the frame (+x)
        langs = super().init_episode(variation, rng)
        panel = self.backend.get_object("panel")
        panel.position = panel.position - np.array([0.18, 0.0, 0.0])
        self._start = panel.position.copy()
        self.register_success_conditions([
            ObjectDisplacedCondition("panel", self._start, 0.12, axis=0),
        ])
        return langs


class OpenMicrowave(_HingeTask):
    name = "open_microwave"
    panel_size = (0.02, 0.24, 0.18)
    frame_size = (0.22, 0.3, 0.2)
    frame_color = (0.8, 0.8, 0.82)
    panel_color = (0.2, 0.2, 0.22)
    travel = 0.1
    languages = ("open the microwave",)


class CloseMicrowave(OpenMicrowave):
    name = "close_microwave"
    open_sign = 1.0
    languages = ("close microwave",)

    def init_episode(self, variation, rng):
        langs = super().init_episode(variation, rng)
        panel = self.backend.get_object("panel")
        panel.position = panel.position - np.array([0.15, 0.0, 0.0])
        self._start = panel.position.copy()
        self.register_success_conditions([
            ObjectDisplacedCondition("panel", self._start, 0.1, axis=0),
        ])
        return langs


class OpenFridge(_HingeTask):
    name = "open_fridge"
    panel_size = (0.02, 0.26, 0.4)
    frame_size = (0.25, 0.3, 0.45)
    frame_color = (0.85, 0.85, 0.88)
    panel_color = (0.75, 0.75, 0.78)
    travel = 0.14
    languages = ("open fridge",)

    def frame_position(self, rng):
        return np.array([0.48, rng.uniform(-0.12, 0.12), TABLE_Z + 0.23])


class CloseFridge(OpenFridge):
    name = "close_fridge"
    open_sign = 1.0
    languages = ("close fridge",)

    def init_episode(self, variation, rng):
        langs = super().init_episode(variation, rng)
        panel = self.backend.get_object("panel")
        panel.position = panel.position - np.array([0.16, 0.0, 0.0])
        self._start = panel.position.copy()
        self.register_success_conditions([
            ObjectDisplacedCondition("panel", self._start, 0.1, axis=0),
        ])
        return langs


class OpenGrill(_HingeTask):
    name = "open_grill"
    panel_size = (0.22, 0.26, 0.02)
    frame_size = (0.24, 0.3, 0.12)
    frame_color = (0.15, 0.15, 0.15)
    panel_color = (0.2, 0.2, 0.2)
    open_axis = 2
    open_sign = 1.0
    travel = 0.1
    languages = ("open the grill",)

    def frame_position(self, rng):
        return np.array([rng.uniform(0.32, 0.42), rng.uniform(-0.15, 0.15),
                         TABLE_Z + 0.06])


class CloseGrill(OpenGrill):
    name = "close_grill"
    languages = ("close the grill",)

    def init_episode(self, variation, rng):
        langs = super().init_episode(variation, rng)
        panel = self.backend.get_object("panel")
        panel.position = panel.position + np.array([0.0, 0.0, 0.12])
        self._start = panel.position.copy()
        self.register_success_conditions([
            ObjectDisplacedCondition("panel", self._start, 0.08, axis=2),
        ])
        return langs

    def get_waypoints(self, dominant_arm):
        p = self.backend.get_object("panel").position
        return [
            Waypoint("right", p + [0, 0, 0.1], DOWN, 1.0, label="approach"),
            Waypoint("right", p, DOWN, 0.0, label="grip_lid"),
            Waypoint("right", p - [0, 0, 0.11], DOWN, None, label="lower"),
            Waypoint("right", p - [0, 0, 0.11], DOWN, 1.0, dwell=4,
                     label="release"),
        ]


class CloseLaptopLid(_HingeTask):
    name = "close_laptop_lid"
    panel_size = (0.18, 0.24, 0.015)
    frame_size = (0.18, 0.24, 0.03)
    frame_color = (0.3, 0.3, 0.32)
    panel_color = (0.3, 0.3, 0.32)
    open_axis = 2
    open_sign = 1.0
    travel = 0.06
    languages = ("close laptop lid",)

    def frame_position(self, rng):
        return np.array([rng.uniform(0.3, 0.42), rng.uniform(-0.2, 0.2),
                         TABLE_Z + 0.015])

    def init_episode(self, variation, rng):
        langs = super().init_episode(variation, rng)
        panel = self.backend.get_object("panel")
        panel.position = panel.position + np.array([-0.07, 0.0, 0.08])
        self._start = panel.position.copy()
        self.register_success_conditions([
            ObjectDisplacedCondition("panel", self._start, 0.05, axis=2),
        ])
        return langs

    def get_waypoints(self, dominant_arm):
        p = self.backend.get_object("panel").position
        return [
            Waypoint("right", p + [0, 0, 0.1], DOWN, 1.0, label="approach"),
            Waypoint("right", p, DOWN, 0.0, label="grip_lid"),
            Waypoint("right", p + [0.07, 0, -0.07], DOWN, None, label="fold"),
            Waypoint("right", p + [0.07, 0, -0.07], DOWN, 1.0, dwell=4,
                     label="release"),
        ]


class OpenOven(_HingeTask):
    name = "open_oven"
    panel_size = (0.02, 0.3, 0.22)
    frame_size = (0.3, 0.4, 0.25)
    frame_color = (0.2, 0.2, 0.2)
    panel_color = (0.1, 0.1, 0.1)
    travel = 0.13
    languages = ("open the oven",)


class OpenWindow(_HingeTask):
    name = "open_window"
    panel_size = (0.02, 0.26, 0.3)
    frame_size = (0.04, 0.3, 0.35)
    frame_color = (0.9, 0.9, 0.9)
    panel_color = (0.6, 0.8, 0.95)
    open_axis = 1
    open_sign = 1.0
    travel = 0.12
    languages = ("open window",)

    def frame_position(self, rng):
        return np.array([0.5, rng.uniform(-0.15, 0.0), TABLE_Z + 0.3])


class SlideCabinetOpen(_HingeTask):
    name = "slide_cabinet_open"
    panel_size = (0.02, 0.18, 0.2)
    frame_size = (0.2, 0.4, 0.24)
    open_axis = 1
    open_sign = 1.0
    travel = 0.12
    languages = ("slide the cabinet door open",)


class ToiletSeatUp(_HingeTask):
    name = "toilet_seat_up"
    panel_size = (0.2, 0.2, 0.02)
    frame_size = (0.2, 0.22, 0.2)
    frame_color = (0.95, 0.95, 0.95)
    panel_color = (0.95, 0.95, 0.95)
    open_axis = 2
    open_sign = 1.0
    travel = 0.12
    languages = ("lift the toilet seat up",)

    def frame_position(self, rng):
        return np.array([rng.uniform(0.3, 0.42), rng.uniform(-0.15, 0.15),
                         TABLE_Z + 0.1])


class ToiletSeatDown(ToiletSeatUp):
    name = "toilet_seat_down"
    languages = ("put the toilet seat down",)

    def init_episode(self, variation, rng):
        langs = super().init_episode(variation, rng)
        panel = self.backend.get_object("panel")
        panel.position = panel.position + np.array([0.0, 0.0, 0.14])
        self._start = panel.position.copy()
        self.register_success_conditions([
            ObjectDisplacedCondition("panel", self._start, 0.1, axis=2),
        ])
        return langs

    def get_waypoints(self, dominant_arm):
        p = self.backend.get_object("panel").position
        return [
            Waypoint("right", p + [0, 0, 0.1], DOWN, 1.0, label="approach"),
            Waypoint("right", p, DOWN, 0.0, label="grip_seat"),
            Waypoint("right", p - [0, 0, 0.13], DOWN, None, label="lower"),
            Waypoint("right", p - [0, 0, 0.13], DOWN, 1.0, dwell=4,
                     label="release"),
        ]


class OpenWineBottle(_HingeTask):
    """Bimanual: one hand steadies the bottle, the other pulls the cork
    (open_wine_bottle.py, two-arm like the reference's open_jar)."""

    name = "open_wine_bottle"
    bimanual = True
    languages = ("open the wine bottle", "pull the cork out of the bottle")
    num_variations = 2

    def init_episode(self, variation, rng):
        self.backend.remove_all_objects()
        bottle = np.array([rng.uniform(0.25, 0.4), rng.uniform(-0.2, 0.2),
                           TABLE_Z + 0.12])
        self.backend.add_object(SceneObject(
            "bottle", bottle, size=np.array([0.06, 0.06, 0.24]),
            color=(0.2, 0.35, 0.2)))
        self.backend.add_object(SceneObject(
            "cork", bottle + [0, 0, 0.135], size=np.array([0.025, 0.025, 0.03]),
            color=(0.75, 0.6, 0.4)))
        self._dominant = "right" if bottle[1] < 0 else "left"
        self.register_success_conditions([
            ObjectAboveCondition("cork", float(bottle[2]) + 0.22),
        ])
        return [self.languages[variation % 2]]

    def target_object_name(self):
        return "bottle"

    def dominant_arm(self):
        return self._dominant

    def get_waypoints(self, dominant_arm):
        bottle = self.backend.get_object("bottle").position
        cork = self.backend.get_object("cork").position
        helper = _other(dominant_arm)
        return [
            Waypoint(helper, bottle + [0, 0, 0.05], DOWN, 1.0,
                     label="approach_bottle"),
            Waypoint(helper, bottle + [0, 0, 0.02], DOWN, 0.0,
                     label="steady_bottle"),
            Waypoint(dominant_arm, cork + [0, 0, 0.08], DOWN, 1.0,
                     label="approach_cork"),
            Waypoint(dominant_arm, cork, DOWN, 0.0, label="grip_cork"),
            Waypoint(dominant_arm, cork + [0, 0, 0.15], DOWN, None, dwell=4,
                     label="pull_cork"),
        ]


def _other(arm: str) -> str:
    return "left" if arm == "right" else "right"


# -----------------------------------------------------------------------------------
# stack / arrange family
# -----------------------------------------------------------------------------------


class StackCups(_CatalogueTask):
    """Stack the other cups onto the target cup (stack_cups.py)."""

    name = "stack_cups"
    num_variations = 3

    def init_episode(self, variation, rng):
        self.backend.remove_all_objects()
        cname = list(COLORS)[variation % 3]
        base = sample_disjoint_position(
            self.backend, rng, [0.25, -0.2, TABLE_Z + 0.04],
            [0.42, 0.2, TABLE_Z + 0.04], np.full(3, 0.1))
        self.backend.add_object(SceneObject(
            "cup_base", base, size=np.array([0.07, 0.07, 0.08]),
            color=COLORS[cname], static=True))
        conds = []
        self._cups = []
        for i in range(2):
            pos = sample_disjoint_position(
                self.backend, rng, [0.18, -0.3, TABLE_Z + 0.04],
                [0.45, 0.3, TABLE_Z + 0.04], np.full(3, 0.1))
            nm = f"cup{i}"
            self.backend.add_object(SceneObject(
                nm, pos, size=np.array([0.06, 0.06, 0.08]),
                color=(0.8, 0.8, 0.85)))
            self._cups.append(nm)
            conds.append(DetectedCondition(
                nm, base + np.array([0, 0, 0.1]), np.array([0.06, 0.06, 0.12])))
        self._base = base
        self.register_success_conditions(conds)
        return [f"stack the other cups on top of the {cname} cup"]

    def target_object_name(self):
        return "cup_base"

    def get_waypoints(self, dominant_arm):
        wps = []
        for i, nm in enumerate(self._cups):
            p = self.backend.get_object(nm).position
            drop = self._base + np.array([0.0, 0.0, 0.1 + 0.05 * i])
            wps += [
                Waypoint("right", p + [0, 0, 0.12], DOWN, 1.0,
                         label=f"approach_{nm}"),
                Waypoint("right", p, DOWN, 0.0, label=f"grasp_{nm}"),
                Waypoint("right", drop + [0, 0, 0.06], DOWN, None,
                         label=f"carry_{nm}"),
                Waypoint("right", drop, DOWN, 1.0, dwell=3,
                         label=f"stack_{nm}"),
            ]
        return wps


class PlaceCups(_CatalogueTask):
    """Hang cups on the cup holder spokes (place_cups.py)."""

    name = "place_cups"
    num_variations = 2

    def init_episode(self, variation, rng):
        self.backend.remove_all_objects()
        n = 1 + variation % 2
        holder = np.array([rng.uniform(0.32, 0.42), rng.uniform(0.1, 0.25),
                           TABLE_Z + 0.12])
        self.backend.add_object(SceneObject(
            "holder", holder, size=np.array([0.1, 0.1, 0.24]),
            color=(0.5, 0.35, 0.2), static=True))
        conds, self._cups = [], []
        for i in range(n):
            pos = sample_disjoint_position(
                self.backend, rng, [0.18, -0.3, TABLE_Z + 0.04],
                [0.42, 0.0, TABLE_Z + 0.04], np.full(3, 0.09))
            nm = f"cup{i}"
            self.backend.add_object(SceneObject(
                nm, pos, size=np.array([0.06, 0.06, 0.08]),
                color=(0.9, 0.9, 0.95)))
            self._cups.append(nm)
            spoke = holder + np.array([0.0, -0.02 - 0.06 * i, 0.04])
            conds.append(DetectedCondition(nm, spoke,
                                           np.array([0.07, 0.07, 0.1])))
        self._holder = holder
        self.register_success_conditions(conds)
        return [f"place {n} cup{'s' if n > 1 else ''} on the cup holder"]

    def target_object_name(self):
        return "holder"

    def get_waypoints(self, dominant_arm):
        wps = []
        for i, nm in enumerate(self._cups):
            p = self.backend.get_object(nm).position
            spoke = self._holder + np.array([0.0, -0.02 - 0.06 * i, 0.04])
            wps += [
                Waypoint("right", p + [0, 0, 0.12], DOWN, 1.0,
                         label=f"approach_{nm}"),
                Waypoint("right", p, DOWN, 0.0, label=f"grasp_{nm}"),
                Waypoint("right", spoke + [0, 0, 0.08], DOWN, None,
                         label=f"carry_{nm}"),
                Waypoint("right", spoke, DOWN, 1.0, dwell=3,
                         label=f"hang_{nm}"),
            ]
        return wps


class PourFromCupToCup(_CatalogueTask):
    """Carry the full cup over the empty one and tip it (pour_from_cup_to_cup.py;
    kinematic: the pour is a hover above the target cup)."""

    name = "pour_from_cup_to_cup"
    num_variations = 2

    def init_episode(self, variation, rng):
        self.backend.remove_all_objects()
        cname = list(COLORS)[variation % 2]
        target = sample_disjoint_position(
            self.backend, rng, [0.25, 0.0, TABLE_Z + 0.04],
            [0.42, 0.3, TABLE_Z + 0.04], np.full(3, 0.1))
        self.backend.add_object(SceneObject(
            "target_cup", target, size=np.array([0.07, 0.07, 0.08]),
            color=COLORS[cname], static=True))
        src = sample_disjoint_position(
            self.backend, rng, [0.18, -0.3, TABLE_Z + 0.04],
            [0.42, -0.05, TABLE_Z + 0.04], np.full(3, 0.1))
        self.backend.add_object(SceneObject(
            "source_cup", src, size=np.array([0.06, 0.06, 0.08]),
            color=(0.9, 0.9, 0.95)))
        self._target = target
        self.register_success_conditions([
            DetectedCondition("source_cup", target + np.array([0, 0, 0.14]),
                              np.array([0.06, 0.06, 0.08])),
            GraspedCondition("source_cup", "any"),
        ])
        return [f"pour liquid from the cup into the {cname} cup"]

    def target_object_name(self):
        return "source_cup"

    def get_waypoints(self, dominant_arm):
        src = self.backend.get_object("source_cup").position
        hover = self._target + np.array([0.0, 0.0, 0.14])
        return [
            Waypoint("right", src + [0, 0, 0.12], DOWN, 1.0, label="approach"),
            Waypoint("right", src, DOWN, 0.0, label="grasp_cup"),
            Waypoint("right", hover + [0, 0, 0.06], DOWN, None, label="carry"),
            Waypoint("right", hover, DOWN, None, dwell=6, label="pour"),
        ]


CATALOGUE_TASKS = (
    # press
    LampOn, LampOff, PressSwitch, TvOn, BeatTheBuzz, TurnOvenOn, TurnTap,
    ChangeChannel, PushButtons,
    # pick-lift
    PickAndLift, TakeUsbOutOfComputer, UnplugCharger, LightBulbOut,
    TakeToiletRollOffStand, TakeFrameOffHanger, TakeMoneyOutSafe,
    TakeUmbrellaOutOfUmbrellaStand,
    # pick-place
    PhoneOnBase, PutKnifeOnChoppingBoard, PutMoneyInSafe,
    PutUmbrellaInUmbrellaStand, BasketballInHoop, InsertOntoSquarePeg,
    PutToiletRollOnStand, StackWine, PlaceHangerOnRack, LightBulbIn,
    PlugChargerInPowerSupply, InsertUsbInComputer, PutKnifeInKnifeBlock,
    MeatOnGrill, MeatOffGrill, PutTrayInOven, PutGroceriesInCupboard,
    PutBooksOnBookshelf, PutShoesInBox, PutPlateInColoredDishRack,
    ScoopWithSpatula,
    # slide
    SlideBlockToColorTarget, ReachAndDrag, Hockey, MoveHanger, WipeDesk,
    # hinge
    OpenBox, CloseBox, OpenDoor, CloseDoor, OpenMicrowave, CloseMicrowave,
    OpenFridge, CloseFridge, OpenGrill, CloseGrill, CloseLaptopLid, OpenOven,
    OpenWindow, SlideCabinetOpen, ToiletSeatUp, ToiletSeatDown, OpenWineBottle,
    # stack / arrange
    StackCups, PlaceCups, PourFromCupToCup,
)
