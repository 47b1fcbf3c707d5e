"""Catalogue completion: the remaining formulaic rlbench/tasks/ recipes.

Built from the family bases of tasks_catalogue.py (press / pick-lift /
pick-place / slide / hinge) plus a couple of bespoke multi-object scenes
(set_the_table, setup_checkers, play_jenga). With this module the registry
covers every task name in the reference's rlbench/tasks/ directory
(110 files) plus this framework's bimanual extras — 120 registered total.
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
from voxactb_tpu_torch.sim.task import Waypoint, sample_disjoint_position
from voxactb_tpu_torch.sim.tasks_catalogue import (
    COLORS,
    DOWN,
    TABLE_Z,
    _CatalogueTask,
    _HingeTask,
    _PickLiftTask,
    _PickPlaceTask,
    _PressTask,
    _SlideTask,
)


# -- press-family --------------------------------------------------------------------


class ChangeClock(_PressTask):
    name = "change_clock"
    fixture_size = (0.04, 0.14, 0.14)
    fixture_color = (0.9, 0.9, 0.85)
    press_offset = (-0.03, 0.0, -0.02)
    languages = ("change the clock to show time 12.15",
                 "turn the knob on the back of the clock")
    num_variations = 2


class SetClockToTime(ChangeClock):
    name = "set_clock_to_time"
    languages = ("set the clock to 12.15", "adjust the clock to show the time")


class WeighingScales(_PickPlaceTask):
    """Put the pepper on the scales (weighing_scales.py)."""

    name = "weighing_scales"
    item_size = (0.05, 0.05, 0.06)
    item_color = (0.2, 0.6, 0.2)
    languages = ("weigh the pepper", "put the pepper on the weighing scales")
    num_variations = 2

    def build_scene(self, variation, rng):
        scales = np.array([rng.uniform(0.3, 0.42), rng.uniform(0.05, 0.25),
                           TABLE_Z + 0.03])
        self.backend.add_object(SceneObject(
            "scales", scales, size=np.array([0.14, 0.14, 0.06]),
            color=(0.85, 0.85, 0.88), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.18, -0.3, TABLE_Z + 0.03],
            [0.42, -0.05, TABLE_Z + 0.03], np.asarray(self.item_size))
        return item, scales + np.array([0.0, 0.0, 0.07])


class TakeOffWeighingScales(_PickLiftTask):
    name = "take_off_weighing_scales"
    item_size = (0.05, 0.05, 0.06)
    item_color = (0.2, 0.6, 0.2)
    languages = ("remove the pepper from the weighing scales",)

    def build_scene(self, variation, rng):
        scales = np.array([rng.uniform(0.3, 0.42), rng.uniform(-0.2, 0.2),
                           TABLE_Z + 0.03])
        self.backend.add_object(SceneObject(
            "scales", scales, size=np.array([0.14, 0.14, 0.06]),
            color=(0.85, 0.85, 0.88), static=True))
        return scales + np.array([0.0, 0.0, 0.09])


class ScrewNail(_PressTask):
    name = "screw_nail"
    fixture_size = (0.12, 0.12, 0.06)
    fixture_color = (0.55, 0.4, 0.2)
    press_offset = (0.0, 0.0, 0.05)
    languages = ("screw the nail in to the block", "use the screwdriver")


class WaterPlants(_PickPlaceTask):
    name = "water_plants"
    item_size = (0.06, 0.1, 0.12)
    item_color = (0.2, 0.5, 0.9)
    region_half = (0.1, 0.1, 0.14)
    drop_height = 0.2
    release = False
    languages = ("water the plant", "pour water over the plant")

    def build_scene(self, variation, rng):
        plant = np.array([rng.uniform(0.3, 0.42), rng.uniform(0.05, 0.3),
                          TABLE_Z + 0.1])
        self.backend.add_object(SceneObject(
            "plant", plant, size=np.array([0.12, 0.12, 0.2]),
            color=(0.15, 0.6, 0.2), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.18, -0.3, TABLE_Z + 0.06],
            [0.42, -0.05, TABLE_Z + 0.06], np.asarray(self.item_size))
        return item, plant + np.array([0.0, 0.0, 0.16])

    def init_episode(self, variation, rng):
        langs = super().init_episode(variation, rng)
        # success: can hovers over the plant while still held
        self.register_success_conditions([
            DetectedCondition("item", self._target, np.asarray(self.region_half)),
            GraspedCondition("item", "any"),
        ])
        return langs


class HitBallWithQueue(_SlideTask):
    name = "hit_ball_with_queue"
    item_size = (0.04, 0.04, 0.04)
    item_color = (0.95, 0.95, 0.95)
    region_half = (0.07, 0.07, 0.06)
    languages = ("hit the ball with the queue into the goal",)

    def target_offset(self, variation, rng):
        return np.array([rng.uniform(0.14, 0.2), rng.uniform(-0.04, 0.04), 0.0])


class PutRubbishInColorBin(_PickPlaceTask):
    name = "put_rubbish_in_color_bin"
    item_size = (0.03, 0.03, 0.04)
    item_color = (0.6, 0.6, 0.5)
    region_half = (0.08, 0.08, 0.12)
    num_variations = 3

    def build_scene(self, variation, rng):
        cname = list(COLORS)[variation % 3]
        self.languages = (f"put the rubbish in the {cname} bin",)
        bin_pos = np.array([rng.uniform(0.3, 0.45), rng.uniform(0.1, 0.3),
                            TABLE_Z + 0.08])
        self.backend.add_object(SceneObject(
            "bin", bin_pos, size=np.array([0.12, 0.12, 0.16]),
            color=COLORS[cname], static=True))
        other = sample_disjoint_position(
            self.backend, rng, [0.2, -0.35, TABLE_Z + 0.08],
            [0.45, 0.35, TABLE_Z + 0.08], np.array([0.12, 0.12, 0.16]))
        self.backend.add_object(SceneObject(
            "bin_other", other, size=np.array([0.12, 0.12, 0.16]),
            color=COLORS[list(COLORS)[(variation + 1) % 3]], static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.2, -0.35, TABLE_Z + 0.02],
            [0.45, 0.0, TABLE_Z + 0.02], np.asarray(self.item_size))
        return item, bin_pos + np.array([0.0, 0.0, 0.1])


class PutBottleInFridge(_PickPlaceTask):
    """Single-arm variant (the coordinated bimanual one is in tasks_extra)."""

    name = "put_bottle_in_fridge"
    item_size = (0.05, 0.05, 0.16)
    item_color = (0.2, 0.35, 0.2)
    region_half = (0.12, 0.14, 0.2)
    drop_height = 0.22
    languages = ("put the bottle in the fridge",)

    def build_scene(self, variation, rng):
        fridge = np.array([0.48, rng.uniform(-0.12, 0.12), TABLE_Z + 0.23])
        self.backend.add_object(SceneObject(
            "fridge", fridge, size=np.array([0.25, 0.3, 0.45]),
            color=(0.85, 0.85, 0.88), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.15, -0.35, TABLE_Z + 0.08],
            [0.35, 0.35, TABLE_Z + 0.08], np.asarray(self.item_size))
        return item, fridge + np.array([-0.18, 0.0, -0.1])


class GetIceFromFridge(_PickPlaceTask):
    name = "get_ice_from_fridge"
    item_size = (0.06, 0.06, 0.09)
    item_color = (0.9, 0.9, 0.95)
    region_half = (0.1, 0.1, 0.1)
    languages = ("get ice from the fridge",
                 "hold the cup under the ice dispenser")
    num_variations = 2
    release = False

    def build_scene(self, variation, rng):
        fridge = np.array([0.48, rng.uniform(-0.12, 0.12), TABLE_Z + 0.25])
        self.backend.add_object(SceneObject(
            "fridge", fridge, size=np.array([0.25, 0.3, 0.5]),
            color=(0.8, 0.8, 0.84), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.15, -0.35, TABLE_Z + 0.045],
            [0.35, 0.35, TABLE_Z + 0.045], np.asarray(self.item_size))
        return item, fridge + np.array([-0.17, 0.0, 0.05])

    def init_episode(self, variation, rng):
        langs = super().init_episode(variation, rng)
        self.register_success_conditions([
            DetectedCondition("item", self._target, np.asarray(self.region_half)),
            GraspedCondition("item", "any"),
        ])
        return langs


class TakeShoesOutOfBox(_PickLiftTask):
    name = "take_shoes_out_of_box"
    item_size = (0.05, 0.1, 0.04)
    item_color = (0.3, 0.2, 0.1)
    lift = 0.16
    languages = ("take the shoes out of the box",)

    def build_scene(self, variation, rng):
        box = np.array([rng.uniform(0.3, 0.42), rng.uniform(-0.2, 0.2),
                        TABLE_Z + 0.05])
        self.backend.add_object(SceneObject(
            "box", box, size=np.array([0.18, 0.24, 0.1]),
            color=(0.8, 0.75, 0.6), static=True))
        return box + np.array([0.0, -0.05, 0.04])


class TakeCupOutFromCabinet(_PickLiftTask):
    name = "take_cup_out_from_cabinet"
    item_size = (0.06, 0.06, 0.08)
    item_color = (0.9, 0.9, 0.95)
    lift = 0.14
    languages = ("take out a cup from the left half of the cabinet",
                 "take out a cup from the right half of the cabinet")
    num_variations = 2

    def build_scene(self, variation, rng):
        cab = np.array([0.46, rng.uniform(-0.1, 0.1), TABLE_Z + 0.3])
        self.backend.add_object(SceneObject(
            "cabinet", cab, size=np.array([0.2, 0.4, 0.25]),
            color=(0.5, 0.35, 0.2), static=True))
        side = 1.0 if variation % 2 == 0 else -1.0
        return cab + np.array([-0.14, side * 0.1, -0.06])


class TakePlateOffColoredDishRack(_PickLiftTask):
    name = "take_plate_off_colored_dish_rack"
    item_size = (0.12, 0.12, 0.015)
    item_color = (0.95, 0.95, 0.95)
    lift = 0.15
    num_variations = 3

    def build_scene(self, variation, rng):
        cname = list(COLORS)[variation % 3]
        self.languages = (f"take the plate off the {cname} dish rack",)
        rack = np.array([rng.uniform(0.3, 0.42), rng.uniform(-0.2, 0.2),
                         TABLE_Z + 0.04])
        self.backend.add_object(SceneObject(
            "rack", rack, size=np.array([0.16, 0.16, 0.08]),
            color=COLORS[cname], static=True))
        return rack + np.array([0.0, 0.0, 0.09])


class HangFrameOnHanger(_PickPlaceTask):
    name = "hang_frame_on_hanger"
    item_size = (0.12, 0.02, 0.16)
    item_color = (0.55, 0.35, 0.15)
    region_half = (0.08, 0.08, 0.12)
    drop_height = 0.18
    languages = ("hang the frame on the hanger",)

    def build_scene(self, variation, rng):
        wall = np.array([0.5, rng.uniform(-0.2, 0.2), TABLE_Z + 0.35])
        self.backend.add_object(SceneObject(
            "hanger_peg", wall, size=np.array([0.04, 0.04, 0.04]),
            color=(0.4, 0.4, 0.4), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.15, -0.3, TABLE_Z + 0.08],
            [0.38, 0.3, TABLE_Z + 0.08], np.asarray(self.item_size))
        return item, wall + np.array([-0.04, 0.0, -0.06])


class PutBooksAtShelfLocation(_PickPlaceTask):
    name = "put_books_at_shelf_location"
    item_size = (0.04, 0.12, 0.16)
    item_color = (0.6, 0.2, 0.2)
    region_half = (0.1, 0.12, 0.12)
    drop_height = 0.22
    num_variations = 2

    def build_scene(self, variation, rng):
        side = ("left", 1.0) if variation % 2 == 0 else ("right", -1.0)
        self.languages = (f"put the book on the {side[0]} side of the shelf",)
        shelf = np.array([0.48, rng.uniform(-0.08, 0.08), TABLE_Z + 0.35])
        self.backend.add_object(SceneObject(
            "bookshelf", shelf, size=np.array([0.2, 0.45, 0.05]),
            color=(0.5, 0.35, 0.2), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.15, -0.3, TABLE_Z + 0.08],
            [0.4, 0.3, TABLE_Z + 0.08], np.asarray(self.item_size))
        return item, shelf + np.array([0.0, side[1] * 0.14, 0.12])


class EmptyContainer(_PickPlaceTask):
    name = "empty_container"
    item_size = (0.04, 0.04, 0.04)
    region_half = (0.12, 0.12, 0.1)
    num_variations = 2

    def build_scene(self, variation, rng):
        cname = list(COLORS)[variation % 2]
        self.item_color = COLORS[cname]
        self.languages = (
            f"empty the container into the {cname} container",)
        src = np.array([rng.uniform(0.25, 0.35), rng.uniform(-0.3, -0.1),
                        TABLE_Z + 0.04])
        self.backend.add_object(SceneObject(
            "container_src", src, size=np.array([0.2, 0.2, 0.08]),
            color=(0.7, 0.7, 0.7), static=True))
        dst = np.array([rng.uniform(0.25, 0.35), rng.uniform(0.1, 0.3),
                        TABLE_Z + 0.04])
        self.backend.add_object(SceneObject(
            "container_dst", dst, size=np.array([0.2, 0.2, 0.08]),
            color=COLORS[cname], static=True))
        return src + np.array([0.0, 0.0, 0.07]), dst + np.array([0.0, 0.0, 0.08])


class EmptyDishwasher(_PickLiftTask):
    name = "empty_dishwasher"
    item_size = (0.12, 0.12, 0.015)
    item_color = (0.95, 0.95, 0.95)
    lift = 0.18
    languages = ("empty the dishwasher", "take the plate out of the dishwasher")
    num_variations = 2

    def build_scene(self, variation, rng):
        dw = np.array([0.46, rng.uniform(-0.1, 0.1), TABLE_Z + 0.15])
        self.backend.add_object(SceneObject(
            "dishwasher", dw, size=np.array([0.25, 0.35, 0.3]),
            color=(0.75, 0.75, 0.78), static=True))
        return dw + np.array([-0.16, 0.0, -0.05])


class PutAllGroceriesInCupboard(_CatalogueTask):
    """Multi-item pick-place loop (put_all_groceries_in_cupboard.py)."""

    name = "put_all_groceries_in_cupboard"
    num_variations = 1

    GROCERIES = (("crackers", (0.8, 0.6, 0.2)), ("soup", (0.85, 0.2, 0.2)),
                 ("mustard", (0.85, 0.75, 0.1)))

    def init_episode(self, variation, rng):
        self.backend.remove_all_objects()
        cupboard = np.array([0.46, rng.uniform(-0.08, 0.08), TABLE_Z + 0.42])
        self.backend.add_object(SceneObject(
            "cupboard", cupboard, size=np.array([0.25, 0.5, 0.25]),
            color=(0.5, 0.35, 0.2), static=True))
        self._drop = cupboard + np.array([-0.1, 0.0, -0.06])
        conds, self._items = [], []
        for nm, rgb in self.GROCERIES:
            pos = sample_disjoint_position(
                self.backend, rng, [0.15, -0.3, TABLE_Z + 0.045],
                [0.38, 0.3, TABLE_Z + 0.045], np.full(3, 0.09))
            self.backend.add_object(SceneObject(
                nm, pos, size=np.array([0.05, 0.05, 0.09]), color=rgb))
            self._items.append(nm)
            conds.append(DetectedCondition(
                nm, self._drop, np.array([0.13, 0.2, 0.12])))
        self.register_success_conditions(conds)
        return ["put all of the groceries in the cupboard"]

    def target_object_name(self):
        return self._items[0]

    def get_waypoints(self, dominant_arm):
        wps = []
        for i, nm in enumerate(self._items):
            p = self.backend.get_object(nm).position
            drop = self._drop + np.array([0.0, 0.12 * (i - 1), 0.0])
            wps += [
                Waypoint("right", p + [0, 0, 0.1], DOWN, 1.0,
                         label=f"approach_{nm}"),
                Waypoint("right", p, DOWN, 0.0, label=f"grasp_{nm}"),
                Waypoint("right", drop + [0, 0, 0.1], DOWN, None,
                         label=f"carry_{nm}"),
                Waypoint("right", drop, DOWN, 1.0, dwell=3,
                         label=f"store_{nm}"),
            ]
        return wps


class SetTheTable(_CatalogueTask):
    """Place plate + cutlery at their settings (set_the_table.py)."""

    name = "set_the_table"
    num_variations = 1

    PIECES = (("plate", (0.95, 0.95, 0.95), (0.12, 0.12, 0.015), (0.0, 0.0)),
              ("fork", (0.8, 0.8, 0.85), (0.015, 0.12, 0.01), (0.0, 0.1)),
              ("knife", (0.8, 0.8, 0.85), (0.015, 0.12, 0.01), (0.0, -0.1)))

    def init_episode(self, variation, rng):
        self.backend.remove_all_objects()
        setting = np.array([rng.uniform(0.3, 0.4), rng.uniform(-0.05, 0.05),
                            TABLE_Z])
        self._setting = setting
        conds, self._pieces = [], []
        for nm, rgb, size, (dx, dy) in self.PIECES:
            pos = sample_disjoint_position(
                self.backend, rng, [0.12, -0.35, TABLE_Z + size[2] / 2],
                [0.28, 0.35, TABLE_Z + size[2] / 2], np.asarray(size))
            self.backend.add_object(SceneObject(
                nm, pos, size=np.asarray(size), color=rgb))
            self._pieces.append((nm, np.array([dx, dy, 0.03])))
            conds.append(DetectedCondition(
                nm, setting + [dx, dy, 0.02], np.array([0.07, 0.07, 0.06])))
        self.register_success_conditions(conds)
        return ["set the table"]

    def target_object_name(self):
        return "plate"

    def get_waypoints(self, dominant_arm):
        wps = []
        for nm, off in self._pieces:
            p = self.backend.get_object(nm).position
            tgt = self._setting + off
            wps += [
                Waypoint("right", p + [0, 0, 0.1], DOWN, 1.0,
                         label=f"approach_{nm}"),
                Waypoint("right", p, DOWN, 0.0, label=f"grasp_{nm}"),
                Waypoint("right", tgt + [0, 0, 0.08], DOWN, None,
                         label=f"carry_{nm}"),
                Waypoint("right", tgt, DOWN, 1.0, dwell=3,
                         label=f"place_{nm}"),
            ]
        return wps


class SetupCheckers(_PickPlaceTask):
    name = "setup_checkers"
    item_size = (0.035, 0.035, 0.012)
    item_color = (0.1, 0.1, 0.1)
    region_half = (0.05, 0.05, 0.05)
    languages = ("setup the checkers board",
                 "place the remaining checker in its spot")
    num_variations = 2

    def build_scene(self, variation, rng):
        board = np.array([rng.uniform(0.3, 0.4), rng.uniform(-0.1, 0.1),
                          TABLE_Z + 0.008])
        self.backend.add_object(SceneObject(
            "board", board, size=np.array([0.3, 0.3, 0.015]),
            color=(0.75, 0.55, 0.3), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.12, -0.35, TABLE_Z + 0.006],
            [0.25, 0.35, TABLE_Z + 0.006], np.asarray(self.item_size))
        corner = board + np.array([-0.1 if variation % 2 else 0.1, 0.1, 0.03])
        return item, corner


class SetupChess(SetupCheckers):
    name = "setup_chess"
    item_color = (0.95, 0.95, 0.9)
    languages = ("setup the chess board",
                 "place the remaining chess piece in its spot")


class SolvePuzzle(SetupCheckers):
    name = "solve_puzzle"
    item_size = (0.05, 0.05, 0.01)
    item_color = (0.2, 0.6, 0.85)
    languages = ("solve the jigsaw puzzle", "place the missing puzzle piece")


class PlayJenga(_PickLiftTask):
    """Remove a block without toppling the tower (play_jenga.py; kinematic:
    the tower must not move)."""

    name = "play_jenga"
    item_size = (0.045, 0.015, 0.012)
    item_color = (0.85, 0.7, 0.45)
    lift = 0.1
    languages = ("play jenga", "take the protruding block out of the tower")

    def build_scene(self, variation, rng):
        base = np.array([rng.uniform(0.28, 0.4), rng.uniform(-0.15, 0.15),
                         TABLE_Z + 0.09])
        self.backend.add_object(SceneObject(
            "tower", base, size=np.array([0.045, 0.045, 0.18]),
            color=(0.8, 0.65, 0.4)))
        self._tower_start = base.copy()
        return base + np.array([0.0, 0.04, 0.03])

    def init_episode(self, variation, rng):
        langs = super().init_episode(variation, rng)
        # extra constraint: the tower must not topple (move > 2 cm)
        self.register_success_conditions(
            list(self._success_conditions)
            + [_StillCondition("tower", self._tower_start, 0.02)])
        return langs


class _StillCondition(ObjectDisplacedCondition):
    """Object must NOT have moved more than ``min_distance``."""

    def satisfied(self, backend) -> bool:
        return not super().satisfied(backend)


class SlideCabinetOpenAndPlaceCups(_CatalogueTask):
    """Two-phase: slide the cabinet door, then put the cup inside
    (slide_cabinet_open_and_place_cups.py)."""

    name = "slide_cabinet_open_and_place_cups"
    num_variations = 1

    def init_episode(self, variation, rng):
        self.backend.remove_all_objects()
        cab = np.array([0.46, rng.uniform(-0.1, 0.1), TABLE_Z + 0.25])
        self.backend.add_object(SceneObject(
            "cabinet", cab, size=np.array([0.2, 0.4, 0.24]),
            color=(0.5, 0.35, 0.2), static=True))
        door = cab + np.array([-0.11, -0.1, 0.0])
        self.backend.add_object(SceneObject(
            "door", door, size=np.array([0.02, 0.18, 0.2]),
            color=(0.55, 0.4, 0.25)))
        cup = sample_disjoint_position(
            self.backend, rng, [0.15, -0.35, TABLE_Z + 0.04],
            [0.35, 0.1, TABLE_Z + 0.04], np.full(3, 0.09))
        self.backend.add_object(SceneObject(
            "cup", cup, size=np.array([0.06, 0.06, 0.08]),
            color=(0.9, 0.9, 0.95)))
        self._door_start = door.copy()
        self._inside = cab + np.array([-0.12, 0.08, -0.04])
        self.register_success_conditions([
            ObjectDisplacedCondition("door", self._door_start, 0.1, axis=1),
            DetectedCondition("cup", self._inside, np.array([0.1, 0.1, 0.1])),
        ])
        return ["slide open the cabinet and put the cup inside"]

    def target_object_name(self):
        return "cup"

    def get_waypoints(self, dominant_arm):
        door = self.backend.get_object("door").position
        cup = self.backend.get_object("cup").position
        slid = door + np.array([0.0, 0.14, 0.0])
        return [
            Waypoint("right", door + [0, 0, 0.12], DOWN, 1.0,
                     label="approach_door"),
            Waypoint("right", door, DOWN, 0.0, label="grip_door"),
            Waypoint("right", slid, DOWN, None, label="slide_door"),
            Waypoint("right", slid, DOWN, 1.0, dwell=2, label="release_door"),
            Waypoint("right", cup + [0, 0, 0.1], DOWN, None,
                     label="approach_cup"),
            Waypoint("right", cup, DOWN, 0.0, label="grasp_cup"),
            Waypoint("right", self._inside + [0, 0, 0.1], DOWN, None,
                     label="carry_cup"),
            Waypoint("right", self._inside, DOWN, 1.0, dwell=4,
                     label="place_cup"),
        ]


class RemoveCups(_PickLiftTask):
    name = "remove_cups"
    item_size = (0.06, 0.06, 0.08)
    item_color = (0.9, 0.9, 0.95)
    lift = 0.12
    languages = ("remove the cup from the cup holder",)

    def build_scene(self, variation, rng):
        holder = np.array([rng.uniform(0.3, 0.42), rng.uniform(-0.2, 0.2),
                           TABLE_Z + 0.12])
        self.backend.add_object(SceneObject(
            "holder", holder, size=np.array([0.1, 0.1, 0.24]),
            color=(0.5, 0.35, 0.2), static=True))
        return holder + np.array([0.0, -0.08, 0.04])


class BlockPyramid(_CatalogueTask):
    """Stack three blocks into a pyramid (block_pyramid.py)."""

    name = "block_pyramid"
    num_variations = 1

    def init_episode(self, variation, rng):
        self.backend.remove_all_objects()
        base = np.array([rng.uniform(0.28, 0.38), rng.uniform(-0.08, 0.08),
                         TABLE_Z + 0.025])
        self._base = base
        conds, self._blocks = [], []
        for i, cname in enumerate(("red", "green", "blue")):
            pos = sample_disjoint_position(
                self.backend, rng, [0.15, -0.35, TABLE_Z + 0.025],
                [0.42, 0.35, TABLE_Z + 0.025], np.full(3, 0.06))
            nm = f"block_{cname}"
            self.backend.add_object(SceneObject(
                nm, pos, size=np.full(3, 0.05), color=COLORS[cname]))
            self._blocks.append(nm)
        # pyramid: two on the base row, one on top
        self._slots = [base, base + [0.0, 0.055, 0.0],
                       base + [0.0, 0.027, 0.05]]
        for nm, slot in zip(self._blocks, self._slots):
            conds.append(DetectedCondition(nm, slot,
                                           np.array([0.04, 0.04, 0.04])))
        self.register_success_conditions(conds)
        return ["build a pyramid out of the blocks"]

    def target_object_name(self):
        return self._blocks[0]

    def get_waypoints(self, dominant_arm):
        wps = []
        for nm, slot in zip(self._blocks, self._slots):
            p = self.backend.get_object(nm).position
            wps += [
                Waypoint("right", p + [0, 0, 0.1], DOWN, 1.0,
                         label=f"approach_{nm}"),
                Waypoint("right", p, DOWN, 0.0, label=f"grasp_{nm}"),
                Waypoint("right", slot + [0, 0, 0.08], DOWN, None,
                         label=f"carry_{nm}"),
                Waypoint("right", slot, DOWN, 1.0, dwell=3,
                         label=f"stack_{nm}"),
            ]
        return wps


class PlaceShapeInShapeSorter(_PickPlaceTask):
    name = "place_shape_in_shape_sorter"
    item_size = (0.04, 0.04, 0.04)
    region_half = (0.05, 0.05, 0.07)
    num_variations = 3

    def build_scene(self, variation, rng):
        shape = ("cube", "cylinder", "triangular prism")[variation % 3]
        self.item_color = list(COLORS.values())[variation % 3]
        self.languages = (f"put the {shape} in the shape sorter",)
        sorter = np.array([rng.uniform(0.3, 0.42), rng.uniform(0.05, 0.25),
                           TABLE_Z + 0.06])
        self.backend.add_object(SceneObject(
            "sorter", sorter, size=np.array([0.18, 0.18, 0.12]),
            color=(0.85, 0.75, 0.3), static=True))
        item = sample_disjoint_position(
            self.backend, rng, [0.15, -0.3, TABLE_Z + 0.02],
            [0.4, -0.05, TABLE_Z + 0.02], np.asarray(self.item_size))
        return item, sorter + np.array([0.0, 0.0, 0.1])


class PlaceWineAtRackLocation(_PickPlaceTask):
    name = "place_wine_at_rack_location"
    item_size = (0.06, 0.06, 0.24)
    region_half = (0.07, 0.07, 0.14)
    drop_height = 0.25
    num_variations = 3

    def build_scene(self, variation, rng):
        loc = ("left", "middle", "right")[variation % 3]
        self.item_color = (0.3, 0.05, 0.1)
        self.languages = (f"stack the wine bottle to the {loc} of the rack",)
        rack = np.array([rng.uniform(0.32, 0.45), rng.uniform(0.05, 0.2),
                         TABLE_Z + 0.08])
        self.backend.add_object(SceneObject(
            "rack", rack, size=np.array([0.16, 0.36, 0.16]),
            color=(0.45, 0.3, 0.15), static=True))
        dy = {0: 0.12, 1: 0.0, 2: -0.12}[variation % 3]
        item = sample_disjoint_position(
            self.backend, rng, [0.18, -0.3, TABLE_Z + 0.12],
            [0.42, -0.1, TABLE_Z + 0.12], np.asarray(self.item_size))
        return item, rack + np.array([0.0, dy, 0.04])


class TakeTrayOutOfOven(_PickLiftTask):
    """Single-arm variant (the coordinated bimanual one is in tasks_extra)."""

    name = "take_tray_out_of_oven"
    item_size = (0.16, 0.22, 0.015)
    item_color = (0.7, 0.7, 0.75)
    lift = 0.12
    languages = ("take the tray out of the oven",)

    def build_scene(self, variation, rng):
        oven = np.array([0.45, rng.uniform(-0.1, 0.1), TABLE_Z + 0.15])
        self.backend.add_object(SceneObject(
            "oven", oven, size=np.array([0.3, 0.4, 0.3]),
            color=(0.2, 0.2, 0.2), static=True))
        return oven + np.array([-0.2, 0.0, -0.05])


CATALOGUE2_TASKS = (
    ChangeClock, SetClockToTime, WeighingScales, TakeOffWeighingScales,
    ScrewNail, WaterPlants, HitBallWithQueue, PutRubbishInColorBin,
    PutBottleInFridge, GetIceFromFridge, TakeShoesOutOfBox,
    TakeCupOutFromCabinet, TakePlateOffColoredDishRack, HangFrameOnHanger,
    PutBooksAtShelfLocation, EmptyContainer, EmptyDishwasher,
    PutAllGroceriesInCupboard, SetTheTable, SetupCheckers, SetupChess,
    SolvePuzzle, PlayJenga, SlideCabinetOpenAndPlaceCups, RemoveCups,
    BlockPyramid, PlaceShapeInShapeSorter, PlaceWineAtRackLocation,
    TakeTrayOutOfOven,
)


class SweepToDustpanOfSize(_CatalogueTask):
    """Sweep the dirt into the dustpan of the commanded size — two pans in the
    scene, only the right one counts (rlbench/tasks/sweep_to_dustpan_of_size.py)."""

    name = "sweep_to_dustpan_of_size"
    num_variations = 2

    def init_episode(self, variation, rng):
        self.backend.remove_all_objects()
        size_name = "short" if variation % 2 == 0 else "tall"
        pans = {}
        for nm, sz, y in (("dustpan_short", 0.1, 0.28),
                          ("dustpan_tall", 0.16, -0.28)):
            pos = np.array([rng.uniform(0.25, 0.4), y, TABLE_Z + 0.02])
            self.backend.add_object(SceneObject(
                nm, pos, size=np.array([sz, sz, 0.03]),
                color=(0.3, 0.3, 0.35), static=True))
            pans[nm] = pos
        dirt = sample_disjoint_position(
            self.backend, rng, [0.2, -0.12, TABLE_Z + 0.013],
            [0.45, 0.12, TABLE_Z + 0.013], np.full(3, 0.025))
        self.backend.add_object(SceneObject(
            "dirt", dirt, size=np.full(3, 0.025), color=(0.45, 0.3, 0.15)))
        self._target = pans[f"dustpan_{size_name}"] + np.array([0, 0, 0.03])
        self.register_success_conditions([
            DetectedCondition("dirt", self._target,
                              np.array([0.08, 0.08, 0.06])),
        ])
        return [f"sweep the dirt into the {size_name} dustpan"]

    def target_object_name(self):
        return "dirt"

    def get_waypoints(self, dominant_arm):
        dirt = self.backend.get_object("dirt").position
        return [
            Waypoint("right", dirt + [0, 0, 0.08], DOWN, 1.0,
                     label="approach_dirt"),
            Waypoint("right", dirt, DOWN, 0.0, label="catch_dirt"),
            Waypoint("right", self._target, DOWN, None, label="sweep"),
            Waypoint("right", self._target, DOWN, 1.0, dwell=5,
                     label="deposit"),
        ]


CATALOGUE2_TASKS = CATALOGUE2_TASKS + (SweepToDustpanOfSize,)
