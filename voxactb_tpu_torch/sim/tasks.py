"""The four VoxAct-B benchmark tasks against the kinematic backend.

Counterparts of rlbench/tasks/{open_jar,open_drawer,put_item_in_drawer,
hand_over_item}.py with their scripted bimanual demo logic (dominant-conditioned
waypoint mirroring, open_jar.py:40-99; success via proximity/grasp conditions,
open_jar.py:86-90). Geometry is simplified to what the kinematic backend models;
the contracts (placement randomization, dominant-arm ground truth, per-arm labeled
waypoints, success conditions) match.
"""

from __future__ import annotations

from typing import List

import numpy as np

from voxactb_tpu_torch.sim.backend import SceneObject
from voxactb_tpu_torch.sim.conditions import (
    Condition,
    GraspedCondition,
    ObjectAboveCondition,
    ObjectDisplacedCondition,
    DetectedCondition,
)
from voxactb_tpu_torch.sim.task import BimanualTask, Waypoint, sample_disjoint_position

TABLE_Z = 0.76
DOWN = np.array([0.0, 1.0, 0.0, 0.0])  # gripper pointing down (xyzw)


def _assistive(dominant: str) -> str:
    return "left" if dominant == "right" else "right"


class OpenJar(BimanualTask):
    """Assistive arm steadies the jar; dominant unscrews and lifts the lid
    (open_jar.py:15-114, incl. the 0.9-1.01 random rescale)."""

    name = "open_jar"
    num_variations = 2  # jar biased to the right / left half

    def init_task(self) -> None:
        pass

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        side = -1.0 if variation % 2 == 0 else 1.0
        scale = rng.uniform(0.9, 1.01)  # resize_object_of_interest
        jar_pos = np.array([
            rng.uniform(0.15, 0.45),
            side * rng.uniform(0.1, 0.35),
            TABLE_Z + 0.05,
        ])
        self.backend.add_object(SceneObject(
            "jar", jar_pos, size=np.array([0.08, 0.08, 0.10]) * scale,
            color=(0.9, 0.1, 0.1)))
        self.backend.add_object(SceneObject(
            "lid", jar_pos + [0, 0, 0.07 * scale],
            size=np.array([0.09, 0.09, 0.02]) * scale, color=(0.2, 0.2, 0.9)))
        self._dominant = "right" if side < 0 else "left"
        self.register_success_conditions([
            ObjectAboveCondition("lid", TABLE_Z + 0.25),
            GraspedCondition("jar", _assistive(self._dominant)),
        ])
        d = self._dominant
        return [
            f"grasp the jar with {_assistive(d)} hand and grasp the lid of the "
            f"jar with {d} hand to unscrew it in an anti_clockwise direction "
            "until it is removed from the jar",
        ]

    def target_object_name(self):
        return "jar"

    def dominant_arm(self) -> str:
        return self._dominant

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        jar = self.backend.get_object("jar")
        lid = self.backend.get_object("lid")
        a, d = _assistive(dominant_arm), dominant_arm
        return [
            Waypoint(a, jar.position + [0, 0, 0.12], DOWN, 1.0, label="approach_jar"),
            Waypoint(a, jar.position + [0, 0, 0.0], DOWN, 0.0, label="grasp_jar"),
            Waypoint(d, lid.position + [0, 0, 0.10], DOWN, 1.0, label="approach_lid"),
            Waypoint(d, lid.position + [0, 0, 0.0], DOWN, 0.0, label="grasp_lid"),
            Waypoint(d, lid.position + [0, 0, 0.30], DOWN, None, label="lift_lid"),
        ]


class OpenDrawer(BimanualTask):
    """Assistive steadies the cabinet; dominant pulls the bottom handle
    (open_drawer.py behavior)."""

    name = "open_drawer"
    num_variations = 2

    def init_task(self) -> None:
        pass

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        facing = -1.0 if variation % 2 == 0 else 1.0  # handle faces right / left arm
        base = np.array([rng.uniform(0.2, 0.4), rng.uniform(-0.1, 0.1),
                         TABLE_Z + 0.12])
        self.backend.add_object(SceneObject(
            "cabinet", base, size=np.array([0.25, 0.3, 0.25]),
            color=(0.5, 0.35, 0.2), static=True))
        handle_pos = base + [0.0, facing * 0.18, -0.06]
        self.backend.add_object(SceneObject(
            "bottom_handle", handle_pos, size=np.full(3, 0.03),
            color=(0.8, 0.8, 0.2)))
        self._dominant = "right" if facing < 0 else "left"
        self._handle_start = handle_pos.copy()
        self.register_success_conditions([
            ObjectDisplacedCondition("bottom_handle", self._handle_start,
                                     0.12, axis=1),
        ])
        d = self._dominant
        return [f"hold the drawer with {_assistive(d)} hand and open the bottom "
                f"drawer with {d} hand"]

    def target_object_name(self):
        return "bottom_handle"

    def dominant_arm(self) -> str:
        return self._dominant

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        cab = self.backend.get_object("cabinet")
        handle = self.backend.get_object("bottom_handle")
        a, d = _assistive(dominant_arm), dominant_arm
        pull = np.array([0.0, np.sign(handle.position[1] - cab.position[1]), 0.0])
        return [
            Waypoint(a, cab.position + [0, 0, 0.20], DOWN, 1.0, label="hold_top"),
            Waypoint(a, cab.position + [0, 0, 0.14], DOWN, 0.0, label="press_top"),
            Waypoint(d, handle.position + pull * 0.08, DOWN, 1.0,
                     label="approach_handle"),
            Waypoint(d, handle.position, DOWN, 0.0, label="grasp_handle"),
            Waypoint(d, handle.position + pull * 0.2, DOWN, None, label="pull"),
        ]


class PutItemInDrawer(BimanualTask):
    """The ASSISTIVE arm opens the top drawer, the DOMINANT arm drops the item
    in — the reference's role split (put_item_in_drawer.py:38-41: 'open the
    top drawer with left hand and put the item in ... with right hand' when
    dominant=right). The split also aligns demo time with the eval rollout's
    assistive-first alternation (rollout_generator.py:233-244): the drawer
    opening happens in the demo's first frames, exactly when the assistive
    arm gets its turns — with the roles swapped the dominant arm trains on
    inputs where the other arm is still at home and then never sees such a
    state closed-loop (diagnosed round 4: replay exact-match 1.00 but 4% val)."""

    name = "put_item_in_drawer"
    num_variations = 2

    def init_task(self) -> None:
        pass

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        facing = -1.0 if variation % 2 == 0 else 1.0
        base = np.array([rng.uniform(0.2, 0.4), rng.uniform(-0.1, 0.1),
                         TABLE_Z + 0.12])
        self.backend.add_object(SceneObject(
            "cabinet", base, size=np.array([0.25, 0.3, 0.25]),
            color=(0.5, 0.35, 0.2), static=True))
        handle_pos = base + [0.0, facing * 0.18, 0.08]
        self.backend.add_object(SceneObject(
            "top_handle", handle_pos, size=np.full(3, 0.03), color=(0.8, 0.8, 0.2)))
        # the item sits ON TOP of the cabinet (as in RLBench's
        # put_item_in_drawer, where the block spawns on the drawer unit) so the
        # whole task fits one VLM crop of radius 0.3 around the handle
        item_pos = base + np.array([rng.uniform(-0.06, 0.06),
                                    rng.uniform(-0.08, 0.08), 0.125 + 0.02])
        self.backend.add_object(SceneObject(
            "item", item_pos, size=np.full(3, 0.04), color=(0.2, 0.8, 0.2)))
        self._dominant = "right" if facing < 0 else "left"
        # success = item inside the cabinet body (the opened drawer's volume),
        # strictly below its top face so the spawn position does not satisfy it
        self._drawer_region = base
        self.register_success_conditions([
            DetectedCondition("item", self._drawer_region,
                              np.array([0.10, 0.12, 0.06])),
        ])
        d = self._dominant
        return [f"open the top drawer with {_assistive(d)} hand and put the "
                f"item in the top drawer with {d} hand"]

    def target_object_name(self):
        return "top_handle"

    def dominant_arm(self) -> str:
        return self._dominant

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        handle = self.backend.get_object("top_handle")
        item = self.backend.get_object("item")
        a, d = _assistive(dominant_arm), dominant_arm
        pull = np.array([0.0, np.sign(handle.position[1]
                                      - self._drawer_region[1]), 0.0])
        drop = self._drawer_region + [0, 0, 0.03]
        return [
            Waypoint(a, handle.position + pull * 0.08, DOWN, 1.0,
                     label="approach_handle"),
            Waypoint(a, handle.position, DOWN, 0.0, label="grasp_handle"),
            Waypoint(a, handle.position + pull * 0.18, DOWN, 1.0, label="pull_open"),
            Waypoint(d, item.position + [0, 0, 0.10], DOWN, 1.0,
                     label="approach_item"),
            Waypoint(d, item.position, DOWN, 0.0, label="grasp_item"),
            Waypoint(d, drop, DOWN, None, label="carry"),
            Waypoint(d, drop, DOWN, 1.0, dwell=5, label="drop"),
        ]


class HandOverItem(BimanualTask):
    """The near arm passes the item to the far (dominant) arm."""

    name = "hand_over_item"
    num_variations = 2

    def init_task(self) -> None:
        pass

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        side = -1.0 if variation % 2 == 0 else 1.0
        item_pos = np.array([rng.uniform(0.2, 0.45),
                             side * rng.uniform(0.2, 0.4), TABLE_Z + 0.02])
        self.backend.add_object(SceneObject(
            "cube", item_pos, size=np.full(3, 0.04), color=(0.9, 0.2, 0.9)))
        # cube near the right arm -> LEFT dominant (receiver), and vice versa
        self._dominant = "left" if side < 0 else "right"
        self.register_success_conditions([
            GraspedCondition("cube", self._dominant),
        ])
        d = self._dominant
        return [f"pass the item from the {_assistive(d)} hand to the {d} hand"]

    def target_object_name(self):
        return "cube"

    def dominant_arm(self) -> str:
        return self._dominant

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        cube = self.backend.get_object("cube")
        d = dominant_arm
        a = _assistive(d)
        # Meet point DIRECTLY above the cube's spawn. Every keyframe below is a
        # fixed offset of the crop center (the VLM crop latches onto the cube's
        # start position), mirroring the reference where all handover waypoints
        # are fixed offsets of the task's workspace dummy (hand_over_item.py:
        # 40-58) — deterministic in crop frame. Round-4's variant nudged the
        # meet point by -sign(cube.y)*0.05, which made the target FLIP with the
        # episode variation while the crop-centered voxel grids of the two
        # variations look identical; the CE loss averaged the two answers
        # (probe_replay_accuracy: trans_exact 0.30, repeated |dt|=9 = the
        # 2*0.05/res mirror distance; trans_loss plateau at ~log 2). The
        # exchange height is also kept low enough that the whole keyframe stack
        # stays INSIDE the crop's z-range (cube_z + 0.3 = 1.08): the round-4
        # reach/descend keyframes at z=1.15/1.11 clamped onto the crop's top
        # voxel plane, collapsing the receiver's stage separation (live probe:
        # arm pinned at zmax - res/2).
        meet = np.array([cube.position[0], cube.position[1], TABLE_Z + 0.16])
        # STRICT a/d ALTERNATION. The eval rollout alternates assistive (even
        # steps) and dominant (odd steps) turns (rollout_generator.py:233-244);
        # a demo that runs one arm's waypoints back-to-back (the reference
        # groups all assistive dummies before all dominant ones,
        # task_two_robots.py _get_waypoints_dominant_assistive) trains each
        # policy only on contexts where the OTHER arm sits at its
        # demo-schedule pose. hand_over is the one benchmark task whose
        # keyframes revisit the same position (present/release at the meet
        # point), so the policy must disambiguate its stage from the other
        # arm's configuration — and at eval the other arm is always at its
        # ALTERNATION pose, never its demo pose. Round-5 live probe: the giver
        # saw the receiver hovering at the meet (an end-of-demo context) on
        # its second turn and skipped straight to 'withdraw'; both arms then
        # looped (probe_policy_open_loop --live: replay exact-match 0.988,
        # val 0-4%). Interleaving the waypoints a,d,a,d makes every training
        # context exactly the context the alternating rollout produces.
        # The giver's release is 1 cm above the presentation pose and the
        # receiver's align/receive differ by 2 cm so the no-duplicate keyframe
        # scanner (demo_loading_utils.py:274-289) keeps every gripper flip on
        # a moved pose. TCP separation stays >= 4 cm at the tightest step
        # (backend ARM_MIN_SEPARATION = 2.5 cm). The released cube holds its
        # pose (kinematic backend, no gravity) until the receiver closes
        # 4 cm above it — inside GRASP_RADIUS, on the approach axis.
        # Three keyframes per arm (the reference's structure: 3 dummies per
        # arm, hand_over_item.py:16-24), every stage >= 3 cm from its
        # neighbors (>= 2.5 voxels at the 50-voxel crop) so each policy's
        # next-keyframe map is unique in its OWN pose alone: giver
        # 0.88-open -> 0.78-close -> 0.93-open, receiver 1.04 -> 1.00 ->
        # 0.97-close (z at the sampled episode). Success (receiver grasps)
        # lands on eval turn 5 of the 25-step horizon.
        return [
            Waypoint(a, cube.position + [0, 0, 0.10], DOWN, 1.0, label="approach"),
            Waypoint(d, meet + [0, 0, 0.12], DOWN, 1.0, label="reach"),
            Waypoint(a, cube.position, DOWN, 0.0, label="grasp"),
            Waypoint(d, meet + [0, 0, 0.08], DOWN, 1.0, label="descend"),
            Waypoint(a, meet + [0, 0, 0.01], DOWN, 1.0, label="release"),
            Waypoint(d, meet + [0, 0, 0.05], DOWN, 0.0, label="receive"),
        ]


class OpenJarDifferentAppearance(OpenJar):
    """Rebuttal-experiment variant: jars of different appearances cycled per
    episode (rollout_generator.py:27-42 swaps task_design_open_jar{,_4084,_4403}
    .ttt scenes; here the jar's color/scale cycles with the variation index)."""

    name = "open_jar_different_appearance"
    num_variations = 6  # 2 sides x 3 appearances

    APPEARANCES = [  # (jar color, lid color, scale) per 'scene file'
        ((0.9, 0.1, 0.1), (0.2, 0.2, 0.9), 1.00),
        ((0.2, 0.6, 0.9), (0.9, 0.8, 0.1), 1.15),   # open_jar_4084 analogue
        ((0.15, 0.7, 0.3), (0.7, 0.2, 0.7), 0.85),  # open_jar_4403 analogue
    ]

    def init_episode(self, variation: int, rng) -> List[str]:
        desc = super().init_episode(variation % 2, rng)
        jar_color, lid_color, scale = self.APPEARANCES[
            (variation // 2) % len(self.APPEARANCES)]
        jar = self.backend.get_object("jar")
        lid = self.backend.get_object("lid")
        jar.color, lid.color = jar_color, lid_color
        jar.size = jar.size * scale
        lid.size = lid.size * scale
        # keep the lid seated on the rescaled jar (the parent's +0.07*scale
        # convention, with scale read back from the jar's rescaled height):
        # otherwise a 1.15x lid sinks into the jar and a 0.85x one floats
        lid.position = jar.position + [0, 0, 0.07 * (jar.size[2] / 0.10)]
        return desc


class OpenDrawerDifferentAppearance(OpenDrawer):
    """Rebuttal variant: drawer cabinets with different textures
    (task_design_open_drawer_texture{2,3}.ttt analogues)."""

    name = "open_drawer_different_appearance"
    num_variations = 6

    APPEARANCES = [
        ((0.5, 0.35, 0.2), (0.8, 0.8, 0.2)),
        ((0.25, 0.25, 0.3), (0.9, 0.5, 0.1)),  # texture2 analogue
        ((0.7, 0.65, 0.55), (0.3, 0.3, 0.9)),  # texture3 analogue
    ]

    def init_episode(self, variation: int, rng) -> List[str]:
        desc = super().init_episode(variation % 2, rng)
        cab_color, handle_color = self.APPEARANCES[
            (variation // 2) % len(self.APPEARANCES)]
        self.backend.get_object("cabinet").color = cab_color
        self.backend.get_object("bottom_handle").color = handle_color
        return desc


class CloseJar(BimanualTask):
    """Assistive steadies the jar; dominant fetches the lid and screws it back on
    (rlbench/tasks/close_jar.py, bimanual-ified like open_jar)."""

    name = "close_jar"
    num_variations = 2

    def init_task(self) -> None:
        pass

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        side = -1.0 if variation % 2 == 0 else 1.0
        jar_pos = np.array([rng.uniform(0.15, 0.45),
                            side * rng.uniform(0.1, 0.35), TABLE_Z + 0.05])
        self.backend.add_object(SceneObject(
            "jar", jar_pos, size=np.array([0.08, 0.08, 0.10]),
            color=(0.9, 0.1, 0.1)))
        # collision-checked lid spawn: independent uniform draws could embed
        # the lid in the jar wall (the PlacementError retry in reset() handles
        # a saturated scene, like every catalogue task)
        lid_size = np.array([0.09, 0.09, 0.02])
        lid_pos = sample_disjoint_position(
            self.backend, rng,
            [0.15, min(side * 0.0, side * 0.08), TABLE_Z + 0.01],
            [0.45, max(side * 0.0, side * 0.08), TABLE_Z + 0.01], lid_size)
        self.backend.add_object(SceneObject(
            "lid", lid_pos, size=lid_size, color=(0.2, 0.2, 0.9)))
        self._dominant = "right" if side < 0 else "left"
        self._jar_top = jar_pos + [0, 0, 0.07]
        self.register_success_conditions([
            DetectedCondition("lid", self._jar_top, np.array([0.05, 0.05, 0.05])),
            GraspedCondition("jar", _assistive(self._dominant)),
        ])
        d = self._dominant
        return [f"hold the jar with {_assistive(d)} hand and screw the lid back "
                f"on the jar with {d} hand in a clockwise direction"]

    def target_object_name(self):
        return "jar"

    def dominant_arm(self) -> str:
        return self._dominant

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        jar = self.backend.get_object("jar")
        lid = self.backend.get_object("lid")
        a, d = _assistive(dominant_arm), dominant_arm
        return [
            Waypoint(a, jar.position + [0, 0, 0.12], DOWN, 1.0, label="approach_jar"),
            Waypoint(a, jar.position, DOWN, 0.0, label="steady_jar"),
            Waypoint(d, lid.position + [0, 0, 0.10], DOWN, 1.0, label="approach_lid"),
            Waypoint(d, lid.position, DOWN, 0.0, label="grasp_lid"),
            Waypoint(d, self._jar_top + [0, 0, 0.10], DOWN, None, label="carry_lid"),
            Waypoint(d, self._jar_top, DOWN, None, label="seat_lid"),
            Waypoint(d, self._jar_top, DOWN, 1.0, dwell=5, label="screw_release"),
        ]


class CloseDrawer(BimanualTask):
    """Assistive steadies the cabinet; dominant pushes the open drawer shut
    (rlbench/tasks/close_drawer.py)."""

    name = "close_drawer"
    num_variations = 2

    def init_task(self) -> None:
        pass

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        facing = -1.0 if variation % 2 == 0 else 1.0
        base = np.array([rng.uniform(0.2, 0.4), rng.uniform(-0.1, 0.1),
                         TABLE_Z + 0.12])
        self.backend.add_object(SceneObject(
            "cabinet", base, size=np.array([0.25, 0.3, 0.25]),
            color=(0.5, 0.35, 0.2), static=True))
        # drawer starts pulled OUT by 0.18 along the facing axis
        handle_pos = base + [0.0, facing * (0.18 + 0.18), -0.06]
        self.backend.add_object(SceneObject(
            "bottom_handle", handle_pos, size=np.full(3, 0.03),
            color=(0.8, 0.8, 0.2)))
        self._dominant = "right" if facing < 0 else "left"
        self._closed_pos = base + [0.0, facing * 0.18, -0.06]
        self.register_success_conditions([
            DetectedCondition("bottom_handle", self._closed_pos,
                              np.array([0.06, 0.06, 0.06])),
        ])
        d = self._dominant
        return [f"hold the drawer with {_assistive(d)} hand and close the bottom "
                f"drawer with {d} hand"]

    def target_object_name(self):
        return "bottom_handle"

    def dominant_arm(self) -> str:
        return self._dominant

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        cab = self.backend.get_object("cabinet")
        handle = self.backend.get_object("bottom_handle")
        a, d = _assistive(dominant_arm), dominant_arm
        return [
            Waypoint(a, cab.position + [0, 0, 0.20], DOWN, 1.0, label="hold_top"),
            Waypoint(a, cab.position + [0, 0, 0.14], DOWN, 0.0, label="press_top"),
            Waypoint(d, handle.position + [0, 0, 0.08], DOWN, 1.0,
                     label="approach_handle"),
            Waypoint(d, handle.position, DOWN, 0.0, label="grasp_handle"),
            Waypoint(d, self._closed_pos, DOWN, None, label="push_shut"),
            Waypoint(d, self._closed_pos, DOWN, 1.0, dwell=5, label="release"),
        ]


class TakeItemOutOfDrawer(BimanualTask):
    """Dominant pulls the drawer open; assistive lifts the item out
    (rlbench/tasks/take_item_out_of_drawer.py)."""

    name = "take_item_out_of_drawer"
    num_variations = 2

    def init_task(self) -> None:
        pass

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        facing = -1.0 if variation % 2 == 0 else 1.0
        base = np.array([rng.uniform(0.2, 0.4), rng.uniform(-0.1, 0.1),
                         TABLE_Z + 0.12])
        self.backend.add_object(SceneObject(
            "cabinet", base, size=np.array([0.25, 0.3, 0.25]),
            color=(0.5, 0.35, 0.2), static=True))
        handle_pos = base + [0.0, facing * 0.18, -0.06]
        self.backend.add_object(SceneObject(
            "bottom_handle", handle_pos, size=np.full(3, 0.03),
            color=(0.8, 0.8, 0.2)))
        # the item sits in the (conceptual) drawer, next to the handle
        self.backend.add_object(SceneObject(
            "item", handle_pos + [0.06, 0.0, 0.0], size=np.full(3, 0.035),
            color=(0.2, 0.8, 0.2)))
        self._dominant = "right" if facing < 0 else "left"
        self.register_success_conditions([
            ObjectAboveCondition("item", TABLE_Z + 0.25),
            GraspedCondition("item", _assistive(self._dominant)),
        ])
        d = self._dominant
        return [f"open the bottom drawer with {d} hand and take the item out of "
                f"the drawer with {_assistive(d)} hand"]

    def target_object_name(self):
        return "item"

    def dominant_arm(self) -> str:
        return self._dominant

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        cab = self.backend.get_object("cabinet")
        handle = self.backend.get_object("bottom_handle")
        item = self.backend.get_object("item")
        a, d = _assistive(dominant_arm), dominant_arm
        pull = np.array([0.0, np.sign(handle.position[1] - cab.position[1]), 0.0])
        return [
            Waypoint(d, handle.position + pull * 0.08, DOWN, 1.0,
                     label="approach_handle"),
            Waypoint(d, handle.position, DOWN, 0.0, label="grasp_handle"),
            Waypoint(d, handle.position + pull * 0.18, DOWN, 1.0,
                     label="pull_open"),
            Waypoint(a, item.position + [0, 0, 0.10], DOWN, 1.0,
                     label="approach_item"),
            Waypoint(a, item.position, DOWN, 0.0, label="grasp_item"),
            Waypoint(a, item.position + [0, 0, 0.30], DOWN, None, label="lift_out"),
        ]


class OpenJarTwoArms(OpenJar):
    """The 'both' arm-mode jar task (rlbench/tasks/open_jar_two_arms.py): same
    scene and demo script, but the policy contract is fixed right/left
    alternation instead of dominant/assistive."""

    name = "open_jar_two_arms"


class SweepToDustpan(BimanualTask):
    """One arm holds the dustpan; the other sweeps the dirt block into it
    (rlbench/tasks/sweep_to_dustpan.py, naturally bimanual here)."""

    name = "sweep_to_dustpan"
    num_variations = 2

    def init_task(self) -> None:
        pass

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        side = -1.0 if variation % 2 == 0 else 1.0
        pan_pos = np.array([rng.uniform(0.2, 0.4),
                            side * rng.uniform(0.2, 0.35), TABLE_Z + 0.02])
        dirt_pos = np.array([rng.uniform(0.2, 0.45),
                             -side * rng.uniform(0.1, 0.3), TABLE_Z + 0.01])
        self.backend.add_object(SceneObject(
            "dustpan", pan_pos, size=np.array([0.12, 0.12, 0.03]),
            color=(0.3, 0.3, 0.35), static=True))
        self.backend.add_object(SceneObject(
            "dirt", dirt_pos, size=np.full(3, 0.025), color=(0.45, 0.3, 0.15)))
        self.backend.add_object(SceneObject(
            "broom", dirt_pos + [0.0, -side * 0.12, 0.0],
            size=np.array([0.03, 0.03, 0.15]), color=(0.9, 0.7, 0.2)))
        # the arm nearest the dustpan holds it; the other sweeps (dominant)
        self._dominant = "right" if side > 0 else "left"
        self.register_success_conditions([
            DetectedCondition("dirt", pan_pos + [0, 0, 0.02],
                              np.array([0.08, 0.08, 0.06])),
        ])
        d = self._dominant
        return [f"hold the dustpan with {_assistive(d)} hand and sweep the dirt "
                f"into it with {d} hand"]

    def target_object_name(self):
        return "dustpan"

    def dominant_arm(self) -> str:
        return self._dominant

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        pan = self.backend.get_object("dustpan")
        dirt = self.backend.get_object("dirt")
        a, d = _assistive(dominant_arm), dominant_arm
        # deposit point offset from the pan-holding TCP (pan + [0,0,0.04]) by
        # ~5.4cm — landing the dominant TCP ON the assistive TCP trips the
        # backend's ARM_MIN_SEPARATION collision failure while staying well
        # inside the success region (+-0.08/0.08/0.06 around pan + 0.02z)
        drop = pan.position + [0.05, 0, 0.06]
        return [
            Waypoint(a, pan.position + [0, 0, 0.10], DOWN, 1.0, label="reach_pan"),
            Waypoint(a, pan.position + [0, 0, 0.04], DOWN, 0.0, label="hold_pan"),
            Waypoint(d, dirt.position + [0, 0, 0.08], DOWN, 1.0,
                     label="approach_dirt"),
            Waypoint(d, dirt.position, DOWN, 0.0, label="catch_dirt"),
            Waypoint(d, drop, DOWN, None, label="sweep"),
            Waypoint(d, drop, DOWN, 1.0, dwell=5, label="deposit"),
        ]


class StraightenRope(BimanualTask):
    """Both arms pull opposite rope ends apart until the rope is taut
    (rlbench/tasks/straighten_rope.py — the genuinely two-handed task)."""

    name = "straighten_rope"
    num_variations = 2

    ROPE_LENGTH = 0.5

    def init_task(self) -> None:
        pass

    def init_episode(self, variation: int, rng) -> List[str]:
        self.backend.remove_all_objects()
        mid = np.array([rng.uniform(0.25, 0.4), rng.uniform(-0.05, 0.05),
                        TABLE_Z + 0.02])
        # crumpled rope: ends start close together
        gap = 0.12
        self.backend.add_object(SceneObject(
            "rope_head", mid + [0.0, gap / 2, 0.0], size=np.full(3, 0.03),
            color=(0.9, 0.9, 0.9)))
        self.backend.add_object(SceneObject(
            "rope_tail", mid + [0.0, -gap / 2, 0.0], size=np.full(3, 0.03),
            color=(0.6, 0.6, 0.6)))
        self._dominant = "right" if variation % 2 == 0 else "left"
        self._mid = mid

        class _TautCondition(Condition):
            def __init__(self, length):
                self._length = length

            def satisfied(self, backend) -> bool:
                head = backend.get_object("rope_head").position
                tail = backend.get_object("rope_tail").position
                return float(np.linalg.norm(head - tail)) >= self._length * 0.9

        self.register_success_conditions([_TautCondition(self.ROPE_LENGTH)])
        return ["straighten the rope by pulling its two ends apart with "
                "both hands"]

    def target_object_name(self):
        return "rope_head"

    def dominant_arm(self) -> str:
        return self._dominant

    def get_waypoints(self, dominant_arm: str) -> List[Waypoint]:
        head = self.backend.get_object("rope_head")
        tail = self.backend.get_object("rope_tail")
        # left arm takes the +y end, right the -y end, regardless of dominance
        left_end, right_end = (head, tail) if head.position[1] > \
            tail.position[1] else (tail, head)
        stretch = self.ROPE_LENGTH / 2
        return [
            Waypoint("left", left_end.position + [0, 0, 0.08], DOWN, 1.0,
                     label="approach_left_end"),
            Waypoint("left", left_end.position, DOWN, 0.0, label="grasp_left_end"),
            Waypoint("right", right_end.position + [0, 0, 0.08], DOWN, 1.0,
                     label="approach_right_end"),
            Waypoint("right", right_end.position, DOWN, 0.0,
                     label="grasp_right_end"),
            Waypoint("left", self._mid + [0, stretch, 0.02], DOWN, None,
                     label="pull_left"),
            Waypoint("right", self._mid + [0, -stretch, 0.02], DOWN, None,
                     label="pull_right"),
        ]


TASK_REGISTRY = {
    t.name: t for t in (
        OpenJar, OpenDrawer, PutItemInDrawer, HandOverItem,
        OpenJarDifferentAppearance, OpenDrawerDifferentAppearance,
        CloseJar, CloseDrawer, TakeItemOutOfDrawer, OpenJarTwoArms,
        SweepToDustpan, StraightenRope,
    )
}

# extended catalogue (coordinated bimanual + classic single-arm tasks) — imported
# last so tasks_extra can subclass the canonical four above
from voxactb_tpu_torch.sim.tasks_extra import EXTRA_TASKS  # noqa: E402

TASK_REGISTRY.update({t.name: t for t in EXTRA_TASKS})

# broad single-arm catalogue (press / pick-lift / pick-place / slide / hinge /
# stack families — the rlbench/tasks/ recipe vocabulary)
from voxactb_tpu_torch.sim.tasks_catalogue import CATALOGUE_TASKS  # noqa: E402

TASK_REGISTRY.update({t.name: t for t in CATALOGUE_TASKS})

from voxactb_tpu_torch.sim.tasks_catalogue2 import CATALOGUE2_TASKS  # noqa: E402

TASK_REGISTRY.update({t.name: t for t in CATALOGUE2_TASKS})
