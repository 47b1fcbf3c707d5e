"""Observation extraction and camera-geometry helpers (host-side NumPy).

Counterparts of peract/helpers/utils.py: ``extract_obs`` (:516-633, proprio assembly per
arm mode + timestep channel), ``point_to_pixel_index`` (:127-137). These run on host at
env-step frequency — the device program consumes the arrays they produce.

Layout note: this framework keeps images channels-LAST (H, W, C) end to end; the
reference transposes to channel-first for torch (utils.py:579-583), which we never do.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np


def point_to_pixel_index(point: np.ndarray, extrinsics: np.ndarray,
                         intrinsics: np.ndarray):
    """World point -> (px, py) pixel index through a camera (helpers/utils.py:127-137).

    Reproduces the reference's mirrored-projection convention (the double reflection
    around the principal point).
    """
    p = np.array([point[0], point[1], point[2], 1.0])
    cam = np.linalg.inv(extrinsics) @ p
    px_, py_, pz = cam[:3]
    px = 2 * intrinsics[0, 2] - int(-intrinsics[0, 0] * (px_ / pz) + intrinsics[0, 2])
    py = 2 * intrinsics[1, 2] - int(-intrinsics[1, 1] * (py_ / pz) + intrinsics[1, 2])
    return px, py


@dataclass
class BimanualObservation:
    """Raw per-step observation from a bimanual env (Observation2Robots,
    rlbench/backend/observation_two_robots.py:5-74) — plain numpy, channels-last."""

    # cameras: name -> array
    rgb: Dict[str, np.ndarray] = field(default_factory=dict)           # [H,W,3] uint8/float
    point_cloud: Dict[str, np.ndarray] = field(default_factory=dict)   # [H,W,3] float32
    misc: Dict[str, np.ndarray] = field(default_factory=dict)          # cam in/extrinsics

    # right arm
    joint_positions_right: Optional[np.ndarray] = None
    gripper_right_open: float = 1.0
    gripper_right_pose: Optional[np.ndarray] = None       # [7] xyz + xyzw quat
    gripper_right_joint_positions: Optional[np.ndarray] = None  # [2]
    # left arm
    joint_positions_left: Optional[np.ndarray] = None
    gripper_left_open: float = 1.0
    gripper_left_pose: Optional[np.ndarray] = None
    gripper_left_joint_positions: Optional[np.ndarray] = None

    ignore_collisions: float = 0.0
    target_object_pos: Optional[np.ndarray] = None        # VLM crop point
    auto_crop_radius: float = 0.0
    joint_velocities_right: Optional[np.ndarray] = None
    joint_velocities_left: Optional[np.ndarray] = None


def _arm_state(gripper_open: float, finger_joints: np.ndarray) -> np.ndarray:
    return np.concatenate([[gripper_open], np.clip(finger_joints, 0.0, 0.04)])


def extract_obs(
    obs: BimanualObservation,
    cameras: Sequence[str],
    t: int = 0,
    episode_length: int = 10,
    which_arm: str = "right",
    keypoint_label: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Flatten an observation into the dict the agents/replay consume.

    Mirrors helpers/utils.py:516-633: proprio assembly per arm mode, the normalized
    reverse-time channel ``(1 - t/(T-1)) * 2 - 1``, per-camera rgb/pcd + in/extrinsics,
    and the arm-ID channel when ``keypoint_label`` is provided (``arm_id_to_proprio``).
    """
    out: Dict[str, np.ndarray] = {}

    right = _arm_state(obs.gripper_right_open, obs.gripper_right_joint_positions)
    left = _arm_state(obs.gripper_left_open, obs.gripper_left_joint_positions)

    if which_arm == "right":
        robot_state = right
    elif which_arm == "left":
        robot_state = left
    elif which_arm in ("dominant", "assistive"):
        robot_state = np.concatenate([left, right])
    elif which_arm == "both":
        out["low_dim_state_right_arm"] = right.astype(np.float32)
        out["low_dim_state_left_arm"] = left.astype(np.float32)
        robot_state = None
    else:
        raise ValueError(f"unknown which_arm {which_arm!r}")

    time_channel = (1.0 - (t / float(episode_length - 1))) * 2.0 - 1.0
    if which_arm == "both":
        for k in ("low_dim_state_right_arm", "low_dim_state_left_arm"):
            out[k] = np.concatenate([out[k], [time_channel]]).astype(np.float32)
        # the two-head encoder consumes ONE stacked vector (right then left,
        # 4 each — perceiver_lang_io.py:584-600's proprio pair); store it so
        # the replay's low_dim_state column is not zero-filled for 'both'
        out["low_dim_state"] = np.concatenate(
            [out["low_dim_state_right_arm"],
             out["low_dim_state_left_arm"]]).astype(np.float32)
    elif keypoint_label is None:
        out["low_dim_state"] = np.concatenate(
            [robot_state, [time_channel]]).astype(np.float32)
    elif which_arm in ("dominant", "assistive"):
        out["low_dim_state"] = np.concatenate(
            [robot_state, [time_channel], [keypoint_label]]).astype(np.float32)
    else:
        # arm_pred_input: replace the timestep with the arm id (utils.py:622-625)
        out["low_dim_state"] = np.concatenate(
            [robot_state, [keypoint_label]]).astype(np.float32)

    out["ignore_collisions"] = np.array([obs.ignore_collisions], np.float32)

    for cam in cameras:
        # accept both layouts: BimanualObservation dicts (obs.rgb["wrist"]) and
        # RLBench-style flat attributes (obs.wrist_rgb) from unpickled demos
        rgb_dict = getattr(obs, "rgb", None)
        if isinstance(rgb_dict, dict) and cam in rgb_dict:
            out[f"{cam}_rgb"] = np.asarray(rgb_dict[cam])
            out[f"{cam}_point_cloud"] = np.asarray(
                obs.point_cloud[cam], np.float32)
        else:
            out[f"{cam}_rgb"] = np.asarray(getattr(obs, f"{cam}_rgb"))
            out[f"{cam}_point_cloud"] = np.asarray(
                getattr(obs, f"{cam}_point_cloud"), np.float32)
        misc = getattr(obs, "misc", {})
        for suffix in ("extrinsics", "intrinsics"):
            key = f"{cam}_camera_{suffix}"
            if key in misc:
                out[key] = np.asarray(misc[key], np.float32)

    return out
