"""Demo -> keyframe transitions -> replay buffer.

Counterpart of ``_get_action`` (launch_utils.py:167-299: keyframe gripper pose ->
canonical quaternion -> per-axis rotation bins + voxel index in the scene/crop bounds),
``_add_keypoints_to_replay`` (:301-489: per-keyframe crop-bounds override from the
VLM-tagged ``target_object_pos``, language embedding, arm labels) and ``fill_replay``
(:491-596) / ``fill_multi_task_replay`` (:598-660 — one process per task writing into
a Manager-backed store; here a thread pool into the lock-protected buffer, since the
store is in-process numpy, not pickled files).

Host-side discretization uses scipy Rotation — bit-identical to the reference oracle;
the device path (ops/geometry.py) is covered by its own parity tests.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
from scipy.spatial.transform import Rotation

from voxactb_tpu_torch.replay.buffer import UniformReplayBuffer
from voxactb_tpu_torch.utils.keypoints import KeypointConfig, keypoint_discovery
from voxactb_tpu_torch.utils.observation import extract_obs

REWARD_SCALE = 100.0  # launch_utils.py:32


def split_left_right_instruction(description: str):
    """'<left-arm clause> and <right-arm clause>' -> (left, right) instruction
    halves (utils.py:24-30). The reference asserts the 'left hand'/'right hand'
    pattern; our scripted tasks don't all follow it, so fall back to the full
    description for both arms when it is absent."""
    parts = description.split(" and ")
    left, right = parts[0], parts[-1]
    if "left" in left and "right" in right and "right" not in left \
            and "left" not in right:
        return left, right
    return description, description


def quaternion_to_discrete_euler_np(quat: np.ndarray, resolution: int) -> np.ndarray:
    euler = Rotation.from_quat(quat).as_euler("xyz", degrees=True) + 180.0
    disc = np.around(euler / resolution).astype(np.int64)
    disc[disc == int(360 / resolution)] = 0
    return disc


def point_to_voxel_index_np(point, voxel_size: int, bounds) -> np.ndarray:
    bounds = np.asarray(bounds)
    bb_mins, bb_maxs = bounds[0:3], bounds[3:6]
    res = (bb_maxs - bb_mins) / (np.array([voxel_size] * 3) + 1e-12)
    idx = np.minimum(
        np.floor((point - bb_mins) / (res + 1e-12)).astype(np.int32),
        voxel_size - 1,
    )
    return np.maximum(idx, 0)


def scene_bounds_from_crop_np(radius: float, target_pos) -> List[float]:
    p = np.round(np.asarray(target_pos, np.float64), 2)
    return [p[0] - radius, p[1] - radius, p[2] - radius,
            p[0] + radius, p[1] + radius, p[2] + radius]


def discretize_keyframe(obs_tp1, obs_tm1, scene_bounds, voxel_size: int,
                        rotation_resolution: int, arm: str):
    """One arm's keyframe -> (trans_idx[3], rot_grip_idx[4], ignore_collisions,
    gripper_pose8) (launch_utils.py:178-232)."""
    pose = np.asarray(getattr(obs_tp1, f"gripper_{arm}_pose"), np.float64)
    gripper_open = float(getattr(obs_tp1, f"gripper_{arm}_open"))
    quat = pose[3:] / np.linalg.norm(pose[3:])
    if quat[-1] < 0:
        quat = -quat
    rot = quaternion_to_discrete_euler_np(quat, rotation_resolution)
    trans = point_to_voxel_index_np(pose[:3], voxel_size, scene_bounds)
    ignore_collisions = int(getattr(obs_tm1, "ignore_collisions", 0))
    rot_grip = np.concatenate([rot, [int(gripper_open)]]).astype(np.int32)
    action = np.concatenate([pose, [gripper_open]]).astype(np.float32)
    return trans.astype(np.int32), rot_grip, ignore_collisions, action


def reference_split_arm_fn(num_demos: int):
    """The reference's data convention (launch_utils.py:542-560): demos are split in
    half, first half LEFT-dominant then right (equivalently first half
    right-assistive). Returns fn(demo_index) -> dominant arm; ``fill_replay`` flips
    it for 'assistive' mode."""

    half = int(num_demos / 2)

    def fn(d_idx: int) -> str:
        return "left" if (num_demos == 1 or d_idx < half) else "right"

    return fn


def add_keypoints_to_replay(
    replay: UniformReplayBuffer,
    demo_observations: Sequence,
    episode_keypoints: Sequence[int],
    description: str,
    cameras: Sequence[str],
    scene_bounds: Sequence[float],
    voxel_size: int,
    rotation_resolution: int,
    which_arm: str,
    lang_encoder: Optional[Callable] = None,
    labels: Optional[Sequence[int]] = None,
    dominant_assistive_arm: str = "",
    crop_target_obj_voxel: bool = False,
    crop_radius=0.3,
    arm_pred_loss: bool = False,
    arm_id_to_proprio: bool = False,
    arm_pred_input: bool = False,
    episode_length: int = 25,
    task_id: int = 0,
    task_name: str = "",
    start_frame: int = 0,
) -> int:
    """Insert one keyframe chain starting from ``start_frame``; returns the count.

    The reference calls this per augmentation start frame (launch_utils.py:577-596):
    the first transition pairs ``demo[start_frame]`` with the next keyframe action,
    then the remaining keyframes chain keyframe -> keyframe.
    """
    if lang_encoder is not None:
        sentence_emb, token_embs = lang_encoder(description)
    else:
        sentence_emb = np.zeros((1, 1024), np.float32)
        token_embs = np.zeros((1, 77, 512), np.float32)
    # multiarm conditions each keyframe on ITS arm's instruction half
    # (launch_utils.py:368-376 via extract_left_and_right_arm_instruction)
    per_arm_lang = None
    if which_arm == "multiarm" and lang_encoder is not None:
        left_d, right_d = split_left_right_instruction(description)
        per_arm_lang = {"left": lang_encoder(left_d),
                        "right": lang_encoder(right_d)}

    obs = demo_observations[start_frame]
    n_added = 0
    for k, keypoint in enumerate(episode_keypoints):
        obs_tp1 = demo_observations[keypoint]
        obs_tm1 = demo_observations[max(0, keypoint - 1)]

        bounds = list(scene_bounds)
        if crop_target_obj_voxel:
            # per-keyframe crop bounds from the VLM-tagged object position
            # (launch_utils.py:341-347); 'auto' uses the episode's stored radius
            target = np.asarray(obs_tp1.target_object_pos)
            radius = (obs_tp1.auto_crop_radius
                      if crop_radius == "auto" and
                      getattr(obs_tp1, "auto_crop_radius", 0.0) != 0.0
                      else (0.3 if crop_radius == "auto" else crop_radius))
            bounds = scene_bounds_from_crop_np(radius, target)

        # 'both' is right-primary: the main trans/rot_grip/gripper_pose keys feed the
        # RIGHT head and the *_left keys feed the left head (launch_utils.py:89-166
        # signature + the two-head train step's label routing)
        arm = dominant_assistive_arm or (
            "right" if which_arm in ("right", "multiarm", "both") else "left"
        )
        if which_arm == "multiarm" and labels is not None:
            arm = "right" if labels[k] == 0 else "left"

        trans, rot_grip, ignore_coll, action = discretize_keyframe(
            obs_tp1, obs_tm1, bounds, voxel_size, rotation_resolution, arm)

        terminal = k == len(episode_keypoints) - 1
        reward = REWARD_SCALE if terminal else 0.0

        keypoint_label = labels[k] if (labels is not None and
                                       (arm_id_to_proprio or arm_pred_loss or
                                        arm_pred_input)) else None
        # extract_obs never sees 'multiarm': the reference resolves it to the
        # keyframe's arm first (launch_utils.py:368-383); arm_pred_input swaps
        # the timestep channel for the arm id (utils.py:620-625)
        obs_dict = extract_obs(
            obs, cameras, t=k, episode_length=episode_length,
            which_arm=arm if which_arm == "multiarm" else which_arm,
            keypoint_label=keypoint_label
            if (arm_id_to_proprio or
                (arm_pred_input and which_arm == "multiarm")) else None,
        )

        s_emb, t_embs = (per_arm_lang[arm] if per_arm_lang is not None
                         else (sentence_emb, token_embs))
        transition = {
            **obs_dict,
            "trans_action_indicies": trans,
            "rot_grip_action_indicies": rot_grip,
            "ignore_collisions": [ignore_coll],
            "gripper_pose": getattr(obs_tp1, f"gripper_{arm}_pose"),
            "lang_goal_emb": s_emb[0],
            "lang_token_embs": t_embs[0],
            "reward": reward,
            "terminal": terminal,
            "timeout": False,
            "demo": True,
            "task_id": task_id,
        }
        if crop_target_obj_voxel:
            transition["target_object_scene_bounds"] = np.asarray(bounds, np.float32)
        if arm_pred_loss and labels is not None:
            transition["label"] = [labels[k]]
        if which_arm == "both":
            # 'both' is right-primary (arm == 'right' above), so the second
            # discretization is always the LEFT arm's
            t2, rg2, _, _ = discretize_keyframe(
                obs_tp1, obs_tm1, bounds, voxel_size, rotation_resolution,
                "left")
            transition["trans_action_indicies_left"] = t2
            transition["rot_grip_action_indicies_left"] = rg2
            transition["gripper_pose_left"] = getattr(
                obs_tp1, "gripper_left_pose")

        replay.add(transition)
        n_added += 1
        obs = obs_tp1
    return n_added


def fill_replay(
    replay: UniformReplayBuffer,
    demos: Sequence,  # LoadedDemo-like: .observations + .descriptions
    cameras: Sequence[str],
    scene_bounds: Sequence[float],
    voxel_size: int,
    rotation_resolution: int,
    which_arm: str,
    lang_encoder: Optional[Callable] = None,
    keypoint_cfg: Optional[KeypointConfig] = None,
    dominant_assistive_arm_fn: Optional[Callable] = None,
    demo_augmentation: bool = True,
    demo_augmentation_every_n: int = 10,
    task_id: int = 0,
    task_name: str = "",
    **kwargs,
) -> int:
    """launch_utils.py:491-596: keypoint discovery + per-start-frame insertion.

    With ``demo_augmentation`` every ``every_n``-th intermediate frame becomes a
    starting observation paired against the remaining keyframe chain — the PerAct
    data scheme the reference trains on (launch_utils.py:577-596).
    """
    keypoint_cfg = keypoint_cfg or KeypointConfig()
    # memoize text encodes: every augmentation start frame re-encodes the SAME
    # demo description (and multiarm its two halves) — ~len(demo)/every_n
    # redundant CLIP forwards per demo otherwise
    if lang_encoder is not None:
        _cache: Dict[str, tuple] = {}
        _raw_encoder = lang_encoder

        def lang_encoder(text, _c=_cache, _e=_raw_encoder):  # noqa: F811
            if text not in _c:
                _c[text] = _e(text)
            return _c[text]

    total = 0
    for demo in demos:
        observations = demo.observations
        description = demo.descriptions[0] if demo.descriptions else ""
        da_arm = ""
        if which_arm in ("dominant", "assistive"):
            da_arm = (dominant_assistive_arm_fn(demo)
                      if dominant_assistive_arm_fn else "right")
            if which_arm == "assistive":
                da_arm = "left" if da_arm == "right" else "right"
        result = keypoint_discovery(
            observations, which_arm=which_arm,
            dominant_assistive_arm=da_arm, cfg=keypoint_cfg,
        )
        keypoints, labels = (result if isinstance(result, tuple)
                             else (result, None))

        for i in range(len(observations) - 1):
            if not demo_augmentation and i > 0:
                break
            if i % demo_augmentation_every_n != 0:
                continue
            # drop keyframes the start frame has already passed
            # (launch_utils.py:589-592)
            while keypoints and i >= keypoints[0]:
                keypoints = keypoints[1:]
                if labels is not None:
                    labels = labels[1:]
            if not keypoints:
                break
            total += add_keypoints_to_replay(
                replay, observations, keypoints, description, cameras,
                scene_bounds, voxel_size, rotation_resolution, which_arm,
                lang_encoder=lang_encoder, labels=labels,
                dominant_assistive_arm=da_arm, task_id=task_id,
                task_name=task_name, start_frame=i, **kwargs,
            )
    return total


def fill_multi_task_replay(replay, task_demos: Dict[str, Sequence],
                           max_workers: int = 8, **common) -> Dict[str, int]:
    """One worker per task filling the shared (lock-protected) buffer
    (launch_utils.py:598-660's process pool, without the pickling)."""
    results: Dict[str, int] = {}
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = {
            pool.submit(
                fill_replay, replay, demos, task_id=i, task_name=name, **common
            ): name
            for i, (name, demos) in enumerate(task_demos.items())
        }
        for fut, name in futures.items():
            results[name] = fut.result()
    return results
