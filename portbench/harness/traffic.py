"""The one traffic generator: observations, episodes and replay transitions
drawn from a seed and a traffic file's parameters (``traffic/<name>.json``).

Every seed draws the same sizes and counts; only the values differ. Point
clouds are uniform in a box: the scene box for whole-scene traffic, a box of
``cloud_radius`` around each episode's (or transition's) target for cropped
traffic. Colours are integers in [0, 255] as the cameras give them.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

F32 = np.float32


def crop_bounds(point: np.ndarray, radius: float) -> np.ndarray:
    """Crop point rounded to 2 decimals, +- radius (float32)."""
    p = (np.round(point.astype(F32) * F32(100)) * F32(0.01)).astype(F32)
    return np.concatenate([p - F32(radius), p + F32(radius)]).astype(F32)


def _clouds(rng, count: int, image: int, cameras: int, low, high):
    """Per-camera colours ``[cameras, count, H, W, 3]`` (uint8) and points
    uniform in the box ``low``-``high`` (``[3]``, or ``[count, 3]``: one box
    per observation)."""
    low = np.broadcast_to(np.asarray(low, F32), (count, 3))[None, :, None, None, :]
    high = np.broadcast_to(np.asarray(high, F32), (count, 3))[None, :, None, None, :]
    rgb = rng.integers(0, 256, (cameras, count, image, image, 3), dtype=np.uint8)
    unit = rng.random((cameras, count, image, image, 3), dtype=F32)
    return rgb, (low + (high - low) * unit).astype(F32)


def _targets(rng, count: int, crop: dict):
    return rng.uniform(crop["target_low"], crop["target_high"], (count, 3)).astype(F32)


def observations(t: dict, seed_rng, cameras: List[str], low_dim: int) -> List[Dict]:
    """A pool of ``t["pool"]`` single observations for ``act``; with
    ``t["crop"]`` each episode of ``t["episode_length"]`` shares one target,
    whose crop bounds ride along as ``"_bounds"``."""
    n, image = t["pool"], t["image"]
    crop = t.get("crop")
    if crop:
        ep = t["episode_length"]
        targets = np.repeat(_targets(seed_rng, -(-n // ep), crop), ep, 0)[:n]
        r = F32(crop["cloud_radius"])
        rgb, pts = _clouds(seed_rng, n, image, len(cameras), targets - r, targets + r)
    else:
        rgb, pts = _clouds(seed_rng, n, image, len(cameras), t["points_low"], t["points_high"])
    goal = seed_rng.standard_normal((n, 1024), dtype=F32)
    tokens = seed_rng.standard_normal((n, 77, 512), dtype=F32)
    pool = []
    ep_len = t.get("episode_length", n)
    for i in range(n):
        obs = {"lang_goal_emb": goal[i], "lang_token_embs": tokens[i]}
        for c, cam in enumerate(cameras):
            obs[f"{cam}_rgb"] = rgb[c, i]
            obs[f"{cam}_point_cloud"] = pts[c, i]
        step = i % ep_len
        time_ch = F32((1.0 - step / max(1, ep_len - 1)) * 2.0 - 1.0)
        grip = seed_rng.uniform(0.0, 1.0, 3).astype(F32)
        for arm in ("left", "right"):
            obs[f"low_dim_state_{arm}_arm"] = np.concatenate([grip, [time_ch]]).astype(F32)
        obs["low_dim_state"] = obs["low_dim_state_right_arm"][:low_dim]
        if crop:
            obs["_bounds"] = crop_bounds(targets[i], crop["radius"])
        pool.append(obs)
    return pool


def replay_rows(t: dict, seed_rng, cameras: List[str], low_dim: int) -> List[Dict]:
    """``t["pool"]`` replay transitions with the BC replay signature: clouds
    around a per-row target, the keyframe gripper pose within
    ``t["crop"]["pose_radius"]`` of it, its crop bounds as
    ``target_object_scene_bounds``, random labels. ``reward`` holds the row's
    number (the train step does not read it), so the reference can take the
    rows of a batch from its own copy."""
    n, image, crop = t["pool"], t["image"], t["crop"]
    targets = _targets(seed_rng, n, crop)
    r = F32(crop["cloud_radius"])
    rgb, pts = _clouds(seed_rng, n, image, len(cameras), targets - r, targets + r)
    quat = seed_rng.standard_normal((n, 4)).astype(F32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    pose_r = crop["pose_radius"]
    pos = (targets + seed_rng.uniform(-pose_r, pose_r, (n, 3))).astype(F32)
    num_rot = t["rotation_classes"]
    rows = []
    goal = seed_rng.standard_normal((n, 1024), dtype=F32)
    tokens = seed_rng.standard_normal((n, 77, 512), dtype=F32)
    low = seed_rng.standard_normal((n, low_dim), dtype=F32)
    labels = seed_rng.integers(0, 2, (n, 3))
    rot = seed_rng.integers(0, num_rot, (n, 3))
    for i in range(n):
        row = {"low_dim_state": low[i],
               "trans_action_indicies": np.zeros(3, np.int32),
               "rot_grip_action_indicies": np.asarray([*rot[i], labels[i, 0]], np.int32),
               "ignore_collisions": np.asarray([labels[i, 1]], np.int32),
               "gripper_pose": np.concatenate([pos[i], quat[i]]).astype(F32),
               "lang_goal_emb": goal[i], "lang_token_embs": tokens[i],
               "task_id": np.int32(0), "demo": True, "timeout": False, "terminal": False,
               "reward": F32(i),
               "target_object_scene_bounds": crop_bounds(targets[i], crop["radius"]),
               "label": np.asarray([labels[i, 2]], np.int32)}
        for c, cam in enumerate(cameras):
            row[f"{cam}_rgb"] = rgb[c, i]
            row[f"{cam}_point_cloud"] = pts[c, i]
            row[f"{cam}_camera_extrinsics"] = np.eye(4, dtype=F32)
            row[f"{cam}_camera_intrinsics"] = np.eye(3, dtype=F32)
        rows.append(row)
    return rows
