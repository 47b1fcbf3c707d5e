"""Episode-start observations for the VLM crop's cells, drawn from a seed
and a traffic file's parameters (``traffic/<name>.json``).

Each observation: a front RGB-D frame of ``frame`` = [H, W] pixels seen by
a pinhole camera (focal ``focal`` px, the camera frame as the world's), a
table plane whose depth runs from ``table_depth``'s far end at the top row
to its near end at the bottom, and one box-shaped object whose top face
covers a share ``object_share`` of the frame, ``object_height`` above the
table, in its task's colour (``colors``) on a grey table; the task drawn
per frame among ``tasks``. Then what the acting policy takes: for each of
its cameras a ``image``² cloud uniform within ``cloud_radius`` of the
object's top centre, colours uniform, the proprio at the episode's first
step and random language embeddings. Every seed draws the same sizes; only
the values differ.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

F32 = np.float32


def frame(rng, t: dict):
    """One front frame: (rgb ``[H, W, 3]`` uint8, cloud ``[H, W, 3]`` f32,
    the object's pixels ``[H, W]``, its top centre ``[3]``, task)."""
    h, w = t["frame"]
    near, far = sorted(rng.uniform(*t["table_depth"], 2))
    far = max(far, near + 0.1)
    v, u = np.mgrid[0:h, 0:w].astype(F32)
    z = far + (near - far) * v / F32(h - 1)
    share = rng.uniform(*t["object_share"])
    aspect = rng.uniform(0.6, 1.6)
    oh = int(np.clip(round(np.sqrt(share * h * w / aspect)), 4, h - 2))
    ow = int(np.clip(round(share * h * w / oh), 4, w - 2))
    top, left = int(rng.integers(0, h - oh)), int(rng.integers(0, w - ow))
    obj = np.zeros((h, w), bool)
    obj[top:top + oh, left:left + ow] = True
    z = np.where(obj, z - F32(rng.uniform(*t["object_height"])), z).astype(F32)
    z = z + rng.normal(0.0, 0.002, (h, w)).astype(F32)  # depth noise, 2 mm
    f = F32(t["focal"])
    cloud = np.stack([(u - F32(w / 2)) * z / f, (v - F32(h / 2)) * z / f, z], -1).astype(F32)
    task = t["tasks"][int(rng.integers(len(t["tasks"])))]
    rgb = np.clip(rng.normal(150.0, 25.0, (h, w, 3)), 0, 255)
    color = np.asarray(t["colors"][task], F32)
    rgb[obj] = np.clip(color + rng.normal(0.0, 8.0, (int(obj.sum()), 3)), 0, 255)
    center = cloud[obj].mean(0).astype(F32)
    return rgb.astype(np.uint8), cloud, obj, center, task


def observations(t: dict, rng, cameras: List[str], low_dim: int) -> List[Dict]:
    """A pool of ``t["pool"]`` episode-start observations: ``front_rgb``,
    ``front_point_cloud``, ``task``, ``_object`` (the object's pixels) and
    the policy's keys (its cameras, ``low_dim_state*``, language)."""
    pool = []
    n, image, r = t["pool"], t["image"], F32(t["cloud_radius"])
    for _ in range(n):
        rgb, cloud, obj, center, task = frame(rng, t)
        obs = {"front_rgb": rgb, "front_point_cloud": cloud, "task": task, "_object": obj,
               "lang_goal_emb": rng.standard_normal(1024, dtype=F32),
               "lang_token_embs": rng.standard_normal((77, 512), dtype=F32)}
        for cam in cameras:
            obs[f"{cam}_rgb"] = rng.integers(0, 256, (image, image, 3), dtype=np.uint8)
            unit = rng.random((image, image, 3), dtype=F32)
            obs[f"{cam}_point_cloud"] = (center - r + 2 * r * unit).astype(F32)
        grip = rng.uniform(0.0, 1.0, 3).astype(F32)
        for arm in ("left", "right"):  # the first step: time channel 1
            obs[f"low_dim_state_{arm}_arm"] = np.concatenate([grip, [F32(1.0)]]).astype(F32)
        obs["low_dim_state"] = obs["low_dim_state_right_arm"][:low_dim]
        pool.append(obs)
    return pool
