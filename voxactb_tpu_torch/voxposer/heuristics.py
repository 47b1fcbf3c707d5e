"""Dominant-arm selection heuristics (acting vs stabilizing role assignment).

Counterpart of ``determine_dominant_hand`` (peract/voxposer/envs/rlbench_env.py:530-615).
Pure geometry over quantities any env can provide: object surface normals or centroid,
the front camera's look-at vector, and the two robot base positions.

Rules (thresholds are behavioral constants from the reference):
- OpenDrawer:      angle(front-cam look-at, mean bottom-handle normal) >= 135 -> right.
- PutItemInDrawer: angle(front-cam look-at, mean top-handle normal)    >= 134 -> left.
- OpenJar:         jar centroid closer to the right arm base           -> right.
- HandOverItem:    cube closer to the right arm base -> LEFT (the dominant arm
  receives the hand-over, so it is the far one).

A copy of ``voxactb_tpu.voxposer.heuristics``, kept in the port so that it imports nothing
of the JAX package; host code, the same on every device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


def angle_between_deg(v1, v2) -> float:
    v1 = np.asarray(v1, np.float64)
    v2 = np.asarray(v2, np.float64)
    cos = float(np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2) + 1e-12))
    return math.degrees(math.acos(np.clip(cos, -1.0, 1.0)))


def dominant_arm_from_normals(lookat: np.ndarray, normals: np.ndarray,
                              threshold_deg: float, ge_arm: str, lt_arm: str) -> str:
    """Shared drawer rule: mean-normal vs look-at angle thresholding."""
    mean_normal = np.mean(np.asarray(normals, np.float64), axis=0)
    # the reference takes acos of the raw dot with an averaged (non-unit) normal —
    # normalize for robustness; threshold semantics unchanged for unit inputs
    angle = angle_between_deg(lookat, mean_normal)
    return ge_arm if angle >= threshold_deg else lt_arm


def dominant_arm_by_distance(object_centroid, right_base, left_base,
                             closer_arm_dominant: bool = True) -> str:
    d_right = math.dist(np.asarray(object_centroid), np.asarray(right_base))
    d_left = math.dist(np.asarray(object_centroid), np.asarray(left_base))
    closer = "right" if d_right < d_left else "left"
    if closer_arm_dominant:
        return closer
    return "left" if closer == "right" else "right"


def determine_dominant_hand(
    task_name: str,
    *,
    front_lookat: Optional[Sequence[float]] = None,
    object_normals: Optional[np.ndarray] = None,
    object_centroid: Optional[Sequence[float]] = None,
    right_arm_base: Optional[Sequence[float]] = None,
    left_arm_base: Optional[Sequence[float]] = None,
) -> str:
    """Dispatch the per-task rule. Task names accept both CamelCase and snake_case."""
    t = task_name.replace("_", "").lower()
    if t == "opendrawer":
        return dominant_arm_from_normals(front_lookat, object_normals,
                                         135.0, "right", "left")
    if t == "putitemindrawer":
        return dominant_arm_from_normals(front_lookat, object_normals,
                                         134.0, "left", "right")
    if t == "openjar":
        return dominant_arm_by_distance(object_centroid, right_arm_base,
                                        left_arm_base, closer_arm_dominant=True)
    if t == "handoveritem":
        # the receiving (far) arm is dominant (rlbench_env.py:600-613)
        return dominant_arm_by_distance(object_centroid, right_arm_base,
                                        left_arm_base, closer_arm_dominant=False)
    if object_centroid is not None and right_arm_base is not None \
            and left_arm_base is not None:
        # tasks beyond the benchmarked four: closer-arm default (the OpenJar
        # rule generalizes — reach the object with the nearer arm)
        return dominant_arm_by_distance(object_centroid, right_arm_base,
                                        left_arm_base, closer_arm_dominant=True)
    raise NotImplementedError(f"no dominant-arm rule for task {task_name!r}")
