"""Camera-geometry helpers (host-side NumPy), act-path subset of
``voxactb_tpu.utils.observation``."""

from __future__ import annotations

import numpy as np


def point_to_pixel_index(point: np.ndarray, extrinsics: np.ndarray,
                         intrinsics: np.ndarray):
    """World point -> (px, py) pixel index through a camera (helpers/utils.py:127-137),
    with the reference's mirrored-projection convention."""
    p = np.array([point[0], point[1], point[2], 1.0])
    cam = np.linalg.inv(extrinsics) @ p
    px_, py_, pz = cam[:3]
    px = 2 * intrinsics[0, 2] - int(-intrinsics[0, 0] * (px_ / pz) + intrinsics[0, 2])
    py = 2 * intrinsics[1, 2] - int(-intrinsics[1, 1] * (py_ / pz) + intrinsics[1, 2])
    return px, py
