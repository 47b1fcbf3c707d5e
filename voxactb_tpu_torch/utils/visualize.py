"""Voxel-grid and value-map visualization without a GL stack.

Counterparts of ``visualise_voxel`` (helpers/utils.py:236 — pyrender/trimesh offscreen
render of the occupancy grid with Q overlay and picked/gt coordinates) and VoxPoser's
``ValueMapVisualizer`` (voxposer/visualizers.py — plotly HTML affordance dumps).
Both reference paths need a display/GL or plotly; these use orthographic numpy
projections so summaries render anywhere (and plug into ImageSummary/TensorBoard).

A copy of ``voxactb_tpu.utils.visualize``, kept in the port so that it imports nothing
of the JAX package; host code, the same on every device.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _project_max(volume: np.ndarray, axis: int) -> np.ndarray:
    return volume.max(axis=axis)


def visualise_voxel(
    voxel_grid: np.ndarray,
    q_attention: Optional[np.ndarray] = None,
    highlight_coordinate: Optional[np.ndarray] = None,
    gt_coordinate: Optional[np.ndarray] = None,
) -> np.ndarray:
    """[N,N,N,C(>=10)] channels-last grid -> [N, 3N+2, 3] uint8 panel.

    Three orthographic max-projections side by side; occupancy renders the mean-RGB
    feature channels, the Q overlay tints red, the argmax pick draws green and the
    ground-truth draws blue crosshairs (matching the reference's color semantics).
    """
    occ = voxel_grid[..., -1] > 0
    rgb = np.clip((voxel_grid[..., 3:6] + 1.0) / 2.0, 0, 1)

    q = None
    if q_attention is not None:
        q = np.asarray(q_attention, np.float64)
        q = q.reshape(voxel_grid.shape[:3])
        q = (q - q.min()) / (q.max() - q.min() + 1e-9)

    n = voxel_grid.shape[0]
    panels = []
    for axis in range(3):
        img = np.zeros((n, n, 3), np.float64)
        occ_p = occ.any(axis=axis)
        for c in range(3):
            img[..., c] = np.where(occ_p, _project_max(
                rgb[..., c] * occ, axis), 0.15)
        if q is not None:
            qp = _project_max(q, axis)
            img[..., 0] = np.maximum(img[..., 0], qp)

        def mark(coord, color):
            if coord is None:
                return
            uv = [int(c) for i, c in enumerate(coord) if i != axis]
            u, v = np.clip(uv[0], 0, n - 1), np.clip(uv[1], 0, n - 1)
            img[u, :] = color
            img[:, v] = color

        mark(highlight_coordinate, (0.0, 1.0, 0.0))
        mark(gt_coordinate, (0.0, 0.3, 1.0))
        panels.append(img)

    sep = np.ones((n, 1, 3)) * 0.5
    out = np.concatenate([panels[0], sep, panels[1], sep, panels[2]], axis=1)
    return (out * 255).astype(np.uint8)


class ValueMapVisualizer:
    """Dump affordance/obstacle/cost maps + planner paths per plan call."""

    def __init__(self, save_dir: str, max_dumps: int = 50):
        self._dir = save_dir
        self._count = 0
        self._max = max_dumps
        os.makedirs(save_dir, exist_ok=True)

    def update(self, maps: Dict[str, np.ndarray],
               path: Optional[np.ndarray] = None) -> Optional[str]:
        if self._count >= self._max:
            return None
        payload = {k: np.asarray(v, np.float32) for k, v in maps.items()}
        if path is not None:
            payload["path"] = np.asarray(path, np.float32)
        # projection previews for quick inspection
        for k, v in list(payload.items()):
            if v.ndim == 3:
                payload[f"{k}_proj_z"] = v.max(axis=2)
        out = os.path.join(self._dir, f"plan_{self._count:04d}.npz")
        np.savez_compressed(out, **payload)
        self._count += 1
        return out
