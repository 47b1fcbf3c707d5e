"""Voxel value maps: the spatial language the LMP-generated code speaks.

Counterpart of the map factories and voxel helpers in
peract/voxposer/interfaces.py:243-314 (``cm2index``, ``set_voxel_by_radius``,
``get_empty_affordance_map`` et al.). Maps are plain numpy volumes at planner
resolution; world<->voxel conversion is metric over the workspace bounds.

A copy of ``voxactb_tpu.voxposer.value_maps``, kept in the port so that it imports nothing
of the JAX package; host code, the same on every device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class VoxelMapSpec:
    """Workspace bounds + map resolution."""

    bounds: np.ndarray  # [6] x0 y0 z0 x1 y1 z1
    map_size: int = 100

    def __post_init__(self):
        self.bounds = np.asarray(self.bounds, np.float32)

    @property
    def mins(self):
        return self.bounds[:3]

    @property
    def maxs(self):
        return self.bounds[3:]

    @property
    def resolution(self) -> np.ndarray:
        return (self.maxs - self.mins) / self.map_size

    # -- conversions (interfaces.py:243-268) --------------------------------------

    def world_to_voxel(self, point) -> np.ndarray:
        idx = (np.asarray(point) - self.mins) / (self.resolution + 1e-12)
        return np.clip(np.floor(idx), 0, self.map_size - 1).astype(np.int32)

    def voxel_to_world(self, idx) -> np.ndarray:
        return self.mins + (np.asarray(idx, np.float32) + 0.5) * self.resolution

    def cm2index(self, cm: float, direction=None):
        """Centimeters -> voxel count (optionally along a direction vector)."""
        cells = cm / 100.0 / self.resolution
        if direction is None:
            return int(np.round(cells.mean()))
        d = np.asarray(direction, np.float32)
        d = d / (np.linalg.norm(d) + 1e-12)
        return int(np.round(np.abs(cells * d).sum()))

    # -- map factories (interfaces.py:302-314) --------------------------------------

    def empty_map(self, fill: float = 0.0) -> np.ndarray:
        return np.full((self.map_size,) * 3, fill, np.float32)

    def affordance_map(self) -> np.ndarray:
        return self.empty_map(0.0)  # 1 marks "go here"

    def avoidance_map(self) -> np.ndarray:
        return self.empty_map(0.0)  # 1 marks "stay away"

    def rotation_map(self) -> np.ndarray:
        """[S,S,S,4] per-voxel target quaternion (identity default)."""
        m = np.zeros((self.map_size,) * 3 + (4,), np.float32)
        m[..., 3] = 1.0
        return m

    def velocity_map(self) -> np.ndarray:
        return self.empty_map(1.0)

    def gripper_map(self) -> np.ndarray:
        return self.empty_map(1.0)  # 1 = open


def set_voxel_by_radius(voxel_map: np.ndarray, center_idx, radius_cm: float,
                        spec: VoxelMapSpec, value: float = 1.0) -> np.ndarray:
    """Set all voxels within a metric radius of a center (interfaces.py:285-301)."""
    r_cells = max(0, spec.cm2index(radius_cm))
    c = np.asarray(center_idx, np.int64)
    s = voxel_map.shape[0]
    lo = np.clip(c - r_cells, 0, s - 1)
    hi = np.clip(c + r_cells + 1, 0, s)
    xs, ys, zs = np.meshgrid(*[np.arange(lo[i], hi[i]) for i in range(3)],
                             indexing="ij")
    d2 = (xs - c[0]) ** 2 + (ys - c[1]) ** 2 + (zs - c[2]) ** 2
    inside = d2 <= r_cells ** 2
    sub = voxel_map[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
    sub[inside] = value  # works for both scalar [S,S,S] and vector [S,S,S,K] maps
    return voxel_map


def normalize_map(m: np.ndarray) -> np.ndarray:
    """Min-max normalize to [0, 1] (voxposer/utils.py normalize_map)."""
    lo, hi = m.min(), m.max()
    return (m - lo) / (hi - lo + 1e-12)
