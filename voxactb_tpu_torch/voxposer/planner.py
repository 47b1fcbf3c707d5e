"""Greedy voxel path planner over affordance/avoidance cost maps.

Counterpart of ``PathPlanner.optimize`` (peract/voxposer/planners.py:19-174):
cost = EDT-smoothed target map + Gaussian-blurred obstacle map; greedy steepest
descent over a local neighborhood with a revisit penalty; postprocess = Savitzky-Golay
smoothing, high-curvature cutoff, waypoint spacing, snap-final-to-target.

A copy of ``voxactb_tpu.voxposer.planner``, kept in the port so that it imports nothing
of the JAX package; host code, the same on every device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
from scipy.ndimage import distance_transform_edt, gaussian_filter
from scipy.signal import savgol_filter

from voxactb_tpu_torch.voxposer.value_maps import normalize_map


@dataclass
class PlannerConfig:
    """voxposer/configs/rlbench_config.yaml planner group defaults."""

    max_steps: int = 300
    stop_threshold: float = 0.001  # rlbench_config.yaml:4
    target_map_weight: float = 1.0
    obstacle_map_weight: float = 1.0
    obstacle_map_gaussian_sigma: float = 5.0
    savgol_window_size: int = 20
    savgol_polyorder: int = 2
    max_curvature: float = 3.0
    target_spacing: float = 10.0
    pushing_skip_per_k: int = 2


def calc_curvature(path: np.ndarray) -> np.ndarray:
    """Discrete curvature |p' x p''| / |p'|^3 per interior point."""
    if len(path) < 3:
        return np.zeros(len(path))
    d1 = np.gradient(path, axis=0)
    d2 = np.gradient(d1, axis=0)
    cross = np.cross(d1, d2)
    num = np.linalg.norm(cross, axis=-1)
    den = np.linalg.norm(d1, axis=-1) ** 3 + 1e-12
    return num / den


class GreedyPathPlanner:
    def __init__(self, config: Optional[PlannerConfig] = None, map_size: int = 100):
        self.config = config or PlannerConfig()
        self.map_size = map_size

    # -- neighborhood (planners.py:104-122) -----------------------------------------

    def _nearby(self, pos: np.ndarray, object_centric: bool) -> np.ndarray:
        # reference formula assumes map_size=100 (planners.py:106); clamp for small maps
        half = max(1, int(2 * self.map_size / 100))
        offs = np.arange(-half, half + 1)
        axes = (offs, offs, np.array([0])) if object_centric else (offs,) * 3
        grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
        grid = grid[np.any(grid != 0, axis=1)]
        cand = np.clip(np.round(pos).astype(int) + grid, 0, self.map_size - 1)
        return np.unique(cand, axis=0)

    # -- main loop (planners.py:19-87) ------------------------------------------------

    def optimize(self, start_pos: np.ndarray, target_map: np.ndarray,
                 obstacle_map: np.ndarray, object_centric: bool = False
                 ) -> Tuple[np.ndarray, dict]:
        cfg = self.config
        raw_target = target_map
        target = normalize_map(distance_transform_edt(1 - target_map))
        obstacle = normalize_map(
            gaussian_filter(obstacle_map.astype(np.float64),
                            sigma=cfg.obstacle_map_gaussian_sigma))
        costmap = normalize_map(
            target * cfg.target_map_weight + obstacle * cfg.obstacle_map_weight)
        work = costmap.copy()

        pos = np.asarray(start_pos, np.float64)
        path = [pos]
        for _ in range(cfg.max_steps):
            nearby = self._nearby(pos, object_centric)
            scores = work[nearby[:, 0], nearby[:, 1], nearby[:, 2]]
            nxt = nearby[np.argmin(scores)].astype(np.float64)
            cur = np.round(pos).clip(0, self.map_size - 1).astype(int)
            work[cur[0], cur[1], cur[2]] += 1.0  # revisit penalty
            path.append(nxt)
            pos = nxt
            if self._should_stop(pos, work, object_centric):
                break

        raw_path = np.asarray(path)
        processed = self._postprocess(raw_path, raw_target, object_centric)
        info = {
            "costmap": costmap,
            "planner_raw_path": raw_path,
            "planner_postprocessed_path": processed,
        }
        return processed, info

    def _should_stop(self, pos, costmap, object_centric) -> bool:
        """Stop when NO neighbor costs less than current + stop_threshold —
        i.e. the walk sits at a strict local minimum by margin theta
        (planners.py:90-102 no_nearby_equal_criteria, threshold sign included;
        on an EDT costmap the per-voxel deltas near the target exceed 0.001,
        so this terminates at the minimum rather than wandering)."""
        cur = np.round(pos).clip(0, self.map_size - 1).astype(int)
        current_cost = costmap[cur[0], cur[1], cur[2]]
        nearby = self._nearby(pos, object_centric=False)
        better = costmap[nearby[:, 0], nearby[:, 1], nearby[:, 2]] < (
            current_cost + self.config.stop_threshold)
        return not np.any(better)

    # -- postprocess (planners.py:123-174) ---------------------------------------------

    def _postprocess(self, path: np.ndarray, raw_target_map: np.ndarray,
                     object_centric: bool) -> np.ndarray:
        cfg = self.config
        win = min(len(path), cfg.savgol_window_size)
        if win % 2 == 0:
            win += 1
        poly = min(cfg.savgol_polyorder, win - 1)
        if win > poly and len(path) >= win:
            try:
                path = savgol_filter(path, win, poly, axis=0)
            except ValueError:
                pass

        curvature = calc_curvature(path)
        if len(curvature) > 5:
            high = np.where(curvature[5:] > cfg.max_curvature)[0]
            if len(high) > 0:
                path = path[: int(0.9 * (high[0] + 5))]

        trimmed = path[1:-1]
        if len(trimmed) > 1:
            target_spacing = int(cfg.target_spacing * self.map_size / 100)
            seg = np.linalg.norm(trimmed[1:] - trimmed[:-1], axis=1)
            if seg.sum() > target_spacing:
                skip = int(np.round(target_spacing / max(seg.mean(), 1e-9)))
                if skip > 1:
                    trimmed = trimmed[::skip]
        path = np.concatenate([path[:1], trimmed, path[-1:]])

        last = np.round(path[-1]).clip(0, self.map_size - 1).astype(int)
        if raw_target_map[last[0], last[1], last[2]] == 0:
            targets = np.argwhere(raw_target_map == 1)
            if len(targets):
                closest = targets[
                    np.argmin(np.linalg.norm(targets - last, axis=1))].astype(
                    np.float64)
                if object_centric:
                    closest[2] = last[2]
                path = np.append(path, [closest], axis=0)

        if object_centric:
            k = cfg.pushing_skip_per_k
            path = np.concatenate([path[k:-1:k], path[-1:]])
        return path.clip(0, self.map_size - 1)
