"""Obstacle-aware TCP path planning over the kinematic backend's AABBs.

Behavioral counterpart of ``EndEffectorPoseViaPlanning2Robots``'s planned-path
execution (RLBench/rlbench/action_modes/arm_action_modes.py:388-435): the action
mode first plans a path that avoids scene geometry (RRT-Connect there), and only
if collision-aware planning fails does it fall back to planning without collision
checks (:399-418). Here the configuration space is the TCP position (the kinematic
backend has no joint-space self-collisions), obstacles are object AABBs, and the
planner is a deterministic recursive detour search: straight segment if free,
otherwise route via inflated corners of the first blocking box.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def segment_aabb_entry(p0, p1, aabb, margin: float = 0.0) -> Optional[float]:
    """Slab test: the entry parameter t in [0,1] where p0->p1 first enters the
    (inflated) box, or None when the segment misses it."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    lo = np.asarray(aabb[:3], np.float64) - margin
    hi = np.asarray(aabb[3:], np.float64) + margin
    d = p1 - p0
    tmin, tmax = 0.0, 1.0
    for ax in range(3):
        if abs(d[ax]) < 1e-12:
            if p0[ax] < lo[ax] or p0[ax] > hi[ax]:
                return None
            continue
        t1 = (lo[ax] - p0[ax]) / d[ax]
        t2 = (hi[ax] - p0[ax]) / d[ax]
        if t1 > t2:
            t1, t2 = t2, t1
        tmin = max(tmin, t1)
        tmax = min(tmax, t2)
        if tmin > tmax:
            return None
    return tmin


def segment_hits_aabb(p0, p1, aabb, margin: float = 0.0) -> bool:
    """Slab test: does the segment p0->p1 intersect the (inflated) box?"""
    return segment_aabb_entry(p0, p1, aabb, margin) is not None


def _point_in_aabb(p, aabb, margin: float) -> bool:
    return bool(np.all(p >= np.asarray(aabb[:3]) - margin)
                and np.all(p <= np.asarray(aabb[3:]) + margin))


def _first_blocker(p0, p1, obstacles, margin):
    """Nearest obstacle by ENTRY PARAMETER along the segment (not by center
    distance — a large box pierced first can have a far-away center)."""
    best, best_t = None, np.inf
    for box in obstacles:
        t = segment_aabb_entry(p0, p1, box, margin)
        if t is not None and t < best_t:
            best, best_t = box, t
    return best


def plan_path(
    start,
    goal,
    obstacles: Sequence[np.ndarray],
    margin: float = 0.02,
    clearance: float = 0.06,
    max_depth: int = 4,
) -> Optional[List[np.ndarray]]:
    """Waypoints from ``start`` to ``goal`` avoiding AABBs, or None if stuck.

    Boxes containing either endpoint are ignored — a grasp target's own box must
    be enterable, like the reference's approach to its final pose. The search
    routes via the inflated corners/faces of the first blocking box, recursing
    on BOTH sub-segments (straight lines from afar clip box corners, so a via
    point is allowed to itself need a detour).
    """
    start = np.asarray(start, np.float64)
    goal = np.asarray(goal, np.float64)
    obstacles = [np.asarray(b, np.float64) for b in obstacles
                 if not (_point_in_aabb(start, b, margin)
                         or _point_in_aabb(goal, b, margin))]

    def candidates_for(blocker):
        lo, hi = blocker[:3] - clearance, blocker[3:] + clearance
        cx, cy, cz = (lo + hi) / 2
        vias = [np.array([cx, cy, hi[2]]),         # over the top
                np.array([cx, cy, lo[2]])]         # under the bottom
        for x in (lo[0], hi[0]):                   # inflated corners, 3 levels
            for y in (lo[1], hi[1]):
                for z in (hi[2], cz, lo[2]):
                    vias.append(np.array([x, y, z]))
        for z in (hi[2], lo[2]):                   # face-edge midpoints
            vias += [np.array([lo[0], cy, z]), np.array([hi[0], cy, z]),
                     np.array([cx, lo[1], z]), np.array([cx, hi[1], z])]
        return vias

    def search(p0, p1, depth) -> Optional[List[np.ndarray]]:
        blocker = _first_blocker(p0, p1, obstacles, margin)
        if blocker is None:
            return [p1]
        if depth <= 0:
            return None
        vias = candidates_for(blocker)
        vias.sort(key=lambda v: np.linalg.norm(p0 - v) + np.linalg.norm(v - p1))
        for via in vias:
            if any(_point_in_aabb(via, b, margin) for b in obstacles):
                continue
            first = ([via] if _first_blocker(p0, via, obstacles, margin) is None
                     else search(p0, via, depth - 1))
            if first is None:
                continue
            rest = (search(via, p1, depth - 1)
                    if _first_blocker(via, p1, obstacles, margin) is not None
                    else [p1])
            if rest is not None:
                return first + rest
        return None

    return search(start, goal, max_depth)
