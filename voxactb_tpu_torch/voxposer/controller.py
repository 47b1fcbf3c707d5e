"""Object-centric control: heuristic pushing dynamics + random-shooting MPC.

Counterpart of VoxPoser's ``Controller`` MPC half (peract/voxposer/controllers.py:
``random_shooting_MPC`` :103 + ``PushingDynamicsModel`` from dynamics_models.py) and
the contact-motion execution at :38-67: sample candidate pushes (contact point,
direction, distance), roll them through the dynamics model, score proximity to the
target waypoint, execute the best via an approach -> push -> retreat primitive.

A copy of ``voxactb_tpu.voxposer.controller``, kept in the port so that it imports nothing
of the JAX package; host code, the same on every device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


class PushingDynamicsModel:
    """Heuristic planar pushing: the object translates by ``efficiency`` times the
    push distance along the push direction (contact assumed at the object rim)."""

    def __init__(self, efficiency: float = 0.9):
        self.efficiency = efficiency

    def predict(self, object_position: np.ndarray, contact_point: np.ndarray,
                push_dir: np.ndarray, push_dist: np.ndarray) -> np.ndarray:
        d = np.asarray(push_dir, np.float64)
        d = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9)
        moved = np.asarray(object_position) + d * (
            np.asarray(push_dist)[..., None] * self.efficiency)
        return moved


@dataclass
class MPCConfig:
    num_samples: int = 128
    horizon: int = 1
    max_push_dist: float = 0.12
    approach_dist: float = 0.08


class RandomShootingMPC:
    """Sample pushes, score final object position against the target, pick the best."""

    def __init__(self, dynamics: Optional[PushingDynamicsModel] = None,
                 cfg: Optional[MPCConfig] = None, seed: int = 0):
        self.dynamics = dynamics or PushingDynamicsModel()
        self.cfg = cfg or MPCConfig()
        self._rng = np.random.default_rng(seed)

    def plan_push(self, object_position, object_radius: float, target_position
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
        """-> (contact_point, push_dir (unit, planar), push_dist)."""
        cfg = self.cfg
        obj = np.asarray(object_position, np.float64)
        tgt = np.asarray(target_position, np.float64)

        angles = self._rng.uniform(0, 2 * np.pi, cfg.num_samples)
        dirs = np.stack([np.cos(angles), np.sin(angles),
                         np.zeros_like(angles)], -1)
        dists = self._rng.uniform(0.2, 1.0, cfg.num_samples) * cfg.max_push_dist
        contacts = obj - dirs * object_radius

        final = self.dynamics.predict(obj, contacts, dirs, dists)
        scores = np.linalg.norm(final - tgt, axis=-1)
        best = int(np.argmin(scores))
        return contacts[best], dirs[best], float(dists[best])

    def execute_push(self, env, arm: str, contact, push_dir, push_dist,
                     quat=(0.0, 1.0, 0.0, 0.0)) -> None:
        """approach -> push -> retreat primitive (controllers.py:38-67)."""
        cfg = self.cfg
        contact = np.asarray(contact, np.float64)
        push_dir = np.asarray(push_dir, np.float64)
        t_start = contact - push_dir * cfg.approach_dist
        t_push = contact + push_dir * push_dist
        t_rest = contact - push_dir * cfg.approach_dist * 0.8
        for point in (t_start, t_push, t_rest):
            action = np.concatenate(
                [point, quat, [0.0], [1.0]]).astype(np.float32)
            env.step(action, arm)
