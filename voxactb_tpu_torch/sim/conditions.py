"""Task success conditions.

Counterpart of RLBench's condition set (rlbench/backend/conditions.py —
``DetectedCondition`` via ProximitySensor, ``GraspedCondition``,
``ConditionSet``; used e.g. at open_jar.py:86-90).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from voxactb_tpu_torch.sim.backend import SimBackend


class Condition(abc.ABC):
    @abc.abstractmethod
    def satisfied(self, backend: SimBackend) -> bool: ...


@dataclass
class DetectedCondition(Condition):
    """Object center inside an axis-aligned sensor region."""

    object_name: str
    region_center: np.ndarray
    region_half_extent: np.ndarray
    negated: bool = False

    def satisfied(self, backend: SimBackend) -> bool:
        p = backend.get_object(self.object_name).position
        inside = bool(np.all(np.abs(p - self.region_center)
                             <= self.region_half_extent))
        return inside != self.negated


@dataclass
class GraspedCondition(Condition):
    object_name: str
    arm: str  # 'right' | 'left' | 'any'

    def satisfied(self, backend: SimBackend) -> bool:
        holder = backend.get_object(self.object_name).grasped_by
        return holder == self.arm if self.arm != "any" else holder is not None


@dataclass
class NothingGraspedCondition(Condition):
    arm: str

    def satisfied(self, backend: SimBackend) -> bool:
        return all(o.grasped_by != self.arm
                   for o in map(backend.get_object, backend.object_names()))


@dataclass
class ObjectAboveCondition(Condition):
    """e.g. lid lifted off the jar."""

    object_name: str
    min_height: float

    def satisfied(self, backend: SimBackend) -> bool:
        return backend.get_object(self.object_name).position[2] >= self.min_height


@dataclass
class ObjectDisplacedCondition(Condition):
    """Object moved from its registered start by at least ``min_distance``
    along ``axis`` (or euclidean when axis is None)."""

    object_name: str
    start_position: np.ndarray
    min_distance: float
    axis: int = -1  # -1 => euclidean

    def satisfied(self, backend: SimBackend) -> bool:
        p = backend.get_object(self.object_name).position
        if self.axis < 0:
            return float(np.linalg.norm(p - self.start_position)) >= self.min_distance
        return abs(float(p[self.axis] - self.start_position[self.axis])) \
            >= self.min_distance


class ConditionSet(Condition):
    """All conditions must hold; with ``order_matters`` each must first be
    seen satisfied in sequence (rlbench/backend/conditions.py ConditionSet:
    a latch advances only when the next condition in order fires)."""

    def __init__(self, conditions: Sequence[Condition], order_matters: bool = False):
        self._conditions = list(conditions)
        self._order_matters = order_matters
        self._latched = 0

    def satisfied(self, backend: SimBackend) -> bool:
        if not self._order_matters:
            return all(c.satisfied(backend) for c in self._conditions)
        while (self._latched < len(self._conditions)
               and self._conditions[self._latched].satisfied(backend)):
            self._latched += 1
        return self._latched == len(self._conditions)


@dataclass
class GripperNearCondition(Condition):
    """An arm's TCP within ``tol`` of a point (reach/press-style successes,
    rlbench/backend/conditions.py DetectedCondition-on-tip equivalent)."""

    arm: str
    target: np.ndarray
    tol: float = 0.05

    def satisfied(self, backend: SimBackend) -> bool:
        tcp = backend.arm(self.arm).tcp_position
        return float(np.linalg.norm(tcp - np.asarray(self.target))) <= self.tol
