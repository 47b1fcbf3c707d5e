"""Proportional prioritized replay (sum tree) — present for parity, off by default.

Counterparts of YARR's ``PrioritizedReplayBuffer``
(yarr/replay_buffer/prioritized_replay_buffer.py:18-217) and ``sum_tree.py:1-201``.
VoxAct-B ships with ``prioritisation: False`` (conf/config.yaml:25), so this is an
opt-in sampling strategy over the same storage.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from voxactb_tpu_torch.replay.buffer import ElementSpec, UniformReplayBuffer


class SumTree:
    """Binary indexed tree of priorities with O(log n) sample/update."""

    def __init__(self, capacity: int):
        self._capacity = int(capacity)
        self._depth = int(np.ceil(np.log2(max(2, capacity))))
        self._size = 2 ** (self._depth + 1)
        self._nodes = np.zeros(self._size, np.float64)
        self._leaf0 = 2 ** self._depth
        self.max_recorded_priority = 1.0

    def total(self) -> float:
        return float(self._nodes[1])

    def set(self, index: int, value: float) -> None:
        if value < 0:
            raise ValueError("priorities must be non-negative")
        self.max_recorded_priority = max(self.max_recorded_priority, value)
        node = self._leaf0 + index
        delta = value - self._nodes[node]
        while node >= 1:
            self._nodes[node] += delta
            node //= 2

    def get(self, index: int) -> float:
        return float(self._nodes[self._leaf0 + index])

    def sample(self, rng: np.random.Generator, query: float = None) -> int:
        if self.total() <= 0:
            raise RuntimeError("cannot sample from an empty sum tree")
        q = (rng.uniform() if query is None else query) * self.total()
        node = 1
        while node < self._leaf0:
            left = 2 * node
            # strict '<' (Dopamine sum_tree semantics): q == left-subtree sum
            # must NOT descend left, or q=0.0 over a zero-priority left
            # subtree returns a zero-priority leaf (-> inf importance weights)
            if q < self._nodes[left]:
                node = left
            else:
                q -= self._nodes[left]
                node = left + 1
        return node - self._leaf0

    def stratified_sample(self, batch_size: int,
                          rng: np.random.Generator) -> np.ndarray:
        bounds = np.linspace(0.0, 1.0, batch_size + 1)
        return np.array([
            self.sample(rng, query=rng.uniform(bounds[i], bounds[i + 1]))
            for i in range(batch_size)
        ])


class PrioritizedReplayBuffer(UniformReplayBuffer):
    def __init__(self, capacity: int, signature: Sequence[ElementSpec],
                 seed: int = 0, alpha: float = 0.6):
        super().__init__(capacity, signature, seed)
        self._tree = SumTree(capacity)
        self._alpha = alpha

    def add(self, transition: Dict[str, np.ndarray],
            priority: float = None) -> int:
        with self._lock:
            return self._add_locked(transition, priority)

    def _add_locked(self, transition: Dict[str, np.ndarray],
                    priority: float = None) -> int:
        # inside the buffer lock (buffer.py's subclass contract): concurrent
        # adds from the threaded EnvRunner would otherwise race the
        # non-atomic ancestor updates in SumTree.set
        idx = super()._add_locked(transition)
        if priority is None:
            # new transitions take the CURRENT MAX leaf value so they are
            # sampled at least once; max_recorded_priority is already
            # alpha-exponentiated — raising it to alpha again systematically
            # under-prioritized fresh data for any alpha != 1
            self._tree.set(idx, self._tree.max_recorded_priority)
        else:
            self._tree.set(idx, float(priority) ** self._alpha)
        return idx

    def sample_transition_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        with self._lock:
            indices = self._tree.stratified_sample(batch_size, self._rng)
            batch = self.gather(indices)
            total = self._tree.total()
            probs = np.array([self._tree.get(i) / total for i in indices])
            batch["indices"] = indices
            batch["sampling_probabilities"] = probs.astype(np.float32)
            return batch

    def set_priority(self, indices: np.ndarray, priorities: np.ndarray) -> None:
        with self._lock:
            for i, p in zip(np.atleast_1d(indices), np.atleast_1d(priorities)):
                self._tree.set(int(i), float(p) ** self._alpha)
