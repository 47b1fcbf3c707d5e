"""Replay buffers: contiguous structure-of-arrays storage with task-uniform sampling.

Counterpart of YARR's ``UniformReplayBuffer`` (yarr/replay_buffer/uniform_replay_buffer.py:73,
Dopamine-style ring buffer; disk mode pickles ONE FILE PER TRANSITION :322-386) and
``TaskUniformReplayBuffer`` (task_uniform_replay_buffer.py:20 — per-task index lists,
uniform-over-tasks then uniform-within-task sampling :30-100). The signature builder
mirrors ``create_replay`` (peract/agents/peract_bc/launch_utils.py:37-166).

Redesign rationale (a host store feeding one device program, not a DataLoader):
- storage is preallocated contiguous numpy per element -> sampling a batch is pure
  fancy-indexing, no unpickling, no per-transition files;
- persistence is one ``.npz`` per buffer (mmap-able), not N pickles — the reference
  documents corrupted-pickle failures as delete-and-restart (README "Unpickling Error");
- images are stored uint8 and normalized on device inside the train step.

This buffer stores exactly one timestep per transition (PerAct uses timesteps=1;
the stacked-frame machinery in YARR is dead weight for BC).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class ElementSpec:
    name: str
    shape: Tuple[int, ...]
    dtype: np.dtype


def bc_replay_signature(
    cameras: Sequence[str],
    image_size: Tuple[int, int] = (128, 128),
    low_dim_size: int = 4,
    voxel_layers: int = 1,
    crop_target_obj_voxel: bool = False,
    arm_pred_loss: bool = False,
    two_arm: bool = False,
    lang_emb_dim: int = 1024,
    lang_tokens: int = 77,
    lang_token_dim: int = 512,
) -> List[ElementSpec]:
    """The BC replay element set (launch_utils.py:37-166)."""
    h, w = image_size
    specs = [
        ElementSpec("low_dim_state", (low_dim_size,), np.float32),
        ElementSpec("trans_action_indicies", (voxel_layers * 3,), np.int32),
        ElementSpec("rot_grip_action_indicies", (4,), np.int32),
        ElementSpec("ignore_collisions", (1,), np.int32),
        ElementSpec("gripper_pose", (7,), np.float32),
        ElementSpec("lang_goal_emb", (lang_emb_dim,), np.float32),
        ElementSpec("lang_token_embs", (lang_tokens, lang_token_dim), np.float32),
        ElementSpec("task_id", (), np.int32),
        ElementSpec("demo", (), np.bool_),
        ElementSpec("timeout", (), np.bool_),
        ElementSpec("terminal", (), np.bool_),
        ElementSpec("reward", (), np.float32),
    ]
    for cam in cameras:
        specs += [
            ElementSpec(f"{cam}_rgb", (h, w, 3), np.uint8),
            ElementSpec(f"{cam}_point_cloud", (h, w, 3), np.float32),
            ElementSpec(f"{cam}_camera_extrinsics", (4, 4), np.float32),
            ElementSpec(f"{cam}_camera_intrinsics", (3, 3), np.float32),
        ]
    if crop_target_obj_voxel:
        specs.append(ElementSpec("target_object_scene_bounds", (6,), np.float32))
    if arm_pred_loss:
        specs.append(ElementSpec("label", (1,), np.int32))
    if two_arm:
        specs += [
            ElementSpec("trans_action_indicies_left", (voxel_layers * 3,), np.int32),
            ElementSpec("rot_grip_action_indicies_left", (4,), np.int32),
            ElementSpec("gripper_pose_left", (7,), np.float32),
        ]
    return specs


class UniformReplayBuffer:
    """Thread-safe contiguous ring buffer with uniform sampling."""

    def __init__(self, capacity: int, signature: Sequence[ElementSpec],
                 seed: int = 0):
        self._capacity = int(capacity)
        self._signature = {s.name: s for s in signature}
        self._store: Dict[str, np.ndarray] = {
            s.name: np.zeros((self._capacity,) + tuple(s.shape), s.dtype)
            for s in signature
        }
        self._cursor = 0
        self._add_count = 0
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(seed)

    # -- writing -------------------------------------------------------------------

    def add(self, transition: Dict[str, np.ndarray]) -> int:
        """Insert one transition; unknown keys are ignored, missing keys zero-fill."""
        with self._lock:
            return self._add_locked(transition)

    def _add_locked(self, transition: Dict[str, np.ndarray]) -> int:
        """Insertion body; subclasses extend this INSIDE the lock so their
        bookkeeping stays in cursor order under concurrent adds."""
        idx = self._cursor
        for name, arr in self._store.items():
            if name in transition:
                arr[idx] = np.asarray(transition[name], arr.dtype).reshape(
                    arr.shape[1:]
                )
            else:
                arr[idx] = 0
        self._cursor = (self._cursor + 1) % self._capacity
        self._add_count += 1
        return idx

    def extend(self, transitions: Sequence[Dict[str, np.ndarray]]) -> None:
        for t in transitions:
            self.add(t)

    # -- reading -------------------------------------------------------------------

    @property
    def size(self) -> int:
        return min(self._add_count, self._capacity)

    @property
    def add_count(self) -> int:
        return self._add_count

    def sample_indices(self, batch_size: int) -> np.ndarray:
        if self.size == 0:
            raise RuntimeError("cannot sample from an empty replay buffer")
        return self._rng.integers(0, self.size, size=batch_size)

    def gather(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        return {name: arr[indices] for name, arr in self._store.items()}

    def sample_transition_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        with self._lock:
            return self.gather(self.sample_indices(batch_size))

    # -- persistence (single npz vs the reference's file-per-transition) -------------

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with self._lock:
            np.savez(
                path,
                __cursor=self._cursor,
                __add_count=self._add_count,
                **{k: v[: self.size] for k, v in self._store.items()},
            )

    def load(self, path: str) -> None:
        # np.savez appends '.npz' when missing; accept the same bare path here
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        data = np.load(path, allow_pickle=False)
        with self._lock:
            n = int(data["__add_count"])
            size = min(n, self._capacity)
            for name, arr in self._store.items():
                if name in data:
                    arr[:size] = data[name][:size]
            self._cursor = int(data["__cursor"]) % self._capacity
            self._add_count = n


class TaskUniformReplayBuffer(UniformReplayBuffer):
    """Uniform over tasks, then uniform within task — the buffer VoxAct-B trains from
    (task_uniform_replay_buffer.py:20-100, selected at run_seed_fn.py:108-118)."""

    def __init__(self, capacity: int, signature: Sequence[ElementSpec],
                 seed: int = 0):
        super().__init__(capacity, signature, seed)
        self._task_indices: Dict[int, List[int]] = {}

    def _add_locked(self, transition: Dict[str, np.ndarray]) -> int:
        # single-lock with the store write: two-phase locking let concurrent
        # fill workers append task indices out of cursor order, so the
        # head-of-list eviction below missed stale entries after wraparound
        idx = super()._add_locked(transition)
        task = int(transition.get("task_id", 0))
        # ring overwrite: the slot being reused is the OLDEST live entry, so
        # it sits at the head of whichever task list holds it
        if self._add_count > self._capacity:
            for lst in self._task_indices.values():
                if lst and lst[0] == idx:
                    lst.pop(0)
                    break
        self._task_indices.setdefault(task, []).append(idx)
        return idx

    def load(self, path: str) -> None:
        super().load(path)
        with self._lock:
            # rebuild per-task index lists in INSERTION order (cursor-first
            # when wrapped) so head-of-list eviction stays correct
            self._task_indices = {}
            size = self.size
            if size == 0:
                return
            if self._add_count > self._capacity:
                order = list(range(self._cursor, size)) + \
                    list(range(self._cursor))
            else:
                order = list(range(size))
            tids = self._store["task_id"]
            for i in order:
                self._task_indices.setdefault(int(tids[i]), []).append(i)

    def sample_transition_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        with self._lock:
            tasks = list(self._task_indices)
            if not tasks:
                raise RuntimeError("cannot sample from an empty replay buffer")
            chosen_tasks = self._rng.choice(len(tasks), size=batch_size)
            indices = np.array(
                [
                    self._task_indices[tasks[t]][
                        self._rng.integers(len(self._task_indices[tasks[t]]))
                    ]
                    for t in chosen_tasks
                ]
            )
            return self.gather(indices)
