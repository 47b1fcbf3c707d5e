"""Replay buffer backed by the native mmap shard store (C++ gather path).

Drop-in for ``UniformReplayBuffer`` when the replay must live on disk / persist across
runs — the role of YARR's disk mode (uniform_replay_buffer.py:322-386) with none of the
per-transition pickle files. Rows are the signature's elements packed back-to-back at
fixed stride; batch sampling is one multithreaded native gather into a single numpy
allocation, then one copy per element out of it.

The row layout, the store file and the sampling streams are those of the JAX
package's ``replay/native_buffer.py``: a store written by one package opens in
the other.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from typing import Dict, List, Sequence

import numpy as np

from voxactb_tpu_torch.native import load_native
from voxactb_tpu_torch.replay.buffer import ElementSpec


def _element_bytes(spec: ElementSpec) -> int:
    return int(np.dtype(spec.dtype).itemsize * int(np.prod(spec.shape or (1,))))


class NativeReplayBuffer:
    def __init__(self, capacity: int, signature: Sequence[ElementSpec],
                 path: str, seed: int = 0, gather_threads: int = 4):
        self._lib = load_native()
        self._signature = list(signature)
        self._rng = np.random.default_rng(seed)
        self._gather_threads = gather_threads
        self._lock = threading.Lock()

        self._offsets: List[int] = []
        off = 0
        for s in self._signature:
            self._offsets.append(off)
            off += _element_bytes(s)
        self._row_bytes = off

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._path = path
        if os.path.exists(path):
            self._handle = self._lib.rs_open(path.encode())
            if not self._handle:
                raise IOError(f"failed to open replay store {path}")
            if self._lib.rs_row_bytes(self._handle) != self._row_bytes:
                raise IOError(
                    f"replay store {path} row stride "
                    f"{self._lib.rs_row_bytes(self._handle)} != signature "
                    f"{self._row_bytes}")
            existing_cap = int(self._lib.rs_capacity(self._handle))
            if existing_cap != capacity:
                raise IOError(
                    f"replay store {path} has capacity {existing_cap}, "
                    f"requested {capacity}; delete the file or match the size")
        else:
            self._handle = self._lib.rs_create(
                path.encode(), capacity, self._row_bytes)
            if not self._handle:
                raise IOError(f"failed to create replay store {path}")

    # -- info ---------------------------------------------------------------------

    def _store(self):
        """The store's handle; a closed store raises here, where the C++
        functions would dereference a null handle."""
        if not self._handle:
            raise RuntimeError(f"replay store {self._path} is closed")
        return self._handle

    @property
    def size(self) -> int:
        return int(self._lib.rs_size(self._store()))

    @property
    def add_count(self) -> int:
        return int(self._lib.rs_add_count(self._store()))

    @property
    def row_bytes(self) -> int:
        return self._row_bytes

    @property
    def path(self) -> str:
        return self._path

    # -- write ---------------------------------------------------------------------

    def _pack(self, transition: Dict[str, np.ndarray]) -> np.ndarray:
        row = np.zeros(self._row_bytes, np.uint8)
        for spec, off in zip(self._signature, self._offsets):
            if spec.name not in transition:
                continue
            a = np.ascontiguousarray(
                np.asarray(transition[spec.name], spec.dtype).reshape(
                    spec.shape or (1,)))
            row[off:off + a.nbytes] = a.view(np.uint8).reshape(-1)
        return row

    def add(self, transition: Dict[str, np.ndarray]) -> int:
        row = self._pack(transition)
        with self._lock:
            return int(self._lib.rs_add(
                self._store(), row.ctypes.data_as(ctypes.c_void_p)))

    def extend(self, transitions) -> None:
        for t in transitions:
            self.add(t)

    # -- read ---------------------------------------------------------------------

    def _unpack(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        """One array per element, each a writable copy of its columns of
        ``rows``: nothing returned aliases ``rows`` (a ring slot of the
        sampler is handed back as soon as this returns), and
        ``torch.from_numpy`` takes the arrays as they are."""
        n = rows.shape[0]
        out = {}
        for spec, off in zip(self._signature, self._offsets):
            flat = np.array(rows[:, off:off + _element_bytes(spec)], order="C")
            arr = flat.view(spec.dtype).reshape((n,) + tuple(spec.shape or (1,)))
            out[spec.name] = arr.reshape(n) if spec.shape == () else arr
        return out

    def gather(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        idx = np.ascontiguousarray(indices, np.uint64)
        rows = np.empty((len(idx), self._row_bytes), np.uint8)
        self._lib.rs_gather(
            self._store(),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(idx),
            rows.ctypes.data_as(ctypes.c_void_p),
            self._gather_threads,
        )
        return self._unpack(rows)

    def sample_transition_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        if self.size == 0:
            raise RuntimeError("cannot sample from an empty replay buffer")
        return self.gather(self._rng.integers(0, self.size, batch_size))

    # -- persistence: the mmap file IS the buffer ------------------------------------

    def flush(self) -> None:
        self._lib.rs_flush(self._store())

    def close(self) -> None:
        if self._handle:
            self._lib.rs_close(self._handle)
            self._handle = None


class AsyncBatchSampler:
    """Native background batch feed — C++ producer threads gather batches into a
    ring of buffers while the train loop computes (the DataLoader(num_workers,
    pin_memory) role, pytorch_replay_buffer.py:75-82, with the gather + sampling
    entirely off the GIL).

    ``bs_stop`` frees the C++ sampler, so ``close`` must not run while a
    consumer holds a ring slot or is about to take one. ``next`` waits for the
    store to hold a batch outside the sampler (the producers wait the same
    way), then takes the slot, copies it out and hands it back under a lock
    that ``close`` takes before ``bs_stop``: a batch is on its way whenever a
    consumer holds the lock, so ``close`` waits for it and never frees the
    sampler under a consumer. A ``next`` after ``close``, or one that waits
    while ``close`` runs, raises ``RuntimeError``.

    Usage::

        sampler = AsyncBatchSampler(buf, batch_size=8)
        for _ in range(steps):
            batch = sampler.next()      # dict of numpy arrays (copied out)
        sampler.close()
    """

    def __init__(self, buffer: NativeReplayBuffer, batch_size: int,
                 ring_size: int = 4, num_threads: int = 2, seed: int = 0):
        self._buf = buffer
        self._lib = buffer._lib
        self._batch = batch_size
        self._lock = threading.Lock()
        self._handle = self._lib.bs_start(
            buffer._store(), batch_size, ring_size, num_threads, seed)
        if not self._handle:
            raise RuntimeError("failed to start native batch sampler")

    def next(self) -> Dict[str, np.ndarray]:
        # until the store holds a batch the producers publish nothing: wait
        # here, where close() can end the wait
        while self._handle and self._buf.size < self._batch:
            time.sleep(0.001)
        with self._lock:
            if not self._handle:
                raise RuntimeError("native batch sampler stopped")
            slot = int(self._lib.bs_acquire(self._handle))
            if slot < 0:
                raise RuntimeError("native batch sampler stopped")
            try:
                ptr = self._lib.bs_buffer(self._handle, slot)
                rows = np.ctypeslib.as_array(
                    ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
                    shape=(self._batch, self._buf.row_bytes))
                # _unpack copies, so the view never escapes the ring slot
                return self._buf._unpack(rows)
            finally:
                self._lib.bs_release(self._handle, slot)

    def close(self) -> None:
        with self._lock:
            handle, self._handle = self._handle, None
            if handle:
                self._lib.bs_stop(handle)
