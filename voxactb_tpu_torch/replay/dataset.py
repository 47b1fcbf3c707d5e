"""Replay -> device feed with background prefetch and double buffering.

Counterpart of ``PyTorchReplayBuffer`` (yarr/replay_buffer/wrappers/pytorch_replay_buffer.py:59-82
— IterableDataset + DataLoader workers + pin_memory). A background thread samples
the next host batch while the device computes on the current one:

- it builds the batch in pinned (page-locked) host memory: a ``non_blocking``
  copy from pageable memory would quietly synchronize the host;
- it copies the batch to the device with ``non_blocking=True`` on a CUDA
  stream of its own and records an event after the copies;
- ``__next__`` makes the consumer's current stream wait on that event and
  calls ``record_stream`` on every tensor, so the caching allocator does not
  hand the memory to the copy stream again while the consumer still uses it.

Every batch gets fresh pinned buffers from PyTorch's caching host allocator,
which keeps a block from reuse until the copy that reads it has ended, so the
worker never overwrites a staging buffer that is still being copied.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from voxactb_tpu_torch.device import resolve_device
from voxactb_tpu_torch.utils.profiling import count, span

# batches the worker may hold ready: one being consumed, one being copied
PREFETCH_DEPTH = 2


def _host_tensor(v, pin: bool) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(v, order="C"))
    return t.pin_memory() if pin else t


class PrefetchIterator:
    """Infinite iterator of replay batches as tensors on ``device``.

    ``device`` defaults to CUDA and raises without it; ``device="cpu"`` hands
    out CPU tensors (no pinning, no streams).
    """

    def __init__(
        self,
        sample_fn: Callable[[], Dict[str, np.ndarray]],
        device=None,
    ):
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(device=self._device) if self._cuda else None
        self._sample_fn = sample_fn
        self._queue: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _transfer(self, batch):
        host = {k: _host_tensor(v, self._cuda) for k, v in batch.items()}
        if not self._cuda:
            return host, None
        with torch.cuda.stream(self._stream):
            out = {k: t.to(self._device, non_blocking=True) for k, t in host.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _worker(self):
        try:
            while not self._stop.is_set():
                # off the profiler's timeline: where a profiler records this
                # thread, its spans would name the consumer's idle gaps
                with span("vx.feed.sample", timeline=False):
                    batch = self._sample_fn()
                with span("vx.feed.stage", timeline=False):
                    item = self._transfer(batch)
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — forwarded, not swallowed
            # a silently-dead worker would hang the train loop forever on an
            # un-timed queue.get(); forward the failure to the consumer
            self._error = e
            self._stop.set()

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        """The next batch; a call that finds no batch ready counts as a stall
        (``feed.stalls``, beside ``feed.batches``)."""
        with span("vx.feed.next"):
            if self._queue.empty():
                count("feed.stalls")
            while True:
                if self._error is not None:
                    raise RuntimeError("replay prefetch worker failed") \
                        from self._error
                if self._stop.is_set():
                    raise StopIteration
                try:
                    batch, ready = self._queue.get(timeout=1.0)
                except queue.Empty:
                    continue
                if ready is not None:
                    current = torch.cuda.current_stream(self._device)
                    current.wait_event(ready)
                    for t in batch.values():
                        t.record_stream(current)
                count("feed.batches")
                return batch

    def close(self):
        self._stop.set()
        # drain so the worker can exit its put()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
