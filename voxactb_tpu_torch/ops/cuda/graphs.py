"""Device programs replayed as CUDA graphs, one per key: the act
(``agents/qfunction.make_infer_fn``) and the VLM pass
(``vlm/pipeline.TorchOwlVitSamDetector``).

Eager, each is hundreds to thousands of launches that the host pays for one
by one while the device waits on it; captured, it is one graph launch. The
hand-written kernels run inside a graph as they run outside it.

A caller keeps a ``Graphs`` table and, for each call, takes its entry: the
key is the caller's part (say the frame size) and the shapes and dtypes of
the call's inputs (``leaves``: numpy arrays, CPU tensors, CUDA tensors),
held per ``owner`` (the model, the detector) and dropped when the owner's
``version`` changes (the storage of the model's parameters, ``storage``).
Holding the entry's lock, the caller copies the leaves in and runs one or
more programs over them by name; each program takes the inputs as
positional arguments and returns a tuple (a named tuple too) of tensors.

Programs go through graphs on a CUDA device, outside an ``eager()`` block;
anywhere else a program runs eagerly on the leaves themselves, nothing is
captured and no graph counter moves. Through graphs:

- the entry's first copy-in makes its input slots, shaped as the leaves, in
  one f32 device slab. Host leaves go up through one pinned twin of their
  part of the slab in one host-to-device copy; CUDA leaves are copied on the
  device. Every program of the entry reads the same slots;
- a program's first call runs it eagerly over the slots (the kernels' lazy
  set-up: builds, shared-memory opt-ins, cuDNN and cuBLAS plans) and returns
  that result, then captures it. Later calls replay it and return clones of
  its outputs, which the next replay overwrites;
- a graph reads the parameter memory of the modules it ran, so a weight
  load that keeps storage is read by the next replay; a change of storage
  is a new version;
- ``ops/cuda.LAUNCHES`` keeps counting kernels launched: a capture launches
  none, and each replay adds the launches its capture recorded. A capture
  (with its eager first run) holds one process-wide lock, which each
  replay's count takes too.

Tracing (``utils/profiling``), for a table named ``name``: the counters
``<name>.graph_captures`` and ``<name>.graph_replays``, the span
``vx.<name>.h2d`` around a copy-in and ``vx.<name>.replay`` around a
replay. A program's own spans run only in its first call.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Callable, Sequence

import numpy as np
import torch

from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.utils.profiling import count, span

# One capture (with its eager first run) at a time, and no replay's launch
# count while one runs: a capture's launches are read off ``LAUNCHES``.
_LOCK = threading.RLock()
_ALIGN = 128  # input slots start on 512-byte boundaries, as fresh allocations do
_EAGER = threading.local()


@contextlib.contextmanager
def eager():
    """Run every program eagerly on its leaves inside the block, on this
    thread: the programs the graphs replay, on the same inputs, for
    comparison."""
    before = getattr(_EAGER, "on", False)
    _EAGER.on = True
    try:
        yield
    finally:
        _EAGER.on = before


def _replays(device: torch.device) -> bool:
    """Whether programs on ``device`` go through graphs here."""
    return device.type == "cuda" and not getattr(_EAGER, "on", False)


def _leaf(x):
    """A leaf as the slots take it: a CUDA tensor as it is, host data as a
    numpy array (a CPU tensor's over its memory)."""
    if isinstance(x, torch.Tensor):
        return x if x.is_cuda else x.detach().numpy()
    return np.asarray(x)


def _storage(module: torch.nn.Module, out: list) -> list:
    for tensors in (module._parameters, module._buffers):
        for t in tensors.values():
            if t is not None:
                out.append(t.data_ptr())
    for child in module._modules.values():
        if child is not None:
            _storage(child, out)
    return out


def storage(module: torch.nn.Module) -> tuple:
    """The storage addresses of ``module``'s parameters and buffers, its
    submodules' included (a walk of the module dicts, which
    ``named_parameters`` makes several times slower)."""
    return tuple(_storage(module, []))


def key(version, tag, leaves: Sequence) -> tuple:
    """The key of a call: the owner's ``version``, the caller's ``tag`` and
    the leaves' shapes and dtypes, a host leaf's dtype numpy's and a CUDA
    tensor's torch's."""
    return version, tag, tuple((tuple(x.shape), x.dtype) for x in map(_leaf, leaves))


def _launched(launches: dict, sign: int) -> None:
    with _LOCK:
        for k, n in launches.items():
            LAUNCHES[k] += sign * n


class Graph:
    """One key's input slots and the programs captured over them, by name;
    its lock is held from a copy-in to the last program that reads it."""

    def __init__(self, name: str, device: torch.device):
        self.lock = threading.Lock()
        self._name, self._device = name, device
        self._h2d, self._replay = f"vx.{name}.h2d", f"vx.{name}.replay"
        self._programs = {}  # name -> (graph, outputs, launches)
        self._slots = None
        self._inputs = ()

    def _make_slots(self, leaves: list) -> None:
        f32, dev = torch.float32, self._device
        host = [i for i, x in enumerate(leaves) if isinstance(x, np.ndarray)]
        ends = np.cumsum([0] + [-(-leaves[i].size // _ALIGN) * _ALIGN for i in host]).tolist()
        start = dict(zip(host, ends))
        self._slab = torch.empty(ends[-1], dtype=f32, device=dev)
        self._pinned = torch.empty(ends[-1], dtype=f32, pin_memory=True)
        self._slots = [self._slab[start[i]:start[i] + x.size].view(x.shape) if i in start
                       else torch.empty(x.shape, dtype=f32, device=dev)
                       for i, x in enumerate(leaves)]
        # numpy views: a torch copy between host tensors of this size would
        # split over the intra-op threads, which then spin on the host's cores
        staging = self._pinned.numpy()
        self._staging = {i: staging[a:a + leaves[i].size].reshape(leaves[i].shape)
                         for i, a in start.items()}
        self._staged = torch.cuda.Event()  # the last copy out of the pinned buffer
        self._done = torch.cuda.Event()    # the last program's work on the slots

    @torch.inference_mode()
    def copy_in(self, leaves: Sequence) -> None:
        """The leaves into the slots, enqueued on the current stream; off the
        graphs, they are the programs' inputs as they are."""
        if not _replays(self._device):
            self._inputs = tuple(leaves)
            return
        with span(self._h2d):
            leaves = [_leaf(x) for x in leaves]
            if self._slots is None:
                self._make_slots(leaves)
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(self._done)
            if self._staging:
                self._staged.synchronize()
                for i, view in self._staging.items():
                    np.copyto(view, leaves[i], casting="unsafe")
                self._slab.copy_(self._pinned, non_blocking=True)
                self._staged.record(stream)
            for slot, x in zip(self._slots, leaves):
                if isinstance(x, torch.Tensor):
                    slot.copy_(x)
            self._inputs = tuple(self._slots)

    @torch.inference_mode()
    def run(self, name: str, program: Callable) -> tuple:
        """``program(*inputs)``: its first call on the graphs run eagerly,
        then captured; later calls replayed, its outputs cloned."""
        if not _replays(self._device):
            return program(*self._inputs)
        stream = torch.cuda.current_stream(self._device)
        held = self._programs.get(name)
        if held is None:
            with _LOCK:
                first = program(*self._inputs)
                self._done.record(stream)
                before = dict(LAUNCHES)
                graph = torch.cuda.CUDAGraph()
                try:
                    # thread_local: other threads may run, or copy to the host, meanwhile
                    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                        outputs = program(*self._inputs)
                finally:
                    launches = {k: n - before[k] for k, n in LAUNCHES.items()
                                if n != before[k]}
                    _launched(launches, -1)  # a capture launches nothing
            self._programs[name] = graph, outputs, launches
            count(f"{self._name}.graph_captures")
            return first
        graph, outputs, launches = held
        with span(self._replay):
            graph.replay()
        out = getattr(type(outputs), "_make", tuple)(t.clone() for t in outputs)
        self._done.record(stream)
        count(f"{self._name}.graph_replays")
        _launched(launches, 1)
        return out


class Graphs:
    """The table of one kind of program's graphs (``name``: ``act``,
    ``vlm``) on ``device``, keyed as the module says."""

    def __init__(self, name: str, device):
        self._name, self._device = name, torch.device(device)
        self._lock = threading.Lock()
        # owner -> (version, {key: Graph}); an owner's graphs go with it
        self.table = weakref.WeakKeyDictionary()

    def entry(self, owner, version, tag, leaves: Sequence) -> Graph:
        """The entry of ``leaves`` under ``owner`` at ``version`` with the
        caller's ``tag``, made on its first call."""
        k = key(version, tag, leaves)
        with self._lock:
            held = self.table.get(owner)
            if held is None or held[0] != version:
                held = self.table[owner] = (version, {})
            graph = held[1].get(k)
            if graph is None:
                graph = held[1][k] = Graph(self._name, self._device)
        return graph
