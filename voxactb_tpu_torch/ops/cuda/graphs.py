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
- what a program derives from its owner's parameters (``weight``: a
  weight's compute-dtype copy; ``derived``: a kernel's layout of its
  weights) is kept in the owner's ``Mirror``: made in the program's first
  run, read at the same addresses by its capture and every replay, so no
  graph casts a weight. Before a copy-in, an operand whose parameters were
  written in place since it was made (a ``load_state_dict`` that keeps
  storage, an optimizer step) is made again into the same memory, and the
  next replay reads the new weights; the mirror goes with the owner's
  version. Off the graphs, ``weight`` and ``derived`` compute as they are
  called, autograd and all;
- ``ops/cuda.LAUNCHES`` keeps counting kernels launched: a capture launches
  none, and each replay adds the launches its capture recorded. A capture
  (with its eager first run) holds one process-wide lock, which each
  replay's count takes too.

Tracing (``utils/profiling``), for a table named ``name``: the counters
``<name>.graph_captures``, ``<name>.graph_replays`` and
``<name>.weight_casts`` (operands made or made again in the mirror), the span
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
from torch import nn

from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.utils.profiling import count, span

# One capture (with its eager first run) at a time, and no replay's launch
# count while one runs: a capture's launches are read off ``LAUNCHES``.
_LOCK = threading.RLock()
_ALIGN = 128  # input slots start on 512-byte boundaries, as fresh allocations do
_EAGER = threading.local()
_ACTIVE = threading.local()  # .mirror, .making: the program this thread runs through graphs


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


def weight(param: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``param.to(dtype)``, a weight in the compute dtype: inside a program
    run through graphs, the owner's mirrored copy."""
    if param.dtype == dtype:
        return param
    return derived(torch.Tensor.to, param, dtype)


def derived(make: Callable, *args):
    """``make(*args)``, a tensor or a tuple of tensors derived from weights.
    Inside a program run through graphs, where every tensor of ``args`` is
    a parameter, an operand of the mirror or a view of either, the owner's
    ``Mirror`` holds it; anywhere else it is computed here. ``make`` is a
    function of module scope: with the other arguments it keys the
    operands."""
    mirror = getattr(_ACTIVE, "mirror", None)
    if mirror is None:
        return make(*args)
    return mirror.get(make, args)


def _base(t: torch.Tensor) -> torch.Tensor:
    return t if t._base is None else t._base


class _View:
    """A view argument, taken anew from its base at each remake: one taken
    under inference_mode cannot be read once its base was written outside
    it."""

    __slots__ = ("base", "geometry")

    def __init__(self, base, geometry):
        self.base, self.geometry = base, geometry

    def __call__(self) -> torch.Tensor:
        return torch.as_strided(self.base, *self.geometry)


class _Derived:
    """One ``derived`` call's operands and what they were made from."""

    __slots__ = ("make", "args", "roots", "versions", "out", "fresh")

    def __init__(self, make, args, roots, out, fresh):
        self.make, self.args, self.roots = make, args, roots
        self.versions = [r._version for r in roots]
        self.out, self.fresh = out, fresh

    def remake(self) -> int:
        """Make the operands again into their memory if a parameter they
        derive from was written since; the number made."""
        versions = [r._version for r in self.roots]
        if versions == self.versions:
            return 0
        new = self.make(*(a() if isinstance(a, _View) else a for a in self.args))
        new = new if isinstance(new, tuple) else (new,)
        out = self.out if isinstance(self.out, tuple) else (self.out,)
        for i in self.fresh:
            out[i].copy_(new[i])
        self.versions = versions
        return len(self.fresh)


class Mirror:
    """One owner's operands derived from its parameters, for every program
    of its ``Graphs`` entries: made in a program's first, eager run, read
    by its capture (which makes none) and its replays, and made again in
    place by ``refresh`` once a parameter they derive from is written."""

    def __init__(self, name: str):
        self._count = f"{name}.weight_casts"
        self._held = {}     # key -> _Derived, in the order made
        self._roots = {}    # id of an operand's base -> the parameters it derives from
        self._params = []   # every parameter an operand derives from, once
        self._ids = set()
        self._seen = []     # their versions at the last look

    def get(self, make: Callable, args: tuple):
        key, spec, roots = [make], [], []
        for a in args:
            if not isinstance(a, torch.Tensor):
                key.append(a)
                spec.append(a)
                continue
            base = _base(a)
            from_ = [base] if isinstance(base, nn.Parameter) else self._roots.get(id(base))
            if from_ is None or base.dtype != a.dtype:
                return make(*args)  # not derived from weights alone
            geometry = (tuple(a.shape), a.stride(), a.storage_offset())
            key.append((id(base), *geometry))
            spec.append(a if a is base else _View(base, geometry))
            roots.extend(from_)
        held = self._held.get(tuple(key))
        if held is not None:
            return held.out
        out = make(*args)
        if not _ACTIVE.making:
            return out  # in a capture: the graph computes it
        flat = out if isinstance(out, tuple) else (out,)
        bases = [_base(t) for t in flat]
        known = [isinstance(b, nn.Parameter) or id(b) in self._roots for b in bases]
        if any(k and t is not b for k, t, b in zip(known, flat, bases)):
            return out  # a view of an argument: taken anew in each call
        fresh = [i for i, k in enumerate(known) if not k]
        for i in fresh:
            self._roots[id(bases[i])] = roots
        self._held[tuple(key)] = _Derived(make, spec, roots, out, fresh)
        for r in roots:
            if id(r) not in self._ids:
                self._ids.add(id(r))
                self._params.append(r)
                self._seen.append(r._version)
        if fresh:
            count(self._count, len(fresh))
        return out

    @torch.inference_mode()
    def refresh(self) -> None:
        """Make again what derives from parameters written since it was
        made, in the order made (an operand before those derived from it)."""
        seen = [p._version for p in self._params]
        if seen == self._seen:
            return
        with _LOCK:  # no first run adds to the mirror meanwhile
            made = sum(held.remake() for held in self._held.values())
            # the look's versions: a write since then is seen by the next look
            self._seen = seen
        if made:
            count(self._count, made)

    @contextlib.contextmanager
    def active(self, making: bool):
        """``derived`` reads this mirror on this thread inside the block, and
        adds what it lacks where ``making``."""
        before = getattr(_ACTIVE, "mirror", None), getattr(_ACTIVE, "making", False)
        _ACTIVE.mirror, _ACTIVE.making = self, making
        try:
            yield
        finally:
            _ACTIVE.mirror, _ACTIVE.making = before


class Graph:
    """One key's input slots and the programs captured over them, by name;
    its lock is held from a copy-in to the last program that reads it."""

    def __init__(self, name: str, device: torch.device, mirror: Mirror):
        self.lock = threading.Lock()
        self._name, self._device, self._mirror = name, device, mirror
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
                with self._mirror.active(making=True):
                    first = program(*self._inputs)
                self._done.record(stream)
                before = dict(LAUNCHES)
                graph = torch.cuda.CUDAGraph()
                try:
                    # thread_local: other threads may run, or copy to the host, meanwhile
                    with torch.cuda.graph(graph, capture_error_mode="thread_local"), \
                            self._mirror.active(making=False):
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
        self.mirrors = weakref.WeakKeyDictionary()  # owner -> Mirror, with its graphs

    def entry(self, owner, version, tag, leaves: Sequence) -> Graph:
        """The entry of ``leaves`` under ``owner`` at ``version`` with the
        caller's ``tag``, made on its first call; the owner's mirror made
        up to date with its parameters first."""
        k = key(version, tag, leaves)
        with self._lock:
            held = self.table.get(owner)
            if held is None or held[0] != version:
                held = self.table[owner] = (version, {})
                self.mirrors[owner] = Mirror(self._name)
            mirror = self.mirrors[owner]
            graph = held[1].get(k)
            if graph is None:
                graph = held[1][k] = Graph(self._name, self._device, mirror)
            mirror.refresh()
        return graph
