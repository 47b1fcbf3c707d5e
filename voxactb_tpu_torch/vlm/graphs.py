"""The VLM pass's device programs replayed as CUDA graphs.

A pass of ``TorchOwlVitSamDetector`` runs three programs on the card:
OWL-ViT's class logits and boxes of the frame, SAM's image embedding of the
frame, and SAM's mask decoder with the IoU choice and the chosen mask
resized to the frame. Eager, they are some four thousand launches, which
the host pays for one by one while the device waits on it. Each is
captured here as one CUDA graph over fixed input buffers (one set per frame
size and query count, held by the detector): its first call runs it
eagerly, for the kernels' lazy set-up (builds, shared-memory opt-ins,
cuBLAS plans), then captures it; later calls replay it. The caller copies
each pass's inputs into the buffers first. A graph reads the towers'
parameter memory, so a weight load that keeps storage is read by the next
replay; a detector with new towers makes new graphs. Outputs are returned
as clones: the next replay overwrites the graph's own. Off the card the
same programs run eagerly over the same buffers; ``Program.eager`` runs one
eagerly on the card too, for tests.

``ops/cuda.LAUNCHES`` keeps counting kernels launched, as in
``agents/act_graph``: a capture launches none, and each replay adds the
launches its capture recorded. Counters ``vlm.graph_captures`` and
``vlm.graph_replays`` (``utils/profiling``).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.utils.profiling import count


class Program:
    """``fn(*inputs)`` -> a tuple of tensors, over the fixed device tensors
    ``inputs``: on a CUDA device run through a CUDA graph after its first
    call, elsewhere eagerly every call."""

    def __init__(self, fn: Callable[..., Tuple[torch.Tensor, ...]],
                 inputs: Sequence[torch.Tensor]):
        self.fn, self.inputs = fn, tuple(inputs)
        self.capture = self.inputs[0].is_cuda
        self.graph = None
        self.outputs: Tuple[torch.Tensor, ...] = ()
        self.launches = {}

    @torch.inference_mode()
    def eager(self) -> Tuple[torch.Tensor, ...]:
        """The program run eagerly over its inputs, no graph involved."""
        return tuple(t.clone() for t in self.fn(*self.inputs))

    @torch.inference_mode()
    def __call__(self) -> Tuple[torch.Tensor, ...]:
        if not self.capture:
            return self.eager()
        if self.graph is None:
            first = self.fn(*self.inputs)
            before = dict(LAUNCHES)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    self.outputs = self.fn(*self.inputs)
            finally:
                self.launches = {k: n - before[k] for k, n in LAUNCHES.items()
                                 if n != before[k]}
                for k, n in self.launches.items():  # a capture launches nothing
                    LAUNCHES[k] -= n
            self.graph = graph
            count("vlm.graph_captures")
            return tuple(t.clone() for t in first)
        self.graph.replay()
        for k, n in self.launches.items():
            LAUNCHES[k] += n
        count("vlm.graph_replays")
        return tuple(t.clone() for t in self.outputs)
