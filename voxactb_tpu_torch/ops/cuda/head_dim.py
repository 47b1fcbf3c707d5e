"""Zero-padding of the attention head dim to the widths a kernel is built for.

The attention kernels K2, K4 and K7 are built for a few head dims (64 and 128;
64 and 80 for K7). Their wrappers take any head dim up to the largest: they
zero-pad q, k, v (and K4's dO) on the last axis to the next width the kernel
takes, launch it, and slice the head-dim outputs back. Zero columns add
nothing to ``q k^T`` and give zero columns of ``O`` (and of ``dQ``, ``dK``,
``dV``), while the row max, the log-sum-exp, the row term and the dropout
mask do not depend on the head dim, so the padding is exact, as in the TPU
kernels, which pad the head dim to a multiple of 128. q stays pre-scaled by
the true ``hd ** -0.5``, as the callers scale it.

``padded_call`` is the one helper; it runs on any device, so the tests hold it
around the plain versions on CPU tensors.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F


def kernel_head_dim(hd: int, widths: Sequence[int], name: str) -> int:
    """The smallest of ``widths`` (ascending) that holds ``hd``; raises above
    the largest, with the limit in the message."""
    for width in widths:
        if hd <= width:
            return width
    raise ValueError(f"{name} kernel takes head dims of at most {widths[-1]}, got {hd}")


def pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` zero-padded on its last axis to ``width`` columns."""
    return x if x.shape[-1] == width else F.pad(x, (0, width - x.shape[-1]))


def padded_call(fn: Callable, operands: Sequence[torch.Tensor], width: int, *rest,
                sliced: Optional[Sequence[int]] = None, **kwargs):
    """``fn(*operands zero-padded to width, *rest, **kwargs)`` with its
    head-dim outputs sliced back to the operands' head dim. The result is one
    tensor, or with ``sliced`` a tuple whose entries at those positions are
    head-dim outputs (the others, e.g. a log-sum-exp, are passed through)."""
    hd = operands[0].shape[-1]
    result = fn(*(pad_head_dim(x, width) for x in operands), *rest, **kwargs)
    if width == hd:
        return result
    if sliced is None:
        return result[..., :hd]
    return tuple(r[..., :hd] if i in sliced else r for i, r in enumerate(result))
