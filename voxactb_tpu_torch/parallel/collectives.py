"""The collectives the split train step makes, and Megatron's f and g operators.

``torch.distributed`` calls on ``torch.Tensor``s, over a process group. NCCL
takes them on the card as they are. Gloo has no CUDA form of the gathers and
reductions this module needs (and NCCL takes no two ranks on one device), so
over a gloo group a CUDA tensor is staged through pinned host memory: copied
to the host, reduced or gathered there, copied back. A reduce-scatter over
gloo (which has none) is an all-reduce of which the rank keeps its slice.
A group of one rank makes no call.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    if group_size(group) == 1:
        return t
    if _staged(t, group):
        h = _host(t.contiguous())
        dist.all_reduce(h, group=group)
        return t.copy_(h)
    dist.all_reduce(t, group=group)
    return t


def all_reduce_flat(tensors: List[torch.Tensor], group) -> None:
    """``all_reduce`` of every tensor (one dtype) as one flat buffer, in place."""
    if not tensors or group_size(group) == 1:
        return
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order."""
    n = group_size(group)
    if n == 1:
        return t
    src = _host(t.contiguous()) if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(t.device)


def reduce_scatter(t: torch.Tensor, dim: int, group, rank: int) -> torch.Tensor:
    """This rank's slice (``rank`` of the group's equal slices along ``dim``)
    of the sum of ``t`` over ``group``."""
    n = group_size(group)
    if n == 1:
        return t
    if dist.get_backend(group) == "nccl":
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n,) + src.shape[1:], dtype=t.dtype,
                          device=t.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim).contiguous()
    return all_reduce(t.clone(), group).chunk(n, dim)[rank].contiguous()


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of global rank ``src`` on every rank of ``group``, in place."""
    if group_size(group) == 1:
        return t
    if _staged(t, group):
        h = _host(t.contiguous())
        dist.broadcast(h, src, group=group)
        return t.copy_(h)
    dist.broadcast(t, src, group=group)
    return t


class _Copy(torch.autograd.Function):
    """Megatron's f: identity forward, gradient summed over the tensor-parallel
    ranks in the backward (before a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.to(torch.float32), ctx.group).to(g.dtype), None


class _Reduce(torch.autograd.Function):
    """Megatron's g: sum over the tensor-parallel ranks in the forward (after a
    row-parallel layer), identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _Copy.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _Reduce.apply(x, group)
