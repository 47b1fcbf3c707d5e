"""K1: fused voxelize + 1x1x1 preprocess + stats + k5/s5 patchify.

Replaces ``voxactb_tpu/ops/pallas/front_fused.py::front_fused``. The kernel
(``csrc/front_fused.cu``) is memory-bound on an H100: at 100^3, B = 1 it
writes 128 MB of d0 for 9.5 GFLOP of work. Unlike the TPU kernel it keeps
every point (no per-row capacity), so ``overflow`` is always 0. Its scatter
sums with atomics in a run-dependent order: d0 may differ from the plain
version by one bf16 ulp where a mean lands on a rounding boundary.
"""

from __future__ import annotations

import ctypes

import torch

from voxactb_tpu_torch.models.blocks import conv3d_f32acc, edge_pad, to_ncdhw, to_ndhwc
from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.encoder_stats import encoder_stats_reference
from voxactb_tpu_torch.ops.voxelize import voxelize

_C = 64
_VOX_TILE = 128  # csrc/common.cuh kPreTile


def patchify_pre(d0: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """k5/s5 conv of bf16 ``d0`` with edge padding, f32, without bias: the
    back padding is never read, so this equals the JAX package's front-padded
    space-to-depth form."""
    w = wp.to(torch.bfloat16).permute(4, 3, 0, 1, 2)
    return to_ndhwc(conv3d_f32acc(edge_pad(to_ncdhw(d0), 2), w, 5))


def front_fused_reference(coords, feats, coord_bounds, w1, b1, wp, *,
                          voxel_size: int):
    """Plain version: XLA-path voxelize -> K5's plain version (bf16 1x1 conv +
    lrelu, stats) -> pre-activation patchify, with the rounding points of the
    kernel."""
    b = coords.shape[0]
    grid = voxelize(coords, feats, coord_bounds, voxel_size=voxel_size)
    d0, kp, gmax = encoder_stats_reference(grid, w1, b1)
    patch = patchify_pre(d0, wp)
    overflow = torch.zeros((b,), dtype=torch.int32, device=coords.device)
    return d0, patch, kp, gmax, overflow


def front_fused(coords, feats, coord_bounds, w1, b1, wp, *, voxel_size: int):
    """``(d0 [B,N,N,N,C] bf16, patch_pre [B,s,s,s,C] f32, kp [B,3C] f32,
    gmax [B,C] f32, overflow [B] int32)`` — the JAX signature's outputs.

    coords, feats: ``[B, P, 3]``; coord_bounds ``[B|1, 6]``; w1 ``[10, C]``;
    b1 ``[C]``; wp ``[5, 5, 5, C, C]``. CPU tensors take the plain version.
    """
    if not coords.is_cuda:
        return front_fused_reference(coords, feats, coord_bounds, w1, b1, wp,
                                     voxel_size=voxel_size)
    from voxactb_tpu_torch.ops.cuda.build import check, library, stream_ptr

    n = voxel_size
    b, p, _ = coords.shape
    c = w1.shape[-1]
    if c != _C or wp.shape != (5, 5, 5, c, c) or n % 5 != 0:
        raise ValueError(f"front_fused kernel takes C=64, k5/s5 patchify and N % 5 "
                         f"== 0; got C={c}, wp {tuple(wp.shape)}, N={n}")
    dev = coords.device
    f32 = torch.float32
    coords = coords.to(f32).contiguous()
    feats = feats.to(f32).contiguous()
    bounds = coord_bounds.to(f32).reshape(-1, 6).contiguous()
    if bounds.shape[0] not in (1, b):
        raise ValueError(f"coord_bounds must be [1|B, 6], got {tuple(coord_bounds.shape)}")
    w1_bf = w1.to(torch.bfloat16).contiguous()
    b1_f = b1.to(f32).contiguous()
    wp_bf = wp.to(torch.bfloat16).reshape(125, c, c).contiguous()
    lin = torch.linspace(-1.0, 1.0, n, dtype=f32, device=dev)

    n3 = n ** 3
    s = n // 5
    p3 = -(-n3 // _VOX_TILE)
    acc = torch.empty((b, n3, 8), dtype=f32, device=dev)
    part = torch.empty((b, p3, 5, c), dtype=f32, device=dev)
    d0 = torch.empty((b, n, n, n, c), dtype=torch.bfloat16, device=dev)
    patch = torch.empty((b, s, s, s, c), dtype=f32, device=dev)
    kp = torch.empty((b, 3 * c), dtype=f32, device=dev)
    gmax = torch.empty((b, c), dtype=f32, device=dev)

    lib = library("front_fused")
    fn = lib.voxactb_front_fused
    fn.restype = ctypes.c_int
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, ci, vp, vp, vp, vp, ci, ci, ci,
                   vp, vp, vp, vp, vp, vp, vp]
    err = fn(coords.data_ptr(), feats.data_ptr(), bounds.data_ptr(),
             int(bounds.shape[0] == b), w1_bf.data_ptr(), b1_f.data_ptr(),
             wp_bf.data_ptr(), lin.data_ptr(), b, p, n, acc.data_ptr(),
             part.data_ptr(), d0.data_ptr(), patch.data_ptr(), kp.data_ptr(),
             gmax.data_ptr(), stream_ptr(dev))
    check(lib, "front_fused", err)
    LAUNCHES["front_fused"] += 1
    overflow = torch.zeros((b,), dtype=torch.int32, device=dev)
    return d0, patch, kp, gmax, overflow
