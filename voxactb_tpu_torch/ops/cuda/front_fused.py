"""K1: fused voxelize + 1x1x1 preprocess + stats + k5/s5 patchify, and the
patchify alone (``front_patchify``, the dense path's).

Replaces ``voxactb_tpu/ops/pallas/front_fused.py::front_fused``. The kernel
(``csrc/front_fused.cu``: the voxel pass of ``csrc/voxel_pass.cuh``, shared
with K5, and the ``wgmma`` patchify of ``csrc/front_patchify.cuh``) is
memory-bound on an H100: at 100^3, B = 1 it writes 128 MB of d0 for 9.5
GFLOP of work. Unlike the TPU kernel it keeps every point (no per-row
capacity), so ``overflow`` is always 0. Its scatter sums with atomics in a
run-dependent order: d0 may differ from the plain version by one bf16 ulp
where a mean lands on a rounding boundary.
"""

from __future__ import annotations

import ctypes

import torch

from voxactb_tpu_torch.models.blocks import conv3d_f32acc, edge_pad, to_ncdhw, to_ndhwc
from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.build import header_constant, tma_operand
from voxactb_tpu_torch.ops.cuda.encoder_stats import (
    encoder_stats_reference, stats_weights, voxel_pass_grid)
from voxactb_tpu_torch.ops.cuda.graphs import derived
from voxactb_tpu_torch.ops.voxelize import voxelize

_C = 64
PATCH_ROWS = header_constant("front_patchify.cuh", "kRows")  # patch rows per tile
PATCH_TAPS = header_constant("front_patchify.cuh", "kTaps")
_PATCH_SLOTS = header_constant("front_patchify.cuh", "kSlots")  # partial tiles per CTA


def patchify_pre(d0: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """k5/s5 conv of ``d0`` with edge padding, f32, without bias, the weights
    in d0's dtype (bf16 on the kernel paths): the back padding is never read,
    so this equals the JAX package's front-padded space-to-depth form."""
    w = wp.to(d0.dtype).permute(4, 3, 0, 1, 2)
    return to_ndhwc(conv3d_f32acc(edge_pad(to_ncdhw(d0), 2), w, 5))


def patchify_grid(b: int, n: int, sms: int):
    """``(tiles, steps, G)`` of the patchify (``csrc/front_patchify.cuh``):
    tiles of ``PATCH_ROWS`` patch rows, ``steps = tiles x 125`` (tile, tap)
    steps numbered tile-major, and G persistent CTAs (one per SM, at most one
    per step), CTA c taking steps [steps c / G, steps (c + 1) / G)."""
    tiles = -(-b * (n // 5) ** 3 // PATCH_ROWS)
    steps = tiles * PATCH_TAPS
    return tiles, steps, min(sms, steps)


def patchify_segments(b: int, n: int, sms: int):
    """The patchify's work as ``(cta, tile, tap0, tap1, slot)`` segments, in
    CTA order: CTA ``cta`` sums taps ``tap0 .. tap1 - 1`` of ``tile``; a
    segment that holds the whole tile is stored (``slot`` None), any other is
    a partial in the CTA's ``slot`` (0: its first tile, 1: its last), and
    ``patchify_reduce`` adds a tile's partials in CTA order."""
    _, steps, g = patchify_grid(b, n, sms)
    out = []
    for c in range(g):
        w0, w1 = steps * c // g, steps * (c + 1) // g
        first = w0 // PATCH_TAPS
        w = w0
        while w < w1:
            tile = w // PATCH_TAPS
            end = min(w1, (tile + 1) * PATCH_TAPS)
            tap0, tap1 = w - tile * PATCH_TAPS, end - tile * PATCH_TAPS
            whole = tap0 == 0 and tap1 == PATCH_TAPS
            out.append((c, tile, tap0, tap1, None if whole else int(tile != first)))
            w = end
    return out


def patch_weight(wp: torch.Tensor) -> torch.Tensor:
    """The patchify's ``[5,5,5,C,C]`` kernel in its GEMM's layout: ``[taps,
    C, C]`` bf16, contiguous and aligned for TMA."""
    c = wp.shape[-1]
    return tma_operand(wp.to(torch.bfloat16).reshape(PATCH_TAPS, c, c))


def front_weights(w1: torch.Tensor, b1: torch.Tensor, wp: torch.Tensor):
    """The fused front's weights in its layouts: ``stats_weights`` and
    ``patch_weight``."""
    return stats_weights(w1, b1) + (patch_weight(wp),)


def front_patchify(d0: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """``patchify_pre(d0, wp)``: d0 ``[B,N,N,N,64]``, wp ``[5,5,5,64,64]``
    -> ``[B,N/5,N/5,N/5,64]`` f32. CPU tensors take the plain version; on
    the card the kernel takes bf16 d0 with N % 5 == 0 and raises otherwise."""
    if not d0.is_cuda:
        return patchify_pre(d0, wp)
    from voxactb_tpu_torch.ops.cuda.build import check, entry, sm_count, stream_ptr

    b, n = d0.shape[0], d0.shape[1]
    if (d0.dtype != torch.bfloat16 or d0.shape[1:] != (n, n, n, _C) or n % 5 != 0
            or tuple(wp.shape) != (5, 5, 5, _C, _C)):
        raise ValueError(f"front_patchify kernel takes bf16 d0 [B,N,N,N,64] with N % 5 "
                         f"== 0 and wp [5,5,5,64,64]; got d0 {tuple(d0.shape)} "
                         f"{d0.dtype}, wp {tuple(wp.shape)}")
    dev = d0.device
    s = n // 5
    d0 = d0.contiguous()
    wp_bf = derived(patch_weight, wp)
    _, _, g = patchify_grid(b, n, sm_count(dev))
    ppart = torch.empty((g, _PATCH_SLOTS, PATCH_ROWS, _C), dtype=torch.float32, device=dev)
    patch = torch.empty((b, s, s, s, _C), dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib, fn = entry("front_fused", "voxactb_front_patchify",
                    [vp, vp, ci, ci, ci, vp, vp, vp])
    err = fn(d0.data_ptr(), wp_bf.data_ptr(), b, n, g, ppart.data_ptr(), patch.data_ptr(),
             stream_ptr(dev))
    check(lib, "front_fused", err)
    LAUNCHES["front_patchify"] += 1
    return patch


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
    from voxactb_tpu_torch.ops.cuda.build import check, entry, sm_count, stream_ptr

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
    w1_bf, b1_f, wp_bf = derived(front_weights, w1, b1, wp)
    lin = torch.linspace(-1.0, 1.0, n, dtype=f32, device=dev)

    n3 = n ** 3
    s = n // 5
    sms = sm_count(dev)
    g = voxel_pass_grid(b, n, sms)
    _, _, gp = patchify_grid(b, n, sms)
    acc = torch.empty((b, n3, 8), dtype=f32, device=dev)
    part = torch.empty((b, g, 5, c), dtype=f32, device=dev)
    ppart = torch.empty((gp, _PATCH_SLOTS, PATCH_ROWS, c), dtype=f32, device=dev)
    d0 = torch.empty((b, n, n, n, c), dtype=torch.bfloat16, device=dev)
    patch = torch.empty((b, s, s, s, c), dtype=f32, device=dev)
    kp = torch.empty((b, 3 * c), dtype=f32, device=dev)
    gmax = torch.empty((b, c), dtype=f32, device=dev)

    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib, fn = entry("front_fused", "voxactb_front_fused",
                    [vp, vp, vp, ci, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                     vp, vp, vp, vp, vp, vp, vp, vp])
    err = fn(coords.data_ptr(), feats.data_ptr(), bounds.data_ptr(),
             int(bounds.shape[0] == b), w1_bf.data_ptr(), b1_f.data_ptr(),
             wp_bf.data_ptr(), lin.data_ptr(), b, p, n, g, gp, acc.data_ptr(),
             part.data_ptr(), ppart.data_ptr(), d0.data_ptr(), patch.data_ptr(),
             kp.data_ptr(), gmax.data_ptr(), stream_ptr(dev))
    check(lib, "front_fused", err)
    LAUNCHES["front_fused"] += 1
    LAUNCHES["front_patchify"] += 1
    overflow = torch.zeros((b,), dtype=torch.int32, device=dev)
    return d0, patch, kp, gmax, overflow
