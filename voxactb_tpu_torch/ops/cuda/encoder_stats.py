"""K5: dense-grid encoder front — 1x1x1 preprocess conv + lrelu + stats of d0.

Replaces ``voxactb_tpu/ops/pallas/encoder_stats.py::encoder_stats``, the
front the act path takes when the fused front (K1) is not eligible and the
dense grid is built (``pallas_front=False``). d0 = lrelu(bf16(x . W1 + b1)):
the grid and W1 rounded to bf16, f32 products and sum, the bias added in f32,
the cast before the lrelu; then the soft-argmax statistics of the rounded d0
(``softargmax_stats_3d``'s arithmetic, linspace positions). The kernel
(``csrc/encoder_stats.cu`` on the voxel pass of ``csrc/voxel_pass.cuh``, which
K1 shares) is bounded by bytes on an H100: at 100^3, B = 1 it reads the grid
and writes 128 MB of d0 for 1.3 GFLOP.
"""

from __future__ import annotations

import ctypes

import torch

from voxactb_tpu_torch.models.blocks import lrelu, softargmax_stats_3d
from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.build import header_constant
from voxactb_tpu_torch.ops.cuda.graphs import derived

_C = 64
VOX_TILE = header_constant("voxel_pass.cuh", "kTile")  # voxels per tile
_VOX_CTAS_PER_SM = header_constant("voxel_pass.cuh", "kCtasPerSm")


def voxel_pass_grid(b: int, n: int, sms: int) -> int:
    """G, the voxel pass's persistent CTAs per sample (``csrc/voxel_pass.cuh``,
    K1's and K5's): all of them resident at once, ``kCtasPerSm`` per SM over
    the batch, and at most one per tile of ``VOX_TILE`` voxels. CTA g of a
    sample takes its tiles g, g + G, ..."""
    tiles = -(-n ** 3 // VOX_TILE)
    return max(1, min(tiles, _VOX_CTAS_PER_SM * sms // b))


def encoder_stats_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor):
    """Plain version. x ``[B,N,N,N,Cin]`` (any float dtype), w1 ``[Cin, C]``,
    b1 ``[C]`` -> ``(d0 [B,N,N,N,C] bf16, kp [B,3C] f32, gmax [B,C] f32)``."""
    bf16, f32 = torch.bfloat16, torch.float32
    pre = x.to(bf16).to(f32) @ w1.to(bf16).to(f32) + b1.to(f32)
    d0 = lrelu(pre.to(bf16))
    kp, gmax = softargmax_stats_3d(d0)
    return d0, kp, gmax


def stats_weights(w1: torch.Tensor, b1: torch.Tensor):
    """The 1x1 conv's weights in the voxel pass's layouts: w1 ``[10, C]``
    bf16, b1 f32."""
    return w1.to(torch.bfloat16).contiguous(), b1.to(torch.float32).contiguous()


def encoder_stats(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor):
    """Same arguments and returns as ``encoder_stats_reference``; CPU tensors
    take the plain version. The kernel takes an f32 or bf16 grid of 10
    channels and C = 64."""
    if not x.is_cuda:
        return encoder_stats_reference(x, w1, b1)
    from voxactb_tpu_torch.ops.cuda.build import check, entry, sm_count, stream_ptr

    b, n = x.shape[0], x.shape[1]
    if (x.shape[1:] != (n, n, n, 10) or w1.shape != (10, _C)
            or x.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"encoder_stats kernel takes an f32 or bf16 [B,N,N,N,10] grid "
                         f"and w1 [10, 64]; got x {tuple(x.shape)} {x.dtype}, "
                         f"w1 {tuple(w1.shape)}")
    dev = x.device
    f32 = torch.float32
    x = x.contiguous()
    w1_bf, b1_f = derived(stats_weights, w1, b1)
    lin = torch.linspace(-1.0, 1.0, n, dtype=f32, device=dev)

    g = voxel_pass_grid(b, n, sm_count(dev))
    part = torch.empty((b, g, 5, _C), dtype=f32, device=dev)
    d0 = torch.empty((b, n, n, n, _C), dtype=torch.bfloat16, device=dev)
    kp = torch.empty((b, 3 * _C), dtype=f32, device=dev)
    gmax = torch.empty((b, _C), dtype=f32, device=dev)

    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib, fn = entry("encoder_stats", "voxactb_encoder_stats",
                    [vp, ci, vp, vp, vp, ci, ci, ci, vp, vp, vp, vp, vp])
    err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), w1_bf.data_ptr(),
             b1_f.data_ptr(), lin.data_ptr(), b, n, g, part.data_ptr(), d0.data_ptr(),
             kp.data_ptr(), gmax.data_ptr(), stream_ptr(dev))
    check(lib, "encoder_stats", err)
    LAUNCHES["encoder_stats"] += 1
    return d0, kp, gmax
