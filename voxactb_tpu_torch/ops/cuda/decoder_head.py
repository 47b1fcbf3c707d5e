"""K3: fused decoder tail — skip-concat k3 conv + lrelu, trans head(s), stats.

Replaces ``voxactb_tpu/ops/pallas/decoder_head_v2.py::decoder_head_v2`` and
the same function under the TPU's other schedules (``decoder_head.py`` v1,
``decoder_head_v2c.py``). The kernel (``csrc/decoder_head.cu``) is bounded by
operations on an H100: at 100^3, B = 1 the u conv is about 442 GFLOP, which
``csrc/tail_conv.cuh`` computes brick by brick (``brick_grid``); the trans
head and the statistics then read u brick by brick too
(``csrc/decoder_tail.cuh``, ``trans_stats_grid``). u is
rounded to the compute dtype before the lrelu; trans stays f32 (``acc + bt``),
unlike the XLA path, which rounds it to the compute dtype. The compute dtype
is d0's, as in ``decoder_head_v2``: the plain version computes at f32 for f32
operands; the kernel takes bf16 only and refuses f32 operands.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from voxactb_tpu_torch.models.blocks import (
    conv3d_f32acc, edge_pad, lrelu, softargmax_stats_3d, to_ncdhw, to_ndhwc)
from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.graphs import derived

_C = 64
_BRICK = (4, 8, 8)  # csrc/tail_conv.cuh kBz, kBy, kBx: output voxels (z, y, x)


def brick_grid(b, n):
    """The u conv's launch geometry on a ``[B,N,N,N]`` grid: the
    ``(samples, z, y, x)`` counts of its output bricks, partial bricks at the
    far edges included. Brick ``i`` (numbered x fastest, then y, z, sample)
    covers voxels ``z0:z0+4, y0:y0+8, x0:x0+8`` of its sample, cut at N."""
    return (b,) + tuple(-(-n // e) for e in _BRICK)


def brick_origin(i, grid):
    """``(sample, z0, y0, x0)`` of brick ``i`` of ``brick_grid``'s ``grid``."""
    _, nbz, nby, nbx = grid
    x, i = i % nbx, i // nbx
    y, i = i % nby, i // nby
    z, b = i % nbz, i // nbz
    return b, z * _BRICK[0], y * _BRICK[1], x * _BRICK[2]


def trans_stats_grid(b, n, sms):
    """G, the trans/stats launch's CTAs per sample on a ``[B,N,N,N]`` grid and
    a card of ``sms`` SMs: two CTAs per SM over all samples, at most one per
    output brick of a sample. CTA ``g`` of sample ``s`` takes the sample's
    bricks ``g, g + G, ...`` (brick ``s * per + p`` of ``brick_grid``, ``per``
    bricks per sample) and writes partial ``[s, g]`` of the statistics."""
    per = int(np.prod(brick_grid(1, n)[1:]))
    return min(per, max(1, 2 * sms // b))


def tail_conv_reference(d0, u0, wf, bf):
    """Plain version of the tail's u conv, in d0's dtype: ``u =
    lrelu(dtype(conv3d_k3_replicate(cat[d0, u0]) + bf))`` ``[B,N,N,N,C]``."""
    dt, f32 = d0.dtype, torch.float32
    cat = torch.cat([d0, u0.to(dt)], -1)
    w = wf.to(dt).permute(4, 3, 0, 1, 2)
    pre = conv3d_f32acc(edge_pad(to_ncdhw(cat), 1), w, 1)
    pre = pre + bf.to(f32)[:, None, None, None]
    return lrelu(to_ndhwc(pre).to(dt))


def tail_from_u(u, wt, bt):
    """Plain version of the tail's trans head(s) and stats over u
    ``[B,N,N,N,C]``: ``(trans [B,N,N,N,T] f32, kp [B,3C] f32, gmax [B,C]
    f32)``."""
    f32 = torch.float32
    wtk = wt[..., 0].to(u.dtype).permute(0, 4, 1, 2, 3)  # [T, C, 3, 3, 3]
    trans = conv3d_f32acc(edge_pad(to_ncdhw(u), 1), wtk, 1)
    trans = to_ndhwc(trans + bt.to(f32)[:, None, None, None])
    kp, gmax = softargmax_stats_3d(u)
    return trans.contiguous(), kp, gmax


def decoder_head_reference(d0, u0, wf, bf, wt, bt):
    """Plain version, in d0's dtype (bf16 or f32). d0, u0 ``[B,N,N,N,C]``; wf
    ``[3,3,3,2C,C]``; bf ``[C]``; wt ``[T,3,3,3,C,1]``; bt ``[T]`` -> ``(trans
    [B,N,N,N,T] f32, kp [B,3C] f32, gmax [B,C] f32)``."""
    return tail_from_u(tail_conv_reference(d0, u0, wf, bf), wt, bt)


def check_tail_operands(name, d0, wf, wt, *activations):
    """Raise ``ValueError`` for operands a tail kernel (K3, K8) does not
    take: activations (d0 and ``activations``) other than bf16 — the kernel
    computes in bf16 and does not round f32 operands silently — C other than
    64, other than k3 weights, or other than 1-2 trans heads."""
    dtypes = sorted({str(a.dtype) for a in (d0, *activations)})
    if dtypes != ["torch.bfloat16"]:
        raise ValueError(f"the {name} kernel computes in bf16 and takes bf16 "
                         f"activations; got {', '.join(dtypes)} (the plain version "
                         f"computes at f32)")
    c = d0.shape[-1]
    if (c != _C or d0.dim() != 5 or wf.shape != (3, 3, 3, 2 * c, c)
            or wt.shape[1:] != (3, 3, 3, c, 1) or wt.shape[0] not in (1, 2)):
        raise ValueError(
            f"the {name} kernel takes C=64, k3 weights and 1-2 heads; got d0 "
            f"{tuple(d0.shape)}, wf {tuple(wf.shape)}, wt {tuple(wt.shape)}")


def head_weights(wt, bt):
    """The trans heads' weights in the kernels' layouts: wt ``[27, C, T]``
    bf16, bt f32."""
    t_heads, c = wt.shape[0], wt.shape[-2]
    return (wt[..., 0].to(torch.bfloat16).permute(1, 2, 3, 4, 0).reshape(
                27, c, t_heads).contiguous(),
            bt.to(torch.float32).contiguous())


def tail_weights(wf, bf, wt, bt):
    """The tail's weights in the kernels' layouts: wf ``[27, 2C, C]`` bf16,
    bf f32, wt ``[27, C, T]`` bf16, bt f32."""
    c = wf.shape[-1]
    return (wf.to(torch.bfloat16).reshape(27, 2 * c, c).contiguous(),
            bf.to(torch.float32).contiguous()) + head_weights(wt, bt)


def decoder_head(d0, u0, wf, bf, wt, bt):
    """Same arguments and returns as ``decoder_head_reference``; CPU tensors
    take the plain version, CUDA tensors the kernel (bf16 d0 and u0 only)."""
    if not d0.is_cuda:
        return decoder_head_reference(d0, u0, wf, bf, wt, bt)
    return launch_decoder_head(d0, u0, wf, bf, wt, bt)[:3]


def launch_decoder_head(d0, u0, wf, bf, wt, bt):
    """The kernel on CUDA tensors: ``(trans, kp, gmax, u)``, with the u grid
    ``[B,N,N,N,C]`` bf16 that its conv wrote."""
    from voxactb_tpu_torch.ops.cuda.build import check, entry, sm_count, stream_ptr, tma_operand

    check_tail_operands("decoder_head", d0, wf, wt, u0)
    if u0.shape != d0.shape:
        raise ValueError(f"decoder_head: u0 {tuple(u0.shape)} differs from d0 "
                         f"{tuple(d0.shape)}")
    b, n, c = d0.shape[0], d0.shape[1], d0.shape[-1]
    t_heads = wt.shape[0]
    dev = d0.device
    f32, bf16 = torch.float32, torch.bfloat16
    d0c, u0c = d0.contiguous(), u0.contiguous()
    wf_bf, bf_f, wt_bf, bt_f = derived(tail_weights, wf, bf, wt, bt)
    wf_bf = tma_operand(wf_bf)
    lin = torch.linspace(-1.0, 1.0, n, dtype=f32, device=dev)

    g_ctas = trans_stats_grid(b, n, sm_count(dev))
    u = torch.empty((b, n ** 3, c), dtype=bf16, device=dev)
    part, trans, kp, gmax = tail_outputs(b, n, c, t_heads, g_ctas, dev)

    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib, fn = entry("decoder_head", "voxactb_decoder_head", [vp] * 7 + [ci] * 4 + [vp] * 6)
    err = fn(d0c.data_ptr(), u0c.data_ptr(), wf_bf.data_ptr(), bf_f.data_ptr(),
             wt_bf.data_ptr(), bt_f.data_ptr(), lin.data_ptr(), b, n, t_heads, g_ctas,
             u.data_ptr(), part.data_ptr(), trans.data_ptr(), kp.data_ptr(),
             gmax.data_ptr(), stream_ptr(dev))
    check(lib, "decoder_head", err)
    LAUNCHES["decoder_head"] += 1
    LAUNCHES["decoder_tail_conv"] += 1
    LAUNCHES["decoder_tail_trans_stats"] += 1
    return trans, kp, gmax, u.reshape(b, n, n, n, c)


def tail_outputs(b, n, c, t_heads, g_ctas, dev):
    """The statistics' partials ``[B,G,5,C]`` and the tail's outputs (trans,
    kp, gmax), allocated for a launch."""
    f32 = torch.float32
    return (torch.empty((b, g_ctas, 5, c), dtype=f32, device=dev),
            torch.empty((b, n, n, n, t_heads), dtype=f32, device=dev),
            torch.empty((b, 3 * c), dtype=f32, device=dev),
            torch.empty((b, c), dtype=f32, device=dev))


def launch_tail_from_u(u, wt, bt):
    """The tail's trans/stats launch alone (with its combine) on a CUDA u
    ``[B,N,N,N,C]`` bf16: ``tail_from_u``'s function, ``(trans, kp, gmax)``."""
    from voxactb_tpu_torch.ops.cuda.build import check, entry, sm_count, stream_ptr

    b, n, c = u.shape[0], u.shape[1], u.shape[-1]
    if u.dtype != torch.bfloat16 or c != _C or u.dim() != 5 or wt.shape[1:] != (
            3, 3, 3, c, 1) or wt.shape[0] not in (1, 2):
        raise ValueError(f"tail trans/stats takes bf16 u [B,N,N,N,64] and 1-2 k3 heads; "
                         f"got u {tuple(u.shape)} {u.dtype}, wt {tuple(wt.shape)}")
    dev, t_heads = u.device, wt.shape[0]
    uc = u.contiguous()
    wt_bf, bt_f = head_weights(wt, bt)
    lin = torch.linspace(-1.0, 1.0, n, dtype=torch.float32, device=dev)
    g_ctas = trans_stats_grid(b, n, sm_count(dev))
    part, trans, kp, gmax = tail_outputs(b, n, c, t_heads, g_ctas, dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib, fn = entry("decoder_head", "voxactb_tail_trans_stats", [vp] * 4 + [ci] * 4 + [vp] * 5)
    err = fn(uc.data_ptr(), wt_bf.data_ptr(), bt_f.data_ptr(), lin.data_ptr(),
             b, n, t_heads, g_ctas, part.data_ptr(), trans.data_ptr(), kp.data_ptr(),
             gmax.data_ptr(), stream_ptr(dev))
    check(lib, "decoder_head", err)
    LAUNCHES["decoder_tail_trans_stats"] += 1
    return trans, kp, gmax
