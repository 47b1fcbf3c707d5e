"""K3: fused decoder tail — skip-concat k3 conv + lrelu, trans head(s), stats.

Replaces ``voxactb_tpu/ops/pallas/decoder_head_v2.py::decoder_head_v2`` and
the same function under the TPU's other schedules (``decoder_head.py`` v1,
``decoder_head_v2c.py``). The kernel (``csrc/decoder_head.cu``) is bounded by
operations on an H100: at 100^3, B = 1 the u conv is about 442 GFLOP. u is
rounded to bf16 before the lrelu; trans stays f32 (``acc + bt``), unlike the
XLA path, which rounds it to the compute dtype.
"""

from __future__ import annotations

import ctypes

import torch

from voxactb_tpu_torch.models.blocks import (
    conv3d_f32acc, edge_pad, lrelu, softargmax_stats_3d, to_ncdhw, to_ndhwc)
from voxactb_tpu_torch.ops.cuda import LAUNCHES

_C = 64
_VOX_PER_BLOCK = 512  # csrc/decoder_head.cu kVoxPerBlock


def decoder_head_reference(d0, u0, wf, bf, wt, bt):
    """Plain version. d0, u0 ``[B,N,N,N,C]``; wf ``[3,3,3,2C,C]``; bf ``[C]``;
    wt ``[T,3,3,3,C,1]``; bt ``[T]`` -> ``(trans [B,N,N,N,T] f32,
    kp [B,3C] f32, gmax [B,C] f32)``."""
    bf16 = torch.bfloat16
    cat = torch.cat([d0.to(bf16), u0.to(bf16)], -1)
    w = wf.to(bf16).permute(4, 3, 0, 1, 2)
    pre = conv3d_f32acc(edge_pad(to_ncdhw(cat), 1), w, 1)
    pre = pre + bf.to(torch.float32)[:, None, None, None]
    u = lrelu(to_ndhwc(pre).to(bf16))
    wtk = wt[..., 0].to(bf16).permute(0, 4, 1, 2, 3)  # [T, C, 3, 3, 3]
    trans = conv3d_f32acc(edge_pad(to_ncdhw(u), 1), wtk, 1)
    trans = to_ndhwc(trans + bt.to(torch.float32)[:, None, None, None])
    kp, gmax = softargmax_stats_3d(u)
    return trans.contiguous(), kp, gmax


def decoder_head(d0, u0, wf, bf, wt, bt):
    """Same arguments and returns as ``decoder_head_reference``; CPU tensors
    take the plain version."""
    if not d0.is_cuda:
        return decoder_head_reference(d0, u0, wf, bf, wt, bt)
    from voxactb_tpu_torch.ops.cuda.build import check, library, stream_ptr

    b, n = d0.shape[0], d0.shape[1]
    c = d0.shape[-1]
    t_heads = wt.shape[0]
    if (c != _C or u0.shape != d0.shape or wf.shape != (3, 3, 3, 2 * c, c)
            or wt.shape[1:] != (3, 3, 3, c, 1) or t_heads not in (1, 2)):
        raise ValueError(
            f"decoder_head kernel takes C=64, k3 weights and 1-2 heads; got d0 "
            f"{tuple(d0.shape)}, u0 {tuple(u0.shape)}, wf {tuple(wf.shape)}, "
            f"wt {tuple(wt.shape)}")
    dev = d0.device
    f32, bf16 = torch.float32, torch.bfloat16
    d0c = d0.to(bf16).contiguous()
    u0c = u0.to(bf16).contiguous()
    wf_bf = wf.to(bf16).reshape(27, 2 * c, c).contiguous()
    wt_bf = wt[..., 0].to(bf16).permute(1, 2, 3, 4, 0).reshape(27, c, t_heads).contiguous()
    bf_f = bf.to(f32).contiguous()
    bt_f = bt.to(f32).contiguous()
    lin = torch.linspace(-1.0, 1.0, n, dtype=f32, device=dev)

    n3 = n ** 3
    p = -(-n3 // _VOX_PER_BLOCK)
    u = torch.empty((b, n3, c), dtype=bf16, device=dev)
    part = torch.empty((b, p, 5, c), dtype=f32, device=dev)
    trans = torch.empty((b, n, n, n, t_heads), dtype=f32, device=dev)
    kp = torch.empty((b, 3 * c), dtype=f32, device=dev)
    gmax = torch.empty((b, c), dtype=f32, device=dev)

    lib = library("decoder_head")
    fn = lib.voxactb_decoder_head
    fn.restype = ctypes.c_int
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 7 + [ci] * 3 + [vp] * 6
    err = fn(d0c.data_ptr(), u0c.data_ptr(), wf_bf.data_ptr(), bf_f.data_ptr(),
             wt_bf.data_ptr(), bt_f.data_ptr(), lin.data_ptr(), b, n, t_heads,
             u.data_ptr(), part.data_ptr(), trans.data_ptr(), kp.data_ptr(),
             gmax.data_ptr(), stream_ptr(dev))
    check(lib, "decoder_head", err)
    LAUNCHES["decoder_head"] += 1
    return trans, kp, gmax
