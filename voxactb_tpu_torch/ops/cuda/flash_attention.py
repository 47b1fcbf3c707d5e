"""K2: inference attention softmax(q k^T + key mask) v, head dim 64.

Replaces ``voxactb_tpu/ops/pallas/flash_attention.py::flash_attention``. The
kernel (``csrc/flash_attention.cu``) is bounded by operations on an H100
(about 60 GFLOP per act at 100^3, B = 1). Numerics follow the TPU kernel:
f32 logits of bf16 operands, whole-row max and sum, P normalised before its
bf16 cast, f32 accumulation of P v, bf16 out. The kernel folds the row sum
online in its first pass over the keys, so it sums in another f32 order than
the plain version's full-row sum; a P entry on a bf16 rounding boundary can
then round the other way.
"""

from __future__ import annotations

import ctypes

import torch

from voxactb_tpu_torch.ops.cuda import LAUNCHES

_HD = 64


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Plain version: ``[BH, Tq, hd] x [BH, Tk, hd] -> [BH, Tq, hd]`` in
    ``v.dtype``; q is pre-scaled by the caller."""
    bf = torch.bfloat16
    logits = torch.matmul(q.to(bf).to(torch.float32),
                          k.to(bf).to(torch.float32).transpose(-1, -2))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(-1, keepdim=True)
    attn = (p / s).to(v.dtype)
    return torch.matmul(attn.to(torch.float32),
                        v.to(bf).to(torch.float32)).to(v.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    rows_per_block: int = 0) -> torch.Tensor:
    """``[BH, Tq, 64] x [BH, Tk, 64] -> [BH, Tq, 64]``; q must be PRE-SCALED
    by ``dim_head ** -0.5``. CPU tensors take the plain version.

    ``rows_per_block`` picks the kernel's schedule: 64 (warps share key tiles)
    or 16 (warps split the key axis); 0 takes 16 when 64-row blocks would
    number fewer than the card's SMs."""
    if not q.is_cuda:
        return flash_attention_reference(q, k, v)
    from voxactb_tpu_torch.ops.cuda.build import check, library, stream_ptr

    bh, tq, hd = q.shape
    tk = k.shape[1]
    if hd != _HD or k.shape != (bh, tk, hd) or v.shape != (bh, tk, hd):
        raise ValueError(f"flash_attention kernel takes head dim 64 and matching "
                         f"k/v; got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if v.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention kernel takes bf16 operands, got {v.dtype}")
    bf = torch.bfloat16
    q = q.to(bf).contiguous()
    k = k.to(bf).contiguous()
    v = v.contiguous()
    out = torch.empty_like(q)
    lib = library("flash_attention")
    fn = lib.voxactb_flash_attention
    fn.restype = ctypes.c_int
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, tq, tk,
             rows_per_block, stream_ptr(q.device))
    check(lib, "flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    return out
