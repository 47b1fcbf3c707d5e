"""K7: SAM attention with a decomposed relative-position bias.

Replaces ``voxactb_tpu/ops/pallas/sam_attention.py::global_rel_attention``
(``csrc/sam_attention.cu`` on ``csrc/attention_fwd.cuh``). On an H100 a
global block of ViT-H (BH 16, T 4096, head dim 80) is bounded by operations
and a windowed one (BH 400, T 196) by bytes. The kernel adds the f32 rel terms
to the f32 logits and normalises P over the whole row before its bf16 cast,
as the plain version (``ops/sam_attention.global_rel_attention_plain``) does;
its online row sum adds in another f32 order, so a P entry on a bf16 rounding
boundary can round the other way.

The kernel is built for head dims 64 (ViT-B, ViT-L) and 80 (ViT-H)
(``HEAD_DIMS``); the wrapper zero-pads q, k and v of a narrower head to the
next of them (``head_dim.padded_call``, exact; the rel terms do not depend on
the head dim) and raises above 80.
"""

from __future__ import annotations

import ctypes

import torch

from voxactb_tpu_torch.ops.cuda import LAUNCHES
from voxactb_tpu_torch.ops.cuda.head_dim import kernel_head_dim, padded_call
from voxactb_tpu_torch.ops.sam_attention import global_rel_attention_plain

HEAD_DIMS = (64, 80)  # the kernel's head dims; narrower heads are zero-padded
KEY_TILE = 128  # keys per tile of the kernel
MAX_GRID = 64
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_ARGS = [_VP] * 6 + [_CI] * 5 + [_VP]


def global_rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rel_h_term: torch.Tensor, rel_w_term: torch.Tensor, *,
                         kh: int, kw: int) -> torch.Tensor:
    """``[BH, T, hd]`` bf16 q (pre-scaled by ``hd ** -0.5`` and rounded to
    bf16), k, v and f32 ``[BH, T, kh]`` / ``[BH, T, kw]`` rel terms ->
    ``[BH, T, hd]`` bf16, over a ``kh x kw`` grid (``T = kh * kw``), hd at most
    80. CPU tensors take the plain version."""
    if not q.is_cuda:
        return global_rel_attention_plain(q, k, v, rel_h_term, rel_w_term, kh=kh, kw=kw)
    width = kernel_head_dim(q.shape[-1], HEAD_DIMS, "sam_attention")
    return padded_call(_launch, (q, k, v), width, rel_h_term, rel_w_term, kh=kh, kw=kw)


def _launch(q, k, v, rel_h_term, rel_w_term, *, kh: int, kw: int) -> torch.Tensor:
    """The kernel at a head dim of ``HEAD_DIMS``."""
    from voxactb_tpu_torch.ops.cuda.build import check, entry, stream_ptr, tma_operand

    bh, t, hd = q.shape
    if (hd not in HEAD_DIMS or t != kh * kw or not 1 <= kh <= MAX_GRID
            or not 1 <= kw <= MAX_GRID):
        raise ValueError(f"sam_attention kernel takes head dim {HEAD_DIMS} and a grid of "
                         f"at most {MAX_GRID} x {MAX_GRID} with T = kh * kw; got q "
                         f"{tuple(q.shape)}, kh {kh}, kw {kw}")
    if k.shape != q.shape or v.shape != q.shape or rel_h_term.shape != (bh, t, kh) \
            or rel_w_term.shape != (bh, t, kw):
        raise ValueError(f"sam_attention kernel: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, rel_h {tuple(rel_h_term.shape)}, rel_w "
                         f"{tuple(rel_w_term.shape)} do not match")
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise ValueError(f"sam_attention kernel takes bf16 q, k, v; got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    q, k, v = tma_operand(q), tma_operand(k), tma_operand(v)
    rel_h, rel_w = (r if r.dtype == torch.float32 and r.is_contiguous()
                    else r.to(torch.float32).contiguous() for r in (rel_h_term, rel_w_term))
    out = torch.empty_like(q)
    lib, fn = entry("sam_attention", "voxactb_sam_attention", _ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
             out.data_ptr(), bh, t, kh, kw, hd, stream_ptr(q.device))
    check(lib, "sam_attention", err)
    LAUNCHES["sam_attention"] += 1
    return out
