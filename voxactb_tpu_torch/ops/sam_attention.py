"""SAM attention with a decomposed relative-position bias, in plain PyTorch.

The XLA formulation of ``voxactb_tpu.models.sam_encoder.WindowAttention``:
the logits ``q k^T`` (f32 sums of the operands' exact products) get
``rel_h[i, j // kw]`` and then ``rel_w[i, j % kw]`` added, the f32 softmax
over the whole row is cast to ``v``'s dtype, and ``P v`` is taken in that
dtype. It is the encoder's path wherever K7 (``ops/cuda/sam_attention``) does
not engage, and K7's plain version.
"""

from __future__ import annotations

import torch


def global_rel_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               rel_h_term: torch.Tensor, rel_w_term: torch.Tensor, *,
                               kh: int, kw: int) -> torch.Tensor:
    """``[BH, T, hd]`` q (pre-scaled), k, v and the f32 ``[BH, T, kh]`` /
    ``[BH, T, kw]`` rel terms over a ``kh x kw`` token grid -> ``[BH, T, hd]``
    in ``v.dtype``."""
    bh, t, _ = q.shape
    if t != kh * kw:
        raise ValueError(f"T = {t} is not kh * kw = {kh} * {kw}")
    f32 = torch.float32
    logits = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)).reshape(bh, t, kh, kw)
    logits = (logits + rel_h_term.to(f32)[..., :, None]
              + rel_w_term.to(f32)[..., None, :]).reshape(bh, t, t)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    attn = (p / p.sum(-1, keepdim=True)).to(v.dtype)
    return torch.matmul(attn.to(f32), v.to(f32)).to(v.dtype)
