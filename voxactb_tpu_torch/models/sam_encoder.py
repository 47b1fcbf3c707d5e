"""SAM image encoder (ViT-det with windowed attention).

Counterpart of ``voxactb_tpu.models.sam_encoder``: a ViT with a 16x16 patch
embed, decomposed relative-position attention, window attention except at the
global blocks, and the 256-channel conv neck. ``sam_vit_h()/l()/b()`` build
the released sizes. Channels-last, parameters in f32 under the flax names,
cast to the compute ``dtype`` at use.

Attention goes through K7 (``ops/cuda/sam_attention``, the hand-written
kernel on a CUDA tensor) where the JAX package takes its Pallas kernel: at
bf16, with rel-pos, in the global blocks (``fused_global``, on by default)
and, with ``fused_windowed``, in the windowed ones. Elsewhere it is the plain
formulation (``ops/sam_attention``), which is also K7's plain version. The
rest of a block's non-GEMM work (norms, qkv split with the rel-pos terms,
bias + GELU, bias + residual) goes through four hand-written kernels
(``ops/cuda/sam_block``) for a CUDA bf16 input, and through their plain
versions, the eager formulation, otherwise.

``load_torch_sam_weights`` (a segment-anything checkpoint's
``image_encoder.*``) and ``load_hf_sam_vision_weights`` (transformers'
``vision_encoder.*``) map upstream state_dicts onto the flax tree.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from voxactb_tpu_torch.models.blocks import Conv2D, Dense, LayerNorm, rounded
from voxactb_tpu_torch.models.torch_port import make_port_helpers
from voxactb_tpu_torch.ops.cuda import sam_block
from voxactb_tpu_torch.ops.cuda.graphs import weight
from voxactb_tpu_torch.ops.cuda.sam_block import (  # noqa: F401 (the encoder's names)
    rel_pos_embed as _rel_pos_embed, window_partition, window_unpartition)
from voxactb_tpu_torch.ops.resize import resize_linear


class WindowAttention(nn.Module):
    """Multi-head attention with decomposed relative positions over a 2D token grid."""

    def __init__(self, dim: int, num_heads: int, use_rel_pos: bool = True,
                 input_size: Tuple[int, int] = (14, 14), fused_global: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.use_rel_pos = use_rel_pos
        self.fused_global = fused_global
        self.dtype = dtype
        head_dim = dim // num_heads
        self.qkv = Dense(dim, dim * 3, dtype=dtype, generator=generator)
        self.proj = Dense(dim, dim, dtype=dtype, generator=generator)
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, head_dim))

    def forward(self, rows: torch.Tensor, grid: Tuple[int, int],
                ops: sam_block.Ops) -> torch.Tensor:
        """``[B * kh * kw, C]`` rows of ``B`` token grids of ``grid`` = (kh,
        kw) -> the output projection's ``[B * kh * kw, C]`` rows before its
        bias, which ``SamBlock`` adds with the residual (``ops.bias_residual``).
        ``ops`` splits the qkv GEMM's rows into the attention's operands."""
        from voxactb_tpu_torch.ops.cuda.sam_attention import global_rel_attention
        from voxactb_tpu_torch.ops.sam_attention import global_rel_attention_plain

        kh, kw = grid
        heads, hd, dt = self.num_heads, self.dim // self.num_heads, self.dtype
        rel = (self.rel_pos_h, self.rel_pos_w) if self.use_rel_pos else (None, None)
        # q * scale rounds to the compute dtype before the logits; the rel
        # terms come from the UNSCALED q, in f32
        q, k, v, rel_h_term, rel_w_term = ops.qkv_split(
            F.linear(rows.to(dt), weight(self.qkv.weight, dt)), weight(self.qkv.bias, dt),
            heads=heads, grid=grid, scale=rounded(hd ** -0.5, dt), rel_pos=rel)
        fused = self.fused_global and self.use_rel_pos and dt == torch.bfloat16
        attention = global_rel_attention if fused else global_rel_attention_plain
        out = attention(q, k, v, rel_h_term, rel_w_term, kh=kh, kw=kw)
        b = rows.shape[0] // (kh * kw)
        out = out.reshape(b, heads, kh * kw, hd).transpose(1, 2).reshape(-1, self.dim)
        return F.linear(out, weight(self.proj.weight, dt))


class SamBlock(nn.Module):
    """Pre-norm ViT block, windowed (``window_size`` > 0) or global. Its
    non-GEMM stretches (the norms, the qkv split with the rel-pos terms,
    bias + GELU, bias + residual with the window layout) go through
    ``ops/cuda/sam_block``: the hand-written kernels for a CUDA bf16 input,
    the plain versions otherwise (``sam_block.ops_for``)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 14,
                 grid_size: Tuple[int, int] = (64, 64), mlp_ratio: float = 4.0,
                 fused_global: bool = False, fused_windowed: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.window_size = window_size  # 0: global attention
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        inp = (window_size, window_size) if window_size > 0 else grid_size
        fuse = fused_global if window_size == 0 else fused_windowed
        self.attn = WindowAttention(dim, num_heads, input_size=inp, fused_global=fuse,
                                    dtype=dtype, generator=generator)
        self.norm2 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        hidden = int(dim * mlp_ratio)
        self.mlp_fc1 = Dense(dim, hidden, dtype=dtype, generator=generator)
        self.mlp_fc2 = Dense(hidden, dim, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
        ops = sam_block.ops_for(x)
        ws, dt = self.window_size, self.dtype
        grid = (ws, ws) if ws > 0 else tuple(x.shape[1:3])
        y = ops.ln_rows(x, self.norm1.weight, self.norm1.bias, eps=self.norm1.eps, window=ws)
        x = ops.bias_residual(x, self.attn(y, grid, ops), weight(self.attn.proj.bias, dt),
                              window=ws)
        y = ops.ln_rows(x, self.norm2.weight, self.norm2.bias, eps=self.norm2.eps, window=0)
        fc1, fc2 = self.mlp_fc1, self.mlp_fc2
        y = ops.bias_gelu(F.linear(y, weight(fc1.weight, dt)), weight(fc1.bias, dt))
        return ops.bias_residual(x, F.linear(y, weight(fc2.weight, dt)), weight(fc2.bias, dt),
                                 window=0)


class SamImageEncoder(nn.Module):
    """``[B, img, img, 3]`` normalised -> ``[B, g, g, out_chans]`` f32.

    ``depth_limit`` (>= 0) runs only the first that many blocks and
    ``skip_neck`` returns the trunk's ``[B, g, g, embed_dim]`` before the neck
    (as f32): the profiler's depth-truncated encoders (``tools/profile_sam``).
    Every block's weights exist either way."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16, embed_dim: int = 1280,
                 depth: int = 32, num_heads: int = 16, window_size: int = 14,
                 global_attn_indexes: Sequence[int] = (7, 15, 23, 31), out_chans: int = 256,
                 fused_global: bool = True, fused_windowed: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, depth_limit: int = -1,
                 skip_neck: bool = False):
        super().__init__()
        self.depth = depth
        self.depth_limit = depth_limit
        self.skip_neck = skip_neck
        self.dtype = dtype
        g = img_size // patch_size
        self.patch_embed = Conv2D(3, embed_dim, patch_size, patch_size, dtype=dtype,
                                  generator=generator)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, embed_dim))
        for i in range(depth):
            self.add_module(f"block_{i}", SamBlock(
                embed_dim, num_heads,
                window_size=0 if i in global_attn_indexes else window_size,
                grid_size=(g, g), fused_global=fused_global,
                fused_windowed=fused_windowed, dtype=dtype, generator=generator))
        # neck: 1x1 conv -> LN -> 3x3 conv -> LN, to out_chans channels
        self.neck_conv1 = Conv2D(embed_dim, out_chans, 1, use_bias=False, dtype=dtype,
                                 generator=generator)
        self.neck_ln1 = LayerNorm(out_chans, eps=1e-6, dtype=dtype)
        self.neck_conv2 = Conv2D(out_chans, out_chans, 3, padding="SAME", use_bias=False,
                                 dtype=dtype, generator=generator)
        self.neck_ln2 = LayerNorm(out_chans, eps=1e-6, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x) + weight(self.pos_embed, self.dtype)
        for i in range(self.depth if self.depth_limit < 0 else self.depth_limit):
            x = getattr(self, f"block_{i}")(x)
        if self.skip_neck:
            return x.float()
        x = self.neck_ln1(self.neck_conv1(x))
        return self.neck_ln2(self.neck_conv2(x)).float()


def sam_vit_h(dtype=torch.float32, **kw) -> SamImageEncoder:
    return SamImageEncoder(embed_dim=1280, depth=32, num_heads=16,
                           global_attn_indexes=(7, 15, 23, 31), dtype=dtype, **kw)


def sam_vit_l(dtype=torch.float32, **kw) -> SamImageEncoder:
    return SamImageEncoder(embed_dim=1024, depth=24, num_heads=16,
                           global_attn_indexes=(5, 11, 17, 23), dtype=dtype, **kw)


def sam_vit_b(dtype=torch.float32, **kw) -> SamImageEncoder:
    return SamImageEncoder(embed_dim=768, depth=12, num_heads=12,
                           global_attn_indexes=(2, 5, 8, 11), dtype=dtype, **kw)


SAM_PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


def preprocess_image(rgb: np.ndarray, img_size: int = 1024, device=None) -> torch.Tensor:
    """uint8 RGB ``[H, W, 3]`` -> normalised, resized (longest side to
    ``img_size``) and zero-padded ``[1, img_size, img_size, 3]`` f32 on
    ``device``."""
    return normalize_frame(torch.as_tensor(np.asarray(rgb), dtype=torch.float32,
                                           device=device), img_size)


@functools.lru_cache(maxsize=None)
def _pixel_stats(device: torch.device):
    return (torch.as_tensor(SAM_PIXEL_MEAN, device=device),
            torch.as_tensor(SAM_PIXEL_STD, device=device))


def normalize_frame(frame: torch.Tensor, img_size: int = 1024) -> torch.Tensor:
    """``preprocess_image`` of a frame ``[H, W, 3]`` (0-255, f32) already on
    its device; after a device's first call, no copy from the host."""
    h, w = frame.shape[:2]
    scale = img_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    mean, std = _pixel_stats(frame.device)
    x = (resize_linear(frame, (nh, nw, 3)) - mean) / std
    out = x.new_zeros(img_size, img_size, 3)
    out[:nh, :nw] = x
    return out[None]


def load_hf_sam_vision_weights(state_dict) -> dict:
    """Map a transformers ``SamModel`` / ``SamVisionModel`` vision-encoder
    state_dict (``vision_encoder.*`` keys, modeling_sam.py naming) onto
    ``SamImageEncoder``. Same math as the facebook layout importer below —
    only the key names differ (``patch_embed.projection`` vs ``patch_embed.proj``,
    ``layers.N.layer_norm1`` vs ``blocks.N.norm1``, ``neck.layer_norm1`` vs
    ``neck.1`` ...)."""

    a = make_port_helpers(state_dict)[0]

    p = "vision_encoder."
    params = {
        "patch_embed": {
            "kernel": a(p + "patch_embed.projection.weight").transpose(2, 3, 1, 0),
            "bias": a(p + "patch_embed.projection.bias"),
        },
        "pos_embed": a(p + "pos_embed"),
        "neck_conv1": {"kernel": a(p + "neck.conv1.weight").transpose(2, 3, 1, 0)},
        "neck_ln1": {"scale": a(p + "neck.layer_norm1.weight"),
                     "bias": a(p + "neck.layer_norm1.bias")},
        "neck_conv2": {"kernel": a(p + "neck.conv2.weight").transpose(2, 3, 1, 0)},
        "neck_ln2": {"scale": a(p + "neck.layer_norm2.weight"),
                     "bias": a(p + "neck.layer_norm2.bias")},
    }
    depth = max(int(k.split(".")[2]) for k in state_dict
                if k.startswith(p + "layers.")) + 1
    for i in range(depth):
        b = f"{p}layers.{i}."
        params[f"block_{i}"] = {
            "norm1": {"scale": a(b + "layer_norm1.weight"),
                      "bias": a(b + "layer_norm1.bias")},
            "norm2": {"scale": a(b + "layer_norm2.weight"),
                      "bias": a(b + "layer_norm2.bias")},
            "attn": {
                "qkv": {"kernel": a(b + "attn.qkv.weight").T,
                        "bias": a(b + "attn.qkv.bias")},
                "proj": {"kernel": a(b + "attn.proj.weight").T,
                         "bias": a(b + "attn.proj.bias")},
                "rel_pos_h": a(b + "attn.rel_pos_h"),
                "rel_pos_w": a(b + "attn.rel_pos_w"),
            },
            "mlp_fc1": {"kernel": a(b + "mlp.lin1.weight").T,
                        "bias": a(b + "mlp.lin1.bias")},
            "mlp_fc2": {"kernel": a(b + "mlp.lin2.weight").T,
                        "bias": a(b + "mlp.lin2.bias")},
        }
    return {"params": params}


def load_torch_sam_weights(state_dict) -> dict:
    """Map a segment-anything ``image_encoder.*`` state_dict onto SamImageEncoder."""

    a = make_port_helpers(state_dict)[0]

    p = "image_encoder."
    params = {
        "patch_embed": {
            # torch conv [out,in,kh,kw] -> flax [kh,kw,in,out]
            "kernel": a(p + "patch_embed.proj.weight").transpose(2, 3, 1, 0),
            "bias": a(p + "patch_embed.proj.bias"),
        },
        "pos_embed": a(p + "pos_embed"),
        "neck_conv1": {"kernel": a(p + "neck.0.weight").transpose(2, 3, 1, 0)},
        "neck_ln1": {"scale": a(p + "neck.1.weight"), "bias": a(p + "neck.1.bias")},
        "neck_conv2": {"kernel": a(p + "neck.2.weight").transpose(2, 3, 1, 0)},
        "neck_ln2": {"scale": a(p + "neck.3.weight"), "bias": a(p + "neck.3.bias")},
    }
    depth = max(int(k.split(".")[2]) for k in state_dict
                if k.startswith(p + "blocks.")) + 1
    for i in range(depth):
        b = f"{p}blocks.{i}."
        params[f"block_{i}"] = {
            "norm1": {"scale": a(b + "norm1.weight"), "bias": a(b + "norm1.bias")},
            "norm2": {"scale": a(b + "norm2.weight"), "bias": a(b + "norm2.bias")},
            "attn": {
                "qkv": {"kernel": a(b + "attn.qkv.weight").T,
                        "bias": a(b + "attn.qkv.bias")},
                "proj": {"kernel": a(b + "attn.proj.weight").T,
                         "bias": a(b + "attn.proj.bias")},
                "rel_pos_h": a(b + "attn.rel_pos_h"),
                "rel_pos_w": a(b + "attn.rel_pos_w"),
            },
            "mlp_fc1": {"kernel": a(b + "mlp.lin1.weight").T,
                        "bias": a(b + "mlp.lin1.bias")},
            "mlp_fc2": {"kernel": a(b + "mlp.lin2.weight").T,
                        "bias": a(b + "mlp.lin2.bias")},
        }
    return {"params": params}
