"""Baseline policy networks: CNN-BC-lang, ViT-BC-lang, and the C2FARM LingUNet Q-net.

Counterpart of ``voxactb_tpu.models.baselines`` (the reference's baseline zoo:
``BCLangAgent``'s CNN+lang+proprio regressor over CNNLangAndFcsNet, the ViT
variant over ViTLangAndFcsNet, and C2FARM's language-conditioned 3D U-Net
Q-attention). Channels-last at every boundary, as in the JAX package; the
submodules carry flax's names (the ViT's unnamed ``LayerNorm_k`` / ``Dense_k``
included), so ``weights.baseline_from_flax`` fills them by name.

These networks compute no function that a TPU kernel of the JAX package
computes: they are convolutions, dense layers, LayerNorm and attention written
out with ``einsum``, in plain PyTorch on every device.

Where flax and PyTorch differ:

- flax ``nn.Conv`` defaults to ``"SAME"`` padding, which for a stride-2 conv
  is asymmetric: on an even input a 3x3/s2 conv pads 0 before and 1 after
  (``flax_same_pads``). PyTorch's ``padding=1`` pads both sides and shifts
  every output, so the CNN pads explicitly and convolves VALID.
- ``jax.nn.gelu`` is the tanh form (``blocks.gelu_tanh``).
- flax ``MultiHeadDotProductAttention`` keeps its projections as
  ``DenseGeneral`` kernels ``[dim, heads, head_dim]`` (output ``[heads,
  head_dim, dim]``), with biases, and scales the query by ``head_dim ** -0.5``.
- ``jax.image.resize(..., "nearest")`` at x2 repeats every voxel.

A reference fact, kept: ``LingUNetQNet``'s skip concat needs every grid side to
be a multiple of ``2 ** levels``. At 50^3 and 2 levels, 25 pools to 12, which
grows back to 24, and the concat with the 25^3 skip fails, in both packages.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from voxactb_tpu_torch.models.blocks import (
    Conv2D, Conv3D, Dense, DenseBlock, LayerNorm, act_fn, gelu_tanh, lecun_normal_,
    to_ncdhw, to_ndhwc)


def flax_same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's (lax's) ``"SAME"`` padding of one spatial axis: the output has
    ``ceil(size / stride)`` positions, the total pad splits with the smaller
    half before."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same_nhwc(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Zero-pad ``[B, H, W, C]`` as flax's ``"SAME"`` conv does."""
    top, bottom = flax_same_pads(x.shape[1], kernel, stride)
    left, right = flax_same_pads(x.shape[2], kernel, stride)
    return F.pad(x, (0, 0, left, right, top, bottom))


def _normalized_quat(out: torch.Tensor) -> torch.Tensor:
    """``[xyz, quat, rest]`` with the quaternion divided by ``|quat| + 1e-8``,
    the reference's post-processing; returned as f32."""
    xyz, quat, rest = out[:, :3], out[:, 3:7], out[:, 7:]
    quat = quat / (torch.linalg.vector_norm(quat, dim=-1, keepdim=True) + 1e-8)
    return torch.cat([xyz, quat, rest], -1).to(torch.float32)


class CnnLangPolicy(nn.Module):
    """Per-camera siamese CNN over rgb(+pcd) -> lang-tiled MLP action head.

    Action = [xyz(3), quat(4), grip(1)] regressed directly (bc_lang). The
    JAX module infers its input widths at ``init``; here they are arguments
    (``build_policy`` reads them off a sample).
    """

    def __init__(self, num_cameras: int, in_channels: int, proprio_dim: int,
                 lang_dim: int, filters: Sequence[int] = (32, 64, 64),
                 fc_layers: Sequence[int] = (128, 64), action_dim: int = 8,
                 activation: str = "lrelu", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_cameras = num_cameras
        self.filters = tuple(filters)
        self.activation = activation
        self.dtype = dtype
        for cam in range(num_cameras):
            cin = in_channels
            for i, f in enumerate(self.filters):
                self.add_module(f"conv_{i}_{cam}", Conv2D(
                    cin, f, 3, strides=2, dtype=dtype, generator=generator))
                cin = f
        width = num_cameras * self.filters[-1] + proprio_dim + lang_dim
        self.fc_layers = tuple(fc_layers)
        for i, f in enumerate(self.fc_layers):
            self.add_module(f"fc_{i}", DenseBlock(width, f, activation, dtype, generator))
            width = f
        self.head = DenseBlock(width, action_dim, None, dtype, generator)

    def forward(self, rgbs, pcds, proprio, lang_goal_emb):
        act = act_fn(self.activation)
        feats = []
        for cam, (rgb, pcd) in enumerate(zip(rgbs, pcds)):
            x = torch.cat([rgb, pcd], -1).to(self.dtype)
            for i in range(len(self.filters)):
                x = act(getattr(self, f"conv_{i}_{cam}")(pad_same_nhwc(x, 3, 2)))
            feats.append(x.mean(dim=(1, 2)))
        h = torch.cat(feats + [proprio.to(self.dtype), lang_goal_emb.to(self.dtype)], -1)
        for i in range(len(self.fc_layers)):
            h = getattr(self, f"fc_{i}")(h)
        return _normalized_quat(self.head(h))


class DenseGeneral(nn.Module):
    """A flax ``DenseGeneral`` contraction held in flax's own layout:
    ``kernel`` of shape ``in_shape + out_shape``, ``bias`` of ``out_shape``,
    the input's trailing ``len(in_shape)`` axes contracted. lecun-normal over
    the flattened kernel, as flax draws it."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_in = len(in_shape)
        self.dtype = dtype
        flat = torch.empty(math.prod(in_shape), math.prod(out_shape))
        lecun_normal_(flat, flat.shape[0], generator)
        self.kernel = nn.Parameter(flat.reshape(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.zeros(*out_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = list(range(-self.n_in, 0))
        y = torch.tensordot(x.to(self.dtype), self.kernel.to(self.dtype),
                            dims=(dims, list(range(self.n_in))))
        return y + self.bias.to(self.dtype)


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` self-attention without
    dropout or mask: q, k, v ``[dim, heads, head_dim]`` with biases, the
    query divided by ``sqrt(head_dim)``, softmax over the keys, output
    ``[heads, head_dim, dim]``."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        self.head_dim = dim // heads
        self.dtype = dtype
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral((dim,), (heads, self.head_dim), dtype,
                                               generator))
        self.out = DenseGeneral((heads, self.head_dim), (dim,), dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)  # [B, T, H, D]
        q = q / torch.tensor(math.sqrt(self.head_dim), dtype=q.dtype, device=q.device)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        weights = torch.softmax(logits, dim=-1).to(self.dtype)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, v))


class ViTLangPolicy(nn.Module):
    """Patch-ViT over the cameras' images side by side + lang + proprio ->
    action. ``num_tokens`` (1 + the patch count) sizes ``pos``, which flax
    sizes at its first call."""

    def __init__(self, in_channels: int, proprio_dim: int, lang_dim: int,
                 num_tokens: int, patch: int = 8, dim: int = 128, depth: int = 4,
                 heads: int = 4, action_dim: int = 8, activation: str = "lrelu",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch, self.dim, self.depth = patch, dim, depth
        self.dtype = dtype
        self.patch_embed = Conv2D(in_channels, dim, patch, strides=patch, dtype=dtype,
                                  generator=generator)
        self.lang_proj = Dense(lang_dim, dim, dtype=dtype, generator=generator)
        self.pos = nn.Parameter(torch.empty(1, num_tokens, dim))
        with torch.no_grad():
            self.pos.normal_(0.0, 0.02, generator=generator)
        # flax numbers the unnamed layers per class in call order: two
        # LayerNorms and two Denses per block
        for i in range(depth):
            self.add_module(f"LayerNorm_{2 * i}", LayerNorm(dim, dtype=dtype))
            self.add_module(f"attn_{i}", MultiHeadDotProductAttention(dim, heads, dtype,
                                                                      generator))
            self.add_module(f"LayerNorm_{2 * i + 1}", LayerNorm(dim, dtype=dtype))
            self.add_module(f"Dense_{2 * i}", Dense(dim, dim * 4, dtype=dtype,
                                                    generator=generator))
            self.add_module(f"Dense_{2 * i + 1}", Dense(dim * 4, dim, dtype=dtype,
                                                        generator=generator))
        self.head = DenseBlock(dim + proprio_dim, action_dim, None, dtype, generator)

    def forward(self, rgbs, pcds, proprio, lang_goal_emb):
        x = torch.cat([torch.cat([r, p], -1) for r, p in zip(rgbs, pcds)],
                      2).to(self.dtype)  # the cameras side by side along the width
        b = x.shape[0]
        tokens = self.patch_embed(x).reshape(b, -1, self.dim)
        lang = self.lang_proj(lang_goal_emb.to(self.dtype))[:, None]
        tokens = torch.cat([lang, tokens], 1)
        if tokens.shape[1] != self.pos.shape[1]:
            raise ValueError(f"{tokens.shape[1]} tokens, but pos was sized for "
                             f"{self.pos.shape[1]}")
        tokens = tokens + self.pos.to(self.dtype)
        for i in range(self.depth):
            y = getattr(self, f"LayerNorm_{2 * i}")(tokens)
            tokens = tokens + getattr(self, f"attn_{i}")(y)
            y = getattr(self, f"LayerNorm_{2 * i + 1}")(tokens)
            y = gelu_tanh(getattr(self, f"Dense_{2 * i}")(y))
            tokens = tokens + getattr(self, f"Dense_{2 * i + 1}")(y)
        h = torch.cat([tokens[:, 0], proprio.to(self.dtype)], -1)
        return _normalized_quat(self.head(h))


def upsample_nearest2(x: torch.Tensor) -> torch.Tensor:
    """``jax.image.resize(x, 2x on D, H, W, "nearest")`` of ``[B, D, H, W,
    C]``: every voxel repeated twice along each spatial axis."""
    for axis in (1, 2, 3):
        x = x.repeat_interleave(2, dim=axis)
    return x


class LingUNetQNet(nn.Module):
    """Language-FiLMed 3D U-Net over the voxel grid -> Q_trans + rot/grip heads
    (C2FARM-BC's lingunet Q-attention): conv encoder, FiLM from language and
    proprio at the bottleneck, nearest-upsampled decode with skips, a
    1-channel translation Q head and an MLP rot/grip/collision head."""

    def __init__(self, in_channels: int, proprio_dim: int, lang_dim: int,
                 base_channels: int = 16, levels: int = 2,
                 num_rotation_classes: int = 72, activation: str = "lrelu",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.levels = levels
        self.dtype = dtype
        ch, cin, skips = base_channels, in_channels, []
        for i in range(levels):
            self.add_module(f"enc_{i}", Conv3D(cin, ch, 3, 1, activation, dtype=dtype,
                                               generator=generator))
            skips.append(ch)
            cin, ch = ch, ch * 2
        cond = lang_dim + proprio_dim
        self.film_gamma = Dense(cond, ch // 2, dtype=dtype, generator=generator)
        self.film_beta = Dense(cond, ch // 2, dtype=dtype, generator=generator)
        self.bottleneck = Conv3D(cin, ch // 2, 3, 1, activation, dtype=dtype,
                                 generator=generator)
        c = ch // 2
        for i in reversed(range(levels)):
            out = max(base_channels, c // 2)
            self.add_module(f"dec_{i}", Conv3D(c + skips[i], out, 3, 1, activation,
                                               dtype=dtype, generator=generator))
            c = out
        self.trans_head = Conv3D(c, 1, 3, 1, None, dtype=dtype, generator=generator)
        self.head_fc = DenseBlock(c + cond, 128, activation, dtype, generator)
        self.rot_grip_collision = DenseBlock(128, num_rotation_classes * 3 + 4, None,
                                             dtype, generator)

    def forward(self, voxel_grid, proprio, lang_goal_emb):
        x = voxel_grid.to(self.dtype)
        skips = []
        for i in range(self.levels):
            x = getattr(self, f"enc_{i}")(x)
            skips.append(x)
            x = to_ndhwc(F.max_pool3d(to_ncdhw(x), 2, 2))
        cond = torch.cat([lang_goal_emb.to(self.dtype), proprio.to(self.dtype)], -1)
        gamma = self.film_gamma(cond)[:, None, None, None]
        beta = self.film_beta(cond)[:, None, None, None]
        x = self.bottleneck(x)
        x = x * (1 + gamma) + beta
        for i in reversed(range(self.levels)):
            x = torch.cat([upsample_nearest2(x), skips[i]], -1)
            x = getattr(self, f"dec_{i}")(x)
        q_trans = self.trans_head(x).to(torch.float32)
        pooled = x.amax(dim=(1, 2, 3)).to(self.dtype)
        h = self.head_fc(torch.cat([pooled, cond], -1))
        rgc = self.rot_grip_collision(h).to(torch.float32)
        return {"trans": q_trans, "rot_grip": rgc[:, :-2], "collision": rgc[:, -2:]}


def build_policy(network: str, rgbs, pcds, proprio, lang_goal_emb,
                 generator: Optional[torch.Generator] = None, **net_kw) -> nn.Module:
    """``CnnLangPolicy`` (``network='cnn'``) or ``ViTLangPolicy`` (any other
    name, as the JAX agent chooses) sized from one sample of its inputs, as
    flax's ``init`` sizes it: the cameras, their channels, the proprio and
    language widths and, for the ViT, the token count."""
    cin = rgbs[0].shape[-1] + pcds[0].shape[-1]
    proprio_dim, lang_dim = proprio.shape[-1], lang_goal_emb.shape[-1]
    if network == "cnn":
        return CnnLangPolicy(len(rgbs), cin, proprio_dim, lang_dim, generator=generator,
                             **net_kw)
    patch = net_kw.get("patch", 8)
    width = sum(r.shape[2] for r in rgbs)
    num_tokens = 1 + (rgbs[0].shape[1] // patch) * (width // patch)
    return ViTLangPolicy(cin, proprio_dim, lang_dim, num_tokens, generator=generator,
                         **net_kw)
