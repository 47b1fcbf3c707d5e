"""CLIP ModifiedResNet (RN50) image tower.

Counterpart of ``voxactb_tpu.models.clip_image`` (the vendored CLIP's
``ModifiedResNet``, clip.py:128-210): a 3-conv stem with avgpool striding, 4
bottleneck stages whose stride-2 blocks pool before their last conv and in
their shortcut, and an ``AttentionPool2d`` head projecting to the 1024-d joint
space. ``forward`` can return the stage features too. It runs in f32, on
``nn.Conv2d`` and ``nn.BatchNorm2d`` in eval mode (the running statistics
come from the flax ``batch_stats`` through ``weights.load_flax_params``); the
attention pool is a plain softmax over 50 tokens, as in the JAX package.
Input and features are channels-last; submodules carry the flax names.

``load_torch_clip_image_weights`` maps the OpenAI state_dict (``visual.*``)
onto the flax tree ``{'params', 'batch_stats'}``; ``preprocess_clip_image``
is the JAX package's bicubic resize and normalisation.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from voxactb_tpu_torch.models.blocks import Dense, lecun_normal_
from voxactb_tpu_torch.models.torch_port import make_port_helpers


def _conv(cin: int, cout: int, k: int, stride: int = 1, pad: int = 0,
          generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=False)
    lecun_normal_(conv.weight, cin * k * k, generator)
    return conv


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_ch = planes * self.expansion
        self.stride = stride
        self.conv1 = _conv(inplanes, planes, 1, generator=generator)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, pad=1, generator=generator)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = _conv(planes, out_ch, 1, generator=generator)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.has_downsample = stride > 1 or inplanes != out_ch
        if self.has_downsample:
            self.downsample_conv = _conv(inplanes, out_ch, 1, generator=generator)
            self.downsample_bn = nn.BatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        if self.stride > 1:  # CLIP's anti-aliased striding: avgpool then conv
            y = F.avg_pool2d(y, self.stride)
        y = self.bn3(self.conv3(y))
        identity = x
        if self.has_downsample:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return F.relu(y + identity)


class AttentionPool2d(nn.Module):
    def __init__(self, spatial: int, embed_dim: int, num_heads: int, output_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.empty(spatial * spatial + 1, embed_dim))
        with torch.no_grad():
            self.positional_embedding.normal_(0.0, embed_dim ** -0.5, generator=generator)
        for name in ("q_proj", "k_proj", "v_proj"):
            setattr(self, name, Dense(embed_dim, embed_dim, generator=generator))
        self.c_proj = Dense(embed_dim, output_dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        b, c = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)  # [B, HW, C], rows of the grid in order
        tokens = torch.cat([tokens.mean(1, keepdim=True), tokens], 1)
        tokens = tokens + self.positional_embedding[None]
        hd = c // self.num_heads

        def split(t):
            return t.reshape(b, -1, self.num_heads, hd).transpose(1, 2)

        q, k, v = split(self.q_proj(tokens[:, :1])), split(self.k_proj(tokens)), \
            split(self.v_proj(tokens))
        attn = torch.softmax(torch.matmul(q * hd ** -0.5, k.transpose(-1, -2)), -1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, 1, c)
        return self.c_proj(out)[:, 0].float()


class ClipResNetImageEncoder(nn.Module):
    """RN50: layers (3, 4, 6, 3), width 64, embed 1024, input 224^2 (the
    attention pool's positional table is sized for ``input_resolution``).
    ``[B, H, W, 3]`` normalised -> ``[B, output_dim]`` f32; with
    ``return_pyramid`` also the four stages' ``[B, h, w, C]`` features."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 output_dim: int = 1024, heads: int = 32, input_resolution: int = 224,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = tuple(layers)
        # 3-conv stem with torch's symmetric padding of 1, also at stride 2
        for i, (cin, cout, stride) in enumerate(
                [(3, width // 2, 2), (width // 2, width // 2, 1), (width // 2, width, 1)]):
            setattr(self, f"stem_conv{i + 1}", _conv(cin, cout, 3, stride, 1, generator))
            setattr(self, f"stem_bn{i + 1}", nn.BatchNorm2d(cout))
        inplanes, planes = width, width
        for stage, blocks in enumerate(self.layers):
            for b in range(blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                setattr(self, f"layer{stage + 1}_{b}",
                        Bottleneck(inplanes, planes, stride, generator))
                inplanes = planes * Bottleneck.expansion
            planes *= 2
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32, heads,
                                        output_dim, generator)
        self.eval()

    def forward(self, x: torch.Tensor, return_pyramid: bool = False):
        x = x.to(torch.float32).permute(0, 3, 1, 2)
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"stem_bn{i}")(getattr(self, f"stem_conv{i}")(x)))
        x = F.avg_pool2d(x, 2)
        pyramid = []
        for stage, blocks in enumerate(self.layers):
            for b in range(blocks):
                x = getattr(self, f"layer{stage + 1}_{b}")(x)
            pyramid.append(x.permute(0, 2, 3, 1))
        emb = self.attnpool(x)
        return (emb, pyramid) if return_pyramid else emb


def load_torch_clip_image_weights(state_dict, prefix: str = "visual.") -> dict:
    """Map the reference CLIP ``ModifiedResNet`` state_dict onto this module.

    Accepts the full CLIP state_dict (keys ``visual.*``, clip.py:311-365) or a bare
    ``ModifiedResNet`` one (``prefix=""``); values may be torch tensors or numpy.
    Returns ``{"params": ..., "batch_stats": ...}`` — BatchNorm running stats land in
    the ``batch_stats`` collection so eval-mode forwards reproduce the torch tower.
    """

    a = make_port_helpers(state_dict, prefix)[0]

    def conv(key):  # torch [out, in, kh, kw] -> flax [kh, kw, in, out]
        return {"kernel": a(key + ".weight").transpose(2, 3, 1, 0)}

    def bn(key):
        return ({"scale": a(key + ".weight"), "bias": a(key + ".bias")},
                {"mean": a(key + ".running_mean"), "var": a(key + ".running_var")})

    params, stats = {}, {}
    for i in (1, 2, 3):
        params[f"stem_conv{i}"] = conv(f"conv{i}")
        params[f"stem_bn{i}"], stats[f"stem_bn{i}"] = bn(f"bn{i}")

    layer_blocks = {}
    for k in state_dict:
        kk = k[len(prefix):] if k.startswith(prefix) else None
        if kk and kk.startswith("layer"):
            stage = int(kk[5])
            blk = int(kk.split(".")[1])
            layer_blocks[stage] = max(layer_blocks.get(stage, 0), blk + 1)
    for stage, blocks in sorted(layer_blocks.items()):
        for b in range(blocks):
            p = f"layer{stage}.{b}"
            leaf, bstats = {}, {}
            for c in ("conv1", "conv2", "conv3"):
                leaf[c] = conv(f"{p}.{c}")
            for c in ("bn1", "bn2", "bn3"):
                leaf[c], bstats[c] = bn(f"{p}.{c}")
            if prefix + f"{p}.downsample.0.weight" in state_dict:
                leaf["downsample_conv"] = conv(f"{p}.downsample.0")
                leaf["downsample_bn"], bstats["downsample_bn"] = bn(
                    f"{p}.downsample.1")
            params[f"layer{stage}_{b}"] = leaf
            stats[f"layer{stage}_{b}"] = bstats

    params["attnpool"] = {
        "positional_embedding": a("attnpool.positional_embedding"),
    }
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        params["attnpool"][proj] = {
            "kernel": a(f"attnpool.{proj}.weight").T,
            "bias": a(f"attnpool.{proj}.bias"),
        }
    return {"params": params, "batch_stats": stats}


CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_clip_image(rgb: np.ndarray, size: int = 224, device=None) -> torch.Tensor:
    """uint8 ``[H, W, 3]`` -> normalised ``[1, size, size, 3]`` f32 on
    ``device`` (bicubic resize as ``jax.image.resize``, then CLIP's mean and
    std)."""
    from voxactb_tpu_torch.ops.resize import resize_cubic

    x = torch.as_tensor(np.asarray(rgb), dtype=torch.float32, device=device) / 255.0
    x = resize_cubic(x, (size, size, 3))
    x = (x - torch.as_tensor(CLIP_IMAGE_MEAN, device=device)) \
        / torch.as_tensor(CLIP_IMAGE_STD, device=device)
    return x[None]
