"""The plain reference of OWL-ViT's detection (Minderer et al., arXiv
2205.06230; ``google/owlvit-base-patch32``), float32.

A CLIP ViT image tower whose patch tokens, each multiplied by the class
token, feed a class head (the cosine of a projected token with each query
embedding, shifted and scaled per token) and a box head (an MLP whose
output is biased toward the token's own grid cell, then a sigmoid to cxcywh
in [0, 1]); the queries come from CLIP's text tower (causal mask, the token
at the end-of-text id pooled, projected). Written from the paper and
``transformers``' ``OwlViTForObjectDetection`` as one function of the
parameter dictionary of ``reference/vlm_params.py``; nothing here imports
the port. Departures from the published code, each as the port has it:
- the frame is scaled to [0, 1] and resized to the tower's square without
  CLIP's mean and std;
- the query's BPE token ids are data (the port's tokenizer makes them);
- the image is resized by half-pixel bilinear interpolation (an upsample
  from the 640 x 480 frame, where the port's antialiased resize and
  ``F.interpolate`` agree).

``precision`` as ``reference/qnet.py``'s: ``exact`` (TF32 off:
``qnet.float32_only``) or ``fp8``, every product's operands in float8 e4m3,
one scale per tensor.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.qnet import float32_only, rounding

F32 = torch.float32


def linear(p, name, x, r):
    y = F.linear(r.a(x), r.a(p[name + ".weight"]))
    b = p.get(name + ".bias")
    return y if b is None else y + b


def layer_norm(p, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], eps)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def attention(q, k, v, r, mask=None):
    """``[B, H, T, hd]`` q, k, v -> softmax(q k^T / sqrt(hd) + mask) v."""
    logits = torch.matmul(r.a(q), r.a(k).transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        logits = logits + mask
    return torch.matmul(r.a(torch.softmax(logits, -1)), r.a(v))


def heads(x, n):
    b, t, d = x.shape
    return x.reshape(b, t, n, d // n).transpose(1, 2)


def merge(x):
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def clip_block(p, b, x, n_heads, r, names, mask=None):
    """A pre-LN CLIP block; ``names``: (ln1, qkv, proj, ln2, fc1, fc2)."""
    ln1, qkv, proj, ln2, fc1, fc2 = (b + n for n in names)
    q, k, v = linear(p, qkv, layer_norm(p, ln1, x, 1e-5), r).chunk(3, -1)
    x = x + linear(p, proj, merge(attention(heads(q, n_heads), heads(k, n_heads),
                                            heads(v, n_heads), r, mask)), r)
    return x + linear(p, fc2, quick_gelu(linear(p, fc1, layer_norm(p, ln2, x, 1e-5), r)), r)


VISION_NAMES = ("ln1", "qkv", "proj", "ln2", "fc1", "fc2")
TEXT_NAMES = ("ln_1", "attn_in", "attn_out", "ln_2", "mlp_fc", "mlp_proj")


def preprocess(rgb: torch.Tensor, size: int) -> torch.Tensor:
    """uint8-valued ``[H, W, 3]`` -> ``[1, 3, size, size]`` in [0, 1]."""
    x = rgb.to(F32).permute(2, 0, 1)[None] / 255.0
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False)


def image_tokens(p, spec: dict, x: torch.Tensor, r) -> torch.Tensor:
    """``[1, 3, S, S]`` -> the patch tokens times the class token, ``[1, T, d]``."""
    pt = spec["patch"]
    tokens = F.conv2d(r.a(x), r.a(p["image_encoder.patch_embed.weight"]), stride=pt)
    tokens = tokens.flatten(2).transpose(1, 2)
    cls = p["image_encoder.cls_token"].expand(tokens.shape[0], 1, -1)
    x = layer_norm(p, "image_encoder.pre_ln",
                   torch.cat([cls, tokens], 1) + p["image_encoder.pos_embed"], 1e-5)
    for i in range(spec["depth"]):
        x = clip_block(p, f"image_encoder.block_{i}.", x, spec["heads"], r, VISION_NAMES)
    x = layer_norm(p, "image_encoder.post_ln", x, 1e-5)
    return x[:, 1:] * x[:, :1]


def box_bias(g: int, device) -> torch.Tensor:
    """``[g * g, 4]``: the logit of each token's grid-cell corner and of the
    cell's size (``compute_box_bias``)."""
    xs = torch.arange(1, g + 1, dtype=F32, device=device) / g
    coords = torch.stack([xs[None, :].expand(g, g).reshape(-1),
                          xs[:, None].expand(g, g).reshape(-1)], -1).clamp(0.0, 1.0)
    size = torch.full_like(coords, 1.0 / g)
    logit = lambda c: torch.log(c + 1e-4) - torch.log1p(-c + 1e-4)  # noqa: E731
    return torch.cat([logit(coords), logit(size)], -1)


def normalize(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)


@float32_only()
def detect(params: Dict[str, torch.Tensor], spec: dict, rgb: torch.Tensor,
           query_emb: torch.Tensor, precision: str = "exact") -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame ``[H, W, 3]`` and query embeddings ``[Q, E]`` -> (class
    logits ``[T, Q]``, boxes ``[T, 4]`` cxcywh), f32. ``params``: the
    ``owl.`` tower (``vlm_params.tower``)."""
    r = rounding(precision)
    p = params
    feats = image_tokens(p, spec, preprocess(rgb, spec["img_size"]), r)
    f = layer_norm(p, "merged_ln", feats, 1e-5)
    sims = torch.einsum("btd,qd->btq", r.a(normalize(linear(p, "class_proj", f, r))),
                        r.a(normalize(query_emb)))
    scale = F.elu(linear(p, "logit_scale_head", f, r)) + 1.0
    logits = (sims + linear(p, "logit_shift", f, r)) * scale
    h = F.gelu(linear(p, "box_dense0", f, r))
    h = linear(p, "box_dense2", F.gelu(linear(p, "box_dense1", h, r)), r)
    g = spec["img_size"] // spec["patch"]
    boxes = torch.sigmoid(h + box_bias(g, h.device)[None])
    return logits[0], boxes[0]


@float32_only()
def embed_text(params: Dict[str, torch.Tensor], spec: dict, ids: torch.Tensor,
               precision: str = "exact") -> torch.Tensor:
    """Token ids ``[Q, ctx]`` -> sentence embeddings ``[Q, E]``: CLIP's
    causal text tower, the end-of-text token (the largest id) pooled and
    projected. ``params``: the ``owl_text.`` tower."""
    r = rounding(precision)
    p = params
    t = ids.shape[1]
    x = p["token_embedding"][ids.long()] + p["positional_embedding"][:t]
    causal = torch.full((t, t), float("-inf"), device=x.device).triu(1)
    for i in range(spec["layers"]):
        x = clip_block(p, f"resblock_{i}.", x, spec["heads"], r, TEXT_NAMES, causal)
    x = layer_norm(p, "ln_final", x, 1e-5)
    pooled = x[torch.arange(x.shape[0], device=x.device), ids.argmax(-1)]
    return torch.matmul(r.a(pooled), r.a(p["text_projection"]))
