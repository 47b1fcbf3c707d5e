"""The VLM crop's weights: one flat ``name -> tensor`` dict that the program
(``TorchOwlVitSamDetector.build(params=...)``) and the plain reference
(``reference/owlvit.py``, ``reference/sam.py``) both read by name.

Names and layouts are the port's ``state_dict`` names under four prefixes:
``owl.`` (OWL-ViT's image tower and heads), ``owl_text.`` (its CLIP text
tower), ``sam.`` (SAM's image encoder) and ``decoder.`` (SAM's prompt
encoder and mask decoder). A matrix is ``[out, in]``, a convolution
``[out, in, kh, kw]``, a transposed convolution ``[in, out, kh, kw]``.
Nothing here imports the port.

``spec`` is a configuration's ``vlm`` group: ``owl``, ``owl_text``, ``sam``
and ``decoder``, each a tower's widths.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

F32 = torch.float32
Shapes = Dict[str, Tuple[int, ...]]


def _dense(out: Shapes, name: str, n_in: int, n_out: int, bias: bool = True) -> None:
    out[name + ".weight"] = (n_out, n_in)
    if bias:
        out[name + ".bias"] = (n_out,)


def _norm(out: Shapes, name: str, n: int) -> None:
    out[name + ".weight"] = (n,)
    out[name + ".bias"] = (n,)


def owl_shapes(o: dict) -> Shapes:
    d, g = o["dim"], o["img_size"] // o["patch"]
    out: Shapes = {"image_encoder.patch_embed.weight": (d, 3, o["patch"], o["patch"]),
                   "image_encoder.cls_token": (1, 1, d),
                   "image_encoder.pos_embed": (1, g * g + 1, d)}
    _norm(out, "image_encoder.pre_ln", d)
    for i in range(o["depth"]):
        b = f"image_encoder.block_{i}."
        _norm(out, b + "ln1", d)
        _dense(out, b + "qkv", d, 3 * d)
        _dense(out, b + "proj", d, d)
        _norm(out, b + "ln2", d)
        _dense(out, b + "fc1", d, 4 * d)
        _dense(out, b + "fc2", 4 * d, d)
    _norm(out, "image_encoder.post_ln", d)
    _norm(out, "merged_ln", d)
    _dense(out, "class_proj", d, o["embed_dim"])
    _dense(out, "logit_shift", d, 1)
    _dense(out, "logit_scale_head", d, 1)
    _dense(out, "box_dense0", d, d)
    _dense(out, "box_dense1", d, d)
    _dense(out, "box_dense2", d, 4)
    return out


def text_shapes(t: dict) -> Shapes:
    w = t["width"]
    out: Shapes = {"token_embedding": (t["vocab_size"], w),
                   "positional_embedding": (t["context_length"], w),
                   "text_projection": (w, t["embed_dim"])}
    for i in range(t["layers"]):
        b = f"resblock_{i}."
        _norm(out, b + "ln_1", w)
        _dense(out, b + "attn_in", w, 3 * w)
        _dense(out, b + "attn_out", w, w)
        _norm(out, b + "ln_2", w)
        _dense(out, b + "mlp_fc", w, 4 * w)
        _dense(out, b + "mlp_proj", 4 * w, w)
    _norm(out, "ln_final", w)
    return out


def sam_shapes(s: dict) -> Shapes:
    c, p = s["embed_dim"], s["patch_size"]
    g = s["img_size"] // p
    hd = c // s["num_heads"]
    out: Shapes = {"patch_embed.weight": (c, 3, p, p), "patch_embed.bias": (c,),
                   "pos_embed": (1, g, g, c)}
    for i in range(s["depth"]):
        b = f"block_{i}."
        n = g if i in s["global_attn_indexes"] else s["window_size"]
        _norm(out, b + "norm1", c)
        _dense(out, b + "attn.qkv", c, 3 * c)
        _dense(out, b + "attn.proj", c, c)
        out[b + "attn.rel_pos_h"] = (2 * n - 1, hd)
        out[b + "attn.rel_pos_w"] = (2 * n - 1, hd)
        _norm(out, b + "norm2", c)
        _dense(out, b + "mlp_fc1", c, 4 * c)
        _dense(out, b + "mlp_fc2", 4 * c, c)
    oc = s["out_chans"]
    out["neck_conv1.weight"] = (oc, c, 1, 1)
    _norm(out, "neck_ln1", oc)
    out["neck_conv2.weight"] = (oc, oc, 3, 3)
    _norm(out, "neck_ln2", oc)
    return out


def decoder_shapes(d: dict) -> Shapes:
    dim, m = d["dim"], d["num_masks"]
    out: Shapes = {"pe.gaussian_matrix": (2, dim // 2), "corner_embed": (2, dim),
                   "iou_token": (1, dim), "mask_tokens": (m, dim), "no_mask_embed": (1, dim)}

    def attn(name, downsample):
        inner = dim // downsample
        for proj in ("q", "k", "v"):
            _dense(out, f"{name}.{proj}", dim, inner)
        _dense(out, name + ".out", inner, dim)

    for i in range(d["depth"]):
        b = f"block_{i}."
        attn(b + "self_attn", 1)
        attn(b + "cross_t2i", 2)
        attn(b + "cross_i2t", 2)
        for j in range(4):
            _norm(out, b + f"LayerNorm_{j}", dim)
        _dense(out, b + "Dense_0", dim, d["mlp_dim"])
        _dense(out, b + "Dense_1", d["mlp_dim"], dim)
    attn("final_t2i", 2)
    _norm(out, "LayerNorm_0", dim)
    out["up1.weight"] = (dim, dim // 4, 2, 2)
    out["up1.bias"] = (dim // 4,)
    _norm(out, "LayerNorm_1", dim // 4)
    out["up2.weight"] = (dim // 4, dim // 8, 2, 2)
    out["up2.bias"] = (dim // 8,)
    for i in range(m):
        for j, (a, b) in enumerate(((dim, dim), (dim, dim), (dim, dim // 8))):
            _dense(out, f"hyper_{i}.Dense_{j}", a, b)
    for j, (a, b) in enumerate(((dim, dim), (dim, dim), (dim, m))):
        _dense(out, f"iou_head.Dense_{j}", a, b)
    return out


def param_shapes(spec: dict) -> Shapes:
    out: Shapes = {}
    for prefix, fn, key in (("owl.", owl_shapes, "owl"), ("owl_text.", text_shapes, "owl_text"),
                            ("sam.", sam_shapes, "sam"), ("decoder.", decoder_shapes, "decoder")):
        out.update({prefix + k: v for k, v in fn(spec[key]).items()})
    return out


def _scale(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of a parameter's draw, at its module's initialisation
    scale."""
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("decoder.") and leaf in ("gaussian_matrix", "corner_embed",
                                                "iou_token", "mask_tokens", "no_mask_embed"):
        return 0.0, 1.0
    if leaf == "positional_embedding":
        return 0.0, 0.01
    if leaf in ("token_embedding", "cls_token", "pos_embed"):
        return 0.0, 0.02
    if leaf in ("rel_pos_h", "rel_pos_w"):
        return 0.0, 0.1
    if leaf == "text_projection":  # [in, out]
        return 0.0, shape[0] ** -0.5
    if leaf == "bias":
        return 0.0, 0.02
    if len(shape) == 1:  # a LayerNorm's scale
        return 1.0, 0.1
    if name.endswith(("up1.weight", "up2.weight")):  # [in, out, 2, 2], stride 2
        return 0.0, shape[0] ** -0.5
    return 0.0, float(np.prod(shape[1:])) ** -0.5


def draw_vlm_params(spec: dict, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights in one draw on ``device``: each matrix or
    kernel N(0, 1 / fan_in), each bias N(0, 0.02^2), each LayerNorm scale
    1 + N(0, 0.1^2), the embeddings N(0, 0.02^2) (CLIP's positions 0.01^2),
    SAM's rel-pos tables N(0, 0.1^2) (zero at initialisation: drawn so that
    the bias path works), the prompt encoder's Fourier matrix and learned
    tokens N(0, 1)."""
    shapes = param_shapes(spec)
    sizes = [int(np.prod(v)) for v in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator, device=device, dtype=F32)
    out, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        mean, std = _scale(name, shape)
        out[name] = flat[at:at + size].view(shape).mul_(std).add_(mean)
        at += size
    return out


def tower(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The parameters under ``prefix`` (e.g. ``"sam."``), the prefix removed."""
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}
