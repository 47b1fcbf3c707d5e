"""Pretrained-weights discovery and loaders for the language and vision towers.

The port's counterpart of ``voxactb_tpu.utils.pretrained``. No checkpoint
ships with the repository, so every tower runs on seeded weights unless one
is on disk; the reference conditions on real CLIP RN50 language
(launch_utils.py:384-400) and recentres the grid with real OWL-ViT + SAM
(vlm.py:77-143). This module is where real weights enter:

    export VOXACTB_WEIGHTS_DIR=/path/to/weights   # or put the files in weights/

Recognized files (first match wins):
    clip_rn50.pt | RN50.pt            OpenAI CLIP RN50 (state_dict or jit archive)
    sam_vit_b.pth | sam_vit_l.pth | sam_vit_h.pth   segment-anything checkpoints
    owlvit_base.pt                    transformers OwlViTForObjectDetection state_dict

Each loader maps the file through the port's importer onto the JAX package's
flax tree (numpy leaves, equal leaf for leaf to the JAX importer's) and loads
it into the port's tower, built in f32 at the checkpoint's dims on
``device`` (CUDA unless the caller passes ``"cpu"``); it returns the tower
and the tree, from which other towers (bf16, the kernel path) load too. A
missing key or a shape that does not fit raises.

The ``*_key_shapes`` functions give the upstream layouts (key -> shape) at
the published sizes by default, for synthetic checkpoints.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

_CANDIDATES = {
    "clip": ("clip_rn50.pt", "RN50.pt"),
    "sam_vit_b": ("sam_vit_b.pth",),
    "sam_vit_l": ("sam_vit_l.pth",),
    "sam_vit_h": ("sam_vit_h.pth",),
    "owlvit": ("owlvit_base.pt",),
}


def weights_dir() -> str:
    default = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "weights")
    return os.environ.get("VOXACTB_WEIGHTS_DIR", default)


def find_weights(name: str) -> Optional[str]:
    """Path of a recognized checkpoint for ``name`` (see _CANDIDATES), or None."""
    d = weights_dir()
    for fname in _CANDIDATES.get(name, ()):
        p = os.path.join(d, fname)
        if os.path.exists(p):
            return p
    return None


def _torch_state_dict(path: str):
    """Load a torch checkpoint as a state_dict of tensors/arrays.

    Handles plain state_dicts, {'state_dict'|'model': ...} wrappers, and OpenAI's
    TorchScript archives (the reference's load path, clip.py:559-607, tries jit
    first then falls back to a state_dict)."""
    import torch

    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except Exception:
        obj = torch.jit.load(path, map_location="cpu").state_dict()
    if hasattr(obj, "state_dict") and not isinstance(obj, dict):
        obj = obj.state_dict()
    if isinstance(obj, dict):
        for key in ("state_dict", "model"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    return obj


def _loaded(build, tree, device):
    """``build()`` on ``device`` (f32, eval), filled from ``tree``."""
    import torch

    from voxactb_tpu_torch.device import resolve_device
    from voxactb_tpu_torch.weights import load_flax_params

    with torch.device(resolve_device(device)):
        model = build()
    load_flax_params(model, tree)
    return model.eval()


def clip_text_from(params, device=None, **kw):
    """``ClipTextEncoder`` at the dims of a CLIP text tree (``kw``, e.g.
    ``dtype``, as its arguments), loaded."""
    from voxactb_tpu_torch.models.clip_text import ClipTextEncoder

    p = params["params"]
    width = p["positional_embedding"].shape[1]
    return _loaded(lambda: ClipTextEncoder(
        vocab_size=p["token_embedding"].shape[0],
        context_length=p["positional_embedding"].shape[0], width=width,
        heads=max(1, width // 64), layers=sum(1 for k in p if k.startswith("resblock_")),
        embed_dim=p["text_projection"].shape[1], **kw), params, device)


def load_clip_text(path: Optional[str] = None, device=None):
    """(ClipTextEncoder at the checkpoint's text dims, ported params) from a
    CLIP checkpoint. Returns None when no checkpoint is found."""
    path = path or find_weights("clip")
    if path is None:
        return None
    from voxactb_tpu_torch.models.clip_text import load_torch_clip_weights

    params = load_torch_clip_weights(_torch_state_dict(path))
    return clip_text_from(params, device), params


def load_clip_image(path: Optional[str] = None, device=None):
    """(ClipResNetImageEncoder, ported variables incl. batch_stats), or None."""
    path = path or find_weights("clip")
    if path is None:
        return None
    from voxactb_tpu_torch.models.clip_image import (
        ClipResNetImageEncoder, load_torch_clip_image_weights)

    variables = load_torch_clip_image_weights(_torch_state_dict(path))
    p = variables["params"]
    stem = p["stem_conv1"]["kernel"].shape[-1]
    layers = [sum(1 for k in p if k.startswith(f"layer{s}_")) for s in (1, 2, 3, 4)]
    pool = p["attnpool"]
    res = round((pool["positional_embedding"].shape[0] - 1) ** 0.5) * 32
    width = stem * 2
    model = _loaded(lambda: ClipResNetImageEncoder(
        layers=layers, width=width, output_dim=pool["c_proj"]["kernel"].shape[1],
        heads=width * 32 // 64, input_resolution=res), variables, device)
    return model, variables


_SAM_SIZES = {"vit_b": "sam_vit_b", "vit_l": "sam_vit_l", "vit_h": "sam_vit_h"}


def sam_encoder_from(params, size: str = "vit_h", device=None, **kw):
    """The SAM image encoder of ``size`` (``kw`` as ``sam_vit_h``'s), loaded
    from a SAM encoder tree."""
    from voxactb_tpu_torch.models import sam_encoder as se

    return _loaded(lambda: getattr(se, _SAM_SIZES[size])(**kw), params, device)


def load_sam_encoder(size: str = "vit_h", path: Optional[str] = None, device=None):
    """(SamImageEncoder of the requested size, ported params), or None."""
    path = path or find_weights(f"sam_{size}")
    if path is None:
        return None
    from voxactb_tpu_torch.models.sam_encoder import load_torch_sam_weights

    params = load_torch_sam_weights(_torch_state_dict(path))
    return sam_encoder_from(params, size, device), params


def owlvit_from(det_params, text_params, device=None, dtype=None):
    """(OwlViTDetector, text ClipTextEncoder) at the dims of the OWL-ViT
    trees (in ``dtype``, f32 by default), loaded."""
    import torch

    dt = dict(dtype=dtype or torch.float32)
    from voxactb_tpu_torch.models.owlvit import OwlViTDetector, OwlViTImageEncoder

    vp = det_params["params"]["image_encoder"]
    dim = vp["cls_token"].shape[-1]
    depth = sum(1 for k in vp if k.startswith("block_"))
    n_pos = vp["pos_embed"].shape[1] - 1
    patch = vp["patch_embed"]["kernel"].shape[0]
    img = int(round(n_pos ** 0.5)) * patch
    embed = text_params["params"]["text_projection"].shape[1]
    det = _loaded(lambda: OwlViTDetector(
        embed_dim=embed, image_encoder=OwlViTImageEncoder(
            img_size=img, patch=patch, dim=dim, depth=depth, heads=max(1, dim // 64), **dt),
        **dt), det_params, device)
    return det, clip_text_from(text_params, device, **dt)


def load_owlvit(path: Optional[str] = None, device=None):
    """((OwlViTDetector, det params), (ClipTextEncoder, text params)), or None."""
    path = path or find_weights("owlvit")
    if path is None:
        return None
    from voxactb_tpu_torch.models.owlvit import load_hf_owlvit_weights

    det_params, text_params = load_hf_owlvit_weights(_torch_state_dict(path))
    det, text = owlvit_from(det_params, text_params, device)
    return (det, det_params), (text, text_params)


# -- the upstream layouts ------------------------------------------------------------

Shapes = Dict[str, Tuple[int, ...]]


def _bn(key: str, n: int) -> Shapes:
    return {f"{key}.weight": (n,), f"{key}.bias": (n,), f"{key}.running_mean": (n,),
            f"{key}.running_var": (n,), f"{key}.num_batches_tracked": ()}


def _linear(key: str, n_in: int, n_out: int, bias: bool = True) -> Shapes:
    out = {f"{key}.weight": (n_out, n_in)}
    if bias:
        out[f"{key}.bias"] = (n_out,)
    return out


def _norm(key: str, n: int) -> Shapes:
    return {f"{key}.weight": (n,), f"{key}.bias": (n,)}


def clip_rn50_key_shapes(embed_dim: int = 1024, image_resolution: int = 224,
                         vision_layers: Sequence[int] = (3, 4, 6, 3), vision_width: int = 64,
                         context_length: int = 77, vocab_size: int = 49408,
                         transformer_width: int = 512,
                         transformer_layers: int = 12) -> Shapes:
    """OpenAI CLIP with the ModifiedResNet image tower (clip.py:311-365), RN50
    by default: the text tower, ``logit_scale`` and ``visual.*`` with the
    BatchNorms' running statistics."""
    w = transformer_width
    shapes: Shapes = {"positional_embedding": (context_length, w),
                      "text_projection": (w, embed_dim), "logit_scale": (),
                      "token_embedding.weight": (vocab_size, w), **_norm("ln_final", w)}
    for i in range(transformer_layers):
        p = f"transformer.resblocks.{i}"
        shapes.update({f"{p}.attn.in_proj_weight": (3 * w, w),
                       f"{p}.attn.in_proj_bias": (3 * w,),
                       **_linear(f"{p}.attn.out_proj", w, w), **_norm(f"{p}.ln_1", w),
                       **_linear(f"{p}.mlp.c_fc", w, 4 * w),
                       **_linear(f"{p}.mlp.c_proj", 4 * w, w), **_norm(f"{p}.ln_2", w)})
    vw = vision_width
    for i, (cin, cout) in enumerate(((3, vw // 2), (vw // 2, vw // 2), (vw // 2, vw))):
        shapes[f"visual.conv{i + 1}.weight"] = (cout, cin, 3, 3)
        shapes.update(_bn(f"visual.bn{i + 1}", cout))
    inplanes, planes = vw, vw
    for stage, blocks in enumerate(vision_layers):
        for b in range(blocks):
            p = f"visual.layer{stage + 1}.{b}"
            shapes.update({f"{p}.conv1.weight": (planes, inplanes, 1, 1),
                           f"{p}.conv2.weight": (planes, planes, 3, 3),
                           f"{p}.conv3.weight": (planes * 4, planes, 1, 1),
                           **_bn(f"{p}.bn1", planes), **_bn(f"{p}.bn2", planes),
                           **_bn(f"{p}.bn3", planes * 4)})
            if b == 0 and (stage > 0 or inplanes != planes * 4):
                shapes[f"{p}.downsample.0.weight"] = (planes * 4, inplanes, 1, 1)
                shapes.update(_bn(f"{p}.downsample.1", planes * 4))
            inplanes = planes * 4
        planes *= 2
    c = vw * 32
    shapes["visual.attnpool.positional_embedding"] = ((image_resolution // 32) ** 2 + 1, c)
    for proj in ("k_proj", "q_proj", "v_proj"):
        shapes.update(_linear(f"visual.attnpool.{proj}", c, c))
    shapes.update(_linear("visual.attnpool.c_proj", c, embed_dim))
    return shapes


def owlvit_key_shapes(vision_width: int = 768, vision_layers: int = 12,
                      vision_mlp: int = 3072, image_size: int = 768, patch: int = 32,
                      text_width: int = 512, text_layers: int = 12, text_mlp: int = 2048,
                      context_length: int = 16, vocab_size: int = 49408,
                      projection_dim: int = 512) -> Shapes:
    """transformers ``OwlViTForObjectDetection``'s state_dict, B/32 (published
    ``google/owlvit-base-patch32``) by default."""
    def encoder(prefix: str, width: int, layers: int, mlp: int) -> Shapes:
        out: Shapes = {}
        for i in range(layers):
            p = f"{prefix}encoder.layers.{i}"
            for h in ("k", "v", "q", "out"):
                out.update(_linear(f"{p}.self_attn.{h}_proj", width, width))
            out.update({**_norm(f"{p}.layer_norm1", width), **_linear(f"{p}.mlp.fc1", width, mlp),
                        **_linear(f"{p}.mlp.fc2", mlp, width),
                        **_norm(f"{p}.layer_norm2", width)})
        return out

    t, v, w = "owlvit.text_model.", "owlvit.vision_model.", vision_width
    shapes: Shapes = {"owlvit.logit_scale": (),
                      f"{t}embeddings.token_embedding.weight": (vocab_size, text_width),
                      f"{t}embeddings.position_embedding.weight": (context_length, text_width)}
    shapes.update(encoder(t, text_width, text_layers, text_mlp))
    shapes.update(_norm(f"{t}final_layer_norm", text_width))
    shapes.update({f"{v}embeddings.class_embedding": (w,),
                   f"{v}embeddings.patch_embedding.weight": (w, 3, patch, patch),
                   f"{v}embeddings.position_embedding.weight":
                       ((image_size // patch) ** 2 + 1, w),
                   **_norm(f"{v}pre_layernorm", w)})
    shapes.update(encoder(v, w, vision_layers, vision_mlp))
    shapes.update({**_norm(f"{v}post_layernorm", w),
                   "owlvit.visual_projection.weight": (projection_dim, w),
                   "owlvit.text_projection.weight": (projection_dim, text_width),
                   **_linear("class_head.dense0", w, text_width),
                   **_linear("class_head.logit_shift", w, 1),
                   **_linear("class_head.logit_scale", w, 1),
                   **_linear("box_head.dense0", w, w), **_linear("box_head.dense1", w, w),
                   **_linear("box_head.dense2", w, 4), **_norm("layer_norm", w)})
    return shapes


def sam_key_shapes(embed_dim: int = 1280, depth: int = 32, num_heads: int = 16,
                   global_attn_indexes: Sequence[int] = (7, 15, 23, 31),
                   img_size: int = 1024, patch: int = 16, window: int = 14,
                   out_chans: int = 256, decoder_depth: int = 2, mlp_dim: int = 2048,
                   num_masks: int = 4, iou_hidden: int = 256,
                   mask_in_chans: int = 16) -> Shapes:
    """A segment-anything checkpoint's state_dict (image encoder, prompt
    encoder, mask decoder), ViT-H (``sam_vit_h.pth``) by default."""
    g, d, hd = img_size // patch, embed_dim, embed_dim // num_heads
    e = "image_encoder."
    shapes: Shapes = {f"{e}pos_embed": (1, g, g, d),
                      f"{e}patch_embed.proj.weight": (d, 3, patch, patch),
                      f"{e}patch_embed.proj.bias": (d,)}
    for i in range(depth):
        b = f"{e}blocks.{i}"
        n = 2 * (g if i in global_attn_indexes else window) - 1
        shapes.update({**_norm(f"{b}.norm1", d), f"{b}.attn.rel_pos_h": (n, hd),
                       f"{b}.attn.rel_pos_w": (n, hd), **_linear(f"{b}.attn.qkv", d, 3 * d),
                       **_linear(f"{b}.attn.proj", d, d), **_norm(f"{b}.norm2", d),
                       **_linear(f"{b}.mlp.lin1", d, 4 * d),
                       **_linear(f"{b}.mlp.lin2", 4 * d, d)})
    c = out_chans
    shapes.update({f"{e}neck.0.weight": (c, d, 1, 1), **_norm(f"{e}neck.1", c),
                   f"{e}neck.2.weight": (c, c, 3, 3), **_norm(f"{e}neck.3", c)})
    pe, m = "prompt_encoder.", mask_in_chans
    shapes[f"{pe}pe_layer.positional_encoding_gaussian_matrix"] = (2, c // 2)
    for i in range(4):
        shapes[f"{pe}point_embeddings.{i}.weight"] = (1, c)
    shapes.update({f"{pe}not_a_point_embed.weight": (1, c),
                   f"{pe}mask_downscaling.0.weight": (m // 4, 1, 2, 2),
                   f"{pe}mask_downscaling.0.bias": (m // 4,),
                   **_norm(f"{pe}mask_downscaling.1", m // 4),
                   f"{pe}mask_downscaling.3.weight": (m, m // 4, 2, 2),
                   f"{pe}mask_downscaling.3.bias": (m,),
                   **_norm(f"{pe}mask_downscaling.4", m),
                   f"{pe}mask_downscaling.6.weight": (c, m, 1, 1),
                   f"{pe}mask_downscaling.6.bias": (c,),
                   f"{pe}no_mask_embed.weight": (1, c)})
    md = "mask_decoder."

    def attn(key: str, inner: int) -> Shapes:
        return {**_linear(f"{key}.q_proj", c, inner), **_linear(f"{key}.k_proj", c, inner),
                **_linear(f"{key}.v_proj", c, inner), **_linear(f"{key}.out_proj", inner, c)}

    for i in range(decoder_depth):
        p = f"{md}transformer.layers.{i}"
        shapes.update({**attn(f"{p}.self_attn", c), **_norm(f"{p}.norm1", c),
                       **attn(f"{p}.cross_attn_token_to_image", c // 2),
                       **_norm(f"{p}.norm2", c), **_linear(f"{p}.mlp.lin1", c, mlp_dim),
                       **_linear(f"{p}.mlp.lin2", mlp_dim, c), **_norm(f"{p}.norm3", c),
                       **_norm(f"{p}.norm4", c),
                       **attn(f"{p}.cross_attn_image_to_token", c // 2)})
    shapes.update({**attn(f"{md}transformer.final_attn_token_to_image", c // 2),
                   **_norm(f"{md}transformer.norm_final_attn", c),
                   f"{md}iou_token.weight": (1, c), f"{md}mask_tokens.weight": (num_masks, c),
                   f"{md}output_upscaling.0.weight": (c, c // 4, 2, 2),
                   f"{md}output_upscaling.0.bias": (c // 4,),
                   **_norm(f"{md}output_upscaling.1", c // 4),
                   f"{md}output_upscaling.3.weight": (c // 4, c // 8, 2, 2),
                   f"{md}output_upscaling.3.bias": (c // 8,)})
    for i in range(num_masks):
        p = f"{md}output_hypernetworks_mlps.{i}.layers"
        shapes.update({**_linear(f"{p}.0", c, c), **_linear(f"{p}.1", c, c),
                       **_linear(f"{p}.2", c, c // 8)})
    p = f"{md}iou_prediction_head.layers"
    shapes.update({**_linear(f"{p}.0", c, iou_hidden), **_linear(f"{p}.1", iou_hidden,
                                                                 iou_hidden),
                   **_linear(f"{p}.2", iou_hidden, num_masks)})
    return shapes
