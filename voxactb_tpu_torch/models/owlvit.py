"""OWL-ViT open-vocabulary detector.

Counterpart of ``voxactb_tpu.models.owlvit``: a CLIP-style ViT image tower
whose PATCH tokens (each merged with the CLS token multiplicatively) feed two
heads, a class head scoring each patch against text embeddings (scaled cosine
logits with a learned shift) and a box head (MLP -> cxcywh, biased toward each
token's grid cell). The text tower is the CLIP text transformer
(``models/clip_text.py``). Channels-last, parameters in f32 under the flax
names, cast to the compute ``dtype`` at use. ``load_hf_owlvit_weights`` maps a
transformers ``OwlViTForObjectDetection`` state_dict onto the flax trees of
both towers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from voxactb_tpu_torch.models.blocks import Conv2D, Dense, LayerNorm, gelu_erf, rounded, sigmoid
from voxactb_tpu_torch.models.clip_text import (
    ClipTextEncoder, attend, merge_heads, quick_gelu, split_heads)
from voxactb_tpu_torch.models.torch_port import make_port_helpers
from voxactb_tpu_torch.ops.cuda.graphs import weight
from voxactb_tpu_torch.ops.resize import resize_linear
from voxactb_tpu_torch.utils.profiling import count


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads = heads
        self.ln1 = LayerNorm(dim, dtype=dtype)
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, generator=generator)
        self.proj = Dense(dim, dim, dtype=dtype, generator=generator)
        self.ln2 = LayerNorm(dim, dtype=dtype)
        self.fc1 = Dense(dim, 4 * dim, dtype=dtype, generator=generator)
        self.fc2 = Dense(4 * dim, dim, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (split_heads(a, self.heads)
                   for a in self.qkv(self.ln1(x)).chunk(3, dim=-1))
        x = x + self.proj(merge_heads(attend(q * rounded(q.shape[-1] ** -0.5, q.dtype), k, v)))
        return x + self.fc2(quick_gelu(self.fc1(self.ln2(x))))


class OwlViTImageEncoder(nn.Module):
    """CLIP ViT tower returning per-patch feature tokens ``[B, g*g, dim]`` f32
    (CLS merged, OWL-style)."""

    def __init__(self, img_size: int = 768, patch: int = 32, dim: int = 768,
                 depth: int = 12, heads: int = 12, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.img_size, self.patch, self.dim, self.depth = img_size, patch, dim, depth
        self.dtype = dtype
        g = img_size // patch
        self.patch_embed = Conv2D(3, dim, patch, patch, use_bias=False, dtype=dtype,
                                  generator=generator)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, g * g + 1, dim))
        with torch.no_grad():
            self.cls_token.normal_(0.0, 0.02, generator=generator)
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        self.pre_ln = LayerNorm(dim, dtype=dtype)
        for i in range(depth):
            self.add_module(f"block_{i}", ViTBlock(dim, heads, dtype, generator))
        self.post_ln = LayerNorm(dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, 3]
        b = x.shape[0]
        tokens = self.patch_embed(x).reshape(b, -1, self.dim)
        cls = weight(self.cls_token, self.dtype).expand(b, 1, self.dim)
        tokens = self.pre_ln(torch.cat([cls, tokens], 1) + weight(self.pos_embed, self.dtype))
        for i in range(self.depth):
            tokens = getattr(self, f"block_{i}")(tokens)
        tokens = self.post_ln(tokens)
        # OWL-ViT merges the CLS token into the patch tokens multiplicatively
        return (tokens[:, 1:] * tokens[:, :1]).float()


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + rounded(1e-6, x.dtype))


class OwlViTDetector(nn.Module):
    """Image ``[B, H, W, 3]`` + text embeddings ``[Q, embed_dim]`` -> (logits
    ``[B, tokens, Q]``, boxes ``[B, tokens, 4]`` cxcywh in [0, 1]), both f32."""

    def __init__(self, embed_dim: int = 512,
                 image_encoder: Optional[OwlViTImageEncoder] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.image_encoder = image_encoder or OwlViTImageEncoder(dtype=dtype,
                                                                 generator=generator)
        d = self.image_encoder.dim
        self.merged_ln = LayerNorm(d, dtype=dtype)
        self.class_proj = Dense(d, embed_dim, dtype=dtype, generator=generator)
        self.logit_shift = Dense(d, 1, dtype=dtype, generator=generator)
        self.logit_scale_head = Dense(d, 1, dtype=dtype, generator=generator)
        # exact (erf) gelu between the box-head layers: transformers' nn.GELU()
        self.box_dense0 = Dense(d, d, dtype=dtype, generator=generator)
        self.box_dense1 = Dense(d, d, dtype=dtype, generator=generator)
        self.box_dense2 = Dense(d, 4, dtype=dtype, generator=generator)

    def box_head(self, x: torch.Tensor) -> torch.Tensor:
        x = gelu_erf(self.box_dense0(x))
        return self.box_dense2(gelu_erf(self.box_dense1(x)))

    @staticmethod
    def _box_bias(g: int, device=None) -> torch.Tensor:
        """``[g*g, 4]``: each token biased toward its own grid cell, with the
        cell-corner coordinates and epsilon'd logit of transformers'
        ``compute_box_bias``."""
        xs = torch.arange(1, g + 1, dtype=torch.float32, device=device) / g
        coords = torch.stack([xs[None, :].expand(g, g).reshape(-1),
                              xs[:, None].expand(g, g).reshape(-1)], -1).clamp(0.0, 1.0)
        coord_bias = torch.log(coords + 1e-4) - torch.log1p(-coords + 1e-4)
        size = torch.full_like(coords, 1.0 / g)
        size_bias = torch.log(size + 1e-4) - torch.log1p(-size + 1e-4)
        return torch.cat([coord_bias, size_bias], -1)

    def forward(self, image: torch.Tensor, text_embeds: torch.Tensor):
        feats = self.image_encoder(image)  # [B, T, D] f32
        g = int(np.sqrt(feats.shape[1]))
        feats_ln = self.merged_ln(feats.to(self.dtype))
        # class head: scaled cosine similarity with learned shift and scale
        q_emb = _l2_normalize(self.class_proj(feats_ln))
        txt = _l2_normalize(text_embeds).to(q_emb.dtype)
        sims = torch.einsum("btd,qd->btq", q_emb.float(), txt.float())
        scale = F.elu(self.logit_scale_head(feats_ln)) + 1.0
        logits = (sims + self.logit_shift(feats_ln)) * scale
        boxes = sigmoid(self.box_head(feats_ln) + self._box_bias(g, feats.device)[None])
        return logits.float(), boxes.float()


def load_hf_owlvit_weights(state_dict):
    """Map a transformers ``OwlViTForObjectDetection`` state_dict onto this stack.

    Returns ``(detector_params, text_params)``: the first loads
    :class:`OwlViTDetector` (vision tower + class/box heads), the second loads
    ``models.clip_text.ClipTextEncoder`` configured with the
    checkpoint's text dims (the OWL text tower is CLIP's, context length 16).
    """
    a, dense, ln, _, _ = make_port_helpers(state_dict)

    def vit_blocks(prefix, names):
        """Shared CLIP-style encoder-layer mapping (vision 'block_i'/text 'resblock_i')."""
        out = {}
        lp = prefix + "encoder.layers."
        depth = max(int(k[len(lp):].split(".")[0]) for k in state_dict
                    if k.startswith(lp)) + 1
        for i in range(depth):
            p = f"{prefix}encoder.layers.{i}."
            qkv_w = np.concatenate(
                [a(p + f"self_attn.{h}_proj.weight").T for h in ("q", "k", "v")],
                axis=1)
            qkv_b = np.concatenate(
                [a(p + f"self_attn.{h}_proj.bias") for h in ("q", "k", "v")])
            out[names["block"].format(i)] = {
                names["ln1"]: ln(p + "layer_norm1"),
                names["ln2"]: ln(p + "layer_norm2"),
                names["qkv"]: {"kernel": qkv_w, "bias": qkv_b},
                names["proj"]: dense(p + "self_attn.out_proj"),
                names["fc1"]: dense(p + "mlp.fc1"),
                names["fc2"]: dense(p + "mlp.fc2"),
            }
        return out

    v = "owlvit.vision_model."
    vision = {
        "patch_embed": {
            "kernel": a(v + "embeddings.patch_embedding.weight").transpose(
                2, 3, 1, 0)},
        "cls_token": a(v + "embeddings.class_embedding").reshape(1, 1, -1),
        "pos_embed": a(v + "embeddings.position_embedding.weight")[None],
        "pre_ln": ln(v + "pre_layernorm"),
        "post_ln": ln(v + "post_layernorm"),
    }
    vision.update(vit_blocks(v, {"block": "block_{}", "ln1": "ln1", "ln2": "ln2",
                                 "qkv": "qkv", "proj": "proj",
                                 "fc1": "fc1", "fc2": "fc2"}))

    det_params = {"params": {
        "image_encoder": vision,
        "merged_ln": ln("layer_norm"),
        "class_proj": dense("class_head.dense0"),
        "logit_shift": dense("class_head.logit_shift"),
        "logit_scale_head": dense("class_head.logit_scale"),
        "box_dense0": dense("box_head.dense0"),
        "box_dense1": dense("box_head.dense1"),
        "box_dense2": dense("box_head.dense2"),
    }}

    t = "owlvit.text_model."
    text = {
        "token_embedding": a(t + "embeddings.token_embedding.weight"),
        "positional_embedding": a(t + "embeddings.position_embedding.weight"),
        "ln_final": ln(t + "final_layer_norm"),
        "text_projection": a("owlvit.text_projection.weight").T,
    }
    text.update(vit_blocks(t, {"block": "resblock_{}", "ln1": "ln_1",
                               "ln2": "ln_2", "qkv": "attn_in",
                               "proj": "attn_out", "fc1": "mlp_fc",
                               "fc2": "mlp_proj"}))
    return det_params, {"params": text}


class OwlViTPipeline:
    """Text query -> best box (``get_bounding_box_using_owl_vit``); the box
    source of ``SamSegmenter``. The modules hold their weights and sit on the
    device the pipeline runs on."""

    def __init__(self, detector: OwlViTDetector, text_encoder: Optional[ClipTextEncoder] = None,
                 tokenizer=None, img_size: int = 768):
        self._det = detector
        self._text = text_encoder
        self._tokenizer = tokenizer
        self._img_size = img_size

    @property
    def device(self) -> torch.device:
        return next(self._det.parameters()).device

    def embed_queries(self, queries: Sequence[str]) -> torch.Tensor:
        """``[Q, embed_dim]`` f32 sentence embeddings of the queries."""
        if self._text is None:
            raise RuntimeError("no text tower supplied")
        if self._tokenizer is None:
            from voxactb_tpu_torch.utils.bpe import SimpleTokenizer

            self._tokenizer = SimpleTokenizer()
        # the text tower's own context (16 in OWL-ViT's checkpoints, 77 in CLIP's)
        ctx = self._text.positional_embedding.shape[0]
        tokens = torch.as_tensor(self._tokenizer.tokenize(list(queries), context_length=ctx),
                                 device=self.device)
        with torch.inference_mode():
            sent, _ = self._text(tokens)
        return sent

    def predict_frame(self, frame: torch.Tensor, text_embeds: torch.Tensor):
        """A frame ``[H, W, 3]`` (0-255, f32) and query embeddings ``[Q, E]``
        on the device -> (class logits ``[T, Q]``, boxes ``[T, 4]`` cxcywh in
        [0, 1]) of the frame's patches, f32; no copy from the host."""
        x = resize_linear(frame[None] / 255.0, (1, self._img_size, self._img_size, 3))
        with torch.inference_mode():
            logits, boxes = self._det(x, text_embeds)
        return logits[0], boxes[0]

    @staticmethod
    def choose(logits: torch.Tensor, boxes: torch.Tensor, frame_hw,
               score_threshold: float = 0.1):
        """``predict_frame``'s outputs -> (box_xyxy in the frame's pixels,
        score, patch) of the best query match; two copies to the host."""
        h, w = frame_hw
        probs = sigmoid(logits).cpu().numpy()  # [T, Q]
        count("vlm.d2h_copies")
        best = np.unravel_index(np.argmax(probs), probs.shape)
        score = float(probs[best])
        if score < score_threshold:
            raise ValueError(f"no detection above {score_threshold} "
                             f"(best {score:.3f})")
        cx, cy, bw, bh = boxes[best[0]].cpu().numpy()
        count("vlm.d2h_copies")
        box = np.array([(cx - bw / 2) * w, (cy - bh / 2) * h,
                        (cx + bw / 2) * w, (cy + bh / 2) * h])
        return np.clip(box, 0, [w, h, w, h]), score, int(best[0])

    def detect(self, rgb: np.ndarray, text_embeds, score_threshold: float = 0.1):
        """-> (box_xyxy in source pixels, score) for the best query match."""
        dev = self.device
        frame = torch.as_tensor(np.asarray(rgb), dtype=torch.float32, device=dev)
        box, score, _ = self.choose(
            *self.predict_frame(frame, torch.as_tensor(text_embeds, device=dev)),
            rgb.shape[:2], score_threshold)
        return box, score
