"""SAM prompt encoder (box prompts) + two-way-transformer mask decoder.

Counterpart of ``voxactb_tpu.models.sam_decoder``: random-Fourier positional
encoding for prompts, learned corner embeddings for boxes, the no-mask dense
embedding added to the image embedding, a depth-2 two-way transformer between
prompt tokens and image embedding, 4x upscaling, per-mask hypernetwork MLPs
and an IoU head. As there, the FIRST two-way block's self-attention replaces
the queries (no residual), the block LayerNorms use eps 1e-6 while the final
attention's keeps 1e-5, the upscaling LayerNorm uses 1e-6, and every GELU is
the exact erf form. Channels-last, parameters in f32 under the flax names
(auto-named submodules keep flax's ``Dense_i`` / ``LayerNorm_i``).
``load_torch_sam_decoder_weights`` (a segment-anything checkpoint's
``prompt_encoder.*`` / ``mask_decoder.*``) and ``load_hf_sam_decoder_weights``
(transformers' ``SamModel``) map upstream state_dicts onto the flax tree.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from voxactb_tpu_torch.models.blocks import (
    ConvTranspose2D, Dense, LayerNorm, gelu_erf, rounded, sigmoid)
from voxactb_tpu_torch.models.clip_text import attend, merge_heads, split_heads
from voxactb_tpu_torch.models.torch_port import make_port_helpers
from voxactb_tpu_torch.ops.cuda.graphs import weight
from voxactb_tpu_torch.ops.resize import resize_linear


class RandomFourierPE(nn.Module):
    """SAM's PositionEmbeddingRandom: coords in [0,1]^2 -> ``[2 * num_feats]``
    features, in f32."""

    def __init__(self, num_feats: int = 128, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gaussian_matrix = nn.Parameter(torch.empty(2, num_feats))
        with torch.no_grad():
            self.gaussian_matrix.normal_(0.0, 1.0, generator=generator)

    def forward(self, coords: torch.Tensor) -> torch.Tensor:  # [..., 2]
        proj = torch.matmul(2.0 * coords - 1.0, self.gaussian_matrix) * (2 * np.pi)
        return torch.cat([torch.sin(proj), torch.cos(proj)], -1)

    def grid(self, h: int, w: int) -> torch.Tensor:
        dev = self.gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        return self(torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)], -1))


class MLP(nn.Module):
    """SamFeedForward: relu MLP (``layers - 1`` hidden layers, then the output)."""

    def __init__(self, in_features: int, hidden: int, out: int, layers: int = 3,
                 sigmoid_out: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = layers
        self.sigmoid_out = sigmoid_out
        dims = [in_features] + [hidden] * (layers - 1) + [out]
        for i in range(layers):
            self.add_module(f"Dense_{i}", Dense(dims[i], dims[i + 1], dtype=dtype,
                                                generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers - 1):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        x = getattr(self, f"Dense_{self.layers - 1}")(x)
        return sigmoid(x) if self.sigmoid_out else x


class _Attn(nn.Module):
    def __init__(self, dim: int, heads: int, downsample: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads = heads
        inner = dim // downsample
        self.q = Dense(dim, inner, dtype=dtype, generator=generator)
        self.k = Dense(dim, inner, dtype=dtype, generator=generator)
        self.v = Dense(dim, inner, dtype=dtype, generator=generator)
        self.out = Dense(inner, dim, dtype=dtype, generator=generator)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        qh, kh, vh = (split_heads(proj(t), self.heads)
                      for proj, t in ((self.q, q), (self.k, k), (self.v, v)))
        return self.out(merge_heads(attend(qh * rounded(qh.shape[-1] ** -0.5, qh.dtype), kh, vh)))


class TwoWayBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int = 2048,
                 skip_first_pe: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.skip_first_pe = skip_first_pe
        self.self_attn = _Attn(dim, heads, dtype=dtype, generator=generator)
        self.cross_t2i = _Attn(dim, heads, 2, dtype=dtype, generator=generator)
        self.cross_i2t = _Attn(dim, heads, 2, dtype=dtype, generator=generator)
        for i in range(4):
            self.add_module(f"LayerNorm_{i}", LayerNorm(dim, eps=1e-6, dtype=dtype))
        self.Dense_0 = Dense(dim, mlp_dim, dtype=dtype, generator=generator)
        self.Dense_1 = Dense(mlp_dim, dim, dtype=dtype, generator=generator)

    def forward(self, tokens, image, token_pe, image_pe):
        # token self-attention; in the first block its output REPLACES the tokens
        if self.skip_first_pe:
            tokens = self.self_attn(tokens, tokens, tokens)
        else:
            q = tokens + token_pe
            tokens = tokens + self.self_attn(q, q, tokens)
        tokens = self.LayerNorm_0(tokens)
        # token -> image cross attention
        tokens = self.LayerNorm_1(
            tokens + self.cross_t2i(tokens + token_pe, image + image_pe, image))
        # relu MLP
        tokens = self.LayerNorm_2(tokens + self.Dense_1(F.relu(self.Dense_0(tokens))))
        # image -> token cross attention
        image = self.LayerNorm_3(
            image + self.cross_i2t(image + image_pe, tokens + token_pe, tokens))
        return tokens, image


class SamMaskDecoder(nn.Module):
    """Box prompt + image embedding ``[B, g, g, dim]`` -> (masks ``[B, M, 4g,
    4g]``, IoU predictions ``[B, M]``), both f32."""

    def __init__(self, dim: int = 256, heads: int = 8, depth: int = 2, num_masks: int = 4,
                 mlp_dim: int = 2048, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.depth, self.num_masks = dim, depth, num_masks
        self.dtype = dtype
        self.pe = RandomFourierPE(dim // 2, generator)
        self.corner_embed = nn.Parameter(torch.empty(2, dim))
        self.iou_token = nn.Parameter(torch.empty(1, dim))
        self.mask_tokens = nn.Parameter(torch.empty(num_masks, dim))
        self.no_mask_embed = nn.Parameter(torch.empty(1, dim))
        with torch.no_grad():
            for p in (self.corner_embed, self.iou_token, self.mask_tokens,
                      self.no_mask_embed):
                p.normal_(0.0, 1.0, generator=generator)
        for i in range(depth):
            self.add_module(f"block_{i}", TwoWayBlock(dim, heads, mlp_dim, i == 0, dtype,
                                                      generator))
        self.final_t2i = _Attn(dim, heads, 2, dtype=dtype, generator=generator)
        self.LayerNorm_0 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.up1 = ConvTranspose2D(dim, dim // 4, 2, 2, dtype=dtype, generator=generator)
        self.LayerNorm_1 = LayerNorm(dim // 4, eps=1e-6, dtype=dtype)
        self.up2 = ConvTranspose2D(dim // 4, dim // 8, 2, 2, dtype=dtype, generator=generator)
        for i in range(num_masks):
            self.add_module(f"hyper_{i}", MLP(dim, dim, dim // 8, dtype=dtype,
                                              generator=generator))
        self.iou_head = MLP(dim, dim, num_masks, dtype=dtype, generator=generator)

    def forward(self, image_embedding: torch.Tensor, boxes: torch.Tensor):
        """``boxes``: ``[B, 4]`` normalised (x0, y0, x1, y1) in [0, 1]."""
        b, g, _, c = image_embedding.shape
        dt = self.dtype
        # prompt tokens: two box corners with learned corner type embeddings
        prompt = self.pe(boxes.reshape(b, 2, 2)) + self.corner_embed[None]
        tokens = torch.cat([self.iou_token[None].expand(b, 1, self.dim),
                            self.mask_tokens[None].expand(b, self.num_masks, self.dim),
                            prompt], 1)
        # the no-mask dense prompt embedding is ADDED to the image embedding
        image = (image_embedding.to(dt) + weight(self.no_mask_embed[None, None], dt)).reshape(
            b, g * g, c)
        image_pe = self.pe.grid(g, g).reshape(1, g * g, self.dim).expand(
            b, g * g, self.dim).to(dt)
        token_pe = tokens.to(dt)
        x = tokens.to(dt)
        for i in range(self.depth):
            x, image = getattr(self, f"block_{i}")(x, image, token_pe, image_pe)
        x = self.LayerNorm_0(x + self.final_t2i(x + token_pe, image + image_pe, image))
        iou_out, mask_out = x[:, 0], x[:, 1:1 + self.num_masks]

        # upscale the image embedding 4x (two stride-2 transposed convs)
        img = image.reshape(b, g, g, c)
        img = gelu_erf(self.LayerNorm_1(self.up1(img)))
        img = gelu_erf(self.up2(img))  # [B, 4g, 4g, dim / 8]
        hyper = torch.stack([getattr(self, f"hyper_{i}")(mask_out[:, i])
                             for i in range(self.num_masks)], 1)  # [B, M, dim / 8]
        masks = torch.einsum("bmc,bhwc->bmhw", hyper.float(), img.float())
        return masks, self.iou_head(iou_out).float()


def load_hf_sam_decoder_weights(state_dict) -> dict:
    """Map a transformers ``SamModel`` prompt-encoder + mask-decoder state_dict onto
    ``SamMaskDecoder``.

    The HF model has TWO SamPositionalEmbedding instances (``shared_image_embedding``
    for the image grid and ``prompt_encoder.shared_embedding`` for prompts) that are
    equal in converted checkpoints; this module follows the original segment-anything
    design with ONE pe layer, loaded from the prompt encoder's copy.
    """

    a, dense, ln, sam_attn, conv_t = make_port_helpers(state_dict)

    def feed_forward(key, layers=3):
        out = {"Dense_0": dense(key + ".proj_in")}
        for i in range(layers - 2):
            out[f"Dense_{i + 1}"] = dense(f"{key}.layers.{i}")
        out[f"Dense_{layers - 1}"] = dense(key + ".proj_out")
        return out

    md = "mask_decoder."
    params = {
        "pe": {"gaussian_matrix":
               a("prompt_encoder.shared_embedding.positional_embedding")},
        "corner_embed": np.concatenate(
            [a("prompt_encoder.point_embed.2.weight"),
             a("prompt_encoder.point_embed.3.weight")], axis=0),
        "no_mask_embed": a("prompt_encoder.no_mask_embed.weight"),
        "iou_token": a(md + "iou_token.weight"),
        "mask_tokens": a(md + "mask_tokens.weight"),
        "up1": conv_t(md + "upscale_conv1"),
        "up2": conv_t(md + "upscale_conv2"),
        "LayerNorm_1": ln(md + "upscale_layer_norm"),
        "final_t2i": sam_attn(md + "transformer.final_attn_token_to_image"),
        "LayerNorm_0": ln(md + "transformer.layer_norm_final_attn"),
        "iou_head": feed_forward(md + "iou_prediction_head"),
    }
    lp = md + "transformer.layers."
    depth = max(int(k[len(lp):].split(".")[0]) for k in state_dict
                if k.startswith(lp)) + 1
    for i in range(depth):
        p = f"{md}transformer.layers.{i}."
        params[f"block_{i}"] = {
            "self_attn": sam_attn(p + "self_attn"),
            "cross_t2i": sam_attn(p + "cross_attn_token_to_image"),
            "cross_i2t": sam_attn(p + "cross_attn_image_to_token"),
            "LayerNorm_0": ln(p + "layer_norm1"),
            "LayerNorm_1": ln(p + "layer_norm2"),
            "LayerNorm_2": ln(p + "layer_norm3"),
            "LayerNorm_3": ln(p + "layer_norm4"),
            "Dense_0": dense(p + "mlp.lin1"),
            "Dense_1": dense(p + "mlp.lin2"),
        }
    n_masks = a(md + "mask_tokens.weight").shape[0]
    for i in range(n_masks):
        params[f"hyper_{i}"] = feed_forward(
            f"{md}output_hypernetworks_mlps.{i}")
    return {"params": params}


def load_torch_sam_decoder_weights(state_dict) -> dict:
    """Map a facebook segment-anything checkpoint's prompt-encoder + mask-decoder
    (``prompt_encoder.*`` / ``mask_decoder.*`` keys, original naming: norm1..4,
    mlp.lin1/lin2, output_upscaling.0/1/3, MLP ``layers.N``) onto
    ``SamMaskDecoder`` — the companion of ``load_torch_sam_weights`` so a
    single sam_vit_*.pth loads the whole segmentation path."""

    a, dense, ln, sam_attn, conv_t = make_port_helpers(state_dict)

    def mlp3(key):  # facebook SamFeedForward equivalent: MLP with layers.0..2
        return {f"Dense_{i}": dense(f"{key}.layers.{i}") for i in range(3)}

    md = "mask_decoder."
    params = {
        "pe": {"gaussian_matrix":
               a("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix")},
        "corner_embed": np.concatenate(
            [a("prompt_encoder.point_embeddings.2.weight"),
             a("prompt_encoder.point_embeddings.3.weight")], axis=0),
        "no_mask_embed": a("prompt_encoder.no_mask_embed.weight"),
        "iou_token": a(md + "iou_token.weight"),
        "mask_tokens": a(md + "mask_tokens.weight"),
        "up1": conv_t(md + "output_upscaling.0"),
        "up2": conv_t(md + "output_upscaling.3"),
        "LayerNorm_1": ln(md + "output_upscaling.1"),
        "final_t2i": sam_attn(md + "transformer.final_attn_token_to_image"),
        "LayerNorm_0": ln(md + "transformer.norm_final_attn"),
        "iou_head": mlp3(md + "iou_prediction_head"),
    }
    lp = md + "transformer.layers."
    depth = max(int(k[len(lp):].split(".")[0]) for k in state_dict
                if k.startswith(lp)) + 1
    for i in range(depth):
        p = f"{lp}{i}."
        params[f"block_{i}"] = {
            "self_attn": sam_attn(p + "self_attn"),
            "cross_t2i": sam_attn(p + "cross_attn_token_to_image"),
            "cross_i2t": sam_attn(p + "cross_attn_image_to_token"),
            "LayerNorm_0": ln(p + "norm1"),
            "LayerNorm_1": ln(p + "norm2"),
            "LayerNorm_2": ln(p + "norm3"),
            "LayerNorm_3": ln(p + "norm4"),
            "Dense_0": dense(p + "mlp.lin1"),
            "Dense_1": dense(p + "mlp.lin2"),
        }
    n_masks = a(md + "mask_tokens.weight").shape[0]
    for i in range(n_masks):
        params[f"hyper_{i}"] = mlp3(f"{md}output_hypernetworks_mlps.{i}")
    return {"params": params}


class SamSegmenter:
    """Box-prompted segmentation: encoder + decoder + mask selection. The
    modules hold their weights and sit on the device the segmenter runs on."""

    def __init__(self, encoder: nn.Module, decoder: Optional[SamMaskDecoder] = None,
                 img_size: int = 1024):
        self.encoder = encoder
        self.decoder = decoder or SamMaskDecoder()
        self._img_size = img_size

    @property
    def device(self) -> torch.device:
        return next(self.encoder.parameters()).device

    def embed(self, rgb: np.ndarray) -> torch.Tensor:
        """The frame's image embedding ``[1, g, g, 256]``, f32 on the device."""
        frame = torch.as_tensor(np.asarray(rgb), dtype=torch.float32, device=self.device)
        return self.embed_frame(frame)

    def embed_frame(self, frame: torch.Tensor) -> torch.Tensor:
        """``embed`` of a frame ``[H, W, 3]`` (0-255, f32) on the device."""
        from voxactb_tpu_torch.models.sam_encoder import normalize_frame

        with torch.inference_mode():
            return self.encoder(normalize_frame(frame, self._img_size))

    def box_array(self, box_xyxy, frame_hw) -> np.ndarray:
        """A box in the frame's pixels -> the decoder's ``[1, 4]`` normalised
        box over the padded square (f32, on the host)."""
        scale = self._img_size / max(frame_hw)
        # +0.5 shifts the corner to the pixel center (SamPromptEncoder._embed_boxes)
        return ((np.asarray(box_xyxy, np.float32) * scale + 0.5) / self._img_size)[None]

    def decode(self, embedding: torch.Tensor, box: torch.Tensor):
        """-> (mask logits ``[1, M, 4g, 4g]`` over the padded square, IoU
        predictions ``[1, M]``), f32 on the device; ``box`` as ``box_array``'s."""
        with torch.inference_mode():
            return self.decoder(embedding, box)

    def predict(self, rgb: np.ndarray, box_xyxy):
        """-> (image embedding ``[1, g, g, 256]``, mask logits ``[1, M, 4g, 4g]``
        over the padded square, IoU predictions ``[1, M]``), f32 on the device."""
        box = torch.as_tensor(self.box_array(box_xyxy, rgb.shape[:2]), device=self.device)
        emb = self.embed(rgb)
        masks, iou = self.decode(emb, box)
        return emb, masks, iou

    def mask_logits(self, masks: torch.Tensor, frame_hw, index) -> torch.Tensor:
        """Mask ``index`` (an int, or a one-element long tensor on the device,
        read there without a copy to the host) of ``predict``'s logits with
        the padding cropped away, resized to the ``(H, W)`` frame: ``[H, W]``
        f32."""
        h, w = frame_hw
        scale = self._img_size / max(h, w)
        if isinstance(index, torch.Tensor):
            m = torch.index_select(masks[0], 0, index.reshape(1))[0]
        else:
            m = masks[0, index]
        mg = m.shape[0]
        ch = max(1, int(round(h * scale / self._img_size * mg)))
        cw = max(1, int(round(w * scale / self._img_size * mg)))
        return resize_linear(m[:ch, :cw], (h, w))

    def segment_box(self, rgb: np.ndarray, box_xyxy) -> np.ndarray:
        """-> boolean ``[H, W]`` mask of the best-scoring (IoU head) output."""
        _, masks, iou = self.predict(rgb, box_xyxy)
        best = int(np.argmax(iou[0].cpu().numpy()))
        return (self.mask_logits(masks, rgb.shape[:2], best) > 0).cpu().numpy()
