"""The plain reference of Segment Anything's box-prompted mask (Kirillov et
al., arXiv 2304.02643; ``sam_vit_h_4b8939``), float32, and of VoxAct-B's
crop geometry on the chosen mask (arXiv 2407.04152, ``vlm.py``).

- Image encoder (ViTDet): a 16 x 16 patch embedding with a learned absolute
  position, pre-LN blocks that attend in windows of 14 x 14 over the token
  grid zero-padded to a multiple of 14, except the global blocks, which
  attend over the whole grid; every attention adds the decomposed
  relative-position bias ``q . R_h[i_h - j_h]`` and ``q . R_w[i_w - j_w]``
  of the unscaled q; a GELU MLP; then the neck (a 1 x 1 and a 3 x 3
  convolution without bias, each followed by a LayerNorm over channels).
- Prompt encoder and mask decoder: the box's two corners as random-Fourier
  features plus learned corner embeddings, the no-mask embedding added to
  the image embedding, a two-way transformer of depth 2 (its first block's
  token self-attention replaces the tokens), a final token-to-image
  attention, the image embedding upscaled 4x by two transposed
  convolutions, one hypernetwork MLP per mask token and an IoU head.
- The crop: the masked points voxel-downsampled at 1 cm, their centroid,
  the open_jar fallback and the +5 cm radius, in numpy (a copy of the
  port's ``crop_point_from_mask``, kept here so the reference imports
  nothing of the port).

Written from the paper and ``segment-anything`` as functions of the
parameter dictionary of ``reference/vlm_params.py``. Departures from the
published code, each as the port has it: the frame is resized by
half-pixel bilinear interpolation (an upsample from 640 x 480, where the
port's antialiased resize and ``F.interpolate`` agree); the chosen mask is
the one of highest predicted IoU among all mask tokens; the chosen mask's
logits are resized to the frame the same way. ``precision`` as
``reference/qnet.py``'s.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.owlvit import heads, layer_norm, linear, merge
from portbench.reference.qnet import float32_only, rounding

F32 = torch.float32
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


# -- image encoder ------------------------------------------------------------------


def preprocess(rgb: torch.Tensor, size: int) -> torch.Tensor:
    """uint8-valued ``[H, W, 3]`` -> ``[1, 3, size, size]``: the longest side
    resized to ``size``, normalised, zero-padded at the bottom and right."""
    h, w = rgb.shape[:2]
    scale = size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = F.interpolate(rgb.to(F32).permute(2, 0, 1)[None], size=(nh, nw), mode="bilinear",
                      align_corners=False)
    mean = torch.tensor(PIXEL_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(PIXEL_STD, device=x.device)[None, :, None, None]
    return F.pad((x - mean) / std, (0, size - nw, 0, size - nh))


def rel_table(table: torch.Tensor, n: int) -> torch.Tensor:
    """``[2n - 1, hd]`` -> ``[n, n, hd]``, entry (i, j) at offset i - j."""
    idx = torch.arange(n, device=table.device)
    return table[idx[:, None] - idx[None, :] + (n - 1)]


def rel_attention(p, b, x, n_heads, r):
    """Attention over a ``[B, h, w, C]`` grid with the decomposed rel-pos
    bias (``b``: the block's prefix)."""
    bsz, h, w, c = x.shape
    hd = c // n_heads
    qkv = linear(p, b + "attn.qkv", x.reshape(bsz, h * w, c), r)
    q, k, v = (heads(t, n_heads) for t in qkv.chunk(3, -1))  # [B, H, T, hd]
    rq = q.reshape(bsz, n_heads, h, w, hd)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", r.a(rq), r.a(rel_table(p[b + "attn.rel_pos_h"], h)))
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r.a(rq), r.a(rel_table(p[b + "attn.rel_pos_w"], w)))
    logits = torch.matmul(r.a(q * hd ** -0.5), r.a(k).transpose(-1, -2))
    logits = (logits.reshape(bsz, n_heads, h, w, h, w) + rel_h[..., :, None]
              + rel_w[..., None, :]).reshape(bsz, n_heads, h * w, h * w)
    out = torch.matmul(r.a(torch.softmax(logits, -1)), r.a(v))
    return linear(p, b + "attn.proj", merge(out), r).reshape(bsz, h, w, c)


def block(p, b, x, spec, window: int, r):
    y = layer_norm(p, b + "norm1", x, 1e-6)
    if window:
        _, h, w, c = y.shape
        ph, pw = -h % window, -w % window
        y = F.pad(y, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        y = y.reshape(1, hp // window, window, wp // window, window, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)
        y = rel_attention(p, b, y, spec["num_heads"], r)
        y = y.reshape(1, hp // window, wp // window, window, window, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(1, hp, wp, c)[:, :h, :w]
    else:
        y = rel_attention(p, b, y, spec["num_heads"], r)
    x = x + y
    y = F.gelu(linear(p, b + "mlp_fc1", layer_norm(p, b + "norm2", x, 1e-6), r))
    return x + linear(p, b + "mlp_fc2", y, r)


@float32_only()
def encode(params: Dict[str, torch.Tensor], spec: dict, rgb: torch.Tensor,
           precision: str = "exact", global_windowed: bool = False,
           rel_pos: bool = True) -> torch.Tensor:
    """One frame ``[H, W, 3]`` -> the image embedding ``[1, g, g, out]``.
    ``params``: the ``sam.`` tower. ``global_windowed`` and ``rel_pos``
    False are planted faults (tests): the global blocks attend in windows;
    the rel-pos bias is left out."""
    r = rounding(precision)
    p = dict(params)
    if not rel_pos:
        p.update({k: torch.zeros_like(v) for k, v in p.items() if ".rel_pos_" in k})
    x = preprocess(rgb, spec["img_size"])
    x = F.conv2d(r.a(x), r.a(p["patch_embed.weight"]), p["patch_embed.bias"],
                 stride=spec["patch_size"]).permute(0, 2, 3, 1) + p["pos_embed"]
    for i in range(spec["depth"]):
        glob = i in spec["global_attn_indexes"]
        window = spec["window_size"] if (not glob or global_windowed) else 0
        if glob and global_windowed:  # the window's own table: the global one's middle
            for axis in ("h", "w"):
                t = p[f"block_{i}.attn.rel_pos_{axis}"]
                mid = t.shape[0] // 2
                p[f"block_{i}.attn.rel_pos_{axis}"] = t[mid - window + 1:mid + window]
        x = block(p, f"block_{i}.", x, spec, window, r)
    x = F.conv2d(r.a(x.permute(0, 3, 1, 2)), r.a(p["neck_conv1.weight"]))
    x = layer_norm(p, "neck_ln1", x.permute(0, 2, 3, 1), 1e-6)
    x = F.conv2d(r.a(x.permute(0, 3, 1, 2)), r.a(p["neck_conv2.weight"]), padding=1)
    return layer_norm(p, "neck_ln2", x.permute(0, 2, 3, 1), 1e-6)


# -- prompt encoder and mask decoder --------------------------------------------------


def fourier(p, coords, r):
    """``[..., 2]`` in [0, 1] -> ``[..., dim]`` random-Fourier features."""
    proj = torch.matmul(r.a(2.0 * coords - 1.0), r.a(p["pe.gaussian_matrix"])) * (2 * math.pi)
    return torch.cat([torch.sin(proj), torch.cos(proj)], -1)


def attn(p, name, q, k, v, n_heads, r):
    qh, kh, vh = (heads(linear(p, f"{name}.{s}", t, r), n_heads)
                  for s, t in (("q", q), ("k", k), ("v", v)))
    logits = torch.matmul(r.a(qh * qh.shape[-1] ** -0.5), r.a(kh).transpose(-1, -2))
    out = torch.matmul(r.a(torch.softmax(logits, -1)), r.a(vh))
    return linear(p, name + ".out", merge(out), r)


def mlp(p, name, x, r, layers=3):
    for i in range(layers - 1):
        x = F.relu(linear(p, f"{name}.Dense_{i}", x, r))
    return linear(p, f"{name}.Dense_{layers - 1}", x, r)


def conv_t(p, name, x, r):
    """Channels-last 2 x 2, stride-2 transposed convolution."""
    y = F.conv_transpose2d(r.a(x.permute(0, 3, 1, 2)), r.a(p[name + ".weight"]),
                           p[name + ".bias"], stride=2)
    return y.permute(0, 2, 3, 1)


@float32_only()
def decode(params: Dict[str, torch.Tensor], spec: dict, embedding: torch.Tensor,
           box: torch.Tensor, precision: str = "exact") -> Tuple[torch.Tensor, torch.Tensor]:
    """Image embedding ``[1, g, g, dim]`` and a box ``[1, 4]`` (x0, y0, x1,
    y1 over the padded square, in [0, 1]) -> (mask logits ``[1, M, 4g,
    4g]``, IoU predictions ``[1, M]``). ``params``: the ``decoder.`` tower."""
    r = rounding(precision)
    p = params
    _, g, _, dim = embedding.shape
    m, nh = spec["num_masks"], spec["heads"]
    prompt = fourier(p, box.reshape(1, 2, 2), r) + p["corner_embed"][None]
    tokens = torch.cat([p["iou_token"][None], p["mask_tokens"][None], prompt], 1)
    image = (embedding + p["no_mask_embed"][None, None]).reshape(1, g * g, dim)
    c = (torch.arange(g, dtype=F32, device=embedding.device) + 0.5) / g
    image_pe = fourier(p, torch.stack([c[None, :].expand(g, g), c[:, None].expand(g, g)],
                                      -1), r).reshape(1, g * g, dim)
    x = tokens
    for i in range(spec["depth"]):
        b = f"block_{i}."
        if i == 0:  # the first block's self-attention replaces the tokens
            x = attn(p, b + "self_attn", x, x, x, nh, r)
        else:
            q = x + tokens
            x = x + attn(p, b + "self_attn", q, q, x, nh, r)
        x = layer_norm(p, b + "LayerNorm_0", x, 1e-6)
        x = layer_norm(p, b + "LayerNorm_1", x + attn(p, b + "cross_t2i", x + tokens,
                                                        image + image_pe, image, nh, r), 1e-6)
        y = linear(p, b + "Dense_1", F.relu(linear(p, b + "Dense_0", x, r)), r)
        x = layer_norm(p, b + "LayerNorm_2", x + y, 1e-6)
        image = layer_norm(p, b + "LayerNorm_3", image + attn(
            p, b + "cross_i2t", image + image_pe, x + tokens, x, nh, r), 1e-6)
    x = layer_norm(p, "LayerNorm_0", x + attn(p, "final_t2i", x + tokens, image + image_pe,
                                               image, nh, r), 1e-5)
    img = image.reshape(1, g, g, dim)
    img = F.gelu(layer_norm(p, "LayerNorm_1", conv_t(p, "up1", img, r), 1e-6))
    img = F.gelu(conv_t(p, "up2", img, r))  # [1, 4g, 4g, dim / 8]
    hyper = torch.stack([mlp(p, f"hyper_{i}", x[:, 1 + i], r) for i in range(m)], 1)
    masks = torch.einsum("bmc,bhwc->bmhw", r.a(hyper), r.a(img))
    return masks, mlp(p, "iou_head", x[:, 0], r)


def box_prompt(box_xyxy: np.ndarray, frame_hw, img_size: int) -> np.ndarray:
    """A box in the frame's pixels -> ``[1, 4]`` over the padded square, the
    corners shifted to pixel centres."""
    scale = img_size / max(frame_hw)
    return ((np.asarray(box_xyxy, np.float32) * scale + 0.5) / img_size)[None]


def frame_logits(masks: torch.Tensor, index: int, frame_hw, img_size: int) -> torch.Tensor:
    """Mask ``index``'s logits over the frame ``[H, W]``: the padding cropped
    away, resized."""
    h, w = frame_hw
    m = masks[0, index]
    scale = img_size / max(h, w)
    ch = max(1, int(round(h * scale / img_size * m.shape[0])))
    cw = max(1, int(round(w * scale / img_size * m.shape[1])))
    return F.interpolate(m[None, None, :ch, :cw], size=(h, w), mode="bilinear",
                         align_corners=False)[0, 0]


# -- the crop ---------------------------------------------------------------------------

JAR_FALLBACK_POINT = np.array([0.27462014, -0.00487481, 0.81258505], np.float32)


def voxel_downsample(points: np.ndarray, voxel: float, sums=np.float64) -> np.ndarray:
    keys = np.floor(points / voxel).astype(np.int64)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    total = np.zeros((len(counts), 3), sums)
    np.add.at(total, inverse.reshape(-1), points)
    return (total / counts[:, None]).astype(np.float32)


def chosen_pixels(logits: np.ndarray) -> np.ndarray:
    """The mask's pixels (logit > 0); where none is, those at its largest
    logit."""
    mask = logits > 0
    return mask if mask.any() else logits >= logits.max()


def crop(mask: np.ndarray, cloud: np.ndarray, task: str, c: dict,
         precision: str = "exact") -> Tuple[np.ndarray, float]:
    """Boolean ``[H, W]`` + cloud ``[H, W, 3]`` -> (crop point, radius) as
    ``vlm.py`` derives them; ``c``: the configuration's ``crop`` group.
    ``precision``: ``"exact"``, float32 points and float64 voxel sums, as
    the configuration states; ``"fp16"`` (the control), the points rounded to
    float16 and the sums in float32, the nearest precisions below those."""
    pts = cloud[mask].reshape(-1, 3)
    pts = pts[np.isfinite(pts).all(-1)]
    if len(pts) == 0:
        raise ValueError("empty object mask")
    sums = np.float64
    if precision == "fp16":
        pts, sums = pts.astype(np.float16).astype(np.float32), np.float32
    pts = voxel_downsample(pts, c["downsample_voxel"], sums)
    center = pts.mean(0)
    extents = pts.max(0) - pts.min(0)
    if task == "open_jar" and extents[:2].max() > c["jar_max_dim"]:
        center = np.asarray(c["jar_fallback"], np.float32)
    return center.astype(np.float32), float(extents.max() + c["radius_padding"])
