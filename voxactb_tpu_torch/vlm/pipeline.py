"""Object localization -> voxel-grid recentering (the VoxAct-B "VLM" subsystem).

Counterpart of ``voxactb_tpu.vlm.pipeline``: OWL-ViT proposes a box for a
task-specific text query, SAM segments it, the mask selects front-camera
points whose voxel-downsampled centroid becomes the crop point, and the crop
radius is auto-derived from the object's extent plus 5cm padding.

- ``crop_point_from_mask``: the geometry half (mask + cloud -> centroid +
  radius) on the host, copied from the JAX package; ``crop_stats_on_device``
  + ``crop_from_stats`` compute the same from a mask's logits where they
  lie, with one copy to the host;
- ``Detector`` protocol: anything producing a boolean object mask from an RGB
  frame: ``TorchOwlVitSamDetector`` (the port's OWL-ViT + SAM towers on the
  card), ``ColorDetector``, ``MaskLocalizer`` / ``GroundTruthLocalizer``;
- ``VLM``: the user-facing class with the reference's entry point
  ``get_target_object_world_coords``. With a detector that keeps its mask's
  logits on the device (``mask_logits``) the geometry runs there too.

``TorchOwlVitSamDetector.build`` makes the towers at given widths, compute
dtype and K7 flags, from a flat ``name -> tensor`` dict or a generator;
``from_pretrained`` builds through it from local checkpoints
(``utils/pretrained``). The transformers-based ``OwlVitSamDetector`` is not
ported: the card has no transformers.

Spans and counters (``utils/profiling``): ``vx.vlm`` per pass, inside it
``vx.vlm.owl`` (detection and its copies), ``vx.vlm.sam.encode``
(preprocess, image encoder), ``vx.vlm.sam.decode`` (prompt, mask decoder,
the IoU choice), ``vx.vlm.crop`` (the geometry, enqueued) and
``vx.vlm.d2h`` (its one copy); counters ``vlm.d2h_copies`` (each blocking
copy to the host) and ``vlm.mask_pixels`` (the chosen mask's area).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Protocol, Tuple

import numpy as np
import torch

from voxactb_tpu_torch.ops.cuda import graphs
from voxactb_tpu_torch.utils.profiling import count, span

# per-task text queries (vlm.py:146-151)
TASK_QUERIES: Dict[str, str] = {
    "open_jar": "jar",
    "open_drawer": "drawer handle",
    "put_item_in_drawer": "drawer handle",
    "hand_over_item": "item",
}

# failed-jar-detection fallback: the reference's fixed workspace-center crop
# point (vlm.py:177-180), applied only when the detection is implausibly large
JAR_FALLBACK_POINT = np.array([0.27462014, -0.00487481, 0.81258505], np.float32)
JAR_MAX_PLAUSIBLE_DIM = 0.15  # vlm.py:177's bbox>0.15 guard, in meters
AUTO_RADIUS_PADDING = 0.05  # +5cm (vlm.py:182-192)


def task_queries(task_name: str, default: str = "object") -> str:
    return TASK_QUERIES.get(task_name, default)


def voxel_downsample(points: np.ndarray, voxel: float = 0.01) -> np.ndarray:
    """Open3D-style voxel downsample (one mean point per occupied voxel) in numpy.

    Replaces the reference's open3d dependency (vlm.py:160-168).
    """
    if len(points) == 0:
        return points
    keys = np.floor(points / voxel).astype(np.int64)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True,
                                   return_counts=True)
    sums = np.zeros((len(counts), 3), np.float64)
    np.add.at(sums, inverse, points)
    return (sums / counts[:, None]).astype(np.float32)


def crop_point_from_mask(
    mask: np.ndarray,
    point_cloud: np.ndarray,
    task_name: str = "",
    downsample_voxel: float = 0.01,
) -> Tuple[np.ndarray, float]:
    """Boolean mask [H,W] + cloud [H,W,3] -> (crop point [3], auto crop radius).

    Mirrors vlm.py:152-194: masked points are voxel-downsampled, the centroid is
    the crop point (OpenJar falls back to the fixed workspace-center point when
    the detection is implausibly large), and the auto radius is the largest
    axis extent of the object plus 5cm padding (vlm.py:182-192).
    """
    pts = point_cloud[mask.astype(bool)].reshape(-1, 3)
    pts = pts[np.isfinite(pts).all(-1)]
    if len(pts) == 0:
        raise ValueError("empty object mask — detector found nothing")
    pts = voxel_downsample(pts, downsample_voxel)
    return _crop(pts.mean(0), pts.max(0) - pts.min(0), task_name)


def _crop(center: np.ndarray, extents: np.ndarray, task_name: str) -> Tuple[np.ndarray, float]:
    """The crop point and radius from the downsampled object's centroid and
    extents (f32)."""
    if task_name == "open_jar" and extents[:2].max() > JAR_MAX_PLAUSIBLE_DIM:
        # detector latched onto something jar-sized-ly implausible: fall back
        # to the fixed workspace-center crop point, exactly like the
        # reference's bbox>0.15 guard (vlm.py:177-180) — a GOOD detection
        # keeps its measured centroid, z included
        center = JAR_FALLBACK_POINT.copy()

    radius = float(extents.max() + AUTO_RADIUS_PADDING)
    return center.astype(np.float32), radius


def chosen_mask(logits: torch.Tensor) -> torch.Tensor:
    """A mask's logits -> its pixels (logit > 0); where none is positive,
    the pixels at its largest logit, the best guess (as ``ColorDetector``
    keeps the closest colour), with no copy to the host."""
    mask = logits > 0
    return torch.where(mask.any(), mask, logits >= logits.max())


def crop_stats_on_device(logits: torch.Tensor, cloud: torch.Tensor,
                         downsample_voxel: float = 0.01) -> torch.Tensor:
    """``crop_point_from_mask``'s work on the device, without a copy to the
    host: the chosen mask (``chosen_mask``) of ``logits`` ``[H, W]`` over
    ``cloud`` ``[H, W, 3]`` f32 -> ``[8]`` f32: the downsampled object's
    centroid (3) and extents (3), the mask's area and its finite points'
    count. As ``voxel_downsample``: keys ``floor(p / voxel)`` in f32, each
    occupied voxel's mean summed in float64 in the points' order (stable
    sorts by key), cast to f32; the centroid is their mean."""
    f32, f64 = torch.float32, torch.float64
    mask = chosen_mask(logits).reshape(-1)
    pts = cloud.reshape(-1, 3).to(f32)
    valid = mask & torch.isfinite(pts).all(-1)
    # constants filled on the device: a copy from pageable memory would wait for the stream
    voxel = torch.full((), downsample_voxel, dtype=f32, device=pts.device)
    zero = torch.zeros((), dtype=f32, device=pts.device)
    keys = torch.floor(torch.where(valid[:, None], pts, zero) / voxel).to(torch.int64)
    # lexicographic (invalid last, x, y, z), stable: each voxel's points keep their order
    order = torch.arange(len(pts), device=pts.device)
    for col in (keys[:, 2], keys[:, 1], keys[:, 0], (~valid).to(torch.int64)):
        order = order[torch.argsort(col[order], stable=True)]
    k, v = keys[order], valid[order]
    new = torch.ones_like(v)
    new[1:] = (k[1:] != k[:-1]).any(-1)
    starts = new & v
    group = torch.cumsum(starts.to(torch.int64), 0) - 1
    group = group.clamp(min=0)
    p = torch.where(v[:, None], pts[order], zero).to(f64)
    sums = torch.zeros((len(pts), 3), dtype=f64, device=pts.device).index_add_(0, group, p)
    counts = torch.zeros(len(pts), dtype=f64, device=pts.device).index_add_(0, group, v.to(f64))
    occupied = counts > 0
    means = (sums / counts.clamp(min=1.0)[:, None]).to(f32)
    n = occupied.sum()
    center = (torch.where(occupied[:, None], means, zero).to(f64).sum(0)
              / n.clamp(min=1).to(f64)).to(f32)
    inf = torch.full((), float("inf"), dtype=f32, device=pts.device)
    hi = torch.where(occupied[:, None], means, -inf).amax(0)
    lo = torch.where(occupied[:, None], means, inf).amin(0)
    return torch.cat([center, hi - lo, mask.sum().to(f32)[None], valid.sum().to(f32)[None]])


def crop_from_stats(stats: np.ndarray, task_name: str = "") -> Tuple[np.ndarray, float]:
    """``crop_stats_on_device``'s ``[8]`` on the host -> (crop point [3],
    radius), as ``crop_point_from_mask`` gives them; raises on a mask with
    no finite point."""
    stats = np.asarray(stats, np.float32)
    if stats[7] == 0:
        raise ValueError("empty object mask — detector found nothing")
    return _crop(stats[:3].copy(), stats[3:6].copy(), task_name)


class Detector(Protocol):
    def __call__(self, rgb: np.ndarray, query: str) -> np.ndarray:
        """RGB [H,W,3] uint8 + text query -> boolean mask [H,W]."""


def build_towers(spec: Dict[str, dict], *, dtype: torch.dtype = torch.float32,
                 fused_global: bool = False, fused_windowed: bool = False, device=None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None) -> Dict[str, torch.nn.Module]:
    """The detector's four towers at ``spec``'s widths, in eval mode:
    ``owl`` (``OwlViTDetector``: ``spec["owl"]`` is ``OwlViTImageEncoder``'s
    arguments and ``embed_dim``), ``owl_text`` (``ClipTextEncoder``), ``sam``
    (``SamImageEncoder``) and ``decoder`` (``SamMaskDecoder``), each group
    its constructor's arguments; ``dtype`` the compute dtype, the K7 flags
    as ``SamImageEncoder``'s. Weights from ``params`` (``"<tower>.<name>"``
    -> tensor, the towers' ``state_dict`` names; the modules take the
    tensors themselves, no copy) or else drawn from ``generator`` at each
    module's initialisation on ``device``."""
    from voxactb_tpu_torch.device import resolve_device
    from voxactb_tpu_torch.models.clip_text import ClipTextEncoder
    from voxactb_tpu_torch.models.owlvit import OwlViTDetector, OwlViTImageEncoder
    from voxactb_tpu_torch.models.sam_decoder import SamMaskDecoder
    from voxactb_tpu_torch.models.sam_encoder import SamImageEncoder

    def make(g):
        owl = dict(spec["owl"])
        embed = owl.pop("embed_dim")
        return {"owl": OwlViTDetector(embed, OwlViTImageEncoder(**owl, dtype=dtype, generator=g),
                                      dtype=dtype, generator=g),
                "owl_text": ClipTextEncoder(**spec["owl_text"], dtype=dtype, generator=g),
                "sam": SamImageEncoder(**spec["sam"], fused_global=fused_global,
                                       fused_windowed=fused_windowed, dtype=dtype, generator=g),
                "decoder": SamMaskDecoder(**spec["decoder"], dtype=dtype, generator=g)}

    if params is None:
        with torch.device(resolve_device(device)):
            towers = make(generator)
    else:
        with torch.device("meta"):
            towers = make(None)
        for name, module in towers.items():
            prefix = name + "."
            module.load_state_dict({k[len(prefix):]: v for k, v in params.items()
                                    if k.startswith(prefix)}, strict=True, assign=True)
    return {k: m.eval() for k, m in towers.items()}


def spec_from_trees(det_tree, text_tree, sam_tree, decoder_tree) -> Dict[str, dict]:
    """``build_towers``' spec read off imported flax trees (OWL-ViT's
    detector and text tower, SAM's image encoder and mask decoder). Widths
    that no shape shows take the published values: OWL-ViT's heads of 64,
    the mask decoder's 8 heads."""
    vp = det_tree["params"]["image_encoder"]
    dim = vp["cls_token"].shape[-1]
    patch = vp["patch_embed"]["kernel"].shape[0]
    tp = text_tree["params"]
    width = tp["positional_embedding"].shape[1]
    sp = sam_tree["params"]
    g, sam_patch = sp["pos_embed"].shape[1], sp["patch_embed"]["kernel"].shape[0]
    blocks = sorted((int(k.split("_")[1]) for k in sp if k.startswith("block_")))
    rel = {i: sp[f"block_{i}"]["attn"]["rel_pos_h"].shape for i in blocks}
    windowed = [(n + 1) // 2 for n, _ in rel.values() if n != 2 * g - 1]
    dp = decoder_tree["params"]
    return {
        "owl": dict(img_size=int(round((vp["pos_embed"].shape[1] - 1) ** 0.5)) * patch,
                    patch=patch, dim=dim, depth=sum(k.startswith("block_") for k in vp),
                    heads=max(1, dim // 64),
                    embed_dim=tp["text_projection"].shape[1]),
        "owl_text": dict(vocab_size=tp["token_embedding"].shape[0],
                         context_length=tp["positional_embedding"].shape[0], width=width,
                         heads=max(1, width // 64),
                         layers=sum(k.startswith("resblock_") for k in tp),
                         embed_dim=tp["text_projection"].shape[1]),
        "sam": dict(img_size=g * sam_patch, patch_size=sam_patch,
                    embed_dim=sp["pos_embed"].shape[-1], depth=len(blocks),
                    num_heads=sp["pos_embed"].shape[-1] // rel[blocks[0]][1],
                    window_size=windowed[0] if windowed else g,
                    global_attn_indexes=tuple(i for i in blocks if rel[i][0] == 2 * g - 1),
                    out_chans=sp["neck_conv1"]["kernel"].shape[-1]),
        "decoder": dict(dim=dp["iou_token"].shape[-1], heads=8,
                        depth=sum(k.startswith("block_") for k in dp),
                        num_masks=dp["mask_tokens"].shape[0],
                        mlp_dim=dp["block_0"]["Dense_0"]["kernel"].shape[1]),
    }


class TorchOwlVitSamDetector:
    """OWL-ViT box proposal + SAM box-prompted mask on the port's towers
    (``models/owlvit.py``, ``models/sam_encoder.py`` + ``sam_decoder.py``),
    the counterpart of the JAX package's ``JaxOwlVitSamDetector``. The query
    embeddings are computed once per query and cached. ``last`` holds the
    newest pass's device outputs (OWL's logits, the box and its patch,
    SAM's embedding, mask logits, IoU predictions and chosen index, the
    chosen mask's logits over the frame), for inspection."""

    def __init__(self, owl_pipeline, sam_segmenter, score_threshold: float = 0.1):
        self._owl = owl_pipeline
        self._sam = sam_segmenter
        self._threshold = score_threshold
        self._query_cache = {}
        self._graphs = graphs.Graphs("vlm", sam_segmenter.device)
        self.last: Dict[str, object] = {}

    @classmethod
    def build(cls, spec: Dict[str, dict], *, dtype: torch.dtype = torch.float32,
              fused_global: bool = False, fused_windowed: bool = False, device=None,
              params: Optional[Dict[str, torch.Tensor]] = None,
              generator: Optional[torch.Generator] = None, score_threshold: float = 0.1):
        """The detector at ``spec``'s widths (see ``build_towers``): the
        compute ``dtype`` and K7's flags (K7 runs at bf16 on a CUDA device),
        weights from ``params`` or ``generator``."""
        t = build_towers(spec, dtype=dtype, fused_global=fused_global,
                         fused_windowed=fused_windowed, device=device, params=params,
                         generator=generator)
        from voxactb_tpu_torch.models.owlvit import OwlViTPipeline
        from voxactb_tpu_torch.models.sam_decoder import SamSegmenter

        return cls(OwlViTPipeline(t["owl"], t["owl_text"], img_size=spec["owl"]["img_size"]),
                   SamSegmenter(t["sam"], t["decoder"], spec["sam"]["img_size"]),
                   score_threshold)

    @classmethod
    def from_pretrained(cls, sam_size: str = "vit_h", score_threshold: float = 0.1,
                        device=None, compute_dtype: torch.dtype = torch.float32):
        """Build from local checkpoints (``utils/pretrained``:
        ``$VOXACTB_WEIGHTS_DIR`` with ``owlvit_base.pt`` and
        ``sam_{size}.pth``) through ``build``: towers at the checkpoints'
        widths in ``compute_dtype`` (K7 in every SAM block at bf16) on
        ``device`` (CUDA unless the caller passes ``"cpu"``). Raises
        ``FileNotFoundError`` when weights are absent; callers fall back to
        ``MaskLocalizer`` / ``GroundTruthLocalizer``."""
        from voxactb_tpu_torch.device import resolve_device
        from voxactb_tpu_torch.models.owlvit import load_hf_owlvit_weights
        from voxactb_tpu_torch.models.sam_decoder import load_torch_sam_decoder_weights
        from voxactb_tpu_torch.models.sam_encoder import load_torch_sam_weights
        from voxactb_tpu_torch.utils import pretrained
        from voxactb_tpu_torch.weights import flax_tree_to_tensors

        owl_path = pretrained.find_weights("owlvit")
        sam_path = pretrained.find_weights(f"sam_{sam_size}")
        if owl_path is None or sam_path is None:
            raise FileNotFoundError(
                f"no OWL-ViT / SAM checkpoints under {pretrained.weights_dir()} (need "
                f"owlvit_base.pt and sam_{sam_size}.pth)")
        det, text = load_hf_owlvit_weights(pretrained._torch_state_dict(owl_path))
        sd = pretrained._torch_state_dict(sam_path)  # read once for both towers
        trees = {"owl": det, "owl_text": text, "sam": load_torch_sam_weights(sd),
                 "decoder": load_torch_sam_decoder_weights(sd)}
        del sd
        spec = spec_from_trees(*trees.values())
        dev = resolve_device(device)
        params = {}
        for name, module in build_towers(spec, device="meta", params=None).items():
            params.update({f"{name}.{k}": v.to(dev)
                           for k, v in flax_tree_to_tensors(module, trees[name]).items()})
        return cls.build(spec, dtype=compute_dtype, fused_global=True, fused_windowed=True,
                         params=params, score_threshold=score_threshold)

    def mask_logits(self, rgb: np.ndarray, query: str) -> torch.Tensor:
        """The chosen mask's logits over the frame, ``[H, W]`` f32 on the
        device: OWL-ViT's best box for ``query`` (its two copies to the
        host), SAM's masks for it, the one of highest predicted IoU, chosen
        on the device. Three programs, through ``ops/cuda/graphs`` (CUDA
        graphs on a CUDA device, one set per frame size and query count):
        OWL-ViT and SAM's encoder over one copy of the frame, SAM's decoder
        over the embedding and the box prompt."""
        frame_hw = rgb.shape[:2]
        if query not in self._query_cache:
            self._query_cache[query] = self._owl.embed_queries([query])
        dev, f32 = self._sam.device, torch.float32

        def owl(frame, queries):
            return self._owl.predict_frame(torch.as_tensor(frame, dtype=f32, device=dev), queries)

        def encode(frame, _):
            return (self._sam.embed_frame(torch.as_tensor(frame, dtype=f32, device=dev)),)

        def decode(embedding, prompt):
            masks, iou = self._sam.decode(embedding, torch.as_tensor(prompt, device=dev))
            index = torch.argmax(iou[0])
            return masks, iou, index, self._sam.mask_logits(masks, frame_hw, index)

        leaves = (rgb, self._query_cache[query])
        g = self._graphs.entry(self, (), (), leaves)
        with g.lock:
            with span("vx.vlm.owl"):
                g.copy_in(leaves)
                logits, boxes = g.run("owl", owl)
                box, score, patch = self._owl.choose(logits, boxes, frame_hw, self._threshold)
            with span("vx.vlm.sam.encode"):
                (embedding,) = g.run("encode", encode)
        with span("vx.vlm.sam.decode"):
            leaves = (embedding, self._sam.box_array(box, frame_hw))
            g = self._graphs.entry(self, (), frame_hw, leaves)
            with g.lock:
                g.copy_in(leaves)
                masks, iou, index, chosen = g.run("decode", decode)
        self.last = dict(owl_logits=logits, box=box, score=score, patch=patch,
                         embedding=embedding, masks=masks, iou=iou, index=index,
                         mask_logits=chosen)
        return chosen

    def __call__(self, rgb: np.ndarray, query: str) -> np.ndarray:
        mask = chosen_mask(self.mask_logits(rgb, query)).cpu().numpy()
        count("vlm.d2h_copies")
        return mask


_BASE = {
    "open_jar": (0.9, 0.1, 0.1),              # jar body (tasks.py OpenJar)
    "open_drawer": (0.8, 0.8, 0.2),           # bottom_handle
    "put_item_in_drawer": (0.8, 0.8, 0.2),    # top_handle
    "hand_over_item": (0.9, 0.2, 0.9),        # cube
}
# nominal object colors per task (sim/tasks.py scene definitions), uint8
TASK_COLORS: Dict[str, np.ndarray] = {
    k: np.array([int(c * 255) for c in v], np.float32)
    for k, v in _BASE.items()
}


class ColorDetector:
    """Pixels-only detector for the renderer's output: segments the task
    object by color distance in the front-camera RGB.

    This is the detector-agnostic slot the reference fills with OWL-ViT+SAM
    (vlm.py:77-143); on the kinematic renderer (flat-shaded colors) a color
    threshold is the equivalent localization signal, and CRUCIALLY the crop
    point still comes from the rendered pixels + depth-derived cloud — so
    perception error (resolution, occlusion, projection, surface-vs-center
    centroid bias) propagates into the policy evaluation exactly as a learned
    detector's would. No ground-truth object position is consulted.
    """

    def __init__(self, task_name: str, tol: float = 40.0):
        if task_name not in TASK_COLORS:
            raise KeyError(f"no nominal color for task {task_name!r}")
        self._color = TASK_COLORS[task_name]
        self._tol = float(tol)

    def __call__(self, rgb: np.ndarray, query: str) -> np.ndarray:
        rgb = np.asarray(rgb, np.float32)
        if rgb.max() <= 1.0 + 1e-6:   # [-1,1]/[0,1] normalized frames
            rgb = (rgb + 1.0) / 2.0 * 255.0 if rgb.min() < 0 else rgb * 255.0
        d = np.linalg.norm(rgb - self._color, axis=-1)
        mask = d < self._tol
        if not mask.any():
            # a fully occluded object still yields a BEST GUESS, like OWL-ViT
            # returning its highest-scoring box regardless of confidence
            # (vlm.py:100-107 argmax over scores) — the guess's error is real
            # perception error and propagates into the eval
            mask = d <= d.min()
        return mask


class MaskLocalizer:
    """Detector backed by ground-truth segmentation masks (sim provides them)."""

    def __init__(self, mask_lookup: Callable[[str], np.ndarray]):
        self._lookup = mask_lookup

    def __call__(self, rgb: np.ndarray, query: str) -> np.ndarray:
        return np.asarray(self._lookup(query), bool)


class GroundTruthLocalizer:
    """Bypasses detection entirely: env supplies the object position directly."""

    def __init__(self, get_position: Callable[[], np.ndarray],
                 radius: float = 0.3):
        self._get_position = get_position
        self._radius = radius

    def locate(self, *_args, **_kw) -> Tuple[np.ndarray, float]:
        return np.asarray(self._get_position(), np.float32), self._radius


class VLM:
    """The reference's entry point: front-camera frame -> crop point + radius
    (vlm.py:144-194)."""

    def __init__(self, detector: Detector, downsample_voxel: float = 0.01):
        self._detector = detector
        self._downsample_voxel = downsample_voxel

    def get_target_object_world_coords(
        self, rgb: np.ndarray, point_cloud: np.ndarray, task_name: str,
        query: Optional[str] = None,
    ) -> Tuple[np.ndarray, float]:
        query = query or task_queries(task_name)
        with span("vx.vlm"):
            on_device = getattr(self._detector, "mask_logits", None)
            if on_device is None:
                mask = self._detector(rgb, query)
                with span("vx.vlm.crop"):
                    return crop_point_from_mask(
                        mask, point_cloud, task_name, self._downsample_voxel)
            # the cloud goes up first, while the device is idle: a copy from
            # pageable memory waits for the stream
            cloud = torch.as_tensor(np.asarray(point_cloud, np.float32),
                                    device=self._detector._sam.device)
            logits = on_device(rgb, query)
            with span("vx.vlm.crop"):
                stats = crop_stats_on_device(logits, cloud, self._downsample_voxel)
            with span("vx.vlm.d2h"):
                stats = stats.cpu().numpy()
            count("vlm.d2h_copies")
            count("vlm.mask_pixels", int(stats[6]))
            return crop_from_stats(stats, task_name)
