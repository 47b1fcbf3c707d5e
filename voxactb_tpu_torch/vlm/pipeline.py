"""Object localization -> voxel-grid recentering (the VoxAct-B "VLM" subsystem).

Counterpart of ``voxactb_tpu.vlm.pipeline``: OWL-ViT proposes a box for a
task-specific text query, SAM segments it, the mask selects front-camera
points whose voxel-downsampled centroid becomes the crop point, and the crop
radius is auto-derived from the object's extent plus 5cm padding.

- ``crop_point_from_mask``: the geometry half (mask + cloud -> centroid +
  radius), host-only, copied from the JAX package;
- ``Detector`` protocol: anything producing a boolean object mask from an RGB
  frame: ``TorchOwlVitSamDetector`` (the port's OWL-ViT + SAM towers on the
  card), ``ColorDetector``, ``MaskLocalizer`` / ``GroundTruthLocalizer``;
- ``VLM``: the user-facing class with the reference's entry point
  ``get_target_object_world_coords``.

``TorchOwlVitSamDetector.from_pretrained`` builds the towers from local
checkpoints (``utils/pretrained``). The transformers-based
``OwlVitSamDetector`` is not ported: the card has no transformers.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Protocol, Tuple

import numpy as np

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

    center = pts.mean(0)
    extents = pts.max(0) - pts.min(0)
    if task_name == "open_jar" and extents[:2].max() > JAR_MAX_PLAUSIBLE_DIM:
        # detector latched onto something jar-sized-ly implausible: fall back
        # to the fixed workspace-center crop point, exactly like the
        # reference's bbox>0.15 guard (vlm.py:177-180) — a GOOD detection
        # keeps its measured centroid, z included
        center = JAR_FALLBACK_POINT.copy()

    radius = float(extents.max() + AUTO_RADIUS_PADDING)
    return center.astype(np.float32), radius


class Detector(Protocol):
    def __call__(self, rgb: np.ndarray, query: str) -> np.ndarray:
        """RGB [H,W,3] uint8 + text query -> boolean mask [H,W]."""


class TorchOwlVitSamDetector:
    """OWL-ViT box proposal + SAM box-prompted mask on the port's towers
    (``models/owlvit.py``, ``models/sam_encoder.py`` + ``sam_decoder.py``),
    the counterpart of the JAX package's ``JaxOwlVitSamDetector``. The query
    embeddings are computed once per query and cached."""

    def __init__(self, owl_pipeline, sam_segmenter, score_threshold: float = 0.1):
        self._owl = owl_pipeline
        self._sam = sam_segmenter
        self._threshold = score_threshold
        self._query_cache = {}

    @classmethod
    def from_pretrained(cls, sam_size: str = "vit_h", score_threshold: float = 0.1,
                        device=None):
        """Build from local checkpoints (``utils/pretrained``:
        ``$VOXACTB_WEIGHTS_DIR`` with ``owlvit_base.pt`` and
        ``sam_{size}.pth``): f32 towers at the checkpoints' dims on ``device``
        (CUDA unless the caller passes ``"cpu"``). Raises
        ``FileNotFoundError`` when weights are absent; callers fall back to
        ``MaskLocalizer`` / ``GroundTruthLocalizer``."""
        from voxactb_tpu_torch.models.owlvit import OwlViTPipeline, load_hf_owlvit_weights
        from voxactb_tpu_torch.models.sam_decoder import (
            SamSegmenter, load_torch_sam_decoder_weights)
        from voxactb_tpu_torch.models.sam_encoder import load_torch_sam_weights
        from voxactb_tpu_torch.utils import pretrained

        owl_path = pretrained.find_weights("owlvit")
        sam_path = pretrained.find_weights(f"sam_{sam_size}")
        if owl_path is None or sam_path is None:
            raise FileNotFoundError(
                f"no OWL-ViT / SAM checkpoints under {pretrained.weights_dir()} (need "
                f"owlvit_base.pt and sam_{sam_size}.pth)")
        det, text = pretrained.owlvit_from(
            *load_hf_owlvit_weights(pretrained._torch_state_dict(owl_path)), device)
        sd = pretrained._torch_state_dict(sam_path)  # read once for both towers
        encoder = pretrained.sam_encoder_from(load_torch_sam_weights(sd), sam_size, device)
        decoder = pretrained.sam_decoder_from(load_torch_sam_decoder_weights(sd), device)
        del sd
        pipeline = OwlViTPipeline(det, text, img_size=det.image_encoder.img_size)
        return cls(pipeline, SamSegmenter(encoder, decoder), score_threshold)

    def __call__(self, rgb: np.ndarray, query: str) -> np.ndarray:
        if query not in self._query_cache:
            self._query_cache[query] = self._owl.embed_queries([query])
        box, _score = self._owl.detect(rgb, self._query_cache[query], self._threshold)
        return self._sam.segment_box(rgb, box)


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
        mask = self._detector(rgb, query)
        return crop_point_from_mask(
            mask, point_cloud, task_name, self._downsample_voxel)
