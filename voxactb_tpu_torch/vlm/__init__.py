"""VLM object localization driving voxel-grid recentering."""

from voxactb_tpu_torch.vlm.pipeline import (  # noqa: F401
    VLM,
    GroundTruthLocalizer,
    MaskLocalizer,
    TorchOwlVitSamDetector,
    crop_point_from_mask,
    task_queries,
)
