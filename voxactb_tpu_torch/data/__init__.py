"""Demo ingestion: RLBench on-disk format reader and replay-fill pipeline."""

from voxactb_tpu_torch.data.rlbench_format import (  # noqa: F401
    DemoReader,
    decode_depth_rgb,
    pointcloud_from_depth,
)
from voxactb_tpu_torch.data.fill_replay import fill_replay, fill_multi_task_replay  # noqa: F401
