"""VoxPoser-style LLM planning subsystem: value maps, greedy planner, LMP executor."""

from voxactb_tpu_torch.voxposer.planner import GreedyPathPlanner, PlannerConfig  # noqa: F401
from voxactb_tpu_torch.voxposer.value_maps import VoxelMapSpec  # noqa: F401
from voxactb_tpu_torch.voxposer.heuristics import determine_dominant_hand  # noqa: F401
from voxactb_tpu_torch.voxposer.llm_http import (  # noqa: F401
    OpenAIChatBackend,
    VisionChatBackend,
    determine_dominant_hand_llm,
)
