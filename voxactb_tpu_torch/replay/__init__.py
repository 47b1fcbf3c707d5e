"""Host-side replay buffers and device-feed pipelines."""

from voxactb_tpu_torch.replay.buffer import (  # noqa: F401
    ElementSpec,
    TaskUniformReplayBuffer,
    UniformReplayBuffer,
    bc_replay_signature,
)
