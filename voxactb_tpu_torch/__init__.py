"""PyTorch/CUDA port of voxactb_tpu's act path for NVIDIA Hopper.

Module names follow the JAX package (``voxactb_tpu``) so each counterpart is
easy to find. Public tensors are channels-last (``[B, N, N, N, C]``) as there.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; the
hand-written kernels live under ``csrc/`` and are bound in ``ops/cuda/``.
"""

from voxactb_tpu_torch.config import MethodConfig
from voxactb_tpu_torch.device import resolve_device

__all__ = ["MethodConfig", "resolve_device"]
