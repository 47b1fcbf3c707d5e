"""PyTorch/CUDA port of voxactb_tpu for NVIDIA Hopper.

Module names follow the JAX package (``voxactb_tpu``) so each counterpart is
easy to find. Public tensors are channels-last (``[B, N, N, N, C]``) as there.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; the
hand-written kernels live under ``csrc/`` and are bound in ``ops/cuda/``.
The host-only modules (``envs/``, ``sim/``, ``data/``, ``replay/buffer.py``,
``replay/prioritized.py``, ``runners/env_runner.py``, ``utils/keypoints.py``,
``utils/loggers.py``, ``utils/observation.py``, ``voxposer/``, ``realrobot/``,
``utils/recovery.py``, ``utils/video.py``, ``utils/visualize.py``) are copies of
the JAX package's with their imports rewritten, so the port imports nothing of
it.
"""

from voxactb_tpu_torch.config import MethodConfig
from voxactb_tpu_torch.device import resolve_device

__all__ = ["MethodConfig", "resolve_device"]
