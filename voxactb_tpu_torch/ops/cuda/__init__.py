"""Hand-written Hopper kernels of the act path and the BC train step, and
their plain versions.

Each wrapper (``front_fused``, ``flash_attention``, ``decoder_head``,
``flash_attention_train`` with its forward and backward launches) takes its
plain-PyTorch version for CPU tensors only; for CUDA tensors it launches its
kernel or raises. ``LAUNCHES`` counts kernel launches
per wrapper, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {"front_fused": 0, "flash_attention": 0,
                            "decoder_head": 0, "flash_attention_train_fwd": 0,
                            "flash_attention_train_bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)
