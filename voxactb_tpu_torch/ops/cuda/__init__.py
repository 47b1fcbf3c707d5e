"""Hand-written Hopper kernels of the act path, the BC train step and the SAM
image encoder, and their plain versions.

Each wrapper (``front_fused``, ``flash_attention``, ``decoder_head``,
``flash_attention_train`` with its forward and backward launches,
``sam_attention``, and on the dense-grid act path ``encoder_stats``,
``stats_head`` and ``decoder_head_v3``) takes its plain-PyTorch version for
CPU tensors only; for CUDA tensors it launches its kernel or raises.
``LAUNCHES`` counts kernel launches per wrapper, so a run can show that its
main path went through the kernels; ``decoder_tail_conv`` and
``decoder_tail_trans_stats`` count the launches of the decoder tail's u conv
(``csrc/tail_conv.cuh``) and its trans/stats pass (``csrc/decoder_tail.cuh``),
which both ``decoder_head`` and ``decoder_head_v3`` make,
``decoder_phase_gemm`` those of ``decoder_head_v3``'s phase GEMM
(``csrc/phase_gemm.cuh``), and ``front_patchify`` those of the k5/s5 patchify
(``csrc/front_patchify.cuh``), which ``front_fused`` makes and the dense
path's ``front_patchify`` wrapper makes alone. ``grid_copy``, ``smem_scratch``
and ``shifted_window`` (``probes.py``, ``csrc/probes.cu``) count the launches
of the tools' probe kernels. ``sam_ln``, ``sam_qkv_split``, ``sam_bias_gelu``
and ``sam_bias_residual`` count those of SAM's block kernels
(``sam_block.py``, ``csrc/sam_block.cu``), whose wrappers ``SamBlock`` calls
for a CUDA bf16 input only.
"""

from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {"front_fused": 0, "flash_attention": 0,
                            "decoder_head": 0, "flash_attention_train_fwd": 0,
                            "flash_attention_train_bwd": 0, "sam_attention": 0,
                            "encoder_stats": 0, "stats_head": 0, "decoder_head_v3": 0,
                            "decoder_tail_conv": 0, "decoder_tail_trans_stats": 0,
                            "decoder_phase_gemm": 0, "front_patchify": 0,
                            "grid_copy": 0, "smem_scratch": 0, "shifted_window": 0,
                            "sam_ln": 0, "sam_qkv_split": 0, "sam_bias_gelu": 0,
                            "sam_bias_residual": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)
