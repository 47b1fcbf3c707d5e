"""Method configuration for the PyTorch/CUDA port.

A copy of ``voxactb_tpu.config.MethodConfig`` with the same field names and
defaults, so a config of the JAX package translates 1:1 (``MethodConfig(**
dataclasses.asdict(jax_cfg))``). The port keeps its own copy rather than
importing the JAX package's module.

The ``pallas_*`` kernel switches keep their names: in the port,
``pallas_front``, ``pallas_attention`` and ``pallas_decoder`` select the
hand-written Hopper kernels of the act path and ``pallas_attention_train``
the trainable attention kernel of the BC train step (``ops/cuda/``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class MethodConfig:
    """conf/method/PERACT_BC.yaml — model + VoxAct-B behavior flags."""

    name: str = "PERACT_BC"

    # Voxelization
    image_crop_size: int = 64
    bounds_offset: List[float] = field(default_factory=lambda: [0.15])
    voxel_sizes: List[int] = field(default_factory=lambda: [100])
    include_prev_layer: bool = False

    # Perceiver
    num_latents: int = 2048
    latent_dim: int = 512
    transformer_depth: int = 6
    transformer_iterations: int = 1
    cross_heads: int = 1
    cross_dim_head: int = 64
    latent_heads: int = 8
    latent_dim_head: int = 64
    pos_encoding_with_lang: bool = True
    lang_fusion_type: str = "seq"
    voxel_patch_size: int = 5
    voxel_patch_stride: int = 5
    final_dim: int = 64

    # Training
    input_dropout: float = 0.1
    attn_dropout: float = 0.1
    decoder_dropout: float = 0.0
    lr: float = 0.0005
    lr_scheduler: bool = False
    num_warmup_steps: int = 3000
    optimizer: str = "lamb"  # or 'adam'
    lambda_weight_l2: float = 0.000001
    trans_loss_weight: float = 1.0
    rot_loss_weight: float = 1.0
    grip_loss_weight: float = 1.0
    collision_loss_weight: float = 1.0
    rotation_resolution: int = 5

    # Network
    activation: str = "lrelu"

    # Augmentation
    crop_augmentation: bool = True
    apply_se3: bool = True
    aug_xyz: List[float] = field(default_factory=lambda: [0.125, 0.125, 0.125])
    aug_rpy: List[float] = field(default_factory=lambda: [0.0, 0.0, 45.0])
    aug_rot_resolution: int = 5
    demo_augmentation: bool = True
    demo_augmentation_every_n: int = 10

    # Ablations
    no_skip_connection: bool = False
    no_perceiver: bool = False
    no_language: bool = False
    keypoint_method: str = "heuristic"

    # Two arms (VoxAct-B)
    which_arm: str = "right"  # right | left | both | multiarm | dominant | assistive
    variant: str = "two_policies"  # two_policies | one_policy_more_heads
    crop_target_obj_voxel: bool = False
    crop_radius: float = 0.0
    randomizations_crop_point: bool = False
    arm_pred_loss: bool = False
    arm_loss_weight: float = 1.0
    arm_pred_input: bool = False
    arm_id_to_proprio: bool = False
    saved_every_last_inserted: int = 0
    use_default_stopped_buffer_timesteps: bool = False
    stopped_buffer_timesteps_overwrite: int = 0
    is_real_robot: bool = False
    keypoint_discovery_no_duplicate: bool = False

    # Accelerator extras
    compute_dtype: str = "float32"  # 'bfloat16' for tensor-core inference
    remat: bool = False             # recompute the forward in the backward
    fused_upsample: bool = True     # phase-decomposed decoder upsample-conv
    pallas_stats: bool = False      # standalone stats kernel (later slice)
    zshift_conv3d: bool = True      # a TPU conv schedule; same math, ignored
    pallas_decoder: bool = False    # Hopper decoder-tail kernel (ops/cuda/decoder_head)
    pallas_decoder_v3: bool = False  # inline-upsample decoder tail (later slice)
    pallas_decoder_v2c: bool = False  # TPU schedule of the decoder tail; ignored
    pallas_encoder: bool = False    # dense-grid front kernel (later slice)
    pallas_front: bool = False      # Hopper fused front kernel (ops/cuda/front_fused)
    front_scatter_unroll: int = 1   # TPU schedule of the front scatter; ignored
    front_scatter_matmul: bool = False  # TPU schedule of the front scatter; ignored
    pallas_attention: bool = False  # Hopper flash-attention kernel (inference, bf16)
    pallas_attention_train: bool = False  # Hopper trainable attention kernel (bf16)
    pallas_interpret: bool = False  # TPU interpret mode; ignored (CPU tensors
    # always take the kernels' plain versions)

    @property
    def voxel_size(self) -> int:
        return self.voxel_sizes[0]

    @property
    def num_rotation_classes(self) -> int:
        return int(360 // self.rotation_resolution)

    def low_dim_size(self) -> int:
        """Proprio width by arm mode (launch_utils.py:58-75 + extract_obs timestep).

        single arm / both / multiarm: gripper_open + 2 finger joints + timestep = 4
        dominant/assistive: left(3) + right(3) + timestep = 7, +1 arm-id channel
        when ``arm_id_to_proprio`` (helpers/utils.py:614-618).
        """
        if self.which_arm in ("right", "left", "both", "multiarm"):
            return 4
        return 8 if self.arm_id_to_proprio else 7

    def proprio_width(self) -> int:
        """Total proprio vector width the encoder consumes: the two-head
        variant stacks BOTH arms' per-arm states (right then left)."""
        return self.low_dim_size() * (
            2 if self.variant == "one_policy_more_heads" else 1)
