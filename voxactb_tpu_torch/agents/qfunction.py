"""Q-attention inference program: observation -> voxelize -> Perceiver -> action.

Counterpart of the inference half of ``voxactb_tpu.agents.qfunction``
(``make_infer_fn`` and the dispatch it shares with the bench,
qfunction.py:35-226). PyTorch runs eagerly, so the program is a plain function
under ``torch.inference_mode``; its weights are the ``nn.Module`` passed as
argument 0, so one program serves several parameter sets (the acting and
stabilizing policies of a VoxAct-B episode).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from voxactb_tpu_torch.config import MethodConfig
from voxactb_tpu_torch.device import resolve_device
from voxactb_tpu_torch.models.blocks import lrelu
from voxactb_tpu_torch.models.perceiver import PerceiverVoxelLangEncoder
from voxactb_tpu_torch.ops import geometry as G
from voxactb_tpu_torch.ops.voxelize import (
    flatten_camera_observations, reciprocal, voxelize)


def _unported(flag: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{flag} selects a kernel of a later slice of the port ({slice_name}); "
        "unset it to run the same function through the act-path kernels")


def build_encoder(cfg: MethodConfig, low_dim_size: Optional[int] = None, *,
                  device=None, seed: int = 0) -> PerceiverVoxelLangEncoder:
    """Instantiate the Q-net from a method config, with weights initialised
    from ``torch.Generator().manual_seed(seed)`` on the CPU (so every machine
    builds the same weights) and then moved to ``device``."""
    device = resolve_device(device)
    if cfg.voxel_size % cfg.voxel_patch_stride != 0:
        raise ValueError(
            f"voxel_size {cfg.voxel_size} must be divisible by voxel_patch_stride "
            f"{cfg.voxel_patch_stride}")
    # flags of kernels not yet ported raise where the JAX package would take them
    lrelu_bf16 = cfg.activation == "lrelu" and cfg.compute_dtype == "bfloat16"
    if cfg.pallas_stats:
        raise _unported("pallas_stats", "the stats_head kernel")
    if (cfg.pallas_decoder_v3 and cfg.activation == "lrelu"
            and not (cfg.no_skip_connection or cfg.no_perceiver)
            and cfg.voxel_patch_size == cfg.voxel_patch_stride == 5):
        raise _unported("pallas_decoder_v3", "the decoder_head_v3 kernel")
    if cfg.pallas_encoder and lrelu_bf16 and not front_eligible(cfg):
        raise _unported("pallas_encoder", "the encoder_stats kernel")
    two_heads = cfg.variant == "one_policy_more_heads"
    gen = torch.Generator().manual_seed(seed)
    model = PerceiverVoxelLangEncoder(
        depth=cfg.transformer_depth,
        iterations=cfg.transformer_iterations,
        voxel_size=cfg.voxel_size,
        initial_dim=10,
        low_dim_size=low_dim_size if low_dim_size is not None else cfg.low_dim_size(),
        num_rotation_classes=cfg.num_rotation_classes,
        num_latents=cfg.num_latents,
        latent_dim=cfg.latent_dim,
        cross_heads=cfg.cross_heads,
        latent_heads=cfg.latent_heads,
        cross_dim_head=cfg.cross_dim_head,
        latent_dim_head=cfg.latent_dim_head,
        activation=cfg.activation,
        voxel_patch_size=cfg.voxel_patch_size,
        voxel_patch_stride=cfg.voxel_patch_stride,
        final_dim=cfg.final_dim,
        no_skip_connection=cfg.no_skip_connection,
        no_perceiver=cfg.no_perceiver,
        no_language=cfg.no_language,
        arm_pred=cfg.arm_pred_loss and not two_heads,
        num_proprio=2 if two_heads else 1,
        two_arm_heads=two_heads,
        fused_upsample=cfg.fused_upsample,
        pallas_decoder=cfg.pallas_decoder,
        pallas_attention=cfg.pallas_attention,
        dtype=torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32,
        generator=gen,
    )
    return model.to(device).eval()


def normalize_rgb(x: torch.Tensor) -> torch.Tensor:
    """[0,255] -> [-1,1] (preprocess_agent.py:21); ``/ 255`` as the compiled
    JAX program computes it, a multiplication by f32(1/255)."""
    return (x.to(torch.float32) * reciprocal(255.0)) * 2.0 - 1.0


def front_eligible(cfg: MethodConfig) -> bool:
    """Whether the fused front kernel applies to this config."""
    return (cfg.pallas_front and cfg.compute_dtype == "bfloat16"
            and cfg.activation == "lrelu" and cfg.voxel_patch_size == 5
            and cfg.voxel_patch_stride == 5 and cfg.voxel_size % 5 == 0)


def fused_front_inputs(cfg: MethodConfig, model: PerceiverVoxelLangEncoder,
                       coords, feats, bounds):
    """Run the fused front kernel with the model's own preprocess/patchify
    weights; returns the ``front`` tuple for the encoder — (d0, patch tokens,
    kp0, gmax0) — and the overflow count ([B] int32, always 0 here)."""
    from voxactb_tpu_torch.ops.cuda.front_fused import front_fused

    w1 = model.input_preprocess.kernel_dhwio()[0, 0, 0]
    b1 = model.input_preprocess.bias
    wp = model.patchify.kernel_dhwio()
    bp = model.patchify.bias
    d0, patch_pre, kp, gmax, overflow = front_fused(
        coords, feats, bounds, w1, b1, wp, voxel_size=cfg.voxel_size)
    # bias + lrelu on the small patch grid, in Conv3D's f32-accumulate order
    ins = lrelu((patch_pre + bp).to(torch.bfloat16))
    return (d0, ins, kp, gmax), overflow


def apply_with_front(cfg: MethodConfig, model, coords, feats, bounds, proprio,
                     lang_goal_emb, lang_token_embs):
    """Q-forward dispatch: the fused front kernel where eligible (the dense
    grid is then never built and ``grid`` is a [B,1,1,1,10] placeholder),
    else the voxelize path. Returns ``(out, grid, overflow)``."""
    b = coords.shape[0]
    if front_eligible(cfg):
        front, overflow = fused_front_inputs(cfg, model, coords, feats, bounds)
        grid = torch.zeros((b, 1, 1, 1, 10), dtype=torch.float32, device=coords.device)
        out = model(grid, proprio, lang_goal_emb, lang_token_embs, front=front)
    else:
        grid = voxelize(coords, feats, bounds, voxel_size=cfg.voxel_size)
        out = model(grid, proprio, lang_goal_emb, lang_token_embs)
        overflow = torch.zeros((b,), dtype=torch.int32, device=coords.device)
    return out, grid, overflow


def _flat_argmax_3d(q_trans: torch.Tensor) -> torch.Tensor:
    """[B,N,N,N,1] -> [B,3] int32 argmax voxel index (QFunction._argmax_3d :57-63);
    the first maximum wins, as in jnp.argmax."""
    b, n = q_trans.shape[0], q_trans.shape[1]
    idx = torch.argmax(q_trans.reshape(b, -1), -1)
    return torch.stack([idx // (n * n), (idx // n) % n, idx % n], -1).to(torch.int32)


def _decode_rot_grip(rot_grip_logits: torch.Tensor, num_rot: int) -> torch.Tensor:
    """[B, 3R+2] -> [B,4] int32 (rx, ry, rz bins + grip bit)."""
    parts = [rot_grip_logits[:, i * num_rot:(i + 1) * num_rot] for i in range(3)]
    parts.append(rot_grip_logits[:, 3 * num_rot:])
    return torch.stack([torch.argmax(p, -1) for p in parts], -1).to(torch.int32)


class InferOutput(NamedTuple):
    """Everything act() needs, produced on the device in one program."""

    trans_idx: torch.Tensor             # [B, 3] int32 voxel index
    rot_grip_idx: torch.Tensor          # [B, 4] int32
    collision_idx: torch.Tensor         # [B, 1] int32
    attention_coordinate: torch.Tensor  # [B, 3] float32 world point
    continuous_action: torch.Tensor     # [B, 9] = xyz + quat(xyzw) + grip + collision
    q_trans: torch.Tensor               # [B, N, N, N] softmaxed Q
    voxel_grid: torch.Tensor            # [B, N, N, N, 10]
    front_overflow: torch.Tensor        # [B] int32: points the front kernel
    #                                     dropped (always 0 in the port)


def make_infer_fn(cfg: MethodConfig, low_dim_size: Optional[int] = None, *,
                  device=None, seed: int = 0):
    """Build the act program. Returns ``(model, infer)``; ``infer(model, rgbs,
    pcds, proprio, lang_goal_emb, lang_token_embs, bounds)`` takes any module
    of this config as its weights.

    For the 'one_policy_more_heads' variant the InferOutput gains a leading
    head axis of size 2 (right, left) on every action field.
    """
    device = resolve_device(device)
    model = build_encoder(cfg, low_dim_size, device=device, seed=seed)
    n = cfg.voxel_size
    num_rot = cfg.num_rotation_classes
    two_heads = cfg.variant == "one_policy_more_heads"

    def as_tensor(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    @torch.inference_mode()
    def infer(model, rgbs: Sequence, pcds: Sequence, proprio, lang_goal_emb,
              lang_token_embs, bounds) -> InferOutput:
        rgbs = [as_tensor(r) for r in rgbs]
        pcds = [as_tensor(p) for p in pcds]
        b = pcds[0].shape[0]
        bounds = torch.broadcast_to(as_tensor(bounds).reshape(-1, 6), (b, 6))
        coords, feats = flatten_camera_observations(
            [normalize_rgb(r) for r in rgbs], pcds)
        out, grid, overflow = apply_with_front(
            cfg, model, coords, feats, bounds, as_tensor(proprio),
            as_tensor(lang_goal_emb), as_tensor(lang_token_embs))

        def decode(trans, rot_grip, collision):
            t_idx = _flat_argmax_3d(trans)
            rg_idx = _decode_rot_grip(rot_grip, num_rot)
            c_idx = torch.argmax(collision, -1, keepdim=True).to(torch.int32)
            att = G.attention_coordinate(t_idx, n, bounds)
            quat = G.discrete_euler_to_quaternion(rg_idx[:, :3], cfg.rotation_resolution)
            cont = torch.cat([att, quat, rg_idx[:, 3:4].to(torch.float32),
                              c_idx.to(torch.float32)], -1)
            q_soft = torch.softmax(trans.reshape(b, -1), -1).reshape(b, n, n, n)
            return t_idx, rg_idx, c_idx, att, cont, q_soft

        if two_heads:
            parts = [decode(out[f"trans_{s}"], out[f"rot_grip_{s}"],
                            out[f"collision_{s}"]) for s in ("right", "left")]
            stacked = [torch.stack(field) for field in zip(*parts)]
            return InferOutput(*stacked, voxel_grid=grid, front_overflow=overflow)
        return InferOutput(*decode(out["trans"], out["rot_grip"], out["collision"]),
                           voxel_grid=grid, front_overflow=overflow)

    return model, infer
