"""Functional Q-attention core: the inference and the training program.

Counterpart of ``voxactb_tpu.agents.qfunction``. PyTorch runs eagerly, so each
direction is a plain function:

- ``make_infer_fn``: observation -> voxelize -> Perceiver -> argmax decode ->
  continuous action, under ``torch.inference_mode``. Its weights are the
  ``nn.Module`` passed as argument 0, so one program serves several parameter
  sets (the acting and stabilizing policies of a VoxAct-B episode).
- ``make_train_step``: replay batch -> (bounds select | crop jitter) -> SE(3)
  aug -> voxelize -> forward(dropout) -> vectorised CE losses -> LAMB/Adam
  update, a function of ``(state, batch)`` whose weights and optimizer state
  travel in a ``TrainState`` of ``name -> tensor`` dictionaries.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from voxactb_tpu_torch.config import MethodConfig
from voxactb_tpu_torch.device import resolve_device
from voxactb_tpu_torch.models.blocks import lrelu
from voxactb_tpu_torch.models.perceiver import PerceiverVoxelLangEncoder
from voxactb_tpu_torch.ops import geometry as G
from voxactb_tpu_torch.ops.augmentation import (
    Se3AugConfig, apply_se3_augmentation, draw_rows)
from voxactb_tpu_torch.ops.cuda import graphs
from voxactb_tpu_torch.ops.voxelize import (
    flatten_camera_observations, reciprocal, voxelize)
from voxactb_tpu_torch.optim import (
    Optimizer, OptState, cosine_hard_restarts_schedule, global_norm)
from voxactb_tpu_torch.utils.profiling import span


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
        input_dropout=cfg.input_dropout,
        attn_dropout=cfg.attn_dropout,
        decoder_dropout=cfg.decoder_dropout,
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
        pallas_stats=cfg.pallas_stats,
        pallas_encoder=cfg.pallas_encoder,
        pallas_decoder=cfg.pallas_decoder,
        pallas_decoder_v3=cfg.pallas_decoder_v3,
        pallas_attention=cfg.pallas_attention,
        pallas_attention_train=cfg.pallas_attention_train,
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


def front_inputs(cfg: MethodConfig, model, coords, feats, bounds):
    """The Q-forward's front: the fused front kernel where eligible (the
    dense grid is then never built and ``grid`` is a [B,1,1,1,10]
    placeholder), else the voxelize path, which returns the real
    ``[B,N,N,N,10]`` grid (the path to take when rendering voxel grids) for
    the encoder (``pallas_encoder``'s kernel there). Returns ``(front, grid,
    overflow)``, ``front`` None on the voxelize path."""
    b = coords.shape[0]
    if front_eligible(cfg):
        front, overflow = fused_front_inputs(cfg, model, coords, feats, bounds)
        grid = torch.zeros((b, 1, 1, 1, 10), dtype=torch.float32, device=coords.device)
        return front, grid, overflow
    grid = voxelize(coords, feats, bounds, voxel_size=cfg.voxel_size)
    return None, grid, torch.zeros((b,), dtype=torch.int32, device=coords.device)


def apply_with_front(cfg: MethodConfig, model, coords, feats, bounds, proprio,
                     lang_goal_emb, lang_token_embs):
    """Q-forward dispatch: ``front_inputs``, then the model. Returns ``(out,
    grid, overflow)``."""
    front, grid, overflow = front_inputs(cfg, model, coords, feats, bounds)
    out = model(grid, proprio, lang_goal_emb, lang_token_embs, front=front)
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
                  device=None, seed: int = 0, model=None):
    """Build the act program. Returns ``(model, infer)``; ``infer(model, rgbs,
    pcds, proprio, lang_goal_emb, lang_token_embs, bounds)`` takes any module
    of this config as its weights. ``model``, when given, is returned in place
    of a newly built one (the train step's module).

    For the 'one_policy_more_heads' variant the InferOutput gains a leading
    head axis of size 2 (right, left) on every action field.

    ``infer`` runs the program through ``ops/cuda/graphs``: on a CUDA device
    as one CUDA graph per model and input shapes, returning fresh tensors;
    on the CPU, or inside ``graphs.eager()``, eagerly.
    """
    device = resolve_device(device)
    if model is None:
        model = build_encoder(cfg, low_dim_size, device=device, seed=seed)
    n = cfg.voxel_size
    num_rot = cfg.num_rotation_classes
    two_heads = cfg.variant == "one_policy_more_heads"

    def as_tensor(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    @torch.inference_mode()
    def program(model, rgbs: Sequence, pcds: Sequence, proprio, lang_goal_emb,
                lang_token_embs, bounds) -> InferOutput:
        with span("vx.act.h2d"):
            rgbs = [as_tensor(r) for r in rgbs]
            pcds = [as_tensor(p) for p in pcds]
            b = pcds[0].shape[0]
            bounds = torch.broadcast_to(as_tensor(bounds).reshape(-1, 6), (b, 6))
            proprio, lang_goal_emb, lang_token_embs = (
                as_tensor(proprio), as_tensor(lang_goal_emb), as_tensor(lang_token_embs))
        with span("vx.act.front"):
            coords, feats = flatten_camera_observations(
                [normalize_rgb(r) for r in rgbs], pcds)
            front, grid, overflow = front_inputs(cfg, model, coords, feats, bounds)
        out = model(grid, proprio, lang_goal_emb, lang_token_embs, front=front)

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

        with span("vx.act.decode"):
            if two_heads:
                parts = [decode(out[f"trans_{s}"], out[f"rot_grip_{s}"],
                                out[f"collision_{s}"]) for s in ("right", "left")]
                stacked = [torch.stack(field) for field in zip(*parts)]
                return InferOutput(*stacked, voxel_grid=grid, front_overflow=overflow)
            return InferOutput(*decode(out["trans"], out["rot_grip"], out["collision"]),
                               voxel_grid=grid, front_overflow=overflow)

    table = graphs.Graphs("act", device)

    def infer(model, rgbs: Sequence, pcds: Sequence, *rest) -> InferOutput:
        k = len(rgbs)
        leaves = (*rgbs, *pcds, *rest)
        g = table.entry(model, graphs.storage(model), (), leaves)
        with g.lock:
            g.copy_in(leaves)
            return g.run("act", lambda *x: program(model, x[:k], x[k:2 * k], *x[2 * k:]))

    return model, infer


# ---------------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------------


class TrainState(NamedTuple):
    step: torch.Tensor                 # int64 scalar on the device
    params: Dict[str, torch.Tensor]    # parameter name -> f32 tensor
    opt_state: OptState


def make_optimizer(cfg: MethodConfig, training_iterations: int = 1_000_000) -> Optimizer:
    """LAMB (default) or Adam with the reference hyperparameters
    (qattention_peract_bc_agent.py:255-268; PERACT_BC.yaml:30-35). The
    trust-ratio leaves are set by ``make_train_step`` from its model."""
    lr = (cosine_hard_restarts_schedule(cfg.lr, cfg.num_warmup_steps, training_iterations,
                                        max(1, training_iterations // 10_000))
          if cfg.lr_scheduler else cfg.lr)
    return Optimizer(cfg.optimizer, lr, weight_decay=cfg.lambda_weight_l2)


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample cross entropy with integer labels, in f32."""
    return F.cross_entropy(logits.to(torch.float32), labels.to(torch.int64),
                           reduction="none")


def make_train_step(cfg: MethodConfig, optimizer: Optimizer, camera_names: Sequence[str],
                    low_dim_size: Optional[int] = None, *, device=None, seed: int = 0):
    """Build the BC train step. Returns ``(model, init_fn, step_fn)``.

    ``step_fn(state, batch, generator) -> (state, metrics)``: ``batch`` carries
    the replay signature (launch_utils.py:37-166): per-camera ``{cam}_rgb``
    (uint8 scale) and ``{cam}_point_cloud``, ``trans_action_indicies``,
    ``rot_grip_action_indicies``, ``ignore_collisions``, ``gripper_pose``,
    ``lang_goal_emb``, ``lang_token_embs``, ``low_dim_state``, optional
    ``target_object_scene_bounds`` / ``label`` and the ``*_left`` twins for the
    one_policy_more_heads variant. ``generator`` is a ``torch.Generator`` on
    the device (None: the device's default generator); the crop jitter, the
    augmentation candidates and the dropout seeds are drawn from it in that
    order. ``metrics`` are 0-dim tensors on the device (no host sync).
    ``model`` holds the seeded initial weights; the step reads its weights
    from ``state`` and leaves the module's own untouched.
    ``step_fn.loss_and_grads(state, batch, generator)`` gives the losses and
    the gradients without the update; with ``rows=(offset, total)`` the batch
    is the rows ``offset ..`` of a global batch of ``total`` (a data-parallel
    rank's, ``parallel.mesh``), whose ``target_object_scene_bounds`` it
    carries whole: every draw is made for the global batch and these rows
    kept, and the dropout masks are those of these rows (``mask_offset``
    overrides their offset). ``step_fn.model`` and ``step_fn.optimizer`` are
    the module and the optimizer the step runs.
    """
    from voxactb_tpu_torch.weights import leaf_groups

    device = resolve_device(device)
    model = build_encoder(cfg, low_dim_size, device=device, seed=seed)
    optimizer = optimizer.with_leaf_groups(leaf_groups(model))
    n = cfg.voxel_size
    num_rot = cfg.num_rotation_classes
    two_heads = cfg.variant == "one_policy_more_heads"
    aug_cfg = Se3AugConfig(trans_range=tuple(cfg.aug_xyz), rot_range_deg=tuple(cfg.aug_rpy),
                           rot_resolution_deg=cfg.aug_rot_resolution)

    def to_device(batch):
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if t.is_floating_point():
                t = t.to(torch.float32)
            out[k] = t.to(device)
        return out

    def forward(params, grid, low_dim, lang_emb, lang_toks, seeds, batch_offset):
        return functional_call(model, params, (grid, low_dim, lang_emb, lang_toks),
                               dict(train=True, dropout_seeds=seeds,
                                    batch_offset=batch_offset))

    def loss_fn(params, batch, bounds, generator, rows=None, batch_bounds=None,
                mask_offset=0):
        pcds = [batch[f"{c}_point_cloud"] for c in camera_names]
        rgbs = [normalize_rgb(batch[f"{c}_rgb"]) for c in camera_names]
        b = pcds[0].shape[0]

        trans_labels = batch["trans_action_indicies"][:, :3].to(torch.int32)
        rot_grip_labels = batch["rot_grip_action_indicies"].to(torch.int32)
        if two_heads:
            trans_labels_l = batch["trans_action_indicies_left"][:, :3].to(torch.int32)
            rot_grip_labels_l = batch["rot_grip_action_indicies_left"].to(torch.int32)

        with torch.no_grad(), span("vx.update.aug"):
            if cfg.apply_se3:
                aug = apply_se3_augmentation(
                    generator, pcds, batch["gripper_pose"], rot_grip_labels, bounds,
                    voxel_size=n, rot_resolution_deg=cfg.rotation_resolution, cfg=aug_cfg,
                    action_gripper_pose_left=batch.get("gripper_pose_left")
                    if two_heads else None,
                    action_rot_grip_left=rot_grip_labels_l if two_heads else None,
                    rows=rows, batch_bounds=batch_bounds)
                pcds = list(aug.pcds)
                trans_labels, rot_grip_labels = aug.trans_indices, aug.rot_grip_indices
                if two_heads:
                    trans_labels_l = aug.trans_indices_left
                    rot_grip_labels_l = aug.rot_grip_indices_left
            coords, feats = flatten_camera_observations(rgbs, pcds)
            grid = voxelize(coords, feats, bounds, voxel_size=n)

        with span("vx.update.forward"):
            # the dropout seeds are drawn before the (optionally rematerialised)
            # forward and passed in, so a recomputed forward sees the same masks
            seeds = model.draw_dropout_seeds(generator)
            args = (params, grid, batch["low_dim_state"], batch["lang_goal_emb"],
                    batch["lang_token_embs"], seeds, mask_offset)
            out = checkpoint(forward, *args, use_reentrant=False) if cfg.remat \
                else forward(*args)

            collision_labels = batch["ignore_collisions"][:, 0]

            def head_losses(trans, rot_grip, collision, t_lab, rg_lab):
                t_lab = t_lab.to(torch.int64)
                flat_label = (t_lab[:, 0] * n + t_lab[:, 1]) * n + t_lab[:, 2]
                l_trans = _ce(trans.reshape(b, -1), flat_label)
                l_rot = sum(_ce(rot_grip[:, i * num_rot:(i + 1) * num_rot], rg_lab[:, i])
                            for i in range(3))
                l_grip = _ce(rot_grip[:, 3 * num_rot:], rg_lab[:, 3])
                l_coll = _ce(collision, collision_labels)
                return l_trans, l_rot, l_grip, l_coll

            metrics = {}
            l_arm = 0.0
            if two_heads:
                right = head_losses(out["trans_right"], out["rot_grip_right"],
                                    out["collision_right"], trans_labels, rot_grip_labels)
                left = head_losses(out["trans_left"], out["rot_grip_left"],
                                   out["collision_left"], trans_labels_l, rot_grip_labels_l)
                l_trans, l_rot, l_grip, l_coll = (r + l for r, l in zip(right, left))
            else:
                l_trans, l_rot, l_grip, l_coll = head_losses(
                    out["trans"], out["rot_grip"], out["collision"], trans_labels,
                    rot_grip_labels)
                if cfg.arm_pred_loss:
                    l_arm = _ce(out["arm"], batch["label"].reshape(b))
                    metrics["arm_loss"] = l_arm.mean()

            total = (l_trans * cfg.trans_loss_weight + l_rot * cfg.rot_loss_weight
                     + l_grip * cfg.grip_loss_weight + l_coll * cfg.collision_loss_weight
                     + l_arm * cfg.arm_loss_weight).mean()
            metrics.update(total_loss=total, trans_loss=l_trans.mean(), rot_loss=l_rot.mean(),
                           grip_loss=l_grip.mean(), collision_loss=l_coll.mean())
            return total, metrics

    def loss_and_grads(state: TrainState, batch: dict, generator=None, *, rows=None,
                       mask_offset=None):
        """``(metrics, grads)`` of one batch at ``state.params``: the losses as
        0-dim tensors and ``parameter name -> gradient``."""
        with span("vx.update.h2d"):
            batch = to_device(batch)
        b = batch["trans_action_indicies"].shape[0]
        offset, total_b = rows if rows is not None else (0, b)

        # bounds: per-sample VLM-crop bounds override the static scene bounds
        # (qattention update :431-451), with optional +/-5cm crop-point jitter;
        # for the whole batch, then this call's rows
        if cfg.crop_target_obj_voxel:
            bounds = batch["target_object_scene_bounds"]
            if cfg.randomizations_crop_point:
                shift = draw_rows(lambda n: torch.rand((n, 3), generator=generator,
                                                       device=device), total_b)
                bounds = bounds + (shift * 0.1 - 0.05).repeat(1, 2)
        else:
            bounds = torch.broadcast_to(batch["scene_bounds"].reshape(-1, 6), (total_b, 6))
        batch_bounds, bounds = bounds, bounds[offset:offset + b]

        names = list(state.params)
        params = {k: state.params[k].detach().requires_grad_() for k in names}
        total, metrics = loss_fn(params, batch, bounds, generator, rows, batch_bounds,
                                 offset if mask_offset is None else mask_offset)
        with span("vx.update.backward"):
            grads = dict(zip(names, torch.autograd.grad(total, [params[k] for k in names])))
        return {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state: TrainState, batch: dict, generator=None):
        metrics, grads = loss_and_grads(state, batch, generator)
        with torch.no_grad(), span("vx.update.optim"):
            params, opt_state = optimizer.update(grads, state.opt_state, state.params)
            metrics["grad_norm"] = global_norm(grads)
        return TrainState(state.step + 1, params, opt_state), metrics

    train_step.loss_and_grads = loss_and_grads
    train_step.model = model
    train_step.optimizer = optimizer

    def init_fn() -> TrainState:
        """The model's seeded weights, zero moments, step 0."""
        params = {k: v.detach().clone() for k, v in model.named_parameters()}
        return TrainState(torch.zeros((), dtype=torch.int64, device=device), params,
                          optimizer.init(params))

    return model, init_fn, train_step
