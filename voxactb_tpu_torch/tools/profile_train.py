"""Per-stage decomposition of the BC train step at the canonical 50^3 / batch-8
/ bf16 point, on the card. Times, in one process:

  full          the train step (``make_train_step``), SE(3) augmentation on
  fwd_only      voxelize + the encoder's train-mode forward, no gradient
  grad_only     the trans CE loss and its gradient, no optimizer update
  opt_only      the LAMB update alone, the parameters standing in for the
                gradients (the JAX tool's stand-in)
  vox_aug_only  SE(3) augmentation + voxelize (the data path before the encoder)

plus the A/B rows ``full_remat`` (activation checkpointing), ``full_noaug``
and ``full_flashtrain`` (K4, ``pallas_attention_train``). ``--flash-ab-only``
runs ``full`` and ``full_flashtrain`` alone: K4 against the plain attention
path. ``--bwd-split`` times the trans loss's forward and its backward alone
(``torch.autograd.grad`` on a retained graph, the JAX tool's vjp on
precomputed residuals) at depths 6, 3 and 1: the depth slope is the trunk's
backward per layer, the extrapolation to depth 0 the convolutions'.

Counterpart of ``tools/profile_train.py``. Each stage runs ``--steps`` times
in a chain between two CUDA events (wall ms per step), after a warming chain
(``compile_s``: its host seconds, library plans and allocations included),
and once more under ``torch.profiler`` (``device_ms``: the device time of
every kernel, copy and memset per step). The JAX tool's relay rules (a
scalar fetched to the host inside each timed region) have no counterpart:
CUDA events time the card. Each stage's function takes the config, the
model or train state and the batch, so it can be held to the JAX package's
on the same parameters.

Run:  python3 -m voxactb_tpu_torch.tools.profile_train [--batch 8] [--steps 8]
          [--flash-ab-only | --bwd-split] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

CAMERAS = ("wrist", "wrist2")
BASE = dict(voxel_sizes=[50], which_arm="dominant", arm_pred_loss=True,
            crop_target_obj_voxel=True, crop_radius=0.3, compute_dtype="bfloat16")
AB_ROWS = (("full", {}), ("full_remat", {"remat": True}), ("full_noaug", {"apply_se3": False}),
           ("full_flashtrain", {"pallas_attention_train": True}))
BWD_DEPTHS = (6, 3, 1)


def make_batch(cfg, cameras, b: int, img: int = 128) -> dict:
    """The JAX tool's synthetic batch: the same numpy draws in the same order
    (``default_rng(0)``)."""
    rng = np.random.default_rng(0)
    batch = {
        "trans_action_indicies": rng.integers(0, 50, (b, 3)).astype(np.int32),
        "rot_grip_action_indicies": np.concatenate(
            [rng.integers(0, 72, (b, 3)), rng.integers(0, 2, (b, 1))], -1).astype(np.int32),
        "ignore_collisions": rng.integers(0, 2, (b, 1)).astype(np.int32),
        "gripper_pose": np.concatenate(
            [rng.uniform([-0.1, -0.3, 0.6], [0.4, 0.3, 1.0], (b, 3)),
             rng.normal(size=(b, 4))], -1).astype(np.float32),
        "lang_goal_emb": rng.normal(size=(b, 1024)).astype(np.float32),
        "lang_token_embs": rng.normal(size=(b, 77, 512)).astype(np.float32),
        "low_dim_state": rng.normal(size=(b, cfg.low_dim_size())).astype(np.float32),
        "label": rng.integers(0, 2, (b, 1)).astype(np.int32),
        "scene_bounds": np.asarray([-0.3, -0.5, 0.4, 0.5, 0.5, 1.2], np.float32),
        "target_object_scene_bounds": np.tile(
            np.asarray([-0.1, -0.3, 0.5, 0.5, 0.3, 1.1], np.float32), (b, 1)),
    }
    batch["gripper_pose"][:, 3:] /= np.linalg.norm(batch["gripper_pose"][:, 3:], axis=-1,
                                                   keepdims=True)
    for c in cameras:
        batch[f"{c}_rgb"] = rng.integers(0, 255, (b, img, img, 3)).astype(np.float32)
        batch[f"{c}_point_cloud"] = rng.uniform(-0.3, 1.2, (b, img, img, 3)).astype(
            np.float32)
    return batch


def to_device(batch: dict, dev) -> dict:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def stage_batch(cfg, b: int, dev) -> dict:
    """``make_batch`` on ``dev``, its trans labels (drawn below 50) taken
    modulo the config's grid, so that a smaller grid than the canonical 50^3
    keeps them in range (at 50^3 they are the JAX tool's)."""
    batch = make_batch(cfg, CAMERAS, b)
    batch["trans_action_indicies"] %= cfg.voxel_size
    return to_device(batch, dev)


def voxel_grid(cfg, cameras, batch, pcds=None) -> torch.Tensor:
    """The batch's clouds (or ``pcds``) voxelized at its crop bounds."""
    from voxactb_tpu_torch.agents.qfunction import normalize_rgb
    from voxactb_tpu_torch.ops.voxelize import flatten_camera_observations, voxelize

    pcds = [batch[f"{c}_point_cloud"] for c in cameras] if pcds is None else pcds
    rgbs = [normalize_rgb(batch[f"{c}_rgb"]) for c in cameras]
    coords, feats = flatten_camera_observations(rgbs, pcds)
    return voxelize(coords, feats, batch["target_object_scene_bounds"],
                    voxel_size=cfg.voxel_size)


def vox_aug_only(cfg, cameras, batch, generator) -> torch.Tensor:
    """SE(3) augmentation of the clouds and actions, then voxelize: the grid."""
    from voxactb_tpu_torch.ops.augmentation import Se3AugConfig, apply_se3_augmentation

    with torch.no_grad():
        aug = apply_se3_augmentation(
            generator, [batch[f"{c}_point_cloud"] for c in cameras], batch["gripper_pose"],
            batch["rot_grip_action_indicies"].to(torch.int32),
            batch["target_object_scene_bounds"], voxel_size=cfg.voxel_size,
            rot_resolution_deg=cfg.rotation_resolution,
            cfg=Se3AugConfig(trans_range=tuple(cfg.aug_xyz),
                             rot_range_deg=tuple(cfg.aug_rpy),
                             rot_resolution_deg=cfg.aug_rot_resolution))
        return voxel_grid(cfg, cameras, batch, list(aug.pcds))


def fwd_only(cfg, cameras, model, batch, generator) -> dict:
    """Voxelize + the encoder's train-mode forward (dropout from
    ``generator``), without a gradient: the outputs."""
    with torch.no_grad():
        grid = voxel_grid(cfg, cameras, batch)
        return model(grid, batch["low_dim_state"], batch["lang_goal_emb"],
                     batch["lang_token_embs"], train=True,
                     dropout_seeds=model.draw_dropout_seeds(generator))


def trans_loss(cfg, cameras, model, batch, generator) -> torch.Tensor:
    """The JAX tool's loss: the mean CE of the trans logits against the
    trans labels, after voxelize and a train-mode forward."""
    import torch.nn.functional as F

    with torch.no_grad():
        grid = voxel_grid(cfg, cameras, batch)
    out = model(grid, batch["low_dim_state"], batch["lang_goal_emb"], batch["lang_token_embs"],
                train=True, dropout_seeds=model.draw_dropout_seeds(generator))
    n = cfg.voxel_size
    b = grid.shape[0]
    lab = batch["trans_action_indicies"].to(torch.int64)
    flat_label = (lab[:, 0] * n + lab[:, 1]) * n + lab[:, 2]
    return F.cross_entropy(out["trans"].reshape(b, -1).float(), flat_label)


def grad_only(cfg, cameras, model, batch, generator):
    """``(loss, {name: gradient})`` of ``trans_loss``, zero for the weights it
    does not reach (the rotation, grip and collision heads), as
    ``jax.value_and_grad`` gives them; no update."""
    names = [k for k, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in model.named_parameters() if p.requires_grad]
    loss = trans_loss(cfg, cameras, model, batch, generator)
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(names, grads))


def opt_only(optimizer, state):
    """One LAMB update whose gradients are the parameters themselves (the
    JAX tool's stand-in: the same tree, shapes and dtypes): the next state.
    ``optimizer`` carries the model's leaf groups (``with_leaf_groups``), as
    the train step's does."""
    from voxactb_tpu_torch.agents.qfunction import TrainState

    with torch.no_grad():
        params, opt_state = optimizer.update(state.params, state.opt_state, state.params)
    return TrainState(state.step + 1, params, opt_state)


def time_stage(name: str, fn, steps: int, dev) -> dict:
    """``fn`` (one step) timed in a chain of ``steps`` after a warming chain:
    the stage's row, printed."""
    from voxactb_tpu_torch.tools import device_ms, seconds

    def run():
        for _ in range(steps):
            fn()

    t0 = time.perf_counter()
    run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    warm = time.perf_counter() - t0
    ms = seconds(run, dev) * 1e3 / steps
    dms = device_ms(fn, steps, dev)
    row = {"stage": name, "per_step_ms": ms, "device_ms": dms, "compile_s": warm}
    print(json.dumps(row), flush=True)
    return row


def full_rows(args, dev, rows, base=BASE) -> dict:
    """The whole step of ``base`` under each A/B's flags: ``{name: row}``."""
    from voxactb_tpu_torch.agents.qfunction import make_optimizer, make_train_step
    from voxactb_tpu_torch.config import MethodConfig

    out = {}
    for name, flags in rows:
        cfg = MethodConfig(**{**base, **flags, "apply_se3": flags.get("apply_se3", True)})
        _, init_fn, step = make_train_step(cfg, make_optimizer(cfg, 100_000), CAMERAS,
                                           device=dev, seed=0)
        batch = stage_batch(cfg, args.batch, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        holder = [init_fn()]

        def one(step=step, batch=batch, gen=gen, holder=holder):
            holder[0], _ = step(holder[0], batch, gen)

        out[name] = time_stage(name, one, args.steps, dev)
        del step, init_fn, holder
    return out


def bwd_split(args, dev, base=BASE) -> dict:
    from voxactb_tpu_torch.agents.qfunction import build_encoder
    from voxactb_tpu_torch.config import MethodConfig

    results = {}
    flash = dict(pallas_attention_train=True) if getattr(args, "flash_train", False) else {}
    for depth in BWD_DEPTHS:
        cfg = MethodConfig(**{**base, **flash, "transformer_depth": depth})
        model = build_encoder(cfg, device=dev, seed=0)
        batch = stage_batch(cfg, args.batch, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        params = [p for p in model.parameters() if p.requires_grad]
        fwd = time_stage(f"fwd_depth{depth}", lambda: trans_loss(cfg, CAMERAS, model, batch,
                                                                  gen), args.steps, dev)
        # the residuals of one forward; the backward applied alone
        loss = trans_loss(cfg, CAMERAS, model, batch, torch.Generator(device=dev)
                          .manual_seed(7))
        bwd = time_stage(f"bwd_depth{depth}", lambda: torch.autograd.grad(
            loss, params, retain_graph=True, allow_unused=True), args.steps, dev)
        results[f"fwd_depth{depth}"] = fwd["per_step_ms"]
        results[f"bwd_depth{depth}"] = bwd["per_step_ms"]
        results[f"fwd_depth{depth}_device_ms"] = fwd["device_ms"]
        results[f"bwd_depth{depth}_device_ms"] = bwd["device_ms"]
        del model, loss, params
    d6, d3, d1 = (results[f"bwd_depth{d}"] for d in BWD_DEPTHS)
    per_layer = (d6 - d1) / 5.0
    results.update(bwd_attn_mlp_per_layer_ms=per_layer, bwd_trunk6_ms=per_layer * 6,
                   bwd_conv_front_decoder_ms=d1 - per_layer,
                   bwd_fwd_ratio_depth6=d6 / max(results["fwd_depth6"], 1e-9))
    return results


def main(argv=None, device=None) -> dict:
    from voxactb_tpu_torch.agents.qfunction import make_optimizer, make_train_step
    from voxactb_tpu_torch.config import MethodConfig
    from voxactb_tpu_torch.device import resolve_device
    from voxactb_tpu_torch.tools import device_line
    from voxactb_tpu_torch.weights import leaf_groups

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--flash-ab-only", action="store_true",
                    help="run only the full vs full_flashtrain paired A/B")
    ap.add_argument("--bwd-split", action="store_true",
                    help="the trans loss's forward and its backward alone at "
                         "transformer depths 6/3/1")
    ap.add_argument("--flash-train", action="store_true",
                    help="with --bwd-split: the trainable attention kernel (K4) in place of "
                         "the plain attention path the JAX tool's split takes")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(device or args.device)
    print(json.dumps(device_line(dev)), flush=True)

    if args.bwd_split:
        results = bwd_split(args, dev)
        print(json.dumps({"bwd_split": results}), flush=True)
        return {"bwd_split": results}

    rows = AB_ROWS[::3] if args.flash_ab_only else AB_ROWS
    full = full_rows(args, dev, rows)
    results = {name: row["per_step_ms"] for name, row in full.items()}
    device_results = {name: row["device_ms"] for name, row in full.items()}
    if not args.flash_ab_only:
        cfg = MethodConfig(**BASE, apply_se3=True)
        model, init_fn, _ = make_train_step(cfg, make_optimizer(cfg, 100_000), CAMERAS,
                                            device=dev, seed=0)
        optimizer = make_optimizer(cfg, 100_000).with_leaf_groups(leaf_groups(model))
        batch = stage_batch(cfg, args.batch, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        holder = [init_fn()]

        def opt_step():
            holder[0] = opt_only(optimizer, holder[0])

        for name, fn in (("vox_aug_only", lambda: vox_aug_only(cfg, CAMERAS, batch, gen)),
                         ("fwd_only", lambda: fwd_only(cfg, CAMERAS, model, batch, gen)),
                         ("grad_only", lambda: grad_only(cfg, CAMERAS, model, batch, gen)),
                         ("opt_only", opt_step)):
            row = time_stage(name, fn, args.steps, dev)
            results[name] = row["per_step_ms"]
            device_results[name] = row["device_ms"]
    record = {"all": results, "device_ms": device_results, **device_line(dev)}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
