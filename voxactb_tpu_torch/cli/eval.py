"""Checkpoint evaluation entry point.

Counterpart of peract/eval.py:269-373 + eval_seed :39-267: reload the per-seed config
snapshot, rebuild the acting agent (and optionally an independently-checkpointed
stabilizing agent, conf/eval.yaml ``framework.left_arm_ckpt``), sweep checkpoints per
``framework.eval_type`` and write eval CSVs. The agents run on one CUDA device
(``device``: cuda unless the caller passes ``"cpu"``; it raises without CUDA).
Checkpoints are the ``.pt`` files ``cli.train`` writes; a JAX run's seed
directory (``.msgpack`` checkpoints, ``config.json``) evaluates unchanged, and
``framework.left_arm_ckpt`` may name a ``.msgpack`` file.

Usage:
  python -m voxactb_tpu_torch.cli.eval seed_dir=/tmp/run1/open_jar/PERACT_BC/seed0 \\
      framework.eval_type=missing framework.eval_episodes=25 \\
      framework.left_arm_ckpt=/path/weights/5/QAttentionAgent_layer0.pt
"""

from __future__ import annotations

import logging
import os
import sys

from voxactb_tpu_torch.cli.train import parse_overrides


def make_env(cfg, env=None):
    """Environment factory: a provided env; a built-in sim benchmark task when the
    task name is registered (the port's registry holds the JAX package's
    names); else the synthetic fake env."""
    if env is not None:
        return env
    from voxactb_tpu_torch.sim.tasks import TASK_REGISTRY

    if cfg.rlbench.task_name in TASK_REGISTRY:
        from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment

        return BimanualTaskEnvironment(
            TASK_REGISTRY[cfg.rlbench.task_name],
            cameras=cfg.rlbench.cameras,
            image_size=cfg.rlbench.camera_resolution[0],
            episode_length=cfg.rlbench.episode_length,
            seed=cfg.seed,
        )
    from voxactb_tpu_torch.envs.fake_env import FakeBimanualEnv

    return FakeBimanualEnv(
        cameras=cfg.rlbench.cameras,
        image_size=cfg.rlbench.camera_resolution[0],
        episode_length=cfg.rlbench.episode_length,
        seed=cfg.seed,
        task_name=cfg.rlbench.task_name,
    )


def main(argv=None, env=None, device=None):
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.config import Config
    from voxactb_tpu_torch.device import resolve_device
    from voxactb_tpu_torch.runners.eval_runner import EvalRunner

    device = resolve_device(device)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    overrides = parse_overrides(argv or sys.argv[1:])
    seed_dir = overrides.pop("seed_dir", None)
    if not seed_dir:
        raise SystemExit("need seed_dir=<path written by cli.train>")

    # reload the training snapshot, then apply eval-time overrides
    # (eval.py:279-284 behavior)
    cfg = Config.load(os.path.join(seed_dir, "config.json")).override(**overrides)

    acting = QAttentionBCAgent(
        cfg.method, cfg.rlbench.cameras, cfg.rlbench.scene_bounds, device=device)
    left_agent = None
    if cfg.framework.left_arm_ckpt:
        left_cfg = cfg.method
        if cfg.framework.left_arm_train_cfg:
            left_cfg = Config.load(cfg.framework.left_arm_train_cfg).method
        left_agent = QAttentionBCAgent(
            left_cfg, cfg.rlbench.cameras, cfg.rlbench.scene_bounds, device=device)
    elif cfg.method.which_arm in ("dominant", "assistive"):
        logging.warning(
            "dominant_assistive eval without framework.left_arm_ckpt — using an "
            "untrained stabilizing policy")
        left_agent = QAttentionBCAgent(
            cfg.method, cfg.rlbench.cameras, cfg.rlbench.scene_bounds,
            device=device)

    runner = EvalRunner(
        make_env(cfg, env), acting,
        weightsdir=os.path.join(seed_dir, "weights"),
        logdir=seed_dir,
        left_arm_agent=left_agent,
        left_arm_ckpt=cfg.framework.left_arm_ckpt,
        eval_episodes=cfg.framework.eval_episodes,
        episode_length=cfg.rlbench.episode_length,
        which_arm=("dominant_assistive"
                   if cfg.method.which_arm in ("dominant", "assistive")
                   else cfg.method.which_arm),
        crop_target_obj_voxel=cfg.method.crop_target_obj_voxel,
        crop_radius=(float(cfg.method.crop_radius)
                     if isinstance(cfg.method.crop_radius, (int, float))
                     and not isinstance(cfg.method.crop_radius, bool)
                     else 0.3),
        auto_crop=cfg.method.crop_radius == "auto",
        eval_from_eps_number=cfg.framework.eval_from_eps_number,
    )
    results = runner.start(cfg.framework.eval_type)
    for row in results:
        logging.info("eval: %s", row)
    return results


if __name__ == "__main__":
    main()
