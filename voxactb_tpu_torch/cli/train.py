"""BC training entry point.

Counterpart of peract/train.py:28-109 + run_seed_fn.py:26-174: assemble config from
``key=value`` overrides (hydra-style), snapshot it into the seed directory, fill the
replay from stored demos, build the agent, run the offline train loop on one CUDA
device (``device``: cuda unless the caller passes ``"cpu"``; it raises without
CUDA). Checkpoints are ``weights/<step>/QAttentionAgent_layer0.pt``; a run resumes
from its last one, or from a JAX run's ``.msgpack`` of that name. The kernels
run only where the config's ``pallas_*`` flags are on (``method.pallas_front``,
``pallas_attention``, ``pallas_decoder``, ``pallas_attention_train``). With
``replay.use_disk=True`` the replay is the native mmap store at
``replay.path/seed<seed>.replay`` (``replay/native_buffer.py``; g++ builds its
library into ``build/native/`` on first use), fed by its C++ batch sampler.

Usage:
  python -m voxactb_tpu_torch.cli.train rlbench.task_name=open_jar \\
      rlbench.demo_path=/data/demos method.which_arm=dominant \\
      method.crop_target_obj_voxel=true method.crop_radius=0.3 \\
      method.compute_dtype=bfloat16 method.pallas_attention_train=true \\
      framework.training_iterations=100000 log_dir=/tmp/run1
"""

from __future__ import annotations

import ast
import logging
import os
import sys

import numpy as np


def parse_overrides(argv):
    out = {}
    for arg in argv:
        if "=" not in arg:
            raise SystemExit(f"override must be key=value, got {arg!r}")
        k, v = arg.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v  # bare string
    return out


def build_replay_and_agent(cfg, lang_encoder=None, demos=None, device=None):
    """Shared setup: signature -> buffer -> fill -> agent (run_seed_fn.py:60-140).
    ``lang_encoder`` maps a description to numpy ``([1, 1024], [1, 77, 512])``."""
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.data.fill_replay import fill_multi_task_replay
    from voxactb_tpu_torch.replay import TaskUniformReplayBuffer, bc_replay_signature

    m = cfg.method
    sig = bc_replay_signature(
        cfg.rlbench.cameras, tuple(cfg.rlbench.camera_resolution),
        low_dim_size=m.proprio_width(),
        crop_target_obj_voxel=m.crop_target_obj_voxel,
        arm_pred_loss=m.arm_pred_loss,
        two_arm=m.which_arm == "both",
    )
    if cfg.replay.use_disk:
        # disk-mode replay: native mmap store (the reference's one-pickle-per-
        # transition disk mode, uniform sampling) + C++ async batch feed.
        # NOTE: the native sampler is plain-uniform over transitions, not
        # task-uniform like TaskUniformReplayBuffer — with several tasks the
        # batch composition follows per-task transition counts.
        from voxactb_tpu_torch.replay.native_buffer import NativeReplayBuffer

        if len(cfg.rlbench.tasks) > 1:
            logging.warning(
                "replay.use_disk samples uniformly over transitions, not "
                "task-uniformly: %d tasks will mix by transition count",
                len(cfg.rlbench.tasks))
        os.makedirs(cfg.replay.path, exist_ok=True)
        replay = NativeReplayBuffer(
            capacity=int(1e5), signature=sig,
            path=os.path.join(cfg.replay.path, f"seed{cfg.seed}.replay"),
            seed=cfg.seed)
    else:
        replay = TaskUniformReplayBuffer(
            capacity=int(1e5), signature=sig, seed=cfg.seed)

    if demos is None and cfg.rlbench.demo_path == "sim":
        # record scripted demos live from the built-in sim benchmark
        # (the reference's get_demos(live_demos=True) path)
        from voxactb_tpu_torch.data.rlbench_format import LoadedDemo
        from voxactb_tpu_torch.sim.environment import SimEnvironment

        sim = SimEnvironment(
            cameras=cfg.rlbench.cameras,
            image_size=cfg.rlbench.camera_resolution[0],
            episode_length=cfg.rlbench.episode_length, seed=cfg.seed)
        sim.launch()
        demos = {}
        for t in cfg.rlbench.tasks:
            env = sim.get_task(t)
            task_demos = []
            for i in range(cfg.rlbench.demos):
                frames, descriptions = env.get_demo(i)
                task_demos.append(LoadedDemo(
                    frames, descriptions, i % env.task.num_variations,
                    f"sim:{t}:{i}", dominant_arm=env.dominant_arm()))
            demos[t] = task_demos
    elif demos is None and cfg.rlbench.demo_path:
        from voxactb_tpu_torch.data.rlbench_format import DemoReader

        reader = DemoReader(cfg.rlbench.demo_path, cfg.rlbench.cameras)
        demos = {t: reader.load(t, amount=cfg.rlbench.demos)
                 for t in cfg.rlbench.tasks}
    if demos:
        from voxactb_tpu_torch.data.fill_replay import reference_split_arm_fn
        from voxactb_tpu_torch.utils.keypoints import KeypointConfig

        # dominant arm: per-demo ground truth when the source recorded it, else the
        # reference's half-split convention by demo index (launch_utils.py:542-560)
        demo_index = {}
        for demo_list in demos.values():
            for i, d in enumerate(demo_list):
                demo_index[id(d)] = (i, len(demo_list))

        def arm_fn(d):
            known = getattr(d, "dominant_arm", None)
            if known:
                return known
            i, n_total = demo_index.get(id(d), (0, 1))
            return reference_split_arm_fn(n_total)(i)

        kcfg = KeypointConfig(
            saved_every_last_inserted=m.saved_every_last_inserted,
            use_default_stopped_buffer_timesteps=(
                m.use_default_stopped_buffer_timesteps),
            stopped_buffer_timesteps_overwrite=(
                m.stopped_buffer_timesteps_overwrite),
            no_duplicate=m.keypoint_discovery_no_duplicate,
        )
        counts = fill_multi_task_replay(
            replay, demos,
            cameras=cfg.rlbench.cameras,
            scene_bounds=cfg.rlbench.scene_bounds,
            voxel_size=m.voxel_size,
            rotation_resolution=m.rotation_resolution,
            which_arm=m.which_arm,
            lang_encoder=lang_encoder,
            keypoint_cfg=kcfg,
            dominant_assistive_arm_fn=arm_fn,
            demo_augmentation=m.demo_augmentation,
            demo_augmentation_every_n=m.demo_augmentation_every_n,
            crop_target_obj_voxel=m.crop_target_obj_voxel,
            crop_radius=m.crop_radius,
            arm_pred_loss=m.arm_pred_loss,
            arm_id_to_proprio=m.arm_id_to_proprio,
            arm_pred_input=m.arm_pred_input,
            episode_length=cfg.rlbench.episode_length,
        )
        logging.info("replay filled: %s", counts)

    agent = QAttentionBCAgent(
        cfg.method, cfg.rlbench.cameras, cfg.rlbench.scene_bounds,
        batch_size=cfg.replay.batch_size,
        training_iterations=cfg.framework.training_iterations,
        device=device,
    )
    return replay, agent


def main(argv=None, demos=None, lang_encoder=None, device=None):
    """Train one seed, or loop framework.seeds of them (train.py:95-105's per-seed
    spawn collapses to a sequential loop on one device)."""
    from voxactb_tpu_torch.config import Config
    from voxactb_tpu_torch.device import resolve_device

    device = resolve_device(device)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    cfg = Config().override(**parse_overrides(argv or sys.argv[1:]))

    if cfg.framework.seeds > 1:
        out = []
        for s in range(cfg.framework.start_seed,
                       cfg.framework.start_seed + cfg.framework.seeds):
            seed_cfg = cfg.override(**{"seed": s, "framework.seeds": 1})
            out.append(_train_one(seed_cfg, demos, lang_encoder, device))
        return out
    return _train_one(cfg, demos, lang_encoder, device)


def _train_one(cfg, demos=None, lang_encoder=None, device=None):
    from voxactb_tpu_torch.replay.dataset import PrefetchIterator
    from voxactb_tpu_torch.runners.train_runner import OfflineTrainRunner

    seed_dir = os.path.join(cfg.log_dir, cfg.rlbench.task_name,
                            cfg.method.name, f"seed{cfg.seed}")
    os.makedirs(seed_dir, exist_ok=True)
    cfg.save(os.path.join(seed_dir, "config.json"))  # eval reloads this snapshot

    if lang_encoder is None:
        from voxactb_tpu_torch.models.clip_text import ClipLanguageEncoder
        from voxactb_tpu_torch.utils.bpe import SimpleTokenizer

        try:
            tokenizer = SimpleTokenizer()
        except FileNotFoundError as e:  # no CLIP BPE merge table
            logging.warning("no language encoder (%s); using zero embeddings", e)
        else:
            # errors building the tower on the device propagate: a policy
            # trained on zero embeddings would silently lose its language
            enc = ClipLanguageEncoder(tokenizer=tokenizer, device=device)

            def lang_encoder(text):  # the replay stores numpy
                return tuple(t.cpu().numpy() for t in enc.encode_text([text]))

    replay, agent = build_replay_and_agent(cfg, lang_encoder, demos, device)
    if replay.size == 0:
        raise SystemExit(
            "replay is empty — set rlbench.demo_path to a demo dataset")

    scene_bounds = np.asarray(cfg.rlbench.scene_bounds, np.float32)

    from voxactb_tpu_torch.replay.native_buffer import AsyncBatchSampler, \
        NativeReplayBuffer

    native_feed = None
    if isinstance(replay, NativeReplayBuffer):
        rows = replay.size
        if rows < cfg.replay.batch_size:
            # the C++ producers publish nothing until the store holds a batch
            replay.close()
            raise SystemExit(
                f"the disk replay holds {rows} transitions, fewer than a "
                f"batch of {cfg.replay.batch_size}: its sampler would wait forever")
        native_feed = AsyncBatchSampler(
            replay, cfg.replay.batch_size, seed=cfg.seed)

        def sample():
            batch = native_feed.next()
            batch["scene_bounds"] = scene_bounds
            return batch
    else:
        def sample():
            batch = replay.sample_transition_batch(cfg.replay.batch_size)
            batch["scene_bounds"] = scene_bounds
            return batch

    dataset = PrefetchIterator(sample, device=device)
    runner = OfflineTrainRunner(
        agent, dataset,
        logdir=seed_dir,
        weightsdir=os.path.join(seed_dir, "weights"),
        training_iterations=cfg.framework.training_iterations,
        save_freq=cfg.framework.save_freq,
        log_freq=cfg.framework.log_freq,
        num_weights_to_keep=cfg.framework.num_weights_to_keep,
        tensorboard_logging=cfg.framework.tensorboard_logging,
        csv_logging=cfg.framework.csv_logging,
        load_existing_weights=cfg.framework.load_existing_weights,
    )
    try:
        runner.start()
    finally:
        # teardown order: (1) the host prefetch thread — it is the only
        # bs_acquire caller, and bs_stop deletes the C++ Sampler, so the
        # consumer must be joined first (producers are still filling the ring
        # at this point, so a blocked acquire always wakes); (2) the C++
        # producer threads; (3) the mmap store they sample from
        dataset.close()
        if native_feed is not None:
            native_feed.close()
        if isinstance(replay, NativeReplayBuffer):
            replay.flush()
            replay.close()
    return seed_dir


if __name__ == "__main__":
    main()
