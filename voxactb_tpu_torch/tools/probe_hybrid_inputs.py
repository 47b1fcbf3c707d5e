"""Bisect a closed-loop eval failure to an input feature.

Runs the trained pair on four input variants at every keyframe along the
oracle's alternation:

  probe        the env's observation as the rollout sees it
  train        demo-frame cameras + demo proprio + per-arm keyframe time (the
               replay's view)
  cam-train    the env's proprio, the demo frame's cameras
  prop-train   the env's cameras, the demo's proprio and time

Whichever swap snaps the predictions to the oracle names the feature that
breaks closed-loop eval.

Counterpart of ``tools/probe_hybrid_inputs.py`` on the port's sim, data
path and agents (``probe_policy_open_loop.load_agent``). Each keyframe prints
as one JSON line with the JAX tool's keys: ``step``, ``arm``, ``kf`` and per
variant ``"dt=<|trans index error| summed> grip=<predicted>/<target>"``.

Run:  python3 -m voxactb_tpu_torch.tools.probe_hybrid_inputs --task open_jar \\
          --acting-dir <...> --stab-dir <...> --ckpt-step 5999 [--episodes 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from voxactb_tpu_torch.tools.oracle_protocol_check import continuous_from_discrete
from voxactb_tpu_torch.tools.probe_policy_open_loop import oracle_keyframes

VARIANTS = ("probe", "cam-train", "prop-train", "train")


def hybrid_inputs(env, acting, stab, cfg, *, episodes: int = 2,
                  episode_length: int = 25) -> list:
    """The rows of ``episodes`` episodes: per keyframe the acting arm's
    policy (``acting`` for the dominant arm, ``stab`` for the assistive one)
    on the four input variants, against the oracle's target."""
    from voxactb_tpu_torch.data.fill_replay import (discretize_keyframe,
                                                    scene_bounds_from_crop_np)
    from voxactb_tpu_torch.utils.observation import extract_obs

    voxel_size = cfg.method.voxel_sizes[0]
    rot_res = cfg.method.rotation_resolution
    nd = getattr(cfg.method, "keypoint_discovery_no_duplicate", False)
    cams = list(cfg.rlbench.cameras)
    rows = []
    for ep in range(episodes):
        frames, _ = env.get_demo(ep)
        dominant = env.dominant_arm()
        assistive = "left" if dominant == "right" else "right"
        per_arm = oracle_keyframes(frames, dominant, nd)
        obs = env.reset_to_demo(ep)
        crop_point = env.target_object_world_coords()
        bounds = scene_bounds_from_crop_np(0.3, crop_point)

        queues = {arm: list(kps) for arm, kps in per_arm.items()}
        prev_kp = {dominant: 0, assistive: 0}
        kf_counter = {dominant: 0, assistive: 0}
        print(f"\n######## episode {ep} dominant={dominant} kps={per_arm} ########")
        for step in range(episode_length):
            arm = assistive if step % 2 == 0 else dominant
            if not queues[arm]:
                if not queues[dominant] and not queues[assistive]:
                    break
                continue
            kp = queues[arm].pop(0)
            k = kf_counter[arm]
            kf_counter[arm] += 1
            mode = "dominant" if arm == dominant else "assistive"
            agent = acting if arm == dominant else stab

            t_idx, rot_grip, _, _ = discretize_keyframe(
                frames[kp], frames[max(kp - 1, 0)], bounds, voxel_size, rot_res, arm)
            action = continuous_from_discrete(t_idx, rot_grip, bounds, voxel_size, rot_res)

            # the replay's view of this keyframe
            d = extract_obs(frames[prev_kp[arm]], cams, t=k, episode_length=episode_length,
                            which_arm=mode)
            ld = np.asarray(d["low_dim_state"], np.float32)
            tch = ld[6]
            train_left = np.concatenate([ld[:3], [tch]]).astype(np.float32)
            train_right = np.concatenate([ld[3:6], [tch]]).astype(np.float32)

            cam_train = dict(obs)
            for c in cams:
                cam_train[f"{c}_rgb"] = d[f"{c}_rgb"]
                cam_train[f"{c}_point_cloud"] = d[f"{c}_point_cloud"]
            prop_train = dict(obs)
            prop_train["low_dim_state_left_arm"] = train_left
            prop_train["low_dim_state_right_arm"] = train_right
            train = dict(cam_train)
            train["low_dim_state_left_arm"] = train_left
            train["low_dim_state_right_arm"] = train_right
            variants = {"probe": dict(obs), "cam-train": cam_train,
                        "prop-train": prop_train, "train": train}

            row = {"step": step, "arm": mode, "kf": k}
            for name in VARIANTS:
                pred = agent.act(step, variants[name], deterministic=True, which_arm=arm,
                                 new_scene_bounds=np.asarray(bounds).tolist(),
                                 dominant_assitive_policy=True)
                p_t = np.asarray(pred.observation_elements["trans_action_indicies"])
                p_rg = np.asarray(pred.observation_elements["rot_grip_action_indicies"])
                row[name] = (f"dt={np.abs(p_t - t_idx).sum()} "
                             f"grip={int(p_rg[3])}/{int(rot_grip[3])}")
            print(json.dumps(row), flush=True)
            rows.append(dict(episode=ep, **row))

            prev_kp[arm] = kp
            tr = env.step(action, arm)
            obs = dict(tr.observation)
            if tr.terminal:
                break
    return rows


def main(argv=None, device=None) -> list:
    from voxactb_tpu_torch.device import resolve_device
    from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment
    from voxactb_tpu_torch.sim.tasks import TASK_REGISTRY
    from voxactb_tpu_torch.tools.probe_policy_open_loop import load_agent

    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="open_drawer")
    ap.add_argument("--acting-dir", required=True)
    ap.add_argument("--stab-dir", required=True)
    ap.add_argument("--ckpt-step", type=int, required=True)
    ap.add_argument("--episodes", type=int, default=2)
    ap.add_argument("--episode-length", type=int, default=25)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(device or args.device)

    acting, cfg = load_agent(args.acting_dir, args.ckpt_step, "acting", device)
    stab, _ = load_agent(args.stab_dir, args.ckpt_step, "stabilizing", device)
    env = BimanualTaskEnvironment(TASK_REGISTRY[args.task], cameras=list(cfg.rlbench.cameras),
                                  image_size=cfg.rlbench.camera_resolution[0],
                                  episode_length=args.episode_length, seed=43)
    return hybrid_inputs(env, acting, stab, cfg, episodes=args.episodes,
                         episode_length=args.episode_length)


if __name__ == "__main__":
    main()
