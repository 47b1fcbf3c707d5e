"""Diff the policy's TRAINING inputs against its PROBE/EVAL inputs, keyframe by
keyframe, for one task episode.

With a train loss near 0, a policy that emits the previous keyframe's action
open-loop points at an input feature that differs between the replay's
transition (built from raw demo frames by ``data/fill_replay``) and the
observation the env hands back after stepping the discretized oracle action
(``probe_policy_open_loop``, ``runners/rollout.py``). This gives, per
keyframe along the oracle's alternation, the train-side and probe-side
proprio and, per camera, the distances between their rgb and point-cloud
tensors.

Counterpart of ``tools/probe_input_diff.py`` on the port's sim,
``data/fill_replay``, ``utils/keypoints`` and ``utils/observation``; host only
(no weights, no card). Each keyframe prints as one JSON line, with the JAX
tool's quantities: ``low_dim_state`` probe and train, and per camera tensor
``max|d|``, ``mean|d|`` and the share of elements with ``|d| > 0.05`` (or the
two shapes where they differ).

Run:  python3 -m voxactb_tpu_torch.tools.probe_input_diff --task open_jar [--episode 0]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from voxactb_tpu_torch.tools.oracle_protocol_check import continuous_from_discrete
from voxactb_tpu_torch.tools.probe_policy_open_loop import oracle_keyframes

CAMERAS = ("wrist", "wrist2")
FAR = 0.05  # |d| above which an element counts as differing


def tensor_diff(probe, train) -> dict:
    """``max|d|``, ``mean|d|`` and the share above ``FAR`` of two tensors, or
    their shapes where they differ."""
    a = np.asarray(probe, np.float32).squeeze()
    b = np.asarray(train, np.float32).squeeze()
    if a.shape != b.shape:
        return {"shape_probe": list(a.shape), "shape_train": list(b.shape)}
    d = np.abs(a - b)
    return {"max": float(d.max()), "mean": float(d.mean()), "frac": float(np.mean(d > FAR))}


def input_diff(env, episode: int, *, voxel_size: int = 50, crop_radius: float = 0.3,
               episode_length: int = 25, cameras=CAMERAS) -> list:
    """One row per keyframe of ``episode`` along the oracle's alternation:
    the train-side inputs (the demo frame at the arm's previous keyframe,
    ``extract_obs`` at t = the keyframe's index) against the probe-side ones
    (the env's observation after the oracle's earlier actions)."""
    from voxactb_tpu_torch.data.fill_replay import (discretize_keyframe,
                                                    scene_bounds_from_crop_np)
    from voxactb_tpu_torch.utils.observation import extract_obs

    cameras = list(cameras)
    frames, _ = env.get_demo(episode)
    dominant = env.dominant_arm()
    assistive = "left" if dominant == "right" else "right"
    per_arm = oracle_keyframes(frames, dominant, no_duplicate=True)

    obs = env.reset_to_demo(episode)
    crop_point = env.target_object_world_coords()
    bounds = scene_bounds_from_crop_np(crop_radius, crop_point)

    # the train-side inputs: the demo frame at the previous keyframe
    train_inputs, targets = {}, {}
    for arm, kps in per_arm.items():
        prev = 0
        for k, kp in enumerate(kps):
            mode = "dominant" if arm == dominant else "assistive"
            train_inputs[(arm, k)] = extract_obs(frames[prev], cameras, t=k,
                                                 episode_length=episode_length,
                                                 which_arm=mode)
            t_idx, rot_grip, _, _ = discretize_keyframe(
                frames[kp], frames[max(kp - 1, 0)], bounds, voxel_size, 5, arm)
            targets[(arm, k)] = (t_idx, rot_grip)
            prev = kp

    rows = []
    queues = {arm: list(kps) for arm, kps in per_arm.items()}
    kf_counter = {dominant: 0, assistive: 0}
    for step in range(episode_length):
        arm = assistive if step % 2 == 0 else dominant
        if not queues[arm]:
            if not queues[dominant] and not queues[assistive]:
                break
            continue
        kp = queues[arm].pop(0)
        k = kf_counter[arm]
        kf_counter[arm] += 1
        tr_in = train_inputs[(arm, k)]
        row = {"step": step, "arm": arm,
               "role": "dominant" if arm == dominant else "assistive", "kf": k,
               "demo_frame": int(kp),
               "low_dim_state_probe": np.asarray(obs["low_dim_state"], np.float32).tolist(),
               "low_dim_state_train": np.asarray(tr_in["low_dim_state"],
                                                 np.float32).tolist()}
        for cam in cameras:
            for kind in ("rgb", "point_cloud"):
                row[f"{cam}_{kind}"] = tensor_diff(obs[f"{cam}_{kind}"],
                                                   tr_in[f"{cam}_{kind}"])
        rows.append(row)
        t_idx, rot_grip = targets[(arm, k)]
        action = continuous_from_discrete(t_idx, rot_grip, bounds, voxel_size, 5)
        tr = env.step(action, arm)
        obs = dict(tr.observation)
        if tr.terminal:
            break
    return rows


def main(argv=None, device=None) -> list:
    from voxactb_tpu_torch.device import resolve_device
    from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment
    from voxactb_tpu_torch.sim.tasks import TASK_REGISTRY

    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="open_drawer")
    ap.add_argument("--episode", type=int, default=0)
    ap.add_argument("--voxel-size", type=int, default=50)
    ap.add_argument("--crop-radius", type=float, default=0.3)
    ap.add_argument("--episode-length", type=int, default=25)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(device or args.device)  # a host tool: the rule, not the card

    env = BimanualTaskEnvironment(TASK_REGISTRY[args.task], cameras=list(CAMERAS),
                                  image_size=32, episode_length=args.episode_length,
                                  seed=43)
    rows = input_diff(env, args.episode, voxel_size=args.voxel_size,
                      crop_radius=args.crop_radius, episode_length=args.episode_length)
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
