"""Generate a synthetic bimanual demo dataset in the RLBench on-disk format.

Counterpart-in-spirit of RLBench/tools/dataset_generator_two_robots.py for
environments without CoppeliaSim: writes ``<root>/<task>/variation0/episodes/
episode<i>/`` with ``low_dim_obs.pkl``, ``variation_descriptions.pkl`` and per-camera
rgb/depth PNG folders, with kinematically plausible two-arm trajectories (approach ->
grasp -> lift) so keypoint discovery finds real keyframes.

The port's counterpart of ``tools/make_synthetic_dataset.py``: the same files,
byte for byte, at the same seed.

Usage:
  python3 -m voxactb_tpu_torch.tools.make_synthetic_dataset --root build/demos \\
      --task open_jar --episodes 3 --steps 20 --image-size 32
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from voxactb_tpu_torch.data.rlbench_format import encode_depth_rgb


class SyntheticObservation:
    """Observation2Robots-shaped container (pickled as plain attributes)."""


def make_episode(rng, steps, image_size, cameras):
    target = rng.uniform([-0.1, -0.3, 0.75], [0.5, 0.3, 1.0]).astype(np.float32)
    right0 = np.array([0.4, -0.3, 1.0], np.float32)
    left0 = np.array([0.4, 0.3, 1.0], np.float32)

    observations = []
    for i in range(steps):
        o = SyntheticObservation()
        frac = min(1.0, i / max(1, steps * 0.6))
        right = right0 + (target - right0) * frac
        moving = i < int(steps * 0.6)

        o.gripper_right_pose = np.concatenate([right, [0, 0, 0, 1]]).astype(
            np.float32)
        o.gripper_left_pose = np.concatenate([left0, [0, 0, 0, 1]]).astype(
            np.float32)
        o.gripper_right_open = 1.0 if i < int(steps * 0.7) else 0.0
        o.gripper_left_open = 1.0
        o.gripper_right_joint_positions = np.array([0.02, 0.02], np.float32)
        o.gripper_left_joint_positions = np.array([0.02, 0.02], np.float32)
        o.joint_velocities_right = np.full(7, 1.0 if moving else 0.0, np.float32)
        o.joint_velocities_left = np.full(7, 1.0, np.float32)
        o.joint_positions_right = np.zeros(7, np.float32)
        o.joint_positions_left = np.zeros(7, np.float32)
        o.ignore_collisions = 1.0
        o.target_object_pos = target
        o.auto_crop_radius = 0.25
        o.misc = {}
        for cam in cameras:
            o.misc[f"{cam}_camera_near"] = 0.1
            o.misc[f"{cam}_camera_far"] = 3.5
            o.misc[f"{cam}_camera_extrinsics"] = np.eye(4, dtype=np.float32)
            o.misc[f"{cam}_camera_intrinsics"] = np.array(
                [[-float(image_size), 0, image_size / 2],
                 [0, -float(image_size), image_size / 2],
                 [0, 0, 1]], np.float32)
        observations.append(o)
    return observations, target


class SyntheticDemo:
    def __init__(self, observations):
        self._observations = observations

    def __iter__(self):
        return iter(self._observations)

    def __len__(self):
        return len(self._observations)

    def __getitem__(self, i):
        return self._observations[i]


def write_dataset(root, task, episodes, steps, image_size, seed=0,
                  cameras=("wrist", "wrist2")):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for ep in range(episodes):
        ep_dir = os.path.join(root, task, "variation0", "episodes",
                              f"episode{ep}")
        observations, target = make_episode(rng, steps, image_size, cameras)
        for cam in cameras:
            os.makedirs(os.path.join(ep_dir, f"{cam}_rgb"), exist_ok=True)
            os.makedirs(os.path.join(ep_dir, f"{cam}_depth"), exist_ok=True)
            for i in range(steps):
                rgb = rng.integers(0, 255, (image_size, image_size, 3)).astype(
                    np.uint8)
                depth01 = rng.uniform(0.2, 0.6, (image_size, image_size)).astype(
                    np.float32)
                Image.fromarray(rgb).save(
                    os.path.join(ep_dir, f"{cam}_rgb", f"{i}.png"))
                Image.fromarray(encode_depth_rgb(depth01)).save(
                    os.path.join(ep_dir, f"{cam}_depth", f"{i}.png"))
        with open(os.path.join(ep_dir, "low_dim_obs.pkl"), "wb") as f:
            pickle.dump(SyntheticDemo(observations), f)
        with open(os.path.join(ep_dir, "variation_descriptions.pkl"), "wb") as f:
            pickle.dump([f"{task.replace('_', ' ')} with the right hand"], f)
    return os.path.join(root, task)


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--task", default="open_jar")
    p.add_argument("--episodes", type=int, default=3)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    path = write_dataset(args.root, args.task, args.episodes, args.steps,
                         args.image_size, args.seed)
    print(f"wrote {args.episodes} episodes to {path}")
    return path


if __name__ == "__main__":
    main()
