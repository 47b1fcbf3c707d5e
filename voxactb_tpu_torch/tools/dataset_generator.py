"""Record scripted bimanual demos from the sim benchmark into the on-disk format.

Counterpart of RLBench/tools/dataset_generator_two_robots.py:1-496: per task x
variation, roll the scripted demo and write
``<root>/<task>/variation<v>/episodes/episode<i>/`` with ``low_dim_obs.pkl``,
``variation_descriptions.pkl`` and per-camera image folders. RGB is PNG; point clouds
are stored directly as ``<cam>_pcd/<i>.npy`` (a documented extension — the kinematic
renderer has no pinhole depth to encode; ``DemoReader`` loads either form).

The port's counterpart of ``tools/dataset_generator.py``, on the port's sim:
the same files, byte for byte, at the same seed; the pickled frames name this
module's ``_PickleObs``. Either package's ``data/rlbench_format`` reads them.

Usage:
  python3 -m voxactb_tpu_torch.tools.dataset_generator --root build/demos \\
      --tasks open_jar open_drawer --episodes 10 --image-size 32
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment
from voxactb_tpu_torch.sim.tasks import TASK_REGISTRY


class _PickleObs:
    """Plain-attribute snapshot of a frame (image arrays stripped to folders)."""


def write_episode(ep_dir: str, frames, descriptions, cameras) -> None:
    from PIL import Image

    os.makedirs(ep_dir, exist_ok=True)
    light = []
    for i, f in enumerate(frames):
        o = _PickleObs()
        for k, v in vars(f).items():
            if any(k == f"{c}_rgb" or k == f"{c}_point_cloud" for c in cameras):
                continue
            setattr(o, k, v)
        light.append(o)
        for cam in cameras:
            rgb_dir = os.path.join(ep_dir, f"{cam}_rgb")
            pcd_dir = os.path.join(ep_dir, f"{cam}_pcd")
            os.makedirs(rgb_dir, exist_ok=True)
            os.makedirs(pcd_dir, exist_ok=True)
            Image.fromarray(getattr(f, f"{cam}_rgb")).save(
                os.path.join(rgb_dir, f"{i}.png"))
            np.save(os.path.join(pcd_dir, f"{i}.npy"),
                    getattr(f, f"{cam}_point_cloud").astype(np.float32))

    with open(os.path.join(ep_dir, "low_dim_obs.pkl"), "wb") as fh:
        pickle.dump(light, fh)
    with open(os.path.join(ep_dir, "variation_descriptions.pkl"), "wb") as fh:
        pickle.dump(list(descriptions), fh)


def generate(root: str, tasks, episodes: int, image_size: int, seed: int = 0,
             cameras=("wrist", "wrist2")) -> int:
    total = 0
    for task_name in tasks:
        env = BimanualTaskEnvironment(
            TASK_REGISTRY[task_name], cameras=cameras, image_size=image_size,
            seed=seed)
        env.launch()
        per_variation = {}
        for ep in range(episodes):
            frames, descriptions = env.get_demo(ep)
            variation = ep % env.task.num_variations
            idx = per_variation.get(variation, 0)
            per_variation[variation] = idx + 1
            ep_dir = os.path.join(root, task_name, f"variation{variation}",
                                  "episodes", f"episode{idx}")
            write_episode(ep_dir, frames, descriptions, cameras)
            total += 1
        print(f"{task_name}: {episodes} episodes "
              f"({env.task.num_variations} variations)")
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--tasks", nargs="+", default=sorted(TASK_REGISTRY))
    ap.add_argument("--episodes", type=int, default=10)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--processes", type=int, default=1,
                    help="fan tasks out over processes "
                         "(dataset_generator_two_robots.py:36-37)")
    args = ap.parse_args(argv)
    if args.processes > 1 and len(args.tasks) > 1:
        # spawn, not fork: the parent may already hold torch's thread pools,
        # and fork-after-threads deadlocks
        import multiprocessing

        mp = multiprocessing.get_context("spawn")
        with mp.Pool(min(args.processes, len(args.tasks))) as pool:
            counts = pool.starmap(
                generate,
                [(args.root, [t], args.episodes, args.image_size, args.seed)
                 for t in args.tasks])
        n = sum(counts)
    else:
        n = generate(args.root, args.tasks, args.episodes, args.image_size,
                     args.seed)
    print(f"wrote {n} episodes under {args.root}")
    return n


if __name__ == "__main__":
    main()
