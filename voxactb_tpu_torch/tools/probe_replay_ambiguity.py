"""Detect CONFLICTING samples in a task's replay: pairs whose policy-visible
inputs are (near-)identical but whose targets differ.

``probe_replay_accuracy`` separates "the policy never learned the replay" from
"eval is off-manifold"; this probe separates the two causes of the former:
(a) capacity underfit (inputs distinct, net too small) and (b) label
ambiguity (inputs indistinguishable, the CE loss averages over conflicting
targets and exact match caps out). The input signature is what the q-net can
see: the occupied cells of the sample's point clouds binned under its own
crop bounds, plus proprio and the time channel.

Counterpart of ``tools/probe_replay_ambiguity.py``. The replay is rebuilt
through the port's ``cli/train.py::build_replay_and_agent``; the cells are
``floor((p - mins) / res)`` in f32 as the JAX tool bins them (a division, not
the model's voxelize arithmetic), so the pair counts are the JAX tool's
exactly. It needs no weights and no card; ``device`` only names where the
agent that the replay builder makes would live.

Run:  python3 -m voxactb_tpu_torch.tools.probe_replay_ambiguity --task open_jar \\
          --seed-dir eval_artifacts/open_jar/train_dominant/open_jar/PERACT_BC/seed0 \\
          [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def occupied_cells(sample: dict, cameras, scene_bounds, voxel: int):
    """The sorted flat indices of the cells of a ``voxel``^3 grid over the
    sample's crop bounds (its ``target_object_scene_bounds``, else
    ``scene_bounds``) that its cameras' points fall in, with the points in
    bounds and the bounds' largest cell size."""
    pts = np.concatenate([np.asarray(sample[f"{c}_point_cloud"], np.float32).reshape(-1, 3)
                          for c in cameras], 0)
    b = np.asarray(sample.get("target_object_scene_bounds", scene_bounds), np.float32)
    res = (b[3:] - b[:3]) / voxel
    idx = np.floor((pts - b[:3]) / res).astype(np.int64)
    ok = np.all((idx >= 0) & (idx < voxel), 1)
    flat = np.unique(idx[ok] @ np.array([voxel * voxel, voxel, 1]))
    return flat, int(ok.sum()), float(res.max())


def ambiguity(replay, cameras, scene_bounds, *, voxel: int = 50, near: float = 2.0,
              task: str = "") -> dict:
    """The probe's record for a replay: near-duplicate input pairs (at most
    ``near`` cells of symmetric difference, proprio within 0.05) and, among
    them, the pairs whose targets lie more than a cell apart in world metres
    or whose grip bits differ."""
    n = replay.size
    grids, props, metas = [], [], []
    for i in range(n):
        s = {k: v[0] for k, v in replay.gather(np.asarray([i])).items()}
        flat, in_bounds, res_m = occupied_cells(s, cameras, scene_bounds, voxel)
        grids.append(flat)
        prop = np.asarray(s["low_dim_state"], np.float32).ravel()
        props.append(prop)
        metas.append({
            "trans": np.asarray(s["trans_action_indicies"]).tolist(),
            # the world-frame target: comparable across samples whose crop
            # bounds differ (their voxel indices are crop-relative)
            "pose": np.asarray(s["gripper_pose"], np.float32)[:3],
            "res_m": res_m,
            "grip": int(np.asarray(s["rot_grip_action_indicies"]).ravel()[3]),
            "points_in_bounds": in_bounds,
        })
    conflicts, near_total = [], 0
    for i in range(n):
        for j in range(i + 1, n):
            a, b = grids[i], grids[j]
            d_occ = (len(np.setdiff1d(a, b, assume_unique=True))
                     + len(np.setdiff1d(b, a, assume_unique=True)))
            d_prop = float(np.max(np.abs(props[i] - props[j])))
            if d_occ <= near and d_prop < 0.05:
                near_total += 1
                d_m = float(np.linalg.norm(metas[i]["pose"] - metas[j]["pose"]))
                res_m = max(metas[i]["res_m"], metas[j]["res_m"])
                if d_m > res_m or metas[i]["grip"] != metas[j]["grip"]:
                    conflicts.append({
                        "i": i, "j": j, "d_occ": int(d_occ), "d_prop": round(d_prop, 4),
                        "d_target_cm": round(d_m * 100, 2),
                        "grip": f"{metas[i]['grip']}vs{metas[j]['grip']}",
                        "trans_i": metas[i]["trans"], "trans_j": metas[j]["trans"],
                    })
    points = [m["points_in_bounds"] for m in metas]
    return {
        "task": task, "samples": n,
        "near_duplicate_pairs": near_total,
        "conflicting_pairs": len(conflicts),
        "examples": conflicts[:25],
        "per_sample_points_in_bounds": {
            "min": int(min(points)), "median": int(np.median(points)),
            "max": int(max(points)),
        },
    }


def main(argv=None, device=None) -> dict:
    from voxactb_tpu_torch.cli.train import build_replay_and_agent
    from voxactb_tpu_torch.config import Config
    from voxactb_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="hand_over_item")
    ap.add_argument("--seed-dir", required=True)
    ap.add_argument("--voxel", type=int, default=50)
    ap.add_argument("--near", type=float, default=2.0,
                    help="voxel-grid L0 distance (changed cells) below which two "
                         "inputs count as indistinguishable")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(device or args.device)

    cfg = Config.load(os.path.join(args.seed_dir, "config.json"))
    replay, _ = build_replay_and_agent(cfg, device=device)
    print(f"replay rebuilt: {replay.size} samples", flush=True)
    record = ambiguity(replay, cfg.rlbench.cameras, cfg.rlbench.scene_bounds,
                       voxel=args.voxel, near=args.near, task=args.task)
    print(json.dumps(record, indent=1), flush=True)
    return record


if __name__ == "__main__":
    main()
