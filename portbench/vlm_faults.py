#!/usr/bin/env python3
"""Read what planted faults of the VLM cell's choices and crop read, beside
the program and the control, on the card at the cell's size.

    python3 portbench/vlm_faults.py --seeds 1,2,3 [--seconds 3]

For each seed, in one process: a run of ``samh_episode_start_b1`` with a
short window and its check (the program's readings), the control (the
reference in fp8 in the program's place, its crop at fp16), and four
faults read on the same kept units, each fault's choice or geometry put in
the program's place:

- ``worst_patch``: OWL-ViT serves the patch of its lowest logit (read by
  ``owl_gap``);
- ``iou_argmin``: SAM serves the mask of its lowest predicted IoU
  (``iou_gap``);
- ``no_downsample``: the crop's centroid and extents over the masked points
  without the 1 cm voxel downsample (``crop_err``);
- ``rounded_keys``: the voxel keys rounded instead of floored, each voxel
  shifted by half its size (``crop_err``).

One JSON line per seed, then one with each number's largest program
reading and smallest control and fault readings. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

CELL = "samh_episode_start_b1"


def crop_gap(got, want) -> float:
    import numpy as np

    return float(max(np.abs(np.asarray(got[0]) - np.asarray(want[0])).max(),
                     abs(got[1] - want[1])))


def faults(entry) -> dict:
    """The worst reading of each fault over the kept units."""
    import numpy as np
    import torch

    from portbench.entries.vlm_episode_start import spread
    from portbench.reference import sam as ref_sam

    units = entry.units("exact")
    scale = spread(torch.cat([u["ref"][3].reshape(-1) for u in units]))
    conf = entry.vlm_conf["crop"]
    half = np.float32(conf["downsample_voxel"] / 2)
    rows = []
    for u in units:
        logits, _, _, _, iou, _ = u["mine"]
        r_logits, r = u["ref"][0], u["ref"][3].reshape(-1)
        best = r_logits.max(-1).values
        worst = int(torch.argmin(logits.float().max(-1).values))
        low = int(torch.argmin(iou.reshape(-1)))
        mask, cloud, task = u["mask"], u["cloud"], u["task"]
        raw = ref_sam.crop(mask, cloud, task, {**conf, "downsample_voxel": 1e-6})
        point, radius = ref_sam.crop(mask, cloud + half, task, conf)
        rounded = (point - half if not np.array_equal(point, np.asarray(
            conf["jar_fallback"], np.float32)) else point, radius)
        rows.append({"worst_patch.owl_gap": float((best.max() - best[worst]) / spread(r_logits)),
                     "iou_argmin.iou_gap": float((r.max() - r[low]) / scale),
                     "no_downsample.crop_err": crop_gap(raw, u["want"]),
                     "rounded_keys.crop_err": crop_gap(rounded, u["want"])})
    return {k: max(row[k] for row in rows) for k in rows[0]}


def readings(seed: int, seconds: float, device: str = "cuda", overrides=None) -> dict:
    from portbench.harness import core

    ctx = core.Context(CELL, seed, seconds, False, device=device, overrides=overrides)
    record = core.run(ctx, after=lambda e: {"control": e.control(), "faults": faults(e)})
    return {"seed": seed, "program": record["checks"], **record["after"]}


def summary(rows) -> dict:
    out = {"program_max": {}, "control_min": {}, "faults_min": {}}
    for row in rows:
        for group, key, pick in (("program", "program_max", max),
                                 ("control", "control_min", min),
                                 ("faults", "faults_min", min)):
            for name, v in row[group].items():
                d = out[key]
                d[name] = v if name not in d else pick(d[name], v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        row = readings(seed, args.seconds)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": CELL, **summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
