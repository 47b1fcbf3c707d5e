"""The numbers that decide ``correct``, computed from the program's outputs
and the plain reference's.

Acts (greedy choices of a Q-network):
- ``q_err``: the widest gap between the program's softmaxed voxel Q field
  and the reference's, over the reference's largest value;
- ``gap``: the widest gap by which a choice the program served (voxel,
  three rotation bins, grip, collision flag) lies below the reference's best
  logit of its head, in units of the reference's logit spread (the trans
  field's standard deviation for the voxel, that of the rotation, grip and
  collision logits for the others);
- ``decode_err``: the widest gap between the served continuous action and
  the reference's decode of the served indices.

Training, over the first three steps and again over one late step after
the window (``late_`` numbers: its heads, its gradient and its change, the
reference started from the state the window left), leaves whose reference
gradient is under a thousandth of the median leaf's (nought but rounding,
as the trans head's bias under the softmax) left out:
- ``q_err``: as for acts, over the rows of the first step's voxel field
  (its forward with dropout, the same masks on both sides);
- ``grad_gap``: the median leaf's gap between its first gradient's norm and
  the reference's (the worst leaf is a small bias whose gradient, a sum that
  nearly cancels, carries the bf16 path's rounding: see ``PERF.md``);
- ``delta_gap``: the worst leaf's gap between its change after three steps
  and the reference's.
A leaf's gap is relative to the reference's norm of that leaf or of the
median leaf, whichever is larger. Each step's loss gap is kept among the
details and not compared: no fault or control reads far enough above the
program for a limit to fall between (``PERF.md``).
"""

from __future__ import annotations

import statistics
from typing import Dict

import torch

F32 = torch.float32


def head_gaps(ref: dict, trans_idx, rot_bins, grip, collision) -> float:
    """The widest served-choice gap of one sample's heads (see above)."""
    trans = ref["trans"].reshape(-1)
    n = ref["trans"].shape[-1]
    t = [int(v) for v in trans_idx]
    gaps = [(trans.max() - trans[(t[0] * n + t[1]) * n + t[2]]) / trans.std()]
    rgc = torch.cat([ref["rot_grip"], ref["collision"]])
    scale = rgc.std()
    nr = (ref["rot_grip"].shape[0] - 2) // 3
    heads = [(ref["rot_grip"][i * nr:(i + 1) * nr], int(rot_bins[i])) for i in range(3)]
    heads += [(ref["rot_grip"][3 * nr:], int(grip)), (ref["collision"], int(collision))]
    gaps += [(logits.max() - logits[k]) / scale for logits, k in heads]
    return float(torch.stack(gaps).max())


def choices(ref: dict):
    """The reference's own choices: ``(trans_idx, rot_bins, grip, collision)``."""
    n = ref["trans"].shape[-1]
    flat = int(torch.argmax(ref["trans"].reshape(-1)))
    nr = (ref["rot_grip"].shape[0] - 2) // 3
    rot = [int(torch.argmax(ref["rot_grip"][i * nr:(i + 1) * nr])) for i in range(3)]
    return ((flat // (n * n), (flat // n) % n, flat % n), rot,
            int(torch.argmax(ref["rot_grip"][3 * nr:])), int(torch.argmax(ref["collision"])))


def q_err(q_served: torch.Tensor, ref_trans: torch.Tensor) -> float:
    q_ref = torch.softmax(ref_trans.reshape(-1).to(F32), 0)
    return float((q_served.reshape(-1).to(F32) - q_ref).abs().max() / q_ref.max())


def fold(readings: list) -> Dict[str, float]:
    """The worst of each number over samples."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names) -> Dict[str, float]:
    """Each leaf's norm gap, relative to the reference's norm of that leaf
    or of the median leaf, whichever is larger."""
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in names}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack([tensors[k].to(F32).norm() for k in names]).cpu().tolist()
    return dict(zip(names, norms))


def moving_leaves(ref_grads: Dict[str, float]):
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    floor = 1e-3 * statistics.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= floor]


def train_readings(prog: dict, ref: dict, prefix: str = "") -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses`` (a float per step), ``grads`` and
    ``deltas`` (leaf -> norm), ``out`` (the first step's heads). The late
    step's numbers are the same, named with ``prefix``."""
    moving = moving_leaves(ref["grads"])
    rows = zip(prog["out"]["trans"], ref["out"]["trans"])
    return {
        prefix + "q_err": max(q_err(torch.softmax(p.reshape(-1), 0), r) for p, r in rows),
        prefix + "grad_gap": statistics.median(
            leaf_gaps(prog["grads"], ref["grads"], moving).values()),
        prefix + "delta_gap": max(leaf_gaps(prog["deltas"], ref["deltas"], moving).values()),
    }


def train_details(prog: dict, ref: dict, top: int = 5) -> dict:
    """What the train numbers are made of: each step's loss gap, the leaves
    left out, and for each norm the median and the worst leaves (name, gap,
    norm over the median leaf's)."""
    moving = moving_leaves(ref["grads"])
    out = {"loss_gaps": [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])],
           "left_out": sorted(set(ref["grads"]) - set(moving))}
    for key in ("grads", "deltas"):
        gaps = leaf_gaps(prog[key], ref[key], moving)
        med = statistics.median(ref[key][k] for k in moving)
        worst = sorted(gaps, key=gaps.get, reverse=True)[:top]
        out[key] = {"median_gap": statistics.median(gaps.values()),
                    "worst": [[k, gaps[k], ref[key][k] / med] for k in worst]}
    return out
