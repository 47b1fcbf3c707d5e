"""The check shared by the act entries: the plain reference run over a
sample of the acts the window served, in blocks, and the numbers of
``compare`` taken from it; and the control, the reference computed in fp8,
read the same way."""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from portbench.harness import compare
from portbench.reference import prep, qnet


class Served(NamedTuple):
    """One act as the program served it, with the inputs that produced it."""

    role: str
    rgbs: list            # per camera [H, W, 3]
    pcds: list            # per camera [H, W, 3]
    bounds: np.ndarray    # [6]
    proprio: np.ndarray   # [low_dim]
    tokens: np.ndarray    # [77, 512]
    trans_idx: np.ndarray  # [3]
    rot_grip: np.ndarray  # [4]
    action: np.ndarray    # [9]
    q: torch.Tensor       # [N, N, N] softmaxed Q, on the device


def reference(params: Dict[str, torch.Tensor], spec: qnet.Spec, items: List[Served],
              device, precision: str = "exact", block: int = 4) -> List[dict]:
    """The reference's logits for each item (all of one role), on the device."""
    out = []
    with torch.no_grad(), qnet.float32_only():
        for i in range(0, len(items), block):
            part = items[i:i + block]
            t = lambda xs: torch.as_tensor(np.stack(xs), dtype=torch.float32,  # noqa: E731
                                           device=device)
            rgbs = [prep.normalize_rgb(t([it.rgbs[c] for it in part]))
                    for c in range(len(part[0].rgbs))]
            pcds = [t([it.pcds[c] for it in part]) for c in range(len(part[0].pcds))]
            grid = prep.voxelize(*prep.flatten_cameras(rgbs, pcds),
                                 t([it.bounds for it in part]), spec.voxel_size)
            logits = qnet.forward(params, spec, grid, t([it.proprio for it in part]),
                                  t([it.tokens for it in part]), precision=precision)
            for j in range(len(part)):
                out.append({k: v[j] for k, v in logits.items()})
            del grid, logits
    return out


def served_readings(ref: dict, item: Served, resolution: float) -> Dict[str, float]:
    n = ref["trans"].shape[-1]
    dev = ref["trans"].device
    rg = item.rot_grip
    collision = int(round(float(item.action[8])))
    decoded = prep.decode_action(
        torch.as_tensor(item.trans_idx, device=dev), torch.as_tensor(rg[:3], device=dev),
        torch.as_tensor(rg[3], device=dev), torch.as_tensor(collision, device=dev), n,
        torch.as_tensor(item.bounds, device=dev), resolution)
    served = torch.as_tensor(item.action, dtype=torch.float32, device=dev)
    return {"q_err": compare.q_err(item.q, ref["trans"]),
            "gap": compare.head_gaps(ref, item.trans_idx, rg[:3], rg[3], collision),
            "decode_err": float((decoded - served).abs().max())}


def control_readings(ref: dict, ctrl: dict) -> Dict[str, float]:
    """The control's numbers: its softmaxed Q field and its own choices,
    read against the float32 reference."""
    t, rot, grip, coll = compare.choices(ctrl)
    return {"q_err": compare.q_err(torch.softmax(ctrl["trans"].reshape(-1), 0), ref["trans"]),
            "gap": compare.head_gaps(ref, t, rot, grip, coll)}


def check(params_by_role, specs, items: List[Served], device, resolution: float,
          control: bool = False) -> Dict[str, float]:
    """The worst of each number over ``items``: the program's, or with
    ``control`` the fp8 reference's in its place."""
    readings = []
    for role in sorted({it.role for it in items}):
        mine = [it for it in items if it.role == role]
        refs = reference(params_by_role[role], specs[role], mine, device)
        if control:
            ctrls = reference(params_by_role[role], specs[role], mine, device, "fp8")
            readings += [control_readings(r, c) for r, c in zip(refs, ctrls)]
        else:
            readings += [served_readings(r, it, resolution) for r, it in zip(refs, mine)]
    return compare.fold(readings)
