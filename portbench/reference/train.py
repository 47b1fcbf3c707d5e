"""The plain reference of the behaviour-cloning train step, float32.

One step: (SE(3) augmentation) -> voxelize -> Q-network with attention
dropout -> cross entropies of the voxel, the three rotation bins, the grip,
the collision flag and the arm -> LAMB. LAMB as ``optax.lamb``
(``scale_by_adam`` with b1 0.9, b2 0.999, eps 1e-6 and bias correction,
then decoupled weight decay, then the trust ratio ``||p|| / ||u||`` per leaf,
then ``-lr``); a leaf of the trust ratio is a parameter, except that each
attention's key and value projections form one leaf, as flax's fused
``to_kv`` kernel does.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from portbench.reference import prep, qnet

F32 = torch.float32
HEADS = ("trans", "rot_grip", "collision")


def leaf_groups(names: Sequence[str]) -> List[List[str]]:
    """The trust-ratio leaves: ``to_k`` with ``to_v`` of one attention, every
    other parameter alone."""
    out, seen = [], set()
    for n in names:
        if n in seen:
            continue
        if n.endswith(".to_k.weight"):
            group = [n, n[:-len(".to_k.weight")] + ".to_v.weight"]
        else:
            group = [n]
        seen.update(group)
        out.append(group)
    return out


def losses(out: dict, labels: dict, n: int, weights: dict) -> Dict[str, torch.Tensor]:
    """Per-sample cross entropies, weighted and averaged over the batch."""
    b = labels["trans"].shape[0]
    t = labels["trans"].to(torch.int64)
    flat = (t[:, 0] * n + t[:, 1]) * n + t[:, 2]
    rg = labels["rot_grip"].to(torch.int64)
    nr = (out["rot_grip"].shape[1] - 2) // 3
    ce = lambda logits, y: F.cross_entropy(logits, y, reduction="none")  # noqa: E731
    l_trans = ce(out["trans"].reshape(b, -1), flat)
    l_rot = sum(ce(out["rot_grip"][:, i * nr:(i + 1) * nr], rg[:, i]) for i in range(3))
    l_grip = ce(out["rot_grip"][:, 3 * nr:], rg[:, 3])
    l_coll = ce(out["collision"], labels["collision"].to(torch.int64))
    total = (l_trans * weights["trans"] + l_rot * weights["rot"] + l_grip * weights["grip"]
             + l_coll * weights["collision"])
    if "arm" in out:
        total = total + ce(out["arm"], labels["arm"].to(torch.int64)) * weights["arm"]
    return {"total": total.mean(), "trans": l_trans.mean()}


class Lamb:
    """``optax.lamb`` over a dictionary of float32 tensors."""

    def __init__(self, names, lr: float, weight_decay: float, b1=0.9, b2=0.999, eps=1e-6,
                 state=None):
        self.groups = leaf_groups(list(names))
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, weight_decay, b1, b2, eps
        self.count = 0
        self.mu = self.nu = None
        if state is not None:  # (count, mu, nu) of a run part way through
            count, mu, nu = state
            self.count = int(count)
            self.mu = {k: v.to(F32).clone() for k, v in mu.items()}
            self.nu = {k: v.to(F32).clone() for k, v in nu.items()}

    def step(self, params: dict, grads: dict) -> dict:
        if self.mu is None:
            self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
            self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        upd = {}
        for k, g in grads.items():
            self.mu[k] = self.b1 * self.mu[k] + (1 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1 - self.b2) * g * g
            u = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + self.eps)
            upd[k] = u + self.wd * params[k]
        new = {}
        for group in self.groups:
            pn = torch.sqrt(sum((params[k] ** 2).sum() for k in group))
            un = torch.sqrt(sum((upd[k] ** 2).sum() for k in group))
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
            for k in group:
                new[k] = params[k] - self.lr * ratio * upd[k]
        return new


def prepare(batch: dict, method: dict, cameras: Sequence[str], generator, half: bool = False):
    """The step's inputs from a batch of replay rows (tensors on the device):
    bounds, SE(3) augmentation drawn from ``generator`` exactly as the train
    step draws it, the voxel grid and the labels. ``half`` keeps only the
    first half of the batch (a planted fault)."""
    n = method["voxel_sizes"][0]
    b = batch["gripper_pose"].shape[0]
    if method["crop_target_obj_voxel"]:
        bounds = batch["target_object_scene_bounds"].to(F32)
        if method.get("randomizations_crop_point", False):
            shift = torch.rand((b, 3), generator=generator, device=bounds.device)
            bounds = bounds + (shift * 0.1 - 0.05).repeat(1, 2)
    else:
        bounds = batch["scene_bounds"].to(F32).reshape(-1, 6).expand(b, 6)
    pcds = [batch[f"{c}_point_cloud"].to(F32) for c in cameras]
    rgbs = [prep.normalize_rgb(batch[f"{c}_rgb"]) for c in cameras]
    labels = {"trans": batch["trans_action_indicies"][:, :3].to(torch.int32),
              "rot_grip": batch["rot_grip_action_indicies"].to(torch.int32),
              "collision": batch["ignore_collisions"][:, 0]}
    if method.get("arm_pred_loss"):
        labels["arm"] = batch["label"].reshape(b)
    if method["apply_se3"]:
        labels["trans"], labels["rot_grip"], pcds = prep.augment(
            generator, pcds, batch["gripper_pose"].to(F32), labels["rot_grip"][:, 3], bounds,
            n=n, resolution=method["rotation_resolution"], trans_range=method["aug_xyz"],
            rot_range_deg=method["aug_rpy"], rot_step_deg=method["aug_rot_resolution"])
    grid = prep.voxelize(*prep.flatten_cameras(rgbs, pcds), bounds, n)
    rows = slice(0, b // 2 if half else b)
    return (grid[rows], batch["low_dim_state"].to(F32)[rows],
            batch["lang_token_embs"].to(F32)[rows], {k: v[rows] for k, v in labels.items()})


def skip_steps(generator, spec: qnet.Spec, method: dict, b: int, steps: int) -> None:
    """Advance ``generator`` past ``steps`` train steps of batch ``b``: the
    same draws as ``prepare`` and ``run_steps`` take, in the same order and
    shapes, dropped."""
    dev = generator.device
    for _ in range(steps):
        if method["crop_target_obj_voxel"] and method.get("randomizations_crop_point", False):
            torch.rand((b, 3), generator=generator, device=dev)
        if method["apply_se3"]:
            for _ in range(2):
                torch.rand((prep.AUG_CANDIDATES, b, 3), generator=generator, device=dev,
                           dtype=F32)
        torch.randint(0, 1 << 32, (spec.num_dropout_seeds(),), dtype=torch.int64, device=dev,
                      generator=generator)


def run_steps(params: dict, spec: qnet.Spec, method: dict, cameras, batches, generator,
              *, precision: str = "exact", half: bool = False, frozen: bool = False,
              opt_state=None):
    """``len(batches)`` train steps from ``params``: each step's loss, the
    first step's gradients, the first step's heads (``trans``, ``rot_grip``,
    ``collision``; float32, detached) and the parameters after the last
    step. LAMB starts afresh, or from ``opt_state`` (count, mu, nu).
    The draws from ``generator`` per step are the train step's:
    augmentation, then one dropout seed per attention call. ``frozen``
    leaves the parameters as they are (a planted fault)."""
    weights = {"trans": method["trans_loss_weight"], "rot": method["rot_loss_weight"],
               "grip": method["grip_loss_weight"], "collision": method["collision_loss_weight"],
               "arm": method["arm_loss_weight"]}
    opt = Lamb(params, method["lr"], method["lambda_weight_l2"], state=opt_state)
    n = method["voxel_sizes"][0]
    step_losses, first_grads, first_out = [], None, None
    with qnet.float32_only():
        for batch in batches:
            with torch.no_grad():
                grid, low_dim, lang, labels = prepare(batch, method, cameras, generator, half)
            seeds = torch.randint(0, 1 << 32, (spec.num_dropout_seeds(),), dtype=torch.int64,
                                  device=grid.device, generator=generator)
            leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
            out = qnet.forward(leaves, spec, grid, low_dim, lang, precision=precision,
                               dropout_seeds=seeds)
            loss = losses(out, labels, n, weights)["total"]
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            step_losses.append(float(loss.detach()))
            if first_grads is None:
                first_grads = grads
                first_out = {k: out[k].detach().to(F32) for k in HEADS}
            if not frozen:
                with torch.no_grad():
                    params = opt.step(params, grads)
            del out, loss, leaves
    return step_losses, first_grads, first_out, params
