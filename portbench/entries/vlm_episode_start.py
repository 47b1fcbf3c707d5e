"""Entry ``vlm_episode_start``: VoxAct-B's episode start at batch 1, the VLM
crop then the acting policy's first act inside it.

A unit, timed on the host as one latency (what the robot waits for its
first action): one observation's front frame through
``VLM.get_target_object_world_coords`` (OWL-ViT's box for the task's query,
SAM's mask for it, the crop geometry on the card), the crop's scene bounds
(``scene_bounds_from_crop``), then the acting policy's ``act`` inside them
and its action on the host. The detector is built by
``TorchOwlVitSamDetector.build`` from the configuration's ``vlm`` group
(widths, compute dtype, K7's flags), its weights drawn by
``reference/vlm_params.draw_vlm_params``; the policy as ``agent_act``'s.

The check, on a sample of the window's units, holds what the timed path
produced to the plain reference at the configuration's widths (see
``check``); the control is the reference computed in fp8 in the program's
place, read the same way.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench.harness import acts, compare, flops, vlm_flops, vlm_frames
from portbench.harness.core import RunError, reservoir_keep, sub_seed
from portbench.reference import owlvit as ref_owl
from portbench.reference import qnet
from portbench.reference import sam as ref_sam
from portbench.reference.qnet import draw_params
from portbench.reference.vlm_params import draw_vlm_params, tower

TOWERS = ("owl", "owl_text", "sam", "decoder")
KEPT = ("owl_logits", "box", "patch", "embedding", "masks", "iou", "index", "mask_logits")
# read and printed, not compared (PERF.md §2): over 14 seeds the program read up
# to 0.098 and the control from 0.121, too close for a limit between
DETAILS = ("iou_err",)


def proprio_of(obs: dict, mode: str) -> np.ndarray:
    """The proprio vector the policy consumes (as ``agent_act``'s)."""
    if mode == "dominant_assistive":
        return np.concatenate([obs["low_dim_state_left_arm"][:3],
                               obs["low_dim_state_right_arm"]]).astype(np.float32)
    return np.asarray(obs["low_dim_state"], np.float32)


def spread(x: torch.Tensor) -> torch.Tensor:
    return x.float().std().clamp(min=1e-12)


class Entry:
    def __init__(self, ctx):
        from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
        from voxactb_tpu_torch.config import MethodConfig
        from voxactb_tpu_torch.vlm import pipeline

        if not hasattr(pipeline.TorchOwlVitSamDetector, "build"):
            raise RunError("the program has no TorchOwlVitSamDetector.build")
        ctx.mark("port")
        self.ctx = ctx
        dev = ctx.device
        conf = ctx.config
        vlm = {**conf["vlm"], **ctx.cell.get("vlm", {})}  # the cell's keys: tests only
        self.vlm_conf = vlm
        self.spec = {k: vlm[k] for k in TOWERS}
        gen = torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed, 20))
        self.vlm_params = draw_vlm_params(self.spec, gen, dev)
        self.detector = pipeline.TorchOwlVitSamDetector.build(
            self.spec, dtype=getattr(torch, vlm["compute_dtype"]),
            fused_global=vlm["fused_global"], fused_windowed=vlm["fused_windowed"],
            device=dev, params=self.vlm_params, score_threshold=vlm["score_threshold"])
        self.vlm = pipeline.VLM(self.detector, downsample_voxel=vlm["crop"]["downsample_voxel"])
        self.queries = pipeline.task_queries

        self.cameras = conf["cameras"]
        self.role = ctx.cell["policies"][0]
        cfg = MethodConfig(**ctx.method(self.role))
        self.policy_spec = ctx.spec(self.role)
        gen = torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed, 10))
        self.params = {self.role: draw_params(self.policy_spec, gen, dev)}
        agent = QAttentionBCAgent(cfg, self.cameras, conf["scene_bounds"], device=dev)
        agent.build(training=False)
        agent.params = self.params[self.role]
        self.agent = agent
        pol = conf["policies"][self.role]
        self.kwargs = pol.get("act_kwargs", {})
        self.proprio = pol.get("proprio", "low_dim_state")
        ctx.mark("weights_agents")
        self.pool = vlm_frames.observations(ctx.traffic, ctx.rng(1), self.cameras,
                                            ctx.low_dim_size(self.role))
        ctx.mark("traffic")
        self.resolution = ctx.method(self.role)["rotation_resolution"]
        self.n = self.policy_spec.voxel_size
        self.sample_rng = ctx.rng(2)
        self.k = int(ctx.cell["check_samples"])
        self.kept, self.seen, self.failed, self.i = [], 0, 0, 0
        self.launches = None

    def warm(self):
        for _ in range(int(self.ctx.cell["warm_units"])):
            self.unit(window=False)
        from voxactb_tpu_torch.ops import cuda

        self.launches = (cuda.launch_counts().get("sam_attention", 0), self.i)

    def sync(self):
        if torch.device(self.ctx.device).type == "cuda":
            torch.cuda.synchronize()

    def unit(self, window: bool):
        from voxactb_tpu_torch.ops.geometry import scene_bounds_from_crop

        j = self.i % len(self.pool)
        obs = self.pool[j]
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.vlm_start"):
            point, radius = self.vlm.get_target_object_world_coords(
                obs["front_rgb"], obs["front_point_cloud"], obs["task"])
            bounds = scene_bounds_from_crop(point, radius).numpy()
            res = self.agent.act(self.i, obs, new_scene_bounds=bounds, **self.kwargs)
            action = np.asarray(res.action)
        latency = time.perf_counter() - t0
        self.i += 1
        if window:
            self.seen += 1
            self.failed += int(not np.isfinite(action).all())
            last = {k: self.detector.last[k] for k in KEPT}
            reservoir_keep(self.sample_rng, self.kept, (j, last, point, radius, bounds, res),
                           self.seen, self.k)
        return 1, latency

    def flops_per_unit(self) -> float:
        return vlm_flops.pass_flops(self.spec) + flops.forward_flops(self.policy_spec, 1)

    def window_extras(self) -> dict:
        return {"failed": self.failed}

    def trace_extras(self, rec: dict) -> dict:
        return {"samples": rec["units"],
                "k7_bound_s": rec["units"] * vlm_flops.k7_pass_bound_s(self.spec["sam"]),
                "k3_bound_s": rec["units"] * flops.k3_call_bound_s(self.policy_spec, 1)}

    def release(self):
        from voxactb_tpu_torch.ops import cuda

        if self.launches is not None and self.i > self.launches[1]:
            per = (cuda.launch_counts().get("sam_attention", 0) - self.launches[0]) / (
                self.i - self.launches[1])
            print(f"K7 launches per unit after the warm-up: {per:g}", file=sys.stderr,
                  flush=True)
        self.agent = self.detector = self.vlm = None

    # -- the check -------------------------------------------------------------------

    def _ids(self, query: str) -> torch.Tensor:
        from voxactb_tpu_torch.utils.bpe import SimpleTokenizer

        ctx_len = self.spec["owl_text"]["context_length"]
        return torch.as_tensor(SimpleTokenizer().tokenize([query], context_length=ctx_len),
                               device=self.ctx.device)

    def units(self, precision: str) -> list:
        """Per kept unit, what was served against the reference: ``mine``
        (OWL's logits and served patch, SAM's embedding, mask logits, IoU
        predictions and chosen index), ``ref`` (the reference's logits,
        embedding, mask logits and IoU, its decoder fed the served box), the
        crop ``got`` and ``want``, and the chosen ``mask``, ``cloud`` and
        ``task`` they come from. ``precision`` ``exact``: the program served,
        its crop against the reference geometry on its mask; ``fp8``: the fp8
        reference served in its place, its own choices, and its crop the
        reference geometry at ``fp16`` on its own mask."""
        p, dev = self.vlm_params, self.ctx.device
        img = self.spec["sam"]["img_size"]
        conf = self.vlm_conf["crop"]
        queries = {}
        units = []
        with torch.no_grad(), qnet.float32_only():
            for j, served, point, radius, _, _ in self.kept:
                obs = self.pool[j]
                task, cloud = obs["task"], obs["front_point_cloud"]
                query = self.queries(task)
                if query not in queries:
                    queries[query] = ref_owl.embed_text(tower(p, "owl_text."),
                                                        self.spec["owl_text"], self._ids(query))
                rgb = torch.as_tensor(obs["front_rgb"], device=dev)
                logits, _ = ref_owl.detect(tower(p, "owl."), self.spec["owl"], rgb,
                                           queries[query])
                emb = ref_sam.encode(tower(p, "sam."), self.spec["sam"], rgb)
                box = torch.as_tensor(ref_sam.box_prompt(served["box"], rgb.shape[:2], img),
                                      device=dev)
                masks, iou = ref_sam.decode(tower(p, "decoder."), self.spec["decoder"], emb, box)
                if precision == "exact":
                    mine = (served["owl_logits"], served["patch"], served["embedding"],
                            served["masks"], served["iou"], int(served["index"]))
                    mask = ref_sam.chosen_pixels(served["mask_logits"].cpu().numpy())
                    got = (point, radius)
                else:  # the fp8 reference served, its own choices and crop
                    c_logits, _ = ref_owl.detect(tower(p, "owl."), self.spec["owl"], rgb,
                                                 queries[query], "fp8")
                    c_emb = ref_sam.encode(tower(p, "sam."), self.spec["sam"], rgb, "fp8")
                    c_masks, c_iou = ref_sam.decode(tower(p, "decoder."), self.spec["decoder"],
                                                    c_emb, box, "fp8")
                    c_index = int(torch.argmax(c_iou[0]))
                    mine = (c_logits, int(torch.argmax(c_logits.max(-1).values)), c_emb,
                            c_masks, c_iou, c_index)
                    mask = ref_sam.chosen_pixels(ref_sam.frame_logits(
                        c_masks, c_index, rgb.shape[:2], img).cpu().numpy())
                    got = ref_sam.crop(mask, cloud, task, conf, "fp16")
                units.append(dict(mine=mine, ref=(logits, emb, masks, iou), got=got,
                                  want=ref_sam.crop(mask, cloud, task, conf), mask=mask,
                                  cloud=cloud, task=task))
        return units

    def _readings(self, precision: str) -> dict:
        """The worst of each number over the kept units (``vlm_readings``),
        the IoU numbers over the spread of the reference's IoU predictions
        of all of them."""
        units = self.units(precision)
        scale = spread(torch.cat([u["ref"][3].reshape(-1) for u in units]))
        return compare.fold([vlm_readings(u["mine"], u["ref"], u["got"], u["want"], scale)
                             for u in units])

    def _items(self):
        items = []
        for j, _, _, _, bounds, res in self.kept:
            obs = self.pool[j]
            el = res.observation_elements
            items.append(acts.Served(
                self.role, [obs[f"{c}_rgb"] for c in self.cameras],
                [obs[f"{c}_point_cloud"] for c in self.cameras], bounds,
                proprio_of(obs, self.proprio), obs["lang_token_embs"],
                np.asarray(el["trans_action_indicies"]), np.asarray(el["rot_grip_action_indicies"]),
                np.asarray(res.action), res.info["q_depth0"].reshape((self.n,) * 3)))
        return items

    def check(self) -> dict:
        out = self._readings("exact")
        for name in DETAILS:  # not compared: no limit separates the program from the control
            print(f"detail {name} {out.pop(name)!r}", file=sys.stderr, flush=True)
        out.update(acts.check(self.params, {self.role: self.policy_spec}, self._items(),
                              self.ctx.device, self.resolution))
        return out

    def control(self) -> dict:
        out = self._readings("fp8")
        out.update(acts.check(self.params, {self.role: self.policy_spec}, self._items(),
                              self.ctx.device, self.resolution, control=True))
        return out


def vlm_readings(mine, ref, got, want, iou_scale) -> dict:
    """One unit's VLM numbers (``mine``: OWL's logits and served patch, SAM's
    embedding, mask logits, IoU predictions and chosen index; ``ref``: the
    reference's logits, embedding, mask logits and IoU; ``got`` / ``want``:
    the crop point and radius against the reference geometry's on the
    served mask; ``iou_scale``: the spread of the reference's IoU
    predictions over the kept units):
    - ``owl_logit_err``: widest gap of the class logits over every patch,
      over the reference's logit spread;
    - ``owl_gap``: how far the served patch's logit lies below the
      reference's best, in that spread;
    - ``sam_embed_err``: widest gap of the image embedding, over its spread;
    - ``mask_err``: widest gap of every mask's logits, over their spread;
    - ``iou_err``: widest gap of the IoU predictions, over ``iou_scale``
      (printed by ``check``, not compared);
    - ``iou_gap``: how far the reference's IoU of the chosen mask lies below
      its best, over ``iou_scale``;
    - ``crop_err``: widest gap of the crop point's coordinates and the
      radius, in metres."""
    logits, patch, emb, masks, iou, index = mine
    r_logits, r_emb, r_masks, r_iou = ref
    s = spread(r_logits)
    best = r_logits.max(-1).values
    r = r_iou.reshape(-1)
    return {"owl_logit_err": float((logits.float() - r_logits).abs().max() / s),
            "owl_gap": float((best.max() - best[patch]) / s),
            "sam_embed_err": float((emb.float() - r_emb).abs().max() / spread(r_emb)),
            "mask_err": float((masks.float() - r_masks).abs().max() / spread(r_masks)),
            "iou_err": float((iou.float() - r_iou).abs().max() / iou_scale),
            "iou_gap": float((r.max() - r[index]) / iou_scale),
            "crop_err": float(max(np.abs(np.asarray(got[0]) - np.asarray(want[0])).max(),
                                  abs(got[1] - want[1])))}
