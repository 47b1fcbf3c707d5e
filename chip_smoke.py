#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's act paths (fused front and dense grid), its
VLM crop path, its BC train step, its measurement tools, its train and eval
CLIs, its native disk replay, its protocol tool, its diagnosis probes and
profilers, its weight import and export, its baseline policies, VoxPoser's
planner in the rollout and the real-robot path on one NVIDIA H100 and check
them.

    python3 chip_smoke.py

Phases:
  1. build   - compile the hand-written kernels (``voxactb_tpu_torch/csrc``),
               one nvcc per source in parallel; print the card and build time.
  2. kernels - hold each kernel against its plain PyTorch version on the card
               at the main paths' shapes (front at 50^3 and 100^3, inference
               attention at its cross/self/decoder shapes in every schedule,
               with a ragged tail and a key-split case whose planted faults
               must fail, decoder tail at 50^3
               and 100^3 and with two heads at 50^3, trainable attention
               forward and backward at the train step's three shapes, a
               ragged one and keys with a common component: the saved keep
               bits bit-equal, planted faults must fail; SAM
               attention at ViT-H's global and windowed shapes, a ragged
               case that planted faults must fail, head dim 64 and an odd
               grid width; SAM's block kernels at ViT-H's windowed and global
               layouts (bias + GELU, bias + residual and q/k/v bit-equal,
               LayerNorm and the rel terms within f32 sum-order bounds), timed per encoder pass; the dense-grid encoder
               front at 50^3 and 100^3, batch 1 and 8, the stats kernel at the
               dense paths' five shapes and the inline-upsample tail at 50^3
               and 100^3 and with two heads, each within 2^-7 of its largest
               output, two launches bit-equal, planted faults (swapped 'xy'
               positions, a zero-padded slab; for the stats kernel also CTA
               0's tiles skipped, merges without their rescale and arrival
               counters left raised) failing, the stats kernel's device time
               beside its bound and ``torch.amax``'s; the inline-upsample
               tail against cuDNN ``up0`` + the decoder tail; the decoder
               tail's trans/stats launch alone, a zero-ringed u failing; the
               phase GEMM's u0 within 2^-7; the front's patchify launched
               alone at 50^3, 100^3 and 100^3 batch 8, two launches
               bit-equal, a zero-padded front edge failing; the inference and
               the trainable attention (forward, dQ, dK, dV) at head dims 32
               and 96, SAM attention at 32, all zero-padded to the kernels'
               64 / 128 / 80 by their wrappers, each against its plain
               version at the head dim 64 tolerances with a pad of noise
               failing, two launches bit-equal); time kernel
               (wrapper call; for the attention kernels and each launch of
               the decoder tails also device time from the profiler), plain
               version and, where one PyTorch call computes the same function,
               that call (cuDNN's convs for the tail's conv and trans heads,
               the phase GEMM and K1's patchify); K1's and K5's launches each
               on the device by kernel name.
  3. act100  - full-width ``make_infer_fn`` at 100^3, batch 1 and 8, seeded
               weights: kernels on against the same weights with the kernel
               flags off (Q-field and head logits each within twice the plain
               path's own bf16-vs-f32 distance; an action flip fails only
               where the plain path's top-two gap exceeds it; a planted fault
               must fail that check), then the timed main-path run.
  4. dual50  - VoxAct-B's operating point through ``QAttentionBCAgent.act``:
               acting (dominant, arm head) and stabilizing (assistive) policies
               alternating over a 25-act episode on a 50^3 crop; then one act
               of the two-head variant, kernels on against kernels off.
  5. dense100 - the dense-grid act path (``pallas_front=False``: voxelize ->
               encoder front -> Perceiver with the stats kernel -> inline-
               upsample tail) as act100, a planted phase-table fault failing,
               no d0-sized replicate pad in its profiled act;
               one ``QAttentionBCAgent.act`` whose ``voxel_grid_depth0`` is
               voxelize's grid; then checked single acts of the two-head
               variant at 50^3 (``dense_two_head50``) and of ``pallas_stats``
               alone at 100^3 (``stats100``, three stats launches).
  6. vlm_episode - the per-episode VLM crop path at full width on a synthetic
               512^2 front RGB-D frame, through the detector the benchmark
               builds (``TorchOwlVitSamDetector.build``, its pass replayed as
               CUDA graphs): OWL-ViT B/32 detect, SAM ViT-H (SAM attention on
               its global and windowed blocks, 32 launches per replayed pass;
               its block kernels 64 norms, 32 qkv splits, 32 bias + GELU and
               64 bias + residual passes per replayed pass) and its mask
               decoder, the replayed pass's outputs against the plain path
               (eager blocks, no SAM attention) at bf16 and f32 under the
               act's rule; the crop point and radius, the scene bounds, and a 25-act
               dual-policy episode at 50^3 inside them with CLIP-text language;
               stage times and one profiled VLM pass.
  7. train50 - ``make_train_step`` at full width (50^3 crop, batch 8, bf16,
               depth 6, LAMB): one step's losses and gradients with dropout
               and augmentation off, kernels on against the plain attention
               path (within twice the plain bf16 path's distance from f32);
               timed steps with SE(3) augmentation and dropout on (loss finite
               and falling); a second run from the same seed; one step under
               the profiler; two ``agent.update`` steps. Then round 5's model
               (``eval_artifacts``' open_jar config: latents 64 x 64, depth 2,
               heads of 32) on the kernel path: one act (K1 and K2 on heads
               of 32; K3's gate keeps the plain tail at its final_dim of 16)
               under the act rule and one train step's losses and gradients
               (K4) under the train rule against the same model with K4's
               plain version, a pad of noise failing each, two steps whose
               launches show K4 took every attention.
  8. tools   - the tools' probe kernels against their plain versions: the
               grid copy at d0's shape (rows 1 and 4, batch 1; rows 1, batch
               8) bit-equal, a copy without its last slab failing; the scratch
               probe launching at exactly the card's opt-in shared memory and
               refused one row past it, beside an empty launch's device time; the 9-tap shifted window within 2^-7, a
               dy/dx swap failing; each beside its bound and ``copy_`` or
               cuDNN. Then the tools' entry points on the card: the stage
               profile at 100^3 batch 1, its quick subset, the scratch and
               shifted-window probe, the roofline probes and the cost model at
               the H100's peaks.
  9. protocol - the CLIs end to end at VoxAct-B's operating point: two live
               sim demos of open_jar (three 128^2 cameras), ``cli.train`` of
               the acting (dominant) and the stabilizing (assistive) policy
               at full width on the 50^3 crop (bf16, kernel flags on, arm
               loss, SE(3) augmentation, batch 8, 6 steps, checkpoints at 0,
               3 and 5), then ``cli.eval``'s dual-policy rollout of the
               acting policy's checkpoints with the stabilizing policy's last
               (2 episodes of up to 25 steps each): losses finite, files
               written, language non-zero, one CSV row per checkpoint with a
               finite return, stabilizing acts on even steps and acting on
               odd ones, every act inside its episode's crop bounds;
               ``PrefetchIterator`` bit-equal to its host batches with a
               busy consumer and with a slow worker.
 10. protocol_eval - ``cli.train`` with ``replay.use_disk=True`` at that
               operating point: every row of every batch on the card is a row
               of the native store byte for byte, the store holds the
               in-memory replay's rows from the same fill in order, the run
               closes in its teardown order, the feed is closed five times in
               each order while the prefetch thread waits, and the feed's ms
               per batch stands beside the in-memory replay's; then
               ``tools.run_protocol_eval`` on open_jar at full width (bf16,
               kernel flags; 2 demos, 4 steps per policy, checkpoints 0, 2
               and 3, 2 episodes per checkpoint) through the 'missing' sweep,
               the stabilizing sweep, 'best' on the test seed and
               ``--vlm-eval``: finite returns in every summary entry, the CSVs'
               steps, the pair that ``select_checkpoints`` and the last argmax
               pick, alternating acts inside their episodes' crop bounds, K4
               in the train leg and K1-K3 in the eval leg, and the seconds of
               each stage, save, load, demo, train step, act and sim step.
 11. diagnose - on the checkpoints of phase 10's short leg, the five
               diagnosis probes (replay ambiguity and accuracy, open loop with
               the live rollout, input diff, hybrid inputs), then
               ``profile_train --flash-ab-only --steps 2`` and ``profile_sam
               --frames 1``: each tool's record on a line of its own, its
               printed output in ``chip_smoke.json``; the acts launch K1-K3,
               the profilers K4 and K7.
 12. weights - real weights in and out at the published widths: synthetic
               checkpoints in the upstream layouts (OpenAI CLIP RN50, transformers
               OWL-ViT B/32, segment-anything ViT-H, the reference's
               QAttentionAgent_layer0.pt at PERACT_BC's widths) drawn on the
               card into a temporary ``VOXACTB_WEIGHTS_DIR``, each file's size
               and save and read seconds; the policy through
               ``tools.port_torch_checkpoint`` into the JAX format, loaded by the
               agent bit-equal to a direct mapping of the .pt (chunked too; a
               byte-swapped leaf and a dropped chunk planted in the reader must
               break it, a bf16 copy round trip bit-equal), one act on K1-K3
               against the plain path by the act rule, ``cli.eval``'s
               dual-policy episode on a seed directory of .msgpack files; two
               K4 train steps, a JAX-format checkpoint with the optimizer state
               read back bit-equal, one more plain-path step from it against the
               in-memory state's under the train rule (fresh moments must fail
               it), one K4 update of the restored agent;
               ``TorchOwlVitSamDetector.from_pretrained`` and an f32 VLM pass,
               the bf16 detector from the same files (its replayed pass held
               by SAM's rule) and one VLM pass with K7; CLIP RN50 at 224^2; the sim's language from
               the checkpoint's text tower. The files are removed at the end.
 13. baselines - the paper's comparison policies, plain PyTorch (no TPU
               kernel computes their functions; every launch count stays 0):
               ``BCLangAgent`` with the CNN and the ViT at the JAX modules'
               default widths, f32, two 128^2 cameras, batch 8: the card
               against the CPU from one state (forward, gradients, one Adam
               update; a planted fault, symmetric padding for the CNN and an
               unscaled query for the ViT, must fail the forward), 20 updates
               on one batch (the loss falls), the ``{name}.msgpack``
               checkpoint bit-equal through save and load (a flipped byte
               must break it), acts; ``LingUNetQNet`` (base 16, 2 levels) on a
               [1, 48^3, 10] grid, forward and backward against the CPU.
 14. voxposer_robot - at full width with two seeded policies at 50^3 and the
               kernel flags: an open_jar sim episode whose VoxPoser prologue
               (``VoxPoserPlanner`` on a scripted LLM program, 100^3 value
               maps) is bit-equal to a CPU run (a map 1 cm off must differ),
               then dual-policy acts (K1-K3) and a ``voxposer_only`` episode;
               a real-robot episode (``RealRobotEnv`` over ``BimanualURRobot``
               and two loopback UR controllers, seeded RGB-D cameras, the VLM
               crop with K7 at full width): the URScript each controller
               received equals the actions after the hand-eye extrinsics and
               the gimbal guard (without the extrinsics it must differ);
               ``select_best_checkpoint`` over three checkpoints (one in the
               JAX format) on held-out acting transitions picks the step a
               CPU run picks, writes its CSV, and follows swapped files.
 15. report  - every kernel's launch count rose during its main-path run;
               one ``{"kernels": [...]}`` line; the command's total time.
Then the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero without it.
Bulk details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# the H100 SXM's data-sheet peaks, from the port's cost model
from voxactb_tpu_torch.tools.cost_model import (
    H100_HBM_BW as PEAK_BYTES, H100_PEAK_BF16_FLOPS as PEAK_BF16_FLOPS,
    H100_PEAK_F32_FLOPS as PEAK_F32_FLOPS)

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

SCENE_BOUNDS = [-0.8, -1.0, 0.1, 1.2, 1.0, 2.1]
CROP_BOUNDS = [-0.1, -0.3, 0.5, 0.5, 0.3, 1.1]
IMG = 128
DEVICE = "cuda"


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of CUDA-event-timed single calls after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, f32_ops: float = 0.0):
    """The larger of the bytes' time at the memory rate and the operations'
    time: ``flops`` on bf16 operands at the tensor-core peak, ``f32_ops``
    (element-wise float32 work) at the float32 peak."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (flops / PEAK_BF16_FLOPS + f32_ops / PEAK_F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def clouds(rng, batch: int):
    """The bench's clouds: 2 cameras x 128^2 points, rgb in [0, 255]."""
    rgbs = tuple(rng.integers(0, 255, (batch, IMG, IMG, 3)).astype(np.float32)
                 for _ in range(2))
    pcds = tuple(rng.uniform(-0.5, 1.5, (batch, IMG, IMG, 3)).astype(np.float32)
                 for _ in range(2))
    return rgbs, pcds


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


def expect(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: per-kernel checks
# ---------------------------------------------------------------------------


def check_front(model, n, batch, rng, details):
    import torch
    import torch.nn.functional as F
    from voxactb_tpu_torch.models.blocks import edge_pad, to_ncdhw
    from voxactb_tpu_torch.agents.qfunction import normalize_rgb
    from voxactb_tpu_torch.ops.cuda.encoder_stats import voxel_pass_grid
    from voxactb_tpu_torch.ops.cuda.front_fused import (
        front_fused, front_fused_reference, patchify_segments)
    from voxactb_tpu_torch.ops.voxelize import bin_points, flatten_camera_observations

    dev = torch.device(DEVICE)
    rgbs, pcds = clouds(rng, batch)
    coords, feats = flatten_camera_observations(
        [normalize_rgb(torch.tensor(r, device=dev)) for r in rgbs],
        [torch.tensor(p, device=dev) for p in pcds])
    bounds = torch.tensor([SCENE_BOUNDS if n == 100 else CROP_BOUNDS] * batch,
                          device=dev)
    w1 = model.input_preprocess.kernel_dhwio()[0, 0, 0].detach()
    b1 = model.input_preprocess.bias.detach()
    wp = model.patchify.kernel_dhwio().detach()
    args = (coords, feats, bounds, w1, b1, wp)
    with torch.inference_mode():
        got = front_fused(*args, voxel_size=n)
        ref = front_fused_reference(*args, voxel_size=n)
        torch.cuda.synchronize()
    d0, patch, kp, gmax, overflow = got
    rd0, rpatch, rkp, rgmax, _ = ref
    # d0: the scatter's atomics sum in a run-dependent order, so a voxel mean can
    # differ in its last f32 bits and d0 by one bf16 ulp (2^-8 relative)
    ulp = rd0.float().abs() * 2.0 ** -8 + 1e-30
    d0_diff = (d0.float() - rd0.float()).abs()
    expect(bool((d0_diff <= ulp).all()), f"front d0 beyond 1 bf16 ulp at {n}^3")
    frac_d0 = float((d0_diff > 0).float().mean())
    expect(frac_d0 < 1e-3, f"front d0 differs in {frac_d0:.2e} of elements")
    # patch: 8000-term f32 sums of bf16 products in another order (+ d0 ulps)
    e_patch = max_err(patch, rpatch)
    tol_patch = 2e-3 * float(rpatch.abs().max())
    expect(e_patch <= tol_patch, f"front patch err {e_patch} > {tol_patch}")
    e_kp, e_g = max_err(kp, rkp), max_err(gmax, rgmax)
    expect(e_kp <= 1e-3, f"front kp err {e_kp} > 1e-3")
    expect(e_g <= 2.0 ** -7 * float(rgmax.abs().max()), f"front gmax err {e_g}")
    expect(int(overflow.sum()) == 0, "front overflow")

    with torch.inference_mode():
        ms = time_ms(lambda: front_fused(*args, voxel_size=n))
        plain = time_ms(lambda: front_fused_reference(*args, voxel_size=n), reps=5)
        # each of K1's launches on the device
        dev_ms = {k: device_ms(lambda: front_fused(*args, voxel_size=n), key)
                  for k, key in FRONT_LAUNCHES.items()}
        # the patchify's yardstick: cuDNN's bf16 k5/s5 conv of d0 edge-padded
        # by 2 beforehand, channels last (wrapper call, and its device time)
        xp = edge_pad(to_ncdhw(d0), 2).contiguous(memory_format=torch.channels_last_3d)
        wpc = wp.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        patch_lib = time_ms(lambda: F.conv3d(xp, wpc, stride=5))
        patch_lib_dev = device_ms(lambda: F.conv3d(xp, wpc, stride=5), "")
    del xp, wpc
    p = coords.shape[1]
    s = n // 5
    n3 = batch * n ** 3
    nbytes = batch * p * 6 * 4 + n3 * 64 * 2 + batch * s ** 3 * 64 * 4 \
        + batch * 64 * 4 * 4 + (10 * 64 + 125 * 64 * 64) * 2 + 64 * 4
    flops = 2.0 * n3 * 10 * 64 + 2.0 * batch * s ** 3 * 125 * 64 * 64
    bms, by = bound_ms(nbytes, flops)
    # per launch: the accumulator's memset (written once), the scatter (the
    # points read, seven 4-byte atomic adds for each point that lands in the
    # grid), the voxel pass (accumulator read, d0 written; the 1x1 conv's
    # products and the fold's ~10 f32 operations per element), the combine
    # (one partial per voxel-pass CTA), the patchify (d0 and its weights
    # read, patch written) and its reduce (the partial tiles read, the split
    # tiles written)
    idx = bin_points(coords, bounds, n)
    in_grid = int(((idx >= 1) & (idx <= n)).all(-1).sum())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g_vox = voxel_pass_grid(batch, n, sms)
    segments = patchify_segments(batch, n, sms)
    partials = sum(seg[4] is not None for seg in segments)
    split_tiles = len({seg[1] for seg in segments if seg[4] is not None})
    launch_bounds = {
        "acc_memset": bound_ms(n3 * 8 * 4, 0.0),
        "ff_scatter": bound_ms(batch * p * 6 * 4 + in_grid * 7 * 4, 0.0),
        "ff_voxel": bound_ms(n3 * 8 * 4 + n3 * 64 * 2 + batch * g_vox * 5 * 64 * 4,
                             2.0 * n3 * 10 * 64, f32_ops=10.0 * n3 * 64),
        "stats_combine": bound_ms(batch * g_vox * 5 * 64 * 4 + batch * 4 * 64 * 4, 0.0),
        "patchify_gemm": bound_ms(n3 * 64 * 2 + 125 * 64 * 64 * 2 + batch * s ** 3 * 64 * 4,
                                  2.0 * batch * s ** 3 * 125 * 64 * 64),
        "patchify_reduce": bound_ms((partials + split_tiles) * 128 * 64 * 4, 0.0),
    }
    row = dict(shape=f"N={n} B={batch} P={p}", points_in_grid=in_grid,
               max_abs_err=max_err(d0, rd0),
               d0_frac_differing=frac_d0, patch_err=e_patch, kp_err=e_kp,
               gmax_err=e_g, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
               library_ms=None, patchify_library_ms=patch_lib,
               patchify_library_device_ms=patch_lib_dev, launch_device_ms=dev_ms,
               device_ms=sum(dev_ms.values()),
               launch_bound_ms={k: v[0] for k, v in launch_bounds.items()},
               launch_bound_by={k: v[1] for k, v in launch_bounds.items()})
    details.setdefault("front_fused", []).append(row)
    log(f"[kernels] front_fused N={n}: d0 err {row['max_abs_err']:.3g} "
        f"(<=1 bf16 ulp; {frac_d0:.2e} of elements differ), patch err {e_patch:.3g} "
        f"(tol {tol_patch:.3g}), kp err {e_kp:.3g} (tol 1e-3), gmax err {e_g:.3g}; "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms ({by}); device "
        + ", ".join(f"{k} {v:.4f} (bound {launch_bounds[k][0]:.4f})" for k, v in dev_ms.items())
        + f"; patchify's cuDNN k5/s5 conv {patch_lib:.4f} ms, device {patch_lib_dev:.4f}")
    return d0


# K1's launches (csrc/front_fused.cu): their names here, and what the
# profiler's name for each holds (the accumulator's cudaMemsetAsync is a
# "Memset (Device)" activity)
FRONT_LAUNCHES = {"acc_memset": "Memset", "ff_scatter": "ff_scatter",
                  "ff_voxel": "ff_voxel", "stats_combine": "stats_combine",
                  "patchify_gemm": "patchify_gemm", "patchify_reduce": "patchify_reduce"}
# the patchify alone on seeded d0 (from torch.Generator(device="cuda") seeds)
PATCHIFY_SHAPES = ((1, 50, 100), (1, 100, 101), (8, 100, 102))


def zero_front_patchify(front_patchify, d0, wp):
    """The patchify with zeros in front of d0 instead of its clamped edge,
    run through the real kernel: d0 zero-padded by 5 voxels in front on each
    axis, the first patch plane of each axis cropped. A planted fault."""
    import torch.nn.functional as F

    padded = F.pad(d0, (0, 0, 5, 0, 5, 0, 5, 0))
    return front_patchify(padded, wp)[:, 1:, 1:, 1:]


def check_patchify(model, details):
    """The patchify launch alone (csrc/front_patchify.cuh, ``front_patchify``)
    on seeded d0 at 50^3, 100^3 and 100^3 batch 8 against ``patchify_pre``
    within the front check's 2e-3 x max|patch|; two launches bit-equal; the
    zero-padded front edge must fail; device time beside cuDNN's bf16 conv
    of the pre-padded d0."""
    import torch
    import torch.nn.functional as F
    from voxactb_tpu_torch.models.blocks import edge_pad, to_ncdhw
    from voxactb_tpu_torch.ops.cuda.front_fused import front_patchify, patchify_pre

    dev = torch.device(DEVICE)
    wp = model.patchify.kernel_dhwio().detach()
    for batch, n, seed in PATCHIFY_SHAPES:
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((batch, n, n, n, 64), generator=g, device=dev)
        d0 = torch.where(x >= 0, x, 0.02 * x).to(torch.bfloat16)
        del x
        with torch.inference_mode():
            got = front_patchify(d0, wp)
            again = front_patchify(d0, wp)
            ref = patchify_pre(d0, wp)
            wrong = zero_front_patchify(front_patchify, d0, wp)
            torch.cuda.synchronize()
        tag = f"N={n} B={batch}"
        tol = 2e-3 * float(ref.abs().max())
        err = max_err(got, ref)
        expect(err <= tol, f"front_patchify {tag}: err {err} > {tol}")
        expect(torch.equal(got, again), f"front_patchify {tag}: two launches differ")
        planted = max_err(wrong, ref)
        expect(planted > tol, f"front_patchify {tag}: a zero-padded front edge erred by "
               f"{planted} only")
        del got, again, wrong
        with torch.inference_mode():
            ms = time_ms(lambda: front_patchify(d0, wp))
            plain = time_ms(lambda: patchify_pre(d0, wp), reps=5)
            dev_ms = {k: device_ms(lambda: front_patchify(d0, wp), k)
                      for k in ("patchify_gemm", "patchify_reduce")}
            xp = edge_pad(to_ncdhw(d0), 2).contiguous(memory_format=torch.channels_last_3d)
            wpc = wp.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            lib = time_ms(lambda: F.conv3d(xp, wpc, stride=5))
            lib_dev = device_ms(lambda: F.conv3d(xp, wpc, stride=5), "")
        del xp, wpc
        s = n // 5
        bms, by = bound_ms(batch * n ** 3 * 64 * 2 + 125 * 64 * 64 * 2
                           + batch * s ** 3 * 64 * 4, 2.0 * batch * s ** 3 * 125 * 64 * 64)
        device = sum(dev_ms.values())
        row = dict(shape=tag, max_abs_err=err, tol=tol, planted_zero_front_err=planted,
                   ms=ms, device_ms=device, launch_device_ms=dev_ms, plain_ms=plain,
                   bound_ms=bms, bound_by=by, library_ms=lib, library_device_ms=lib_dev,
                   tbytes_per_s=batch * n ** 3 * 64 * 2 / device / 1e9)
        details.setdefault("front_patchify", []).append(row)
        log(f"[kernels] front_patchify {tag}: err {err:.3g} (tol {tol:.3g}); two launches "
            f"bit-equal; planted zero-padded front edge err {planted:.3g}; {ms:.4f} ms, "
            f"device {device:.4f} (gemm {dev_ms['patchify_gemm']:.4f}, reduce "
            f"{dev_ms['patchify_reduce']:.4f}; {row['tbytes_per_s']:.2f} TB/s of d0), plain "
            f"{plain:.4f} ms, bound {bms:.4f} ms ({by}); cuDNN bf16 k5/s5 conv {lib:.4f} ms, "
            f"device {lib_dev:.4f}")
        del d0, ref
        torch.cuda.empty_cache()


def unmasked_attention(attention):
    """K2 without its key mask: the keys zero-filled up to the next key tile
    take part as logit 0 and value 0, which is what the kernel computes if it
    skips the mask. A planted fault, run through the real kernel."""
    import torch
    from voxactb_tpu_torch.ops.cuda.flash_attention import KEY_TILE

    def fn(q, k, v, **kw):
        z = k.new_zeros(k.shape[0], -k.shape[1] % KEY_TILE, k.shape[2])
        return attention(q, torch.cat([k, z], 1), torch.cat([v, z], 1), **kw)
    return fn


def read_past_attention(attention):
    """K2 reading past Tk (up to the next key tile) into the next head's keys
    and values instead of masking (the last head reads zeros). A planted
    fault, run through the real kernel."""
    import torch
    from voxactb_tpu_torch.ops.cuda.flash_attention import KEY_TILE

    def fn(q, k, v, **kw):
        pad = -k.shape[1] % KEY_TILE
        nxt = lambda t: torch.cat([t[1:, :pad], t.new_zeros(1, pad, t.shape[2])], 0)
        return attention(q, torch.cat([k, nxt(k)], 1), torch.cat([v, nxt(v)], 1), **kw)
    return fn


def per_split_attention(attention, splits):
    """K2 with each CTA normalising P by its own split's max and sum: the
    kernel launched on each key slice of a ``splits``-way schedule alone, the
    outputs summed. A planted fault, run through the real kernel."""
    import torch
    from voxactb_tpu_torch.ops.cuda.flash_attention import KEY_TILE

    def fn(q, k, v):
        n = -(-k.shape[1] // KEY_TILE)
        cuts = [KEY_TILE * (i * n // splits) for i in range(splits + 1)]
        total = sum(attention(q, k[:, a:b], v[:, a:b]).float()
                    for a, b in zip(cuts, cuts[1:]))
        return total.to(v.dtype)
    return fn


def tail_inputs(g, tq, tk, dev):
    """Two heads whose real logits sit near -8, so that keys past Tk would
    dominate the row if they took part: a zero-filled key (logit 0) by
    e^8, and head 1's keys read from head 0 (logit +8) by e^16. Values are
    near +1 in head 0 and -1 in head 1, so either fault moves head 0's
    output by most of its size."""
    import torch

    sign = torch.tensor([1.0, -1.0]).reshape(2, 1, 1)
    q = sign * 0.25 + 0.05 * torch.randn(2, tq, 64, generator=g)
    k = -sign * 0.5 + 0.2 * torch.randn(2, tk, 64, generator=g)
    v = sign + 0.5 * torch.randn(2, tk, 64, generator=g)
    return tuple(t.to(dev, torch.bfloat16) for t in (q, k, v))


def split_inputs(g, bh, tq, tk, splits, dev):
    """Keys cut as a ``splits``-way schedule cuts them: the values of each
    split near +1 or -1 in turn, and the row max in the last split (its
    logits near +8, the others' near 0). A kernel that normalised each split
    by its own max and sum would add the splits' averages of opposite sign."""
    import torch
    from voxactb_tpu_torch.ops.cuda.flash_attention import KEY_TILE

    n = -(-tk // KEY_TILE)
    cuts = [i * n // splits for i in range(splits + 1)]  # the kernel's key tiles per split
    split_of = torch.tensor([i for i in range(splits) for _ in range(cuts[i], cuts[i + 1])]
                            ).repeat_interleave(KEY_TILE)[:tk]
    sign = (1.0 - 2.0 * (split_of % 2)).reshape(1, tk, 1)
    last = (split_of == splits - 1).float().reshape(1, tk, 1)
    q = 0.25 + 0.05 * torch.randn(bh, tq, 64, generator=g)
    k = 0.5 * last + 0.2 * torch.randn(bh, tk, 64, generator=g)
    v = sign + 0.5 * torch.randn(bh, tk, 64, generator=g)
    return tuple(t.to(dev, torch.bfloat16) for t in (q, k, v))


def device_ms(fn, name, reps: int = 10, tries: int = 5) -> float:
    """Device time per call of the kernels whose name holds ``name`` (of
    every device-side event, copies and memsets too, when ``name`` is None),
    from the profiler: each kernel's mean time over the launches the profiler
    recorded, times its launches per call, so that a window that lost some
    launches (logged) still gives their time. A window in which the profiler
    recorded none of them (it happens now and then over many short windows)
    is taken again, twice as long, after a pause, and logged; if every try
    comes back empty the run fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for t in range(tries):
        calls = reps << t
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages() if e.device_time_total > 0
                 and not e.is_user_annotation  # the program's spans, mirrored
                 and (name in e.key if name is not None else e.device_type == DeviceType.CUDA)]
        if found:
            lost = [f"{e.key[:60]} x{e.count}" for e in found if e.count % calls]
            if lost:
                log(f"[profiler] a window of {calls} calls recorded " + ", ".join(lost))
            return sum(e.device_time_total / e.count * max(1, round(e.count / calls))
                       for e in found) / 1e3
        log(f"[profiler] a window of {calls} calls recorded no {name} kernel")
        time.sleep(0.1)
    raise AssertionError(f"the profiler recorded no {name} kernel in {tries} windows")


def check_attention(b, s3, rng, details, split_rng=None):
    """K2 against its plain version at every schedule of the act's cross,
    self and decoder shapes and of a ragged tail that planted faults must
    fail; two launches bit-equal. With ``split_rng``, also the ``split``
    case (the cross shape, inputs from that stream) that a kernel
    normalising each key split alone must fail."""
    import torch
    import torch.nn.functional as F
    from voxactb_tpu_torch.ops.cuda.build import sm_count
    from voxactb_tpu_torch.ops.cuda.flash_attention import (
        all_schedules, choose_schedule, flash_attention, flash_attention_reference)

    dev = torch.device(DEVICE)
    tk_in = 77 + s3
    shapes = {"cross": (b, 2048, tk_in), "self": (8 * b, 2048, 2048),
              "decoder": (b, tk_in, 2048), "tail": (2, 2048, tk_in)}
    if split_rng is not None:
        shapes["split"] = (b, 2048, tk_in)
    rows = {}
    for name, (bh, tq, tk) in shapes.items():
        chosen = choose_schedule(bh, tq, tk, sm_count(dev))
        src = split_rng if name == "split" else rng
        g = torch.Generator(device="cpu").manual_seed(int(src.integers(1 << 30)))
        if name == "tail":
            q, k, v = tail_inputs(g, tq, tk, dev)
        elif name == "split":
            q, k, v = split_inputs(g, bh, tq, tk, chosen[1], dev)
        else:
            q = (torch.randn(bh, tq, 64, generator=g) * 0.125).to(dev, torch.bfloat16)
            k = torch.randn(bh, tk, 64, generator=g).to(dev, torch.bfloat16)
            v = torch.randn(bh, tk, 64, generator=g).to(dev, torch.bfloat16)
        ref = flash_attention_reference(q, k, v)
        # the kernel and the plain version round P and the output at the same
        # points and differ only in f32 summation order, so an output may sit
        # one bf16 ulp of its own size away; 2^-7 of the largest output is at
        # least one and at most two ulps of it
        tol = 2.0 ** -7 * float(ref.float().abs().max())
        errs = {}
        for sched in [0] + all_schedules(tk):  # the wrapper's choice, then every one
            got = flash_attention(q, k, v, schedule=sched)
            again = flash_attention(q, k, v, schedule=sched)
            torch.cuda.synchronize()
            key = "chosen" if sched == 0 else f"{sched[0]}x{sched[1]}"
            errs[key] = max_err(got, ref)
            expect(errs[key] <= tol, f"attention {name} schedule {key} err "
                                     f"{errs[key]} > {tol}")
            # no atomics: a second launch gives the same bits
            expect(torch.equal(got, again), f"attention {name} schedule {key}: two "
                                            "launches differ")
        del got, again
        err = max(errs.values())
        planted = {}
        if name == "tail":
            # the case must catch a kernel that skips the mask
            for fault, wrap in (("unmasked", unmasked_attention),
                                ("read_past", read_past_attention)):
                planted[fault] = max_err(wrap(flash_attention)(q, k, v)[:1], ref[:1])
                expect(planted[fault] > tol, f"attention tail: planted fault {fault} "
                                             f"err {planted[fault]} within {tol}")
        if name == "split":
            fault = f"per_split_{chosen[1]}"
            planted[fault] = max_err(per_split_attention(flash_attention, chosen[1])(q, k, v),
                                     ref)
            expect(planted[fault] > tol, f"attention split: planted fault {fault} err "
                                         f"{planted[fault]} within {tol}")
        ms = time_ms(lambda: flash_attention(q, k, v))
        dev_ms = device_ms(lambda: flash_attention(q, k, v), "attention_fwd")
        # device time of every schedule: the evidence for choose_schedule's rule
        schedule_ms = {f"{r}x{sp}": device_ms(lambda: flash_attention(q, k, v,
                                                                      schedule=(r, sp)),
                                              "attention_fwd", reps=5)
                       for r, sp in all_schedules(tk)}
        plain = time_ms(lambda: flash_attention_reference(q, k, v), reps=5)
        # the library call, as [1, BH, T, 64] so that it may take its fused kernel
        lib = time_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                             scale=1.0))
        nbytes = 2.0 * (2 * bh * tq * 64 + 2 * bh * tk * 64)
        flops = 4.0 * bh * tq * tk * 64
        bms, by = bound_ms(nbytes, flops)
        rows[name] = dict(shape=f"{name} BH={bh} Tq={tq} Tk={tk}", max_abs_err=err,
                          errs=errs, tol=tol, ref_max=float(ref.float().abs().max()),
                          planted_fault_err=planted, schedule=list(chosen), ms=ms,
                          device_ms=dev_ms, schedule_device_ms=schedule_ms, plain_ms=plain,
                          library_ms=lib, bound_ms=bms, bound_by=by)
        fastest = min(schedule_ms, key=schedule_ms.get)
        log(f"[kernels] flash_attention {name} BH={bh} Tq={tq} Tk={tk}: err {err:.3g} "
            f"(tol {tol:.3g}) at all {len(errs) - 1} schedules, two launches bit-equal"
            + "".join(f", planted {f} err {e:.3g}" for f, e in planted.items())
            + f"; schedule {chosen[0]}x{chosen[1]} {ms:.4f} ms (device {dev_ms:.4f}; "
            f"fastest on the device {fastest} {schedule_ms[fastest]:.4f}), plain {plain:.4f} ms, "
            f"sdpa {lib:.4f} ms, bound {bms:.4f} ms ({by})")
        del q, k, v, ref
    details.setdefault("flash_attention", []).append(dict(grid=f"s^3={s3} B={b}", **rows))
    return rows


def check_decoder(model, d0, rng, details, heads=1):
    """K3 against its plain version; ``heads=2`` is the two-head launch
    (trans [B,N,N,N,2]) with a second, seeded trans head. Also the u grid its
    conv wrote against the plain conv, two launches bit-equal, the planted
    ``zero_padded_halo`` fault (d0 and u0 zero-padded by one voxel, the trans
    interior cropped) failing the trans check, the device time of each of its
    three launches and cuDNN's conv of the same replicate-padded concat. The
    trans/stats launch alone on the kernel's u against ``tail_from_u`` on the
    same u, with its planted ``zero_ringed_u`` fault (u zero-padded by one
    voxel, trans cropped: the zero-filled halo instead of the clamped one)
    failing the trans check, and cuDNN's bf16 conv of the replicate-padded u
    to T channels as its yardstick."""
    import torch
    import torch.nn.functional as F
    from voxactb_tpu_torch.models.blocks import edge_pad, to_ncdhw
    from voxactb_tpu_torch.ops.cuda.decoder_head import (
        decoder_head, decoder_head_reference, launch_decoder_head, launch_tail_from_u,
        tail_conv_reference, tail_from_u)

    b, n = d0.shape[0], d0.shape[1]
    g = torch.Generator(device="cpu").manual_seed(int(rng.integers(1 << 30)))
    u0 = torch.randn(d0.shape, generator=g).to(d0.device, torch.bfloat16)
    wf = model.final.kernel_dhwio().detach()
    bf = model.final.bias.detach()
    wt = model.trans_decoder.kernel_dhwio().detach()[None]
    bt = model.trans_decoder.bias.detach()
    if heads == 2:
        wt = torch.cat([wt, (torch.randn(wt.shape, generator=g) * wt.std().cpu()).to(
            wt.device)])
        bt = torch.cat([bt, torch.full_like(bt, 0.01)])
    args = (d0, u0, wf, bf, wt, bt)
    got = decoder_head(*args)
    ref = decoder_head_reference(*args)
    torch.cuda.synchronize()
    (trans, kp, gmax), (rtrans, rkp, rgmax) = got, ref
    expect(tuple(trans.shape) == (b, n, n, n, heads), f"decoder trans shape {trans.shape}")
    # trans: 1728-term f32 sums over u, and u itself from 3456-term f32 sums
    # rounded to bf16 (a sum on a rounding boundary may round the other way)
    e_t = max_err(trans, rtrans)
    tol_t = 1e-2 * float(rtrans.abs().max())
    expect(e_t <= tol_t, f"decoder trans err {e_t} > {tol_t}")
    e_kp, e_g = max_err(kp, rkp), max_err(gmax, rgmax)
    expect(e_kp <= 1e-3, f"decoder kp err {e_kp} > 1e-3")
    expect(e_g <= 2.0 ** -7 * float(rgmax.abs().max()), f"decoder gmax err {e_g}")
    argmax_same = bool((trans.reshape(b, -1, heads).argmax(1)
                        == rtrans.reshape(b, -1, heads).argmax(1)).all())
    tag = f"N={n} B={b} T={heads}"
    # the u grid the conv wrote: kernel and plain conv round the same f32 sum
    # once, in another order, so u sits within an ulp of its own size
    with torch.inference_mode():
        first = launch_decoder_head(*args)
        again = launch_decoder_head(*args)
        u_ref = tail_conv_reference(d0, u0, wf, bf)
        pad = lambda x: F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))  # noqa: E731
        wrong = launch_decoder_head(pad(d0), pad(u0), wf, bf, wt, bt)[0][:, 1:-1, 1:-1, 1:-1]
        torch.cuda.synchronize()
    e_u = max_err(first[3], u_ref)
    tol_u = 2.0 ** -7 * float(u_ref.float().abs().max())
    expect(e_u <= tol_u, f"decoder_head {tag}: u err {e_u} > {tol_u}")
    expect(all(torch.equal(x, y) for x, y in zip(first, again)),
           f"decoder_head {tag}: two launches on the same inputs differ")
    planted = max_err(wrong, rtrans)
    expect(planted > tol_t, f"decoder_head {tag}: a zero-padded halo erred by {planted} only")
    # the trans/stats launch alone, on the u the conv wrote: the same function
    # as tail_from_u, summed in another order
    u_k = first[3]
    with torch.inference_mode():
        ts = launch_tail_from_u(u_k, wt, bt)
        ts_ref = tail_from_u(u_k, wt, bt)
        ring = launch_tail_from_u(F.pad(u_k, (0, 0, 1, 1, 1, 1, 1, 1)), wt, bt)[0]
        torch.cuda.synchronize()
    tol_ts = 1e-2 * float(ts_ref[0].abs().max())
    e_ts = max_err(ts[0], ts_ref[0])
    e_ts_kp, e_ts_g = max_err(ts[1], ts_ref[1]), max_err(ts[2], ts_ref[2])
    expect(e_ts <= tol_ts, f"decoder_head {tag}: trans/stats trans err {e_ts} > {tol_ts}")
    expect(e_ts_kp <= 1e-3, f"decoder_head {tag}: trans/stats kp err {e_ts_kp} > 1e-3")
    expect(e_ts_g <= 2.0 ** -7 * float(ts_ref[2].abs().max()),
           f"decoder_head {tag}: trans/stats gmax err {e_ts_g}")
    planted_ring = max_err(ring[:, 1:-1, 1:-1, 1:-1], ts_ref[0])
    expect(planted_ring > tol_ts,
           f"decoder_head {tag}: a zero-ringed u erred by {planted_ring} only")
    del first, again, wrong, ts, ring
    ms = time_ms(lambda: decoder_head(*args))
    plain = time_ms(lambda: decoder_head_reference(*args), reps=5)
    dev_ms = {k: device_ms(lambda: decoder_head(*args), k)
              for k in ("tail_conv", "tail_trans_stats", "stats_combine")}
    with torch.inference_mode():
        ts_plain = time_ms(lambda: tail_from_u(u_k, wt, bt), reps=5)
        # the trans half's yardstick: cuDNN's bf16 conv of the replicate-padded
        # u to T channels, channels last, padded beforehand
        uc = edge_pad(to_ncdhw(u_k), 1).contiguous(memory_format=torch.channels_last_3d)
        wtc = wt[..., 0].to(torch.bfloat16).permute(0, 4, 1, 2, 3).contiguous(
            memory_format=torch.channels_last_3d)
        ts_lib = time_ms(lambda: F.conv3d(uc, wtc))
    del uc, wtc, u_k, ts_ref
    # the yardstick: cuDNN's bf16 conv of the replicate-padded concat,
    # channels last, padded beforehand
    xc = edge_pad(to_ncdhw(torch.cat([d0, u0], -1)), 1).contiguous(
        memory_format=torch.channels_last_3d)
    wc = wf.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    with torch.inference_mode():
        conv_lib = time_ms(lambda: F.conv3d(xc, wc))
        conv_plain = time_ms(lambda: tail_conv_reference(d0, u0, wf, bf), reps=5)
    del xc, wc
    n3 = n ** 3
    nbytes = 2.0 * b * n3 * 64 * 2 + b * n3 * 4 * heads + b * 64 * 4 * 4 \
        + (27 * 128 * 64 + 27 * 64 * heads) * 2 + (64 + heads) * 4
    flops = 2.0 * b * n3 * 27 * 128 * 64 + 2.0 * b * n3 * 27 * 64 * heads
    bms, by = bound_ms(nbytes, flops)
    # the conv alone: d0 and u0 read, u written, its weights and bias
    conv_bms, conv_by = bound_ms(3.0 * b * n3 * 64 * 2 + 27 * 128 * 64 * 2 + 64 * 4,
                                 2.0 * b * n3 * 27 * 128 * 64)
    # trans/stats and its combine: u read, trans and kp / gmax written, the
    # heads' weights; the heads' products on bf16 operands and the fold's ~10
    # f32 operations per element of u
    ts_bms, ts_by = bound_ms(b * n3 * 64 * 2 + b * n3 * heads * 4 + b * 64 * 4 * 4
                             + 27 * 64 * heads * 2 + heads * 4,
                             2.0 * b * n3 * 27 * 64 * heads, f32_ops=10.0 * b * n3 * 64)
    row = dict(shape=tag, max_abs_err=e_t, tol=tol_t, kp_err=e_kp,
               gmax_err=e_g, argmax_same=argmax_same, u_err=e_u, u_tol=tol_u,
               planted_zero_pad_halo_trans_err=planted, ms=ms, plain_ms=plain,
               bound_ms=bms, bound_by=by, library_ms=None,
               conv_device_ms=dev_ms["tail_conv"],
               combine_device_ms=dev_ms["stats_combine"], trans_stats_err=e_ts,
               trans_stats_tol=tol_ts, trans_stats_kp_err=e_ts_kp,
               trans_stats_gmax_err=e_ts_g, planted_zero_ringed_u_trans_err=planted_ring,
               trans_stats_plain_ms=ts_plain, trans_stats_library_ms=ts_lib,
               trans_stats_bound_ms=ts_bms, trans_stats_bound_by=ts_by,
               conv_plain_ms=conv_plain,
               conv_library_ms=conv_lib, conv_bound_ms=conv_bms, conv_bound_by=conv_by,
               conv_tflops=2.0 * b * n3 * 27 * 128 * 64 / dev_ms["tail_conv"] / 1e9,
               trans_stats_device_ms=dev_ms["tail_trans_stats"])
    details.setdefault("decoder_head" if heads == 1 else "decoder_head_two_heads",
                       []).append(row)
    log(f"[kernels] decoder_head {tag}: trans err {e_t:.3g} (tol {tol_t:.3g}), "
        f"kp err {e_kp:.3g}, gmax err {e_g:.3g}, u err {e_u:.3g} (tol {tol_u:.3g}), "
        f"argmax same {argmax_same}; two launches bit-equal; planted zero-padded halo "
        f"trans err {planted:.3g}; {ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms "
        f"({by}); device: conv {dev_ms['tail_conv']:.4f} ms ({row['conv_tflops']:.1f} "
        f"TFLOP/s, bound {conv_bms:.4f}, cuDNN {conv_lib:.4f}, plain {conv_plain:.4f}), "
        f"trans/stats {dev_ms['tail_trans_stats']:.4f} (bound {ts_bms:.4f}, cuDNN T-channel conv "
        f"{ts_lib:.4f}, plain {ts_plain:.4f}; alone: trans err {e_ts:.3g} (tol {tol_ts:.3g}), "
        f"kp err {e_ts_kp:.3g}, gmax err {e_ts_g:.3g}, planted zero-ringed u trans err "
        f"{planted_ring:.3g}), combine {dev_ms['stats_combine']:.4f}")


# K3 on a ragged grid: partial output bricks on all three axes, two samples
# (inputs from a stream of their own, so the other phases keep theirs)
DECODER_RAGGED = (2, 37)


def check_decoder_ragged(model, details):
    import torch

    b, n = DECODER_RAGGED
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.normal(size=(b, n, n, n, 64)).astype(np.float32), device=DEVICE)
    check_decoder(model, torch.where(x >= 0, x, 0.02 * x).to(torch.bfloat16), rng, details)


def dense_grid(rng, n, batch):
    """The ``[B,N,N,N,10]`` grid that ``voxelize`` builds from the bench's
    clouds: the dense-grid act path's input."""
    import torch
    from voxactb_tpu_torch.agents.qfunction import normalize_rgb
    from voxactb_tpu_torch.ops.voxelize import flatten_camera_observations, voxelize

    dev = torch.device(DEVICE)
    rgbs, pcds = clouds(rng, batch)
    coords, feats = flatten_camera_observations(
        [normalize_rgb(torch.tensor(r, device=dev)) for r in rgbs],
        [torch.tensor(p, device=dev) for p in pcds])
    bounds = torch.tensor([SCENE_BOUNDS if n == 100 else CROP_BOUNDS] * batch, device=dev)
    return voxelize(coords, feats, bounds, voxel_size=n)


def hold(kernel, tag, names, got, ref, again):
    """Each output of a dense-grid kernel within 2^-7 of the largest plain
    output, with no floor: kernel and plain version round at the same points
    and differ in f32 summation order only, so a bf16 output may sit one ulp
    of its own size away. Two launches on the same inputs give the same bits
    (no atomics). Returns ``{name: {max_abs_err, tol}}``."""
    import torch

    errs = {}
    for name, a, r in zip(names, got, ref):
        tol = 2.0 ** -7 * float(r.float().abs().max())
        e = max_err(a, r)
        expect(e <= tol, f"{kernel} {tag}: {name} err {e} > {tol}")
        errs[name] = dict(max_abs_err=e, tol=tol)
    expect(all(torch.equal(a, b) for a, b in zip(got, again)),
           f"{kernel} {tag}: two launches on the same inputs differ")
    return errs


def swapped_xy(x):
    """A ``[B,n,n,n,C]`` grid with its d and h axes swapped: a stats kernel
    fed it computes the keypoints with the 'xy' position axes swapped. A
    planted fault, run through the real kernel."""
    return x.transpose(1, 2).contiguous()


def check_encoder_stats(model, n, batch, rng, details):
    """K5 against its plain version on the voxelized grid of the bench's
    clouds, with the model's preprocess weights and a seeded bias. Returns
    the kernel's d0."""
    import torch
    from voxactb_tpu_torch.ops.cuda.encoder_stats import (
        encoder_stats, encoder_stats_reference, voxel_pass_grid)

    dev = torch.device(DEVICE)
    g = torch.Generator(device="cpu").manual_seed(int(rng.integers(1 << 30)))
    grid = dense_grid(rng, n, batch)
    w1 = model.input_preprocess.kernel_dhwio()[0, 0, 0].detach()
    b1 = (0.1 * torch.randn(64, generator=g)).to(dev)
    tag = f"N={n} B={batch}"
    with torch.inference_mode():
        got = encoder_stats(grid, w1, b1)
        again = encoder_stats(grid, w1, b1)
        ref = encoder_stats_reference(grid, w1, b1)
        _, kp_swapped, _ = encoder_stats(swapped_xy(grid), w1, b1)
        torch.cuda.synchronize()
    errs = hold("encoder_stats", tag, ("d0", "kp", "gmax"), got, ref, again)
    d0 = got[0]
    d0_frac = float((d0 != ref[0]).float().mean())
    planted = max_err(kp_swapped, ref[1])
    expect(planted > errs["kp"]["tol"],
           f"encoder_stats {tag}: swapped xy positions erred by {planted} only")
    del got, again, kp_swapped
    with torch.inference_mode():
        ms = time_ms(lambda: encoder_stats(grid, w1, b1))
        plain = time_ms(lambda: encoder_stats_reference(grid, w1, b1), reps=5)
        dev_ms = {k: device_ms(lambda: encoder_stats(grid, w1, b1), k)
                  for k in ("es_voxel", "stats_combine")}
    n3 = batch * n ** 3
    # the grid as the path hands it over (f32), d0 written, the statistics;
    # the 1x1 conv's products on bf16 operands, and the fold's ~10 f32
    # operations per d0 element
    nbytes = grid.numel() * grid.element_size() + n3 * 64 * 2 + batch * 4 * 4 * 64 \
        + 10 * 64 * 2 + 64 * 4
    bms, by = bound_ms(nbytes, 2.0 * n3 * 10 * 64, f32_ops=10.0 * n3 * 64)
    # the voxel pass alone writes one partial per CTA; the combine reads them
    g_vox = voxel_pass_grid(batch, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    part_bytes = batch * g_vox * 5 * 64 * 4
    launch_bounds = {
        "es_voxel": bound_ms(nbytes - batch * 4 * 4 * 64 + part_bytes, 2.0 * n3 * 10 * 64,
                             f32_ops=10.0 * n3 * 64),
        "stats_combine": bound_ms(part_bytes + batch * 4 * 4 * 64, 0.0)}
    row = dict(shape=tag, max_abs_err=errs["d0"]["max_abs_err"], errs=errs,
               d0_frac_differing=d0_frac, planted_xy_swapped_kp_err=planted, ms=ms,
               plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
               launch_device_ms=dev_ms, device_ms=sum(dev_ms.values()),
               launch_bound_ms={k: v[0] for k, v in launch_bounds.items()},
               launch_bound_by={k: v[1] for k, v in launch_bounds.items()})
    details.setdefault("encoder_stats", []).append(row)
    log(f"[kernels] encoder_stats {tag}: " + ", ".join(
        f"{k} err {v['max_abs_err']:.3g} (tol {v['tol']:.3g})" for k, v in errs.items())
        + f", {d0_frac:.2e} of d0 differs; two launches bit-equal; planted xy swap kp err "
        f"{planted:.3g}; {ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms ({by}); device "
        + ", ".join(f"{k} {v:.4f} (bound {launch_bounds[k][0]:.4f})" for k, v in dev_ms.items()))
    del grid, ref
    torch.cuda.empty_cache()
    return d0


# K6 at the shapes the dense-grid paths give it: d0 and u at 100^3 (with K5 or
# K8 off), the decoder grid (C = 128; 192 with two heads) at 100^3 batch 1 and
# 8, and d0 at f32 (the plain f32 path's statistics at 50^3)
STATS_SHAPES = (((1, 100, 64), "bfloat16"), ((1, 20, 128), "bfloat16"),
                ((8, 20, 128), "bfloat16"), ((1, 10, 192), "bfloat16"),
                ((1, 50, 64), "float32"))


def check_stats_head(rng, details):
    """K6 against its plain version on d0-like features (bf16-rounded lrelu of
    a normal) at each of ``STATS_SHAPES``: its launch's device time beside its
    bound, and ``torch.amax`` over the same tensor's spatial axes, a read-rate
    yardstick that computes less (no PyTorch call computes K6's function).
    Faults planted through the real kernel must fail: swapped 'xy' positions;
    CTA 0's tiles skipped, on the grid with a row above every channel's max
    put in tile 0 (CTA 0's first), where its loss shows in every channel;
    the last CTA's merge without its rescale. Then ``check_stats_head_counter``."""
    import torch
    from voxactb_tpu_torch.ops.cuda.stats_head import (
        launch_stats_head, stats_head, stats_head_reference)

    dev = torch.device(DEVICE)

    def faulty(x, fault):
        kp = torch.full((x.shape[0], 3 * x.shape[-1]), float("nan"), device=dev)
        gmax = torch.full((x.shape[0], x.shape[-1]), float("nan"), device=dev)
        launch_stats_head(x, kp, gmax, fault=fault)
        return kp, gmax

    rows = []
    for (b, n, c), dtype in STATS_SHAPES:
        g = torch.Generator(device="cpu").manual_seed(int(rng.integers(1 << 30)))
        x = torch.randn(b, n, n, n, c, generator=g).to(dev)
        x = torch.where(x >= 0, x, 0.02 * x).to(getattr(torch, dtype))
        tag = f"[{b},{n}^3,{c}] {dtype}"
        got = stats_head(x)
        again = stats_head(x)
        ref = stats_head_reference(x)
        kp_swapped, _ = stats_head(swapped_xy(x))
        hot = x.clone()
        hot[:, 0, 0, 0, :] = x.amax(dim=(1, 2, 3)) + 1
        ref_hot = stats_head_reference(hot)
        planted = dict(xy_swapped=(kp_swapped, ref[0]),
                       skip_cta=(faulty(hot, "skip_cta")[0], ref_hot[0]),
                       no_rescale=(faulty(x, "no_rescale")[0], ref[0]))
        torch.cuda.synchronize()
        errs = hold("stats_head", tag, ("kp", "gmax"), got, ref, again)
        hold("stats_head", tag + " hot row", ("kp", "gmax"), stats_head(hot), ref_hot,
             stats_head(hot))
        planted = {k: max_err(*v) for k, v in planted.items()}
        for k, v in planted.items():  # NaN (outputs left unwritten) fails too
            expect(not v <= errs["kp"]["tol"], f"stats_head {tag}: planted {k} erred by {v} only")
        ms = time_ms(lambda: stats_head(x))
        plain = time_ms(lambda: stats_head_reference(x), reps=5)
        dev_ms = device_ms(lambda: stats_head(x), "stats_head_kernel")
        amax = lambda: torch.amax(x, dim=(1, 2, 3))  # noqa: E731
        amax_ms, amax_dev = time_ms(amax), device_ms(amax, None)
        # x read once, kp and gmax written; ~10 f32 operations per element
        bms, by = bound_ms(x.numel() * x.element_size() + b * 4 * 4 * c, 0.0,
                           f32_ops=10.0 * x.numel())
        row = dict(shape=tag, max_abs_err=errs["kp"]["max_abs_err"], errs=errs,
                   planted_kp_err=planted, ms=ms, plain_ms=plain, bound_ms=bms,
                   bound_by=by, library_ms=None, device_ms=dev_ms,
                   launch_device_ms={"stats_head_kernel": dev_ms},
                   launch_bound_ms={"stats_head_kernel": bms},
                   launch_bound_by={"stats_head_kernel": by},
                   amax_ms=amax_ms, amax_device_ms=amax_dev)
        rows.append(row)
        log(f"[kernels] stats_head {tag}: " + ", ".join(
            f"{k} err {v['max_abs_err']:.3g} (tol {v['tol']:.3g})" for k, v in errs.items())
            + "; two launches bit-equal; planted faults' kp err " + ", ".join(
                f"{k} {v:.3g}" for k, v in planted.items())
            + f"; {ms:.4f} ms, device {dev_ms:.4f} (bound {bms:.4f}, {by}), plain "
            f"{plain:.4f} ms; torch.amax (less work) {amax_ms:.4f} ms, device {amax_dev:.4f}")
        del x, hot, got, again, ref, ref_hot, kp_swapped
    torch.cuda.empty_cache()
    details["stats_head"] = rows
    details["stats_head_counter"] = check_stats_head_counter(faulty)
    return rows


def check_stats_head_counter(faulty):
    """K6's arrival counters are set back to 0 by every launch: a launch at
    [1,10^3,192] right after one at [8,20^3,128] (which shares the counters)
    gives the bits of a fresh launch, into outputs filled with NaN
    beforehand; with the planted fault that leaves the counters raised (both
    launches in the faulted launches' own workspace) it does not. Inputs from
    ``torch.Generator(device="cuda")`` seed 130."""
    import torch
    from voxactb_tpu_torch.ops.cuda.stats_head import reset_workspace, stats_head

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(130)
    big = torch.randn(8, 20, 20, 20, 128, generator=g, device=dev).to(torch.bfloat16)
    small = torch.randn(1, 10, 10, 10, 192, generator=g, device=dev).to(torch.bfloat16)
    reset_workspace()
    fresh = stats_head(small)
    runs = {}
    for fault in (None, "stale_counter"):
        faulty(big, fault)
        after = faulty(small, fault)
        torch.cuda.synchronize()
        runs[fault or "none"] = all(torch.equal(a, f) for a, f in zip(after, fresh))
        reset_workspace()
    expect(runs["none"], "stats_head: a launch after another shape differs from a fresh one")
    expect(not runs["stale_counter"],
           "stats_head: the planted stale counter left the next launch bit-equal")
    log("[kernels] stats_head counters: [1,10^3,192] after [8,20^3,128] bit-equal to a fresh "
        "launch; with the planted stale counter it is not")
    return runs


def check_decoder_v3(model, d0, rng, details, heads=1):
    """K8 against its plain version: h from the model's own ``up0.conv_in`` on
    a seeded decoder grid, its ``out_kernel``, seeded biases; ``heads=2``
    adds a seeded second trans head. A zero-padded h (the kernel's edge
    padding skipped) must fail. The u0 grid its phase GEMM wrote within 2^-7
    of ``upsample_from_table``'s largest |u0|, and bit-equal over two
    launches; the device time of each of its four launches, the phase GEMM's
    beside cuDNN's bf16 conv of the same edge-padded slab to 125 x 64
    channels. At T = 1 also the A/B of the two decoder tails on the model's
    own weights: K8 (conv_in, then the tail that makes u0 itself) against K3
    after the whole cuDNN ``up0``."""
    import torch
    import torch.nn.functional as F
    from voxactb_tpu_torch.ops.cuda.decoder_head import decoder_head
    from voxactb_tpu_torch.ops.cuda.decoder_head_v3 import (
        _table_taps, decoder_head_v3, decoder_head_v3_reference, edge_pad_slab,
        launch_decoder_head_v3, phase_weight_table, upsample_from_table)

    dev = torch.device(DEVICE)
    b, n = d0.shape[0], d0.shape[1]
    s = n // 5
    g = torch.Generator(device="cpu").manual_seed(int(rng.integers(1 << 30)))
    grid = torch.randn(b, s, s, s, model.up0.conv_in.weight.shape[1],
                       generator=g).to(dev, torch.bfloat16)
    rnd = lambda *shape, scale: (scale * torch.randn(*shape, generator=g)).to(dev)  # noqa: E731
    with torch.inference_mode():
        h, up_kernel, _ = model.up0(grid, pre_only=True)
    up_bias = rnd(64, scale=0.1)
    wf = model.final.kernel_dhwio().detach()
    bf = rnd(64, scale=0.05)
    wt = model.trans_decoder.kernel_dhwio().detach()[None]
    if heads == 2:
        wt = torch.cat([wt, rnd(*wt.shape[1:], scale=float(wt.std()))[None]])
    bt = rnd(heads, scale=0.01)
    args = (d0, h, up_kernel.detach(), up_bias, wf, bf, wt, bt)
    tag = f"N={n} B={b} T={heads}"
    with torch.inference_mode():
        got = decoder_head_v3(*args)
        again = decoder_head_v3(*args)
        ref = decoder_head_v3_reference(*args)
        table = phase_weight_table(up_kernel.float())
        zero_padded = F.pad(h, (0, 0, 1, 1, 1, 1, 1, 1))
        wrong = launch_decoder_head_v3(d0, zero_padded, table, up_bias, wf, bf, wt, bt)[0]
        hp = edge_pad_slab(h)
        first = launch_decoder_head_v3(d0, hp, table, up_bias, wf, bf, wt, bt)
        second = launch_decoder_head_v3(d0, hp, table, up_bias, wf, bf, wt, bt)
        table_bf = table.to(torch.bfloat16)
        u0_ref = upsample_from_table(h, table_bf, up_bias, torch.bfloat16)
        torch.cuda.synchronize()
    expect(tuple(got[0].shape) == (b, n, n, n, heads), f"decoder_head_v3 trans shape "
                                                       f"{tuple(got[0].shape)}")
    errs = hold("decoder_head_v3", tag, ("trans", "kp", "gmax"), got, ref, again)
    argmax_same = bool((got[0].reshape(b, -1, heads).argmax(1)
                        == ref[0].reshape(b, -1, heads).argmax(1)).all())
    planted = max_err(wrong, ref[0])
    expect(planted > errs["trans"]["tol"],
           f"decoder_head_v3 {tag}: a zero-padded h erred by {planted} only")
    # u0: kernel and plain phase conv round the same f32 sum once, in another
    # order, so u0 sits within an ulp of its own size
    e_u0 = max_err(first[3], u0_ref)
    tol_u0 = 2.0 ** -7 * float(u0_ref.float().abs().max())
    expect(e_u0 <= tol_u0, f"decoder_head_v3 {tag}: u0 err {e_u0} > {tol_u0}")
    expect(all(torch.equal(x, y) for x, y in zip(first, second)),
           f"decoder_head_v3 {tag}: two launches (u0 included) differ")
    del got, again, wrong, zero_padded, first, second
    with torch.inference_mode():
        ms = time_ms(lambda: decoder_head_v3(*args))
        plain = time_ms(lambda: decoder_head_v3_reference(*args), reps=3, warmup=1)
        dev_ms = {k: device_ms(lambda: decoder_head_v3(*args), k)
                  for k in ("phase_gemm", "tail_conv", "tail_trans_stats", "stats_combine")}
        pg_plain = time_ms(lambda: upsample_from_table(h, table_bf, up_bias, torch.bfloat16),
                           reps=5)
        # the phase GEMM's yardstick: cuDNN's bf16 k3 conv of the edge-padded
        # slab to the 125 x 64 (phase, channel) outputs, channels last
        xc = hp.permute(0, 4, 1, 2, 3)
        wc = _table_taps(table_bf).permute(0, 1, 6, 7, 4, 2, 3, 5).reshape(
            125 * 64, 64, 3, 3, 3).contiguous(memory_format=torch.channels_last_3d)
        pg_lib = time_ms(lambda: F.conv3d(xc, wc))
    del table, table_bf, u0_ref, xc, wc
    n3, s3 = b * n ** 3, b * s ** 3
    nbytes = d0.numel() * 2 + h.numel() * 2 + up_kernel.numel() * 4 + wf.numel() * 4 \
        + wt.numel() * 4 + (64 + 64 + heads) * 4 + n3 * heads * 4 + b * 4 * 4 * 64
    flops = 2.0 * s3 * 27 * 64 * 125 * 64 + 2.0 * n3 * 27 * 128 * 64 \
        + 2.0 * n3 * 27 * 64 * heads
    bms, by = bound_ms(nbytes, flops)
    # the phase GEMM alone: hp and the table read, u0 written, the bias
    pg_flops = 2.0 * s3 * 27 * 64 * 125 * 64
    pg_bms, pg_by = bound_ms(hp.numel() * 2 + 27 * 125 * 64 * 64 * 2 + n3 * 64 * 2 + 64 * 4,
                             pg_flops)
    row = dict(shape=tag, max_abs_err=errs["trans"]["max_abs_err"], errs=errs,
               argmax_same=argmax_same, planted_zero_pad_trans_err=planted, ms=ms,
               plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
               u0_err=e_u0, u0_tol=tol_u0,
               device_ms=dev_ms, phase_gemm_plain_ms=pg_plain,
               phase_gemm_library_ms=pg_lib, phase_gemm_bound_ms=pg_bms,
               phase_gemm_bound_by=pg_by,
               phase_gemm_tflops=pg_flops / dev_ms["phase_gemm"] / 1e9)
    if heads == 1:
        def v3_tail():
            h_, k_, b_ = model.up0(grid, pre_only=True)
            return decoder_head_v3(d0, h_, k_, b_, wf, bf, wt, bt)

        def k3_tail():
            return decoder_head(d0, model.up0(grid), wf, bf, wt, bt)

        with torch.inference_mode():  # in turns: K8, K3, K3, K8
            ab = [time_ms(f, reps=5) for f in (v3_tail, k3_tail, k3_tail, v3_tail)]
        row["ab_v3_tail_ms"] = statistics.mean((ab[0], ab[3]))
        row["ab_k3_cudnn_up0_tail_ms"] = statistics.mean((ab[1], ab[2]))
        row["ab_runs_ms"] = ab
    details.setdefault("decoder_head_v3", []).append(row)
    log(f"[kernels] decoder_head_v3 {tag}: " + ", ".join(
        f"{k} err {v['max_abs_err']:.3g} (tol {v['tol']:.3g})" for k, v in errs.items())
        + f", argmax same {argmax_same}, u0 err {e_u0:.3g} (tol {tol_u0:.3g}); two launches "
        f"bit-equal (u0 too); planted zero-padded h trans err {planted:.3g}; {ms:.4f} ms, "
        f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}); device: phase GEMM "
        f"{dev_ms['phase_gemm']:.4f} ms ({row['phase_gemm_tflops']:.1f} TFLOP/s, bound "
        f"{pg_bms:.4f}, cuDNN {pg_lib:.4f}, plain {pg_plain:.4f}), conv "
        f"{dev_ms['tail_conv']:.4f}, trans/stats {dev_ms['tail_trans_stats']:.4f}, combine "
        f"{dev_ms['stats_combine']:.4f}"
        + ("" if heads != 1 else f"; A/B conv_in + K8 {row['ab_v3_tail_ms']:.4f} ms vs "
           f"cuDNN up0 + K3 {row['ab_k3_cudnn_up0_tail_ms']:.4f} ms (runs {ab})"))
    del args, ref, grid, h, hp
    torch.cuda.empty_cache()


# K4 at the train step's shapes (50^3 crop, batch 8): (BH, Tq, Tk, the
# dropout of that attention in the step); `ragged` is off every tile size,
# `common_k` the self shape at BH 8 with keys sharing a large component
TRAIN_ATTENTION_SHAPES = {"cross": (8, 2048, 1077, 0.1), "self": (64, 2048, 2048, 0.1),
                          "decoder": (8, 1077, 2048, 0.0), "ragged": (2, 333, 1077, 0.1),
                          "common_k": (8, 2048, 2048, 0.1)}
TRAIN_STEP_ATTENTIONS = {"cross": 1, "self": 6, "decoder": 1}  # launches per step


def check_attention_train(rng, details):
    """K4 forward and backward against the plain version on the card."""
    import torch
    import torch.nn.functional as F
    from voxactb_tpu_torch.ops.cuda import flash_attention_train as K4

    dev = torch.device(DEVICE)
    rows = {}
    # common_k draws from a stream of its own, so that the later phases keep
    # their inputs
    streams = {"common_k": np.random.default_rng(4)}
    for name, (bh, tq, tk, step_dropout) in TRAIN_ATTENTION_SHAPES.items():
        src = streams.get(name, rng)
        g = torch.Generator(device="cpu").manual_seed(int(src.integers(1 << 30)))
        if name == "ragged":
            q, k, v = tail_inputs(g, tq, tk, dev)
        else:
            q = (torch.randn(bh, tq, 64, generator=g) * 0.125).to(dev, torch.bfloat16)
            k = torch.randn(bh, tk, 64, generator=g)
            if name == "common_k":
                # a common component that cancels in dS k (the rows of dS sum
                # to zero): an error in the row term does not
                k = torch.randn(bh, 1, 64, generator=g) + 0.1 * k
            k = k.to(dev, torch.bfloat16)
            v = torch.randn(bh, tk, 64, generator=g).to(dev, torch.bfloat16)
        d_out = torch.randn(bh, tq, 64, generator=g).to(dev, torch.bfloat16)
        seed = torch.tensor(int(src.integers(1 << 32)), dtype=torch.int64, device=dev)
        row = dict(shape=f"{name} BH={bh} Tq={tq} Tk={tk}", step_dropout=step_dropout)

        # the saved mask, bit for bit
        want = K4.keep_bits(seed, bh, tq, tk, 0.1)
        _, _, got = K4.flash_attention_train_forward(q, k, v, seed, 0.1)
        torch.cuda.synchronize()
        row["mask_words_differing"] = int((want != got).sum())
        keep = K4.unpack_keep_bits(got, tk)
        row["mask_drop_rate"] = float(1.0 - keep.float().mean())
        expect(row["mask_words_differing"] == 0,
               f"attention_train {name}: keep bits differ in "
               f"{row['mask_words_differing']} words")
        del want, got, keep

        for dropout in (0.0, 0.1):
            out, lse, bits = K4.flash_attention_train_forward(q, k, v, seed, dropout)
            dq, dk, dv = K4.flash_attention_train_backward(q, k, v, lse, d_out, bits,
                                                           dropout)
            rout, rlse = K4.plain_forward(q, k, v, seed, dropout)
            rdq, rdk, rdv = K4.plain_backward(q, k, v, rlse, d_out, seed, dropout)
            torch.cuda.synchronize()
            # kernel and plain version round at the same points and differ in
            # f32 summation order only, so a bf16 output (out, dq, dk, dv) may
            # sit one bf16 ulp of its own size away, and 2^-7 of the largest is
            # one to two ulps of it. lse is f32: a few ulps of the largest.
            tols = {"out": 2.0 ** -7, "lse": 2.0 ** -20, "dq": 2.0 ** -7, "dk": 2.0 ** -7,
                    "dv": 2.0 ** -7}
            pairs = {"out": (out, rout), "lse": (lse, rlse), "dq": (dq, rdq),
                     "dk": (dk, rdk), "dv": (dv, rdv)}
            errs = {}
            for key, (a, r) in pairs.items():
                tol = tols[key] * float(r.float().abs().max())
                errs[key] = dict(max_abs_err=max_err(a, r), tol=tol)
                expect(errs[key]["max_abs_err"] <= tol,
                       f"attention_train {name} dropout {dropout}: {key} err "
                       f"{errs[key]['max_abs_err']} > {tol}")
            row[f"dropout_{dropout}"] = errs
            if dropout > 0.0:
                # planted fault: the backward reads another seed's mask
                other = K4.keep_bits(seed + 1, bh, tq, tk, dropout)
                wrong = K4.flash_attention_train_backward(q, k, v, lse, d_out, other,
                                                          dropout)
                caught = [key for key, a in zip(("dq", "dk", "dv"), wrong)
                          if max_err(a, pairs[key][1]) > errs[key]["tol"]]
                row["planted_other_seed_bits_caught_by"] = caught
                expect(len(caught) == 3, f"attention_train {name}: a backward with "
                                         f"another seed's bits passed in {caught}")
                del other, wrong
            if name == "ragged" and dropout == 0.0:
                # planted fault: the keys zero-filled up to the next tile take part
                z = k.new_zeros(bh, -tk % 128, 64)
                wrong, _, _ = K4.flash_attention_train_forward(
                    q, torch.cat([k, z], 1), torch.cat([v, z], 1), seed, 0.0)
                e = max_err(wrong, rout)
                row["planted_unmasked_err"] = e
                expect(e > errs["out"]["tol"],
                       f"attention_train ragged: an unmasked key tail erred by {e} only")
            del out, lse, bits, dq, dk, dv, rout, rlse, rdq, rdk, rdv
        log(f"[kernels] flash_attention_train {name} BH={bh} Tq={tq} Tk={tk}: keep bits "
            f"bit-equal (drop rate {row['mask_drop_rate']:.4f}); " + "; ".join(
                f"dropout {d}: " + ", ".join(
                    f"{key} err {v_['max_abs_err']:.3g} (tol {v_['tol']:.3g})"
                    for key, v_ in row[f"dropout_{d}"].items()) for d in (0.0, 0.1)))

        # no atomics: a second launch gives the same bits
        d = step_dropout
        first = K4.flash_attention_train_forward(q, k, v, seed, d)
        first += K4.flash_attention_train_backward(q, k, v, first[1], d_out, first[2], d)
        again = K4.flash_attention_train_forward(q, k, v, seed, d)
        again += K4.flash_attention_train_backward(q, k, v, again[1], d_out, again[2], d)
        expect(all((a is None and b_ is None) or torch.equal(a, b_)
                   for a, b_ in zip(first, again)),
               f"attention_train {name}: two launches on the same inputs differ")
        del first, again

        # times at dropout 0 and 0.1 (the hash and the bits' share), the step's
        # dropout giving the row's ms
        for drop in (0.0, 0.1):
            _, lse, bits = K4.flash_attention_train_forward(q, k, v, seed, drop)
            row[f"fwd_ms_dropout_{drop}"] = time_ms(
                lambda: K4.flash_attention_train_forward(q, k, v, seed, drop), reps=5)
            row[f"bwd_ms_dropout_{drop}"] = time_ms(
                lambda: K4.flash_attention_train_backward(q, k, v, lse, d_out, bits, drop),
                reps=5)
        _, lse, bits = K4.flash_attention_train_forward(q, k, v, seed, d)
        row["fwd_ms"], row["bwd_ms"] = row[f"fwd_ms_dropout_{d}"], row[f"bwd_ms_dropout_{d}"]
        row["plain_fwd_ms"] = time_ms(lambda: K4.plain_forward(q, k, v, seed, d),
                                      reps=3, warmup=1)
        row["plain_bwd_ms"] = time_ms(lambda: K4.plain_backward(
            q, k, v, lse, d_out, seed, d), reps=3, warmup=1)
        # the library call, as [1, BH, T, 64] so that it may take its fused
        # kernel, at dropout 0 and at the step's dropout (its own mask)
        ql, kl, vl = (t.detach()[None].clone().requires_grad_() for t in (q, k, v))
        for drop in sorted({0.0, d}):
            sfx = "" if drop == 0.0 else f"_dropout_{drop}"
            with torch.no_grad():
                row[f"sdpa_fwd_ms{sfx}"] = time_ms(lambda: F.scaled_dot_product_attention(
                    ql, kl, vl, dropout_p=drop, scale=1.0), reps=5)
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, dropout_p=drop, scale=1.0)
            row[f"sdpa_bwd_ms{sfx}"] = time_ms(lambda: torch.autograd.grad(
                lib_out, (ql, kl, vl), d_out[None], retain_graph=True), reps=5)
            del lib_out
        sfx = "" if d == 0.0 else f"_dropout_{d}"
        row["library_fwd_ms"] = row[f"sdpa_fwd_ms{sfx}"]
        row["library_bwd_ms"] = row[f"sdpa_bwd_ms{sfx}"]
        del ql, kl, vl, lse, bits
        flops = 4.0 * bh * tq * tk * 64
        qkv_bytes = 2.0 * (bh * tq * 64 + 2 * bh * tk * 64)
        bits_bytes = 4.0 * bh * tq * (-(-tk // 32)) if d > 0.0 else 0.0
        row["fwd_bound_ms"], row["fwd_bound_by"] = bound_ms(
            qkv_bytes + 2.0 * bh * tq * 64 + 4.0 * bh * tq + bits_bytes, flops)
        row["bwd_bound_ms"], row["bwd_bound_by"] = bound_ms(
            2.0 * qkv_bytes + 2.0 * 2 * bh * tq * 64 + 4.0 * bh * tq + bits_bytes,
            2.5 * flops)
        rows[name] = row
        log(f"[kernels] flash_attention_train {name} at dropout {d}: forward "
            f"{row['fwd_ms']:.4f} ms (at dropout 0 {row['fwd_ms_dropout_0.0']:.4f}, 0.1 "
            f"{row['fwd_ms_dropout_0.1']:.4f}; plain {row['plain_fwd_ms']:.4f}, sdpa "
            f"{row['sdpa_fwd_ms']:.4f} at dropout 0, {row['library_fwd_ms']:.4f} at {d}; "
            f"bound {row['fwd_bound_ms']:.4f} {row['fwd_bound_by']}); backward "
            f"{row['bwd_ms']:.4f} ms (at dropout 0 {row['bwd_ms_dropout_0.0']:.4f}, 0.1 "
            f"{row['bwd_ms_dropout_0.1']:.4f}; plain {row['plain_bwd_ms']:.4f}, sdpa "
            f"{row['sdpa_bwd_ms']:.4f} at dropout 0, {row['library_bwd_ms']:.4f} at {d}; "
            f"bound {row['bwd_bound_ms']:.4f} {row['bwd_bound_by']})")
        torch.cuda.empty_cache()
    details["flash_attention_train"] = rows
    return rows


# K7 at the SAM ViT-H encoder's shapes at 1024^2, head dim 80: (BH, kh, kw) of
# a global block (16 heads over the 64 x 64 token grid), of a windowed one
# (25 windows of 14 x 14 tokens x 16 heads), and of the ragged case, two heads
# of one window (T = 196 = 3 * 64 + 4); then a global block at head dim 64
# (SAM ViT-B / ViT-L) and a grid of odd width (the kernel's bias lookup for
# odd kw)
def mask_splits(bh, heads=8):
    """The rank splits of the train step's self-attention rows ``[B * heads]``
    that ``check_mask_splits`` holds: (case, [(rows, MaskIndex)] per rank)."""
    from voxactb_tpu_torch.ops.cuda.flash_attention_train import MaskIndex

    rows = np.arange(bh).reshape(-1, heads)
    b, h = rows.shape[0] // 2, heads // 2
    return [("tp2", [(rows[:, t * h:(t + 1) * h].reshape(-1), MaskIndex(h, heads, 0, t * h))
                     for t in range(2)]),
            ("dp2", [(rows[d * b:(d + 1) * b].reshape(-1), MaskIndex(heads, heads, d * b, 0))
                     for d in range(2)])]


def check_mask_splits(details):
    """K4's keep bits on a rank's share of the train step's self shape (batch
    8, 8 heads) split over tp 2 and dp 2: bit-equal to the rows of
    ``keep_bits`` of the whole, with the rank's ``MaskIndex``; the second
    rank's launch with its offsets zeroed must differ."""
    import torch
    from voxactb_tpu_torch.ops.cuda import flash_attention_train as K4

    dev = torch.device(DEVICE)
    bh, tq, tk, dropout = TRAIN_ATTENTION_SHAPES["self"]
    g = torch.Generator(device="cpu").manual_seed(23)
    q, k, v = ((torch.randn(bh, t, 64, generator=g) * 0.125).to(dev, torch.bfloat16)
               for t in (tq, tk, tk))
    seed = torch.tensor(987654321, dtype=torch.int64, device=dev)
    whole = K4.keep_bits(seed, bh, tq, tk, dropout)
    report = {}
    for case, ranks in mask_splits(bh):
        differing = []
        for rows, index in ranks:
            idx = torch.as_tensor(rows, device=dev)
            _, _, got = K4.flash_attention_train_forward(q[idx], k[idx], v[idx], seed, dropout,
                                                         index)
            differing.append(int((got != whole[idx]).sum()))
        rows, index = ranks[1]
        idx = torch.as_tensor(rows, device=dev)
        _, _, zeroed = K4.flash_attention_train_forward(
            q[idx], k[idx], v[idx], seed, dropout,
            index._replace(batch_offset=0, head_offset=0))
        torch.cuda.synchronize()
        report[case] = dict(words_differing=differing, words=int(whole[idx].numel()),
                            zeroed_offsets_words_differing=int((zeroed != whole[idx]).sum()))
        expect(not any(differing), f"attention_train mask split {case}: keep bits differ from "
                                   f"the whole batch's rows in {differing} words")
        expect(report[case]["zeroed_offsets_words_differing"] > 0,
               f"attention_train mask split {case}: zeroed offsets drew the same bits")
    details["attention_train_mask_splits"] = report
    log(f"[kernels] K4 keep bits on a rank's rows of the self shape: "
        + "; ".join(f"{c}: {r['words_differing']} words differ of {r['words']} per rank, "
                    f"{r['zeroed_offsets_words_differing']} with the offsets zeroed"
                    for c, r in report.items()))


SAM_ATTENTION_SHAPES = {"global": (16, 64, 64), "windowed": (400, 14, 14),
                        "ragged": (2, 14, 14), "global_hd64": (16, 64, 64),
                        "odd_grid": (2, 9, 7)}
SAM_HD = 80
SAM_CASE_HD = {"global_hd64": 64}


def sam_attention_inputs(g, name, bh, kh, kw, dev, hd=SAM_HD):
    """q (pre-scaled, bf16), k, v and the f32 rel terms. The ragged case's
    real logits sit near -10 with a rel_h term of spread 2 and a small rel_w
    term, and its values are near +1 in head 0 and -1 in head 1: keys past T
    (logit 0 plus a small bias) would dominate their rows, and a rel_h read by
    the key's grid column (h and w swapped) reweights every row."""
    import torch

    t = kh * kw
    if name == "ragged":
        sign = torch.tensor([1.0, -1.0]).reshape(2, 1, 1)
        q = sign * 0.25 + 0.05 * torch.randn(bh, t, hd, generator=g)
        k = -sign * 0.5 + 0.2 * torch.randn(bh, t, hd, generator=g)
        v = sign + 0.5 * torch.randn(bh, t, hd, generator=g)
        rel_h = 2.0 * torch.randn(bh, t, kh, generator=g)
        rel_w = 0.25 * torch.randn(bh, t, kw, generator=g)
    else:
        q = torch.randn(bh, t, hd, generator=g) * hd ** -0.5
        k = torch.randn(bh, t, hd, generator=g)
        v = torch.randn(bh, t, hd, generator=g)
        rel_h = 0.5 * torch.randn(bh, t, kh, generator=g)
        rel_w = 0.5 * torch.randn(bh, t, kw, generator=g)
    bf = torch.bfloat16
    return (q.to(dev, bf), k.to(dev, bf), v.to(dev, bf), rel_h.to(dev), rel_w.to(dev))


def sam_unmasked_tail(q, k, v, rel_h, rel_w, kh, kw):
    """K7 with the keys past T in the last key tile taking part: the grid
    grows by enough rows of zero keys and values (and zero rel_h columns) to
    cover that tile, so each such key enters its row with logit rel_w. A
    planted fault, run through the real kernel; returns the first T rows."""
    import torch.nn.functional as F
    from voxactb_tpu_torch.ops.cuda.sam_attention import KEY_TILE, global_rel_attention

    t = kh * kw
    kh2 = kh + -(-(-t % KEY_TILE) // kw)
    pad = kh2 * kw - t
    rows = lambda x: F.pad(x, (0, 0, 0, pad))
    out = global_rel_attention(rows(q), rows(k), rows(v), F.pad(rel_h, (0, kh2 - kh, 0, pad)),
                               rows(rel_w), kh=kh2, kw=kw)
    return out[:, :t]


def sam_dropped_columns(q, k, v, rel_h, rel_w, kh, kw):
    """K7 without head-dim columns 64-79 in q k^T (q and k zeroed there), what
    the kernel computes if it skips the narrow box. A planted fault, run
    through the real kernel."""
    from voxactb_tpu_torch.ops.cuda.sam_attention import global_rel_attention

    q2, k2 = q.clone(), k.clone()
    q2[..., 64:] = 0
    k2[..., 64:] = 0
    return global_rel_attention(q2, k2, v, rel_h, rel_w, kh=kh, kw=kw)


def check_sam_attention(rng, details):
    """K7 against its plain version on the card at the encoder's two shapes, a
    ragged case that planted faults must fail, a global block at head dim 64
    and a grid of odd width; two launches bit-equal."""
    import torch
    import torch.nn.functional as F
    from voxactb_tpu_torch.ops.cuda.sam_attention import global_rel_attention
    from voxactb_tpu_torch.ops.sam_attention import global_rel_attention_plain

    dev = torch.device(DEVICE)
    rows = {}
    for name, (bh, kh, kw) in SAM_ATTENTION_SHAPES.items():
        hd = SAM_CASE_HD.get(name, SAM_HD)
        g = torch.Generator(device="cpu").manual_seed(int(rng.integers(1 << 30)))
        q, k, v, rel_h, rel_w = sam_attention_inputs(g, name, bh, kh, kw, dev, hd)
        t = kh * kw
        got = global_rel_attention(q, k, v, rel_h, rel_w, kh=kh, kw=kw)
        ref = global_rel_attention_plain(q, k, v, rel_h, rel_w, kh=kh, kw=kw)
        again = global_rel_attention(q, k, v, rel_h, rel_w, kh=kh, kw=kw)
        torch.cuda.synchronize()
        # kernel and plain version round P and the output at the same points
        # and differ in f32 summation order only: an output may sit one bf16
        # ulp of its own size away, and 2^-7 of the largest is one to two ulps
        ref_max = float(ref.float().abs().max())
        tol = 2.0 ** -7 * ref_max
        err = max_err(got, ref)
        expect(err <= tol, f"sam_attention {name}: err {err} > {tol}")
        expect(torch.equal(got, again), f"sam_attention {name}: two launches differ")
        wrong = {}
        if name == "ragged":
            wrong = {"rel_h_w_swapped": lambda: global_rel_attention(q, k, v, rel_w, rel_h,
                                                                     kh=kw, kw=kh),
                     "unmasked_tail": lambda: sam_unmasked_tail(q, k, v, rel_h, rel_w, kh,
                                                                kw)}
        if hd == 80 and name in ("global", "ragged"):
            wrong["dropped_columns"] = lambda: sam_dropped_columns(q, k, v, rel_h, rel_w,
                                                                   kh, kw)
        planted = {}
        for fault, run in wrong.items():
            planted[fault] = max_err(run(), ref)
            expect(planted[fault] > tol, f"sam_attention {name}: planted fault {fault} "
                                         f"err {planted[fault]} within {tol}")
        del got, again
        ms = time_ms(lambda: global_rel_attention(q, k, v, rel_h, rel_w, kh=kh, kw=kw))
        dev_ms = device_ms(lambda: global_rel_attention(q, k, v, rel_h, rel_w, kh=kh, kw=kw),
                           "attention_fwd")
        plain = time_ms(lambda: global_rel_attention_plain(q, k, v, rel_h, rel_w, kh=kh,
                                                           kw=kw), reps=5)
        # the library call on [1, BH, T, hd] with the whole [BH, T, T] bias built
        # beforehand (SDPA takes a float mask in the operands' dtype); the call
        # alone is timed
        bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(bh, t, t).to(q.dtype)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=bias[None], scale=1.0))
        del bias
        nbytes = 2.0 * 4 * bh * t * hd + 4.0 * bh * t * (kh + kw)
        flops = 4.0 * bh * t * t * hd
        bms, by = bound_ms(nbytes, flops)
        rows[name] = dict(shape=f"{name} BH={bh} T={t} kh={kh} kw={kw} hd={hd}",
                          max_abs_err=err, tol=tol, ref_max=ref_max,
                          planted_fault_err=planted, ms=ms, device_ms=dev_ms, plain_ms=plain,
                          library_ms=lib, bound_ms=bms, bound_by=by)
        log(f"[kernels] sam_attention {name} BH={bh} T={t} kh={kh} kw={kw} hd={hd}: err "
            f"{err:.3g} (tol {tol:.3g}), two launches bit-equal" + "".join(
                f", planted {f} err {e:.3g}" for f, e in planted.items())
            + f"; {ms:.4f} ms (device {dev_ms:.4f}), plain {plain:.4f} ms, sdpa with the "
            f"bias {lib:.4f} ms, bound {bms:.4f} ms ({by})")
        del q, k, v, rel_h, rel_w, ref
        torch.cuda.empty_cache()
    details["sam_attention"] = rows
    return rows


def bf16_ulps(a, b):
    """Distance in bf16 ulps of two bf16 tensors (as ordered integers)."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    return (ordered(a) - ordered(b)).abs()


def bf16_ulp(v):
    """One bf16 ulp at the magnitude of ``v`` (f32)."""
    import torch

    _, e = torch.frexp(v.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v), e - 8)


# ViT-H's block: width, heads, head dim, MLP width, grid, window, and how many
# launches of each window layout one encoder pass makes (28 windowed blocks, 4
# global; ln_rows twice a block, the second on the grid's rows)
SAM_BLOCK = dict(c=1280, heads=16, hd=80, hidden=5120, grid=64, window=14)
SAM_BLOCK_PER_PASS = {"ln_rows.windowed": 28, "ln_rows.global": 36,
                      "qkv_split.windowed": 28, "qkv_split.global": 4, "bias_gelu": 32,
                      "bias_residual.windowed": 28, "bias_residual.global": 36}


def check_sam_block(rng, details):
    """SAM's block kernels (``ops/cuda/sam_block``) against their plain
    versions at ViT-H's shapes, windowed (the 70^2-padded layout) and global:
    ``bias_gelu``, ``bias_residual`` and q/k/v bit-equal; LayerNorm within
    ``ln_rows_bound`` plus one bf16 ulp (the shares one ulp and more apart
    logged); the rel terms within 2 * hd *
    2^-24 * sum |q||t|; two launches bit-equal. Each timed (wrapper call and
    device time) beside its bound and the plain version (wrapper call and
    device time of all its launches), and summed per encoder pass."""
    import torch
    from voxactb_tpu_torch.models.blocks import rounded
    from voxactb_tpu_torch.ops.cuda import sam_block as B

    dev = torch.device(DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(1 << 30)))
    c, heads, hd, hidden, grid, ws = (SAM_BLOCK[k] for k in
                                      ("c", "heads", "hd", "hidden", "grid", "window"))

    def bf(shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    tokens = grid * grid
    x = bf((1, grid, grid, c), 3.0) + 0.5
    w = torch.randn(c, generator=g, device=dev) * 0.3 + 1
    b = torch.randn(c, generator=g, device=dev) * 0.3
    scale = rounded(hd ** -0.5, torch.bfloat16)
    cases = {}
    for window in (ws, 0):
        tag = "windowed" if window else "global"
        kh = window or grid
        rows = B.padded_grid(grid, grid, window)[0] ** 2
        qkv, qb = bf((rows, 3 * c), 2.0), bf((3 * c,), 0.5)
        tabs = tuple(torch.randn(2 * kh - 1, hd, generator=g, device=dev) * 0.1
                     for _ in range(2))
        y, yb = bf((rows, c)), bf((c,), 0.5)
        qk = dict(heads=heads, grid=(kh, kh), scale=scale, rel_pos=tabs)
        cases[f"ln_rows.{tag}"] = dict(
            kernel=lambda window=window: B.ln_rows(x, w, b, eps=1e-6, window=window),
            plain=lambda window=window: B.ln_rows_plain(x, w, b, eps=1e-6, window=window),
            bound=lambda window=window: B.ln_rows_bound(x, w, eps=1e-6, window=window),
            name="sam_ln_rows", nbytes=2.0 * (tokens + rows) * c + 8.0 * c, f32_ops=0.0)
        cases[f"qkv_split.{tag}"] = dict(
            kernel=lambda qkv=qkv, qb=qb, qk=qk: B.qkv_split(qkv, qb, **qk),
            plain=lambda qkv=qkv, qb=qb, qk=qk: B.qkv_split_plain(qkv, qb, **qk),
            bound=lambda qkv=qkv, qb=qb, qk=qk, tabs=tabs: B.qkv_split_plain(
                (qkv + qb).abs(), torch.zeros_like(qb), **{
                    **qk, "rel_pos": tuple(t.abs() for t in tabs)}),
            name="sam_qkv_split",
            nbytes=2.0 * 2 * rows * 3 * c + 4.0 * rows * heads * 2 * kh,
            f32_ops=2.0 * rows * heads * 2 * kh * hd)
        cases[f"bias_residual.{tag}"] = dict(
            kernel=lambda y=y, yb=yb, window=window: B.bias_residual(x, y, yb, window=window),
            plain=lambda y=y, yb=yb, window=window: B.bias_residual_plain(x, y, yb,
                                                                        window=window),
            name="sam_bias_residual", nbytes=2.0 * 3 * tokens * c, f32_ops=0.0)
    h, hb = bf((tokens, hidden), 3.0), bf((hidden,))
    cases["bias_gelu"] = dict(kernel=lambda: B.bias_gelu(h, hb),
                              plain=lambda: B.bias_gelu_plain(h, hb), name="sam_bias_gelu",
                              nbytes=2.0 * 2 * tokens * hidden, f32_ops=0.0)
    report, per_pass = {}, {}
    for key, case in cases.items():
        got, want, again = case["kernel"](), case["plain"](), case["kernel"]()
        torch.cuda.synchronize()
        row = {}
        if key.startswith("ln_rows"):
            # the statistics sum in another f32 order: within their bound plus
            # one bf16 ulp; more than one ulp apart only where the output
            # cancels to near 0
            d = bf16_ulps(got, want)
            err = (got.float() - want.float()).abs()
            tol = case["bound"]() + bf16_ulp(torch.maximum(got.float().abs(),
                                                           want.float().abs()))
            row.update(one_ulp_share=float((d == 1).float().mean()),
                       beyond_one_ulp=int((d > 1).sum()),
                       err_of_bound=float((err / tol).max()))
            expect(bool((err <= tol).all()), f"sam_block {key}: beyond its sum-order bound")
        elif key.startswith("qkv_split"):
            for i in range(3):
                expect(torch.equal(got[i], want[i]), f"sam_block {key}: q/k/v[{i}] differ")
            bound = case["bound"]()
            worst = 0.0
            for i in (3, 4):
                err = (got[i] - want[i]).abs()
                lim = 2 * hd * 2.0 ** -24 * bound[i]
                expect(bool((err <= lim).all()), f"sam_block {key}: rel term beyond its bound")
                worst = max(worst, float((err / lim.clamp_min(1e-30)).max()))
            row["rel_err_of_bound"] = worst
            got, again = torch.cat([t.flatten().float() for t in got]), \
                torch.cat([t.flatten().float() for t in again])
        else:
            expect(torch.equal(got, want), f"sam_block {key}: not bit-equal to plain")
        expect(torch.equal(got, again), f"sam_block {key}: two launches differ")
        del got, want, again
        bms, by = bound_ms(case["nbytes"], 0.0, case["f32_ops"])
        row.update(ms=time_ms(case["kernel"]), device_ms=device_ms(case["kernel"], case["name"]),
                   plain_ms=time_ms(case["plain"], reps=5),
                   plain_device_ms=device_ms(case["plain"], None, reps=3),
                   bound_ms=bms, bound_by=by)
        row["roofline_pct"] = 100.0 * bms / row["device_ms"]
        report[key] = row
        n = SAM_BLOCK_PER_PASS[key]
        for k in ("device_ms", "plain_device_ms", "bound_ms"):
            per_pass[k] = per_pass.get(k, 0.0) + n * row[k]
        log(f"[kernels] sam_block {key}: {row['ms']:.4f} ms (device {row['device_ms']:.4f}, "
            f"{row['roofline_pct']:.1f}% of its bound {bms:.4f} ms, {by}); plain "
            f"{row['plain_ms']:.4f} ms (device {row['plain_device_ms']:.4f})" + "".join(
                f", {k} {row[k]:.3g}" for k in ("one_ulp_share", "beyond_one_ulp",
                                                 "err_of_bound", "rel_err_of_bound")
                if k in row) + ", two launches bit-equal")
    report["per_pass"] = per_pass
    log(f"[kernels] sam_block per ViT-H pass: device {per_pass['device_ms']:.3f} ms, bound "
        f"{per_pass['bound_ms']:.3f} ms, plain versions' device {per_pass['plain_device_ms']:.3f}"
        " ms")
    details["sam_block"] = report
    del x, h
    torch.cuda.empty_cache()
    return report


# K2 and K4 at head dims the kernels are not built for (zero-padded to 64 or
# 128 by their wrappers): (name, head dim, K2's [BH, Tq, Tk], K4's [BH, Tq,
# Tk, dropout]). Round 5's 32 and 96 in (64, 128] at the full model's cross
# shapes (an act at 50^3 batch 8, the train step at batch 8), then round 5's
# own attention shapes (latents 64, 8 heads of 32 in self attention; an act
# at batch 1, a train step at batch 4); K7 below 64 on two heads of one
# 14 x 14 window.
HEAD_DIM_CASES = (("32", 32, (8, 2048, 1077), (8, 2048, 1077, 0.1)),
                  ("96", 96, (8, 2048, 1077), (8, 2048, 1077, 0.1)),
                  ("round5_cross", 32, (1, 64, 1077), (4, 64, 1077, 0.1)),
                  ("round5_self", 32, (8, 64, 64), (32, 64, 64, 0.1)),
                  ("round5_decoder", 32, (1, 1077, 64), (4, 1077, 64, 0.1)))
HEAD_DIM_SAM = (32, (2, 14, 14))


def noise_padded(launch, width, n_operands=3, sliced=None):
    """A kernel's launcher fed its first ``n_operands`` arguments padded on
    the head dim with standard normals (seeded) instead of zeros, a pad that
    is not exact, its head-dim outputs sliced back. (A constant pad would
    shift each row of logits by one constant, which the softmax ignores.) A
    planted fault, run through the real kernel."""
    import torch

    def fn(*args, **kw):
        hd = args[0].shape[-1]
        g = torch.Generator(device=args[0].device).manual_seed(11)
        ops = []
        for x in args[:n_operands]:
            pad = torch.randn(*x.shape[:-1], width - hd, generator=g, device=x.device)
            ops.append(torch.cat([x, pad.to(x.dtype)], -1).contiguous())
        out = launch(*ops, *args[n_operands:], **kw)
        if sliced is None:
            return out[..., :hd]
        return tuple(o[..., :hd] if i in sliced else o for i, o in enumerate(out))
    return fn


def check_head_dims(rng, details):
    """K2 and K4 (forward, dQ, dK, dV) at head dims 32 and 96 and at round 5's
    shapes (``HEAD_DIM_CASES``), and K7 at 32, against their plain versions
    on the card at the tolerances of the head dim 64 checks; a pad of noise
    instead of zeros must fail each; two launches bit-equal; times beside the
    plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from voxactb_tpu_torch.ops.cuda import flash_attention as K2
    from voxactb_tpu_torch.ops.cuda import flash_attention_train as K4
    from voxactb_tpu_torch.ops.cuda import sam_attention as K7
    from voxactb_tpu_torch.ops.cuda.head_dim import kernel_head_dim
    from voxactb_tpu_torch.ops.sam_attention import global_rel_attention_plain

    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    rows = {"flash_attention": {}, "flash_attention_train": {}, "sam_attention": {}}

    def randn(g, *shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, bf)

    for name, hd, k2_shape, k4_shape in HEAD_DIM_CASES:
        # K2
        bh, tq, tk = k2_shape
        width = kernel_head_dim(hd, K2.HEAD_DIMS, "flash_attention")
        g = torch.Generator(device="cpu").manual_seed(int(rng.integers(1 << 30)))
        q, k, v = randn(g, bh, tq, hd, scale=hd ** -0.5), randn(g, bh, tk, hd), randn(
            g, bh, tk, hd)
        ref = K2.flash_attention_reference(q, k, v)
        got, again = K2.flash_attention(q, k, v), K2.flash_attention(q, k, v)
        torch.cuda.synchronize()
        tol = 2.0 ** -7 * float(ref.float().abs().max())
        err = max_err(got, ref)
        expect(got.shape == ref.shape and err <= tol,
               f"attention head dim {hd}: err {err} > {tol}")
        expect(torch.equal(got, again), f"attention head dim {hd}: two launches differ")
        fault = max_err(noise_padded(K2._launch, width)(q, k, v, schedule=0), ref)
        expect(fault > tol, f"attention head dim {hd}: a pad of noise erred by {fault} only")
        flops = 4.0 * bh * tq * tk * hd
        bms, by = bound_ms(2.0 * (2 * bh * tq * hd + 2 * bh * tk * hd), flops)
        row = dict(shape=f"BH={bh} Tq={tq} Tk={tk} hd={hd} (kernel {width})",
                   max_abs_err=err, tol=tol, planted_noise_pad_err=fault,
                   ms=time_ms(lambda: K2.flash_attention(q, k, v)),
                   device_ms=device_ms(lambda: K2.flash_attention(q, k, v), "attention_fwd"),
                   plain_ms=time_ms(lambda: K2.flash_attention_reference(q, k, v), reps=5),
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                       q[None], k[None], v[None], scale=1.0)),
                   bound_ms=bms, bound_by=by)
        rows["flash_attention"][name] = row
        log(f"[kernels] flash_attention {row['shape']}: err {err:.3g} (tol {tol:.3g}), two "
            f"launches bit-equal, planted noise_pad err {fault:.3g}; {row['ms']:.4f} ms "
            f"(device {row['device_ms']:.4f}), plain {row['plain_ms']:.4f}, sdpa "
            f"{row['library_ms']:.4f}, bound {bms:.4f} ({by})")
        del q, k, v, ref, got, again

        # K4
        bh, tq, tk, drop = k4_shape
        width = kernel_head_dim(hd, K4.HEAD_DIMS, "flash_attention_train")
        q, k, v = randn(g, bh, tq, hd, scale=hd ** -0.5), randn(g, bh, tk, hd), randn(
            g, bh, tk, hd)
        d_out = randn(g, bh, tq, hd)
        seed = torch.tensor(int(rng.integers(1 << 32)), dtype=torch.int64, device=dev)
        row = dict(shape=f"BH={bh} Tq={tq} Tk={tk} hd={hd} (kernel {width})")
        tols = {"out": 2.0 ** -7, "lse": 2.0 ** -20, "dq": 2.0 ** -7, "dk": 2.0 ** -7,
                "dv": 2.0 ** -7}
        for dropout in (0.0, drop):
            out, lse, bits = K4.flash_attention_train_forward(q, k, v, seed, dropout)
            grads = K4.flash_attention_train_backward(q, k, v, lse, d_out, bits, dropout)
            rout, rlse = K4.plain_forward(q, k, v, seed, dropout)
            refs = dict(zip(("dq", "dk", "dv"), K4.plain_backward(q, k, v, rlse, d_out, seed,
                                                                   dropout)))
            pairs = {"out": (out, rout), "lse": (lse, rlse),
                     **{key: (a, refs[key]) for key, a in zip(("dq", "dk", "dv"), grads)}}
            errs = {}
            for key, (a, r) in pairs.items():
                t = tols[key] * float(r.float().abs().max())
                errs[key] = dict(max_abs_err=max_err(a, r), tol=t)
                expect(a.shape == r.shape and errs[key]["max_abs_err"] <= t,
                       f"attention_train head dim {hd} dropout {dropout}: {key} err "
                       f"{errs[key]['max_abs_err']} > {t}")
            if dropout > 0.0:
                want = K4.keep_bits(seed, bh, tq, tk, dropout)
                expect(torch.equal(bits, want), f"attention_train head dim {hd}: keep bits")
                again = K4.flash_attention_train_forward(q, k, v, seed, dropout)
                again += K4.flash_attention_train_backward(q, k, v, again[1], d_out,
                                                           again[2], dropout)
                expect(all(torch.equal(a, b_) for a, b_ in zip((out, lse, bits, *grads),
                                                               again)),
                       f"attention_train head dim {hd}: two launches differ")
                # planted: the operands and dO padded with noise
                w_out = noise_padded(K4._launch_forward, width, sliced=(0,))(
                    q, k, v, seed, dropout)[0]
                w_grads = noise_padded(K4._launch_backward, width, n_operands=4,
                                      sliced=(0, 1, 2))(q, k, v, d_out, lse, bits, dropout)
                planted = {"out": max_err(w_out, rout), **{
                    key: max_err(a, refs[key]) for key, a in zip(("dq", "dk", "dv"),
                                                                 w_grads)}}
                caught = [key for key, e in planted.items() if e > errs[key]["tol"]]
                row["planted_noise_pad_err"] = planted
                expect(len(caught) == 4, f"attention_train head dim {hd}: a pad of noise "
                                         f"passed in {set(planted) - set(caught)}")
                del again, w_out, w_grads
            row[f"dropout_{dropout}"] = errs
        _, lse, bits = K4.flash_attention_train_forward(q, k, v, seed, drop)
        row.update(
            fwd_ms=time_ms(lambda: K4.flash_attention_train_forward(q, k, v, seed, drop),
                           reps=5),
            bwd_ms=time_ms(lambda: K4.flash_attention_train_backward(q, k, v, lse, d_out,
                                                                     bits, drop), reps=5),
            fwd_device_ms=device_ms(lambda: K4.flash_attention_train_forward(
                q, k, v, seed, drop), "train_fwd", reps=5),
            bwd_device_ms=device_ms(lambda: K4.flash_attention_train_backward(
                q, k, v, lse, d_out, bits, drop), "train_bwd", reps=5),
            plain_fwd_ms=time_ms(lambda: K4.plain_forward(q, k, v, seed, drop), reps=3,
                                 warmup=1),
            plain_bwd_ms=time_ms(lambda: K4.plain_backward(q, k, v, lse, d_out, seed, drop),
                                 reps=3, warmup=1))
        ql, kl, vl = (t.detach()[None].clone().requires_grad_() for t in (q, k, v))
        with torch.no_grad():
            row["library_fwd_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, dropout_p=drop, scale=1.0), reps=5)
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, dropout_p=drop, scale=1.0)
        row["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), d_out[None], retain_graph=True), reps=5)
        flops = 4.0 * bh * tq * tk * hd
        qkv_bytes = 2.0 * (bh * tq * hd + 2 * bh * tk * hd)
        bits_bytes = 4.0 * bh * tq * (-(-tk // 32))
        row["fwd_bound_ms"], row["fwd_bound_by"] = bound_ms(
            qkv_bytes + 2.0 * bh * tq * hd + 4.0 * bh * tq + bits_bytes, flops)
        row["bwd_bound_ms"], row["bwd_bound_by"] = bound_ms(
            2.0 * qkv_bytes + 2.0 * 2 * bh * tq * hd + 4.0 * bh * tq + bits_bytes,
            2.5 * flops)
        rows["flash_attention_train"][name] = row
        log(f"[kernels] flash_attention_train {row['shape']}: " + "; ".join(
            f"dropout {d}: " + ", ".join(f"{key} err {e['max_abs_err']:.3g} (tol "
                                         f"{e['tol']:.3g})"
                                         for key, e in row[f"dropout_{d}"].items())
            for d in (0.0, drop)) + ", keep bits bit-equal, two launches bit-equal, planted "
            "noise_pad " + ", ".join(f"{key} {e:.3g}"
                                    for key, e in row["planted_noise_pad_err"].items())
            + f"; forward {row['fwd_ms']:.4f} ms (device {row['fwd_device_ms']:.4f}, plain "
            f"{row['plain_fwd_ms']:.4f}, sdpa {row['library_fwd_ms']:.4f}, bound "
            f"{row['fwd_bound_ms']:.4f}), backward {row['bwd_ms']:.4f} ms (device "
            f"{row['bwd_device_ms']:.4f}, plain {row['plain_bwd_ms']:.4f}, sdpa "
            f"{row['library_bwd_ms']:.4f}, bound {row['bwd_bound_ms']:.4f})")
        del q, k, v, d_out, lse, bits, ql, kl, vl, lib_out
        torch.cuda.empty_cache()

    # K7 below 64, on the ragged window case's inputs
    hd, (bh, kh, kw) = HEAD_DIM_SAM
    width = kernel_head_dim(hd, K7.HEAD_DIMS, "sam_attention")
    g = torch.Generator(device="cpu").manual_seed(int(rng.integers(1 << 30)))
    q, k, v, rel_h, rel_w = sam_attention_inputs(g, "ragged", bh, kh, kw, dev, hd)
    run = lambda: K7.global_rel_attention(q, k, v, rel_h, rel_w, kh=kh, kw=kw)  # noqa: E731
    ref = global_rel_attention_plain(q, k, v, rel_h, rel_w, kh=kh, kw=kw)
    got, again = run(), run()
    torch.cuda.synchronize()
    tol = 2.0 ** -7 * float(ref.float().abs().max())
    err = max_err(got, ref)
    expect(got.shape == ref.shape and err <= tol,
           f"sam_attention head dim {hd}: err {err} > {tol}")
    expect(torch.equal(got, again), f"sam_attention head dim {hd}: two launches differ")
    fault = max_err(noise_padded(K7._launch, width)(q, k, v, rel_h, rel_w, kh=kh, kw=kw), ref)
    expect(fault > tol, f"sam_attention head dim {hd}: a pad of noise erred by {fault} only")
    t = kh * kw
    bms, by = bound_ms(2.0 * 4 * bh * t * hd + 4.0 * bh * t * (kh + kw), 4.0 * bh * t * t * hd)
    row = dict(shape=f"BH={bh} T={t} kh={kh} kw={kw} hd={hd} (kernel {width})",
               max_abs_err=err, tol=tol, planted_noise_pad_err=fault, ms=time_ms(run),
               device_ms=device_ms(run, "attention_fwd"),
               plain_ms=time_ms(lambda: global_rel_attention_plain(
                   q, k, v, rel_h, rel_w, kh=kh, kw=kw), reps=5), bound_ms=bms, bound_by=by)
    rows["sam_attention"][str(hd)] = row
    log(f"[kernels] sam_attention {row['shape']}: err {err:.3g} (tol {tol:.3g}), two "
        f"launches bit-equal, planted noise_pad err {fault:.3g}; {row['ms']:.4f} ms (device "
        f"{row['device_ms']:.4f}), plain {row['plain_ms']:.4f}, bound {bms:.4f} ({by})")
    details["head_dims"] = rows
    return rows


# ---------------------------------------------------------------------------
# phases 3-4: the act path
# ---------------------------------------------------------------------------


def act_config(n, **kw):
    from voxactb_tpu_torch.config import MethodConfig

    return MethodConfig(voxel_sizes=[n], compute_dtype="bfloat16", pallas_front=True,
                        pallas_attention=True, pallas_decoder=True, **kw)


def plain_config(cfg, dtype=None):
    """The same config with the kernel flags off (the plain path), at
    ``dtype`` if one is given."""
    import dataclasses

    extra = {} if dtype is None else {"compute_dtype": dtype}
    return dataclasses.replace(cfg, pallas_front=False, pallas_attention=False,
                               pallas_decoder=False, pallas_encoder=False,
                               pallas_stats=False, pallas_decoder_v3=False, **extra)


def act_inputs(rng, batch, low_dim):
    rgbs, pcds = clouds(rng, batch)
    return dict(rgbs=rgbs, pcds=pcds,
                proprio=rng.normal(size=(batch, low_dim)).astype(np.float32),
                lang_goal_emb=rng.normal(size=(batch, 1024)).astype(np.float32),
                lang_token_embs=rng.normal(size=(batch, 77, 512)).astype(np.float32))


def reference_model(cfg, model_on, dtype):
    """The plain path's model at ``dtype`` with ``model_on``'s weights."""
    from voxactb_tpu_torch.agents.qfunction import build_encoder

    model = build_encoder(plain_config(cfg, dtype), device=DEVICE, seed=0)
    model.load_state_dict(model_on.state_dict())
    return model


def path_outputs(cfg, model, inputs, bounds):
    """The Q-net's outputs, as f32, on one batch of observations."""
    import torch
    from voxactb_tpu_torch.agents.qfunction import apply_with_front, normalize_rgb
    from voxactb_tpu_torch.ops.voxelize import flatten_camera_observations

    dev = torch.device(DEVICE)
    b = inputs["proprio"].shape[0]
    t = lambda x: torch.as_tensor(x, device=dev)
    with torch.inference_mode():
        coords, feats = flatten_camera_observations(
            [normalize_rgb(t(r)) for r in inputs["rgbs"]], [t(p) for p in inputs["pcds"]])
        bnd = torch.broadcast_to(t(np.asarray(bounds, np.float32)).reshape(-1, 6), (b, 6))
        out, _, _ = apply_with_front(cfg, model, coords, feats, bnd, t(inputs["proprio"]),
                                     t(inputs["lang_goal_emb"]),
                                     t(inputs["lang_token_embs"]))
    return {k: v.float() for k, v in out.items()}


@contextlib.contextmanager
def wrapped(owner, attr, wrap):
    """Replace ``owner.attr`` by ``wrap(original)`` for the block."""
    orig = getattr(owner, attr)
    setattr(owner, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def planted(module, attr, wrap):
    """Replace a kernel wrapper by ``wrap(wrapper)`` for the block (the port
    looks its wrappers up at call time)."""
    import importlib

    return wrapped(importlib.import_module(module), attr, wrap)


def swapped_decoder_taps(decoder_head):
    """K3 fed its 3x3x3 taps with the depth and width axes swapped: a layout
    fault between the module and the kernel. A planted fault."""
    def fn(d0, u0, wf, *rest):
        return decoder_head(d0, u0, wf.transpose(0, 2), *rest)
    return fn


# planted faults run through the kernel path of act100_b1: (name, wrapper
# module, wrapper, fault, whether the act-level comparison must catch it)
ACT_FAULTS = (
    ("decoder_taps_swapped", "voxactb_tpu_torch.ops.cuda.decoder_head", "decoder_head",
     swapped_decoder_taps, True),
    ("attention_unmasked", "voxactb_tpu_torch.ops.cuda.flash_attention",
     "flash_attention", unmasked_attention, False),
)


# outputs that share a tolerance: the MLP heads' logits come from one feature
# vector through two-layer heads of one initialisation scale (rot_grip and
# collision are even slices of one Dense output), so they carry bf16 noise of
# one size; a group of 2 logits alone would give no estimate of it. The
# two-head variant's ``*_right`` / ``*_left`` outputs fall into the same groups.
def tol_group(key: str) -> str:
    return "trans" if key.startswith("trans") else "logits"


def compare_paths(cfg, model_on, refs, inputs, bounds, tag, details, faults=()):
    """Kernel path vs the plain path at bf16 on the same weights and inputs.

    The tolerance of each group of outputs is twice the plain bf16 path's own
    distance from the plain path at f32 (max abs over the group): if the
    kernel path is no less accurate than the plain bf16 path, the triangle
    inequality keeps the two within it. An integer action may flip only where
    the plain path's top-two gap is within that tolerance.
    """
    on = path_outputs(cfg, model_on, inputs, bounds)
    off = path_outputs(plain_config(cfg), refs["bfloat16"], inputs, bounds)
    f32 = path_outputs(plain_config(cfg, "float32"), refs["float32"], inputs, bounds)
    b = inputs["proprio"].shape[0]
    nr = cfg.num_rotation_classes
    report = {}
    for group in ("trans", "logits"):
        keys = [k for k in on if tol_group(k) == group]
        plain_err = max(max_err(off[k], f32[k]) for k in keys)
        for k in keys:
            report[k] = dict(max_abs_err=max_err(on[k], off[k]), tol=2.0 * plain_err,
                             plain_vs_f32=max_err(off[k], f32[k]),
                             kernel_vs_f32=max_err(on[k], f32[k]),
                             ref_range=float(off[k].max() - off[k].min()))
    bad = [k for k, v in report.items() if v["max_abs_err"] > v["tol"]]
    # integer actions: a flip is allowed only at a near-tie of the plain path;
    # each argmax group as (output key, columns)
    rot = [slice(i * nr, (i + 1) * nr) for i in range(3)] + [slice(3 * nr, None)]
    groups = [(k, sl) for k in on
              for sl in (rot if k.startswith("rot_grip") else [slice(None)])]
    flips, bad_flips = 0, 0
    for key, cols in groups:
        a, r = on[key].reshape(b, -1)[:, cols], off[key].reshape(b, -1)[:, cols]
        tol = report[key]["tol"]
        ia, ir = a.argmax(-1), r.argmax(-1)
        top2 = r.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        for bi in range(b):
            if int(ia[bi]) != int(ir[bi]):
                flips += 1
                if float(gap[bi]) > tol:
                    bad_flips += 1
    report["action_flips"] = flips
    report["flips_beyond_near_tie"] = bad_flips
    log(f"[{tag}] kernel vs plain path: " + ", ".join(
        f"{k} err {v['max_abs_err']:.3g} (tol {v['tol']:.3g}; plain bf16 vs f32 "
        f"{v['plain_vs_f32']:.3g}, kernel vs f32 {v['kernel_vs_f32']:.3g}, range "
        f"{v['ref_range']:.3g})"
        for k, v in report.items() if isinstance(v, dict))
        + f"; {flips} argmax flips, {bad_flips} beyond a near-tie")
    planted_report = {}
    for name, module, attr, wrap, must_catch in faults:
        with planted(module, attr, wrap):
            wrong = path_outputs(cfg, model_on, inputs, bounds)
        errs = {k: max_err(wrong[k], off[k]) for k in on}
        caught = [k for k in on if errs[k] > report[k]["tol"]]
        planted_report[name] = dict(errs=errs, caught_by=caught)
        log(f"[{tag}] planted fault {name}: " + ", ".join(
            f"{k} err {e:.3g}" for k, e in errs.items())
            + f"; beyond tolerance in {caught or 'no output'}")
        expect(bool(caught) or not must_catch,
               f"{tag}: planted fault {name} stayed within tolerance")
    report["planted_faults"] = planted_report
    details.setdefault("path_compare", {})[tag] = report
    expect(not bad, f"{tag}: kernel vs plain beyond tolerance in {bad}")
    expect(bad_flips == 0, f"{tag}: {bad_flips} action flips beyond a near-tie")
    return report


def act100(rng, details, timings):
    return act_phase("act100", act_config(100, which_arm="right"), ACT_FAULTS, rng, details,
                     timings)


def act_phase(tag, cfg, faults, rng, details, timings):
    """``make_infer_fn`` of ``cfg`` at 100^3, batch 1 (10 calls) and 8 (5
    calls): kernels on against kernels off on the same weights under the act
    rule (``faults`` planted at batch 1), then the timed main-path run, with
    one profiled call at batch 1."""
    import torch
    from voxactb_tpu_torch.agents.qfunction import make_infer_fn
    from voxactb_tpu_torch.ops import cuda as kernels

    model_on, infer = make_infer_fn(cfg, device=DEVICE, seed=0)
    model_off, infer_off = make_infer_fn(plain_config(cfg), device=DEVICE, seed=0)
    model_off.load_state_dict(model_on.state_dict())
    refs = {"bfloat16": model_off, "float32": reference_model(cfg, model_on, "float32")}
    runs = {}
    for batch, reps in ((1, 10), (8, 5)):
        inputs = act_inputs(rng, batch, cfg.low_dim_size())
        bounds = [SCENE_BOUNDS] * batch
        compare_paths(cfg, model_on, refs, inputs, bounds, f"{tag}_b{batch}",
                      details, faults=faults if batch == 1 else ())
        args = (inputs["rgbs"], inputs["pcds"], inputs["proprio"],
                inputs["lang_goal_emb"], inputs["lang_token_embs"], bounds)
        out = infer(model_on, *args)  # warm
        out_off = infer_off(model_off, *args)
        torch.cuda.synchronize()
        cont = out.continuous_action
        expect(tuple(cont.shape) == (batch, 9) and bool(torch.isfinite(cont).all()),
               f"{tag} continuous action")
        expect(bool(((out.trans_idx >= 0) & (out.trans_idx < 100)).all()),
               f"{tag} trans idx range")
        differ = int((out.trans_idx != out_off.trans_idx).sum()
                     + (out.rot_grip_idx != out_off.rot_grip_idx).sum()
                     + (out.collision_idx != out_off.collision_idx).sum())
        details["path_compare"][f"{tag}_b{batch}"]["integer_action_elements_differing"] = (
            differ)

        def drive(m, f, n_acts):
            walls = []
            for _ in range(n_acts):
                t0 = time.perf_counter()
                o = f(m, *args)
                o.continuous_action.cpu()
                walls.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(walls)

        plain_ms = drive(model_off, infer_off, max(2, reps // 2))
        kernels.reset_launch_counts()
        ms = drive(model_on, infer, reps)
        counts = kernels.launch_counts()
        runs[batch] = dict(acts=reps, launches=counts)
        if batch == 1:
            profile_act(lambda: infer(model_on, *args).continuous_action.cpu(),
                        f"{tag}_b1", details, ms)
        timings[f"{tag}_b{batch}"] = dict(ms_per_call=ms, plain_ms_per_call=plain_ms,
                                          batch=batch, ms_per_act=ms / batch,
                                          integer_action_elements_differing=differ)
        log(f"[{tag}] batch {batch}: {ms:.3f} ms/call ({ms / batch:.3f} ms/act) "
            f"kernels on, {plain_ms:.3f} ms/call plain; {differ} integer action "
            f"elements differ; launches in {reps} calls: {counts}")
    del model_on, model_off, refs
    torch.cuda.empty_cache()
    return dict(acts=sum(r["acts"] for r in runs.values()),
                launches={k: sum(r["launches"][k] for r in runs.values())
                          for k in runs[1]["launches"]},
                per_batch=runs)


def profile_act(fn, tag, details, act_ms, top=12):
    """One call (an act, a train step) under torch.profiler: device time by
    kernel (device-side events only, so no kernel is counted twice through the
    op that launched it) and the device's busy share of ``act_ms``, the call's
    median wall time measured without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.is_user_annotation]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    # the replicate pads the call made, by input shape
    pads = [dict(op=e.key, input_shapes=[list(x) for x in e.input_shapes if x], calls=e.count)
            for e in prof.key_averages(group_by_input_shape=True)
            if e.device_type == DeviceType.CPU and "replication_pad" in e.key]
    details.setdefault("profile", {})[tag] = dict(
        act_ms=act_ms, device_ms=device_ms, busy_share=device_ms / act_ms,
        kernels=[dict(name=k[:120], ms=ms, calls=c) for k, ms, c in rows],
        replicate_pads=pads)
    log(f"[profile] {tag}: device busy {device_ms:.3f} ms of the {act_ms:.3f} ms call "
        f"({100 * device_ms / act_ms:.1f}%)")
    for k, ms, c in rows[:top]:
        log(f"[profile]   {ms:8.3f} ms  x{c:<4d} {k[:90]}")


def dual50(rng, details, timings, n_acts=25):
    import torch
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.ops import cuda as kernels

    cams = ["wrist", "wrist2"]
    cfg_act = act_config(50, which_arm="dominant", arm_pred_loss=True,
                         crop_target_obj_voxel=True, crop_radius=0.3)
    cfg_stab = act_config(50, which_arm="assistive", crop_target_obj_voxel=True,
                          crop_radius=0.3)
    acting = QAttentionBCAgent(cfg_act, cams, SCENE_BOUNDS, device=DEVICE, seed=0)
    stabilizing = QAttentionBCAgent(cfg_stab, cams, SCENE_BOUNDS, device=DEVICE,
                                    seed=1)
    acting.build(training=False)
    stabilizing.build(training=False)

    # the acting policy's Q-field against the plain path on one observation
    refs = {d: reference_model(cfg_act, acting.params, d) for d in ("bfloat16", "float32")}
    inputs = act_inputs(rng, 1, cfg_act.low_dim_size())
    compare_paths(cfg_act, acting.params, refs, inputs, [CROP_BOUNDS], "dual50", details)
    del refs

    def observation(t):
        rgbs, pcds = clouds(rng, 1)
        obs = {"lang_goal_emb": rng.normal(size=(1024,)).astype(np.float32),
               "lang_token_embs": rng.normal(size=(77, 512)).astype(np.float32)}
        for c, r, p in zip(cams, rgbs, pcds):
            obs[f"{c}_rgb"], obs[f"{c}_point_cloud"] = r[0], p[0]
        time_ch = (1.0 - t / (n_acts - 1)) * 2.0 - 1.0
        for arm in ("left", "right"):
            obs[f"low_dim_state_{arm}_arm"] = np.asarray(
                [1.0, 0.02, 0.02, time_ch], np.float32)
        return obs

    episode = [observation(t) for t in range(n_acts)]
    # warm both policies once outside the timed episode
    for agent, arm in ((acting, "dominant"), (stabilizing, "assistive")):
        agent.act(0, episode[0], which_arm=arm, new_scene_bounds=CROP_BOUNDS,
                  dominant_assitive_policy=True)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    walls = []
    for t, obs in enumerate(episode):
        agent, arm = (acting, "dominant") if t % 2 == 0 else (stabilizing, "assistive")
        t0 = time.perf_counter()
        res = agent.act(t, obs, which_arm=arm, new_scene_bounds=CROP_BOUNDS,
                        dominant_assitive_policy=True)
        walls.append((time.perf_counter() - t0) * 1e3)
        a = np.asarray(res.action)
        expect(a.shape == (9,) and bool(np.isfinite(a).all()), "dual50 action")
        idx = np.asarray(res.observation_elements["trans_action_indicies"])
        expect(bool(((idx >= 0) & (idx < 50)).all()), "dual50 trans idx range")
        lo, hi = np.asarray(CROP_BOUNDS[:3]), np.asarray(CROP_BOUNDS[3:])
        expect(bool(((a[:3] >= lo) & (a[:3] <= hi)).all()), "dual50 action in crop")
        expect(abs(float(np.linalg.norm(a[3:7])) - 1.0) < 1e-3, "dual50 quaternion")
    counts = kernels.launch_counts()
    ms = statistics.median(walls)
    profile_act(lambda: acting.act(0, episode[0], which_arm="dominant",
                                   new_scene_bounds=CROP_BOUNDS,
                                   dominant_assitive_policy=True), "dual50_act", details, ms)
    timings["dual50"] = dict(ms_per_act_median=ms, ms_per_act_mean=statistics.mean(walls),
                             acts=n_acts)
    log(f"[dual50] {n_acts}-act dual-policy episode at 50^3: {ms:.3f} ms/act median, "
        f"{statistics.mean(walls):.3f} mean; launches: {counts}")
    return dict(acts=n_acts, launches=counts)


def two_head50(rng, details):
    """One act of the 'one_policy_more_heads' variant at 50^3 (two proprio
    streams, right and left heads, K3 with trans [B,N,N,N,2])."""
    cfg = act_config(50, which_arm="both", variant="one_policy_more_heads",
                     crop_target_obj_voxel=True, crop_radius=0.3)
    return checked_act("two_head50", cfg, 2, CROP_BOUNDS, rng, details,
                       want={"decoder_head": 1, "front_fused": 1, "flash_attention": 8,
                             "decoder_tail_trans_stats": 1, "front_patchify": 1})


def checked_act(tag, cfg, seed, bounds, rng, details, want, faults=()):
    """One act of ``cfg``: kernels on against kernels off under the act-level
    tolerance (``faults`` planted as ``compare_paths`` plants them), then the
    act itself, whose launches must be ``want``."""
    import torch
    from voxactb_tpu_torch.agents.qfunction import make_infer_fn
    from voxactb_tpu_torch.ops import cuda as kernels

    n = cfg.voxel_size
    model_on, infer = make_infer_fn(cfg, device=DEVICE, seed=seed)
    refs = {d: reference_model(cfg, model_on, d) for d in ("bfloat16", "float32")}
    inputs = act_inputs(rng, 1, cfg.proprio_width())
    compare_paths(cfg, model_on, refs, inputs, [bounds], tag, details, faults=faults)
    del refs
    kernels.reset_launch_counts()
    out = infer(model_on, inputs["rgbs"], inputs["pcds"], inputs["proprio"],
                inputs["lang_goal_emb"], inputs["lang_token_embs"], [bounds])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    cont = out.continuous_action
    two = cfg.variant == "one_policy_more_heads"
    expect(tuple(cont.shape) == ((2, 1, 9) if two else (1, 9))
           and bool(torch.isfinite(cont).all()), f"{tag} continuous action")
    expect(bool(((out.trans_idx >= 0) & (out.trans_idx < n)).all()), f"{tag} trans idx range")
    expect(all(counts[k] == v for k, v in want.items()), f"{tag} launches {counts}")
    heads = (f"right {cont[0, 0, :3].tolist()}, left {cont[1, 0, :3].tolist()}" if two
             else f"{cont[0, :3].tolist()}")
    log(f"[{tag}] one act at {n}^3: {heads}; launches: {counts}")
    del model_on
    torch.cuda.empty_cache()
    return dict(acts=1, launches=counts)


# ---------------------------------------------------------------------------
# phase 5: the dense-grid act path (voxelize -> K5 -> Perceiver with K6 -> K8)
# ---------------------------------------------------------------------------


def dense_config(n, **kw):
    """The act program on the dense voxel grid (``pallas_front=False``), the
    path that hands out the real grid: K5 makes d0 and its statistics, K6 the
    decoder grid's, K8 the decoder tail from the post-``conv_in`` slab, K2
    the attention."""
    from voxactb_tpu_torch.config import MethodConfig

    return MethodConfig(voxel_sizes=[n], compute_dtype="bfloat16", pallas_front=False,
                        pallas_encoder=True, pallas_stats=True, pallas_decoder_v3=True,
                        pallas_attention=True, **kw)


# one dense-grid act's launches
DENSE_LAUNCHES = {"encoder_stats": 1, "stats_head": 1, "decoder_head_v3": 1,
                  "flash_attention": 8, "front_fused": 0, "decoder_head": 0,
                  "decoder_tail_conv": 1, "decoder_tail_trans_stats": 1,
                  "decoder_phase_gemm": 1, "front_patchify": 1}


def swapped_phase_axes(phase_weight_table):
    """K8 fed a phase table with its ry and rx axes swapped: a layout fault
    between the table and the kernel. A planted fault."""
    def fn(up_kernel, scale=5):
        t = phase_weight_table(up_kernel, scale)
        rows, c = t.shape[2], t.shape[3] // (3 * scale)
        return t.reshape(scale, scale, rows, 3, scale, c).transpose(1, 4).reshape(t.shape)
    return fn


DENSE_FAULTS = (
    ("phase_table_ry_rx_swapped", "voxactb_tpu_torch.ops.cuda.decoder_head_v3",
     "phase_weight_table", swapped_phase_axes, True),
)


def dense100(rng, details, timings):
    """The dense-grid act path at 100^3, batch 1 and 8, as ``act100``; every
    call launches K5, K6 and K8 once and K2 eight times."""
    run = act_phase("dense100", dense_config(100, which_arm="right"), DENSE_FAULTS, rng,
                    details, timings)
    for batch, r in run["per_batch"].items():
        expect(all(r["launches"][k] == v * r["acts"] for k, v in DENSE_LAUNCHES.items()),
               f"dense100 batch {batch}: launches {r['launches']} in {r['acts']} calls")
    # the patchify reads d0 as it is: no replicate pad of a d0-sized tensor
    pads = details["profile"]["dense100_b1"]["replicate_pads"]
    d0_sized = [pad for pad in pads
                if any(int(np.prod(shape)) >= 100 ** 3 * 64 for shape in pad["input_shapes"])]
    expect(not d0_sized, f"dense100_b1 pads a d0-sized tensor: {d0_sized}")
    log(f"[dense100] replicate pads in the profiled call: "
        f"{[(pad['input_shapes'], pad['calls']) for pad in pads]}")
    return run


def dense_agent_act(rng, details):
    """One ``QAttentionBCAgent.act`` on the dense-grid path at 100^3: its
    ``voxel_grid_depth0`` is the ``[1,100,100,100,10]`` grid that ``voxelize``
    builds from the observation's clouds, and nothing overflowed."""
    import torch
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.agents.qfunction import normalize_rgb
    from voxactb_tpu_torch.ops import cuda as kernels
    from voxactb_tpu_torch.ops.voxelize import flatten_camera_observations, voxelize

    cams = ["front", "wrist"]
    cfg = dense_config(100, which_arm="right")
    n = cfg.voxel_size
    agent = QAttentionBCAgent(cfg, cams, SCENE_BOUNDS, device=DEVICE, seed=0)
    agent.build(training=False)
    rgbs, pcds = clouds(rng, 1)
    obs = {"lang_goal_emb": rng.normal(size=(1024,)).astype(np.float32),
           "lang_token_embs": rng.normal(size=(77, 512)).astype(np.float32),
           "low_dim_state_right_arm": rng.normal(size=(cfg.low_dim_size(),)).astype(
               np.float32)}
    for c, r, p in zip(cams, rgbs, pcds):
        obs[f"{c}_rgb"], obs[f"{c}_point_cloud"] = r[0], p[0]
    agent.act(0, obs, which_arm="right")  # warm
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res = agent.act(1, obs, which_arm="right")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    dev = torch.device(DEVICE)
    with torch.inference_mode():
        coords, feats = flatten_camera_observations(
            [normalize_rgb(torch.tensor(r, device=dev)) for r in rgbs],
            [torch.tensor(p, device=dev) for p in pcds])
        want = voxelize(coords, feats, torch.tensor([SCENE_BOUNDS], device=dev),
                        voxel_size=n)
    grid = res.info["voxel_grid_depth0"]
    # the scatter's atomics sum in a run-dependent order: a voxel's mean may
    # differ in its last f32 bits; the occupancy is exact
    err = max_err(grid, want)
    occupied = int(want[..., -1].sum())
    expect(tuple(grid.shape) == (1, n, n, n, 10), f"dense agent grid {grid.shape}")
    expect(err <= 1e-5 and torch.equal(grid[..., -1], want[..., -1]) and occupied > 0,
           f"dense agent: voxel_grid_depth0 differs from voxelize's grid by {err}")
    expect(res.info["front_overflow"] == 0, "dense agent: front overflow")
    a = np.asarray(res.action)
    expect(a.shape == (9,) and bool(np.isfinite(a).all()), "dense agent action")
    expect(all(counts[k] == v for k, v in DENSE_LAUNCHES.items()),
           f"dense agent launches {counts}")
    details["dense_agent_act"] = dict(grid_err=err, occupied_voxels=occupied,
                                      launches=counts, action=a.tolist())
    log(f"[dense100] QAttentionBCAgent.act: voxel_grid_depth0 {tuple(grid.shape)} within "
        f"{err:.3g} of voxelize's grid ({occupied} occupied voxels), front_overflow 0; "
        f"launches: {counts}")
    del agent, grid, want
    torch.cuda.empty_cache()
    return dict(acts=1, launches=counts)


def dense_two_head50(rng, details):
    """The dense-grid flags on the two-head variant at 50^3: K6 on a decoder
    grid of C = 192, K8 with trans [B,N,N,N,2]."""
    cfg = dense_config(50, which_arm="both", variant="one_policy_more_heads",
                       crop_target_obj_voxel=True, crop_radius=0.3)
    return checked_act("dense_two_head50", cfg, 2, CROP_BOUNDS, rng, details,
                       want=DENSE_LAUNCHES)


def stats100(rng, details):
    """``pallas_stats`` alone (with the attention kernel) at 100^3, batch 1:
    K6 takes the statistics of d0, of the decoder grid and of u."""
    from voxactb_tpu_torch.config import MethodConfig

    cfg = MethodConfig(voxel_sizes=[100], compute_dtype="bfloat16", pallas_stats=True,
                       pallas_attention=True, which_arm="right")
    return checked_act("stats100", cfg, 4, SCENE_BOUNDS, rng, details,
                       want={"stats_head": 3, "flash_attention": 8, "encoder_stats": 0,
                             "decoder_head_v3": 0, "decoder_head": 0, "front_fused": 0,
                             "decoder_phase_gemm": 0, "decoder_tail_trans_stats": 0,
                             "front_patchify": 0})


# ---------------------------------------------------------------------------
# phase 6: the VLM crop path (VoxAct-B's once-per-episode perception)
# ---------------------------------------------------------------------------

VLM_TASK = "open_drawer"
VLM_DESCRIPTION = "hold the drawer with left hand and open the bottom drawer with right hand"
VLM_FRAME = 512
# the towers at the reference's widths: OWL-ViT B/32 at 768^2 (embed 512)
# with its text tower (width 512, 12 layers, projection 512), SAM ViT-H at
# 1024^2 (sam_vit_h's arguments) with the mask decoder at its defaults, and
# the CLIP RN50 text tower of the acts (ClipLanguageEncoder's defaults)
VLM_TOWERS = dict(
    owl=dict(img_size=768, patch=32, dim=768, depth=12, heads=12), owl_embed=512,
    owl_text=dict(width=512, heads=8, layers=12, embed_dim=512),
    sam=dict(img_size=1024, embed_dim=1280, depth=32, num_heads=16,
             global_attn_indexes=(7, 15, 23, 31)),
    decoder=dict())


def vlm_frame(rng):
    """A front RGB-D frame (from numpy seed 0 in the run): a cloud spread over the workspace with the task's
    object (a 6 cm cube of points) on a 128 x 128 pixel patch, which has the
    task's colour on a dark background."""
    from voxactb_tpu_torch.vlm.pipeline import TASK_COLORS

    n = VLM_FRAME
    pcd = rng.uniform(-1, 1, (n, n, 3)).astype(np.float32)
    pcd[..., 2] += 1.0
    obj = np.zeros((n, n), bool)
    obj[n // 4:n // 4 + 128, n // 2 - 64:n // 2 + 64] = True
    pcd[obj] = np.asarray([0.2, -0.1, 0.9], np.float32) + rng.uniform(
        -0.03, 0.03, (int(obj.sum()), 3)).astype(np.float32)
    rgb = rng.integers(0, 60, (n, n, 3)).astype(np.uint8)
    rgb[obj] = TASK_COLORS[VLM_TASK].astype(np.uint8)
    return rgb, pcd


def vlm_detector(seed):
    """The kernel path's detector in bf16 with weights from ``seed``, on the
    card, built as the benchmark's cell builds it
    (``TorchOwlVitSamDetector.build``): K7 on SAM's global and windowed
    blocks, the pass replayed as CUDA graphs after its first call. The
    weights are drawn on the card from a generator there (ViT-H's 637M draws
    take minutes on the host). The rel-pos tables, zero at initialisation,
    get seeded values so that the bias path does work."""
    import torch
    from voxactb_tpu_torch.vlm.pipeline import TorchOwlVitSamDetector

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    t = VLM_TOWERS
    spec = dict(owl={**t["owl"], "embed_dim": t["owl_embed"]}, owl_text=t["owl_text"],
                sam=t["sam"], decoder=t["decoder"])
    detector = TorchOwlVitSamDetector.build(
        spec, dtype=torch.bfloat16, fused_global=True, fused_windowed=True, device=DEVICE,
        generator=g, score_threshold=0.0)
    with torch.no_grad():
        for name, p in detector._sam.encoder.named_parameters():
            if "rel_pos" in name:
                p.normal_(0.0, 0.1, generator=g)
    return detector


def served_pass(vlm, rgb, pcd, task):
    """Two VLM passes on one frame (the first captures the detector's
    graphs, the second replays them) -> the replayed pass's box and its SAM
    outputs (embedding, mask logits, IoU), as ``SamSegmenter.predict``
    returns them."""
    vlm.get_target_object_world_coords(rgb, pcd, task)
    vlm.get_target_object_world_coords(rgb, pcd, task)
    last = vlm._detector.last
    return last["box"], last["score"], (last["embedding"], last["masks"], last["iou"])


def sam_plain(seg, dtype):
    """The segmenter ``seg`` with its weights, K7 off, at ``dtype`` (built on
    the meta device, then filled). Its blocks take the block kernels at bf16
    unless the caller plants ``sam_block.ops_for``."""
    import torch
    from voxactb_tpu_torch.models.sam_decoder import SamMaskDecoder, SamSegmenter
    from voxactb_tpu_torch.models.sam_encoder import SamImageEncoder

    dt = getattr(torch, dtype)
    with torch.device("meta"):
        enc = SamImageEncoder(**VLM_TOWERS["sam"], fused_global=False, dtype=dt)
        dec = SamMaskDecoder(**VLM_TOWERS["decoder"], dtype=dt)
    enc, dec = enc.to_empty(device=DEVICE), dec.to_empty(device=DEVICE)
    enc.load_state_dict(seg.encoder.state_dict())
    dec.load_state_dict(seg.decoder.state_dict())
    return SamSegmenter(enc.eval(), dec.eval(), VLM_TOWERS["sam"]["img_size"])


def compare_sam_paths(seg, rgb, box, served, details, tag="vlm_episode"):
    """SAM's outputs ``served`` by the detector's replayed pass (its
    embedding, mask logits and IoU predictions for ``box``) against the
    plain path at bf16 on the same weights, frame and box, under the act's
    rule: each group (the image
    embedding, the mask logits, the IoU predictions) within twice the plain
    bf16 path's distance from the plain f32 path. The chosen mask may differ
    only where the plain path's top-two IoU gap is within that tolerance, and
    a mask pixel only where the plain path's |logit| is."""
    import torch

    from voxactb_tpu_torch.ops.cuda import sam_block

    groups = ("embedding", "mask_logits", "iou")
    outs = {"kernel": served}
    for dtype in ("bfloat16", "float32"):
        ref = sam_plain(seg, dtype)
        # the plain path's blocks in their eager formulation at bf16 too
        with planted("voxactb_tpu_torch.ops.cuda.sam_block", "ops_for",
                     lambda _: lambda x: sam_block.PLAIN):
            outs[dtype] = ref.predict(rgb, box)
        del ref
        torch.cuda.empty_cache()
    report = {}
    for i, g in enumerate(groups):
        on, off, f32 = (outs[p][i].float() for p in ("kernel", "bfloat16", "float32"))
        expect(bool(torch.isfinite(on).all()), f"{tag}: non-finite {g}")
        report[g] = dict(max_abs_err=max_err(on, off), tol=2.0 * max_err(off, f32),
                         plain_vs_f32=max_err(off, f32), kernel_vs_f32=max_err(on, f32),
                         ref_max=float(off.abs().max()))
    iou_on, iou_off = (outs[p][2][0].float().cpu() for p in ("kernel", "bfloat16"))
    best_on, best_off = int(iou_on.argmax()), int(iou_off.argmax())
    top2 = iou_off.topk(2).values
    gap = float(top2[0] - top2[1])
    report["mask_index"] = dict(kernel=best_on, plain=best_off, plain_top2_gap=gap)
    # the pixels, both at the plain path's choice, resized to the frame
    frame_hw = rgb.shape[:2]
    on_px = seg.mask_logits(outs["kernel"][1], frame_hw, best_off)
    off_px = seg.mask_logits(outs["bfloat16"][1], frame_hw, best_off)
    flipped = (on_px > 0) != (off_px > 0)
    tol_px = report["mask_logits"]["tol"]
    report["mask_pixels"] = dict(
        differing=int(flipped.sum()),
        beyond_tolerance=int((flipped & (off_px.abs() > tol_px)).sum()),
        area=int((off_px > 0).sum()), frame=list(frame_hw))
    details["vlm_compare" if tag == "vlm_episode" else f"{tag}_compare"] = report
    log(f"[{tag}] SAM kernel path vs plain path: " + ", ".join(
        f"{g} err {report[g]['max_abs_err']:.3g} (tol {report[g]['tol']:.3g}; plain bf16 "
        f"vs f32 {report[g]['plain_vs_f32']:.3g}, kernel vs f32 "
        f"{report[g]['kernel_vs_f32']:.3g}, largest {report[g]['ref_max']:.3g})"
        for g in groups) + f"; mask index {best_on} (plain {best_off}, top-two gap "
        f"{gap:.3g}); {report['mask_pixels']['differing']} of "
        f"{report['mask_pixels']['area']} mask pixels differ, "
        f"{report['mask_pixels']['beyond_tolerance']} beyond the tolerance")
    bad = [g for g in groups if report[g]["max_abs_err"] > report[g]["tol"]]
    expect(not bad, f"{tag}: kernel vs plain beyond tolerance in {bad}")
    expect(best_on == best_off or gap <= report["iou"]["tol"],
           f"{tag}: mask index {best_on} vs {best_off} with a top-two gap {gap}")
    expect(report["mask_pixels"]["beyond_tolerance"] == 0,
           f"{tag}: mask pixels flipped beyond the tolerance")
    del outs
    torch.cuda.empty_cache()
    return report


def vlm_episode(rng, details, timings, n_acts=25):
    """The per-episode VLM crop path at full width, then a 25-act dual-policy
    episode at 50^3 inside the crop it derives, language from CLIP text."""
    import torch
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.models.clip_text import ClipLanguageEncoder
    from voxactb_tpu_torch.models.sam_encoder import preprocess_image
    from voxactb_tpu_torch.ops import cuda as kernels
    from voxactb_tpu_torch.ops.cuda import graphs
    from voxactb_tpu_torch.ops.geometry import scene_bounds_from_crop
    from voxactb_tpu_torch.vlm.pipeline import VLM, task_queries

    t0 = time.perf_counter()
    detector = vlm_detector(seed=3)
    owl, seg = detector._owl, detector._sam
    lang = ClipLanguageEncoder(dtype=torch.bfloat16, device=DEVICE, seed=4)
    vlm = VLM(detector)
    log(f"[vlm_episode] detector built in {time.perf_counter() - t0:.1f} s")
    rgb, pcd = vlm_frame(np.random.default_rng(0))

    # the replayed pass against the plain path, on the box OWL-ViT proposed
    query = task_queries(VLM_TASK)
    query_emb = owl.embed_queries([query])
    box, score, served = served_pass(vlm, rgb, pcd, VLM_TASK)
    compare_sam_paths(seg, rgb, box, served, details)
    del served

    cams = ["wrist", "wrist2"]
    acting = QAttentionBCAgent(act_config(50, which_arm="dominant", arm_pred_loss=True,
                                          crop_target_obj_voxel=True, crop_radius=0.3),
                               cams, SCENE_BOUNDS, lang_encoder=lang, device=DEVICE, seed=0)
    stabilizing = QAttentionBCAgent(act_config(50, which_arm="assistive",
                                               crop_target_obj_voxel=True, crop_radius=0.3),
                                    cams, SCENE_BOUNDS, lang_encoder=lang, device=DEVICE,
                                    seed=1)
    acting.build(training=False)
    stabilizing.build(training=False)
    tokens = lang.tokenize(VLM_DESCRIPTION)[0]

    def observation(t):
        rgbs, pcds = clouds(rng, 1)
        obs = {"lang_goal_tokens": tokens}
        for c, r, p in zip(cams, rgbs, pcds):
            obs[f"{c}_rgb"], obs[f"{c}_point_cloud"] = r[0], p[0]
        time_ch = (1.0 - t / (n_acts - 1)) * 2.0 - 1.0
        for arm in ("left", "right"):
            obs[f"low_dim_state_{arm}_arm"] = np.asarray([1.0, 0.02, 0.02, time_ch],
                                                         np.float32)
        return obs

    episode = [observation(t) for t in range(n_acts)]

    def run_episode():
        """VLM pass -> crop bounds -> 25 alternating acts; per-act walls."""
        t_vlm = time.perf_counter()
        point, radius = vlm.get_target_object_world_coords(rgb, pcd, VLM_TASK)
        bounds = scene_bounds_from_crop(point, radius).numpy()
        vlm_ms = (time.perf_counter() - t_vlm) * 1e3
        walls, actions = [], []
        for t, obs in enumerate(episode):
            agent, arm = (acting, "dominant") if t % 2 == 0 else (stabilizing, "assistive")
            t_act = time.perf_counter()
            res = agent.act(t, obs, which_arm=arm, new_scene_bounds=bounds,
                            dominant_assitive_policy=True)
            walls.append((time.perf_counter() - t_act) * 1e3)
            actions.append(np.asarray(res.action))
        return point, radius, bounds, vlm_ms, walls, actions

    run_episode()  # warm every path
    torch.cuda.synchronize()
    shapes = {}

    sam = VLM_TOWERS["sam"]
    window = sam.get("window_size", 14)
    n_global = len(sam["global_attn_indexes"])
    want = {"global": n_global, "windowed": sam["depth"] - n_global}

    def count_shapes(attention):
        def fn(q, k, v, rel_h, rel_w, *, kh, kw):
            key = "windowed" if (kh, kw) == (window, window) else "global"
            shapes[key] = shapes.get(key, 0) + 1
            return attention(q, k, v, rel_h, rel_w, kh=kh, kw=kw)
        return fn

    torch.cuda.reset_peak_memory_stats()
    with planted("voxactb_tpu_torch.ops.cuda.sam_attention", "global_rel_attention",
                 count_shapes):
        kernels.reset_launch_counts()
        t_ep = time.perf_counter()
        point, radius, bounds, vlm_ms, walls, actions = run_episode()
        torch.cuda.synchronize()
        episode_ms = (time.perf_counter() - t_ep) * 1e3
        counts = kernels.launch_counts()
        # a replay calls no Python entry; the shapes are read off the same
        # programs run eagerly
        replayed_shapes = dict(shapes)
        with graphs.eager():
            detector.mask_logits(rgb, query)
        torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    expect(counts["sam_attention"] == sam["depth"] and not replayed_shapes and shapes == want,
           f"vlm_episode: K7 launches {counts['sam_attention']} in one replayed VLM pass "
           f"(entries called {replayed_shapes}), eagerly by shape {shapes}")
    # SAM's block kernels: two norms, one qkv split, one bias + GELU and two
    # bias + residual passes a block
    depth = sam["depth"]
    block = {k: counts[k] for k in ("sam_ln", "sam_qkv_split", "sam_bias_gelu",
                                    "sam_bias_residual")}
    log(f"[vlm_episode] launches in one replayed VLM pass: K7 {counts['sam_attention']}, "
        + ", ".join(f"{k} {n}" for k, n in block.items()))
    expect(block == {"sam_ln": 2 * depth, "sam_qkv_split": depth, "sam_bias_gelu": depth,
                     "sam_bias_residual": 2 * depth},
           f"vlm_episode: SAM block kernel launches {block} in one replayed VLM pass")
    lo, hi = bounds[:3], bounds[3:]
    for a in actions:
        expect(a.shape == (9,) and bool(np.isfinite(a).all()), "vlm_episode action")
        expect(bool(((a[:3] >= lo) & (a[:3] <= hi)).all()),
               f"vlm_episode: action {a[:3]} outside the derived bounds {bounds}")
        expect(abs(float(np.linalg.norm(a[3:7])) - 1.0) < 1e-3, "vlm_episode quaternion")

    # stage times on the card (CUDA events), and one profiled VLM pass
    img = VLM_TOWERS["sam"]["img_size"]
    x = preprocess_image(rgb, img, torch.device(DEVICE))
    # the decoder's box as SamSegmenter.predict normalises it
    box_t = torch.as_tensor((np.asarray(box, np.float32)[None] * (img / VLM_FRAME) + 0.5)
                            / img, device=DEVICE)
    with torch.inference_mode():
        emb = seg.encoder(x)
        stage = dict(
            sam_encode_ms=time_ms(lambda: seg.encoder(x), reps=5),
            owl_detect_ms=time_ms(lambda: owl.detect(rgb, query_emb, 0.0), reps=5),
            sam_decode_ms=time_ms(lambda: seg.decoder(emb, box_t), reps=5))
    vlm_walls = []
    for _ in range(3):
        t_vlm = time.perf_counter()
        vlm.get_target_object_world_coords(rgb, pcd, VLM_TASK)
        vlm_walls.append((time.perf_counter() - t_vlm) * 1e3)
    vlm_pass_ms = statistics.median(vlm_walls)
    profile_act(lambda: vlm.get_target_object_world_coords(rgb, pcd, VLM_TASK), "vlm_pass",
                details, vlm_pass_ms)
    timings["vlm_episode"] = dict(
        vlm_pass_ms=vlm_pass_ms, vlm_pass_ms_in_episode=vlm_ms, **stage,
        ms_per_act_median=statistics.median(walls), ms_per_act_mean=statistics.mean(walls),
        episode_ms=episode_ms, acts=n_acts, peak_memory_gib=peak_gb,
        crop_point=[float(v) for v in point], crop_radius=radius,
        bounds=[float(v) for v in bounds], owl_box=[float(v) for v in box],
        owl_score=score)
    log(f"[vlm_episode] box {np.round(box, 1).tolist()} (score {score:.3f}) -> crop point "
        f"{np.round(point, 4).tolist()}, radius {radius:.4f}, bounds "
        f"{np.round(bounds, 3).tolist()}; SAM-H encode {stage['sam_encode_ms']:.3f} ms, OWL "
        f"detect {stage['owl_detect_ms']:.3f} ms, SAM decode {stage['sam_decode_ms']:.3f} "
        f"ms, VLM pass {vlm_pass_ms:.3f} ms; {statistics.median(walls):.3f} ms/act median; "
        f"episode (VLM pass + {n_acts} acts) {episode_ms:.3f} ms; peak memory "
        f"{peak_gb:.2f} GiB; launches: {counts}, K7 by shape {shapes}")
    del seg, owl, detector, vlm, acting, stabilizing, lang, emb, x
    torch.cuda.empty_cache()
    return dict(acts=n_acts, vlm_passes=1, launches=counts, sam_attention_by_shape=shapes)


# ---------------------------------------------------------------------------
# phase 7: the BC train step
# ---------------------------------------------------------------------------

TRAIN_CAMERAS = ["wrist", "wrist2"]


def train_config(**kw):
    """The configuration the repo trains: 50^3 VLM-cropped grid, bf16, dominant
    arm with the arm loss, SE(3) augmentation, LAMB, trainable attention kernel."""
    from voxactb_tpu_torch.config import MethodConfig

    base = dict(voxel_sizes=[50], which_arm="dominant", arm_pred_loss=True,
                crop_target_obj_voxel=True, crop_radius=0.3, compute_dtype="bfloat16",
                apply_se3=True, pallas_attention_train=True)
    base.update(kw)
    return MethodConfig(**base)


def train_batch(rng, cfg, b):
    """A synthetic replay batch with the bench's signature and value ranges."""
    batch = {
        "trans_action_indicies": rng.integers(0, 50, (b, 3)).astype(np.int32),
        "rot_grip_action_indicies": np.concatenate(
            [rng.integers(0, 72, (b, 3)), rng.integers(0, 2, (b, 1))], -1).astype(np.int32),
        "ignore_collisions": rng.integers(0, 2, (b, 1)).astype(np.int32),
        "gripper_pose": np.concatenate(
            [rng.uniform([-0.1, -0.3, 0.6], [0.4, 0.3, 1.0], (b, 3)),
             rng.normal(size=(b, 4))], -1).astype(np.float32),
        "lang_goal_emb": rng.normal(size=(b, 1024)).astype(np.float32),
        "lang_token_embs": rng.normal(size=(b, 77, 512)).astype(np.float32),
        "low_dim_state": rng.normal(size=(b, cfg.low_dim_size())).astype(np.float32),
        "label": rng.integers(0, 2, (b, 1)).astype(np.int32),
        "scene_bounds": np.asarray([-0.3, -0.5, 0.4, 0.5, 0.5, 1.2], np.float32),
        "target_object_scene_bounds": np.tile(np.asarray(CROP_BOUNDS, np.float32), (b, 1)),
    }
    batch["gripper_pose"][:, 3:] /= np.linalg.norm(batch["gripper_pose"][:, 3:], axis=-1,
                                                   keepdims=True)
    for c in TRAIN_CAMERAS:
        batch[f"{c}_rgb"] = rng.integers(0, 255, (b, IMG, IMG, 3)).astype(np.float32)
        batch[f"{c}_point_cloud"] = rng.uniform(-0.3, 1.2, (b, IMG, IMG, 3)).astype(
            np.float32)
    return batch


def k4_plain(_wrapper):
    """K4's wrapper replaced by its plain version (the same rounding points,
    f32 sums in another order), on the card."""
    from voxactb_tpu_torch.ops.cuda.flash_attention_train import (
        flash_attention_train_reference)

    return flash_attention_train_reference


def k4_plain_ulp(seed):
    """K4's plain version with one bf16 ulp added to 1% of its outputs
    (seeded): an error inside what the kernel checks accept (2^-7 of the
    largest output is one to two ulps), to measure what such an error does
    to a train step."""
    def wrap(_wrapper):
        import torch
        from voxactb_tpu_torch.ops.cuda.flash_attention_train import (
            flash_attention_train_reference)

        state = {}

        def fn(q, k, v, seed_, *, dropout=0.0, index=(1, 1, 0, 0)):
            g = state.setdefault("g", torch.Generator(device=q.device).manual_seed(seed))
            out = flash_attention_train_reference(q, k, v, seed_, dropout=dropout, index=index)
            flip = (torch.rand(out.shape, generator=g, device=out.device) < 0.01)
            return out * (1 + flip.to(out.dtype) * 2.0 ** -7)
        return fn
    return wrap


K4_ULP_RUNS = 4  # one-ulp perturbations of K4's plain version per noise floor


def compare_train_paths(batch, details, model=None, tag="train50", reference="plain",
                        faults=()):
    """One step's losses and gradients with dropout and augmentation off:
    kernels on (K4) against the plain attention path at bf16, on the same
    seeded weights. The tolerance is twice the plain bf16 path's own distance
    from the plain path at f32, as at act level: over the losses as one group,
    and per gradient leaf, scaled by the leaf's largest f32 gradient (a leaf
    whose own distance happens to be small gets the median leaf's). ``model``
    overrides the config's widths (round 5's model); the report goes to
    ``details`` under ``tag``'s name. With ``reference="k4_plain"`` the
    kernel path is held to the same model with K4's plain version in the
    kernel's place (``k4_plain``), and each tolerance is also at least twice
    the largest distance that ``K4_ULP_RUNS`` one-ulp perturbations of that
    plain version (``k4_plain_ulp``) put between their step and its: round
    5's small model at random weights is so sensitive that K4's rounding
    points (dS rounded to bf16, as on the TPU) fail the plain-path rule on
    about half the batches with K4's plain version alone, and a one-ulp
    change in 1% of the attention outputs fails it on two of three (on the
    CPU); the plain-path distance is one sample of that noise. ``faults``, as
    ``compare_paths``' (name, module, attribute, wrap, must catch), are run
    through the kernel path."""
    import torch
    from voxactb_tpu_torch.agents.qfunction import make_optimizer, make_train_step

    quiet = dict(apply_se3=False, input_dropout=0.0, attn_dropout=0.0)
    results = {}

    def run(kw, *plant):
        cfg = train_config(**{**(model or {}), **quiet, **kw})
        with contextlib.ExitStack() as stack:
            if plant:
                stack.enter_context(planted(*plant))
            _, init_fn, step = make_train_step(cfg, make_optimizer(cfg, 100_000),
                                               TRAIN_CAMERAS, device=DEVICE, seed=0)
            metrics, grads = step.loss_and_grads(init_fn(), batch)
            torch.cuda.synchronize()
        out = ({k: float(v) for k, v in metrics.items()},
               {k: v.float() for k, v in grads.items()})
        del step, init_fn, metrics, grads
        torch.cuda.empty_cache()
        return out

    k4 = ("voxactb_tpu_torch.ops.cuda.flash_attention_train", "flash_attention_train")
    results["on"] = run({})
    ulp = []
    if reference == "k4_plain":
        results["ref"] = run({}, *k4, k4_plain)
        ulp = [run({}, *k4, k4_plain_ulp(seed)) for seed in range(1, K4_ULP_RUNS + 1)]
    results["off"] = run(dict(pallas_attention_train=False))
    results["f32"] = run(dict(pallas_attention_train=False, compute_dtype="float32"))
    (m_on, g_on), (m_off, g_off), (m_32, g_32) = (results[t] for t in ("on", "off", "f32"))
    m_ref, g_ref = results.get("ref", results["off"])
    loss_floor = max((abs(m[k] - m_ref[k]) for m, _ in ulp for k in m_32), default=0.0)
    loss_tol = 2.0 * max(max(abs(m_off[k] - m_32[k]) for k in m_32), loss_floor)
    loss_err = {k: abs(m_on[k] - m_ref[k]) for k in m_32}
    scale = {k: float(g_32[k].abs().max()) for k in g_32}
    live = [k for k in g_32 if scale[k] > 0.0]
    plain = {k: max_err(g_off[k], g_32[k]) / scale[k] for k in live}
    kernel = {k: max_err(g_on[k], g_ref[k]) / scale[k] for k in live}
    kernel_f32 = {k: max_err(g_on[k], g_32[k]) / scale[k] for k in live}
    kernel_plain = {k: max_err(g_on[k], g_off[k]) / scale[k] for k in live}
    typical = statistics.median(plain.values())
    floor = {k: max((max_err(g[k], g_ref[k]) / scale[k] for _, g in ulp), default=0.0)
             for k in live}
    grad_tol = {k: 2.0 * max(plain[k], typical, floor[k]) for k in live}
    worst = max(kernel, key=lambda k: kernel[k] / grad_tol[k])
    report = dict(losses=m_on, losses_plain=m_off, losses_f32=m_32, loss_err=loss_err,
                  loss_tol=loss_tol, grad_err_worst=kernel[worst],
                  grad_tol_worst=grad_tol[worst], grad_err_worst_leaf=worst,
                  grad_plain_vs_f32_median=typical,
                  grad_plain_vs_f32_worst=max(plain.values()), leaves=len(live),
                  grad_err=kernel, grad_plain_vs_f32=plain, grad_kernel_vs_f32=kernel_f32,
                  reference=reference, grad_kernel_vs_plain_path=kernel_plain,
                  loss_kernel_vs_plain_path={k: abs(m_on[k] - m_off[k]) for k in m_32},
                  ulp_runs=len(ulp), loss_ulp_floor=loss_floor, grad_ulp_floor=floor)
    planted_report = {}
    for name, module, attr, wrap, must_catch in faults:
        m_w, g_w = run({}, module, attr, wrap)
        losses = [k for k in m_32 if abs(m_w[k] - m_ref[k]) > loss_tol]
        leaves = [k for k in live if max_err(g_w[k], g_ref[k]) / scale[k] > grad_tol[k]]
        planted_report[name] = dict(losses_caught=losses, leaves_caught=len(leaves),
                                    total_loss_err=abs(m_w["total_loss"] - m_ref["total_loss"]))
        log(f"[{tag}] planted fault {name}: total loss err "
            f"{planted_report[name]['total_loss_err']:.3g}; beyond tolerance in losses "
            f"{losses}, {len(leaves)} gradient leaves")
        expect(bool(losses or leaves) or not must_catch,
               f"{tag}: planted fault {name} stayed within tolerance")
    report["planted_faults"] = planted_report
    details["train_compare" if tag == "train50" else f"{tag}_train_compare"] = report
    against = ("K4's plain version in its place" if reference == "k4_plain"
               else "plain attention path")
    log(f"[{tag}] kernels on vs {against}, dropout and aug off: total loss "
        f"{m_on['total_loss']:.5f} vs {m_ref['total_loss']:.5f} (plain attention path "
        f"{m_off['total_loss']:.5f}, f32 {m_32['total_loss']:.5f}); largest loss err "
        f"{max(loss_err.values()):.3g} (tol {loss_tol:.3g}); largest gradient err against its "
        f"tolerance {kernel[worst]:.3g} of the leaf's largest gradient, at {worst} (tol "
        f"{grad_tol[worst]:.3g}; the plain bf16 path is {typical:.3g} median, "
        f"{max(plain.values()):.3g} worst from f32" + (
            f"; {len(ulp)} one-ulp perturbations of K4's plain version move the loss by "
            f"{loss_floor:.3g} and that leaf by {floor[worst]:.3g}" if ulp else "")
        + f"), over {len(live)} leaves")
    expect(all(np.isfinite(v) for v in m_on.values()), f"{tag}: non-finite loss")
    expect(max(loss_err.values()) <= loss_tol, f"{tag}: loss err {loss_err} > {loss_tol}")
    bad = [k for k in live if kernel[k] > grad_tol[k]]
    expect(not bad, f"{tag}: gradients beyond tolerance in {bad}")


ROUND5_CONFIG = os.path.join(HERE, "eval_artifacts", "open_jar", "train_dominant", "open_jar",
                             "PERACT_BC", "seed0", "config.json")
# the keys of round 5's method config that shape its model: Perceiver widths
# and depth (latents 64 x 64, depth 2, heads of 32), the decoder's width, the
# grid
ROUND5_MODEL_KEYS = ("voxel_sizes", "num_latents", "latent_dim", "transformer_depth",
                     "transformer_iterations", "cross_heads", "cross_dim_head", "latent_heads",
                     "latent_dim_head", "final_dim", "voxel_patch_size", "voxel_patch_stride",
                     "which_arm", "arm_pred_loss", "crop_target_obj_voxel", "crop_radius")


def noise_padded_attention(_wrapper):
    """K2 with its heads' zero pad replaced by noise (``noise_padded``): a
    planted fault through the real kernel at heads below 64."""
    from voxactb_tpu_torch.ops.cuda import flash_attention as K2

    return lambda q, k, v, **kw: noise_padded(K2._launch, 64)(q, k, v, schedule=0)


def noise_padded_attention_train(_wrapper):
    """K4 with its heads' zero pad replaced by noise in the forward and the
    backward (``noise_padded``): a planted fault through the real kernels at
    heads below 64."""
    import torch
    from voxactb_tpu_torch.ops.cuda import flash_attention_train as K4

    fwd = noise_padded(K4._launch_forward, 64, sliced=(0,))
    bwd = noise_padded(K4._launch_backward, 64, n_operands=4, sliced=(0, 1, 2))

    class Noisy(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, seed, dropout, index):
            out, lse, bits = fwd(q, k, v, seed, dropout, index)
            ctx.save_for_backward(q, k, v, lse)
            ctx.bits, ctx.dropout = bits, dropout
            return out

        @staticmethod
        def backward(ctx, d_out):
            q, k, v, lse = ctx.saved_tensors
            dq, dk, dv = bwd(q, k, v, d_out.to(q.dtype), lse, ctx.bits, ctx.dropout)
            return dq, dk, dv, None, None, None

    return lambda q, k, v, seed, *, dropout=0.0, index=K4.LOCAL: Noisy.apply(
        q, k, v, K4._seed_tensor(seed, q.device), float(dropout), K4.MaskIndex(*index))


ROUND5_ACT_FAULTS = (("attention_noise_pad", "voxactb_tpu_torch.ops.cuda.flash_attention",
                      "flash_attention", noise_padded_attention, True),)
ROUND5_TRAIN_FAULTS = (("attention_train_noise_pad",
                        "voxactb_tpu_torch.ops.cuda.flash_attention_train",
                        "flash_attention_train", noise_padded_attention_train, True),)


def round5_model():
    """Round 5's open_jar model (``eval_artifacts``' acting policy config)."""
    with open(ROUND5_CONFIG) as f:
        method = json.load(f)["method"]
    return {k: method[k] for k in ROUND5_MODEL_KEYS}


def round5(rng, details):
    """Round 5's model (heads of 32) on the kernel path: one act with its
    kernel flags held to the plain path by ``compare_paths``, and one train
    step's losses and gradients with K4 held by ``compare_train_paths``, then
    two steps whose launches must show K4 took their calls. Before the kernels
    took head dims other than 64, both raised. The act launches K1 and K2 (4
    calls at depth 2); K3's gate, the JAX package's ``tail_ok``, wants the
    decoder's width equal to the voxel features' (64), and round 5's
    ``final_dim`` is 16, so K3 runs in neither package there."""
    import torch
    from voxactb_tpu_torch.agents.qfunction import make_optimizer, make_train_step
    from voxactb_tpu_torch.ops import cuda as kernels

    model = round5_model()
    expect(model["cross_dim_head"] == 32 and model["latent_dim_head"] == 32,
           f"round 5's head dims: {model}")
    depth = model["transformer_depth"]
    cfg = act_config(model["voxel_sizes"][0],
                     **{k: v for k, v in model.items() if k != "voxel_sizes"})
    act = checked_act("round5_act", cfg, 0, CROP_BOUNDS, rng, details,
                      want={"front_fused": 1, "flash_attention": depth + 2,
                            "decoder_head": 0}, faults=ROUND5_ACT_FAULTS)
    b = 4  # round 5's batch
    tcfg = train_config(**model)
    batch = train_batch(rng, tcfg, b)
    compare_train_paths(batch, details, model=model, tag="round5_train", reference="k4_plain",
                        faults=ROUND5_TRAIN_FAULTS)
    dev = torch.device(DEVICE)
    _, init_fn, step = make_train_step(tcfg, make_optimizer(tcfg, 100_000), TRAIN_CAMERAS,
                                       device=DEVICE, seed=0)
    device_batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_fn()
    state, _ = step(state, device_batch, gen)  # warm
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses = []
    for _ in range(2):
        state, metrics = step(state, device_batch, gen)
        losses.append(float(metrics["total_loss"]))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    expect(all(np.isfinite(losses)), f"round5_train: losses {losses}")
    expect(counts["flash_attention_train_fwd"] == 2 * (depth + 2)
           and counts["flash_attention_train_bwd"] == 2 * (depth + 2),
           f"round5_train: launches {counts} in 2 steps")
    log(f"[round5] train steps at round 5's model, batch {b}, SE(3) aug and dropout on: "
        f"losses {losses}; launches: {counts}")
    del state, step, init_fn
    torch.cuda.empty_cache()
    return act, dict(steps=2, launches=counts)


def train50(rng, details, timings, n_steps=10, warm=2):
    import torch
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.agents.qfunction import make_optimizer, make_train_step
    from voxactb_tpu_torch.ops import cuda as kernels

    b = 8
    cfg = train_config()
    batch = train_batch(rng, cfg, b)
    compare_train_paths(batch, details)

    dev = torch.device(DEVICE)
    _, init_fn, step = make_train_step(cfg, make_optimizer(cfg, 100_000), TRAIN_CAMERAS,
                                       device=DEVICE, seed=0)
    device_batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    def run(seed, timed):
        """warm + n_steps steps from the seeded weights; losses of every step,
        and the wall time of each step after the warm ones."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = init_fn()
        losses, walls = [], []
        for i in range(warm + n_steps):
            if timed and i == warm:
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = step(state, device_batch, gen)
            if timed:
                torch.cuda.synchronize()
                if i >= warm:
                    walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["total_loss"])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        return [float(x) for x in losses], walls, counts, state

    torch.cuda.reset_peak_memory_stats()
    losses, walls, counts, state = run(0, True)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    expect(all(np.isfinite(losses)), f"train50: non-finite loss in {losses}")
    expect(losses[-1] < losses[0], f"train50: loss did not fall: {losses}")
    expect(counts["flash_attention_train_fwd"] == 8 * n_steps
           and counts["flash_attention_train_bwd"] == 8 * n_steps,
           f"train50: launches {counts} in {n_steps} steps")
    ms = statistics.median(walls)
    # the same chain without a sync after every step
    t0 = time.perf_counter()
    again, _, _, _ = run(0, False)
    chain_ms = (time.perf_counter() - t0) * 1e3 / (warm + n_steps)
    spread = max(abs(a - b_) for a, b_ in zip(losses, again))
    bit_equal = losses == again
    # K4 has no atomics, but the voxel scatter (index_add_) and cuDNN's weight
    # gradients sum in an order that changes from run to run, and the steps
    # that follow amplify a last-bit difference: the first step must agree, the
    # spread over the run is reported
    expect(abs(losses[0] - again[0]) <= 1e-3 * abs(losses[0]),
           f"train50: a second run from the same seed starts at {again[0]}, not "
           f"{losses[0]}")
    timings["train50_b8"] = dict(ms_per_step=ms, samples_per_s=b / ms * 1e3,
                                 ms_per_step_unsynced_chain=chain_ms, steps=n_steps,
                                 losses=losses, second_run_losses=again,
                                 second_run_bit_equal=bit_equal,
                                 second_run_max_loss_diff=spread, peak_memory_gib=peak_gb,
                                 walls_ms=walls)
    log(f"[train50] batch {b}, {n_steps} steps after {warm} warm ones, SE(3) aug and "
        f"dropout on: {ms:.3f} ms/step median ({b / ms * 1e3:.3f} samples/s; "
        f"{chain_ms:.3f} ms/step without a sync per step); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; second run from the same seed "
        + ("bit-equal" if bit_equal else f"differs by at most {spread:.3g} (first step by "
           f"{abs(losses[0] - again[0]):.3g})") + f"; peak memory "
        f"{peak_gb:.2f} GiB; launches: {counts}")
    gen = torch.Generator(device=dev).manual_seed(5)
    profile_act(lambda: step(state, device_batch, gen), "train50_step", details, ms)
    del state, step, init_fn
    torch.cuda.empty_cache()

    # through the agent
    agent = QAttentionBCAgent(cfg, TRAIN_CAMERAS, SCENE_BOUNDS, batch_size=b,
                              training_iterations=100_000, device=DEVICE, seed=0)
    agent.build(training=True)
    kernels.reset_launch_counts()
    agent_losses = [float(agent.update(i, dict(batch))["total_loss"]) for i in range(2)]
    agent_counts = kernels.launch_counts()
    expect(all(np.isfinite(agent_losses)), f"train50: agent.update losses {agent_losses}")
    expect(agent_counts["flash_attention_train_fwd"] == 16
           and agent_counts["flash_attention_train_bwd"] == 16,
           f"train50: agent.update launches {agent_counts}")
    names = {s_.name for s_ in agent.update_summaries()}
    expect(any(n.endswith("losses/grad_norm") for n in names), "train50: agent summaries")
    log(f"[train50] agent.update x2: losses {agent_losses}; launches: {agent_counts}")
    timings["train50_b8"]["agent_update_losses"] = agent_losses
    del agent
    torch.cuda.empty_cache()
    return dict(steps=n_steps, launches={k: counts[k] + agent_counts[k] for k in counts},
                per_step={k: counts[k] // n_steps for k in counts})


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 8: the tools (P1-P3, then the profilers and probes on the card)
# ---------------------------------------------------------------------------

GRID_COPY_N = 100  # d0 [B, N^3, 64] bf16
GRID_COPY_CASES = ((1, 1), (1, 4), (8, 1))  # (batch, rows per slab)
SMEM_OPTIN = 232448  # 227 KB: an H100's shared memory per block with the opt-in
TOOLS_KERNELS = ("grid_copy", "smem_scratch", "shifted_window")


def check_grid_copy(details):
    """P1 at d0's shape, seeded on the card (generator seeds 110 + batch):
    the copy bit-equal to x and over two launches; the kernel launched on all
    but the last slab, and on one CTA fewer than its plan (its chunks dealt
    out as before), each into a NaN-filled output, must fail that check and
    differ in exactly the last slab, or exactly the missing CTA's chunks.
    Wrapper-call and device ms beside the bytes bound (x read once, the copy
    written once) and ``copy_``'s."""
    import torch
    from voxactb_tpu_torch.ops.cuda.build import sm_count
    from voxactb_tpu_torch.ops.cuda.probes import (
        grid_copy, grid_copy_chunks, grid_copy_reference, launch_grid_copy)

    dev = torch.device(DEVICE)
    bits = lambda t: t.view(torch.int16)  # noqa: E731
    rows_out = []
    for batch, rows in GRID_COPY_CASES:
        g = torch.Generator(device=dev).manual_seed(110 + batch)
        n = GRID_COPY_N
        x = torch.randn((batch, n, n, n, 64), generator=g, device=dev).to(torch.bfloat16)
        out = grid_copy(x, rows)
        again = grid_copy(x, rows)
        torch.cuda.synchronize()
        tag = f"B={batch} rows={rows}"
        expect(torch.equal(bits(out), bits(x)), f"grid_copy {tag}: the copy differs from x")
        expect(torch.equal(bits(again), bits(out)), f"grid_copy {tag}: two launches differ")
        fault = torch.full_like(x, float("nan"))
        launch_grid_copy(x, fault, rows, n_slabs=batch * n // rows - 1)
        torch.cuda.synchronize()
        slab = rows * n * n * 64
        expect(not torch.equal(bits(fault), bits(x)),
               f"grid_copy {tag}: the copy without its last slab passed the check")
        expect(torch.equal(bits(fault).view(-1)[:-slab], bits(x).view(-1)[:-slab])
               and bool(torch.isnan(fault.view(-1)[-slab:]).all()),
               f"grid_copy {tag}: the copy without its last slab differs elsewhere")
        # one CTA short: the chunks dealt to the last CTA stay NaN
        chunks = grid_copy_chunks(batch * n // rows, slab * 2, sm_count(dev))
        fault.fill_(float("nan"))
        launch_grid_copy(x, fault, rows, grid=len(chunks) - 1)
        torch.cuda.synchronize()
        missed = torch.zeros(x.numel(), dtype=torch.bool, device=dev)
        for start, size in chunks[-1]:
            missed[start // 2:(start + size) // 2] = True
        flat, xf = fault.view(-1), x.view(-1)
        expect(not torch.equal(bits(fault), bits(x)),
               f"grid_copy {tag}: the copy without CTA {len(chunks) - 1} passed the check")
        expect(torch.equal(bits(flat[~missed]), bits(xf[~missed]))
               and bool(torch.isnan(flat[missed]).all()),
               f"grid_copy {tag}: the copy without CTA {len(chunks) - 1} differs elsewhere "
               f"than in its {len(chunks[-1])} chunks")
        lib_out = torch.empty_like(x)
        bound, by = bound_ms(2 * x.numel() * x.element_size(), 0)
        rec = dict(shape=tag, max_abs_err=max_err(out, x), bound_ms=bound, bound_by=by,
                   ctas=len(chunks), chunks=sum(map(len, chunks)),
                   ms=time_ms(lambda: grid_copy(x, rows)),
                   device_ms=device_ms(lambda: grid_copy(x, rows), "probe_grid_copy"),
                   plain_ms=time_ms(lambda: grid_copy_reference(x, rows)),
                   library_ms=time_ms(lambda: lib_out.copy_(x)),
                   library_device_ms=device_ms(lambda: lib_out.copy_(x), None))
        rows_out.append(rec)
        log(f"[tools] grid_copy {tag}: bit-equal, two launches bit-equal, the planted "
            f"last-slab and missing-CTA faults caught ({len(chunks)} CTAs, "
            f"{rec['chunks']} chunks); {rec['ms']:.4f} ms, device {rec['device_ms']:.4f} "
            f"(bound {bound:.4f}, {by}); plain {rec['plain_ms']:.4f}; copy_ "
            f"{rec['library_ms']:.4f}, device {rec['library_device_ms']:.4f}")
        del x, out, again, fault, lib_out, missed, flat, xf
    torch.cuda.empty_cache()
    details["grid_copy"] = rows_out
    return rows_out[0]


def check_smem_scratch(details):
    """P2: the card's opt-in shared memory per block is 232,448 bytes by the
    runtime's query and torch's; the scratch kernel launches at one row, 48
    KB and exactly that limit, with row 0 exact, and is refused one 512-byte
    row past it (the check itself, not a fallback), after which it launches
    again. Its device time beside an empty 128-thread launch's, its floor."""
    import torch
    from voxactb_tpu_torch.ops.cuda.probes import (
        SCRATCH_ROW_BYTES, empty_launch, smem_optin, smem_scratch, smem_scratch_reference)

    dev = torch.device(DEVICE)
    optin = smem_optin(dev)
    torch_optin = getattr(torch.cuda.get_device_properties(dev),
                          "shared_memory_per_block_optin", optin)
    expect(optin == torch_optin == SMEM_OPTIN,
           f"opt-in shared memory per block: runtime {optin}, torch {torch_optin}, "
           f"expected {SMEM_OPTIN}")
    g = torch.Generator(device=dev).manual_seed(120)
    x = torch.randn((8, 128), generator=g, device=dev)
    for nbytes in (SCRATCH_ROW_BYTES, 48 * 1024, SMEM_OPTIN):
        out = smem_scratch(x, nbytes)
        torch.cuda.synchronize()
        expect(torch.equal(out[0], x[0]), f"smem_scratch at {nbytes} bytes: row 0 differs")
    try:
        smem_scratch(x, SMEM_OPTIN + SCRATCH_ROW_BYTES)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    expect(refused is not None,
           f"smem_scratch launched with {SMEM_OPTIN + SCRATCH_ROW_BYTES} bytes of scratch")
    out = smem_scratch(x, SMEM_OPTIN)
    torch.cuda.synchronize()
    expect(torch.equal(out[0], x[0]), "smem_scratch after a refused launch: row 0 differs")
    bound, by = bound_ms(2 * SCRATCH_ROW_BYTES, 0)
    rec = dict(shape=f"[8,128] f32, scratch {SMEM_OPTIN} bytes", max_abs_err=max_err(out[0], x[0]),
               optin=optin, refused_past_the_limit=refused, bound_ms=bound, bound_by=by,
               ms=time_ms(lambda: smem_scratch(x, SMEM_OPTIN)),
               device_ms=device_ms(lambda: smem_scratch(x, SMEM_OPTIN), "probe_smem_scratch"),
               plain_ms=time_ms(lambda: smem_scratch_reference(x, SMEM_OPTIN)),
               library_ms=None, library_device_ms=None,
               launch_floor_device_ms=device_ms(lambda: empty_launch(dev), "probe_empty"))
    details["smem_scratch"] = [rec]
    log(f"[tools] smem_scratch: opt-in limit {optin} bytes; launches at it, refused at "
        f"{SMEM_OPTIN + SCRATCH_ROW_BYTES} ({refused}); {rec['ms']:.4f} ms, device "
        f"{rec['device_ms']:.4f} (an empty 128-thread launch {rec['launch_floor_device_ms']:.4f})"
        f"; plain {rec['plain_ms']:.4f}")
    return rec


# (x's [H+2, W+2], numpy seed): the JAX probe's shapes, then a ragged grid
# (H = 37, W = 69) that is a multiple of neither side of a CTA's band
SHIFTED_WINDOW_CASES = (((102, 102), 12), ((39, 71), 13))


def check_shifted_window(details):
    """P3 at the JAX probe's shapes (x [102,102,128], w [9,128,64] bf16 from
    ``np.random.default_rng(12)``) and on a ragged x [39,71,128] (from
    ``np.random.default_rng(13)``): within 2^-7 of the plain version's
    largest |output|, two launches bit-equal; weights with dy and dx swapped,
    and the kernel with its second warpgroup gathering the first tile's
    pixels (``wg_row_offset=0``), must fail. At the probe's shapes, beside
    cuDNN's bf16 conv2d of the same input, channels last, to 64 channels (it
    writes bf16, not f32)."""
    import torch
    import torch.nn.functional as F
    from voxactb_tpu_torch.ops.cuda.probes import (
        launch_shifted_window, shifted_window, shifted_window_reference)

    dev = torch.device(DEVICE)
    recs = []
    for (hp, wp), seed in SHIFTED_WINDOW_CASES:
        rng = np.random.default_rng(seed)
        x = torch.tensor(rng.normal(size=(hp, wp, 128)).astype(np.float32)).to(
            dev, torch.bfloat16)
        w = torch.tensor(rng.normal(size=(9, 128, 64)).astype(np.float32) * 0.1).to(
            dev, torch.bfloat16)
        h, wd = hp - 2, wp - 2
        tag = f"x [{hp},{wp},128] w [9,128,64] bf16"
        got = shifted_window(x, w)
        again = shifted_window(x, w)
        ref = shifted_window_reference(x, w)
        torch.cuda.synchronize()
        tol = 2.0 ** -7 * float(ref.abs().max())
        e = max_err(got, ref)
        expect(e <= tol, f"shifted_window {tag}: err {e} > {tol}")
        expect(torch.equal(got, again), f"shifted_window {tag}: two launches differ")
        swapped = w.reshape(3, 3, 128, 64).transpose(0, 1).reshape(9, 128, 64).contiguous()
        e_fault = max_err(shifted_window(x, swapped), ref)
        expect(e_fault > tol,
               f"shifted_window {tag} with dy and dx swapped passed ({e_fault} <= {tol})")
        one_tile = torch.empty_like(got)
        launch_shifted_window(x, w, one_tile, wg_row_offset=0)
        e_tile = max_err(one_tile, ref)
        expect(e_tile > tol, f"shifted_window {tag} with both warpgroups on the first tile "
                             f"passed ({e_tile} <= {tol})")
        bound, by = bound_ms(x.numel() * 2 + w.numel() * 2 + h * wd * 64 * 4,
                             2 * h * wd * 64 * 9 * 128)
        rec = dict(shape=tag, max_abs_err=e, tol=tol, fault_err=e_fault,
                   one_tile_fault_err=e_tile, bound_ms=bound, bound_by=by)
        log(f"[tools] shifted_window {tag}: err {e:.3g} (tol {tol:.3g}), two launches "
            f"bit-equal, swapped dy/dx err {e_fault:.3g}, both warpgroups on one tile err "
            f"{e_tile:.3g}")
        if not recs:
            xc = x.permute(2, 0, 1)[None]  # [1, 128, 102, 102], channels last
            wc = w.reshape(3, 3, 128, 64).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            conv = lambda: F.conv2d(xc, wc)  # noqa: E731
            rec.update(library_err=max_err(conv()[0].permute(1, 2, 0), ref),
                       ms=time_ms(lambda: shifted_window(x, w)),
                       device_ms=device_ms(lambda: shifted_window(x, w), "probe_shifted_window"),
                       plain_ms=time_ms(lambda: shifted_window_reference(x, w)),
                       library_ms=time_ms(conv), library_device_ms=device_ms(conv, None),
                       library="cuDNN bf16 conv2d, channels last, bf16 output")
            log(f"[tools] shifted_window {tag}: {rec['ms']:.4f} ms, device "
                f"{rec['device_ms']:.4f} (bound {bound:.4f}, {by}); plain "
                f"{rec['plain_ms']:.4f}; cuDNN {rec['library_ms']:.4f}, device "
                f"{rec['library_device_ms']:.4f} (its bf16 output within "
                f"{rec['library_err']:.3g})")
        recs.append(rec)
    details["shifted_window"] = recs
    return recs[0]


def tools(details):
    """The tools' kernels held to their plain versions, then their entry
    points on the card: the stage profile at batch 1, its quick subset, the
    scratch and shifted-window probe, the roofline probes and the cost model
    at the H100's peaks. Their printed lines go to ``chip_smoke.json``; the
    stage table is logged in one line."""
    import io

    import torch
    from voxactb_tpu_torch.ops import cuda as kernels
    from voxactb_tpu_torch.tools import (
        cost_model, probe_smem, profile_quick, profile_stages, roofline)

    rows = dict(grid_copy=check_grid_copy(details), smem_scratch=check_smem_scratch(details),
                shifted_window=check_shifted_window(details))
    printed = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        stages = profile_stages.main(batch=1)
        quick = profile_quick.main()
        smem = probe_smem.main()
        roof = roofline.main()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    run_s = time.perf_counter() - t0
    expect(list(stages) == list(profile_stages.STAGES)
           and all(np.isfinite(v) and v > 0 for v in stages.values()),
           f"profile_stages: {stages}")
    expect(list(quick) == list(profile_quick.STAGES)
           and all(np.isfinite(v) and v > 0 for v in quick.values()), f"profile_quick: {quick}")
    expect(smem["scratch_kb"].get(227) is True and smem["scratch_kb"].get(228) is False,
           f"probe_smem: scratch {smem['scratch_kb']}")
    expect(smem["shifted_einsum"]["rel_err"] <= 2.0 ** -7, f"probe_smem: {smem}")
    expect(all(v > 0 for r in roof.values() for k, v in r.items() if k != "probe"),
           f"roofline: {roof}")
    cost = {f"act100_b{b}": cost_model.act_cost(n=100, batch=b) for b in (1, 8)}
    cost["train50_b8"] = cost_model.train_cost(n=50, batch=8)
    sol = {k: cost_model.speed_of_light(c) for k, c in cost.items()}
    details["tools"] = dict(run_s=run_s, profile_stages=stages, profile_quick=quick,
                            probe_smem=smem, roofline=roof, speed_of_light=sol,
                            printed=printed.getvalue().splitlines())
    log("[tools] profile_stages b1, ms per step: " + json.dumps(
        {k: round(v, 4) for k, v in stages.items()}))
    log("[tools] profile_quick, ms per step: " + json.dumps(
        {k: round(v, 4) for k, v in quick.items()}))
    log(f"[tools] probe_smem: {smem}; roofline: " + json.dumps(roof))
    log("[tools] speed of light at the H100's peaks: " + json.dumps(
        {k: {kk: (round(vv, 4) if isinstance(vv, float) else vv) for kk, vv in v.items()}
         for k, v in sol.items()}))
    log(f"[tools] the entry points took {run_s:.1f} s; launches: {counts}")
    return dict(launches=counts), rows


# ---------------------------------------------------------------------------
# phase 9: the protocol, through the CLIs (sim demos -> replay -> cli.train ->
# cli.eval's dual-policy rollout on the sim)
# ---------------------------------------------------------------------------

PROTOCOL_TASK = "open_jar"
PROTOCOL_CAMERAS = ["front", "wrist", "wrist2"]
PREFETCH_BATCHES = 6


def protocol_overrides(which_arm, log_dir):
    """VoxAct-B's operating point through ``cli.train``: two live sim demos,
    three 128^2 cameras, the 50^3 crop, full widths, bf16, the kernel flags
    that ``bench.py`` runs, the arm loss, SE(3) augmentation, batch 8."""
    return [f"rlbench.task_name={PROTOCOL_TASK}", f"rlbench.tasks=['{PROTOCOL_TASK}']",
            "rlbench.demo_path=sim", "rlbench.demos=2",
            f"rlbench.cameras={PROTOCOL_CAMERAS}", f"rlbench.camera_resolution=[{IMG},{IMG}]",
            "rlbench.episode_length=25", "method.voxel_sizes=[50]",
            "method.crop_target_obj_voxel=True", "method.crop_radius=0.3",
            "method.compute_dtype=bfloat16", "method.pallas_front=True",
            "method.pallas_attention=True", "method.pallas_decoder=True",
            "method.pallas_attention_train=True", "method.arm_pred_loss=True",
            "method.apply_se3=True", f"method.which_arm={which_arm}",
            "replay.batch_size=8", "framework.training_iterations=6",
            "framework.save_freq=3", "framework.log_freq=1",
            "framework.tensorboard_logging=False", f"log_dir={log_dir}"]


def check_prefetch(details):
    """``PrefetchIterator`` on the card against the host batches it was given,
    bit for bit and in order, in both orders: a consumer whose stream is
    busy while the worker runs ahead, and a worker slower than the consumer.
    Each batch is summed on the consumer's stream right after ``next``."""
    import itertools

    import torch
    from voxactb_tpu_torch.replay.dataset import PrefetchIterator, _host_tensor

    expect(_host_tensor(np.zeros(3, np.float32), True).is_pinned(),
           "prefetch: the staging tensor is not pinned")
    rows = {}
    for order in ("consumer_busy", "worker_slow"):
        counter = itertools.count()
        sent = []

        def sample():
            r = np.random.default_rng(200 + next(counter))
            batch = {"rgb": r.integers(0, 255, (8, 3, IMG, IMG, 3)).astype(np.uint8),
                     "pcd": r.uniform(-1, 1, (8, 3, IMG, IMG, 3)).astype(np.float32),
                     "idx": r.integers(0, 50, (8, 3)).astype(np.int32)}
            sent.append({k: v.copy() for k, v in batch.items()})
            if order == "worker_slow":
                time.sleep(0.05)
            return batch

        it = PrefetchIterator(sample, device=DEVICE)
        try:
            sums, got = [], []
            for _ in range(PREFETCH_BATCHES):
                if order == "consumer_busy":
                    torch.cuda._sleep(20_000_000)  # about 10 ms of a busy stream
                b = next(it)
                sums.append(b["pcd"].double().sum())
                got.append({k: v.cpu().numpy() for k, v in b.items()})
        finally:
            it.close()
        for i, g in enumerate(got):
            expect(all(np.array_equal(g[k], sent[i][k]) for k in g),
                   f"prefetch {order}: batch {i} differs from the host batch")
            pcd = sent[i]["pcd"].astype(np.float64)
            expect(abs(float(sums[i]) - pcd.sum()) <= 1e-9 * np.abs(pcd).sum(),
                   f"prefetch {order}: the consumer's sum of batch {i} read other data")
        rows[order] = dict(batches=PREFETCH_BATCHES)
    details["prefetch"] = rows
    log(f"[protocol] PrefetchIterator: {PREFETCH_BATCHES} batches bit-equal to the host "
        "batches, in order, with a busy consumer and with a slow worker")


def protocol(details, timings):
    """Train the acting (dominant) and the stabilizing (assistive) policy
    through ``cli.train`` from two live sim demos each, then score the acting
    policy's checkpoints through ``cli.eval``'s dual-policy rollout with the
    stabilizing policy's last checkpoint."""
    import csv
    import importlib
    import shutil

    import torch
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.cli import eval as eval_cli
    from voxactb_tpu_torch.cli import train as train_cli
    from voxactb_tpu_torch.ops import cuda as kernels
    from voxactb_tpu_torch.ops.geometry import scene_bounds_from_crop
    from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment

    # the module, not the function that ``voxactb_tpu_torch.data`` exports
    fill_replay = importlib.import_module("voxactb_tpu_torch.data.fill_replay")
    t_phase = time.perf_counter()
    check_prefetch(details)
    root = os.path.join(HERE, "build", "protocol")
    shutil.rmtree(root, ignore_errors=True)
    demo_s, fill_s, replays, updates, losses = [], [], [], [], []
    acts, sim_s, crops = [], [], []
    # host seconds of the agents' builds, checkpoint saves and loads
    host_s = {"build": [], "save": [], "load": []}
    role = {}  # id(agent) -> "acting" | "stabilizing", from what it loaded

    def timed(sink):
        def wrap(fn):
            def call(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                sink.append(time.perf_counter() - t0)
                return out
            return call
        return wrap

    def keep_replay(fn):
        def call(cfg, *a, **kw):
            replay, agent = fn(cfg, *a, **kw)
            replays.append(replay)
            return replay, agent
        return call

    def synced_update(fn):
        def call(self, step, sample):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, step, sample)
            losses.append(float(out["total_loss"]))  # syncs
            updates.append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    def tag(name):
        """Name an agent by what it loaded, after the load: ``load_weights``
        (a checkpoint step, the acting policy) calls ``load_weight`` (a file,
        the stabilizing policy's ``left_arm_ckpt``) inside it."""
        def wrap(fn):
            def call(self, *a, **kw):
                out = fn(self, *a, **kw)
                role[id(self)] = name
                return out
            return call
        return wrap

    def logged_act(fn):
        def call(self, step, observation, **kw):
            t0 = time.perf_counter()
            out = fn(self, step, observation, **kw)
            acts.append(dict(agent=id(self), step=step, ms=(time.perf_counter() - t0) * 1e3,
                             bounds=kw.get("new_scene_bounds"),
                             dual=kw.get("dominant_assitive_policy")))
            return out
        return call

    def logged_crop(fn):
        def call(self):
            out = fn(self)
            crops.append(np.asarray(out, np.float32).copy())
            return out
        return call

    # 1. cli.train, the acting and the stabilizing policy
    seed_dirs = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(wrapped(BimanualTaskEnvironment, "get_demo", timed(demo_s)))
        stack.enter_context(wrapped(fill_replay, "fill_multi_task_replay", timed(fill_s)))
        stack.enter_context(wrapped(train_cli, "build_replay_and_agent", keep_replay))
        stack.enter_context(wrapped(QAttentionBCAgent, "update", synced_update))
        stack.enter_context(wrapped(QAttentionBCAgent, "build", timed(host_s["build"])))
        stack.enter_context(wrapped(QAttentionBCAgent, "save_weights",
                                    timed(host_s["save"])))
        for which in ("dominant", "assistive"):
            seed_dirs[which] = train_cli.main(
                protocol_overrides(which, os.path.join(root, which)), device=DEVICE)
    torch.cuda.synchronize()
    train_counts = kernels.launch_counts()
    train_s = time.perf_counter() - t0
    expect(len(losses) == 12 and all(np.isfinite(losses)), f"protocol: train losses {losses}")
    for which, d in seed_dirs.items():
        for f in ("config.json", "train_data.csv") + tuple(
                f"weights/{s}/QAttentionAgent_layer0.pt" for s in (0, 3, 5)):
            expect(os.path.exists(os.path.join(d, f)), f"protocol: {which} wrote no {f}")
    for which, replay in zip(seed_dirs, replays):
        emb = replay.sample_transition_batch(8)["lang_goal_emb"]
        expect(bool(np.abs(emb).max() > 0), f"protocol: {which} replay's lang_goal_emb is 0")
    step_ms = statistics.median(updates[1:6] + updates[7:])  # the first builds the state

    # 2. cli.eval on the acting policy's seed dir, the stabilizing one's last .pt
    left_ckpt = os.path.join(seed_dirs["assistive"], "weights", "5",
                             "QAttentionAgent_layer0.pt")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(wrapped(QAttentionBCAgent, "act", logged_act))
        stack.enter_context(wrapped(QAttentionBCAgent, "load_weights", tag("acting")))
        stack.enter_context(wrapped(QAttentionBCAgent, "load_weight", tag("stabilizing")))
        stack.enter_context(wrapped(QAttentionBCAgent, "load_weight", timed(host_s["load"])))
        stack.enter_context(wrapped(QAttentionBCAgent, "build", timed(host_s["build"])))
        stack.enter_context(wrapped(BimanualTaskEnvironment, "step", timed(sim_s)))
        stack.enter_context(wrapped(BimanualTaskEnvironment, "target_object_world_coords",
                                    logged_crop))
        results = eval_cli.main([f"seed_dir={seed_dirs['dominant']}",
                                 "framework.eval_type=missing", "framework.eval_episodes=2",
                                 "rlbench.episode_length=25",
                                 f"framework.left_arm_ckpt={left_ckpt}"], device=DEVICE)
    torch.cuda.synchronize()
    eval_counts = kernels.launch_counts()
    eval_s = time.perf_counter() - t0
    with open(os.path.join(seed_dirs["dominant"], "eval_data.csv")) as f:
        rows = list(csv.DictReader(f))
    expect([int(float(r["step"])) for r in rows] == [0, 3, 5],
           f"protocol: eval_data.csv steps {[r.get('step') for r in rows]}")
    expect(all(np.isfinite(float(r["eval_envs/return"])) for r in rows),
           f"protocol: eval returns {[r.get('eval_envs/return') for r in rows]}")
    expect(len(results) == 3, f"protocol: eval results {results}")
    # assistive (stabilizing) acts on even steps, dominant (acting) on odd ones
    wrong = [(a["step"], role.get(a["agent"])) for a in acts
             if role.get(a["agent"]) != ("stabilizing" if a["step"] % 2 == 0 else "acting")
             or not a["dual"]]
    expect(acts and not wrong, f"protocol: acts out of turn {wrong[:5]}")
    # every act got the crop's bounds (the crop point of its episode)
    episodes = sum(1 for a in acts if a["step"] == 0)
    expect(episodes == 6 and len(crops) == 6, f"protocol: {episodes} episodes, "
           f"{len(crops)} crops")
    ep = -1
    for a in acts:
        ep += a["step"] == 0
        want = scene_bounds_from_crop(crops[ep], 0.3).tolist()
        expect(a["bounds"] is not None and list(a["bounds"]) == want,
               f"protocol: act {a['step']} of episode {ep} got bounds {a['bounds']}, "
               f"not {want}")
    wall_s = time.perf_counter() - t_phase
    act_ms = statistics.median(a["ms"] for a in acts)
    sim_ms = statistics.median(sim_s) * 1e3
    ref_act = timings.get("dual50", {}).get("ms_per_act_median")
    ref_step = timings.get("train50_b8", {}).get("ms_per_step")
    timings["protocol"] = dict(
        s_per_demo=statistics.mean(demo_s), demos=len(demo_s), fill_s=fill_s,
        train_step_ms=step_ms, train_samples_per_s=8 / step_ms * 1e3,
        train_step_walls_ms=updates, train_losses=losses, train_s=train_s,
        ms_per_act_median=act_ms, acts=len(acts), sim_step_ms_median=sim_ms,
        sim_steps=len(sim_s), eval_s=eval_s, eval_rows=rows, wall_s=wall_s,
        host_s={k: sum(v) for k, v in host_s.items()},
        host_calls={k: len(v) for k, v in host_s.items()},
        dual50_ms_per_act=ref_act, train50_ms_per_step=ref_step)
    log(f"[protocol] {len(demo_s)} sim demos of {PROTOCOL_TASK} at {IMG}^2 x "
        f"{len(PROTOCOL_CAMERAS)} cameras: {statistics.mean(demo_s):.3f} s per demo; replay "
        f"fills {', '.join(f'{x:.3f}' for x in fill_s)} s")
    log(f"[protocol] cli.train x2 (dominant, assistive; 6 steps each, batch 8, "
        f"{len(PROTOCOL_CAMERAS)} cameras): {step_ms:.3f} ms/step median "
        f"({8 / step_ms * 1e3:.3f} samples/s) beside train50's direct step "
        f"{ref_step if ref_step is None else round(ref_step, 3)} ms (2 cameras); losses "
        f"{[round(x, 4) for x in losses]}; {train_s:.1f} s; launches: {train_counts}")
    log(f"[protocol] cli.eval: {len(rows)} checkpoints x 2 episodes, {len(acts)} acts at "
        f"{act_ms:.3f} ms/act median beside dual50's "
        f"{ref_act if ref_act is None else round(ref_act, 3)}; sim step "
        f"{sim_ms:.3f} ms median over {len(sim_s)}; returns "
        f"{[r['eval_envs/return'] for r in rows]}; {eval_s:.1f} s; launches: {eval_counts}")
    log(f"[protocol] the phase took {wall_s:.1f} s; of it the agents' builds "
        f"{sum(host_s['build']):.2f} s ({len(host_s['build'])}), checkpoint saves "
        f"{sum(host_s['save']):.2f} s ({len(host_s['save'])}), checkpoint loads "
        f"{sum(host_s['load']):.2f} s ({len(host_s['load'])}), demos {sum(demo_s):.2f} s, "
        f"replay fills {sum(fill_s):.2f} s, train steps {sum(updates) / 1e3:.2f} s, acts "
        f"{sum(a['ms'] for a in acts) / 1e3:.2f} s, sim steps {sum(sim_s):.2f} s")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return (dict(launches=train_counts, steps=len(updates)),
            dict(launches=eval_counts, acts=len(acts)))


# ---------------------------------------------------------------------------
# phase 10: the protocol tool (run_protocol_eval's three stages and its
# --vlm-eval) at full width, and cli.train on the native disk replay
# ---------------------------------------------------------------------------

PROTOCOL_EVAL_ITERS = 4  # with save_freq 2: checkpoints 0, 2 and 3
PROTOCOL_EVAL_ROOT = os.path.join(HERE, "build", "protocol_eval")
DISK_REPLAY_ITERS = 4
FEED_BATCHES = 20
TEARDOWN_ROUNDS = 5
# protocol_overrides' keys that the tool sets itself, per task and policy
TOOL_KEYS = ("rlbench.task_name", "rlbench.tasks", "rlbench.demo_path", "rlbench.demos",
             "method.which_arm", "framework.training_iterations", "framework.save_freq",
             "framework.log_freq", "log_dir")
WIDTH_KEYS = ("num_latents", "latent_dim", "transformer_depth", "cross_dim_head",
              "latent_dim_head", "final_dim")


def protocol_eval_extra():
    """``--extra`` for the tool: ``protocol_overrides``' operating point (three
    128^2 cameras, bf16, the kernel flags, SE(3) augmentation, batch 8) at the
    config's full widths, which the tool's ``COMMON`` narrows."""
    from voxactb_tpu_torch.config import MethodConfig

    full = MethodConfig()
    return ([o for o in protocol_overrides("dominant", "") if o.split("=")[0] not in TOOL_KEYS]
            + [f"method.{k}={getattr(full, k)}" for k in WIDTH_KEYS])


def leg_counts(sink, kernels):
    """Wrap a stage so that the kernel launches during it add to ``sink``."""
    def wrap(fn):
        def call(*a, **kw):
            import torch

            torch.cuda.synchronize()
            before = kernels.launch_counts()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            for k, v in kernels.launch_counts().items():
                sink[k] = sink.get(k, 0) + v - before[k]
            return out
        return call
    return wrap


def disk_replay(timings):
    """``cli.train`` with ``replay.use_disk=True`` on two live sim demos at
    the protocol's operating point: every batch that reaches the card is
    rows of the store, byte for byte; the store holds the rows that the
    in-memory replay takes from the same fill, in order; the run closes in
    its teardown order; then the feed is closed while the prefetch thread
    waits, in that order and the other, and timed against the in-memory
    replay's ``sample_transition_batch``."""
    import importlib
    import shutil

    import torch
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.cli import train as train_cli
    from voxactb_tpu_torch.config import Config
    from voxactb_tpu_torch.models.clip_text import ClipLanguageEncoder
    from voxactb_tpu_torch.ops import cuda as kernels
    from voxactb_tpu_torch.replay.dataset import PrefetchIterator
    from voxactb_tpu_torch.replay.native_buffer import AsyncBatchSampler, NativeReplayBuffer
    from voxactb_tpu_torch.utils.bpe import SimpleTokenizer

    fill_replay = importlib.import_module("voxactb_tpu_torch.data.fill_replay")
    root = os.path.join(HERE, "build", "disk_replay")
    shutil.rmtree(root, ignore_errors=True)
    store_dir = os.path.join(root, "replay")
    # cli.train's language tower, each description encoded once, so that the
    # in-memory fill below gets the embeddings the store got
    enc = ClipLanguageEncoder(tokenizer=SimpleTokenizer(), device=DEVICE)
    lang_cache = {}

    def language(text):
        if text not in lang_cache:
            lang_cache[text] = tuple(t.cpu().numpy() for t in enc.encode_text([text]))
        return lang_cache[text]

    overrides = protocol_overrides("dominant", os.path.join(root, "logs")) + [
        f"framework.training_iterations={DISK_REPLAY_ITERS}", "framework.save_freq=100",
        "replay.use_disk=True", f"replay.path={store_dir}"]
    captured, batches, replays = {}, [], []

    def keep_demos(fn):
        def call(replay, demos, *a, **kw):
            captured["demos"] = demos
            return fn(replay, demos, *a, **kw)
        return call

    def keep_replay(fn):
        def call(cfg, *a, **kw):
            replay, agent = fn(cfg, *a, **kw)
            replays.append(replay)
            return replay, agent
        return call

    def keep_batch(fn):
        def call(self, step, sample):
            expect(all(v.device.type == torch.device(DEVICE).type for v in sample.values()),
                   "disk replay: a batch reached the update off the card")
            batches.append({k: v.cpu().numpy() for k, v in sample.items()
                            if k != "scene_bounds"})
            return fn(self, step, sample)
        return call

    counts = {}
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(wrapped(fill_replay, "fill_multi_task_replay", keep_demos))
        stack.enter_context(wrapped(train_cli, "build_replay_and_agent", keep_replay))
        stack.enter_context(wrapped(QAttentionBCAgent, "update", keep_batch))
        stack.enter_context(wrapped(train_cli, "_train_one", leg_counts(counts, kernels)))
        train_cli.main(overrides, lang_encoder=language, device=DEVICE)
    train_s = time.perf_counter() - t0
    store_path = os.path.join(store_dir, "seed0.replay")
    expect(isinstance(replays[0], NativeReplayBuffer) and replays[0].path == store_path,
           "disk replay: cli.train did not train from the native store")
    expect(len(batches) == DISK_REPLAY_ITERS, f"disk replay: {len(batches)} batches")

    # the in-memory replay from the same demos and language, and the store
    cfg = Config().override(**train_cli.parse_overrides(overrides + ["replay.use_disk=False"]))
    memory, _ = train_cli.build_replay_and_agent(cfg, language, captured["demos"],
                                                 device=DEVICE)
    store = NativeReplayBuffer(int(1e5), replays[0]._signature, store_path)
    n = store.size
    expect(n == memory.size > 0 and store.add_count == n,
           f"disk replay: the store holds {n} rows, the in-memory replay {memory.size}")
    stored, held = store.gather(np.arange(n)), memory.gather(np.arange(n))
    keys = sorted(stored)
    bad = [k for k in keys if not (stored[k].dtype == held[k].dtype
                                   and np.array_equal(stored[k], held[k]))]
    expect(not bad, f"disk replay: the store's rows differ from the in-memory replay's in {bad}")
    row_key = lambda rows, i: b"".join(rows[k][i].tobytes() for k in keys)  # noqa: E731
    index = {row_key(stored, i) for i in range(n)}
    rows_checked = 0
    for j, b in enumerate(batches):
        expect(sorted(b) == keys, f"disk replay: batch {j} has keys {sorted(b)}")
        for i in range(len(b[keys[0]])):
            expect(row_key(b, i) in index,
                   f"disk replay: row {i} of batch {j} is no row of the store")
            rows_checked += 1

    # the feed against the in-memory replay's sampling, on the host
    batch = cfg.replay.batch_size
    feed = AsyncBatchSampler(store, batch, seed=0)
    for _ in range(2):
        feed.next()
    t0 = time.perf_counter()
    for _ in range(FEED_BATCHES):
        feed.next()
    feed_ms = (time.perf_counter() - t0) / FEED_BATCHES * 1e3
    feed.close()
    t0 = time.perf_counter()
    for _ in range(FEED_BATCHES):
        memory.sample_transition_batch(batch)
    memory_ms = (time.perf_counter() - t0) / FEED_BATCHES * 1e3
    t0 = time.perf_counter()
    for _ in range(FEED_BATCHES):
        store.sample_transition_batch(batch)
    gather_ms = (time.perf_counter() - t0) / FEED_BATCHES * 1e3

    # close while the prefetch thread waits: cli.train's order (prefetch
    # thread, then the sampler), then the sampler first under the thread
    ends = {"prefetch_first": [], "sampler_first": []}
    for order in ends:
        for _ in range(TEARDOWN_ROUNDS):
            feed = AsyncBatchSampler(store, batch, seed=0)
            it = PrefetchIterator(feed.next, device=DEVICE)
            got = next(it)
            expect(row_key({k: v.cpu().numpy() for k, v in got.items()}, 0) in index,
                   "disk replay: a prefetched row is no row of the store")
            time.sleep(0.05)  # the worker runs ahead and waits on its queue
            if order == "prefetch_first":
                it.close()
                feed.close()
            else:
                feed.close()
                it.close()
            ends[order].append(type(it._error).__name__ if it._error else None)
    expect(all(e is None for e in ends["prefetch_first"]),
           f"disk replay: the prefetch thread failed in cli.train's order: {ends}")
    expect(all(e in (None, "RuntimeError") for e in ends["sampler_first"]),
           f"disk replay: the prefetch thread under a closed sampler: {ends}")
    row_bytes = store.row_bytes
    store.close()
    shutil.rmtree(root, ignore_errors=True)
    timings["disk_replay"] = dict(
        rows=n, row_bytes=row_bytes, batches=len(batches), rows_checked=rows_checked,
        feed_ms_per_batch=feed_ms, memory_sample_ms_per_batch=memory_ms,
        store_sample_ms_per_batch=gather_ms, train_s=train_s, teardown=ends)
    log(f"[protocol_eval] disk replay: cli.train on the native store ({n} rows of "
        f"{row_bytes} bytes, {row_bytes * n / 1e6:.1f} MB written): {len(batches)} batches, "
        f"{rows_checked} rows on the card, each a row of the store byte for byte; the store "
        f"equal to the in-memory replay's {memory.size} rows in order; {train_s:.1f} s; "
        f"launches: {counts}")
    log(f"[protocol_eval] disk replay: batch {batch} on the host: AsyncBatchSampler "
        f"{feed_ms:.3f} ms per batch, the store's sample_transition_batch {gather_ms:.3f} ms, "
        f"the in-memory replay's {memory_ms:.3f} ms; closed {TEARDOWN_ROUNDS} times each "
        f"while the prefetch thread waited (thread then sampler: {ends['prefetch_first']}; "
        f"sampler then thread: {ends['sampler_first']})")
    torch.cuda.empty_cache()
    return dict(launches=counts, steps=len(batches))


def protocol_tool(timings):
    """``run_protocol_eval.main`` on open_jar at full width (bf16, kernel
    flags): two live demos and four steps per policy, then its three stages
    and ``--vlm-eval`` with two episodes per checkpoint."""
    import csv
    import shutil

    import torch
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.ops import cuda as kernels
    from voxactb_tpu_torch.ops.geometry import scene_bounds_from_crop
    from voxactb_tpu_torch.runners.eval_runner import EvalRunner, select_checkpoints
    from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment
    from voxactb_tpu_torch.tools import run_protocol_eval as tool

    root = PROTOCOL_EVAL_ROOT
    shutil.rmtree(root, ignore_errors=True)
    head = ["--tasks", PROTOCOL_TASK, "--iters", str(PROTOCOL_EVAL_ITERS), "--save-freq", "2",
            "--demos", "2", "--episodes", "2", "--out", root]
    argv = head + ["--extra", *protocol_eval_extra()]
    sinks = {k: [] for k in ("save", "load", "demo", "sim_step", "build")}
    updates, acts, crops, runners, stages = [], [], [], [], []
    role = {}  # id(agent) -> "acting" | "stabilizing", from the runner it was given to
    state = {"eval": False}
    train_counts, eval_counts = {}, {}

    def timed(sink):
        def wrap(fn):
            def call(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                sink.append(time.perf_counter() - t0)
                return out
            return call
        return wrap

    def staged(name):
        def wrap(fn):
            def call(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                label = name(*a, **kw) if callable(name) else name
                stages.append((label, time.perf_counter() - t0))
                return out
            return call
        return wrap

    def synced_update(fn):
        def call(self, step, sample):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, step, sample)
            expect(np.isfinite(float(out["total_loss"])), "protocol_eval: a loss is not finite")
            updates.append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    def logged_runner(fn):
        def call(self, env, agent, *a, **kw):
            fn(self, env, agent, *a, **kw)
            role[id(agent)] = "acting"
            role[id(kw["left_arm_agent"])] = "stabilizing"
            runners.append(dict(csv=os.path.basename(self._csv_path),
                                left_arm_ckpt=kw.get("left_arm_ckpt")))
        return call

    def logged_act(fn):
        def call(self, step, observation, **kw):
            t0 = time.perf_counter()
            out = fn(self, step, observation, **kw)
            # the role at the act: a later runner's agent may take a freed id
            acts.append(dict(role=role.get(id(self)), step=step,
                             ms=(time.perf_counter() - t0) * 1e3,
                             bounds=kw.get("new_scene_bounds"),
                             dual=kw.get("dominant_assitive_policy")))
            return out
        return call

    def evaluating(fn):
        def call(*a, **kw):
            state["eval"] = True
            try:
                return fn(*a, **kw)
            finally:
                state["eval"] = False
        return call

    def logged_crop(fn):
        def call(self):
            out = fn(self)
            if state["eval"]:  # the crops of the eval episodes, not the demos'
                crops.append(np.asarray(out, np.float32).copy())
            return out
        return call

    eval_name = lambda task, acting, stab, eps, seed, eval_type, csv_name, *a, **kw: (  # noqa: E731
        f"eval {eval_type} {csv_name}")
    t_phase = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for owner, attr, wrap in (
                (tool, "train_policy", leg_counts(train_counts, kernels)),
                (tool, "run_eval", leg_counts(eval_counts, kernels)),
                (tool, "run_stab_sweep", leg_counts(eval_counts, kernels)),
                (tool, "train_policy", staged(lambda task, arm, *a, **kw: f"train {arm}")),
                (tool, "run_eval", staged(eval_name)),
                (tool, "run_stab_sweep", staged("stabilizing sweep")),
                (tool, "run_eval", evaluating),
                (tool, "run_stab_sweep", evaluating),
                (QAttentionBCAgent, "update", synced_update),
                (QAttentionBCAgent, "act", logged_act),
                (QAttentionBCAgent, "build", timed(sinks["build"])),
                (QAttentionBCAgent, "save_weights", timed(sinks["save"])),
                (QAttentionBCAgent, "load_weight", timed(sinks["load"])),
                (BimanualTaskEnvironment, "get_demo", timed(sinks["demo"])),
                (BimanualTaskEnvironment, "step", timed(sinks["sim_step"])),
                (BimanualTaskEnvironment, "target_object_world_coords", logged_crop),
                (EvalRunner, "__init__", logged_runner)):
            stack.enter_context(wrapped(owner, attr, wrap))
        summary = tool.main(argv, device=DEVICE)
        summary = tool.main(argv + ["--vlm-eval"], device=DEVICE)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t_phase

    # the summary and the CSVs
    task = summary[PROTOCOL_TASK]
    acting_dir = task["acting_dir"]
    finite = lambda rows: rows and all(np.isfinite(r["return"]) for r in rows)  # noqa: E731
    vlm = summary.get(f"{PROTOCOL_TASK}_vlmcrop", {})
    expect(finite(task["val"]) and finite(task["test"]) and finite(task["stab_sweep"]["rows"])
           and finite(vlm.get("val")) and finite(vlm.get("test")),
           f"protocol_eval: summary {json.dumps(summary)[:400]}")
    def read(name):
        with open(os.path.join(acting_dir, name)) as f:
            return list(csv.DictReader(f))

    val_rows, sweep_rows = read("eval_data.csv"), read("stabilizing_sweep.csv")
    steps = [0, 2, PROTOCOL_EVAL_ITERS - 1]
    expect([int(float(r["step"])) for r in val_rows] == steps,
           f"protocol_eval: eval_data.csv steps {[r['step'] for r in val_rows]}")
    best = select_checkpoints(os.path.join(acting_dir, "weights"), "best",
                              os.path.join(acting_dir, "eval_data.csv"))
    best_rows = [r for r in sweep_rows if int(float(r["step"])) == best[0]]
    expect([int(float(r["left_step"])) for r in best_rows] == steps,
           f"protocol_eval: the sweep's left steps {[r['left_step'] for r in sweep_rows]}")
    best_left = max(range(len(best_rows)),
                    key=lambda i: (float(best_rows[i]["eval_envs/return"]), i))
    best_left = int(float(best_rows[best_left]["left_step"]))
    sweep = task["stab_sweep"]
    expect(sweep["acting_step"] == best[0] and sweep["best_left_step"] == best_left
           and [int(r["step"]) for r in task["test"]] == [best[0]]
           and [int(r["step"]) for r in vlm["val"] + vlm["test"]] == [best[0]] * 2,
           f"protocol_eval: chose {sweep['acting_step']}/{sweep['best_left_step']}, the CSVs "
           f"give {best[0]}/{best_left}")
    test_runner = next(r for r in runners if r["csv"] == "test_data.csv")
    expect(os.path.basename(os.path.dirname(test_runner["left_arm_ckpt"])) == str(best_left),
           f"protocol_eval: the test pass paired {test_runner['left_arm_ckpt']}")

    # the acts: alternating, each inside its episode's crop bounds
    wrong = [(a["step"], a["role"]) for a in acts
             if a["role"] != ("stabilizing" if a["step"] % 2 == 0 else "acting")
             or not a["dual"]]
    expect(acts and not wrong, f"protocol_eval: acts out of turn {wrong[:5]}")
    episodes = sum(1 for a in acts if a["step"] == 0)
    expect(episodes == len(crops) == 2 * (2 * len(steps) + 1 + 2),
           f"protocol_eval: {episodes} episodes, {len(crops)} crops")
    ep = -1
    for a in acts:
        ep += a["step"] == 0
        want = scene_bounds_from_crop(crops[ep], 0.3).tolist()
        expect(a["bounds"] is not None and list(a["bounds"]) == want,
               f"protocol_eval: act {a['step']} of episode {ep} got bounds {a['bounds']}, "
               f"not {want}")
    expect(len(updates) == 2 * PROTOCOL_EVAL_ITERS, f"protocol_eval: {len(updates)} updates")
    for leg, counts, names in (("train", train_counts, ("flash_attention_train_fwd",
                                                        "flash_attention_train_bwd")),
                               ("eval", eval_counts, ("front_fused", "flash_attention",
                                                      "decoder_head"))):
        expect(all(counts.get(k, 0) > 0 for k in names),
               f"protocol_eval: the {leg} leg launched {counts}")

    sums = {k: sum(v) for k, v in sinks.items()}
    sums.update(train_step=sum(updates) / 1e3, act=sum(a["ms"] for a in acts) / 1e3)
    calls = {k: len(v) for k, v in sinks.items()}
    calls.update(train_step=len(updates), act=len(acts))
    timings["protocol_eval"] = dict(
        wall_s=wall_s, stages=stages, host_s=sums, host_calls=calls,
        train_step_ms=statistics.median(updates[1:PROTOCOL_EVAL_ITERS]
                                        + updates[PROTOCOL_EVAL_ITERS + 1:]),
        ms_per_act_median=statistics.median(a["ms"] for a in acts), episodes=episodes,
        summary=summary, train_launches=train_counts, eval_launches=eval_counts)
    log(f"[protocol_eval] run_protocol_eval at full width ({' '.join(head[:-2])}, bf16, "
        f"kernel flags): val {[r['return'] for r in task['val']]}, sweep "
        f"{[r['return'] for r in sweep['rows']]}, chose acting {best[0]} with stabilizing "
        f"{best_left}, test {[r['return'] for r in task['test']]}, VLM crop val/test "
        f"{[r['return'] for r in vlm['val'] + vlm['test']]}")
    log(f"[protocol_eval] stages: " + ", ".join(f"{name} {s:.2f} s" for name, s in stages))
    log(f"[protocol_eval] {wall_s:.1f} s; of it " + ", ".join(
        f"{k} {sums[k]:.2f} s ({calls[k]})" for k in ("build", "save", "load", "demo",
                                                       "train_step", "act", "sim_step")))
    log(f"[protocol_eval] train leg launches: {train_counts}")
    log(f"[protocol_eval] eval leg launches: {eval_counts}")
    # the seed dirs stay for the diagnose phase, which removes them
    torch.cuda.empty_cache()
    return (dict(launches=train_counts, steps=len(updates)),
            dict(launches=eval_counts, acts=len(acts)), acting_dir)


DIAGNOSE_STEP = PROTOCOL_EVAL_ITERS - 1  # the short leg's last checkpoint


def diagnose(acting_dir, details, timings):
    """The diagnosis probes on the checkpoints of ``protocol_tool``'s short
    leg (open_jar at full width, bf16, kernel flags; its last step), then the
    two profilers at small counts: ``profile_train --flash-ab-only --steps 2``
    (K4 against the plain attention path) and ``profile_sam --frames 1``. Each
    tool's printed output goes to ``chip_smoke.json``, its record to a line
    of its own; the launches of the whole phase are returned."""
    import contextlib
    import io
    import shutil

    import torch
    from voxactb_tpu_torch.ops import cuda as kernels
    from voxactb_tpu_torch.tools import (probe_hybrid_inputs, probe_input_diff,
                                        probe_policy_open_loop, probe_replay_accuracy,
                                        probe_replay_ambiguity, profile_sam, profile_train)

    stab_dir = acting_dir.replace("train_dominant", "train_assistive")
    step = str(DIAGNOSE_STEP)
    pair = ["--acting-dir", acting_dir, "--stab-dir", stab_dir, "--ckpt-step", step]
    runs = (
        ("probe_replay_ambiguity", probe_replay_ambiguity.main,
         ["--task", PROTOCOL_TASK, "--seed-dir", acting_dir]),
        ("probe_replay_accuracy", probe_replay_accuracy.main,
         ["--task", PROTOCOL_TASK, "--seed-dir", acting_dir, "--ckpt-step", step]),
        ("probe_policy_open_loop", probe_policy_open_loop.main,
         ["--task", PROTOCOL_TASK, *pair, "--episodes", "1", "--live"]),
        ("probe_input_diff", probe_input_diff.main, ["--task", PROTOCOL_TASK]),
        ("probe_hybrid_inputs", probe_hybrid_inputs.main,
         ["--task", PROTOCOL_TASK, *pair, "--episodes", "1"]),
        ("profile_train", profile_train.main, ["--flash-ab-only", "--steps", "2"]),
        ("profile_sam", profile_sam.main, ["--frames", "1"]))
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    records, seconds, launches = {}, {}, {}
    try:
        for name, fn, argv in runs:
            out = io.StringIO()
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                records[name] = fn(argv, device=DEVICE)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            launches[name] = {k: v - before[k] for k, v in kernels.launch_counts().items()
                              if v != before[k]}
            details.setdefault("diagnose", {})[name] = dict(argv=argv, stdout=out.getvalue(),
                                                            seconds=seconds[name],
                                                            launches=launches[name])
            log(f"[diagnose] {name} {seconds[name]:.1f} s, launches {launches[name]}")
    finally:
        shutil.rmtree(PROTOCOL_EVAL_ROOT, ignore_errors=True)
    counts = kernels.launch_counts()

    amb, acc = records["probe_replay_ambiguity"], records["probe_replay_accuracy"]
    expect(amb["samples"] > 0 and 0 <= amb["conflicting_pairs"] <= amb["near_duplicate_pairs"],
           f"diagnose: ambiguity {amb}")
    expect(acc["samples"] == amb["samples"] and 0.0 <= acc["trans_exact"] <= 1.0
           and 0.0 <= acc["grip_exact"] <= 1.0, f"diagnose: replay accuracy {acc}")
    (ol,) = records["probe_policy_open_loop"]["summary"]
    expect(ol["keyframes"] > 0 and ol["live_steps"] > 0 and np.isfinite(ol["pos_err_cm_mean"]),
           f"diagnose: open loop {ol}")
    diff = records["probe_input_diff"]
    expect(diff and all(np.isfinite(r[f"{c}_{k}"]["max"]) for r in diff
                        for c in ("wrist", "wrist2") for k in ("rgb", "point_cloud")),
           f"diagnose: input diff {diff[:1]}")
    hyb = records["probe_hybrid_inputs"]
    expect(hyb and all(v in r for r in hyb for v in probe_hybrid_inputs.VARIANTS),
           f"diagnose: hybrid rows {hyb[:1]}")
    pt = records["profile_train"]
    expect(set(pt["all"]) == {"full", "full_flashtrain"}
           and all(pt["all"][k] > 0 and pt["device_ms"][k] > 0 for k in pt["all"]),
           f"diagnose: profile_train {pt}")
    ps = records["profile_sam"]["all"]
    expect(all(v > 0 for v in ps.values()), f"diagnose: profile_sam {ps}")
    for name, want in (("probe_replay_accuracy", ("front_fused", "flash_attention",
                                                  "decoder_head")),
                       ("probe_policy_open_loop", ("front_fused", "flash_attention",
                                                   "decoder_head")),
                       ("probe_hybrid_inputs", ("flash_attention",)),
                       ("profile_train", ("flash_attention_train_fwd",
                                          "flash_attention_train_bwd")),
                       ("profile_sam", ("sam_attention",))):
        expect(all(launches[name].get(k, 0) > 0 for k in want),
               f"diagnose: {name} launched {launches[name]}")
    summary = dict(
        probe_replay_ambiguity={k: amb[k] for k in ("samples", "near_duplicate_pairs",
                                                    "conflicting_pairs")},
        probe_replay_accuracy={k: acc[k] for k in ("samples", "trans_exact", "grip_exact")},
        probe_policy_open_loop=ol,
        probe_input_diff=dict(keyframes=len(diff), rgb_max=max(
            r[f"{c}_rgb"]["max"] for r in diff for c in ("wrist", "wrist2"))),
        probe_hybrid_inputs=dict(rows=len(hyb), first=hyb[0]),
        profile_train=dict(ms=pt["all"], device_ms=pt["device_ms"]),
        profile_sam=ps)
    for name, rec in summary.items():
        log(json.dumps({"diagnose": name, **rec}))
    wall_s = time.perf_counter() - t_phase
    timings["diagnose"] = dict(wall_s=wall_s, seconds=seconds, summary=summary)
    log(f"[diagnose] {wall_s:.1f} s: " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    torch.cuda.empty_cache()
    return dict(launches=counts, per_tool=launches)


# ---------------------------------------------------------------------------
# phase 12: real weights in and out (synthetic checkpoints at the published
# widths, in the upstream layouts)
# ---------------------------------------------------------------------------

WEIGHTS_ROOT = os.path.join(HERE, "build", "weights_phase")
# the upstream layouts' sizes (the key-shape functions' published defaults);
# the policy is the reference's QAttentionAgent_layer0.pt at PERACT_BC's
# widths on the 50^3 crop, the dominant policy with its arm head
WEIGHTS_LAYOUTS = dict(clip={}, owl={}, sam={},
                       policy=dict(depth=6, voxel_size=50, low_dim=7, latents=2048,
                                   latent_dim=512, arm_pred=True))
POLICY_FILE = "QAttentionAgent_layer0.pt"
WEIGHTS_CHUNK = 2 ** 20  # the chunked-array check: leaves above 1 MiB in flat chunks


def draw_state_dict(shapes, g):
    """A synthetic checkpoint at ``shapes``, drawn on the card from ``g`` and
    moved to the host: norm and BatchNorm scales near 1, biases and running
    means small, running variances in [0.5, 1.5], ``logit_scale`` ln 100,
    other weights N(0, 1 / fan-in), counters int64 zeros."""
    import math

    import torch

    sd = {}
    for key, shape in shapes.items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros((), dtype=torch.int64)
            continue
        x = torch.randn(shape, generator=g, device=DEVICE)
        if key.endswith("running_var"):
            x = 0.5 + torch.rand(shape, generator=g, device=DEVICE)
        elif key.endswith("running_mean"):
            x = 0.1 * x
        elif len(shape) == 0:
            x = torch.full((), math.log(100.0), device=DEVICE)
        elif len(shape) == 1:
            x = 1.0 + 0.1 * x if key.endswith("weight") else 0.02 * x
        else:
            x = x / math.sqrt(math.prod(shape[1:]))
        sd[key] = x.cpu()
    return sd


def write_checkpoints(files):
    """The four synthetic checkpoints: CLIP RN50, OWL-ViT B/32 and SAM ViT-H
    into ``VOXACTB_WEIGHTS_DIR``'s names, the reference policy (keys under
    ``_qnet.``, as the reference's QFunction saves them) beside them."""
    import torch
    from voxactb_tpu_torch.tools.port_torch_checkpoint import reference_key_shapes
    from voxactb_tpu_torch.utils import pretrained as P

    layouts = {"clip_rn50.pt": P.clip_rn50_key_shapes(**WEIGHTS_LAYOUTS["clip"]),
               "owlvit_base.pt": P.owlvit_key_shapes(**WEIGHTS_LAYOUTS["owl"]),
               "sam_vit_h.pth": P.sam_key_shapes(**WEIGHTS_LAYOUTS["sam"]),
               POLICY_FILE: {"_qnet." + k: v for k, v in
                             reference_key_shapes(**WEIGHTS_LAYOUTS["policy"]).items()}}
    g = torch.Generator(device=DEVICE).manual_seed(130)
    for name, shapes in layouts.items():
        t0 = time.perf_counter()
        sd = draw_state_dict(shapes, g)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        path = os.path.join(WEIGHTS_ROOT, "weights" if name != POLICY_FILE else "", name)
        t0 = time.perf_counter()
        torch.save(sd, path)
        files[name] = dict(path=path, keys=len(sd), params=sum(v.numel() for v in sd.values()),
                           bytes=os.path.getsize(path), draw_s=draw_s,
                           save_s=time.perf_counter() - t0)
        del sd
    for name in layouts:
        t0 = time.perf_counter()
        P._torch_state_dict(files[name]["path"])
        files[name]["load_s"] = time.perf_counter() - t0


def codec_faults():
    """Planted faults in the msgpack reader, each (name, wrapper module
    attribute, wrap): a leaf read with its bytes swapped, and a chunked
    array with one chunk dropped (its span left zero)."""
    import torch

    def byteswap(read):
        def fn(data):
            arr = read(data)
            if isinstance(arr, torch.Tensor):  # bf16: swap the two bytes of each
                return arr.view(torch.int16).numpy().byteswap().view(np.int16)
            return arr.byteswap() if arr.size > 1 else arr
        return fn

    def dropped_chunk(unchunk):
        def fn(d):
            d = dict(d, chunks=dict(d["chunks"]))
            last = str(len(d["chunks"]) - 1)
            d["chunks"][last] = d["chunks"][last] * 0
            return unchunk(d)
        return fn

    return (("byteswap", "_array_from_payload", byteswap),
            ("dropped_chunk", "_unchunk", dropped_chunk))


def weights_policy(files, rng, details, timings):
    """The reference policy through the port's tool into the JAX format, read
    by the agent bit-equal to a direct mapping of the .pt (planted codec
    faults must break that), one act on the kernel path against the plain
    path by the act rule, then ``cli.eval``'s dual-policy rollout on a seed
    directory holding the .msgpack."""
    import torch
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.cli import eval as eval_cli
    from voxactb_tpu_torch.cli import train as train_cli
    from voxactb_tpu_torch.config import Config
    from voxactb_tpu_torch.ops import cuda as kernels
    from voxactb_tpu_torch.sim import environment as sim_env
    from voxactb_tpu_torch.tools import port_torch_checkpoint as tool
    from voxactb_tpu_torch.utils import msgpack_codec
    from voxactb_tpu_torch.weights import flax_tree_to_tensors

    depth = str(WEIGHTS_LAYOUTS["policy"]["depth"])
    seed_dir = os.path.join(WEIGHTS_ROOT, PROTOCOL_TASK, "PERACT_BC", "seed0")
    msg = os.path.join(seed_dir, "weights", "0", "QAttentionAgent_layer0.msgpack")
    os.makedirs(os.path.dirname(msg))
    t0 = time.perf_counter()
    tool.main(["--ckpt", files[POLICY_FILE]["path"], "--out", msg, "--depth", depth,
               "--arm-pred"])
    files["QAttentionAgent_layer0.msgpack"] = dict(bytes=os.path.getsize(msg),
                                                   convert_s=time.perf_counter() - t0)
    cfg = act_config(50, which_arm="dominant", arm_pred_loss=True,
                     crop_target_obj_voxel=True, crop_radius=0.3)
    cams = ["wrist", "wrist2"]
    agent = QAttentionBCAgent(cfg, cams, SCENE_BOUNDS, device=DEVICE, seed=0)
    agent.build(training=False)
    t0 = time.perf_counter()
    agent.load_weight(msg)
    torch.cuda.synchronize()
    files["QAttentionAgent_layer0.msgpack"]["load_s"] = time.perf_counter() - t0
    sd = torch.load(files[POLICY_FILE]["path"], map_location="cpu", weights_only=True)
    direct = flax_tree_to_tensors(agent.params, tool.map_reference_qattention(
        sd, int(depth), arm_pred=True))
    del sd

    def differing(path):
        agent.load_weight(path)
        return [k for k, p in agent.params.named_parameters()
                if not torch.equal(p.detach().cpu(), direct[k])]

    bad = differing(msg)
    expect(not bad, f"weights: parameters of the loaded .msgpack differ from the .pt's: {bad}")
    # the chunked path at full width, then the planted reader faults
    chunked = os.path.join(WEIGHTS_ROOT, "chunked.msgpack")
    with wrapped(msgpack_codec, "MAX_CHUNK_SIZE", lambda _: WEIGHTS_CHUNK):
        msgpack_codec.save(chunked, msgpack_codec.load(msg))
    def count_chunked(tree):
        if msgpack_codec.CHUNKED in tree:
            return 1
        return sum(count_chunked(v) for v in tree.values() if isinstance(v, dict))

    with open(chunked, "rb") as f:
        n_chunked = count_chunked(msgpack_codec.unpackb(f.read()))
    bad = differing(chunked)
    expect(n_chunked > 0 and not bad,
           f"weights: {n_chunked} chunked leaves; parameters differing {bad}")
    # a bf16 copy of the policy through the codec
    bf16 = {k: torch.as_tensor(v).to(torch.bfloat16)
            for k, v in flat_tree(msgpack_codec.load(msg)["params"]).items()}
    bf16_path = os.path.join(WEIGHTS_ROOT, "bf16.msgpack")
    msgpack_codec.save(bf16_path, bf16)

    def bf16_differing():
        back = msgpack_codec.load(bf16_path)
        return [k for k, v in bf16.items()
                if not torch.equal(torch.as_tensor(back[k]).view(torch.int16),
                                   v.view(torch.int16))]

    expect(not bf16_differing(), "weights: bf16 leaves changed through the codec")
    planted_report = {}
    for name, attr, wrap in codec_faults():
        with wrapped(msgpack_codec, attr, wrap):
            caught = differing(chunked) + (bf16_differing() if name == "byteswap" else [])
        planted_report[name] = len(caught)
        log(f"[weights] planted codec fault {name}: {len(caught)} leaves differ")
        expect(bool(caught), f"weights: planted codec fault {name} was not seen")
    expect(not differing(msg), "weights: reload after the planted faults")
    details["weights_codec"] = dict(chunked_leaves=n_chunked, planted=planted_report,
                                    bf16_leaves=len(bf16))

    # one act on the kernel path against the plain path, by dual50's rule
    refs = {d: reference_model(cfg, agent.params, d) for d in ("bfloat16", "float32")}
    inputs = act_inputs(rng, 1, cfg.low_dim_size())
    compare_paths(cfg, agent.params, refs, inputs, [CROP_BOUNDS], "weights_act", details)
    del refs
    rgbs, pcds = clouds(rng, 1)
    obs = {"lang_goal_emb": rng.normal(size=(1024,)).astype(np.float32),
           "lang_token_embs": rng.normal(size=(77, 512)).astype(np.float32)}
    for c, r, p in zip(cams, rgbs, pcds):
        obs[f"{c}_rgb"], obs[f"{c}_point_cloud"] = r[0], p[0]
    for arm in ("left", "right"):
        obs[f"low_dim_state_{arm}_arm"] = np.asarray([1.0, 0.02, 0.02, 0.5], np.float32)
    agent.act(0, obs, which_arm="dominant", new_scene_bounds=CROP_BOUNDS,
              dominant_assitive_policy=True)  # warm
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = agent.act(0, obs, which_arm="dominant", new_scene_bounds=CROP_BOUNDS,
                    dominant_assitive_policy=True)
    act_ms = (time.perf_counter() - t0) * 1e3
    act_counts = kernels.launch_counts()
    a = np.asarray(res.action)
    expect(a.shape == (9,) and bool(np.isfinite(a).all()), f"weights: action {a}")
    del agent, direct
    torch.cuda.empty_cache()

    # cli.eval on a seed directory of .msgpack checkpoints (the acting policy
    # and, as the stabilizing one, the same file): one episode
    cfg_run = Config().override(**train_cli.parse_overrides(
        protocol_overrides("dominant", WEIGHTS_ROOT)))
    cfg_run.save(os.path.join(seed_dir, "config.json"))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    # the sim's language from the checkpoint: the earlier phases cached the seeded tower
    with wrapped(sim_env, "_LANG_ENC", lambda _: None), \
            wrapped(sim_env, "_LANG_CACHE", lambda _: {}):
        results = eval_cli.main([f"seed_dir={seed_dir}", "framework.eval_type=missing",
                                 "framework.eval_episodes=1", "rlbench.episode_length=25",
                                 f"framework.left_arm_ckpt={msg}"], device=DEVICE)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_counts = kernels.launch_counts()
    expect(len(results) == 1 and results[0]["step"] == 0
           and np.isfinite(results[0]["eval_envs/return"]),
           f"weights: cli.eval on the .msgpack seed dir gave {results}")
    timings["weights_policy"] = dict(act_ms=act_ms, eval_s=eval_s, eval=results[0])
    log(f"[weights] policy: .pt -> .msgpack {files['QAttentionAgent_layer0.msgpack']['convert_s']:.2f}"
        f" s, agent load {files['QAttentionAgent_layer0.msgpack']['load_s']:.2f} s, every "
        f"parameter bit-equal to the .pt's; one act {act_ms:.3f} ms, launches {act_counts}; "
        f"cli.eval one episode {eval_s:.1f} s: {results[0]}, launches {eval_counts}")
    return act_counts, eval_counts


def weights_resume(rng, details, timings):
    """Two kernel-path train steps (K4), a JAX-format checkpoint with the
    optimizer state written and read back bit-equal, one more step from it
    on the plain path against the step from the in-memory state, and one
    kernel-path update of the restored agent.

    The resumed step (on a second batch, so that the moments of the first
    two steps pull its update away from the new gradient's) is held by the
    train rule on its losses and gradients (twice the plain bf16 path's
    distance from f32, per leaf against its largest f32 gradient). Its
    parameter update, which the restored moments shape, is held per leaf by
    the L2 norm of the difference over the norm of the in-memory state's
    update, within twice the same step's run-to-run spread from the
    in-memory state: element by element, LAMB's normalised update of an
    element whose gradient is rounding noise flips sign between runs (the
    card's plain step spreads by 1.4x a leaf's largest update there), and
    bf16 rounding moves the update by its own size, so neither the train
    rule nor an element-wise bound could see a restore that lost the
    optimizer state. A planted one (fresh moments) must fail."""
    import torch
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.agents.qfunction import make_optimizer, make_train_step
    from voxactb_tpu_torch.ops import cuda as kernels
    from voxactb_tpu_torch.optim import OptState

    cfg = train_config()
    batch, batch2 = train_batch(rng, cfg, 8), train_batch(rng, cfg, 8)

    def agent():
        a = QAttentionBCAgent(cfg, TRAIN_CAMERAS, SCENE_BOUNDS, batch_size=8,
                              training_iterations=100_000, device=DEVICE, seed=0)
        a.build(training=True)
        return a

    first = agent()
    kernels.reset_launch_counts()
    losses = [float(first.update(i, dict(batch))["total_loss"]) for i in range(2)]
    torch.cuda.synchronize()
    train_counts = kernels.launch_counts()
    path = os.path.join(WEIGHTS_ROOT, "resume", "QAttentionAgent_layer0.msgpack")
    os.makedirs(os.path.dirname(path))
    t0 = time.perf_counter()
    first.save_weight(path)
    save_s = time.perf_counter() - t0
    second = agent()
    t0 = time.perf_counter()
    second.load_weight(path)
    second._ensure_state()  # the first update's restore, without the update
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    a, b = first._state, second._state
    same = lambda x, y: [k for k in x if not torch.equal(x[k], y[k])]  # noqa: E731
    diff = dict(params=same(a.params, b.params), mu=same(a.opt_state.mu, b.opt_state.mu),
                nu=same(a.opt_state.nu, b.opt_state.nu))
    expect(not any(diff.values()) and int(a.step) == int(b.step) == 2
           and int(a.opt_state.count) == int(b.opt_state.count) == 2,
           f"weights: restored state differs from the in-memory one: {diff}")

    quiet = dict(apply_se3=False, input_dropout=0.0, attn_dropout=0.0)

    def step_from(state, **kw):
        """(update, losses, gradients) of one plain-path step from ``state``."""
        cfg_ = train_config(**quiet, pallas_attention_train=False, **kw)
        _, _, step = make_train_step(cfg_, make_optimizer(cfg_, 100_000), TRAIN_CAMERAS,
                                     device=DEVICE, seed=0)
        metrics, grads = step.loss_and_grads(state, batch2)
        new, _ = step(state, batch2, torch.Generator(device=DEVICE).manual_seed(7))
        torch.cuda.synchronize()
        return ({k: v - state.params[k] for k, v in new.params.items()},
                {k: float(v) for k, v in metrics.items()},
                {k: v.float() for k, v in grads.items()})

    zeros = lambda d: {k: torch.zeros_like(v) for k, v in d.items()}  # noqa: E731
    fresh = b._replace(opt_state=OptState(torch.zeros_like(b.opt_state.count),
                                          zeros(b.opt_state.mu), zeros(b.opt_state.nu)))
    (d_a, m_a, g_a), (d_again, _, _) = step_from(a), step_from(a)
    (d_b, m_b, g_b), (d_w, _, _) = step_from(b), step_from(fresh)
    _, m_32, g_32 = step_from(a, compute_dtype="float32")
    # the train rule on the losses and gradients
    loss_tol = 2.0 * max(abs(m_a[k] - m_32[k]) for k in m_32)
    loss_err = max(abs(m_b[k] - m_a[k]) for k in m_32)
    gscale = {k: float(v.abs().max()) for k, v in g_32.items()}
    live = [k for k in g_32 if gscale[k] > 0.0]
    plain = {k: max_err(g_a[k], g_32[k]) / gscale[k] for k in live}
    typical = statistics.median(plain.values())
    grad_tol = {k: 2.0 * max(plain[k], typical) for k in live}
    grad_err = {k: max_err(g_b[k], g_a[k]) / gscale[k] for k in live}
    # the update against the step's own run-to-run spread, per leaf in L2
    unorm = {k: float(v.norm()) for k, v in d_a.items()}
    moved = [k for k in d_a if unorm[k] > 0.0]
    rel = lambda d, k: float((d[k] - d_a[k]).norm()) / unorm[k]  # noqa: E731
    spread = max(rel(d_again, k) for k in moved)
    update_tol = 2.0 * max(spread, 2.0 ** -20)
    update_err = {k: rel(d_b, k) for k in moved}
    fault_err = {k: rel(d_w, k) for k in moved}
    caught = [k for k in moved if fault_err[k] > update_tol]
    worst = max(moved, key=update_err.get)
    report = dict(losses_two_steps=losses, step=m_b, loss_err=loss_err, loss_tol=loss_tol,
                  grad_err_worst=max(grad_err.values()),
                  grads_beyond=[k for k in live if grad_err[k] > grad_tol[k]],
                  grad_plain_vs_f32_median=typical, update_err_worst=update_err[worst],
                  worst_leaf=worst, update_spread=spread, update_tol=update_tol,
                  leaves=len(moved),
                  fresh_moments_leaves_caught=len(caught),
                  fresh_moments_err_median=statistics.median(fault_err.values()),
                  save_s=save_s, load_s=load_s, bytes=os.path.getsize(path))
    log(f"[weights] resume: two kernel-path steps (losses {losses}), launches {train_counts}; "
        f".msgpack with the optimizer state {report['bytes'] / 2 ** 20:.1f} MiB, save "
        f"{save_s:.2f} s, load {load_s:.2f} s, state bit-equal; one more plain step from it: "
        f"loss err {loss_err:.3g} (tol {loss_tol:.3g}), gradient err {max(grad_err.values()):.3g}"
        f" of a leaf's largest (the plain bf16 path's median {typical:.3g} from f32), update "
        f"err {update_err[worst]:.3g} of its leaf's norm at {worst} (tol {update_tol:.3g}, "
        f"run-to-run spread {spread:.3g}) over {len(moved)} leaves; fresh moments beyond it in "
        f"{len(caught)} leaves (median {report['fresh_moments_err_median']:.3g})")
    expect(all(np.isfinite(losses)), f"weights: resume losses {losses}")
    expect(loss_err <= loss_tol, f"weights: resumed step's losses {loss_err} > {loss_tol}")
    expect(not report["grads_beyond"],
           f"weights: resumed step's gradients beyond the train rule: {report['grads_beyond']}")
    expect(update_err[worst] <= update_tol, "weights: resumed step's update beyond tolerance")
    expect(bool(caught), "weights: a restore without the optimizer state stayed within tolerance")
    kernels.reset_launch_counts()
    loss = float(second.update(2, dict(batch))["total_loss"])
    torch.cuda.synchronize()
    resume_counts = kernels.launch_counts()
    expect(np.isfinite(loss) and int(second._state.step) == 3,
           f"weights: restored agent's update: loss {loss}, step {int(second._state.step)}")
    details["weights_resume"] = report
    timings["weights_resume"] = dict(save_s=save_s, load_s=load_s, bytes=report["bytes"])
    del first, second, a, b, fresh
    torch.cuda.empty_cache()
    return train_counts, resume_counts


def weights_vlm(details, timings):
    """``TorchOwlVitSamDetector.from_pretrained`` on the files and one f32 VLM
    pass; the bf16 kernel-path detector from the same files
    (``from_pretrained(compute_dtype=bfloat16)``), its replayed pass held by
    ``compare_sam_paths``' rule, one VLM pass on it with K7; one CLIP RN50
    forward; the sim's language encoder on the checkpoint."""
    import torch
    from voxactb_tpu_torch.models.clip_image import preprocess_clip_image
    from voxactb_tpu_torch.ops import cuda as kernels
    from voxactb_tpu_torch.sim import environment as sim_env
    from voxactb_tpu_torch.utils import pretrained as P
    from voxactb_tpu_torch.vlm.pipeline import VLM, TorchOwlVitSamDetector, task_queries

    rgb, pcd = vlm_frame(np.random.default_rng(0))
    t0 = time.perf_counter()
    f32 = TorchOwlVitSamDetector.from_pretrained("vit_h", score_threshold=0.0, device=DEVICE)
    torch.cuda.synchronize()
    build_f32_s = time.perf_counter() - t0
    vlm = VLM(f32)
    vlm.get_target_object_world_coords(rgb, pcd, VLM_TASK)  # warm
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        point32, radius32 = vlm.get_target_object_world_coords(rgb, pcd, VLM_TASK)
        walls.append((time.perf_counter() - t0) * 1e3)
    f32_ms = statistics.median(walls)
    expect(bool(np.isfinite(point32).all()) and np.isfinite(radius32),
           f"weights: f32 VLM pass {point32} {radius32}")
    del vlm, f32
    torch.cuda.empty_cache()

    # the bf16 detector of the kernel path, from the same files
    t0 = time.perf_counter()
    bf16 = TorchOwlVitSamDetector.from_pretrained("vit_h", score_threshold=0.0, device=DEVICE,
                                                  compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_bf16_s = time.perf_counter() - t0
    pipeline, seg = bf16._owl, bf16._sam
    query = pipeline.embed_queries([task_queries(VLM_TASK)])
    vlm = VLM(bf16)
    box, score, served = served_pass(vlm, rgb, pcd, VLM_TASK)
    compare_sam_paths(seg, rgb, box, served, details, tag="weights_vlm")
    del served
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    point, radius = vlm.get_target_object_world_coords(rgb, pcd, VLM_TASK)
    torch.cuda.synchronize()
    walls = [(time.perf_counter() - t0) * 1e3]
    counts = kernels.launch_counts()
    expect(counts["sam_attention"] == VLM_TOWERS["sam"]["depth"],
           f"weights: K7 launches {counts['sam_attention']} in one VLM pass")
    for _ in range(2):
        t0 = time.perf_counter()
        vlm.get_target_object_world_coords(rgb, pcd, VLM_TASK)
        walls.append((time.perf_counter() - t0) * 1e3)
    bf16_ms = statistics.median(walls)
    # stage times on the card (CUDA events), as vlm_episode takes them
    from voxactb_tpu_torch.models.sam_encoder import preprocess_image

    img = VLM_TOWERS["sam"]["img_size"]
    x = preprocess_image(rgb, img, torch.device(DEVICE))
    box_t = torch.as_tensor((np.asarray(box, np.float32)[None] * (img / max(rgb.shape[:2]))
                             + 0.5) / img, device=DEVICE)
    with torch.inference_mode():
        emb = seg.encoder(x)
        stage = dict(sam_encode_ms=time_ms(lambda: seg.encoder(x), reps=5),
                     owl_detect_ms=time_ms(lambda: pipeline.detect(rgb, query, 0.0), reps=5),
                     sam_decode_ms=time_ms(lambda: seg.decoder(emb, box_t), reps=5))
    del emb, x
    del vlm, seg, pipeline, bf16
    torch.cuda.empty_cache()

    # CLIP RN50's image tower at 224^2, and the sim's language on the checkpoint
    t0 = time.perf_counter()
    clip_img, _ = P.load_clip_image(device=DEVICE)
    load_img_s = time.perf_counter() - t0
    x = preprocess_clip_image(rgb, 224, DEVICE)
    with torch.inference_mode():
        emb = clip_img(x)
        rn50_ms = time_ms(lambda: clip_img(x), reps=5)
    expect(tuple(emb.shape) == (1, clip_img.attnpool.c_proj.weight.shape[0])
           and bool(torch.isfinite(emb).all()), f"weights: RN50 embedding {tuple(emb.shape)}")
    del clip_img
    with wrapped(sim_env, "_LANG_ENC", lambda _: None), \
            wrapped(sim_env, "_LANG_CACHE", lambda _: {}):
        sent, tok = sim_env.default_sim_language_encoder()(VLM_DESCRIPTION)
    want = sim_env._make_text_encoder(None, {}, model=P.load_clip_text(device="cpu")[0])(
        VLM_DESCRIPTION)
    seeded = sim_env._make_text_encoder(None, {})(VLM_DESCRIPTION)
    expect(np.array_equal(sent, want[0]) and np.array_equal(tok, want[1])
           and not np.allclose(sent, seeded[0]),
           "weights: the sim's language is not the checkpoint's tower's")
    random_ms = timings.get("vlm_episode", {}).get("vlm_pass_ms")
    timings["weights_vlm"] = dict(
        from_pretrained_s=build_f32_s, f32_vlm_pass_ms=f32_ms, bf16_towers_s=build_bf16_s,
        bf16_vlm_pass_ms=bf16_ms, bf16_vlm_pass_walls_ms=walls, **stage,
        random_weights_vlm_pass_ms=random_ms, rn50_ms=rn50_ms,
        clip_image_load_s=load_img_s, crop_point=[float(v) for v in point], crop_radius=radius,
        crop_point_f32=[float(v) for v in point32], crop_radius_f32=radius32,
        owl_box=[float(v) for v in box], owl_score=score)
    log(f"[weights] VLM on imported weights: from_pretrained (f32) {build_f32_s:.1f} s, f32 "
        f"VLM pass {f32_ms:.3f} ms (crop radius {radius32:.4f}); bf16 towers {build_bf16_s:.1f}"
        f" s, VLM pass with K7 {bf16_ms:.3f} ms (crop radius {radius:.4f}; the random-weight "
        f"vlm phase's pass {random_ms} ms; SAM-H encode {stage['sam_encode_ms']:.3f} ms, OWL "
        f"detect {stage['owl_detect_ms']:.3f} ms, SAM decode {stage['sam_decode_ms']:.3f} ms)"
        f"; K7 launches {counts['sam_attention']}; RN50 at "
        f"224^2 {rn50_ms:.3f} ms; the sim's 1024-d language from the checkpoint's tower")
    return counts


def weights(details, timings):
    """Phase 12: synthetic checkpoints at the published widths in the
    upstream layouts, written to a temporary ``VOXACTB_WEIGHTS_DIR`` and read
    back through the port's importers, tool and codec; removed at the end."""
    import shutil

    import torch
    from voxactb_tpu_torch.ops import cuda as kernels

    t_phase = time.perf_counter()
    shutil.rmtree(WEIGHTS_ROOT, ignore_errors=True)
    os.makedirs(os.path.join(WEIGHTS_ROOT, "weights"))
    files = {}
    before = os.environ.get("VOXACTB_WEIGHTS_DIR")
    os.environ["VOXACTB_WEIGHTS_DIR"] = os.path.join(WEIGHTS_ROOT, "weights")
    total = {k: 0 for k in kernels.LAUNCHES}
    try:
        write_checkpoints(files)
        for name, f in files.items():
            log(f"[weights] {name}: {f['keys']} keys, {f['params'] / 1e6:.1f}M values, "
                f"{f['bytes'] / 2 ** 20:.1f} MiB; drawn on the card {f['draw_s']:.1f} s, "
                f"saved {f['save_s']:.1f} s, read {f['load_s']:.1f} s")
        rng = np.random.default_rng(18)  # the phase's own stream
        runs = (weights_policy(files, rng, details, timings)
                + weights_resume(rng, details, timings) + (weights_vlm(details, timings),))
        for counts in runs:
            for k, v in counts.items():
                total[k] += v
    finally:
        if before is None:
            os.environ.pop("VOXACTB_WEIGHTS_DIR", None)
        else:
            os.environ["VOXACTB_WEIGHTS_DIR"] = before
        shutil.rmtree(WEIGHTS_ROOT, ignore_errors=True)
    wall_s = time.perf_counter() - t_phase
    timings["weights"] = dict(wall_s=wall_s, files={
        k: {kk: vv for kk, vv in v.items() if kk != "path"} for k, v in files.items()})
    log(f"[weights] {wall_s:.1f} s; launches {total}")
    torch.cuda.empty_cache()
    return dict(launches=total)


# ---------------------------------------------------------------------------
# phase 15: the train step split over ranks (two ranks sharing the card)
# ---------------------------------------------------------------------------

PARALLEL_ROOT = os.path.join(HERE, "build", "parallel")
PARALLEL_STEPS = 3
PARALLEL_MESHES = (("dp2", {"dp": 2}, {}), ("fsdp2", {"fsdp": 2}, dict(fsdp=True)),
                   ("tp2", {"tp": 2}, dict(model_parallel=True)))
# (fault, the mesh it is planted in)
PARALLEL_FAULTS = (("zero_dropout_offsets", "dp2"), ("local_trust_ratio", "fsdp2"),
                   ("summed_grads", "dp2"))
PARALLEL_TIMEOUT = 600
PARALLEL_ULP_RUNS = 2
PARALLEL_LOSS_ULPS = 8  # a batch mean of 8 f32 terms taken in another order
PARALLEL_UPDATE_TOL = 5e-4  # a parameter's own f32 rounding: up to 1e-4 of an update


def _one_process(spec, plant=()):
    """``dryrun.run_job`` on the card, with a kernel wrapper replaced for it
    (``planted``) when ``plant`` is given."""
    import torch
    from voxactb_tpu_torch.parallel import dryrun as D

    with contextlib.ExitStack() as stack:
        if plant:
            stack.enter_context(planted(*plant))
        out = D.run_job(spec, DEVICE)
    torch.cuda.empty_cache()
    return out


def update_rel(params, ref, init, names):
    """Per parameter: the L2 distance of ``params`` from ``ref`` over the norm
    of ``ref``'s update from ``init``."""
    return {k: float((params[k] - ref[k]).norm()) / float((ref[k] - init[k]).norm())
            for k in names}


def parallel(details, timings):
    """train50's config (full width, bf16, K4, LAMB, SE(3) augmentation and
    dropout on) at a global batch of 8, three steps from one seeded state:
    twice on one process, then in two spawned ranks that share the card over
    gloo (dp 2, fsdp 2 with the moments split, tp 2 with K4 on 4 of the 8
    heads per rank) and with planted faults; one NCCL rank;
    ``graft_entry.entry()``'s act on the card against ``make_infer_fn``'s;
    ``dryrun_multichip(4)`` on the CPU.

    The rule. The two one-process runs' distance apart, step by step, is the
    run-to-run spread. It is 0 where a step is reproducible (the first step's
    forward, whose losses come back bit-equal), while a split may take the
    same sums in another order, so the floor of a tolerance is what the same
    step in another summation order does: the one-process run with K4's
    plain version in the kernel's place, and ``PARALLEL_ULP_RUNS`` runs of
    that plain version with one bf16 ulp added to 1% of its outputs
    (``k4_plain_ulp``, as round 5's rule), each metric's largest distance over
    the steps. A data split (dp, fsdp) leaves the first forward's per-sample
    arithmetic as it is and reorders only the batch mean: its first step's
    losses must lie within twice the spread and ``PARALLEL_LOSS_ULPS`` f32
    ulps of the one-process losses. Every other metric (the losses of the
    later steps and of a tp split, ``grad_norm`` of every step, whose
    backward sums gradients in another order) must lie within twice the
    larger of the spread and the floor (at least 2^-20 of it), and every
    parameter, after the first and after the last step, within twice the
    larger of its own (the L2 distance over the norm of its update; at least
    the median parameter's). The ranks' optimizer, applied once to
    seeded gradients before the steps (``dryrun.check_gradients``), must give
    the one-process update within ``PARALLEL_UPDATE_TOL`` of each parameter's
    update: that update is f32 element-wise arithmetic, which only the norms'
    sums reorder. Each planted fault must fail one of these."""
    import shutil

    import torch
    from voxactb_tpu_torch import graft_entry
    from voxactb_tpu_torch.agents.qfunction import make_infer_fn
    from voxactb_tpu_torch.parallel import dryrun as D

    t_phase = time.perf_counter()
    os.makedirs(PARALLEL_ROOT, exist_ok=True)
    cfg = train_config()
    kw = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    batch_path = os.path.join(PARALLEL_ROOT, "batch.pt")
    torch.save(train_batch(np.random.default_rng(21), cfg, 8), batch_path)
    spec = lambda name, mesh, **k: D.job(  # noqa: E731
        name, mesh, steps=PARALLEL_STEPS, cfg=dict(kw, full=True), batch=batch_path,
        cameras=TRAIN_CAMERAS, training_iterations=100_000, seed=5, **k)

    k4 = ("voxactb_tpu_torch.ops.cuda.flash_attention_train", "flash_attention_train")
    one = lambda name, *plant: _one_process(spec(name, {"dp": 1}, first_params=True,  # noqa
                                                 update_check=not plant), plant)
    a, b = one("one_process_0"), one("one_process_1")
    floors = [one("k4_plain", *k4, k4_plain)] + [
        one(f"k4_plain_ulp{i}", *k4, k4_plain_ulp(i)) for i in range(1, PARALLEL_ULP_RUNS + 1)]
    init_fn, _, _ = D._build(spec("init", {"dp": 1}), "cpu")
    init = {k: v.detach() for k, v in init_fn().params.items()}
    del init_fn
    keys = sorted(a["metrics"][0])
    gap = lambda x, k: max(abs(m[k] - r[k]) for m, r in zip(x["metrics"], a["metrics"]))  # noqa
    step_spread = [{k: abs(m[k] - r[k]) for k in keys}
                   for m, r in zip(b["metrics"], a["metrics"])]
    metric_spread = {k: gap(b, k) for k in keys}
    metric_floor = {k: max(gap(f, k) for f in floors) for k in keys}
    metric_tol = [{k: 2.0 * max(sp[k], metric_floor[k], 2.0 ** -20 * abs(m[k])) for k in keys}
                  for sp, m in zip(step_spread, a["metrics"])]
    ulp = lambda v: float(np.spacing(np.float32(abs(v))))  # noqa: E731
    first_tol = {k: 2.0 * max(step_spread[0][k], PARALLEL_LOSS_ULPS * ulp(a["metrics"][0][k]))
                 for k in keys if k != "grad_norm"}
    names = [k for k in a["params"] if float((a["params"][k] - init[k]).norm()) > 0.0]
    tols, spreads = {}, {}
    for snap in ("params_first", "params"):
        spreads[snap] = update_rel(b[snap], a[snap], init, names)
        noise = {k: max([spreads[snap][k]] + [update_rel(f[snap], a[snap], init, [k])[k]
                                              for f in floors]) for k in names}
        floor = max(statistics.median(noise.values()), 2.0 ** -20)
        tols[snap] = {k: 2.0 * max(noise[k], floor) for k in names}

    def held(run):
        data_split = set(run["mesh"]) <= {"dp", "fsdp"}
        tol = lambda i, k: (first_tol[k] if data_split and i == 0 and k in first_tol  # noqa
                            else metric_tol[i][k])
        bad = [f"step {i} {k}" for i, m in enumerate(run["metrics"]) for k in keys
               if abs(m[k] - a["metrics"][i][k]) > tol(i, k)]
        worst, by_spread = {}, 0
        for snap in ("params_first", "params"):
            if run.get(snap) is None:
                continue
            err = update_rel(run[snap], a[snap], init, names)
            over = [k for k in names if err[k] > tols[snap][k]]
            by_spread += sum(err[k] > 2.0 * spreads[snap][k] for k in names)
            bad += [f"{snap} {k}" for k in over]
            w = max(names, key=lambda k: err[k] / tols[snap][k])
            worst[snap] = dict(leaf=w, err=err[w], tol=tols[snap][w], beyond=len(over))
        if run.get("update_params") is not None:
            err = update_rel(run["update_params"], a["update_params"], init, names)
            over = [k for k in names if err[k] > PARALLEL_UPDATE_TOL]
            bad += [f"update {k}" for k in over]
            w = max(names, key=err.get)
            worst["update"] = dict(leaf=w, err=err[w], tol=PARALLEL_UPDATE_TOL,
                                   beyond=len(over))
        return bad, worst, by_spread

    meshes = [spec(n, m, first_params=True, update_check=True, **k)
              for n, m, k in PARALLEL_MESHES]
    by_name = {n: (m, k) for n, m, k in PARALLEL_MESHES}
    faults = [spec(f"{on}_{fault}", by_name[on][0], fault=fault, update_check=True,
                   **by_name[on][1]) for fault, on in PARALLEL_FAULTS]
    t0 = time.perf_counter()
    ranks = D.spawn_jobs(2, meshes + faults, workdir=PARALLEL_ROOT, timeout=PARALLEL_TIMEOUT,
                         backend="gloo", device=DEVICE)
    ranks_s = time.perf_counter() - t0
    report = dict(one_process=dict(metrics=a["metrics"], ms_per_step=[a["ms_per_step"],
                                                                    b["ms_per_step"]],
                                   metric_spread=metric_spread, metric_floor=metric_floor,
                                   metric_tol=metric_tol, first_step_loss_tol=first_tol,
                                   median_leaf_spread={s_: statistics.median(v.values())
                                                       for s_, v in spreads.items()}),
                  ranks_s=ranks_s)
    launches = {}
    for run in ranks:
        bad, worst, by_spread = held(run)
        k4_ = [{k: v for k, v in r.items() if v} for r in run["launches"]]
        row = dict(metrics=run["metrics"], ms_per_step=run["ms_per_step"], beyond=bad[:20],
                   n_beyond=len(bad), worst=worst, launches_per_rank=k4_, mesh=run["mesh"],
                   n_sharded=run["n_sharded"], leaves_beyond_twice_the_spread=by_spread)
        if run["sharded_bytes"]:
            row["held_share"] = {n: h / w for n, (h, w) in run["sharded_bytes"].items()}
        report[run["name"]] = row
        if not run["name"].endswith(tuple(f for f, _ in PARALLEL_FAULTS)):
            for r in run["launches"]:
                for k, v in r.items():
                    launches[k] = launches.get(k, 0) + v
        log(f"[parallel] {run['name']} ({run['mesh']}): losses "
            f"{[round(m['total_loss'], 5) for m in run['metrics']]} (one process "
            f"{[round(m['total_loss'], 5) for m in a['metrics']]}); ms/step "
            f"{[round(x, 1) for x in run['ms_per_step']]}; {len(bad)} values beyond the "
            f"rule ({by_spread} parameters beyond twice the spread alone); worst {worst}; K4 "
            f"launches per rank {[(r.get('flash_attention_train_fwd'), r.get('flash_attention_train_bwd')) for r in k4_]}")

    # NCCL: one rank, one data-parallel step
    t0 = time.perf_counter()
    nccl = D.spawn_jobs(1, [D.job("nccl1", {"dp": 1}, steps=1, cfg=dict(kw, full=True),
                                  batch=batch_path, cameras=TRAIN_CAMERAS, seed=5,
                                  training_iterations=100_000)],
                        workdir=PARALLEL_ROOT, timeout=PARALLEL_TIMEOUT, backend="nccl",
                        device=DEVICE)[0]
    report["nccl1"] = dict(metrics=nccl["metrics"], s=time.perf_counter() - t0,
                           launches=nccl["launches"][0])
    log(f"[parallel] NCCL, one rank, one step: loss {nccl['metrics'][0]['total_loss']:.5f} "
        f"(one process {a['metrics'][0]['total_loss']:.5f}), launches "
        f"{ {k: v for k, v in nccl['launches'][0].items() if v} }")

    # graft_entry.entry() on the card
    torch.cuda.empty_cache()
    infer, args = graft_entry.entry()
    got = infer(*args)
    model, infer2 = make_infer_fn(graft_entry.entry_config(), seed=0)
    want = infer2(model, *args[1:])
    torch.cuda.synchronize()
    discrete = ("trans_idx", "rot_grip_idx", "collision_idx", "continuous_action")
    entry_diff = {f: max_err(getattr(got, f), getattr(want, f)) for f in got._fields
                  if getattr(got, f).numel()}
    report["entry"] = entry_diff
    log(f"[parallel] graft_entry.entry() act vs make_infer_fn: {entry_diff}")
    del model, infer, infer2, args
    torch.cuda.empty_cache()

    # the CPU dry run
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(4, timeout=PARALLEL_TIMEOUT)
    report["dryrun_multichip4"] = dict(losses=dry, s=time.perf_counter() - t0)
    shutil.rmtree(PARALLEL_ROOT, ignore_errors=True)
    report["phase_s"] = time.perf_counter() - t_phase
    details["parallel"] = report
    one_ms = statistics.median(a["ms_per_step"][1:] + b["ms_per_step"][1:])
    timings["parallel"] = dict(
        one_process_ms_per_step=a["ms_per_step"], phase_s=report["phase_s"],
        **{n: report[n]["ms_per_step"] for n, _, _ in PARALLEL_MESHES})
    log(f"[parallel] ms/step (median of steps 2-3): one process {one_ms:.1f}; "
        + "; ".join(f"{n} {statistics.median(report[n]['ms_per_step'][1:]):.1f}"
                    for n, _, _ in PARALLEL_MESHES)
        + f"; ranks {ranks_s:.1f} s, phase {report['phase_s']:.1f} s; {nvidia_smi_line()}")

    for n, _, _ in PARALLEL_MESHES:
        expect(report[n]["n_beyond"] == 0,
               f"parallel: {n} beyond the one-process spread in {report[n]['beyond']}")
        expect(all(np.isfinite(m["total_loss"]) for m in report[n]["metrics"]),
               f"parallel: {n} losses")
    for fault, on in PARALLEL_FAULTS:
        expect(report[f"{on}_{fault}"]["n_beyond"] > 0,
               f"parallel: planted fault {fault} in {on} stayed within the spread")
    shares = report["fsdp2"].get("held_share", {})
    expect(bool(shares) and all(abs(v - 0.5) < 1e-6 for v in shares.values()),
           f"parallel: fsdp2 holds {shares} of its split parameters")
    for n in ("dp2", "fsdp2", "tp2"):
        for r in report[n]["launches_per_rank"]:
            expect(r.get("flash_attention_train_fwd", 0) == 8 * PARALLEL_STEPS
                   and r.get("flash_attention_train_bwd", 0) == 8 * PARALLEL_STEPS,
                   f"parallel: {n} K4 launches per rank {r}")
    expect(np.isfinite(nccl["metrics"][0]["total_loss"])
           and nccl["launches"][0]["flash_attention_train_fwd"] == 8,
           f"parallel: NCCL rank {report['nccl1']}")
    expect(all(entry_diff[f] == 0.0 for f in discrete),
           f"parallel: entry() act differs from make_infer_fn's: {entry_diff}")
    return dict(launches=launches)


# ---------------------------------------------------------------------------
# phase 16: the six remaining root probes and the profilers' full modes
# ---------------------------------------------------------------------------

_ACT = ("front_fused", "front_patchify", "decoder_head", "decoder_tail_conv",
        "decoder_tail_trans_stats")
# (tool, keyword arguments, the sizes they give, the kernels whose launches must rise)
PROBES_B = (
    ("probe_op_floor", {}, "the JAX tool's: chains of 16 and 128 matmuls, one 100^3 act",
     _ACT + ("flash_attention",)),
    ("probe_act_ab", dict(n_chain=4), "chains of 4 acts (the JAX tool's 16, 4 and 32), "
     "3 runs in turns", _ACT + ("flash_attention",)),
    ("probe_decoder_ab", {}, "the JAX tool's: 16 tails at 100^3, 5 runs in turns",
     ("decoder_head", "decoder_tail_conv", "decoder_tail_trans_stats", "decoder_head_v3",
      "decoder_phase_gemm")),
    ("probe_decoder_parts", {}, "the JAX tool's: 100^3, 3 runs",
     ("decoder_head", "decoder_tail_conv", "decoder_tail_trans_stats", "grid_copy")),
    ("probe_front_batch", dict(chain=4), "chains of 4 steps (the JAX tool's 16)",
     ("front_fused", "front_patchify", "decoder_head", "decoder_tail_conv",
      "decoder_tail_trans_stats")),
    ("probe_front_matmul", dict(n_chain=4), "act chains of 4 (the JAX tool's 16 and 4), "
     "the front stage's chain of 8 as the JAX tool's", _ACT + ("flash_attention",)),
)
PROFILERS_B = (("profile_train", ["--bwd-split", "--flash-train", "--steps", "2"],
                ("flash_attention_train_fwd", "flash_attention_train_bwd")),
               ("profile_sam", ["--stage", "--frames", "1"], ("sam_attention",)))


def probes_b(details, timings):
    """The six probes on the card, then ``profile_train --bwd-split`` with K4
    at depths 6, 3 and 1 (batch 8) and ``profile_sam --stage``'s ladder at
    ViT-H 1024^2. Each tool's record goes to its own line and to
    ``chip_smoke.json``; the launches of the kernels each tool runs must
    rise."""
    import contextlib as ctx
    import importlib
    import io

    import torch
    from voxactb_tpu_torch.ops import cuda as kernels

    records, launches = {}, {k: 0 for k in kernels.LAUNCHES}
    runs = [(name, lambda mod, kw=kw: mod.main(**kw), sizes, want)
            for name, kw, sizes, want in PROBES_B]
    runs += [(name, lambda mod, argv=argv: mod.main(argv), " ".join(argv), want)
             for name, argv, want in PROFILERS_B]
    for name, call, sizes, want in runs:
        mod = importlib.import_module(f"voxactb_tpu_torch.tools.{name}")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = io.StringIO()
        with ctx.redirect_stdout(out):
            result = call(mod)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        seconds_ = time.perf_counter() - t0
        records[name] = dict(result=result, sizes=sizes, seconds=seconds_,
                             lines=out.getvalue().splitlines(),
                             launches={k: counts[k] for k in want})
        for k, v in counts.items():
            launches[k] += v
        log(f"[probes_b] {name} ({sizes}; {seconds_:.1f} s): "
            + json.dumps(result, default=str)[:1500])
        expect(all(counts[k] > 0 for k in want),
               f"probes_b: {name} launched {[k for k in want if not counts[k]]} no time")
        torch.cuda.empty_cache()
    # the JAX tool prints its variants' action mismatches and goes on: K2 and
    # the plain attention path round differently in bf16, and a random-weight
    # Q field of 10^6 voxels has near-ties (act100's rule holds the kernel
    # path to the plain one with flips only there); reported, not enforced
    ab = records["probe_act_ab"]["result"]
    log(f"[probes_b] probe_act_ab action mismatches: {ab['mismatches']}")
    dab = records["probe_decoder_ab"]["result"]
    expect(all(dab["argmax_equal"].values()), f"probes_b: decoder argmax {dab}")
    fm = records["probe_front_matmul"]["result"]
    expect(not fm["mismatches"], f"probes_b: probe_front_matmul actions {fm['mismatches']}")
    split = records["profile_train"]["result"]["bwd_split"]
    expect(all(np.isfinite(v) and v > 0 for k, v in split.items()
               if k.endswith("_ms") and not k.endswith("device_ms")
               and not k.startswith("bwd_conv")), f"probes_b: bwd split {split}")
    stages = records["profile_sam"]["result"]["stage_table"]
    expect(stages["full_ms"] > 0 and np.isfinite(stages["ladder_sum_ms"]),
           f"probes_b: profile_sam stages {stages}")
    details["probes_b"] = records
    timings["probes_b"] = {name: r["seconds"] for name, r in records.items()}
    log(f"[probes_b] launches: { {k: v for k, v in launches.items() if v} }; "
        f"{nvidia_smi_line()}")
    return dict(launches=launches)


# ---------------------------------------------------------------------------
# phase 13: the baseline zoo
# ---------------------------------------------------------------------------

BASELINE_CAMERAS = ["wrist", "wrist2"]
BASELINE_BATCH = 8
BASELINE_UPDATES = 20
BASELINE_LR = 1e-3  # BCLangAgent's default
# the card against the CPU in f32 (TF32 off), the same port module from the
# same state: outputs, losses and gradients within BASELINE_TOL of the
# largest value compared; one Adam update within 1% of the learning rate
# wherever a gradient is clear of that tolerance times 100 (where it is not,
# Adam's sign is rounding noise: there only its step bound holds)
BASELINE_TOL = 1e-4
LINGUNET_GRID = 48  # a multiple of 2^levels: at 50^3 the skip concat fails
LINGUNET_KW = dict(base_channels=16, levels=2)


def baseline_batch(rng, b):
    """A replay batch as ``BCLangAgent.update`` reads it: two 128^2 cameras,
    proprio 4, language 1024, a pose in the crop with a unit quaternion and a
    gripper bit."""
    pose = rng.normal(size=(b, 7)).astype(np.float32)
    pose[:, :3] = rng.uniform(CROP_BOUNDS[:3], CROP_BOUNDS[3:], (b, 3))
    pose[:, 3:] /= np.linalg.norm(pose[:, 3:], axis=-1, keepdims=True)
    idx = rng.integers(0, 72, (b, 4)).astype(np.int32)
    idx[:, 3] = rng.integers(0, 2, b)
    batch = {"low_dim_state": rng.normal(size=(b, 4)).astype(np.float32),
             "lang_goal_emb": rng.normal(size=(b, 1024)).astype(np.float32),
             "gripper_pose": pose, "rot_grip_action_indicies": idx}
    rgbs, pcds = clouds(rng, b)
    for c, r, p in zip(BASELINE_CAMERAS, rgbs, pcds):
        batch[f"{c}_rgb"], batch[f"{c}_point_cloud"] = r, p
    return batch


def baseline_grads(agent, batch):
    """The MSE loss and its gradients (flax layout, numpy) of ``agent``'s
    network on ``batch``, without an update."""
    import torch
    from voxactb_tpu_torch.weights import baseline_flax_tree

    net = agent.network
    rgbs, pcds = agent._inputs(batch)
    t = lambda k: agent._tensor(batch[k])  # noqa: E731
    target = torch.cat([t("gripper_pose"), t("rot_grip_action_indicies")[:, 3:4]], -1)
    params = dict(net.named_parameters())
    loss = torch.mean((net(rgbs, pcds, t("low_dim_state"), t("lang_goal_emb")) - target) ** 2)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), flat_tree(baseline_flax_tree(net, dict(zip(params, grads))))


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def baseline_params(agent):
    from voxactb_tpu_torch.weights import baseline_flax_tree

    return flat_tree(baseline_flax_tree(agent.network))


def update_errors(before, after_a, after_b, grads, lr=BASELINE_LR):
    """The largest difference of two agents' Adam updates from one state
    where the gradient is clear of noise, and the largest step anywhere
    beyond Adam's bound (lr, plus the rounding of p1 - p0)."""
    largest = max(float(np.abs(g).max()) for g in grads.values())
    worst, beyond = 0.0, 0.0
    for k, g in grads.items():
        da, db = after_a[k] - before[k], after_b[k] - before[k]
        sure = np.abs(g) > 100 * BASELINE_TOL * largest
        if sure.any():
            worst = max(worst, float(np.abs(da[sure] - db[sure]).max()))
        ulps = 4 * np.finfo(np.float32).eps * float(np.abs(before[k]).max())
        beyond = max(beyond, float(np.abs(da).max()) - lr * (1 + 1e-5) - ulps)
    return worst, beyond


def baseline_outputs(agent, batch):
    import torch

    rgbs, pcds = agent._inputs(batch)
    with torch.inference_mode():
        return agent.network(rgbs, pcds, agent._tensor(batch["low_dim_state"]),
                             agent._tensor(batch["lang_goal_emb"])).float().cpu()


def query_unscaled(net):
    """The ViT's attention with its query left unscaled (``head_dim`` 1 in
    the scale): a layout fault of flax's MultiHeadDotProductAttention. A
    planted fault."""
    from voxactb_tpu_torch.models.baselines import MultiHeadDotProductAttention

    mods = [m for m in net.modules() if isinstance(m, MultiHeadDotProductAttention)]

    @contextlib.contextmanager
    def ctx():
        before = [m.head_dim for m in mods]
        for m in mods:
            m.head_dim = 1
        try:
            yield
        finally:
            for m, hd in zip(mods, before):
                m.head_dim = hd
    return ctx()


def symmetric_same_padding(_net):
    """The CNN's flax ``"SAME"`` pads replaced by PyTorch's symmetric
    ``padding=1``. A planted fault."""
    import torch.nn.functional as F

    return planted("voxactb_tpu_torch.models.baselines", "pad_same_nhwc",
                   lambda _fn: lambda x, k, s: F.pad(x, (0, 0, 1, 1, 1, 1)))


BASELINE_FAULTS = {"cnn": ("symmetric_same_padding", symmetric_same_padding),
                   "vit": ("query_unscaled", query_unscaled)}


def flipped_leaf_file(src, dst, leaf):
    """A copy of the checkpoint ``src`` with one byte of ``leaf``'s data
    flipped. A planted fault."""
    data = bytearray(open(src, "rb").read())
    raw = np.ascontiguousarray(leaf).tobytes()
    at = bytes(data).find(raw)
    expect(at >= 0, "checkpoint fault: the leaf's bytes are not in the file")
    data[at + len(raw) // 2] ^= 0x40
    with open(dst, "wb") as f:
        f.write(bytes(data))


def baseline_agent_phase(network, rng, root, details):
    """One baseline agent at the JAX module's default widths, f32: the card
    against the CPU from one state (forward, gradients, one update; the
    planted fault must fail the forward), 20 updates on one batch (the loss
    falls), the msgpack checkpoint bit-equal through save and load (a
    flipped byte must break it), acts."""
    import shutil

    import torch
    from voxactb_tpu_torch.agents.baseline_agents import BCLangAgent

    batch = baseline_batch(rng, BASELINE_BATCH)
    obs = {k: v[:1] for k, v in batch.items()}
    card = BCLangAgent(BASELINE_CAMERAS, network=network, device=DEVICE, seed=0)
    host = BCLangAgent(BASELINE_CAMERAS, network=network, device="cpu", seed=0)
    for agent in (card, host):
        agent.build(training=True)
        agent.act(0, obs)  # sizes the network from the sample (CPU generator, seed 0)
    p0 = baseline_params(host)
    expect(all(np.array_equal(v, p0[k]) for k, v in baseline_params(card).items()),
           f"baselines {network}: the card's initial weights differ from the CPU's")
    row = dict(parameters=int(sum(v.size for v in p0.values())))

    out_card, out_host = baseline_outputs(card, batch), baseline_outputs(host, batch)
    tol = BASELINE_TOL * float(out_host.abs().max())
    row["forward"] = dict(max_abs_err=max_err(out_card, out_host), tol=tol)
    name, fault = BASELINE_FAULTS[network]
    with fault(card.network):
        row["forward"][f"fault_{name}"] = max_err(baseline_outputs(card, batch), out_host)
    expect(row["forward"]["max_abs_err"] <= tol,
           f"baselines {network}: card vs CPU forward {row['forward']}")
    expect(row["forward"][f"fault_{name}"] > tol,
           f"baselines {network}: the planted {name} passed the forward check")

    loss_card, g_card = baseline_grads(card, batch)
    loss_host, g_host = baseline_grads(host, batch)
    g_largest = max(float(np.abs(g).max()) for g in g_host.values())
    g_err = max(float(np.abs(g_card[k] - g_host[k]).max()) for k in g_host)
    l_card = float(card.update(0, batch)["total_loss"])
    l_host = float(host.update(0, batch)["total_loss"])
    worst, beyond = update_errors(p0, baseline_params(card), baseline_params(host), g_host)
    row["step"] = dict(loss_card=l_card, loss_cpu=l_host, grad_err=g_err,
                       grad_tol=BASELINE_TOL * g_largest, update_err=worst,
                       update_tol=1e-2 * BASELINE_LR, beyond_adam_bound=beyond)
    expect(abs(l_card - l_host) <= BASELINE_TOL * abs(l_host)
           and abs(loss_card - loss_host) <= BASELINE_TOL * abs(loss_host),
           f"baselines {network}: card vs CPU loss {row['step']}")
    expect(g_err <= BASELINE_TOL * g_largest, f"baselines {network}: gradients {row['step']}")
    expect(worst <= 1e-2 * BASELINE_LR and beyond <= 0,
           f"baselines {network}: one update {row['step']}")

    # 20 updates on one batch: the loss falls; ms per update
    losses, walls = [], []
    for i in range(BASELINE_UPDATES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(card.update(1 + i, batch)["total_loss"]))  # float() syncs
        walls.append((time.perf_counter() - t0) * 1e3)
    expect(all(np.isfinite(losses)) and losses[-1] < losses[0],
           f"baselines {network}: the loss did not fall: {losses}")
    row.update(loss_first=losses[0], loss_last=losses[-1],
               ms_per_update=statistics.median(walls[1:]))

    # acts: 9 values, a unit quaternion, the collision bit 1
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        action = np.asarray(card.act(0, obs).action)
        walls.append((time.perf_counter() - t0) * 1e3)
    expect(action.shape == (9,) and bool(np.isfinite(action).all()) and action[8] == 1.0
           and abs(float(np.linalg.norm(action[3:7])) - 1.0) < 1e-5,
           f"baselines {network}: act returned {action}")
    row["ms_per_act"] = statistics.median(walls[2:])

    # the checkpoint: saved, loaded into a fresh agent bit-equal, and saved
    # back byte for byte; a byte flipped in one leaf's data must break it
    d = os.path.join(root, network)
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    card.save_weights(os.path.join(d, "saved"))
    save_s = time.perf_counter() - t0
    saved = baseline_params(card)
    fresh = BCLangAgent(BASELINE_CAMERAS, network=network, device=DEVICE, seed=9)
    t0 = time.perf_counter()
    fresh.load_weights(os.path.join(d, "saved"))
    fresh.act(0, obs)
    load_s = time.perf_counter() - t0
    same = lambda a: all(np.array_equal(a[k], v) for k, v in saved.items())  # noqa: E731
    expect(same(baseline_params(fresh)), f"baselines {network}: the loaded weights differ")
    fresh.save_weights(os.path.join(d, "again"))
    path = lambda sub: os.path.join(d, sub, "BCLangAgent.msgpack")  # noqa: E731
    expect(open(path("saved"), "rb").read() == open(path("again"), "rb").read(),
           f"baselines {network}: the checkpoint's bytes changed through load and save")
    leaf = max(saved, key=lambda k: saved[k].size)
    os.makedirs(os.path.join(d, "flipped"))
    flipped_leaf_file(path("saved"), path("flipped"), saved[leaf])
    bad = BCLangAgent(BASELINE_CAMERAS, network=network, device=DEVICE, seed=9)
    bad.load_weights(os.path.join(d, "flipped"))
    bad.act(0, obs)
    expect(not same(baseline_params(bad)),
           f"baselines {network}: a flipped byte in {leaf} was not seen")
    row.update(checkpoint_bytes=os.path.getsize(path("saved")), save_s=save_s, load_s=load_s,
               flipped_leaf=leaf)
    details.setdefault("baselines", {})[network] = row
    del card, host, fresh, bad
    return row


def lingunet_phase(rng, details):
    """``LingUNetQNet`` at base 16 and 2 levels on a [1, 48^3, 10] grid: a
    forward and a backward on the card against the same module on the CPU."""
    import copy

    import torch
    from voxactb_tpu_torch.models.baselines import LingUNetQNet

    n = LINGUNET_GRID
    host = LingUNetQNet(10, 4, 1024, generator=torch.Generator().manual_seed(0),
                        **LINGUNET_KW)
    card = copy.deepcopy(host).to(DEVICE)
    inputs = (rng.normal(size=(1, n, n, n, 10)).astype(np.float32),
              rng.normal(size=(1, 4)).astype(np.float32),
              rng.normal(size=(1, 1024)).astype(np.float32))
    outs, grads, walls = {}, {}, {}
    for tag, model in (("card", card), ("cpu", host)):
        dev = next(model.parameters()).device
        x = [torch.from_numpy(a).to(dev) for a in inputs]
        for _ in range(2 if tag == "card" else 1):  # the card's second pass is timed
            model.zero_grad(set_to_none=True)
            if tag == "card":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(*x)
            loss = sum(out[k].square().mean() for k in sorted(out))
            loss.backward()
            if tag == "card":
                torch.cuda.synchronize()
            walls[tag] = (time.perf_counter() - t0) * 1e3
        outs[tag] = {k: v.detach().float().cpu() for k, v in out.items()}
        grads[tag] = {k: p.grad.float().cpu() for k, p in model.named_parameters()}
    row = {"ms_card": walls["card"], "ms_cpu": walls["cpu"]}
    for k in outs["cpu"]:
        row[k] = dict(max_abs_err=max_err(outs["card"][k], outs["cpu"][k]),
                      tol=BASELINE_TOL * float(outs["cpu"][k].abs().max()))
    g_largest = max(float(g.abs().max()) for g in grads["cpu"].values())
    row["grads"] = dict(max_abs_err=max(max_err(grads["card"][k], g)
                                        for k, g in grads["cpu"].items()),
                        tol=BASELINE_TOL * g_largest)
    expect(outs["card"]["trans"].shape == (1, n, n, n, 1), "lingunet: trans shape")
    bad = [k for k, v in row.items() if isinstance(v, dict) and v["max_abs_err"] > v["tol"]]
    expect(not bad, f"lingunet: card vs CPU beyond tolerance in {bad}: {row}")
    details.setdefault("baselines", {})["lingunet"] = row
    return row


def baselines(details, timings):
    """Phase 13: the baseline zoo (CNN and ViT BC-lang, LingUNet) on the
    card, plain PyTorch: no TPU kernel computes their functions."""
    import shutil

    import torch
    from voxactb_tpu_torch.ops import cuda as kernels

    t_phase = time.perf_counter()
    root = os.path.join(HERE, "build", "baselines")
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(19)  # the phase's own stream
    kernels.reset_launch_counts()
    rows = {net: baseline_agent_phase(net, rng, root, details) for net in ("cnn", "vit")}
    lingunet = lingunet_phase(rng, details)
    counts = kernels.launch_counts()
    expect(not any(counts.values()), f"baselines: a TPU kernel's port ran: {counts}")
    shutil.rmtree(root, ignore_errors=True)
    wall_s = time.perf_counter() - t_phase
    card = nvidia_smi_line()
    timings["baselines"] = dict(wall_s=wall_s, card=card, lingunet_ms=lingunet["ms_card"], **{
        net: {k: r[k] for k in ("ms_per_update", "ms_per_act", "loss_first", "loss_last",
                                "parameters")} for net, r in rows.items()})
    for net, r in rows.items():
        log(f"[baselines] {net}: {r['parameters'] / 1e6:.2f}M parameters, batch "
            f"{BASELINE_BATCH}: {r['ms_per_update']:.3f} ms/update, {r['ms_per_act']:.3f} "
            f"ms/act; loss {r['loss_first']:.4f} -> {r['loss_last']:.4f} over "
            f"{BASELINE_UPDATES} updates; card vs CPU forward {r['forward']['max_abs_err']:.3g} "
            f"(tol {r['forward']['tol']:.3g}; the planted fault "
            f"{[v for k, v in r['forward'].items() if k.startswith('fault')][0]:.3g}), "
            f"gradients {r['step']['grad_err']:.3g} (tol {r['step']['grad_tol']:.3g}), update "
            f"{r['step']['update_err']:.3g} (tol {r['step']['update_tol']:.3g}); checkpoint "
            f"{r['checkpoint_bytes']} bytes bit-equal through save and load, a flipped byte "
            f"in {r['flipped_leaf']} caught; {card}")
    log(f"[baselines] lingunet [1,{LINGUNET_GRID}^3,10] forward+backward {lingunet['ms_card']:.3f}"
        f" ms on the card ({lingunet['ms_cpu']:.1f} ms on the CPU), card vs CPU: " + ", ".join(
            f"{k} {v['max_abs_err']:.3g} (tol {v['tol']:.3g})" for k, v in lingunet.items()
            if isinstance(v, dict)) + f"; no TPU kernel runs in this phase (launches {counts}); "
        f"{wall_s:.1f} s")
    torch.cuda.empty_cache()
    return dict(launches=counts)


# ---------------------------------------------------------------------------
# phase 14: VoxPoser's planner in the rollout, the real-robot episode and the
# offline checkpoint selection
# ---------------------------------------------------------------------------

VOXPOSER_PROGRAM = (
    "obj = detect('jar')\n"
    "aff = get_empty_affordance_map()\n"
    "set_voxel_by_radius(aff, pointat2index(obj.position), 4, 1.0)\n"
    "ret_val = execute('ee', aff)\n")
VOXPOSER_MAP = 100  # the planner's map resolution (the JAX package's default)
VOXPOSER_EPISODE = 6  # policy steps after the prologue
PREPOSITION_STEPS = 10
REAL_EPISODE = 6
# hand-eye extrinsics (policy frame -> each robot's base), offsets of a few cm
REAL_EXTRINSICS = {"right": [0.05, -0.30, -0.02], "left": [-0.04, 0.30, 0.01]}
SELECT_STEPS = (0, 100, 200)  # 200 is written in the JAX format
SELECT_VAL = 2  # held-out acting transitions


class FakeURController:
    """A UR controller on loopback: serves the secondary (30002-style) robot
    state stream and the realtime (30003-style) stream, records the URScript
    lines it receives and executes ``movel`` / ``movej`` by teleporting."""

    def __init__(self):
        import socket
        import struct
        import threading

        self._socket, self._struct = socket, struct
        self.q = np.zeros(6)
        self.tcp = np.array([0.3, 0.0, 0.4, 0.0, 3.14, 0.0])
        self.programs = []
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.sec_srv = socket.create_server(("127.0.0.1", 0))
        self.rt_srv = socket.create_server(("127.0.0.1", 0))
        self.sec_port = self.sec_srv.getsockname()[1]
        self.rt_port = self.rt_srv.getsockname()[1]
        self._threads = [threading.Thread(target=f, daemon=True)
                         for f in (self._sec_loop, self._rt_loop)]
        for t in self._threads:
            t.start()

    def _state_packet(self) -> bytes:
        pack = self._struct.pack
        with self._lock:
            q, tcp = self.q.copy(), self.tcp.copy()
        mode = pack(">Q", 0) + bytes([1, 1, 1, 0, 0, 1, 0, 7])
        jd = b"".join(pack(">ddd", q[j], q[j], 0.0) + bytes(17) for j in range(6))
        ci = pack(">6d", *tcp)
        payload = bytes([16]) + b"".join(pack(">i", 5 + len(body)) + bytes([sub]) + body
                                         for sub, body in ((0, mode), (1, jd), (4, ci)))
        return pack(">i", 4 + len(payload)) + payload

    def _rt_packet(self) -> bytes:
        with self._lock:
            q, tcp = self.q.copy(), self.tcp.copy()
        doubles = np.zeros(131)
        doubles[0] = time.time() % 1e6
        doubles[31:37] = q  # the documented layout: time + 5 six-vectors before q
        doubles[55:61] = tcp
        payload = self._struct.pack(f">{len(doubles)}d", *doubles)
        return self._struct.pack(">i", 4 + len(payload)) + payload

    def _sec_loop(self):
        try:
            conn, _ = self.sec_srv.accept()
        except OSError:
            return
        conn.settimeout(0.01)
        buf = b""
        with conn:
            while not self._stop.is_set():
                try:
                    conn.sendall(self._state_packet())
                    data = conn.recv(65536)
                    buf += data
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        self._execute(line.decode())
                except self._socket.timeout:
                    pass
                except OSError:
                    return
                time.sleep(0.005)

    def _execute(self, line: str) -> None:
        self.programs.append(line)
        for prefix, attr in (("movel(p[", "tcp"), ("movej([", "q")):
            if line.startswith(prefix):
                vals = [float(v) for v in line.split("[")[1].split("]")[0].split(",")]
                with self._lock:
                    setattr(self, attr, np.array(vals))

    def _rt_loop(self):
        try:
            conn, _ = self.rt_srv.accept()
        except OSError:
            return
        with conn:
            while not self._stop.is_set():
                try:
                    conn.sendall(self._rt_packet())
                except OSError:
                    return
                time.sleep(0.005)

    def stop(self):
        self._stop.set()
        self.sec_srv.close()
        self.rt_srv.close()
        for t in self._threads:
            t.join(timeout=2.0)


def voxposer_agents(cams, **kw):
    """The acting (dominant, arm head) and stabilizing (assistive) policies
    at full width on the 50^3 crop with ``bench.py``'s kernel flags."""
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent

    acting = QAttentionBCAgent(act_config(50, which_arm="dominant", arm_pred_loss=True,
                                          crop_target_obj_voxel=True, crop_radius=0.3),
                               cams, SCENE_BOUNDS, device=DEVICE, seed=0, **kw)
    stabilizing = QAttentionBCAgent(act_config(50, which_arm="assistive",
                                               crop_target_obj_voxel=True, crop_radius=0.3),
                                    cams, SCENE_BOUNDS, device=DEVICE, seed=1, **kw)
    acting.build(training=False)
    stabilizing.build(training=False)
    return acting, stabilizing


def voxposer_env(seed, lang):
    from voxactb_tpu_torch.sim.environment import BimanualTaskEnvironment
    from voxactb_tpu_torch.sim.tasks import TASK_REGISTRY

    env = BimanualTaskEnvironment(TASK_REGISTRY[PROTOCOL_TASK], cameras=PROTOCOL_CAMERAS,
                                  image_size=IMG, episode_length=25, seed=seed,
                                  lang_encoder=lang)
    env.launch()
    return env


def voxposer_planner(env, cache_dir, bounds=SCENE_BOUNDS):
    from voxactb_tpu_torch.voxposer.interface import VoxPoserPlanner, make_sim_object_lookup
    from voxactb_tpu_torch.voxposer.lmp import ScriptedBackend
    from voxactb_tpu_torch.voxposer.value_maps import VoxelMapSpec

    return VoxPoserPlanner(ScriptedBackend({"hand": VOXPOSER_PROGRAM}),
                           VoxelMapSpec(bounds, VOXPOSER_MAP), make_sim_object_lookup(env),
                           cache_dir=cache_dir)


def cpu_prologue(seed, lang, cache_dir, bounds=SCENE_BOUNDS):
    """The prologue's motions from a CPU run: the same planner on a fresh sim
    of the same seed, nothing on the card."""
    from voxactb_tpu_torch.runners.rollout import RolloutGenerator

    env = voxposer_env(seed, lang)
    record = []
    step = env.preposition_step
    env.preposition_step = lambda a, arm: record.append((np.asarray(a).copy(), arm)) or step(
        a, arm)
    RolloutGenerator()._voxposer_preposition(env, voxposer_planner(env, cache_dir, bounds),
                                             env.reset(), PREPOSITION_STEPS)
    return record


def voxposer_sim(acting, stabilizing, lang, root, stages):
    """(a) An open_jar episode on the kinematic sim: VoxPoser's prologue,
    then the dual-policy acts on K1-K3; the prologue bit-equal to a CPU run
    (a planner on a map 1 cm off must differ); then a voxposer_only episode."""
    from voxactb_tpu_torch.ops import cuda as kernels
    from voxactb_tpu_torch.runners.rollout import RolloutGenerator

    seed = 21
    t0 = time.perf_counter()
    env = voxposer_env(seed, lang)
    planner = voxposer_planner(env, os.path.join(root, "llm_cache"))
    prologue = []
    step = env.preposition_step
    env.preposition_step = lambda a, arm: prologue.append((np.asarray(a).copy(), arm)) or step(
        a, arm)
    kernels.reset_launch_counts()
    ts = list(RolloutGenerator().generator(
        env, acting, VOXPOSER_EPISODE, eval=True, left_arm_agent=stabilizing,
        which_arm="dominant_assistive", crop_target_obj_voxel=True, crop_radius=0.3,
        no_voxposer=False, planner=planner, max_preposition_steps=PREPOSITION_STEPS))
    counts = kernels.launch_counts()
    stages["sim_episode_s"] = time.perf_counter() - t0
    expect(len(prologue) > 0 and {arm for _, arm in prologue} <= {"left", "right"},
           f"voxposer_robot: no prologue motions ({len(prologue)})")
    # a random policy's step may end the episode (an invalid action), as in
    # the protocol phases; the acts after the prologue must run
    expect(1 <= len(ts) <= VOXPOSER_EPISODE, f"voxposer_robot: {len(ts)} policy steps")
    for t in ts:
        a = np.asarray(t.action)
        expect(a.shape == (9,) and bool(np.isfinite(a).all()), "voxposer_robot: action")

    t0 = time.perf_counter()
    on_cpu = cpu_prologue(seed, lang, os.path.join(root, "llm_cache_cpu"))
    shifted = [b + d for b, d in zip(SCENE_BOUNDS, (0.01, 0.0, 0.0, 0.01, 0.0, 0.0))]
    off = cpu_prologue(seed, lang, os.path.join(root, "llm_cache_off"), shifted)
    stages["cpu_prologue_s"] = time.perf_counter() - t0
    same = lambda xs, ys: len(xs) == len(ys) and all(  # noqa: E731
        a.dtype == b.dtype and np.array_equal(a, b) and s == r
        for (a, s), (b, r) in zip(xs, ys))
    expect(same(prologue, on_cpu), "voxposer_robot: the prologue differs from the CPU run")
    expect(not same(off, on_cpu), "voxposer_robot: a map 1 cm off gave the same prologue")

    t0 = time.perf_counter()
    only_env = voxposer_env(seed + 1, lang)
    kernels.reset_launch_counts()
    only = list(RolloutGenerator().generator(
        only_env, None, 25, voxposer_only_eval=True,
        planner=voxposer_planner(only_env, os.path.join(root, "llm_cache"))))
    only_counts = kernels.launch_counts()
    stages["voxposer_only_s"] = time.perf_counter() - t0
    expect(len(only) > 0 and all(np.isfinite(np.asarray(t.action)).all() for t in only),
           f"voxposer_robot: voxposer_only gave {len(only)} steps")
    expect(not any(only_counts.values()),
           f"voxposer_robot: the voxposer_only episode launched kernels {only_counts}")
    return dict(launches=counts, prologue=len(prologue), policy_steps=len(ts),
                voxposer_only_steps=len(only),
                voxposer_only_return=float(sum(t.reward for t in only)))


def real_cameras(rng):
    """Seeded RGB-D frames at 128^2 with a pinhole K: the front camera sees
    the task's colour on a patch at about 0.9 m, the wrist cameras a
    cloud in front of them."""
    from voxactb_tpu_torch.vlm.pipeline import TASK_COLORS

    K = np.array([[110.0, 0, IMG / 2], [0, 110.0, IMG / 2], [0, 0, 1]], np.float32)
    frames = {}
    for name in PROTOCOL_CAMERAS:
        rgb = rng.integers(0, 60, (IMG, IMG, 3)).astype(np.uint8)
        depth = rng.uniform(0.6, 1.4, (IMG, IMG)).astype(np.float32)
        if name == "front":  # a patch of a third of the frame's side
            patch = (slice(IMG // 3, 2 * IMG // 3),) * 2
            rgb[patch] = TASK_COLORS[PROTOCOL_TASK].astype(np.uint8)
            depth[patch] = 0.9 + rng.uniform(-0.02, 0.02, depth[patch].shape)
        frames[name] = (rgb, depth, K)
    cam_ext = {name: np.eye(4) for name in PROTOCOL_CAMERAS}
    for i, name in enumerate(PROTOCOL_CAMERAS):
        cam_ext[name][:3, 3] = [0.2 * i - 0.2, 0.0, 0.1]
    return {name: (lambda f=f: f) for name, f in frames.items()}, cam_ext


def expected_programs(steps, extrinsics, robots, dominant):
    """What each controller must have received for the env's ``steps``:
    per step the ``movel`` of the action's position through the hand-eye
    extrinsics with its quaternion after ``guard_gimbal_lock`` (axis-angle,
    in the robot's base), then the gripper program."""
    from voxactb_tpu_torch.realrobot import urscript as urs
    from voxactb_tpu_torch.realrobot.robot import quat_to_axis_angle
    from voxactb_tpu_torch.realrobot.robot_env import guard_gimbal_lock

    lines = {"right": [], "left": []}
    for action, which in steps:
        a = np.asarray(action, np.float64)
        arm = {"dominant": dominant,
               "assistive": "left" if dominant == "right" else "right"}.get(which, which)
        pos = (extrinsics[arm] @ np.concatenate([a[:3], [1.0]]))[:3]
        pose = robots.arm(arm)._to_base(np.concatenate([pos, quat_to_axis_angle(
            guard_gimbal_lock(a[3:7]))]))
        grip = int(round((1.0 - float(np.clip(float(a[7]), 0, 1))) * 255))
        for prog in (urs.movel(pose, 0.1, 0.1), urs.robotiq_set_position(grip)):
            lines[arm] += prog.strip().split("\n")
    return lines


def real_robot(acting, stabilizing, lang, rng, stages):
    """(b) A real-robot episode: ``RealRobotEnv`` over ``BimanualURRobot``
    and two loopback UR controllers, seeded RGB-D cameras, the VLM crop on
    the front camera (K7), dual-policy acts (K1-K3); the commands the
    controllers received, parsed back, are the actions after the extrinsics
    and the gimbal guard (without the extrinsics they must differ)."""
    from voxactb_tpu_torch.ops import cuda as kernels
    from voxactb_tpu_torch.ops.geometry import scene_bounds_from_crop
    from voxactb_tpu_torch.realrobot.robot import (
        BimanualURRobot, URRobot, axis_angle_to_quat)
    from voxactb_tpu_torch.realrobot.robot_env import RealRobotEnv, guard_gimbal_lock
    from voxactb_tpu_torch.runners.rollout import RolloutGenerator
    from voxactb_tpu_torch.vlm.pipeline import VLM

    t0 = time.perf_counter()
    vlm = VLM(vlm_detector(seed=22))
    stages["vlm_build_s"] = time.perf_counter() - t0
    extrinsics = {}
    for arm, offset in REAL_EXTRINSICS.items():
        extrinsics[arm] = np.eye(4)
        extrinsics[arm][:3, 3] = offset
    cameras, cam_ext = real_cameras(rng)
    controllers = {arm: FakeURController() for arm in ("right", "left")}
    robots = None
    try:
        robots = BimanualURRobot(*(URRobot("127.0.0.1", controllers[a].sec_port,
                                           controllers[a].rt_port) for a in ("right", "left")))
        env = RealRobotEnv(robots, cameras, extrinsics, cam_extrinsics=cam_ext, vlm=vlm,
                           task_name=PROTOCOL_TASK, episode_length=REAL_EPISODE,
                           dominant_arm="right", lang_encoder=lang)
        steps = []
        step = env.step
        env.step = lambda a, arm: steps.append((np.asarray(a).copy(), arm)) or step(a, arm)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ts = list(RolloutGenerator().generator(
            env, acting, REAL_EPISODE, eval=True, left_arm_agent=stabilizing,
            which_arm="dominant_assistive", crop_target_obj_voxel=True, crop_radius=0.3,
            no_voxposer=True))
        counts = kernels.launch_counts()
        stages["real_episode_s"] = time.perf_counter() - t0
        n_lines = {arm: len(v) for arm, v in
                   expected_programs(steps, extrinsics, robots, "right").items()}
        deadline = time.time() + 10
        while time.time() < deadline and any(
                len(controllers[a].programs) < n for a, n in n_lines.items()):
            time.sleep(0.01)
        got = {arm: list(c.programs) for arm, c in controllers.items()}
        want = expected_programs(steps, extrinsics, robots, "right")
        no_ext = expected_programs(steps, {a: np.eye(4) for a in extrinsics}, robots, "right")
        expect(got == want, "real_robot: the controllers' programs differ from the actions "
               f"after the extrinsics and the gimbal guard: {got} vs {want}")
        expect(got != no_ext, "real_robot: the programs ignore the hand-eye extrinsics")
        # the movel lines parsed back: positions to 1e-6, orientations as the
        # guarded quaternions (up to sign)
        worst_pos, worst_quat = 0.0, 0.0
        by_arm = {"right": iter([l for l in got["right"] if l.startswith("movel")]),
                  "left": iter([l for l in got["left"] if l.startswith("movel")])}
        for action, which in steps:
            arm = {"dominant": "right", "assistive": "left"}.get(which, which)
            vals = np.array([float(v) for v in next(by_arm[arm]).split("[")[1].split("]")[0]
                             .split(",")])
            a = np.asarray(action, np.float64)
            pos = (extrinsics[arm] @ np.concatenate([a[:3], [1.0]]))[:3]
            q = guard_gimbal_lock(a[3:7])
            worst_pos = max(worst_pos, float(np.abs(vals[:3] - pos).max()))
            worst_quat = max(worst_quat, 1.0 - abs(float(np.dot(axis_angle_to_quat(vals[3:]), q))))
        expect(worst_pos <= 1e-6 and worst_quat <= 1e-6,
               f"real_robot: parsed commands {worst_pos} m, 1 - |q.q'| {worst_quat}")
        crop = env.target_object_world_coords()
        bounds = scene_bounds_from_crop(crop, 0.3).tolist()
        expect(len(ts) == REAL_EPISODE and bool(np.isfinite(crop).all()),
               f"real_robot: {len(ts)} steps, crop {crop}")
    finally:
        if robots is not None:
            robots.close()
        for c in controllers.values():
            c.stop()
    del vlm
    return dict(launches=counts, steps=len(ts), lines={a: len(v) for a, v in got.items()},
                crop=[float(v) for v in crop], crop_radius=float(env.auto_crop_radius()),
                parsed_pos_err=worst_pos, parsed_quat_err=worst_quat), ts, bounds


def write_select_checkpoints(weights_dir, cams, val_obs, act_kw):
    """Three checkpoints of the acting policy's config, written by the port's
    agent: the acting policy's own at 0 and a seed-2 policy's at 100 as .pt,
    a seed-3 policy's at 200 in the JAX format. The held-out actions are the
    seed-3 policy's acts on the card, so step 200 is the one to pick."""
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent

    cfg = act_config(50, which_arm="dominant", arm_pred_loss=True,
                     crop_target_obj_voxel=True, crop_radius=0.3)
    actions = None
    for step, seed in zip(SELECT_STEPS, (0, 2, 3)):
        agent = QAttentionBCAgent(cfg, cams, SCENE_BOUNDS, device=DEVICE, seed=seed)
        agent.build(training=False)
        d = os.path.join(weights_dir, str(step))
        os.makedirs(d)
        if step == SELECT_STEPS[-1]:
            agent.save_weight(os.path.join(d, "QAttentionAgent_layer0.msgpack"))
            actions = [np.asarray(agent.act(0, dict(o), which_arm="right", **act_kw).action)
                       for o in val_obs]
        else:
            agent.save_weights(d)
        del agent
    return actions


def select_checkpoint(acting, ts, bounds, root, stages):
    """(c) ``select_best_checkpoint`` on three checkpoints (one JAX-format)
    and held-out acting transitions of the real-robot episode: the card picks
    the step a CPU run of the port picks from the same files, the CSV has a
    row per step; with two checkpoints' files swapped the pick follows."""
    import csv
    import shutil

    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.ops import cuda as kernels
    from voxactb_tpu_torch.realrobot.robot_env import select_best_checkpoint

    cams = PROTOCOL_CAMERAS
    act_kw = dict(new_scene_bounds=bounds, dominant_assitive_policy=True, deterministic=True)
    val_obs = [t.observation for i, t in enumerate(ts) if i % 2 == 1][:SELECT_VAL]
    weights_dir = os.path.join(root, "weights")
    t0 = time.perf_counter()
    gt = write_select_checkpoints(weights_dir, cams, val_obs, act_kw)
    stages["select_write_s"] = time.perf_counter() - t0
    val = [{"observation": o, "action": a} for o, a in zip(val_obs, gt)]
    csv_path = os.path.join(root, "real_eval.csv")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    best, row = select_best_checkpoint(acting, weights_dir, val, "right", csv_path=csv_path,
                                       **act_kw)
    counts = kernels.launch_counts()
    stages["select_card_s"] = time.perf_counter() - t0
    with open(csv_path, newline="") as f:
        steps = [int(r["step"]) for r in csv.DictReader(f)]
    expect(steps == list(SELECT_STEPS), f"select_checkpoint: CSV steps {steps}")

    t0 = time.perf_counter()
    host = QAttentionBCAgent(acting._cfg, cams, SCENE_BOUNDS, device="cpu", seed=0)
    host.build(training=False)
    best_cpu, row_cpu = select_best_checkpoint(host, weights_dir, val, "right", **act_kw)
    stages["select_cpu_s"] = time.perf_counter() - t0
    expect(best == best_cpu == SELECT_STEPS[-1],
           f"select_checkpoint: the card picked {best}, the CPU {best_cpu}")

    # the planted fault: 100's and 200's files swapped, the pick must follow
    swap = os.path.join(root, "swap")
    for a, b in ((100, 200), (200, 100)):
        shutil.copytree(os.path.join(weights_dir, str(a)), os.path.join(swap, str(b)))
    shutil.copytree(os.path.join(weights_dir, "0"), os.path.join(swap, "0"))
    best_swapped, _ = select_best_checkpoint(acting, swap, val, "right", **act_kw)
    expect(best_swapped == 100, f"select_checkpoint: swapped files, still picked {best_swapped}")
    del host
    return dict(launches=counts, best=best, best_cpu=best_cpu, row=row, row_cpu=row_cpu,
                csv_steps=steps, best_swapped=best_swapped)


def voxposer_robot(details, timings):
    """Phase 14: VoxPoser's prologue and voxposer_only episode on the sim,
    the real-robot episode with its VLM crop, and the offline checkpoint
    selection, at full width (PERACT_BC, depth 6, bf16, the kernel flags)."""
    import shutil

    import torch
    from voxactb_tpu_torch.sim.environment import default_sim_language_encoder

    t_phase = time.perf_counter()
    root = os.path.join(HERE, "build", "voxposer_robot")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    stages = {}
    lang = default_sim_language_encoder()
    acting, stabilizing = voxposer_agents(PROTOCOL_CAMERAS)
    try:
        sim = voxposer_sim(acting, stabilizing, lang, root, stages)
        real, ts, bounds = real_robot(acting, stabilizing, lang, np.random.default_rng(20),
                                      stages)
        select = select_checkpoint(acting, ts, bounds, root, stages)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall_s = time.perf_counter() - t_phase
    timings["voxposer_robot"] = dict(wall_s=wall_s, **stages)
    details["voxposer_robot"] = dict(sim=sim, real_robot=real, select=select)
    k = ("front_fused", "flash_attention", "decoder_head", "sam_attention")
    log(f"[voxposer_robot] prologue {sim['prologue']} planner motions bit-equal to the CPU "
        f"run (a map 1 cm off differs), {sim['policy_steps']} policy steps; voxposer_only "
        f"{sim['voxposer_only_steps']} steps; real robot: crop {np.round(real['crop'], 3).tolist()}"
        f", {real['steps']} steps, controller lines {real['lines']} equal to the actions "
        f"after the extrinsics and the gimbal guard (parsed back within "
        f"{real['parsed_pos_err']:.2g} m); select_best_checkpoint: card {select['best']}, CPU "
        f"{select['best_cpu']}, swapped files {select['best_swapped']}; launches K1/K2/K3/K7: "
        f"sim {[sim['launches'][x] for x in k]}, real {[real['launches'][x] for x in k]}, "
        f"select {[select['launches'][x] for x in k]}; stages "
        + ", ".join(f"{s} {v:.1f}" for s, v in stages.items()) + f"; {wall_s:.1f} s")
    del acting, stabilizing
    torch.cuda.empty_cache()
    return {"voxposer_sim": sim, "real_robot": real, "select_checkpoint": select}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from voxactb_tpu_torch.agents.qfunction import build_encoder
    from voxactb_tpu_torch.ops import cuda as kernels
    from voxactb_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)
    details = {}
    timings = {}

    # phase 1
    card = nvidia_smi_line()
    build_s = build.build_all()
    regs = [line.strip() for log_ in build.BUILD_LOG.values() for line in log_.splitlines()
            if "registers" in line or "spill" in line]
    details["build"] = dict(seconds=build_s, ptxas=regs)
    log(f"[build] {card}; kernels built in {build_s:.1f} s")
    for line in regs:
        log(f"[build] {line}")

    # phase 2 (weights of the act path's own seeded models)
    rng = np.random.default_rng(0)
    split_rng = np.random.default_rng(5)  # K2's split case: a stream of its own
    t0 = time.perf_counter()
    attn = {}
    for n in (50, 100):
        model = build_encoder(act_config(n, which_arm="right"), device=DEVICE, seed=0)
        d0 = check_front(model, n, 1, rng, details)
        if n == 100:
            check_patchify(model, details)
        check_decoder(model, d0, rng, details)
        if n == 50:
            check_decoder(model, d0, rng, details, heads=2)
            check_decoder_ragged(model, details)
        attn[n] = check_attention(1, (n // 5) ** 3, rng, details, split_rng)
        del model, d0
        torch.cuda.empty_cache()
    train_attn = check_attention_train(rng, details)
    check_mask_splits(details)
    # the VLM slice's phases draw from streams of their own, so that the
    # earlier phases keep their inputs
    sam_attn = check_sam_attention(np.random.default_rng(1), details)
    check_sam_block(np.random.default_rng(17), details)
    # K2, K4 and K7 at head dims they are not built for: a stream of its own
    head_dims = check_head_dims(np.random.default_rng(16), details)
    # the dense-grid slice's checks and phases draw from a stream of their own
    dense_rng = np.random.default_rng(3)
    for n in (50, 100):
        model = build_encoder(dense_config(n, which_arm="right"), device=DEVICE, seed=0)
        d0 = check_encoder_stats(model, n, 1, dense_rng, details)
        check_encoder_stats(model, n, 8, dense_rng, details)
        check_decoder_v3(model, d0, dense_rng, details)
        if n == 50:
            check_decoder_v3(model, d0, dense_rng, details, heads=2)
        del model, d0
        torch.cuda.empty_cache()
    check_stats_head(dense_rng, details)
    log(f"[kernels] checks took {time.perf_counter() - t0:.1f} s")

    runs = {}
    t0 = time.perf_counter()
    runs["act100"] = act100(rng, details, timings)
    log(f"[act100] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    runs["dual50"] = dual50(rng, details, timings)
    runs["two_head50"] = two_head50(rng, details)
    log(f"[dual50] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    runs["dense100"] = dense100(dense_rng, details, timings)
    runs["dense100_agent"] = dense_agent_act(dense_rng, details)
    runs["dense_two_head50"] = dense_two_head50(dense_rng, details)
    runs["stats100"] = stats100(dense_rng, details)
    log(f"[dense100] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    runs["vlm_episode"] = vlm_episode(np.random.default_rng(2), details, timings)
    log(f"[vlm_episode] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    runs["train50"] = train50(rng, details, timings)
    log(f"[train50] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    runs["round5_act"], runs["round5_train"] = round5(np.random.default_rng(17), details)
    log(f"[round5] took {time.perf_counter() - t0:.1f} s")
    # the tools' phase draws from streams of its own (numpy seed 12, card
    # generator seeds 110-120, the tools' own seeds)
    t0 = time.perf_counter()
    runs["tools"], tool_rows = tools(details)
    log(f"[tools] took {time.perf_counter() - t0:.1f} s")
    runs["protocol_train"], runs["protocol_eval"] = protocol(details, timings)
    t0 = time.perf_counter()
    runs["disk_replay"] = disk_replay(timings)
    runs["protocol_tool_train"], runs["protocol_tool_eval"], acting_dir = protocol_tool(timings)
    log(f"[protocol_eval] took {time.perf_counter() - t0:.1f} s")
    runs["diagnose"] = diagnose(acting_dir, details, timings)
    # the weights phase draws from streams of its own (card generator seed
    # 130, numpy seed 18)
    runs["weights"] = weights(details, timings)
    # the baseline zoo (numpy seed 19) and the VoxPoser / real-robot phase
    # (numpy seed 20, sim seeds 21-22, VLM weights from card seed 22)
    runs["baselines"] = baselines(details, timings)
    runs.update(voxposer_robot(details, timings))
    # the train step split over two ranks on the card (numpy seed 21,
    # generator seed 5), then the remaining probes on their own seeds
    t0 = time.perf_counter()
    runs["parallel"] = parallel(details, timings)
    log(f"[parallel] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    runs["probes_b"] = probes_b(details, timings)
    log(f"[probes_b] took {time.perf_counter() - t0:.1f} s")

    # phase 13: every kernel was launched on the main path that runs it
    act_kernels = ("front_fused", "flash_attention", "decoder_head", "decoder_tail_conv",
                   "decoder_tail_trans_stats", "front_patchify")
    dense_kernels = ("encoder_stats", "stats_head", "decoder_head_v3", "flash_attention",
                     "decoder_tail_conv", "decoder_tail_trans_stats", "decoder_phase_gemm",
                     "front_patchify")
    path_kernels = {"train50": ("flash_attention_train_fwd", "flash_attention_train_bwd"),
                    "round5_act": ("front_fused", "front_patchify", "flash_attention"),
                    "round5_train": ("flash_attention_train_fwd", "flash_attention_train_bwd"),
                    "vlm_episode": act_kernels + ("sam_attention",),
                    "dense100": dense_kernels, "dense100_agent": dense_kernels,
                    "dense_two_head50": dense_kernels,
                    "stats100": ("stats_head", "flash_attention"),
                    "protocol_train": ("flash_attention_train_fwd",
                                       "flash_attention_train_bwd"),
                    "disk_replay": ("flash_attention_train_fwd", "flash_attention_train_bwd"),
                    "protocol_tool_train": ("flash_attention_train_fwd",
                                            "flash_attention_train_bwd"),
                    "diagnose": act_kernels + ("flash_attention_train_fwd",
                                               "flash_attention_train_bwd", "sam_attention"),
                    "weights": act_kernels + ("flash_attention_train_fwd",
                                              "flash_attention_train_bwd", "sam_attention"),
                    # plain PyTorch by design: its own check holds every count at 0
                    "baselines": (),
                    "parallel": ("flash_attention_train_fwd", "flash_attention_train_bwd"),
                    "probes_b": tuple(sorted({k for _, _, _, want in PROBES_B for k in want}
                                             | {k for _, _, want in PROFILERS_B
                                                for k in want})),
                    "real_robot": act_kernels + ("sam_attention",),
                    "tools": TOOLS_KERNELS + ("front_fused", "front_patchify", "decoder_head",
                                              "decoder_tail_conv", "decoder_tail_trans_stats",
                                              "flash_attention")}
    total = {k: 0 for k in kernels.LAUNCHES}
    for name, run in runs.items():
        for k in path_kernels.get(name, act_kernels):
            v = run["launches"][k]
            total[k] += v
            expect(v > 0, f"kernel {k} was not launched on the main path {name}")
    f100 = details["front_fused"][-1]
    row_of = lambda key, shape: next(r for r in details[key] if r["shape"] == shape)  # noqa: E731
    d100 = row_of("decoder_head", "N=100 B=1 T=1")
    v100 = row_of("decoder_head_v3", "N=100 B=1 T=1")
    a100 = attn[100]  # B = 1: one cross, six self, one decoder attention per act
    per_act = lambda key: (a100["cross"][key] + 6 * a100["self"][key]
                           + a100["decoder"][key])
    # batch 8 at 50^3: one cross, six self, one decoder attention per train step
    per_step = lambda key: sum(n * train_attn[s][key]  # noqa: E731
                               for s, n in TRAIN_STEP_ATTENTIONS.items())
    # one VLM pass of ViT-H: its global and its windowed launches
    sam_blocks = {"global": len(VLM_TOWERS["sam"]["global_attn_indexes"])}
    sam_blocks["windowed"] = VLM_TOWERS["sam"]["depth"] - sam_blocks["global"]
    per_pass = lambda key: sum(n * sam_attn[s][key] for s, n in sam_blocks.items())
    sam_by = {by: sum(n * sam_attn[s]["bound_ms"] for s, n in sam_blocks.items()
                      if sam_attn[s]["bound_by"] == by) for by in ("bytes", "operations")}
    # the dense-grid kernels at the shapes of one dense100 act at batch 1
    largest_err = lambda key: max(e["max_abs_err"] for r in details[key]  # noqa: E731
                                  for e in r["errs"].values())
    dense_rows = (("encoder_stats", "N=100 B=1", "encoder_stats.py:59"),
                  ("stats_head", "[1,20^3,128] bfloat16", "stats_head.py:115"),
                  ("decoder_head_v3", "N=100 B=1 T=1", "decoder_head_v3.py:81"))
    p100 = row_of("front_patchify", "N=100 B=1")
    e100 = row_of("encoder_stats", "N=100 B=1")
    kernels_line = {"kernels": [
        # K1 at 100^3 batch 1: the wrapper call, and each launch's device
        # time beside its bound
        dict(name="front_fused", route="cuda",
             source="voxactb_tpu_torch/csrc/front_fused.cu",
             replaces="voxactb_tpu/ops/pallas/front_fused.py:303",
             launches=total["front_fused"], max_abs_err=max(
                 r["max_abs_err"] for r in details["front_fused"]),
             ms=f100["ms"], plain_ms=f100["plain_ms"], bound_ms=f100["bound_ms"],
             bound_by=f100["bound_by"], library_ms=None, device_ms=f100["device_ms"],
             launch_device_ms=f100["launch_device_ms"],
             launch_bound_ms=f100["launch_bound_ms"],
             launch_bound_by=f100["launch_bound_by"]),
        # the k5/s5 patchify inside K1 and on the dense path, alone at 100^3
        # batch 1: the wrapper call beside cuDNN's bf16 conv of the pre-padded
        # d0, and the device time of each
        dict(name="front_patchify", route="cuda",
             source="voxactb_tpu_torch/csrc/front_patchify.cuh",
             replaces="voxactb_tpu/ops/pallas/front_fused.py:303",
             launches=total["front_patchify"],
             max_abs_err=max(r["max_abs_err"] for r in details["front_patchify"]),
             ms=p100["ms"], plain_ms=p100["plain_ms"], bound_ms=p100["bound_ms"],
             bound_by=p100["bound_by"], library_ms=p100["library_ms"],
             device_ms=p100["device_ms"], library_device_ms=p100["library_device_ms"],
             launch_device_ms=p100["launch_device_ms"]),
        dict(name="flash_attention", route="cuda",
             source="voxactb_tpu_torch/csrc/flash_attention.cu",
             replaces="voxactb_tpu/ops/pallas/flash_attention.py:61",
             launches=total["flash_attention"], max_abs_err=max(
                 case["max_abs_err"] for r in details["flash_attention"]
                 for case in r.values() if isinstance(case, dict)),
             ms=per_act("ms"), device_ms=per_act("device_ms"), plain_ms=per_act("plain_ms"),
             bound_ms=per_act("bound_ms"), bound_by="operations",
             library_ms=per_act("library_ms")),
        dict(name="decoder_head", route="cuda",
             source="voxactb_tpu_torch/csrc/decoder_head.cu",
             replaces="voxactb_tpu/ops/pallas/decoder_head_v2.py:40",
             launches=total["decoder_head"], max_abs_err=max(
                 r["max_abs_err"] for r in details["decoder_head"]),
             ms=d100["ms"], plain_ms=d100["plain_ms"], bound_ms=d100["bound_ms"],
             bound_by=d100["bound_by"], library_ms=None),
        # the tail's u conv inside K3 and K8, device time at 100^3 batch 1
        dict(name="decoder_tail_conv", route="cuda",
             source="voxactb_tpu_torch/csrc/tail_conv.cuh",
             replaces="voxactb_tpu/ops/pallas/decoder_head_v2.py:40",
             launches=total["decoder_tail_conv"], max_abs_err=max(
                 r["u_err"] for key in ("decoder_head", "decoder_head_two_heads")
                 for r in details[key]),
             ms=d100["conv_device_ms"], plain_ms=d100["conv_plain_ms"],
             bound_ms=d100["conv_bound_ms"], bound_by=d100["conv_bound_by"],
             library_ms=d100["conv_library_ms"]),
        # the tail's trans/stats pass inside K3 and K8 (its combine apart),
        # device time at 100^3 batch 1
        dict(name="decoder_tail_trans_stats", route="cuda",
             source="voxactb_tpu_torch/csrc/decoder_tail.cuh",
             replaces="voxactb_tpu/ops/pallas/decoder_head_v2.py:40",
             launches=total["decoder_tail_trans_stats"], max_abs_err=max(
                 r["trans_stats_err"] for key in ("decoder_head", "decoder_head_two_heads")
                 for r in details[key]),
             ms=d100["trans_stats_device_ms"], plain_ms=d100["trans_stats_plain_ms"],
             bound_ms=d100["trans_stats_bound_ms"], bound_by=d100["trans_stats_bound_by"],
             library_ms=d100["trans_stats_library_ms"]),
        # K8's phase GEMM, device time at 100^3 batch 1
        dict(name="decoder_phase_gemm", route="cuda",
             source="voxactb_tpu_torch/csrc/phase_gemm.cuh",
             replaces="voxactb_tpu/ops/pallas/decoder_head_v3.py:81",
             launches=total["decoder_phase_gemm"],
             max_abs_err=max(r["u0_err"] for r in details["decoder_head_v3"]),
             ms=v100["device_ms"]["phase_gemm"], plain_ms=v100["phase_gemm_plain_ms"],
             bound_ms=v100["phase_gemm_bound_ms"], bound_by=v100["phase_gemm_bound_by"],
             library_ms=v100["phase_gemm_library_ms"]),
        dict(name="flash_attention_train_fwd", route="cuda",
             source="voxactb_tpu_torch/csrc/flash_attention_train.cu",
             replaces="voxactb_tpu/ops/pallas/flash_attention.py:140",
             launches=total["flash_attention_train_fwd"], max_abs_err=max(
                 r[f"dropout_{d}"]["out"]["max_abs_err"] for r in train_attn.values()
                 for d in (0.0, 0.1)),
             ms=per_step("fwd_ms"), plain_ms=per_step("plain_fwd_ms"),
             bound_ms=per_step("fwd_bound_ms"), bound_by="operations",
             library_ms=per_step("library_fwd_ms")),
        dict(name="flash_attention_train_bwd", route="cuda",
             source="voxactb_tpu_torch/csrc/flash_attention_train.cu",
             replaces="voxactb_tpu/ops/pallas/flash_attention.py:164",
             launches=total["flash_attention_train_bwd"], max_abs_err=max(
                 r[f"dropout_{d}"][g]["max_abs_err"] for r in train_attn.values()
                 for d in (0.0, 0.1) for g in ("dq", "dk", "dv")),
             ms=per_step("bwd_ms"), plain_ms=per_step("plain_bwd_ms"),
             bound_ms=per_step("bwd_bound_ms"), bound_by="operations",
             library_ms=per_step("library_bwd_ms")),
        dict(name="sam_attention", route="cuda",
             source="voxactb_tpu_torch/csrc/sam_attention.cu",
             replaces="voxactb_tpu/ops/pallas/sam_attention.py:67",
             launches=total["sam_attention"],
             max_abs_err=max(r["max_abs_err"] for r in sam_attn.values()),
             ms=per_pass("ms"), device_ms=per_pass("device_ms"), plain_ms=per_pass("plain_ms"),
             bound_ms=per_pass("bound_ms"),
             bound_by=max(sam_by, key=sam_by.get), library_ms=per_pass("library_ms")),
    ] + [dict(name=key, route="cuda", source=f"voxactb_tpu_torch/csrc/{key}.cu",
              replaces=f"voxactb_tpu/ops/pallas/{where}", launches=total[key],
              max_abs_err=largest_err(key), ms=row_of(key, shape)["ms"],
              plain_ms=row_of(key, shape)["plain_ms"], bound_ms=row_of(key, shape)["bound_ms"],
              bound_by=row_of(key, shape)["bound_by"], library_ms=None)
         for key, shape, where in dense_rows] + [
        # the tools' probes: P1 at d0's shape, batch 1, one row per slab; P2 at
        # the opt-in limit; P3 at the JAX probe's shapes
        dict(name=key, route="cuda", source="voxactb_tpu_torch/csrc/probes.cu",
             replaces=where, launches=total[key],
             max_abs_err=max(r["max_abs_err"] for r in details[key]),
             **{k: tool_rows[key][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms", "device_ms",
                                                "library_device_ms")})
        for key, where in (("grid_copy", "tools/profile_stages.py:211"),
                           ("smem_scratch", "tools/probe_vmem.py:13"),
                           ("shifted_window", "tools/probe_vmem.py:36"))]}
    # K2, K4 and K7 at the head dims their wrappers pad (device ms per call)
    for name, key, rows_ in (("flash_attention", "device_ms", head_dims["flash_attention"]),
                             ("flash_attention_train_fwd", "fwd_device_ms",
                              head_dims["flash_attention_train"]),
                             ("flash_attention_train_bwd", "bwd_device_ms",
                              head_dims["flash_attention_train"]),
                             ("sam_attention", "device_ms", head_dims["sam_attention"])):
        next(k for k in kernels_line["kernels"] if k["name"] == name)["head_dim_device_ms"] = {
            case: row[key] for case, row in rows_.items()}
    # K5's launches (the voxel pass, its combine) beside their bounds
    k5 = next(k for k in kernels_line["kernels"] if k["name"] == "encoder_stats")
    k5.update(device_ms=e100["device_ms"], launch_device_ms=e100["launch_device_ms"],
              launch_bound_ms=e100["launch_bound_ms"], launch_bound_by=e100["launch_bound_by"])
    # P2 beside the floor of its launch
    next(k for k in kernels_line["kernels"] if k["name"] == "smem_scratch").update(
        launch_floor_device_ms=tool_rows["smem_scratch"]["launch_floor_device_ms"])
    # K6's one launch on the decoder grid, and torch.amax of it (less work)
    k6 = next(k for k in kernels_line["kernels"] if k["name"] == "stats_head")
    s20 = row_of("stats_head", "[1,20^3,128] bfloat16")
    k6.update({key: s20[key] for key in ("device_ms", "launch_device_ms", "launch_bound_ms",
                                         "launch_bound_by", "amax_ms", "amax_device_ms")})
    details["timings"] = timings
    details["runs"] = runs
    details["card"] = card
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)
    log(f"[total] {time.perf_counter() - T_START:.1f} s of command time")
    log(json.dumps(kernels_line))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
