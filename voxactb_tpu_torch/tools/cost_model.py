"""Analytic FLOPs / HBM-bytes model of the act program (voxelize + Q-forward),
of the BC train step and of the SAM ViT-H image encoder, at an NVIDIA H100's
peaks.

A copy of ``tools/cost_model.py`` (the port imports nothing of the JAX
package's tree): the formulas are the same, and the tests hold them equal.
Per-stage FLOPs and the MINIMAL HBM traffic (every tensor written once, read
once by its consumers — the speed-of-light for a perfectly fused program),
from which

    sol_ms     = max(flops / peak_flops, bytes / hbm_bw)
    mfu_pct    = flops / (measured_s * peak_flops)
    hbm_util   = bytes / (measured_s * hbm_bw)

``speed_of_light`` defaults to the H100 SXM's data-sheet peaks (989 TFLOP/s
dense bf16, 3.35 TB/s HBM3; 67 TFLOP/s float32 outside the tensor cores).
Shapes follow ``models/perceiver.py``'s shape walk at the canonical N=100 /
patch-5 / latents-2048x512 operating point.

``fused_front=True`` counts the *TPU* front kernel's patchify, whose wide-dot
schedule does 5x the minimal patchify MACs; the port's K1 patchify
(``csrc/front_patchify.cuh``) does the minimal ones, so on the card that
stage's FLOPs are an over-count (``fused_front=False`` counts the minimal).
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
H100_PEAK_BF16_FLOPS = 989e12   # bf16 on the tensor cores
H100_PEAK_F32_FLOPS = 67e12     # float32 outside the tensor cores
H100_HBM_BW = 3.35e12           # bytes/s, HBM3


def act_cost(n: int = 100, batch: int = 1, img: int = 128, cams: int = 2,
             im_ch: int = 64, latents: int = 2048, latent_dim: int = 512,
             depth: int = 6, patch: int = 5, lang_len: int = 77,
             input_dim: int = 10, heads_t: int = 1,
             fused_decoder: bool = False,
             fused_front: bool = False, row_cap: int = 2048) -> Dict[str, float]:
    """Per-act FLOPs and minimal HBM bytes of the inference program."""
    s = n // patch                      # patch grid (20)
    seq = lang_len + s ** 3             # 8077
    dim = 2 * im_ch                     # 128 (voxel + proprio stream)
    p = cams * img * img                # points per sample
    bf2, f4 = 2, 4                      # bf16 / f32 widths

    fl: Dict[str, float] = {}
    by: Dict[str, float] = {}

    if fused_front:
        # ops/pallas/front_fused.py: sort+gather pre-pass on [P]-sized tensors,
        # one kernel pass writing d0 once; the dense grid never exists. The
        # patchify wide-dot schedule does 5x the minimal patchify MACs.
        by["front"] = (p * 6 * f4                      # coords+rgb in
                       + p * 8 * f4 * 2                # sort + payload build
                       + 2 * n * row_cap * 8 * f4      # row gather write + read
                       + n ** 3 * im_ch * bf2          # d0 write (once)
                       + s ** 3 * im_ch * f4)          # patch tokens out
        fl["front"] = (p * 30 + 2 * n ** 3 * input_dim * im_ch
                       + 6 * n ** 3 * im_ch
                       + 5 * 2 * s ** 3 * patch ** 3 * im_ch * im_ch)
    else:
        # voxelize: scatter-add of [P, 8] + grid emit (bandwidth only)
        by["voxelize"] = (p * 6 * f4                   # coords+rgb in
                          + (n + 2) ** 3 * 8 * f4 * 2  # scatter grid init+read
                          + n ** 3 * input_dim * f4)   # output grid
        fl["voxelize"] = p * 30

        # 1x1x1 preprocess -> d0 [N^3, 64]
        fl["preprocess"] = 2 * n ** 3 * input_dim * im_ch
        by["preprocess"] = n ** 3 * input_dim * f4 + n ** 3 * im_ch * bf2

        # stats(d0): two passes (max, exp-weighted sums)
        fl["stats_d0"] = 6 * n ** 3 * im_ch
        by["stats_d0"] = 2 * n ** 3 * im_ch * bf2

        # patchify conv k5 s5 (+ proprio/lang preprocess, negligible)
        fl["patchify"] = 2 * s ** 3 * patch ** 3 * im_ch * im_ch
        by["patchify"] = n ** 3 * im_ch * bf2 + s ** 3 * im_ch * bf2

    # perceiver trunk: cross-attn (1 head, dim->latent), depth self-attn + GEGLU FF,
    # decoder cross-attn back to the sequence
    d_lat, d_in = latent_dim, dim
    cross = (2 * latents * d_lat * 64 + 2 * seq * d_in * 128
             + 2 * latents * seq * 64 * 2 + 2 * latents * 64 * d_lat)
    ff = 2 * latents * d_lat * (4 * d_lat) * 2 + 2 * latents * (4 * d_lat // 2) * d_lat
    self_attn = (2 * latents * d_lat * (3 * d_lat)
                 + 2 * latents * latents * d_lat * 2
                 + 2 * latents * d_lat * d_lat)
    dec = (2 * seq * d_in * 64 + 2 * latents * d_lat * 128
           + 2 * seq * latents * 64 * 2 + 2 * seq * 64 * d_in)
    fl["attention"] = cross + ff + depth * (self_attn + ff) + dec
    # activations stream once; weights are accounted separately (read ONCE per
    # step regardless of batch — batched matmuls share the weight fetch)
    attn_params = depth * (4 * d_lat * d_lat + 3 * d_lat * 4 * d_lat) \
        + 2 * latents * d_lat
    weight_bytes = attn_params * bf2
    by["attention"] = 4 * seq * d_in * bf2 \
        + 2 * latents * d_lat * bf2 * depth

    # decoder upsample: conv_in k5 @20^3 + phase-composed k3 -> 125*64 channels
    fl["upsample"] = (2 * s ** 3 * patch ** 3 * dim * im_ch
                      + 2 * s ** 3 * 27 * im_ch * (patch ** 3 * im_ch))
    by["upsample"] = s ** 3 * dim * bf2 + n ** 3 * im_ch * bf2

    # final conv k3 (cat 128 -> 64) + lrelu
    fl["final_conv"] = 2 * n ** 3 * 27 * (2 * im_ch) * im_ch
    # trans decoder(s) k3 64 -> 1
    fl["trans"] = heads_t * 2 * n ** 3 * 27 * im_ch
    # stats(u)
    fl["stats_u"] = 6 * n ** 3 * im_ch

    if fused_decoder:
        # pallas decoder_head: reads d0+u0 once, writes trans + stats only
        by["decoder_tail"] = (2 * n ** 3 * im_ch * bf2
                              + heads_t * n ** 3 * f4)
    else:
        # XLA chain: cat materialized + read, u materialized + read by trans/stats
        by["decoder_tail"] = (2 * n ** 3 * im_ch * bf2 * 2     # cat w+r
                              + n ** 3 * im_ch * bf2 * 3       # u w + 2 consumers
                              + heads_t * n ** 3 * f4)

    total_fl = float(sum(fl.values())) * batch
    act_by = float(sum(by.values())) * batch
    return {
        "flops": total_fl,
        "bytes": act_by + weight_bytes,
        "activation_bytes": act_by,
        "weight_bytes": float(weight_bytes),
        # per-stage numbers are per STEP at this batch (activation traffic
        # scales with batch; the shared weight fetch stays in weight_bytes)
        "flops_by_stage": {k: v * batch for k, v in fl.items()},
        "bytes_by_stage": {k: v * batch for k, v in by.items()},
    }


def train_cost(n: int = 50, batch: int = 8, param_count: float = 35.7e6,
               remat: bool = False, **kw) -> Dict[str, float]:
    """Per-step fwd+bwd+LAMB FLOPs and minimal HBM bytes of the BC train program.

    The forward reuses :func:`act_cost`'s stage model (training runs the
    differentiable XLA ops, so ``fused_decoder=False``). Backward of a matmul/conv
    costs ~2x its forward FLOPs (dX and dW passes); elementwise/stats stages
    backprop at ~1x. Memory: the forward writes each activation once and the
    backward re-reads it and writes/reads a same-sized gradient (3x activation
    traffic; with remat the fwd tensors are recomputed instead: +1x fwd FLOPs,
    2x activation traffic). Parameter-side traffic per step (dominant at small
    grids): bf16 params read in fwd AND in bwd (2+2 B), f32 grads written+read
    (8 B), LAMB moments m,v read+written (16 B), f32 master params read+written
    (8 B) and the trust-ratio norm pass (~2 B) -> ~38 B/param.
    """
    fwd = act_cost(n=n, batch=batch, fused_decoder=False, **kw)
    matmul_frac = 0.9  # share of fwd FLOPs in conv/matmul stages (heads are tiny)
    bwd_flops = fwd["flops"] * (2.0 * matmul_frac + 1.0 * (1 - matmul_frac))
    flops = fwd["flops"] + bwd_flops + (fwd["flops"] if remat else 0.0)
    # activation traffic only — parameter reads are inside param_traffic below
    act_traffic = fwd["activation_bytes"] * (2.0 if remat else 3.0)
    param_traffic = param_count * 38.0
    return {
        "flops": float(flops),
        "bytes": float(act_traffic + param_traffic),
        "fwd_flops": float(fwd["flops"]),
        "param_bytes": float(param_traffic),
        "activation_bytes": float(act_traffic),
    }


def sam_encoder_cost(img: int = 1024, patch: int = 16, dim: int = 1280,
                     depth: int = 32, heads: int = 16, window: int = 14,
                     n_global: int = 4, mlp_ratio: float = 4.0,
                     neck_ch: int = 256) -> Dict[str, float]:
    """Per-frame FLOPs and minimal HBM bytes of the SAM ViT-H image encoder at
    1024^2 (models/sam_encoder.py; the reference loads sam_vit_h, vlm.py:109-117).

    FLOPs per transformer block on T tokens: qkv (2*T*d*3d) + attention
    (2*T*L*d per sim + per weighted-sum, L = window^2 for the 28 windowed
    blocks after 14x14 padding of the 64x64 token grid to 70x70, L = T for the
    4 global blocks) + proj (2*T*d*d) + MLP (2*T*d*4d*2). Bytes: every block
    streams its activations (read + write residual) and reads its weights once
    — the weight read (632M params * 2B = 1.26 GB) dominates at batch 1, which
    is why the encoder is bandwidth-bound even on physical HBM."""
    t = (img // patch) ** 2                      # 4096 tokens
    tw = ((img // patch + window - 1) // window * window) ** 2  # padded 70^2
    fl: Dict[str, float] = {}
    qkv_proj = 2 * t * dim * 3 * dim + 2 * t * dim * dim
    mlp = 2 * t * dim * int(mlp_ratio * dim) * 2
    attn_win = 2 * tw * window * window * dim * 2    # sim + weighted sum
    attn_glob = 2 * t * t * dim * 2
    n_win = depth - n_global
    fl["patch_embed"] = 2 * t * patch * patch * 3 * dim
    fl["qkv_proj"] = depth * qkv_proj
    fl["attention"] = n_win * attn_win + n_global * attn_glob
    fl["mlp"] = depth * mlp
    fl["neck"] = 2 * t * dim * neck_ch + 2 * t * 9 * neck_ch * neck_ch

    params = (patch * patch * 3 * dim                     # patch embed
              + depth * (4 * dim * dim + 2 * dim * int(mlp_ratio * dim))
              + dim * neck_ch + 9 * neck_ch * neck_ch)
    bf2 = 2
    weight_bytes = params * bf2
    # activations: each block reads x and writes the residual sum (the qkv/attn
    # intermediates stay on-chip in a fused schedule); neck + patch embed once
    act_bytes = (t * 3 * patch * patch * 4          # input image
                 + depth * 2 * t * dim * bf2
                 + 2 * t * neck_ch * bf2)
    return {
        "flops": float(sum(fl.values())),
        "bytes": float(act_bytes + weight_bytes),
        "activation_bytes": float(act_bytes),
        "weight_bytes": float(weight_bytes),
        "param_count": float(params),
        "flops_by_stage": fl,
    }


def speed_of_light(cost: Dict[str, float], peak_flops: float = H100_PEAK_BF16_FLOPS,
                   hbm_bw: float = H100_HBM_BW) -> Dict[str, float]:
    t_flops = cost["flops"] / peak_flops
    t_bytes = cost["bytes"] / hbm_bw
    return {
        "sol_ms": max(t_flops, t_bytes) * 1e3,
        "compute_ms": t_flops * 1e3,
        "memory_ms": t_bytes * 1e3,
        "bound": "compute" if t_flops > t_bytes else "memory",
    }


if __name__ == "__main__":
    import json

    c = act_cost()
    print(json.dumps({
        "flops_g": round(c["flops"] / 1e9, 1),
        "hbm_mb": round(c["bytes"] / 1e6, 1),
        "sol_h100": speed_of_light(c),
        "stage_gflops": {k: round(v / 1e9, 1) for k, v in
                         c["flops_by_stage"].items()},
        "stage_mb": {k: round(v / 1e6, 1) for k, v in
                     c["bytes_by_stage"].items()},
    }, indent=1))
