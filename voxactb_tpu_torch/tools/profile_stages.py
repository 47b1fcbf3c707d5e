"""Standalone-op latency profile of the act program's building blocks on the
card (counterpart of ``tools/profile_stages.py``).

Times each hot op in isolation at the canonical 100^3 / bf16 operating point,
plus alternative formulations of the convolutions: a chain of ``n_chain``
steps, each reading a fresh input slice and reducing its outputs to an f32
sum (the JAX tool's ``lax.scan``), between two CUDA events, median of 3
chains after a first, warming one. Inputs are synthesized on the device from
seeded ``torch.Generator``s; weights and points come from the JAX tool's numpy
stream (``default_rng(0)``, the same draws in the same order).

    python3 -m voxactb_tpu_torch.tools.profile_stages [--batch 8] [--only NAME ...]

Prints the device, then ``{"stage", "per_step_ms", "compile_s"}`` per stage
(``compile_s``: host seconds of the warming chain, kernel builds, library
plans and allocations included), then ``{"batch", "all"}``. ``--batch B``
profiles every stage at batch B. Each JAX stage has its counterpart here
(``STAGES``), but for the TPU front kernel's scatter-schedule variants
(``NO_COUNTERPART``).
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from voxactb_tpu_torch.device import resolve_device
from voxactb_tpu_torch.models.blocks import (
    conv3d_f32acc, spatial_softmax_3d, to_ncdhw, to_ndhwc)
from voxactb_tpu_torch.models.perceiver import FeedForward, PreNormAttention
from voxactb_tpu_torch.ops.cuda.decoder_head import decoder_head
from voxactb_tpu_torch.ops.cuda.front_fused import front_fused
from voxactb_tpu_torch.ops.cuda.probes import grid_copy
from voxactb_tpu_torch.ops.upsample_conv import upsample_conv
from voxactb_tpu_torch.ops.voxelize import voxelize
from voxactb_tpu_torch.tools import chain, device_line, device_normal, emit, seconds, warm_seconds

N_CHAIN = 16
N = 100
S = 20  # patch grid
POINTS = 32768  # 2 cameras x 128^2

# JAX stage name -> what runs it on the card
STAGES = {
    "front_fused@100": "K1 ops/cuda/front_fused.front_fused",
    "decoder_v2_tail@100": "K3 ops/cuda/decoder_head.decoder_head",
    "decoder_v2c_tail@100": "K3 ops/cuda/decoder_head.decoder_head (v2c is the same "
                            "function on another TPU schedule)",
    "grid_copy_1row@100": "P1 ops/cuda/probes.grid_copy, 1 row per slab",
    "grid_copy_4row@100": "P1 ops/cuda/probes.grid_copy, 4 rows per slab",
    "voxelize_32k->100^3": "ops/voxelize.voxelize",
    "d0_consumers_separate@100": "models/blocks.spatial_softmax_3d + amax + the k5/s5 conv",
    "conv1x1_10->64@100": "conv3d_f32acc, k1",
    "patchify_k5s5@100": "conv3d_f32acc, k5 s5",
    "patchify_s2d_matmul@100": "space-to-depth + torch.matmul (bf16, f32 accumulation)",
    "ss0_softmax64@100": "models/blocks.spatial_softmax_3d",
    "globalmax@100": "amax over the grid",
    "final_k3_conv3d@100": "conv3d_f32acc, k3 128->64",
    "final_k3_as_2d@100": "three depth-shifted k3 2D convs (conv3d_f32acc, depth 1)",
    "trans_k3_64->1@100": "conv3d_f32acc, k3 64->1",
    "fused_upsample20->100": "ops/upsample_conv.upsample_conv",
    "attention_trunk": "the simplified trunk in torch.matmul",
    "real_attn_trunk": "models/perceiver PreNormAttention + FeedForward, flash=False",
    "real_attn_trunk_flash": "models/perceiver PreNormAttention + FeedForward, flash=True (K2)",
}

_NO_SCATTER = ("K1 scatters every point with atomics: it has no serial per-row "
               "scatter and drops no point, so the TPU kernel's scatter-schedule "
               "knob `{}` has no counterpart")
NO_COUNTERPART = {
    "front_fused_cap64@100": _NO_SCATTER.format("row_cap"),
    "front_fused_unroll8@100": _NO_SCATTER.format("scatter_unroll"),
    "front_fused_matmul@100": _NO_SCATTER.format("scatter_matmul"),
}

BF = torch.bfloat16


def conv3d(x, k, stride=1):
    """XLA's "SAME" conv of channels-last ``x`` with DHWIO ``k``: bf16
    operands, f32 accumulation (``conv3d_f32acc``), rounded to bf16."""
    ks, n = k.shape[0], x.shape[1]
    pad = max((-(-n // stride) - 1) * stride + ks - n, 0)
    xp = F.pad(to_ncdhw(x), (pad // 2, pad - pad // 2) * 3)
    return to_ndhwc(conv3d_f32acc(xp, k.permute(4, 3, 0, 1, 2), stride)).to(BF)


def conv3d_as_2d_zshift(x, k, mode="constant"):
    """k3 conv3d as 3 depth-shifted 2D convs, f32 sums, rounded once: each
    is ``conv3d_f32acc`` with a kernel of depth 1 (D folded into the batch).
    ``mode="constant"`` zero-pads as "SAME", ``"replicate"`` edge-pads."""
    d = x.shape[1]
    xp = F.pad(to_ncdhw(x), (1,) * 6, mode=mode)
    acc = None
    for dz in range(3):
        y = conv3d_f32acc(xp[:, :, dz:dz + d], k[dz:dz + 1].permute(4, 3, 0, 1, 2), 1)
        acc = y if acc is None else acc + y
    return to_ndhwc(acc).to(BF)


def patchify_s2d(x, k):
    """The k5/s5 patchify as space-to-depth + one matmul."""
    ksz = k.shape[0]
    b, n, cin = x.shape[0], x.shape[1], x.shape[-1]
    sgrid, pad = n // ksz, ksz // 2
    xp = to_ndhwc(F.pad(to_ncdhw(x), (pad, 0) * 3, mode="replicate"))[:, :n, :n, :n]
    xp = xp.reshape(b, sgrid, ksz, sgrid, ksz, sgrid, ksz, cin)
    xp = xp.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, sgrid ** 3, ksz ** 3 * cin)
    return torch.matmul(xp, k.reshape(ksz ** 3 * cin, k.shape[-1]))


class RealTrunk(nn.Module):
    """The real trunk at the canonical dims: 1-head cross attention into 2048
    latents, 6 x (8-head self attention + GEGLU FF), 1-head decoder cross
    attention back to the sequence (``models/perceiver.py``'s modules)."""

    def __init__(self, flash: bool, generator: torch.Generator):
        super().__init__()
        g = generator
        self.latents = nn.Parameter(torch.randn(2048, 512, generator=g))
        self.cross = PreNormAttention(512, 128, 1, 64, 512, norm_context=True,
                                      flash=flash, dtype=BF, generator=g)
        self.cross_ff = FeedForward(512, dtype=BF, generator=g)
        self.sa = nn.ModuleList(PreNormAttention(512, 512, 8, 64, 512, flash=flash,
                                                 dtype=BF, generator=g) for _ in range(6))
        self.ff = nn.ModuleList(FeedForward(512, dtype=BF, generator=g) for _ in range(6))
        self.dec = PreNormAttention(128, 512, 1, 64, 128, norm_context=True, flash=flash,
                                    dtype=BF, generator=g)

    def forward(self, seq):
        x = self.latents[None].to(BF).expand(seq.shape[0], -1, -1)
        x = self.cross(x, seq) + x
        x = self.cross_ff(x) + x
        for sa, ff in zip(self.sa, self.ff):
            x = sa(x) + x
            x = ff(x) + x
        return self.dec(seq, x)


def main(batch: int = 1, only=None, *, device=None, n: int = N, n_chain=None):
    """Profile every stage (or those whose name holds a string of ``only``) at
    ``batch``; ``n`` (the grid, 100) and ``n_chain`` (by the JAX tool's rule)
    are there to run it small. Returns ``{stage: per_step_ms}``."""
    dev = resolve_device(device)
    s = n // 5
    emit(device_line(dev))
    # the big grid tensors scale with batch (d0 at batch 8 is 1 GB per chain
    # step): the chain is shortened so the largest stage input (cat128, 2x d0)
    # stays under ~4 GB, as in the JAX tool
    if n_chain is None:
        n_chain = max(2, min(N_CHAIN, int(4e9 / (batch * n ** 3 * 128 * 2))))
        if n_chain != N_CHAIN:
            emit({"note": f"chain shortened to {n_chain} at batch {batch} to fit HBM"})
    wanted = lambda name: not only or any(o in name for o in only)  # noqa: E731

    rng = np.random.default_rng(0)

    def host(shape, scale=1.0, dtype=BF):
        return torch.tensor(rng.normal(size=shape).astype(np.float32) * scale).to(dev, dtype)

    grid10 = device_normal((n_chain, batch, n, n, n, 10), 0, dev)
    d0 = device_normal((n_chain, batch, n, n, n, 64), 1, dev)
    cat128 = device_normal((n_chain, batch, n, n, n, 128), 2, dev)
    small = device_normal((n_chain, batch, s, s, s, 128), 3, dev)
    seq = device_normal((n_chain, batch, 77 + s ** 3, 128), 4, dev)

    k1 = host((1, 1, 1, 10, 64), .1)
    k5s5 = host((5, 5, 5, 64, 64), .1)
    k3 = host((3, 3, 3, 128, 64), .1)
    k3_1 = host((3, 3, 3, 64, 1), .1)
    k5up = host((5, 5, 5, 128, 64), .1)
    bias64 = torch.zeros((64,), dtype=BF, device=dev)
    latents = host((2048, 512), .1)
    wq = host((512, 512), .05)
    wkv = host((128, 128), .05)

    def attn_trunk(sq):
        # cross-attn (1 head, 64) + 6 self-attn layers + FFs, shapes only
        x = latents[None].expand(sq.shape[0], 2048, 512)
        kv = torch.matmul(sq, wkv)
        sim = torch.matmul(x[..., :128].float(), kv.float().transpose(-1, -2))
        a = torch.softmax(sim, -1).to(BF)
        x = x + F.pad(torch.matmul(a, kv), (0, 384))
        for _ in range(6):
            q = torch.matmul(x, wq)
            sim = torch.matmul(q.float(), q.float().transpose(-1, -2))
            a = torch.softmax(sim, -1).to(BF)
            x = x + torch.matmul(a, q)
            x = x + torch.matmul(x, wq)
        return x

    pts = torch.tensor(rng.uniform(-0.5, 1.5, (n_chain, batch, POINTS, 3)).astype(
        np.float32), device=dev)
    ptf = torch.tensor(rng.uniform(-1, 1, (n_chain, batch, POINTS, 3)).astype(
        np.float32), device=dev)
    vox_bounds = torch.tensor([[-0.8, -1.0, 0.1, 1.2, 1.0, 2.1]] * batch, device=dev)

    def d0_consumers_separate(x):
        """ss0 + globalmax + patchify, each re-reading d0 (round-1 structure)."""
        return (spatial_softmax_3d(x), x.amax(dim=(1, 2, 3)), conv3d(x, k5s5, stride=5))

    # one set of trunk weights for both variants (the same seeded draws),
    # built outside the timed chains
    trunks = {flash: RealTrunk(flash, torch.Generator().manual_seed(0)).to(dev)
              for flash in (False, True) if wanted("real_attn_trunk")}

    f32 = torch.float32
    w1_ff = host((10, 64), .1, f32)
    b1_ff = torch.zeros((64,), dtype=f32, device=dev)
    wp_ff = host((5, 5, 5, 64, 64), .1, f32)
    kf_v2 = host((3, 3, 3, 128, 64), .1)
    bf_v2 = torch.zeros((64,), dtype=f32, device=dev)
    wt_v2 = host((1, 3, 3, 3, 64, 1), .1)
    bt_v2 = torch.zeros((1,), dtype=f32, device=dev)

    def decoder_tail(xs):
        return decoder_head(xs[0], xs[1], kf_v2, bf_v2, wt_v2, bt_v2)

    # (input with a leading chain axis, op)
    stages = {
        "front_fused@100": (
            (pts, ptf),
            lambda xs: front_fused(xs[0], xs[1], vox_bounds, w1_ff, b1_ff, wp_ff,
                                   voxel_size=n)),
        "decoder_v2_tail@100": ((d0, d0), decoder_tail),
        "decoder_v2c_tail@100": ((d0, d0), decoder_tail),
        "grid_copy_1row@100": (d0, lambda x: grid_copy(x, 1)),
        "grid_copy_4row@100": (d0, lambda x: grid_copy(x, 4)),
        "voxelize_32k->100^3": (
            (pts, ptf), lambda xs: voxelize(xs[0], xs[1], vox_bounds, voxel_size=n)),
        "d0_consumers_separate@100": (d0, d0_consumers_separate),
        "conv1x1_10->64@100": (grid10, lambda x: conv3d(x, k1)),
        "patchify_k5s5@100": (d0, lambda x: conv3d(x, k5s5, stride=5)),
        "patchify_s2d_matmul@100": (d0, lambda x: patchify_s2d(x, k5s5)),
        "ss0_softmax64@100": (d0, spatial_softmax_3d),
        "globalmax@100": (d0, lambda x: x.amax(dim=(1, 2, 3))),
        "final_k3_conv3d@100": (cat128, lambda x: conv3d(x, k3)),
        "final_k3_as_2d@100": (cat128, lambda x: conv3d_as_2d_zshift(x, k3)),
        "trans_k3_64->1@100": (d0, lambda x: conv3d(x, k3_1)),
        "fused_upsample20->100": (small, lambda x: upsample_conv(x, k5up, bias64, 5)),
        "attention_trunk": (seq, attn_trunk),
        "real_attn_trunk": (seq, trunks.get(False)),
        "real_attn_trunk_flash": (seq, trunks.get(True)),
    }
    assert list(stages) == list(STAGES)

    results = {}
    with torch.inference_mode():
        for name, (inp, fn) in stages.items():
            if not wanted(name):
                continue
            run = lambda: chain(inp, fn, n_chain)  # noqa: E731
            compile_s = warm_seconds(run, dev)
            walls = [seconds(run, dev) for _ in range(3)]
            results[name] = statistics.median(walls) / n_chain * 1000
            emit({"stage": name, "per_step_ms": round(results[name], 4),
                  "compile_s": round(compile_s, 2)})
    print(json.dumps({"batch": batch, "all": {k: round(v, 4) for k, v in results.items()}}),
          flush=True)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--only", nargs="*", default=None,
                    help="substring filter: run only stages whose name "
                         "contains any of these")
    args = ap.parse_args()
    main(batch=args.batch, only=args.only)
