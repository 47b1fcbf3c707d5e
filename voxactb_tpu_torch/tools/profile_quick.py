"""Quick per-stage latency probe for the decoder hot path (a subset of
``profile_stages``), counterpart of ``tools/profile_quick.py``.

Each stage is chained ``N_CHAIN`` times (a fresh input slice per step, its
outputs reduced to an f32 sum), run once to warm and once timed between two
CUDA events. Prints one JSON line per stage as it completes, so a partial run
still yields data. Inputs are synthesized on the device from seeded
``torch.Generator``s; weights come from the JAX tool's numpy stream.

    python3 -m voxactb_tpu_torch.tools.profile_quick

``full_qforward@100`` is the port's ``PerceiverVoxelLangEncoder`` (plain
path, random weights from a seed). The JAX tool builds it with
``zshift_conv3d=True``, a TPU schedule of the same convolutions; the port has
one schedule, so the stage runs the same math.
"""

from __future__ import annotations

import numpy as np
import torch

from voxactb_tpu_torch.device import resolve_device
from voxactb_tpu_torch.models.blocks import spatial_softmax_3d
from voxactb_tpu_torch.models.perceiver import PerceiverVoxelLangEncoder
from voxactb_tpu_torch.ops.upsample_conv import upsample_conv
from voxactb_tpu_torch.ops.voxelize import voxelize
from voxactb_tpu_torch.tools import (
    chain, device_line, device_normal, emit, seconds, warm_seconds)
from voxactb_tpu_torch.tools.profile_stages import BF, POINTS, conv3d_as_2d_zshift

N_CHAIN = 8
N = 100

STAGES = ("full_qforward@100", "preprocess_1x1_10->64@100", "voxelize_32k->100^3",
          "ss0_softmax64@100", "final_k3_as_2d@100", "trans_k3_64->1@100",
          "fused_upsample20->100")


def main(*, device=None, n: int = N, n_chain: int = N_CHAIN, only=None) -> dict:
    """Profile the seven stages (or those whose name holds a string of
    ``only``); ``n`` and ``n_chain`` are there to run it small. Returns
    ``{stage: per_step_ms}``."""
    dev = resolve_device(device)
    s = n // 5
    emit(device_line(dev))
    wanted = lambda name: not only or any(o in name for o in only)  # noqa: E731
    rng = np.random.default_rng(0)

    def host(shape, scale=1.0, dtype=BF):
        return torch.tensor(rng.normal(size=shape).astype(np.float32) * scale).to(dev, dtype)

    d0 = device_normal((n_chain, 1, n, n, n, 64), 1, dev)
    cat128 = device_normal((n_chain, 1, n, n, n, 128), 2, dev)
    small = device_normal((n_chain, 1, s, s, s, 128), 3, dev)
    k3 = host((3, 3, 3, 128, 64), .1)
    k3_1 = host((3, 3, 3, 64, 1), .1)
    k5up = host((5, 5, 5, 128, 64), .1)
    bias64 = torch.zeros((64,), dtype=BF, device=dev)
    pts = torch.tensor(rng.uniform(-0.5, 1.5, (n_chain, 1, POINTS, 3)).astype(np.float32),
                       device=dev)
    ptf = torch.tensor(rng.uniform(-1, 1, (n_chain, 1, POINTS, 3)).astype(np.float32),
                       device=dev)
    vox_bounds = torch.tensor([[-0.8, -1.0, 0.1, 1.2, 1.0, 2.1]], device=dev)

    # attention trunk at the real operating point: cross-attn (2048 latents
    # over 8077 tokens) + 6 self-attn + ff + decoder cross-attn
    trunk = None
    if wanted("full_qforward"):
        trunk = PerceiverVoxelLangEncoder(
            depth=6, voxel_size=n, initial_dim=10, low_dim_size=4, num_latents=2048,
            latent_dim=512, im_channels=64, final_dim=64, input_dropout=0.0,
            attn_dropout=0.0, decoder_dropout=0.0, dtype=BF,
            generator=torch.Generator().manual_seed(0)).to(dev)
    pro = host((1, 4), dtype=torch.float32)
    lg = host((1, 1024), dtype=torch.float32)
    lt = host((1, 77, 512), dtype=torch.float32)
    grids = device_normal((n_chain, 1, n, n, n, 10), 0, dev, torch.float32)

    stages = {
        "full_qforward@100": (grids, lambda g: trunk(g, pro, lg, lt)),
        "preprocess_1x1_10->64@100": (grids, lambda g: torch.matmul(g.to(BF), k3[0, 0, 0, :10])),
        "voxelize_32k->100^3": (
            (pts, ptf), lambda xs: voxelize(xs[0], xs[1], vox_bounds, voxel_size=n)),
        "ss0_softmax64@100": (d0, spatial_softmax_3d),
        "final_k3_as_2d@100": (cat128, lambda x: conv3d_as_2d_zshift(x, k3, "replicate")),
        "trans_k3_64->1@100": (d0, lambda x: conv3d_as_2d_zshift(x, k3_1, "replicate")),
        "fused_upsample20->100": (small, lambda x: upsample_conv(x, k5up, bias64, 5)),
    }
    assert tuple(stages) == STAGES

    results = {}
    with torch.inference_mode():
        for name, (inp, fn) in stages.items():
            if not wanted(name):
                continue
            run = lambda: chain(inp, fn, n_chain)  # noqa: E731
            compile_s = warm_seconds(run, dev)
            results[name] = seconds(run, dev) / n_chain * 1000
            emit({"stage": name, "per_step_ms": round(results[name], 4),
                  "compile_s": round(compile_s, 2)})
    return results


if __name__ == "__main__":
    main()
