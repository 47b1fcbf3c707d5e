"""The fused front against the plain front at 50^3 and 100^3, batch 1 and 8,
and the decoder tail kernel's batch scaling, in one process.

Counterpart of ``tools/probe_front_batch.py``. Each stage is chained
``CHAIN`` deep over fresh point clouds (32768 points per sample), its outputs
reduced to an f32 sum; the median of 3 runs, in ms per step:

  front_fused@N_bB    K1 (voxelize, 1x1 conv + lrelu, stats, k5/s5 patchify)
  front_plain@N_bB    the same function in plain PyTorch
  voxelize_xla@N_bB   the plain voxelize alone (the JAX probe's XLA voxelize)
  decoder_v2@100_bB   K3 at batch 1 and 8

    python3 -m voxactb_tpu_torch.tools.probe_front_batch
"""

from __future__ import annotations

import numpy as np
import torch

from voxactb_tpu_torch.device import resolve_device
from voxactb_tpu_torch.tools import (
    SCENE_BOUNDS, chain as run_chain, device_line, device_normal, emit, median_ms,
    warm_seconds)

CHAIN = 16
POINTS = 32768
FRONT_GRIDS = ((50, 1), (100, 1), (100, 8))
DECODER_BATCHES = (1, 8)
NO_COUNTERPART = {
    "sort_prepass": "K1 scatters every point with atomics (csrc/front_fused.cu); it sorts "
                    "no points by row first",
}


def main(*, device=None, chain: int = CHAIN, front_grids=FRONT_GRIDS,
         decoder_batches=DECODER_BATCHES, decoder_n: int = 100, points: int = POINTS,
         c: int = 64) -> dict:
    """``{stage: ms per step}``; the sizes are there to run it small."""
    from voxactb_tpu_torch.ops.cuda.decoder_head import decoder_head
    from voxactb_tpu_torch.ops.cuda.front_fused import front_fused, front_fused_reference
    from voxactb_tpu_torch.ops.voxelize import voxelize

    dev = resolve_device(device)
    emit(device_line(dev))
    rng = np.random.default_rng(0)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    def timed(name, fn, inputs):
        step = torch.inference_mode()(lambda: run_chain(inputs, lambda xs: fn(*xs), chain))
        warm = warm_seconds(step, dev)
        if not torch.isfinite(step()).all():
            raise FloatingPointError(name)
        ms = median_ms(step, dev, 3, chain)
        emit({"stage": name, "per_step_ms": ms, "compile_s": warm})
        return ms

    results = {}
    for n, b in front_grids:
        w1 = t(rng.normal(size=(10, c)) * .1)
        b1 = torch.zeros((c,), device=dev)
        wp = t(rng.normal(size=(5, 5, 5, c, c)) * .05)
        pts = (t(rng.uniform(-0.5, 1.5, (chain, b, points, 3))),
               t(rng.uniform(-1, 1, (chain, b, points, 3))))
        bb = t(np.broadcast_to(np.asarray([SCENE_BOUNDS], np.float32), (b, 6)))
        for key, fn in (("front_fused", front_fused), ("front_plain", front_fused_reference)):
            results[f"{key}@{n}_b{b}"] = timed(
                f"{key}@{n}_b{b}",
                lambda p, f, fn=fn: fn(p, f, bb, w1, b1, wp, voxel_size=n)[:4], pts)
        results[f"voxelize_xla@{n}_b{b}"] = timed(
            f"voxelize_xla@{n}_b{b}", lambda p, f: voxelize(p, f, bb, voxel_size=n), pts)
        del pts

    n = decoder_n
    wf = t(rng.normal(size=(3, 3, 3, 2 * c, c)) * .05)
    bf = torch.zeros((c,), device=dev)
    wt = t(rng.normal(size=(1, 3, 3, 3, c, 1)) * .05)
    bt = torch.zeros((1,), device=dev)
    for b in decoder_batches:
        d0s = device_normal((chain, b, n, n, n, c), 60 + b, dev)
        u0s = device_normal((chain, b, n, n, n, c), 70 + b, dev)
        results[f"decoder_v2@{n}_b{b}"] = timed(
            f"decoder_v2@{n}_b{b}", lambda d, u: decoder_head(d, u, wf, bf, wt, bt),
            (d0s, u0s))
        del d0s, u0s
    emit({"all": results})
    return results


if __name__ == "__main__":
    main()
