"""The fused front stage alone, and the act chain it feeds, in one process.

Counterpart of ``tools/probe_front_matmul.py``, whose A/B is between two TPU
scatter schedules of the front kernel (serial unroll-8 and one-hot matmul).
K1 scatters every point with atomics: it has one schedule, so each row here
has one variant, ``front_fused`` (median of 3, ms per act):

- the front stage, chained over fresh clouds (2 x 128^2 points) at 100^3
  batch 1 and 8 and 50^3 batch 1, at the act's 64 channels (the JAX probe
  used 128, a width K1 does not take);
- the act chain with bench.py's kernel flags (K1, K3, K2); the cross-schedule
  action check holds trivially: two runs of the one schedule decode the same
  actions (an ``action_mismatch`` line otherwise).

    python3 -m voxactb_tpu_torch.tools.probe_front_matmul
"""

from __future__ import annotations

import numpy as np
import torch

from voxactb_tpu_torch.device import resolve_device
from voxactb_tpu_torch.tools import (
    SCENE_BOUNDS, act_chain, act_observations, chain as run_chain, device_line, emit,
    median_ms)
from voxactb_tpu_torch.tools.probe_act_ab import variant_config

GRIDS = ((100, 1), (100, 8), (50, 1))
N_CHAIN = {1: 16, 8: 4}
N_CHAIN_50 = 16
STAGE_CHAIN = 8
_NO_SCATTER = ("K1 scatters every point with atomics: it has no serial per-row scatter "
               "and drops no point, so the TPU kernel's scatter-schedule knob `{}` has no "
               "counterpart")
NO_COUNTERPART = {"serial8": _NO_SCATTER.format("scatter_unroll"),
                  "matmul": _NO_SCATTER.format("scatter_matmul"),
                  "compile_fail": "the JAX probe records Mosaic refusing a layout; a CUDA "
                                  "kernel that fails to build or launch raises",
                  "err": "the message of such a refusal (compile_fail)"}


def front_stage(n: int, batch: int, dev, chain: int = STAGE_CHAIN, img: int = 128,
                c: int = 64) -> float:
    from voxactb_tpu_torch.ops.cuda.front_fused import front_fused

    rng = np.random.default_rng(0)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    p = 2 * img * img
    coords = t(rng.uniform(-0.5, 1.5, (chain, batch, p, 3)))
    feats = t(rng.uniform(-1, 1, (chain, batch, p, 3)))
    bounds = t([SCENE_BOUNDS] * batch)
    w1 = t(rng.normal(size=(10, c)) * 0.3)
    b1 = t(rng.normal(size=(c,)) * 0.1)
    wp = t(rng.normal(size=(5, 5, 5, c, c)) * 0.05)

    @torch.inference_mode()
    def step():
        # d0's first channel only, as the JAX probe folds it
        return run_chain((coords, feats), lambda xs: (
            lambda d0, patch, kp, gmax, _: (d0[..., 0], patch, kp, gmax))(
                *front_fused(xs[0], xs[1], bounds, w1, b1, wp, voxel_size=n)), chain)

    if not torch.isfinite(step()).all():
        raise FloatingPointError(f"front stage at {n}^3 batch {batch}")
    return median_ms(step, dev, 3, chain * batch)


def main(*, device=None, grids=GRIDS, n_chain=None, stage_chain: int = STAGE_CHAIN,
         img: int = 128, **overrides) -> dict:
    """``{row: {"front_fused": ms per act}}``; ``grids``, the chain lengths,
    ``img`` and config ``overrides`` are there to run it small."""
    from voxactb_tpu_torch.agents.qfunction import make_infer_fn

    dev = resolve_device(device)
    emit(device_line(dev))
    results, mismatches = {}, []
    for n, batch in grids:
        row = {"front_fused": front_stage(n, batch, dev, stage_chain, img)}
        emit({"front_stage": f"n{n}_b{batch}", **row})
        results[f"front_n{n}_b{batch}"] = row
    for n, batch in grids:
        nc = n_chain or (N_CHAIN[batch] if n == 100 else N_CHAIN_50)
        cfg = variant_config(n, pallas_attention=True, **overrides)
        model, infer = make_infer_fn(cfg, device=dev, seed=0)
        obs = act_observations(np.random.default_rng(0), nc, batch, dev, img,
                               cfg.low_dim_size())
        a, b = act_chain(model, infer, obs), act_chain(model, infer, obs)
        if not torch.allclose(a, b, atol=1e-5):
            mismatches.append(emit({"action_mismatch": f"n{n}_b{batch}",
                                    "elements": int((~torch.isclose(a, b, atol=1e-5)).sum())}))
        emit({"compiled": "front_fused", "n": n, "batch": batch})
        key = f"act_n{n}_b{batch}"
        results[key] = {"front_fused": median_ms(lambda: act_chain(model, infer, obs), dev, 3,
                                                 nc * batch)}
        emit({key: results[key]})
    emit({"all": results})
    return dict(results=results, mismatches=mismatches)


if __name__ == "__main__":
    main()
