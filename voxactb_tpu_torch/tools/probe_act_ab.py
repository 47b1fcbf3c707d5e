"""Paired act-chain A/B of the kernel flags, in one process.

Counterpart of ``tools/probe_act_ab.py``. Variants, in turns in one process
(median of 3 runs of each chain), at 100^3 batch 1 and 8 and at 50^3 batch
1, on the same seeded observations:

  base   the fused front (K1) and the decoder tail (K3), plain attention
  flash  + the flash attention kernel (K2)
  all    the JAX probe's flash + v2c + unroll8; here the same config as flash

Every variant must decode the same 9-dof actions (the argmax contract): a
mismatch prints an ``action_mismatch`` line. Prints one JSON line per
variant built, one per grid with ms per act, and a summary.

    python3 -m voxactb_tpu_torch.tools.probe_act_ab
"""

from __future__ import annotations

import numpy as np
import torch

from voxactb_tpu_torch.device import resolve_device
from voxactb_tpu_torch.tools import (
    act_chain, act_observations, device_line, emit, median_ms, warm_seconds)

N_CHAIN = {1: 16, 8: 4}
N_CHAIN_50 = 32
GRIDS = ((100, 1), (100, 8), (50, 1))
VARIANTS = {"base": dict(), "flash": dict(pallas_attention=True)}
SAME_AS = {"all": "flash"}
NO_COUNTERPART = {
    "v2c": "decoder_head_v2c is a TPU schedule of K3 (K-concat z-accumulation); the port "
           "has one decoder tail kernel and ignores the flag (config.py)",
    "unroll8": "front_scatter_unroll is a TPU scatter schedule; K1 scatters with atomics "
               "and ignores the flag (config.py)",
}


def variant_config(n: int, **kw):
    from voxactb_tpu_torch.config import MethodConfig

    base = dict(voxel_sizes=[n], which_arm="right", compute_dtype="bfloat16",
                pallas_decoder=True, pallas_encoder=True, pallas_front=True,
                pallas_attention=False)
    base.update(kw)
    return MethodConfig(**base)


def main(*, device=None, grids=GRIDS, n_chain=None, img: int = 128, reps: int = 3,
         **overrides) -> dict:
    """``{grid: {variant: ms per act}}``; ``grids``, ``n_chain`` (one count
    for every grid), ``img`` and config ``overrides`` are there to run it
    small. ``mismatches`` lists the variants whose actions differ."""
    from voxactb_tpu_torch.agents.qfunction import make_infer_fn

    dev = resolve_device(device)
    emit(device_line(dev))
    results, mismatches = {}, []
    for n, batch in grids:
        nc = n_chain or (N_CHAIN[batch] if n == 100 else N_CHAIN_50)
        chains, actions = {}, {}
        for name, kw in VARIANTS.items():
            cfg = variant_config(n, **kw, **overrides)
            model, infer = make_infer_fn(cfg, device=dev, seed=0)
            obs = act_observations(np.random.default_rng(0), nc, batch, dev, img,
                                   cfg.low_dim_size())
            s = warm_seconds(lambda: act_chain(model, infer, obs), dev)
            acts = act_chain(model, infer, obs)
            if not torch.isfinite(acts).all():
                raise FloatingPointError(f"{name} at {n}^3 batch {batch}: non-finite actions")
            chains[name] = (model, infer, obs)
            actions[name] = acts.cpu()
            emit({"compiled": name, "n": n, "batch": batch, "warm_s": s})
        ref = actions["base"]
        for name, acts in actions.items():
            if not torch.allclose(acts, ref, atol=1e-5):
                bad = int((~torch.isclose(acts, ref, atol=1e-5)).sum())
                mismatches.append(emit({"action_mismatch": name, "n": n, "batch": batch,
                                        "elements": bad}))
        walls = {name: [] for name in chains}
        for _ in range(reps):
            for name, (model, infer, obs) in chains.items():
                walls[name].append(median_ms(lambda: act_chain(model, infer, obs), dev, 1,
                                             nc * batch))
        key = f"n{n}_b{batch}"
        results[key] = {name: sorted(w)[len(w) // 2] for name, w in walls.items()}
        results[key].update({alias: results[key][same] for alias, same in SAME_AS.items()})
        emit({key: results[key]})
        del chains
    emit({"all": results})
    return dict(results=results, mismatches=mismatches)


if __name__ == "__main__":
    main()
