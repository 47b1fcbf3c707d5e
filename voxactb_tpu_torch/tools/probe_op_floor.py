"""The card's fixed cost per dependent launch, and the launches of one act.

Counterpart of ``tools/probe_op_floor.py``:

(a) chains of K dependent bf16 ``[128, 128]`` matmuls (``torch.matmul``, as
    the JAX probe's ``jnp.dot``s: no Pallas kernel) at K = 16 and 128, each
    chain ending in an f32 sum; ms per launch from the two lengths, and the
    fixed cost of a chain;
(b) the act program's launches: where the JAX probe counts the instructions
    of the compiled 100^3 act, the port runs one 100^3 batch-1 act under
    ``torch.profiler`` and counts its device launches (kernels, copies and
    memsets; on the CPU, its top-level operators), with the twelve most
    frequent by name. The ``BENCH_PALLAS_*`` flags select the kernels as in
    the JAX probe (``BENCH_PALLAS_DECODER_V3`` K8, ``_DECODER`` K3,
    ``_ENCODER`` K5, ``_FRONT`` K1; K2 is on as in ``bench.py``).

    python3 -m voxactb_tpu_torch.tools.probe_op_floor
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np
import torch

from voxactb_tpu_torch.device import resolve_device
from voxactb_tpu_torch.tools import act_observations, device_line, emit, median_ms

CHAINS = (16, 128)
NO_COUNTERPART = {
    "error": "the JAX probe records the remote compiler refusing a large program; the "
             "profiler's count of one act has no such failure",
}


def measure_op_floor(dev: torch.device, chains=CHAINS, reps: int = 5) -> dict:
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(128, 128)).astype(np.float32)).to(dev, torch.bfloat16)
    w = torch.tensor(rng.normal(size=(128, 128)).astype(np.float32) * 0.05).to(
        dev, torch.bfloat16)

    def chain(k):
        def run():
            y = x
            for _ in range(k):
                y = torch.matmul(y, w)
            return y.sum(dtype=torch.float32)
        return run

    k_lo, k_hi = chains
    assert torch.isfinite(chain(k_lo)())
    ms_lo, ms_hi = (median_ms(chain(k), dev, reps) for k in (k_lo, k_hi))
    per_op = (ms_hi - ms_lo) / (k_hi - k_lo)
    return {f"chain{k_lo}_ms": ms_lo, f"chain{k_hi}_ms": ms_hi, "per_op_ms": per_op,
            "fixed_fetch_ms": ms_lo - k_lo * per_op}


def act_config(n: int, **overrides):
    from voxactb_tpu_torch.config import MethodConfig

    flag = os.environ.get
    kw = dict(voxel_sizes=[n], which_arm="right", compute_dtype="bfloat16",
              pallas_decoder=flag("BENCH_PALLAS_DECODER", "1") == "1",
              pallas_decoder_v3=flag("BENCH_PALLAS_DECODER_V3", "0") == "1",
              pallas_encoder=flag("BENCH_PALLAS_ENCODER", "1") == "1",
              pallas_front=flag("BENCH_PALLAS_FRONT", "1") == "1",
              pallas_attention=flag("BENCH_PALLAS_ATTN", "1") == "1")
    kw.update(overrides)
    return MethodConfig(**kw)


def _outermost_op(event) -> bool:
    """Whether ``event`` is an op with no op above it (spans do not count)."""
    parent = event.cpu_parent
    while parent is not None and parent.is_user_annotation:
        parent = parent.cpu_parent
    return parent is None and not event.is_user_annotation


def count_act_ops(dev: torch.device, n: int = 100, img: int = 128, **overrides) -> dict:
    """Launches of one act (after a warming one) and the twelve most frequent."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from voxactb_tpu_torch.agents.qfunction import make_infer_fn

    cfg = act_config(n, **overrides)
    model, infer = make_infer_fn(cfg, device=dev, seed=0)
    (obs,) = act_observations(np.random.default_rng(0), 1, 1, dev, img, cfg.low_dim_size())
    infer(model, *obs)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        infer(model, *obs)
        if cuda:
            torch.cuda.synchronize(dev)
    # the program's spans are user annotations, on the device's timeline too:
    # neither is an op
    if cuda:
        kinds = Counter({e.key: e.count for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA and e.device_time_total > 0
                         and not e.is_user_annotation})
    else:
        kinds = Counter(e.name for e in prof.events() if _outermost_op(e))
    return {"entry_ops": sum(kinds.values()), "by_kind": dict(kinds.most_common(12))}


def main(*, device=None, n: int = 100, img: int = 128, chains=CHAINS, **overrides) -> dict:
    """Both probes; ``n``, ``img``, ``chains`` and config ``overrides`` are
    there to run it small."""
    dev = resolve_device(device)
    emit(device_line(dev))
    out = {"op_floor": measure_op_floor(dev, chains),
           "act_program": count_act_ops(dev, n, img, **overrides)}
    return emit(out)


if __name__ == "__main__":
    main()
