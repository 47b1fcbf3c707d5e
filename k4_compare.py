#!/usr/bin/env python3
"""Time K4 (``voxactb_tpu_torch/ops/cuda/flash_attention_train``) forward and
backward on one NVIDIA GPU at the BC train step's shapes, for this checkout or
another one, and print one JSON line.

    python3 k4_compare.py [--checkout DIR]

Run it in turns on two checkouts in one session on one card (A, B, B, A) to
compare two versions of the kernels: each run builds DIR's kernels into
DIR/build/kernels and imports DIR's package. Both wrapper interfaces are
taken: the forward returning ``(out, lse)`` or ``(out, lse, keep_bits)``, and
the backward reading the seed or the bits.

Per shape and dropout it reports the median CUDA-event time of single
wrapper calls (``call_ms``, host work included, as ``chip_smoke.py`` times
kernels) and the kernels' own device time per call from ``torch.profiler``
(``device_ms``), for the forward and the backward.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys


def call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


def device_ms(fn, reps: int = 10) -> float:
    """Device time of the kernels one call launches, from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages()
                   if e.device_time_total > 0 and "train" in e.key)
    return total_us / reps / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkout", default=os.path.dirname(os.path.abspath(__file__)))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k4_compare: no CUDA device available", file=sys.stderr)
        return 2
    # the train step's attentions, from this checkout's chip_smoke.py
    from chip_smoke import TRAIN_ATTENTION_SHAPES, TRAIN_STEP_ATTENTIONS

    checkout = os.path.abspath(args.checkout)
    sys.path.insert(0, checkout)
    from voxactb_tpu_torch.ops.cuda import build
    from voxactb_tpu_torch.ops.cuda import flash_attention_train as K4

    if not os.path.abspath(build.__file__).startswith(checkout + os.sep):
        raise SystemExit(f"k4_compare: {checkout} holds no voxactb_tpu_torch package")
    build_s = build.build_all(("flash_attention_train",))
    takes_bits = "bits" in inspect.signature(K4.flash_attention_train_backward).parameters
    dev = torch.device("cuda")
    rows = {}
    for name, n in TRAIN_STEP_ATTENTIONS.items():
        bh, tq, tk, step_dropout = TRAIN_ATTENTION_SHAPES[name]
        g = torch.Generator().manual_seed(0)
        q = (torch.randn(bh, tq, 64, generator=g) * 0.125).to(dev, torch.bfloat16)
        k = torch.randn(bh, tk, 64, generator=g).to(dev, torch.bfloat16)
        v = torch.randn(bh, tk, 64, generator=g).to(dev, torch.bfloat16)
        d_out = torch.randn(bh, tq, 64, generator=g).to(dev, torch.bfloat16)
        seed = torch.tensor(12345, dtype=torch.int64, device=dev)
        for dropout in sorted({0.0, step_dropout}):
            fwd = lambda: K4.flash_attention_train_forward(q, k, v, seed, dropout)  # noqa: E731
            res = fwd()
            lse = res[1]
            mask = res[2] if takes_bits else seed
            bwd = lambda: K4.flash_attention_train_backward(  # noqa: E731
                q, k, v, lse, d_out, mask, dropout)
            rows[f"{name}_dropout_{dropout}"] = dict(
                launches_per_step=n if dropout == step_dropout else 0,
                fwd_call_ms=call_ms(fwd), bwd_call_ms=call_ms(bwd),
                fwd_device_ms=device_ms(fwd), bwd_device_ms=device_ms(bwd))
        del q, k, v, d_out
        torch.cuda.empty_cache()
    per_step = {key: sum(r["launches_per_step"] * r[key] for r in rows.values())
                for key in ("fwd_call_ms", "bwd_call_ms", "fwd_device_ms", "bwd_device_ms")}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"checkout": checkout, "card": card, "build_s": build_s,
                      "takes_bits": takes_bits, "per_step": per_step, "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
