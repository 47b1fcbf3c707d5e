#!/usr/bin/env python3
"""Time K6 (``voxactb_tpu_torch/ops/cuda/stats_head``) on one NVIDIA GPU at the
dense paths' five shapes, for this checkout or another one, and print one
JSON line.

    python3 stats_head_compare.py [--checkout DIR]

Run it in turns on two checkouts on one card, back to back (A, B, B, A), to
compare two versions of the kernel: each run builds DIR's stats kernel into
DIR/build/kernels and imports DIR's package, and takes the shapes
(``STATS_SHAPES``) and the timers from DIR's ``chip_smoke.py``. Per shape it
reports the median CUDA-event time of single wrapper calls (``call_ms``, host
work included, ``time_ms``) and the device time per call of every kernel a
call launches, from ``torch.profiler`` (``device_ms``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkout", default=os.path.dirname(os.path.abspath(__file__)))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("stats_head_compare: no CUDA device available", file=sys.stderr)
        return 2
    checkout = os.path.abspath(args.checkout)
    sys.path.insert(0, checkout)
    import chip_smoke
    from voxactb_tpu_torch.ops.cuda import build
    from voxactb_tpu_torch.ops.cuda import stats_head as K6

    for mod in (chip_smoke, build):
        if not os.path.abspath(mod.__file__).startswith(checkout + os.sep):
            raise SystemExit(f"stats_head_compare: {checkout} holds no {mod.__name__}")
    build_s = build.build_all(("stats_head",))
    dev = torch.device("cuda")
    rows = {}
    for seed, ((b, n, c), dtype) in enumerate(chip_smoke.STATS_SHAPES):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(b, n, n, n, c, generator=g).to(dev)
        x = torch.where(x >= 0, x, 0.02 * x).to(getattr(torch, dtype))
        fn = lambda: K6.stats_head(x)  # noqa: E731
        rows[f"[{b},{n}^3,{c}] {dtype}"] = dict(
            call_ms=chip_smoke.time_ms(fn, reps=20, warmup=3),
            device_ms=chip_smoke.device_ms(fn, None, reps=20))
        del x
        torch.cuda.empty_cache()
    print(json.dumps({"checkout": checkout, "card": chip_smoke.nvidia_smi_line(),
                      "build_s": build_s, "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
