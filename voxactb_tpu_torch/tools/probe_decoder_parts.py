"""The decoder tail kernel's time by part.

Counterpart of ``tools/probe_decoder_parts.py``. The JAX probe times
compile-time ablations of its TPU kernel that compute wrong outputs on
purpose; the port's K3 runs in three launches, so each part is timed as it
runs, from the profiler, beside the stream floor (median of ``reps``):

  full         the wrapper call (``decoder_head``), ms per call
  conv         its k3 conv launch (``tail_conv``, writes u)
  trans_stats  its trans conv and soft-argmax partials (``tail_trans_stats``)
  combine      the partials' merge (``stats_combine``)
  dma          P1 (``grid_copy``) of the bytes K3 reads (d0 and u0): the
               stream floor

Off the card (``--device cpu``) the plain versions run and only ``full`` and
``dma`` have a time.

    python3 -m voxactb_tpu_torch.tools.probe_decoder_parts [--n 100] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from voxactb_tpu_torch.device import resolve_device
from voxactb_tpu_torch.tools import device_line, device_normal, emit, kernel_ms, median_ms

PARTS = {"conv": "tail_conv", "trans_stats": "tail_trans_stats", "combine": "stats_combine"}
_ABLATION = ("a compile-time ablation of the TPU kernel that computes wrong outputs on "
             "purpose; the port's K3 is not built with such variants: {}")
NO_COUNTERPART = {
    "nostats": _ABLATION.format("the stats share one launch with the trans conv "
                                "(trans_stats)"),
    "notrans": _ABLATION.format("the trans conv shares one launch with the stats "
                                "(trans_stats)"),
    "tap1": _ABLATION.format("a one-tap kernel is not built; the k3 conv is its own "
                             "launch (conv)"),
    "stats_ms": "full - nostats of the ablations above",
    "trans_ms": "full - notrans of the ablations above",
    "eight_taps_ms": "full - tap1 of the ablations above",
    "--cpu": "--device cpu",
    "compiled": "no variant of the kernel is built: the parts are the launches of its one build",
    "cpu_smoke": "--device cpu runs the plain versions and prints the same record, their "
                 "launches without a device time",
}


def main(*, device=None, n: int = 100, c: int = 64, t_heads: int = 1, reps: int = 3,
         calls: int = 10) -> dict:
    from voxactb_tpu_torch.ops.cuda.decoder_head import decoder_head
    from voxactb_tpu_torch.ops.cuda.probes import grid_copy

    dev = resolve_device(device)
    emit(device_line(dev))
    rng = np.random.default_rng(0)
    d0 = device_normal((1, n, n, n, c), 50, dev)
    u0 = device_normal((1, n, n, n, c), 51, dev)

    def w(shape, scale):
        return torch.tensor(rng.normal(size=shape).astype(np.float32) * scale).to(
            dev, torch.bfloat16)

    wf, bf = w((3, 3, 3, 2 * c, c), 0.05), w((c,), 1.0)
    wt, bt = w((t_heads, 3, 3, 3, c, 1), 0.05), w((t_heads,), 1.0)
    both = torch.stack([d0, u0])

    @torch.inference_mode()
    def full():
        return decoder_head(d0, u0, wf, bf, wt, bt)

    def dma():
        return grid_copy(both.reshape(2, n, n, n, c), 1)

    trans = full()[0]
    if not torch.isfinite(trans).all():
        raise FloatingPointError("decoder_head: non-finite trans")
    med = {"full": median_ms(full, dev, reps), "dma": median_ms(dma, dev, reps)}
    med.update({k: v for k, v in zip(PARTS, kernel_ms(full, calls, dev,
                                                       list(PARTS.values())).values())})
    shares = {"dma_floor_ms": med["dma"]}
    return emit({"n": n, "medians_ms": med, "shares": shares})


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--c", type=int, default=64)
    ap.add_argument("--t-heads", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None, help="cpu: the plain versions (no timing value)")
    args = ap.parse_args(argv)
    return main(device=args.device, n=args.n, c=args.c, t_heads=args.t_heads, reps=args.reps)


if __name__ == "__main__":
    cli()
