"""Measure the card's achievable memory rate and bf16 matmul rate
(counterpart of ``tools/roofline.py``).

Each probe is a chain of ``N_CHAIN`` steps over fresh slices synthesized on
the device, run once to warm and once timed between two CUDA events: a
read-reduce and a read-write elementwise pass over [1024, 1024, 64] bf16
slices (128 MB each, beyond the 50 MB L2), and a 2048^3 bf16
``torch.matmul``. Library calls, not kernels of the port.

    python3 -m voxactb_tpu_torch.tools.roofline
"""

from __future__ import annotations

import torch

from voxactb_tpu_torch.device import resolve_device
from voxactb_tpu_torch.tools import device_line, device_normal, emit, seconds, warm_seconds

N_CHAIN = 16


def main(*, device=None, n_chain: int = N_CHAIN, rows: int = 1024, mm: int = 2048) -> dict:
    """The three probes' lines; ``rows`` (of the bandwidth slices) and ``mm``
    (the matmul's size) are there to run it small."""
    dev = resolve_device(device)
    emit(device_line(dev))
    big = device_normal((n_chain, rows, 1024, 64), 0, dev)
    a = device_normal((n_chain, mm, mm), 1, dev)
    b = device_normal((1, mm, mm), 2, dev)[0]
    half = torch.tensor(0.5, dtype=torch.bfloat16, device=dev)
    scale = torch.tensor(1.0001, dtype=torch.bfloat16, device=dev)

    def step_s(xs, f):
        """Seconds per step of a chain of f, each step's output summed in f32."""
        def run():
            for i in range(n_chain):
                f(xs[i]).sum(dtype=torch.float32)
        warm_seconds(run, dev)
        return seconds(run, dev) / n_chain

    out = {}
    with torch.inference_mode():
        gb = big[0].numel() * 2 / 1e9
        t_read = step_s(big, lambda x: x.amax(dim=(0, 1)))
        out["read_reduce"] = emit({"probe": "read_reduce", "ms": t_read * 1e3, "GB": gb,
                                   "GBps": gb / t_read})
        # one pass writes 0.5 + 1.0001 x, the sum reads it: 3x the slice's bytes
        t_rw = step_s(big, lambda x: torch.addcmul(half, x, scale))
        out["rw_elementwise"] = emit({"probe": "rw_elementwise", "ms": t_rw * 1e3,
                                      "GBps_eff_3x": 3 * gb / t_rw})
        t_mm = step_s(a, lambda x: torch.matmul(x, b))
        out["matmul"] = emit({"probe": f"matmul{mm}", "ms": t_mm * 1e3,
                              "TFLOPs": 2 * mm ** 3 / t_mm / 1e12})
    return out


if __name__ == "__main__":
    main()
