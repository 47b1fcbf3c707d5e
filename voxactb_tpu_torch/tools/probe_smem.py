"""Probe the on-chip scratch a kernel can take and the 9-tap shifted-window
matmul on this card (counterpart of ``tools/probe_vmem.py``).

Hopper has no VMEM: a kernel's on-chip scratch is its shared memory, at most
227 KB (232,448 bytes) per block on an H100, above 48 KB only as dynamic
shared memory after the kernel's limit is raised (the opt-in limit,
``cudaDevAttrMaxSharedMemoryPerBlockOptin``). So the sizes walked are in KB,
not MB: 16, 48, 96, 160, 200, 227 and 228 KB, the last past the limit.

    python3 -m voxactb_tpu_torch.tools.probe_smem
"""

from __future__ import annotations

import numpy as np
import torch

from voxactb_tpu_torch.device import resolve_device
from voxactb_tpu_torch.ops.cuda.probes import shifted_window, smem_scratch
from voxactb_tpu_torch.tools import device_line, seconds

SCRATCH_KB = (16, 48, 96, 160, 200, 227, 228)


def probe_scratch(nbytes: int, device=None) -> bool:
    """Whether the scratch kernel launches with ``nbytes`` of shared memory;
    prints the error when it does not."""
    dev = resolve_device(device)
    x = torch.ones((8, 128), dtype=torch.float32, device=dev)
    try:
        smem_scratch(x, nbytes).cpu()
        return True
    except RuntimeError as e:
        print(f"  {nbytes} bytes failed: {str(e)[:200]}", flush=True)
        return False


def probe_shifted_einsum(device=None, reps: int = 50) -> dict:
    """The 9-tap (3 x 3) shifted-window matmul on a padded [102, 102, 128]
    bf16 block -> [100, 100, 64] f32, against the numpy sum over taps; prints
    the relative error and the time per call over ``reps`` calls."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    xn = rng.normal(size=(102, 102, 128)).astype(np.float32)
    wn = rng.normal(size=(9, 128, 64)).astype(np.float32) * 0.1
    xp = torch.tensor(xn).to(dev, torch.bfloat16)
    w = torch.tensor(wn).to(dev, torch.bfloat16)
    y = shifted_window(xp, w).cpu().numpy()
    # reference
    ref = np.zeros((100, 100, 64), np.float32)
    xn = xp.float().cpu().numpy()
    wn = w.float().cpu().numpy()
    i = 0
    for dy in range(3):
        for dx in range(3):
            ref += xn[dy:dy + 100, dx:dx + 100, :] @ wn[i]
            i += 1
    err = float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-9))

    def calls():
        for _ in range(reps):
            shifted_window(xp, w)

    ms = seconds(calls, dev) / reps * 1000
    print(f"shifted einsum ok, rel err {err:.2e}, {ms:.4f} ms/call", flush=True)
    return {"rel_err": err, "ms_per_call": ms}


def main(device=None, reps: int = 50) -> dict:
    dev = resolve_device(device)
    print(f"devices: {device_line(dev)}", flush=True)
    scratch = {}
    for kb in SCRATCH_KB:
        ok = probe_scratch(kb * 1024, dev)
        scratch[kb] = ok
        print(f"scratch {kb}KB: {'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            break
    return {**device_line(dev), "scratch_kb": scratch,
            "shifted_einsum": probe_shifted_einsum(dev, reps)}


if __name__ == "__main__":
    main()
