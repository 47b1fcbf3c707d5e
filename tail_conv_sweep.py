#!/usr/bin/env python3
"""Time variants of the decoder tail's u conv (``voxactb_tpu_torch/csrc/
tail_conv.cuh``) in turns on one NVIDIA GPU, and print one JSON line.

    python3 tail_conv_sweep.py

Each variant is the checkout's source with one constant or line replaced
(``VARIANTS``), built with the port's nvcc flags into
``build/tail_conv_sweep/<variant>/`` and loaded in place of K3's library.
At 50^3 and 100^3 (batch 1) and 100^3 batch 8, on seeded d0 and u0 and the
act model's seeded weights, every variant's u is held within 2^-7 of the
plain conv's largest |u|, and the conv's device time per call comes from the
profiler, variants in the order A, B, C, C, B, A.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

# name: (text in tail_conv.cuh, its replacement); the first is the source as is
VARIANTS = {
    "ring3_persistent": None,
    "ring2_persistent": ("constexpr int kRing = 3;", "constexpr int kRing = 2;"),
    "ring3_one_brick_per_cta": ("const int grid = (int)(nb < sms ? nb : sms);",
                                "const int grid = (int)nb;"),
}
SHAPES = ((1, 50), (1, 100), (8, 100))


def build_variants(build):
    """One nvcc per variant, all at once; returns the loaded libraries."""
    procs = {}
    for name, sub in VARIANTS.items():
        d = HERE / "build" / "tail_conv_sweep" / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        if sub:
            src = (d / "tail_conv.cuh").read_text()
            if sub[0] not in src:
                raise SystemExit(f"variant {name}: {sub[0]!r} not in tail_conv.cuh")
            (d / "tail_conv.cuh").write_text(src.replace(*sub))
        out = d / "libdecoder_head.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(d / "decoder_head.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tail_conv_sweep: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as c
    from voxactb_tpu_torch.agents.qfunction import build_encoder
    from voxactb_tpu_torch.ops.cuda import build
    from voxactb_tpu_torch.ops.cuda.decoder_head import (
        decoder_head, launch_decoder_head, tail_conv_reference)

    libs = build_variants(build)
    card = c.nvidia_smi_line()
    model = build_encoder(c.act_config(50, which_arm="right"), device="cuda", seed=0)
    wf, bf = model.final.kernel_dhwio().detach(), model.final.bias.detach()
    wt = model.trans_decoder.kernel_dhwio().detach()[None]
    bt = model.trans_decoder.bias.detach()
    rows = []
    for b, n in SHAPES:
        rng = np.random.default_rng(n)
        x = torch.tensor(rng.normal(size=(b, n, n, n, 64)).astype(np.float32), device="cuda")
        d0 = torch.where(x >= 0, x, 0.02 * x).to(torch.bfloat16)
        del x
        g = torch.Generator(device="cpu").manual_seed(n)
        u0 = torch.randn(d0.shape, generator=g).to("cuda", torch.bfloat16)
        args = (d0, u0, wf, bf, wt, bt)
        u_ref = tail_conv_reference(d0, u0, wf, bf)
        tol = 2.0 ** -7 * float(u_ref.float().abs().max())
        times = {k: [] for k in VARIANTS}
        for name in list(VARIANTS) + list(VARIANTS)[::-1]:
            build._LIBS["decoder_head"] = libs[name]
            err = c.max_err(launch_decoder_head(*args)[3], u_ref)
            c.expect(err <= tol, f"{name} N={n} B={b}: u err {err} > {tol}")
            times[name].append(c.device_ms(lambda: decoder_head(*args), "tail_conv"))
        flops = 2.0 * b * n ** 3 * 27 * 128 * 64
        row = dict(shape=f"N={n} B={b}", device_ms=times,
                   tflops={k: flops / min(v) / 1e9 for k, v in times.items()})
        rows.append(row)
        print(json.dumps(row), flush=True)
        del d0, u0, u_ref, args
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "tail_conv_sweep": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
