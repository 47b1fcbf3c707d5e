"""Time variants of P1's copy kernel and P3's shifted-window kernel
(``csrc/probes.cu``) in turns on one NVIDIA GPU, P1 beside ``copy_``, and
print one JSON line per case and one in all.

    python3 -m voxactb_tpu_torch.tools.probe_sweep

Each variant is the checkout's ``probes.cu`` with some of its constants
set otherwise (``COPY_VARIANTS``, ``WINDOW_VARIANTS``), built with the port's
nvcc flags into ``build/probe_sweep/<kind>_<variant>/`` and launched through
its own library with the plan its constants give. At d0's shapes ([1, 100^3,
64] bf16 with 1 and 4 rows per slab, and batch 8 with 1), on seeded inputs,
every variant's copy is bit-equal to x, and each variant's time per launch
is the CUDA-event time of 20 back-to-back launches over 20, variants and
``copy_`` in the order A, B, ..., copy_, copy_, ..., B, A (the median of the
two). The wrapper's host time per call (``grid_copy`` and ``copy_`` issued
200 times without a synchronisation, over 200) is printed too. P3's variants
run at the JAX probe's shapes, held within 2^-7 of the plain version, their
device time per launch from the profiler (50 launches), in the same turns.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch

from voxactb_tpu_torch.device import resolve_device
from voxactb_tpu_torch.ops.cuda import build
from voxactb_tpu_torch.ops.cuda.probes import (
    SW_TILE, grid_copy, grid_copy_plan, shifted_window_reference)

# name: {constant of probes.cu: its value}; the first of each kernel is the
# source as it is
COPY_VARIANTS = {
    "c16k_s12_a8_1cta": {},
    "c16k_s12_a6_1cta": {"kCopyAhead": 6},
    "c16k_s12_a10_1cta": {"kCopyAhead": 10},
    "c16k_s6_a3_1cta": {"kCopyStages": 6, "kCopyAhead": 3},
    "c8k_s24_a16_1cta": {"kChunkBytes": 8192, "kCopyStages": 24, "kCopyAhead": 16},
    "c32k_s6_a4_1cta": {"kChunkBytes": 32768, "kCopyStages": 6, "kCopyAhead": 4},
    "c64k_s3_a2_1cta": {"kChunkBytes": 65536, "kCopyStages": 3, "kCopyAhead": 2},
    "c16k_s6_a4_2cta": {"kCopyStages": 6, "kCopyAhead": 4, "kCopyCtasPerSm": 2},
    "c16k_s4_a3_3cta": {"kCopyStages": 4, "kCopyAhead": 3, "kCopyCtasPerSm": 3},
}
# two 8 x 8 tiles per CTA (91 CTAs at 100 x 100), one (169) or three (65)
WINDOW_VARIANTS = {
    "two_tiles_per_cta": {},
    "one_tile_per_cta": {"kSwConsumers": 1},
    "three_tiles_per_cta": {"kSwConsumers": 3},
}
CASES = ((1, 1), (1, 4), (8, 1))  # (batch, rows per slab) of d0 [B, 100^3, 64] bf16
N = 100


def _variant_source(text: str, spec) -> str:
    for name, value in spec.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise SystemExit(f"probes.cu declares no constexpr int {name}")
    return text


def build_variants(variants, kind: str):
    """One nvcc per variant, all at once, into build/probe_sweep/<kind>_<name>:
    name -> (library, its kChunkBytes and kCopyCtasPerSm)."""
    procs = {}
    for name, spec in variants.items():
        d = build.PACKAGE_DIR.parent / "build" / "probe_sweep" / f"{kind}_{name}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        src = _variant_source((d / "probes.cu").read_text(), spec)
        (d / "probes.cu").write_text(src)
        consts = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                  for k in ("kChunkBytes", "kCopyCtasPerSm")}
        out = d / "libprobes.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(d / "probes.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out, consts)
    libs = {}
    for name, (proc, out, consts) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = (ctypes.CDLL(str(out)), consts)
    return libs


def _profiled_ms(fn, name: str, calls: int = 50) -> float:
    """Mean device time per launch of the kernels named ``name`` over
    ``calls`` calls, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages()
             if name in e.key and e.device_time_total > 0 and not e.is_user_annotation]
    if not found:
        raise SystemExit(f"the profiler recorded no {name} kernel")
    return sum(e.device_time_total for e in found) / sum(e.count for e in found) / 1e3


def _events_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_us(fn, calls: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def sweep_copy(dev, sms: int, stream: int):
    libs = build_variants(COPY_VARIANTS, "copy")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    rows_out = []
    for batch, rows in CASES:
        g = torch.Generator(device=dev).manual_seed(110 + batch)
        x = torch.randn((batch, N, N, N, 64), generator=g, device=dev).to(torch.bfloat16)
        out = torch.empty_like(x)
        total, slab_bytes = batch * N // rows, rows * N * N * 64 * 2
        launches = {}
        for name, (lib, consts) in libs.items():
            plan = grid_copy_plan(total, slab_bytes, sms, chunk_limit=consts["kChunkBytes"],
                                  ctas_per_sm=consts["kCopyCtasPerSm"])
            if lib.voxactb_grid_copy_prepare():
                raise SystemExit(f"{name}: the copy kernel's shared memory was refused")
            fn = lib.voxactb_grid_copy
            fn.restype, fn.argtypes = ci, [vp, vp, ctypes.c_longlong, ci, ci, ci, ci, ci, vp]
            args = (x.data_ptr(), out.data_ptr(), slab_bytes, total, plan.chunk_bytes,
                    plan.chunks_per_slab, plan.ctas, plan.ctas, stream)

            def launch(fn=fn, args=args, name=name):
                err = fn(*args)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            out.fill_(float("nan"))
            launch()
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int16), x.view(torch.int16)):
                raise SystemExit(f"{name} B={batch} rows={rows}: the copy differs from x")
            launches[name] = launch
        launches["copy_"] = lambda: out.copy_(x)
        times = {k: [] for k in launches}
        for name in list(launches) + list(launches)[::-1]:
            times[name].append(_events_ms(launches[name]))
        row = dict(shape=f"B={batch} rows={rows}",
                   ms={k: statistics.median(v) for k, v in times.items()},
                   turns=times,
                   host_us={"grid_copy": _host_us(lambda: grid_copy(x, rows)),
                            "copy_": _host_us(lambda: out.copy_(x))})
        print(json.dumps(row), flush=True)
        rows_out.append(row)
        del x, out
        torch.cuda.empty_cache()
    return rows_out


def sweep_window(dev, stream: int):
    """P3's variants at the JAX probe's shapes (x [102, 102, 128], w [9, 128,
    64] bf16 from numpy seed 12): within 2^-7 of the plain version's largest
    |output|, device time per launch from the profiler, in turns."""
    import numpy as np

    libs = build_variants(WINDOW_VARIANTS, "window")
    rng = np.random.default_rng(12)
    x = torch.tensor(rng.normal(size=(102, 102, 128)).astype(np.float32)).to(dev, torch.bfloat16)
    w = torch.tensor(rng.normal(size=(9, 128, 64)).astype(np.float32) * 0.1).to(
        dev, torch.bfloat16)
    ref = shifted_window_reference(x, w)
    tol = 2.0 ** -7 * float(ref.abs().max())
    out = torch.empty_like(ref)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    launches = {}
    for name, (lib, _) in libs.items():
        fn = lib.voxactb_shifted_window
        fn.restype, fn.argtypes = ci, [vp, vp, vp, ci, ci, ci, vp]
        args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), 100, 100, SW_TILE, stream)

        def launch(fn=fn, args=args, name=name):
            err = fn(*args)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        out.fill_(float("nan"))
        launch()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not err <= tol:
            raise SystemExit(f"shifted_window {name}: err {err} > {tol}")
        launches[name] = launch
    times = {k: [] for k in launches}
    for name in list(launches) + list(launches)[::-1]:
        times[name].append(_profiled_ms(launches[name], "probe_shifted_window"))
    row = dict(shape="x [102,102,128] w [9,128,64] bf16",
               ms={k: statistics.median(v) for k, v in times.items()}, turns=times)
    print(json.dumps(row), flush=True)
    return [row]


def main(device=None) -> dict:
    dev = resolve_device(device)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    result = {"card": card, "grid_copy": sweep_copy(dev, sms, stream),
              "shifted_window": sweep_window(dev, stream)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("probe_sweep: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    main()
