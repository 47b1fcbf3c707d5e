#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's act path and BC train step on one NVIDIA H100
and check them.

    python3 chip_smoke.py

Phases:
  1. build   - compile the hand-written kernels (``voxactb_tpu_torch/csrc``),
               one nvcc per source in parallel; print the card and build time.
  2. kernels - hold each kernel against its plain PyTorch version on the card
               at the main paths' shapes (front at 50^3 and 100^3, inference
               attention at its cross/self/decoder shapes, decoder tail at 50^3
               and 100^3 and with two heads at 50^3, trainable attention
               forward and backward at the train step's three shapes and a
               ragged one: keep mask bit-equal, planted faults must fail);
               time kernel, plain version and, where one PyTorch call computes
               the same function, that call.
  3. act100  - full-width ``make_infer_fn`` at 100^3, batch 1 and 8, seeded
               weights: kernels on against the same weights with the kernel
               flags off (Q-field and head logits each within twice the plain
               path's own bf16-vs-f32 distance; an action flip fails only
               where the plain path's top-two gap exceeds it; a planted fault
               must fail that check), then the timed main-path run.
  4. dual50  - VoxAct-B's operating point through ``QAttentionBCAgent.act``:
               acting (dominant, arm head) and stabilizing (assistive) policies
               alternating over a 25-act episode on a 50^3 crop; then one act
               of the two-head variant, kernels on against kernels off.
  5. train50 - ``make_train_step`` at full width (50^3 crop, batch 8, bf16,
               depth 6, LAMB): one step's losses and gradients with dropout
               and augmentation off, kernels on against the plain attention
               path (within twice the plain bf16 path's distance from f32);
               timed steps with SE(3) augmentation and dropout on (loss finite
               and falling); a second run from the same seed; one step under
               the profiler; two ``agent.update`` steps.
  6. report  - every kernel's launch count rose during its main-path run;
               one ``{"kernels": [...]}`` line.
Then the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero without it.
Bulk details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
SCENE_BOUNDS = [-0.8, -1.0, 0.1, 1.2, 1.0, 2.1]
CROP_BOUNDS = [-0.1, -0.3, 0.5, 0.5, 0.3, 1.1]
IMG = 128
DEVICE = "cuda"


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of CUDA-event-timed single calls after warm-up."""
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


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def clouds(rng, batch: int):
    """The bench's clouds: 2 cameras x 128^2 points, rgb in [0, 255]."""
    rgbs = tuple(rng.integers(0, 255, (batch, IMG, IMG, 3)).astype(np.float32)
                 for _ in range(2))
    pcds = tuple(rng.uniform(-0.5, 1.5, (batch, IMG, IMG, 3)).astype(np.float32)
                 for _ in range(2))
    return rgbs, pcds


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


def expect(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: per-kernel checks
# ---------------------------------------------------------------------------


def check_front(model, n, batch, rng, details):
    import torch
    from voxactb_tpu_torch.agents.qfunction import normalize_rgb
    from voxactb_tpu_torch.ops.cuda.front_fused import front_fused, front_fused_reference
    from voxactb_tpu_torch.ops.voxelize import flatten_camera_observations

    dev = torch.device(DEVICE)
    rgbs, pcds = clouds(rng, batch)
    coords, feats = flatten_camera_observations(
        [normalize_rgb(torch.tensor(r, device=dev)) for r in rgbs],
        [torch.tensor(p, device=dev) for p in pcds])
    bounds = torch.tensor([SCENE_BOUNDS if n == 100 else CROP_BOUNDS] * batch,
                          device=dev)
    w1 = model.input_preprocess.kernel_dhwio()[0, 0, 0].detach()
    b1 = model.input_preprocess.bias.detach()
    wp = model.patchify.kernel_dhwio().detach()
    args = (coords, feats, bounds, w1, b1, wp)
    with torch.inference_mode():
        got = front_fused(*args, voxel_size=n)
        ref = front_fused_reference(*args, voxel_size=n)
        torch.cuda.synchronize()
    d0, patch, kp, gmax, overflow = got
    rd0, rpatch, rkp, rgmax, _ = ref
    # d0: the scatter's atomics sum in a run-dependent order, so a voxel mean can
    # differ in its last f32 bits and d0 by one bf16 ulp (2^-8 relative)
    ulp = rd0.float().abs() * 2.0 ** -8 + 1e-30
    d0_diff = (d0.float() - rd0.float()).abs()
    expect(bool((d0_diff <= ulp).all()), f"front d0 beyond 1 bf16 ulp at {n}^3")
    frac_d0 = float((d0_diff > 0).float().mean())
    expect(frac_d0 < 1e-3, f"front d0 differs in {frac_d0:.2e} of elements")
    # patch: 8000-term f32 sums of bf16 products in another order (+ d0 ulps)
    e_patch = max_err(patch, rpatch)
    tol_patch = 2e-3 * float(rpatch.abs().max())
    expect(e_patch <= tol_patch, f"front patch err {e_patch} > {tol_patch}")
    e_kp, e_g = max_err(kp, rkp), max_err(gmax, rgmax)
    expect(e_kp <= 1e-3, f"front kp err {e_kp} > 1e-3")
    expect(e_g <= 2.0 ** -7 * float(rgmax.abs().max()), f"front gmax err {e_g}")
    expect(int(overflow.sum()) == 0, "front overflow")

    with torch.inference_mode():
        ms = time_ms(lambda: front_fused(*args, voxel_size=n))
        plain = time_ms(lambda: front_fused_reference(*args, voxel_size=n), reps=5)
    p = coords.shape[1]
    s = n // 5
    nbytes = batch * p * 6 * 4 + batch * n ** 3 * 64 * 2 + batch * s ** 3 * 64 * 4 \
        + batch * 64 * 4 * 4 + (10 * 64 + 125 * 64 * 64) * 2 + 64 * 4
    flops = 2.0 * batch * n ** 3 * 10 * 64 + 2.0 * batch * s ** 3 * 125 * 64 * 64
    bms, by = bound_ms(nbytes, flops)
    row = dict(shape=f"N={n} B={batch} P={p}", max_abs_err=max_err(d0, rd0),
               d0_frac_differing=frac_d0, patch_err=e_patch, kp_err=e_kp,
               gmax_err=e_g, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
               library_ms=None)
    details.setdefault("front_fused", []).append(row)
    log(f"[kernels] front_fused N={n}: d0 err {row['max_abs_err']:.3g} "
        f"(<=1 bf16 ulp; {frac_d0:.2e} of elements differ), patch err {e_patch:.3g} "
        f"(tol {tol_patch:.3g}), kp err {e_kp:.3g} (tol 1e-3), gmax err {e_g:.3g}; "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms ({by})")
    return d0


def unmasked_attention(attention):
    """K2 without its key mask: the keys zero-filled up to the next 64-key
    tile take part as logit 0 and value 0, which is what the kernel computes
    if it skips the mask. A planted fault, run through the real kernel."""
    import torch

    def fn(q, k, v, **kw):
        z = k.new_zeros(k.shape[0], -k.shape[1] % 64, k.shape[2])
        return attention(q, torch.cat([k, z], 1), torch.cat([v, z], 1), **kw)
    return fn


def read_past_attention(attention):
    """K2 reading past Tk into the next head's keys and values instead of
    masking (the last head reads zeros). A planted fault, run through the
    real kernel."""
    import torch

    def fn(q, k, v, **kw):
        pad = -k.shape[1] % 64
        nxt = lambda t: torch.cat([t[1:, :pad], t.new_zeros(1, pad, t.shape[2])], 0)
        return attention(q, torch.cat([k, nxt(k)], 1), torch.cat([v, nxt(v)], 1), **kw)
    return fn


def tail_inputs(g, tq, tk, dev):
    """Two heads whose real logits sit near -8, so that keys past Tk would
    dominate the row if they took part: a zero-filled key (logit 0) by
    e^8, and head 1's keys read from head 0 (logit +8) by e^16. Values are
    near +1 in head 0 and -1 in head 1, so either fault moves head 0's
    output by most of its size."""
    import torch

    sign = torch.tensor([1.0, -1.0]).reshape(2, 1, 1)
    q = sign * 0.25 + 0.05 * torch.randn(2, tq, 64, generator=g)
    k = -sign * 0.5 + 0.2 * torch.randn(2, tk, 64, generator=g)
    v = sign + 0.5 * torch.randn(2, tk, 64, generator=g)
    return tuple(t.to(dev, torch.bfloat16) for t in (q, k, v))


def check_attention(b, s3, rng, details):
    import torch
    import torch.nn.functional as F
    from voxactb_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_reference)

    dev = torch.device(DEVICE)
    tk_in = 77 + s3
    shapes = {"cross": (b, 2048, tk_in), "self": (8 * b, 2048, 2048),
              "decoder": (b, tk_in, 2048), "tail": (2, 2048, tk_in)}
    rows = {}
    for name, (bh, tq, tk) in shapes.items():
        g = torch.Generator(device="cpu").manual_seed(int(rng.integers(1 << 30)))
        if name == "tail":
            q, k, v = tail_inputs(g, tq, tk, dev)
        else:
            q = (torch.randn(bh, tq, 64, generator=g) * 0.125).to(dev, torch.bfloat16)
            k = torch.randn(bh, tk, 64, generator=g).to(dev, torch.bfloat16)
            v = torch.randn(bh, tk, 64, generator=g).to(dev, torch.bfloat16)
        ref = flash_attention_reference(q, k, v)
        # the kernel and the plain version round P and the output at the same
        # points and differ only in f32 summation order, so an output may sit
        # one bf16 ulp of its own size away; 2^-7 of the largest output is at
        # least one and at most two ulps of it
        tol = 2.0 ** -7 * float(ref.float().abs().max())
        errs = {}
        for rpb in (0, 64, 16):  # the schedule the wrapper picks, then both
            got = flash_attention(q, k, v, rows_per_block=rpb)
            torch.cuda.synchronize()
            errs[rpb] = max_err(got, ref)
            expect(errs[rpb] <= tol, f"attention {name} rows_per_block={rpb} err "
                                     f"{errs[rpb]} > {tol}")
        err = max(errs.values())
        planted = {}
        if name == "tail":
            # the case must catch a kernel that skips the mask
            for fault, wrap in (("unmasked", unmasked_attention),
                                ("read_past", read_past_attention)):
                planted[fault] = max_err(wrap(flash_attention)(q, k, v)[:1], ref[:1])
                expect(planted[fault] > tol, f"attention tail: planted fault {fault} "
                                             f"err {planted[fault]} within {tol}")
        ms = time_ms(lambda: flash_attention(q, k, v))
        ms64 = time_ms(lambda: flash_attention(q, k, v, rows_per_block=64))
        ms16 = time_ms(lambda: flash_attention(q, k, v, rows_per_block=16))
        plain = time_ms(lambda: flash_attention_reference(q, k, v), reps=5)
        # the library call, as [1, BH, T, 64] so that it may take its fused kernel
        lib = time_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                             scale=1.0))
        nbytes = 2.0 * (2 * bh * tq * 64 + 2 * bh * tk * 64)
        flops = 4.0 * bh * tq * tk * 64
        bms, by = bound_ms(nbytes, flops)
        rows[name] = dict(shape=f"{name} BH={bh} Tq={tq} Tk={tk}", max_abs_err=err,
                          tol=tol, ref_max=float(ref.float().abs().max()),
                          planted_fault_err=planted, ms=ms, ms_rows64=ms64,
                          ms_rows16=ms16, plain_ms=plain, library_ms=lib,
                          bound_ms=bms, bound_by=by)
        log(f"[kernels] flash_attention {name} BH={bh} Tq={tq} Tk={tk}: err {err:.3g} "
            f"(tol {tol:.3g})" + "".join(f", planted {f} err {e:.3g}"
                                         for f, e in planted.items())
            + f"; {ms:.4f} ms (64-row blocks {ms64:.4f}, 16-row {ms16:.4f}), "
            f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.4f} ms ({by})")
    details.setdefault("flash_attention", []).append(dict(grid=f"s^3={s3} B={b}", **rows))
    return rows


def check_decoder(model, d0, rng, details, heads=1):
    """K3 against its plain version; ``heads=2`` is the two-head launch
    (trans [B,N,N,N,2]) with a second, seeded trans head."""
    import torch
    from voxactb_tpu_torch.ops.cuda.decoder_head import (
        decoder_head, decoder_head_reference)

    b, n = d0.shape[0], d0.shape[1]
    g = torch.Generator(device="cpu").manual_seed(int(rng.integers(1 << 30)))
    u0 = torch.randn(d0.shape, generator=g).to(d0.device, torch.bfloat16)
    wf = model.final.kernel_dhwio().detach()
    bf = model.final.bias.detach()
    wt = model.trans_decoder.kernel_dhwio().detach()[None]
    bt = model.trans_decoder.bias.detach()
    if heads == 2:
        wt = torch.cat([wt, (torch.randn(wt.shape, generator=g) * wt.std().cpu()).to(
            wt.device)])
        bt = torch.cat([bt, torch.full_like(bt, 0.01)])
    args = (d0, u0, wf, bf, wt, bt)
    got = decoder_head(*args)
    ref = decoder_head_reference(*args)
    torch.cuda.synchronize()
    (trans, kp, gmax), (rtrans, rkp, rgmax) = got, ref
    expect(tuple(trans.shape) == (b, n, n, n, heads), f"decoder trans shape {trans.shape}")
    # trans: 1728-term f32 sums over u, and u itself from 3456-term f32 sums
    # rounded to bf16 (a sum on a rounding boundary may round the other way)
    e_t = max_err(trans, rtrans)
    tol_t = 1e-2 * float(rtrans.abs().max())
    expect(e_t <= tol_t, f"decoder trans err {e_t} > {tol_t}")
    e_kp, e_g = max_err(kp, rkp), max_err(gmax, rgmax)
    expect(e_kp <= 1e-3, f"decoder kp err {e_kp} > 1e-3")
    expect(e_g <= 2.0 ** -7 * float(rgmax.abs().max()), f"decoder gmax err {e_g}")
    argmax_same = bool((trans.reshape(b, -1, heads).argmax(1)
                        == rtrans.reshape(b, -1, heads).argmax(1)).all())
    ms = time_ms(lambda: decoder_head(*args))
    plain = time_ms(lambda: decoder_head_reference(*args), reps=5)
    n3 = n ** 3
    nbytes = 2.0 * b * n3 * 64 * 2 + b * n3 * 4 * heads + b * 64 * 4 * 4 \
        + (27 * 128 * 64 + 27 * 64 * heads) * 2 + (64 + heads) * 4
    flops = 2.0 * b * n3 * 27 * 128 * 64 + 2.0 * b * n3 * 27 * 64 * heads
    bms, by = bound_ms(nbytes, flops)
    row = dict(shape=f"N={n} B={b} T={heads}", max_abs_err=e_t, tol=tol_t, kp_err=e_kp,
               gmax_err=e_g, argmax_same=argmax_same, ms=ms, plain_ms=plain,
               bound_ms=bms, bound_by=by, library_ms=None)
    details.setdefault("decoder_head" if heads == 1 else "decoder_head_two_heads",
                       []).append(row)
    log(f"[kernels] decoder_head N={n} T={heads}: trans err {e_t:.3g} (tol {tol_t:.3g}), "
        f"kp err {e_kp:.3g}, gmax err {e_g:.3g}, argmax same {argmax_same}; "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms ({by})")


def kernel_keep_mask(seed, bh, tq, tk, dropout):
    """K4's dropout mask read back through the forward kernel itself: with
    q = 0 every probability is 1/Tk, so with a one-hot slice of 64 keys as v
    an output is non-zero exactly where the kernel kept that key."""
    import torch
    from voxactb_tpu_torch.ops.cuda.flash_attention_train import (
        flash_attention_train_forward)

    dev = torch.device(DEVICE)
    q = torch.zeros(bh, tq, 64, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(bh, tk, 64, dtype=torch.bfloat16, device=dev)
    keep = torch.empty(bh, tq, tk, dtype=torch.bool, device=dev)
    eye = torch.eye(64, dtype=torch.bfloat16, device=dev)
    for c0 in range(0, tk, 64):
        w = min(64, tk - c0)
        v = torch.zeros(bh, tk, 64, dtype=torch.bfloat16, device=dev)
        v[:, c0:c0 + w] = eye[:w]
        out, _ = flash_attention_train_forward(q, k, v, seed, dropout)
        keep[:, :, c0:c0 + w] = out[:, :, :w] != 0
    return keep


# K4 at the train step's shapes (50^3 crop, batch 8): (BH, Tq, Tk, the
# dropout of that attention in the step)
TRAIN_ATTENTION_SHAPES = {"cross": (8, 2048, 1077, 0.1), "self": (64, 2048, 2048, 0.1),
                          "decoder": (8, 1077, 2048, 0.0), "ragged": (2, 333, 1077, 0.1)}


def check_attention_train(rng, details):
    """K4 forward and backward against the plain version on the card."""
    import torch
    import torch.nn.functional as F
    from voxactb_tpu_torch.ops.cuda import flash_attention_train as K4

    dev = torch.device(DEVICE)
    rows = {}
    for name, (bh, tq, tk, step_dropout) in TRAIN_ATTENTION_SHAPES.items():
        g = torch.Generator(device="cpu").manual_seed(int(rng.integers(1 << 30)))
        if name == "ragged":
            q, k, v = tail_inputs(g, tq, tk, dev)
        else:
            q = (torch.randn(bh, tq, 64, generator=g) * 0.125).to(dev, torch.bfloat16)
            k = torch.randn(bh, tk, 64, generator=g).to(dev, torch.bfloat16)
            v = torch.randn(bh, tk, 64, generator=g).to(dev, torch.bfloat16)
        d_out = torch.randn(bh, tq, 64, generator=g).to(dev, torch.bfloat16)
        seed = torch.tensor(int(rng.integers(1 << 32)), dtype=torch.int64, device=dev)
        row = dict(shape=f"{name} BH={bh} Tq={tq} Tk={tk}", step_dropout=step_dropout)

        # the mask, bit for bit
        want = K4.keep_mask(seed, bh, tq, tk, 0.1)
        got = kernel_keep_mask(seed, bh, tq, tk, 0.1)
        torch.cuda.synchronize()
        row["mask_elements_differing"] = int((want != got).sum())
        row["mask_drop_rate"] = float(1.0 - got.float().mean())
        expect(row["mask_elements_differing"] == 0,
               f"attention_train {name}: keep mask differs in "
               f"{row['mask_elements_differing']} elements")
        del want, got

        for dropout in (0.0, 0.1):
            out, lse = K4.flash_attention_train_forward(q, k, v, seed, dropout)
            dq, dk, dv = K4.flash_attention_train_backward(q, k, v, lse, d_out, seed,
                                                           dropout)
            rout, rlse = K4.plain_forward(q, k, v, seed, dropout)
            rdq, rdk, rdv = K4.plain_backward(q, k, v, rlse, d_out, seed, dropout)
            torch.cuda.synchronize()
            # kernel and plain version round at the same points and differ in
            # f32 summation order only, so a bf16 output (out, dq, dk, dv) may
            # sit one bf16 ulp of its own size away, and 2^-7 of the largest is
            # one to two ulps of it. lse is f32: a few ulps of the largest.
            tols = {"out": 2.0 ** -7, "lse": 2.0 ** -20, "dq": 2.0 ** -7, "dk": 2.0 ** -7,
                    "dv": 2.0 ** -7}
            pairs = {"out": (out, rout), "lse": (lse, rlse), "dq": (dq, rdq),
                     "dk": (dk, rdk), "dv": (dv, rdv)}
            errs = {}
            for key, (a, r) in pairs.items():
                tol = tols[key] * float(r.float().abs().max())
                errs[key] = dict(max_abs_err=max_err(a, r), tol=tol)
                expect(errs[key]["max_abs_err"] <= tol,
                       f"attention_train {name} dropout {dropout}: {key} err "
                       f"{errs[key]['max_abs_err']} > {tol}")
            row[f"dropout_{dropout}"] = errs
            if dropout > 0.0:
                # planted fault: the backward draws its mask from another seed
                wrong = K4.flash_attention_train_backward(q, k, v, lse, d_out, seed + 1,
                                                          dropout)
                caught = [key for key, a in zip(("dq", "dk", "dv"), wrong)
                          if max_err(a, pairs[key][1]) > errs[key]["tol"]]
                row["planted_other_seed_caught_by"] = caught
                expect(len(caught) == 3, f"attention_train {name}: a backward with "
                                         f"another seed's mask passed in {caught}")
            if name == "ragged" and dropout == 0.0:
                # planted fault: the keys zero-filled up to the next tile take part
                z = k.new_zeros(bh, -tk % 64, 64)
                wrong, _ = K4.flash_attention_train_forward(
                    q, torch.cat([k, z], 1), torch.cat([v, z], 1), seed, 0.0)
                e = max_err(wrong, rout)
                row["planted_unmasked_err"] = e
                expect(e > errs["out"]["tol"],
                       f"attention_train ragged: an unmasked key tail erred by {e} only")
            del rout, rlse, rdq, rdk, rdv
        log(f"[kernels] flash_attention_train {name} BH={bh} Tq={tq} Tk={tk}: mask "
            f"bit-equal (drop rate {row['mask_drop_rate']:.4f}); " + "; ".join(
                f"dropout {d}: " + ", ".join(
                    f"{key} err {v_['max_abs_err']:.3g} (tol {v_['tol']:.3g})"
                    for key, v_ in row[f"dropout_{d}"].items()) for d in (0.0, 0.1)))

        # no atomics: a second launch gives the same bits
        d = step_dropout
        out, lse = K4.flash_attention_train_forward(q, k, v, seed, d)
        first = (out, lse) + K4.flash_attention_train_backward(q, k, v, lse, d_out, seed, d)
        out2, lse2 = K4.flash_attention_train_forward(q, k, v, seed, d)
        again = (out2, lse2) + K4.flash_attention_train_backward(q, k, v, lse2, d_out,
                                                                 seed, d)
        expect(all(torch.equal(a, b_) for a, b_ in zip(first, again)),
               f"attention_train {name}: two launches on the same inputs differ")
        del first, again, out2, lse2

        # times at the dropout this attention has in the train step
        row["fwd_ms"] = time_ms(lambda: K4.flash_attention_train_forward(q, k, v, seed, d),
                                reps=5)
        row["bwd_ms"] = time_ms(lambda: K4.flash_attention_train_backward(
            q, k, v, lse, d_out, seed, d), reps=5)
        row["plain_fwd_ms"] = time_ms(lambda: K4.plain_forward(q, k, v, seed, d),
                                      reps=3, warmup=1)
        row["plain_bwd_ms"] = time_ms(lambda: K4.plain_backward(
            q, k, v, lse, d_out, seed, d), reps=3, warmup=1)
        # the library call, as [1, BH, T, 64] so that it may take its fused kernel
        ql, kl, vl = (t.detach()[None].clone().requires_grad_() for t in (q, k, v))
        with torch.no_grad():
            row["sdpa_fwd_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=1.0), reps=5)
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=1.0)
        row["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), d_out[None], retain_graph=True), reps=5)
        del lib_out, ql, kl, vl
        flops = 4.0 * bh * tq * tk * 64
        qkv_bytes = 2.0 * (bh * tq * 64 + 2 * bh * tk * 64)
        row["fwd_bound_ms"], row["fwd_bound_by"] = bound_ms(
            qkv_bytes + 2.0 * bh * tq * 64 + 4.0 * bh * tq, flops)
        row["bwd_bound_ms"], row["bwd_bound_by"] = bound_ms(
            2.0 * qkv_bytes + 2.0 * 2 * bh * tq * 64 + 4.0 * bh * tq, 2.5 * flops)
        rows[name] = row
        log(f"[kernels] flash_attention_train {name} at dropout {d}: forward "
            f"{row['fwd_ms']:.4f} ms (plain {row['plain_fwd_ms']:.4f}, sdpa "
            f"{row['sdpa_fwd_ms']:.4f}, bound {row['fwd_bound_ms']:.4f} "
            f"{row['fwd_bound_by']}); backward {row['bwd_ms']:.4f} ms (plain "
            f"{row['plain_bwd_ms']:.4f}, sdpa {row['sdpa_bwd_ms']:.4f}, bound "
            f"{row['bwd_bound_ms']:.4f} {row['bwd_bound_by']})")
        torch.cuda.empty_cache()
    details["flash_attention_train"] = rows
    return rows


# ---------------------------------------------------------------------------
# phases 3-4: the act path
# ---------------------------------------------------------------------------


def act_config(n, **kw):
    from voxactb_tpu_torch.config import MethodConfig

    return MethodConfig(voxel_sizes=[n], compute_dtype="bfloat16", pallas_front=True,
                        pallas_attention=True, pallas_decoder=True, **kw)


def plain_config(cfg, dtype=None):
    """The same config with the kernel flags off (the plain path), at
    ``dtype`` if one is given."""
    import dataclasses

    extra = {} if dtype is None else {"compute_dtype": dtype}
    return dataclasses.replace(cfg, pallas_front=False, pallas_attention=False,
                               pallas_decoder=False, **extra)


def act_inputs(rng, batch, low_dim):
    rgbs, pcds = clouds(rng, batch)
    return dict(rgbs=rgbs, pcds=pcds,
                proprio=rng.normal(size=(batch, low_dim)).astype(np.float32),
                lang_goal_emb=rng.normal(size=(batch, 1024)).astype(np.float32),
                lang_token_embs=rng.normal(size=(batch, 77, 512)).astype(np.float32))


def reference_model(cfg, model_on, dtype):
    """The plain path's model at ``dtype`` with ``model_on``'s weights."""
    from voxactb_tpu_torch.agents.qfunction import build_encoder

    model = build_encoder(plain_config(cfg, dtype), device=DEVICE, seed=0)
    model.load_state_dict(model_on.state_dict())
    return model


def path_outputs(cfg, model, inputs, bounds):
    """The Q-net's outputs, as f32, on one batch of observations."""
    import torch
    from voxactb_tpu_torch.agents.qfunction import apply_with_front, normalize_rgb
    from voxactb_tpu_torch.ops.voxelize import flatten_camera_observations

    dev = torch.device(DEVICE)
    b = inputs["proprio"].shape[0]
    t = lambda x: torch.as_tensor(x, device=dev)
    with torch.inference_mode():
        coords, feats = flatten_camera_observations(
            [normalize_rgb(t(r)) for r in inputs["rgbs"]], [t(p) for p in inputs["pcds"]])
        bnd = torch.broadcast_to(t(np.asarray(bounds, np.float32)).reshape(-1, 6), (b, 6))
        out, _, _ = apply_with_front(cfg, model, coords, feats, bnd, t(inputs["proprio"]),
                                     t(inputs["lang_goal_emb"]),
                                     t(inputs["lang_token_embs"]))
    return {k: v.float() for k, v in out.items()}


@contextlib.contextmanager
def planted(module, attr, wrap):
    """Replace a kernel wrapper by ``wrap(wrapper)`` for the block (the port
    looks its wrappers up at call time)."""
    import importlib

    mod = importlib.import_module(module)
    orig = getattr(mod, attr)
    setattr(mod, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def swapped_decoder_taps(decoder_head):
    """K3 fed its 3x3x3 taps with the depth and width axes swapped: a layout
    fault between the module and the kernel. A planted fault."""
    def fn(d0, u0, wf, *rest):
        return decoder_head(d0, u0, wf.transpose(0, 2), *rest)
    return fn


# planted faults run through the kernel path of act100_b1: (name, wrapper
# module, wrapper, fault, whether the act-level comparison must catch it)
ACT_FAULTS = (
    ("decoder_taps_swapped", "voxactb_tpu_torch.ops.cuda.decoder_head", "decoder_head",
     swapped_decoder_taps, True),
    ("attention_unmasked", "voxactb_tpu_torch.ops.cuda.flash_attention",
     "flash_attention", unmasked_attention, False),
)


# outputs that share a tolerance: the MLP heads' logits come from one feature
# vector through two-layer heads of one initialisation scale (rot_grip and
# collision are even slices of one Dense output), so they carry bf16 noise of
# one size; a group of 2 logits alone would give no estimate of it. The
# two-head variant's ``*_right`` / ``*_left`` outputs fall into the same groups.
def tol_group(key: str) -> str:
    return "trans" if key.startswith("trans") else "logits"


def compare_paths(cfg, model_on, refs, inputs, bounds, tag, details, faults=()):
    """Kernel path vs the plain path at bf16 on the same weights and inputs.

    The tolerance of each group of outputs is twice the plain bf16 path's own
    distance from the plain path at f32 (max abs over the group): if the
    kernel path is no less accurate than the plain bf16 path, the triangle
    inequality keeps the two within it. An integer action may flip only where
    the plain path's top-two gap is within that tolerance.
    """
    on = path_outputs(cfg, model_on, inputs, bounds)
    off = path_outputs(plain_config(cfg), refs["bfloat16"], inputs, bounds)
    f32 = path_outputs(plain_config(cfg, "float32"), refs["float32"], inputs, bounds)
    b = inputs["proprio"].shape[0]
    nr = cfg.num_rotation_classes
    report = {}
    for group in ("trans", "logits"):
        keys = [k for k in on if tol_group(k) == group]
        plain_err = max(max_err(off[k], f32[k]) for k in keys)
        for k in keys:
            report[k] = dict(max_abs_err=max_err(on[k], off[k]), tol=2.0 * plain_err,
                             plain_vs_f32=max_err(off[k], f32[k]),
                             kernel_vs_f32=max_err(on[k], f32[k]),
                             ref_range=float(off[k].max() - off[k].min()))
    bad = [k for k, v in report.items() if v["max_abs_err"] > v["tol"]]
    # integer actions: a flip is allowed only at a near-tie of the plain path;
    # each argmax group as (output key, columns)
    rot = [slice(i * nr, (i + 1) * nr) for i in range(3)] + [slice(3 * nr, None)]
    groups = [(k, sl) for k in on
              for sl in (rot if k.startswith("rot_grip") else [slice(None)])]
    flips, bad_flips = 0, 0
    for key, cols in groups:
        a, r = on[key].reshape(b, -1)[:, cols], off[key].reshape(b, -1)[:, cols]
        tol = report[key]["tol"]
        ia, ir = a.argmax(-1), r.argmax(-1)
        top2 = r.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        for bi in range(b):
            if int(ia[bi]) != int(ir[bi]):
                flips += 1
                if float(gap[bi]) > tol:
                    bad_flips += 1
    report["action_flips"] = flips
    report["flips_beyond_near_tie"] = bad_flips
    log(f"[{tag}] kernel vs plain path: " + ", ".join(
        f"{k} err {v['max_abs_err']:.3g} (tol {v['tol']:.3g}; plain bf16 vs f32 "
        f"{v['plain_vs_f32']:.3g}, kernel vs f32 {v['kernel_vs_f32']:.3g}, range "
        f"{v['ref_range']:.3g})"
        for k, v in report.items() if isinstance(v, dict))
        + f"; {flips} argmax flips, {bad_flips} beyond a near-tie")
    planted_report = {}
    for name, module, attr, wrap, must_catch in faults:
        with planted(module, attr, wrap):
            wrong = path_outputs(cfg, model_on, inputs, bounds)
        errs = {k: max_err(wrong[k], off[k]) for k in on}
        caught = [k for k in on if errs[k] > report[k]["tol"]]
        planted_report[name] = dict(errs=errs, caught_by=caught)
        log(f"[{tag}] planted fault {name}: " + ", ".join(
            f"{k} err {e:.3g}" for k, e in errs.items())
            + f"; beyond tolerance in {caught or 'no output'}")
        expect(bool(caught) or not must_catch,
               f"{tag}: planted fault {name} stayed within tolerance")
    report["planted_faults"] = planted_report
    details.setdefault("path_compare", {})[tag] = report
    expect(not bad, f"{tag}: kernel vs plain beyond tolerance in {bad}")
    expect(bad_flips == 0, f"{tag}: {bad_flips} action flips beyond a near-tie")
    return report


def act100(rng, details, timings):
    import torch
    from voxactb_tpu_torch.agents.qfunction import make_infer_fn
    from voxactb_tpu_torch.ops import cuda as kernels

    cfg = act_config(100, which_arm="right")
    model_on, infer = make_infer_fn(cfg, device=DEVICE, seed=0)
    model_off, infer_off = make_infer_fn(plain_config(cfg), device=DEVICE, seed=0)
    model_off.load_state_dict(model_on.state_dict())
    refs = {"bfloat16": model_off, "float32": reference_model(cfg, model_on, "float32")}
    runs = {}
    for batch, reps in ((1, 10), (8, 5)):
        inputs = act_inputs(rng, batch, cfg.low_dim_size())
        bounds = [SCENE_BOUNDS] * batch
        compare_paths(cfg, model_on, refs, inputs, bounds, f"act100_b{batch}",
                      details, faults=ACT_FAULTS if batch == 1 else ())
        args = (inputs["rgbs"], inputs["pcds"], inputs["proprio"],
                inputs["lang_goal_emb"], inputs["lang_token_embs"], bounds)
        out = infer(model_on, *args)  # warm
        out_off = infer_off(model_off, *args)
        torch.cuda.synchronize()
        cont = out.continuous_action
        expect(tuple(cont.shape) == (batch, 9) and bool(torch.isfinite(cont).all()),
               "act100 continuous action")
        expect(bool(((out.trans_idx >= 0) & (out.trans_idx < 100)).all()),
               "act100 trans idx range")
        differ = int((out.trans_idx != out_off.trans_idx).sum()
                     + (out.rot_grip_idx != out_off.rot_grip_idx).sum()
                     + (out.collision_idx != out_off.collision_idx).sum())
        details["path_compare"][f"act100_b{batch}"]["integer_action_elements_differing"] = (
            differ)

        def drive(m, f, n_acts):
            walls = []
            for _ in range(n_acts):
                t0 = time.perf_counter()
                o = f(m, *args)
                o.continuous_action.cpu()
                walls.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(walls)

        plain_ms = drive(model_off, infer_off, max(2, reps // 2))
        kernels.reset_launch_counts()
        ms = drive(model_on, infer, reps)
        counts = kernels.launch_counts()
        runs[batch] = dict(acts=reps, launches=counts)
        if batch == 1:
            profile_act(lambda: infer(model_on, *args).continuous_action.cpu(),
                        "act100_b1", details, ms)
        timings[f"act100_b{batch}"] = dict(ms_per_call=ms, plain_ms_per_call=plain_ms,
                                           batch=batch, ms_per_act=ms / batch,
                                           integer_action_elements_differing=differ)
        log(f"[act100] batch {batch}: {ms:.3f} ms/call ({ms / batch:.3f} ms/act) "
            f"kernels on, {plain_ms:.3f} ms/call plain; {differ} integer action "
            f"elements differ; launches in {reps} calls: {counts}")
    del model_on, model_off, refs
    torch.cuda.empty_cache()
    return dict(acts=sum(r["acts"] for r in runs.values()),
                launches={k: sum(r["launches"][k] for r in runs.values())
                          for k in runs[1]["launches"]},
                per_batch=runs)


def profile_act(fn, tag, details, act_ms, top=12):
    """One call (an act, a train step) under torch.profiler: device time by
    kernel (device-side events only, so no kernel is counted twice through the
    op that launched it) and the device's busy share of ``act_ms``, the call's
    median wall time measured without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    details.setdefault("profile", {})[tag] = dict(
        act_ms=act_ms, device_ms=device_ms, busy_share=device_ms / act_ms,
        kernels=[dict(name=k[:120], ms=ms, calls=c) for k, ms, c in rows])
    log(f"[profile] {tag}: device busy {device_ms:.3f} ms of the {act_ms:.3f} ms call "
        f"({100 * device_ms / act_ms:.1f}%)")
    for k, ms, c in rows[:top]:
        log(f"[profile]   {ms:8.3f} ms  x{c:<4d} {k[:90]}")


def dual50(rng, details, timings, n_acts=25):
    import torch
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.ops import cuda as kernels

    cams = ["wrist", "wrist2"]
    cfg_act = act_config(50, which_arm="dominant", arm_pred_loss=True,
                         crop_target_obj_voxel=True, crop_radius=0.3)
    cfg_stab = act_config(50, which_arm="assistive", crop_target_obj_voxel=True,
                          crop_radius=0.3)
    acting = QAttentionBCAgent(cfg_act, cams, SCENE_BOUNDS, device=DEVICE, seed=0)
    stabilizing = QAttentionBCAgent(cfg_stab, cams, SCENE_BOUNDS, device=DEVICE,
                                    seed=1)
    acting.build(training=False)
    stabilizing.build(training=False)

    # the acting policy's Q-field against the plain path on one observation
    refs = {d: reference_model(cfg_act, acting.params, d) for d in ("bfloat16", "float32")}
    inputs = act_inputs(rng, 1, cfg_act.low_dim_size())
    compare_paths(cfg_act, acting.params, refs, inputs, [CROP_BOUNDS], "dual50", details)
    del refs

    def observation(t):
        rgbs, pcds = clouds(rng, 1)
        obs = {"lang_goal_emb": rng.normal(size=(1024,)).astype(np.float32),
               "lang_token_embs": rng.normal(size=(77, 512)).astype(np.float32)}
        for c, r, p in zip(cams, rgbs, pcds):
            obs[f"{c}_rgb"], obs[f"{c}_point_cloud"] = r[0], p[0]
        time_ch = (1.0 - t / (n_acts - 1)) * 2.0 - 1.0
        for arm in ("left", "right"):
            obs[f"low_dim_state_{arm}_arm"] = np.asarray(
                [1.0, 0.02, 0.02, time_ch], np.float32)
        return obs

    episode = [observation(t) for t in range(n_acts)]
    # warm both policies once outside the timed episode
    for agent, arm in ((acting, "dominant"), (stabilizing, "assistive")):
        agent.act(0, episode[0], which_arm=arm, new_scene_bounds=CROP_BOUNDS,
                  dominant_assitive_policy=True)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    walls = []
    for t, obs in enumerate(episode):
        agent, arm = (acting, "dominant") if t % 2 == 0 else (stabilizing, "assistive")
        t0 = time.perf_counter()
        res = agent.act(t, obs, which_arm=arm, new_scene_bounds=CROP_BOUNDS,
                        dominant_assitive_policy=True)
        walls.append((time.perf_counter() - t0) * 1e3)
        a = np.asarray(res.action)
        expect(a.shape == (9,) and bool(np.isfinite(a).all()), "dual50 action")
        idx = np.asarray(res.observation_elements["trans_action_indicies"])
        expect(bool(((idx >= 0) & (idx < 50)).all()), "dual50 trans idx range")
        lo, hi = np.asarray(CROP_BOUNDS[:3]), np.asarray(CROP_BOUNDS[3:])
        expect(bool(((a[:3] >= lo) & (a[:3] <= hi)).all()), "dual50 action in crop")
        expect(abs(float(np.linalg.norm(a[3:7])) - 1.0) < 1e-3, "dual50 quaternion")
    counts = kernels.launch_counts()
    ms = statistics.median(walls)
    profile_act(lambda: acting.act(0, episode[0], which_arm="dominant",
                                   new_scene_bounds=CROP_BOUNDS,
                                   dominant_assitive_policy=True), "dual50_act", details, ms)
    timings["dual50"] = dict(ms_per_act_median=ms, ms_per_act_mean=statistics.mean(walls),
                             acts=n_acts)
    log(f"[dual50] {n_acts}-act dual-policy episode at 50^3: {ms:.3f} ms/act median, "
        f"{statistics.mean(walls):.3f} mean; launches: {counts}")
    return dict(acts=n_acts, launches=counts)


def two_head50(rng, details):
    """One act of the 'one_policy_more_heads' variant at 50^3 (two proprio
    streams, right and left heads, K3 with trans [B,N,N,N,2]): kernels on
    against kernels off under the act-level tolerance, then the act itself."""
    import torch
    from voxactb_tpu_torch.agents.qfunction import make_infer_fn
    from voxactb_tpu_torch.ops import cuda as kernels

    cfg = act_config(50, which_arm="both", variant="one_policy_more_heads",
                     crop_target_obj_voxel=True, crop_radius=0.3)
    model_on, infer = make_infer_fn(cfg, device=DEVICE, seed=2)
    refs = {d: reference_model(cfg, model_on, d) for d in ("bfloat16", "float32")}
    inputs = act_inputs(rng, 1, cfg.proprio_width())
    compare_paths(cfg, model_on, refs, inputs, [CROP_BOUNDS], "two_head50", details)
    del refs
    kernels.reset_launch_counts()
    out = infer(model_on, inputs["rgbs"], inputs["pcds"], inputs["proprio"],
                inputs["lang_goal_emb"], inputs["lang_token_embs"], [CROP_BOUNDS])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    cont = out.continuous_action
    expect(tuple(cont.shape) == (2, 1, 9) and bool(torch.isfinite(cont).all()),
           "two_head50 continuous action")
    expect(bool(((out.trans_idx >= 0) & (out.trans_idx < 50)).all()),
           "two_head50 trans idx range")
    expect(counts["decoder_head"] == 1 and counts["front_fused"] == 1
           and counts["flash_attention"] == 8, f"two_head50 launches {counts}")
    log(f"[two_head50] one act of the two-head variant: right {cont[0, 0, :3].tolist()}, "
        f"left {cont[1, 0, :3].tolist()}; launches: {counts}")
    return dict(acts=1, launches=counts)


# ---------------------------------------------------------------------------
# phase 5: the BC train step
# ---------------------------------------------------------------------------

TRAIN_CAMERAS = ["wrist", "wrist2"]


def train_config(**kw):
    """The configuration the repo trains: 50^3 VLM-cropped grid, bf16, dominant
    arm with the arm loss, SE(3) augmentation, LAMB, trainable attention kernel."""
    from voxactb_tpu_torch.config import MethodConfig

    base = dict(voxel_sizes=[50], which_arm="dominant", arm_pred_loss=True,
                crop_target_obj_voxel=True, crop_radius=0.3, compute_dtype="bfloat16",
                apply_se3=True, pallas_attention_train=True)
    base.update(kw)
    return MethodConfig(**base)


def train_batch(rng, cfg, b):
    """A synthetic replay batch with the bench's signature and value ranges."""
    batch = {
        "trans_action_indicies": rng.integers(0, 50, (b, 3)).astype(np.int32),
        "rot_grip_action_indicies": np.concatenate(
            [rng.integers(0, 72, (b, 3)), rng.integers(0, 2, (b, 1))], -1).astype(np.int32),
        "ignore_collisions": rng.integers(0, 2, (b, 1)).astype(np.int32),
        "gripper_pose": np.concatenate(
            [rng.uniform([-0.1, -0.3, 0.6], [0.4, 0.3, 1.0], (b, 3)),
             rng.normal(size=(b, 4))], -1).astype(np.float32),
        "lang_goal_emb": rng.normal(size=(b, 1024)).astype(np.float32),
        "lang_token_embs": rng.normal(size=(b, 77, 512)).astype(np.float32),
        "low_dim_state": rng.normal(size=(b, cfg.low_dim_size())).astype(np.float32),
        "label": rng.integers(0, 2, (b, 1)).astype(np.int32),
        "scene_bounds": np.asarray([-0.3, -0.5, 0.4, 0.5, 0.5, 1.2], np.float32),
        "target_object_scene_bounds": np.tile(np.asarray(CROP_BOUNDS, np.float32), (b, 1)),
    }
    batch["gripper_pose"][:, 3:] /= np.linalg.norm(batch["gripper_pose"][:, 3:], axis=-1,
                                                   keepdims=True)
    for c in TRAIN_CAMERAS:
        batch[f"{c}_rgb"] = rng.integers(0, 255, (b, IMG, IMG, 3)).astype(np.float32)
        batch[f"{c}_point_cloud"] = rng.uniform(-0.3, 1.2, (b, IMG, IMG, 3)).astype(
            np.float32)
    return batch


def compare_train_paths(batch, details):
    """One step's losses and gradients with dropout and augmentation off:
    kernels on (K4) against the plain attention path at bf16, on the same
    seeded weights. The tolerance is twice the plain bf16 path's own distance
    from the plain path at f32, as at act level: over the losses as one group,
    and per gradient leaf, scaled by the leaf's largest f32 gradient (a leaf
    whose own distance happens to be small gets the median leaf's)."""
    import torch
    from voxactb_tpu_torch.agents.qfunction import make_optimizer, make_train_step

    quiet = dict(apply_se3=False, input_dropout=0.0, attn_dropout=0.0)
    results = {}
    for tag, kw in (("on", {}), ("off", dict(pallas_attention_train=False)),
                    ("f32", dict(pallas_attention_train=False, compute_dtype="float32"))):
        cfg = train_config(**quiet, **kw)
        _, init_fn, step = make_train_step(cfg, make_optimizer(cfg, 100_000),
                                           TRAIN_CAMERAS, device=DEVICE, seed=0)
        metrics, grads = step.loss_and_grads(init_fn(), batch)
        torch.cuda.synchronize()
        results[tag] = ({k: float(v) for k, v in metrics.items()},
                        {k: v.float() for k, v in grads.items()})
        del step, init_fn, metrics, grads
        torch.cuda.empty_cache()
    (m_on, g_on), (m_off, g_off), (m_32, g_32) = (results[t] for t in ("on", "off", "f32"))
    loss_tol = 2.0 * max(abs(m_off[k] - m_32[k]) for k in m_32)
    loss_err = {k: abs(m_on[k] - m_off[k]) for k in m_32}
    scale = {k: float(g_32[k].abs().max()) for k in g_32}
    live = [k for k in g_32 if scale[k] > 0.0]
    plain = {k: max_err(g_off[k], g_32[k]) / scale[k] for k in live}
    kernel = {k: max_err(g_on[k], g_off[k]) / scale[k] for k in live}
    typical = statistics.median(plain.values())
    grad_tol = {k: 2.0 * max(plain[k], typical) for k in live}
    worst = max(kernel, key=lambda k: kernel[k] / grad_tol[k])
    report = dict(losses=m_on, losses_plain=m_off, losses_f32=m_32, loss_err=loss_err,
                  loss_tol=loss_tol, grad_err_worst=kernel[worst],
                  grad_tol_worst=grad_tol[worst], grad_err_worst_leaf=worst,
                  grad_plain_vs_f32_median=typical,
                  grad_plain_vs_f32_worst=max(plain.values()), leaves=len(live),
                  grad_err=kernel, grad_plain_vs_f32=plain)
    details["train_compare"] = report
    log(f"[train50] kernels on vs plain attention path, dropout and aug off: total loss "
        f"{m_on['total_loss']:.5f} vs {m_off['total_loss']:.5f} (f32 {m_32['total_loss']:.5f}"
        f"); largest loss err {max(loss_err.values()):.3g} (tol {loss_tol:.3g}); largest "
        f"gradient err against its tolerance {kernel[worst]:.3g} of the leaf's largest "
        f"gradient, at {worst} (tol {grad_tol[worst]:.3g}; the plain bf16 path is "
        f"{typical:.3g} median, {max(plain.values()):.3g} worst from f32), over "
        f"{len(live)} leaves")
    expect(all(np.isfinite(v) for v in m_on.values()), "train50: non-finite loss")
    expect(max(loss_err.values()) <= loss_tol, f"train50: loss err {loss_err} > {loss_tol}")
    bad = [k for k in live if kernel[k] > grad_tol[k]]
    expect(not bad, f"train50: gradients beyond tolerance in {bad}")


def train50(rng, details, timings, n_steps=10, warm=2):
    import torch
    from voxactb_tpu_torch.agents.qattention_agent import QAttentionBCAgent
    from voxactb_tpu_torch.agents.qfunction import make_optimizer, make_train_step
    from voxactb_tpu_torch.ops import cuda as kernels

    b = 8
    cfg = train_config()
    batch = train_batch(rng, cfg, b)
    compare_train_paths(batch, details)

    dev = torch.device(DEVICE)
    _, init_fn, step = make_train_step(cfg, make_optimizer(cfg, 100_000), TRAIN_CAMERAS,
                                       device=DEVICE, seed=0)
    device_batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    def run(seed, timed):
        """warm + n_steps steps from the seeded weights; losses of every step,
        and the wall time of each step after the warm ones."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = init_fn()
        losses, walls = [], []
        for i in range(warm + n_steps):
            if timed and i == warm:
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = step(state, device_batch, gen)
            if timed:
                torch.cuda.synchronize()
                if i >= warm:
                    walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["total_loss"])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        return [float(x) for x in losses], walls, counts, state

    torch.cuda.reset_peak_memory_stats()
    losses, walls, counts, state = run(0, True)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    expect(all(np.isfinite(losses)), f"train50: non-finite loss in {losses}")
    expect(losses[-1] < losses[0], f"train50: loss did not fall: {losses}")
    expect(counts["flash_attention_train_fwd"] == 8 * n_steps
           and counts["flash_attention_train_bwd"] == 8 * n_steps,
           f"train50: launches {counts} in {n_steps} steps")
    ms = statistics.median(walls)
    # the same chain without a sync after every step
    t0 = time.perf_counter()
    again, _, _, _ = run(0, False)
    chain_ms = (time.perf_counter() - t0) * 1e3 / (warm + n_steps)
    spread = max(abs(a - b_) for a, b_ in zip(losses, again))
    bit_equal = losses == again
    # K4 has no atomics, but the voxel scatter (index_add_) and cuDNN's weight
    # gradients sum in an order that changes from run to run, and the steps
    # that follow amplify a last-bit difference: the first step must agree, the
    # spread over the run is reported
    expect(abs(losses[0] - again[0]) <= 1e-3 * abs(losses[0]),
           f"train50: a second run from the same seed starts at {again[0]}, not "
           f"{losses[0]}")
    timings["train50_b8"] = dict(ms_per_step=ms, samples_per_s=b / ms * 1e3,
                                 ms_per_step_unsynced_chain=chain_ms, steps=n_steps,
                                 losses=losses, second_run_losses=again,
                                 second_run_bit_equal=bit_equal,
                                 second_run_max_loss_diff=spread, peak_memory_gib=peak_gb,
                                 walls_ms=walls)
    log(f"[train50] batch {b}, {n_steps} steps after {warm} warm ones, SE(3) aug and "
        f"dropout on: {ms:.3f} ms/step median ({b / ms * 1e3:.3f} samples/s; "
        f"{chain_ms:.3f} ms/step without a sync per step); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; second run from the same seed "
        + ("bit-equal" if bit_equal else f"differs by at most {spread:.3g} (first step by "
           f"{abs(losses[0] - again[0]):.3g})") + f"; peak memory "
        f"{peak_gb:.2f} GiB; launches: {counts}")
    gen = torch.Generator(device=dev).manual_seed(5)
    profile_act(lambda: step(state, device_batch, gen), "train50_step", details, ms)
    del state, step, init_fn
    torch.cuda.empty_cache()

    # through the agent
    agent = QAttentionBCAgent(cfg, TRAIN_CAMERAS, SCENE_BOUNDS, batch_size=b,
                              training_iterations=100_000, device=DEVICE, seed=0)
    agent.build(training=True)
    kernels.reset_launch_counts()
    agent_losses = [float(agent.update(i, dict(batch))["total_loss"]) for i in range(2)]
    agent_counts = kernels.launch_counts()
    expect(all(np.isfinite(agent_losses)), f"train50: agent.update losses {agent_losses}")
    expect(agent_counts["flash_attention_train_fwd"] == 16
           and agent_counts["flash_attention_train_bwd"] == 16,
           f"train50: agent.update launches {agent_counts}")
    names = {s_.name for s_ in agent.update_summaries()}
    expect(any(n.endswith("losses/grad_norm") for n in names), "train50: agent summaries")
    log(f"[train50] agent.update x2: losses {agent_losses}; launches: {agent_counts}")
    timings["train50_b8"]["agent_update_losses"] = agent_losses
    del agent
    torch.cuda.empty_cache()
    return dict(steps=n_steps, launches={k: counts[k] + agent_counts[k] for k in counts},
                per_step={k: counts[k] // n_steps for k in counts})


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from voxactb_tpu_torch.agents.qfunction import build_encoder
    from voxactb_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)
    details = {}
    timings = {}

    # phase 1
    card = nvidia_smi_line()
    build_s = build.build_all()
    regs = [line.strip() for log_ in build.BUILD_LOG.values() for line in log_.splitlines()
            if "registers" in line or "spill" in line]
    details["build"] = dict(seconds=build_s, ptxas=regs)
    log(f"[build] {card}; kernels built in {build_s:.1f} s")
    for line in regs:
        log(f"[build] {line}")

    # phase 2 (weights of the act path's own seeded models)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    attn = {}
    for n in (50, 100):
        model = build_encoder(act_config(n, which_arm="right"), device=DEVICE, seed=0)
        d0 = check_front(model, n, 1, rng, details)
        check_decoder(model, d0, rng, details)
        if n == 50:
            check_decoder(model, d0, rng, details, heads=2)
        attn[n] = check_attention(1, (n // 5) ** 3, rng, details)
        del model, d0
        torch.cuda.empty_cache()
    train_attn = check_attention_train(rng, details)
    log(f"[kernels] checks took {time.perf_counter() - t0:.1f} s")

    runs = {}
    t0 = time.perf_counter()
    runs["act100"] = act100(rng, details, timings)
    log(f"[act100] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    runs["dual50"] = dual50(rng, details, timings)
    runs["two_head50"] = two_head50(rng, details)
    log(f"[dual50] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    runs["train50"] = train50(rng, details, timings)
    log(f"[train50] took {time.perf_counter() - t0:.1f} s")

    # phase 6: every kernel was launched on the main path that runs it
    act_kernels = ("front_fused", "flash_attention", "decoder_head")
    train_kernels = ("flash_attention_train_fwd", "flash_attention_train_bwd")
    total = {k: 0 for k in act_kernels + train_kernels}
    for name, run in runs.items():
        for k in train_kernels if name == "train50" else act_kernels:
            v = run["launches"][k]
            total[k] += v
            expect(v > 0, f"kernel {k} was not launched on the main path {name}")
    f100 = details["front_fused"][-1]
    d100 = details["decoder_head"][-1]
    a100 = attn[100]  # B = 1: one cross, six self, one decoder attention per act
    per_act = lambda key: (a100["cross"][key] + 6 * a100["self"][key]
                           + a100["decoder"][key])
    # batch 8 at 50^3: one cross, six self, one decoder attention per train step
    per_step = lambda key: (train_attn["cross"][key] + 6 * train_attn["self"][key]
                            + train_attn["decoder"][key])
    kernels_line = {"kernels": [
        dict(name="front_fused", route="cuda",
             source="voxactb_tpu_torch/csrc/front_fused.cu",
             replaces="voxactb_tpu/ops/pallas/front_fused.py:303",
             launches=total["front_fused"], max_abs_err=max(
                 r["max_abs_err"] for r in details["front_fused"]),
             ms=f100["ms"], plain_ms=f100["plain_ms"], bound_ms=f100["bound_ms"],
             bound_by=f100["bound_by"], library_ms=None),
        dict(name="flash_attention", route="cuda",
             source="voxactb_tpu_torch/csrc/flash_attention.cu",
             replaces="voxactb_tpu/ops/pallas/flash_attention.py:61",
             launches=total["flash_attention"], max_abs_err=max(
                 r[s]["max_abs_err"] for r in details["flash_attention"]
                 for s in ("cross", "self", "decoder", "tail")),
             ms=per_act("ms"), plain_ms=per_act("plain_ms"),
             bound_ms=per_act("bound_ms"), bound_by="operations",
             library_ms=per_act("library_ms")),
        dict(name="decoder_head", route="cuda",
             source="voxactb_tpu_torch/csrc/decoder_head.cu",
             replaces="voxactb_tpu/ops/pallas/decoder_head_v2.py:40",
             launches=total["decoder_head"], max_abs_err=max(
                 r["max_abs_err"] for r in details["decoder_head"]),
             ms=d100["ms"], plain_ms=d100["plain_ms"], bound_ms=d100["bound_ms"],
             bound_by=d100["bound_by"], library_ms=None),
        dict(name="flash_attention_train_fwd", route="cuda",
             source="voxactb_tpu_torch/csrc/flash_attention_train.cu",
             replaces="voxactb_tpu/ops/pallas/flash_attention.py:140",
             launches=total["flash_attention_train_fwd"], max_abs_err=max(
                 r[f"dropout_{d}"]["out"]["max_abs_err"] for r in train_attn.values()
                 for d in (0.0, 0.1)),
             ms=per_step("fwd_ms"), plain_ms=per_step("plain_fwd_ms"),
             bound_ms=per_step("fwd_bound_ms"), bound_by="operations",
             library_ms=per_step("sdpa_fwd_ms")),
        dict(name="flash_attention_train_bwd", route="cuda",
             source="voxactb_tpu_torch/csrc/flash_attention_train.cu",
             replaces="voxactb_tpu/ops/pallas/flash_attention.py:164",
             launches=total["flash_attention_train_bwd"], max_abs_err=max(
                 r[f"dropout_{d}"][g]["max_abs_err"] for r in train_attn.values()
                 for d in (0.0, 0.1) for g in ("dq", "dk", "dv")),
             ms=per_step("bwd_ms"), plain_ms=per_step("plain_bwd_ms"),
             bound_ms=per_step("bwd_bound_ms"), bound_by="operations",
             library_ms=per_step("sdpa_bwd_ms")),
    ]}
    details["timings"] = timings
    details["runs"] = runs
    details["card"] = card
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)
    log(json.dumps(kernels_line))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
