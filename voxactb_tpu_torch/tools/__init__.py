"""The port's measurement tools, counterparts of the JAX package's ``tools/``.

- ``profile_stages``: per-stage latency of the act program's building blocks
  at 100^3 (``python3 -m voxactb_tpu_torch.tools.profile_stages``);
- ``profile_quick``: its decoder-path subset with the whole Q-forward;
- ``probe_smem``: the shared-memory scratch a kernel can take, and the 9-tap
  shifted-window matmul (``tools/probe_vmem.py``'s counterpart);
- ``roofline``: the card's measured memory and bf16 matmul rates;
- ``cost_model``: analytic FLOPs and bytes at the H100's peaks;
- ``probe_sweep``: variants of the copy and shifted-window probe kernels
  (``csrc/probes.cu``) built and timed in turns on the card;
- the policy-diagnosis probes: ``probe_replay_ambiguity``,
  ``probe_replay_accuracy``, ``probe_policy_open_loop``, ``probe_input_diff``
  and ``probe_hybrid_inputs``;
- ``profile_train`` and ``profile_sam``: the train step's and the SAM image
  encoder's stages (``--bwd-split [--flash-train]``, ``--stage``);
- the root probes: ``probe_op_floor`` (the fixed cost per dependent launch and
  one act's launches), ``probe_act_ab`` (K2 on and off in act chains),
  ``probe_decoder_ab`` (K8 against cuDNN ``up0`` + K3), ``probe_decoder_parts``
  (K3's launches beside P1's stream floor), ``probe_front_batch`` (K1 against
  the plain front, K3 at batch 8) and ``probe_front_matmul`` (the front stage
  and its act chain). A key of the JAX tool that has no counterpart here is
  listed, with the reason, in the tool's ``NO_COUNTERPART``.

The helpers below are what the timed tools share: inputs synthesized on the
device from a seed, chains of steps that each read a fresh input slice and
reduce their outputs to an f32 sum (the JAX tools' ``lax.scan``), a timer
that reads CUDA events on the card and the host clock elsewhere, and the
profiler's device time per call.
"""

from __future__ import annotations

import json
import time

import torch


def device_line(dev: torch.device) -> dict:
    """What a timed tool ran on: the card's name, or the CPU."""
    if dev.type == "cuda":
        return {"device": torch.cuda.get_device_name(dev), "count": torch.cuda.device_count()}
    return {"device": "cpu"}


def emit(record: dict) -> dict:
    print(json.dumps(record), flush=True)
    return record


def device_normal(shape, seed: int, dev: torch.device, dtype=torch.bfloat16,
                  std: float = 1.0) -> torch.Tensor:
    """``std`` x standard normals of ``shape`` in ``dtype``, drawn on ``dev``
    from ``torch.Generator`` seeded with ``seed``, one leading slice at a time
    (no float32 copy of the whole tensor)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = torch.empty(shape, dtype=dtype, device=dev)
    for i in range(shape[0]):
        out[i] = torch.randn(shape[1:], generator=g, device=dev) * std
    return out


def leaves(y):
    """The tensors of a (nested) tuple, list or dict of outputs."""
    if isinstance(y, torch.Tensor):
        return [y]
    if isinstance(y, dict):
        y = list(y.values())
    return [t for v in y if v is not None for t in leaves(v)]


def chain(inp, fn, n_chain: int) -> torch.Tensor:
    """``fn`` on slices 0 .. n_chain - 1 of ``inp`` (a tensor or a tuple of
    tensors with a leading chain axis), each step's outputs reduced to an f32
    sum; the ``[n_chain]`` sums."""
    tots = []
    for i in range(n_chain):
        xs = tuple(t[i] for t in inp) if isinstance(inp, tuple) else inp[i]
        tots.append(sum(t.sum(dtype=torch.float32) for t in leaves(fn(xs))))
    return torch.stack(tots)


def seconds(fn, dev: torch.device) -> float:
    """Seconds of one call of ``fn``: between two CUDA events on the card,
    host clock around the call elsewhere."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def device_ms(fn, calls: int, dev: torch.device):
    """Device milliseconds per call of ``fn`` over ``calls`` calls: the sum of
    every device-side activity (kernels, copies, memsets) that
    ``torch.profiler`` records, per call (the program's spans mirrored on the
    device's timeline left out); None off the card."""
    if dev.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(dev)
    total = sum(e.device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return total / calls / 1e3


def warm_seconds(fn, dev: torch.device) -> float:
    """Host seconds of a first (warming) call, to its end on the device:
    kernel builds, library plans and allocations included."""
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def kernel_ms(fn, calls: int, dev: torch.device, names) -> dict:
    """Device milliseconds per call of ``fn`` of the kernels whose name holds
    each of ``names`` (summed over the kernels that match), from the
    profiler over ``calls`` calls; None for each off the card."""
    if dev.type != "cuda":
        return {n: None for n in names}
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(dev)
    events = [e for e in prof.key_averages()
              if e.device_time_total > 0 and not e.is_user_annotation]
    return {n: sum(e.device_time_total for e in events if n in e.key) / calls / 1e3
            for n in names}


def median_ms(fn, dev: torch.device, reps: int = 3, per: int = 1) -> float:
    """Median over ``reps`` calls of ``fn`` (``seconds``), in ms per ``per``."""
    walls = sorted(seconds(fn, dev) for _ in range(reps))
    return walls[len(walls) // 2] * 1e3 / per


SCENE_BOUNDS = [-0.8, -1.0, 0.1, 1.2, 1.0, 2.1]  # bench.py's


def act_observations(rng, n_chain: int, batch: int, dev: torch.device, img: int = 128,
                     low_dim: int = 4):
    """``n_chain`` seeded observations of ``batch`` (bench.py's: two cameras of
    ``img``^2, rgb in [0, 255], points in [-0.5, 1.5]^3) on ``dev``, each a
    tuple for ``make_infer_fn``'s program after its module."""
    def t(x):
        return torch.as_tensor(x.astype("float32"), device=dev)

    obs = []
    for _ in range(n_chain):
        rgbs = tuple(t(rng.integers(0, 255, (batch, img, img, 3))) for _ in range(2))
        pcds = tuple(t(rng.uniform(-0.5, 1.5, (batch, img, img, 3))) for _ in range(2))
        obs.append((rgbs, pcds, t(rng.normal(size=(batch, low_dim))),
                    t(rng.normal(size=(batch, 1024))), t(rng.normal(size=(batch, 77, 512))),
                    torch.tensor([SCENE_BOUNDS], device=dev)))
    return obs


def act_chain(model, infer, obs):
    """The act program over every observation: ``[n_chain, B, 9]`` actions."""
    return torch.stack([infer(model, *o).continuous_action for o in obs])
