"""Entry points of the port: the flagship act program with its example
arguments, and the train step's dry run over several CPU ranks.

Counterpart of the repo's ``__graft_entry__.py``:

- ``entry()``: ``(infer, example_args)``, ``make_infer_fn``'s act program at
  the canonical VoxAct-B config (50^3 crop, 2048 latents, depth 6, two 128^2
  cameras, bf16) with ``bench.py``'s kernel flags, so that the act runs the
  fused front (K1), the flash attention (K2) and the decoder tail (K3);
  ``infer(*example_args)`` acts;
- ``dryrun_multichip(n)``: the BC train step split over ``n`` CPU ranks on
  gloo (``parallel.dryrun.spawn_jobs``), in the JAX dry run's four passes with
  its tolerances: dp x fsdp; dp x tp 2 x sp 2 (loss trajectory and the
  parameters after three steps held to the first pass); two real processes
  (``spawn_two_process_dryrun``); and the 256-latent config, whose large
  leaves really shard over fsdp, held to its dp run.

    python3 -m voxactb_tpu_torch.graft_entry [N]   # the dry run, N = 8 by default
"""

from __future__ import annotations

import sys

import numpy as np

N_STEPS = 3
BIG = dict(num_latents=256, latent_dim=256, cross_dim_head=32, latent_dim_head=32)


def entry_config(**overrides):
    """``__graft_entry__.py:17``'s config with ``bench.py``'s kernel flags."""
    from voxactb_tpu_torch.config import MethodConfig

    kw = dict(voxel_sizes=[50], which_arm="dominant", arm_pred_loss=True,
              crop_target_obj_voxel=True, crop_radius=0.3, compute_dtype="bfloat16",
              pallas_front=True, pallas_encoder=True, pallas_decoder=True,
              pallas_attention=True)
    kw.update(overrides)
    return MethodConfig(**kw)


def entry(*, device=None, img: int = 128, **overrides):
    """``(infer, example_args)``: the act program and one observation (batch
    1, two cameras, numpy seed 0, weights from seed 0) on ``device`` (the card
    by default). ``img`` and ``overrides`` shrink it for a CPU run."""
    from voxactb_tpu_torch.agents.qfunction import make_infer_fn

    cfg = entry_config(**overrides)
    model, infer = make_infer_fn(cfg, device=device, seed=0)
    rng = np.random.default_rng(0)
    b = 1
    rgbs = tuple(rng.integers(0, 255, (b, img, img, 3)).astype(np.float32) for _ in range(2))
    pcds = tuple(rng.uniform(-0.5, 1.5, (b, img, img, 3)).astype(np.float32)
                 for _ in range(2))
    proprio = rng.normal(size=(b, cfg.low_dim_size())).astype(np.float32)
    lang_goal = rng.normal(size=(b, 1024)).astype(np.float32)
    lang_tok = rng.normal(size=(b, 77, 512)).astype(np.float32)
    bounds = np.asarray([[-0.1, -0.3, 0.5, 0.5, 0.3, 1.1]], np.float32)
    return infer, (model, rgbs, pcds, proprio, lang_goal, lang_tok, bounds)


def _close(a, b_) -> bool:
    return abs(a - b_) < 0.01 * (abs(a) + 1.0)


def _losses(result):
    return [m["total_loss"] for m in result["metrics"]]


def dryrun_multichip(n_devices: int, *, timeout: float = 900.0) -> dict:
    """The four passes over ``n_devices`` CPU ranks; raises on a failed
    check, returns each pass's losses."""
    from voxactb_tpu_torch.parallel.dryrun import job, spawn_jobs, spawn_two_process_dryrun

    fsdp = 2 if n_devices % 2 == 0 else 1
    jobs = [job("dp_fsdp", {"dp": n_devices // fsdp, "fsdp": fsdp}, fsdp=True,
                batch_size=n_devices, steps=N_STEPS)]
    if n_devices % 4 == 0:
        jobs.append(job("dp_tp_sp", {"dp": n_devices // 4, "tp": 2, "sp": 2},
                        model_parallel=True, batch_size=n_devices, steps=N_STEPS))
    if n_devices % 2 == 0:
        jobs += [job("big_dp", {"dp": n_devices}, batch_size=n_devices, cfg=BIG,
                     steps=N_STEPS),
                 job("big_fsdp", {"dp": n_devices // 2, "fsdp": 2}, fsdp=True,
                     batch_size=n_devices, cfg=BIG, steps=N_STEPS)]
    res = {r["name"]: r for r in spawn_jobs(n_devices, jobs, timeout=timeout)}
    out = {}

    dp = res["dp_fsdp"]
    losses_dp = _losses(dp)
    assert all(np.isfinite(losses_dp)), losses_dp
    out["dp_fsdp"] = losses_dp
    print(f"dryrun_multichip({n_devices}): mesh={dp['mesh']} "
          f"losses={[round(v, 4) for v in losses_dp]} OK", flush=True)

    if "dp_tp_sp" in res:
        mp = res["dp_tp_sp"]
        losses_mp = _losses(mp)
        assert all(np.isfinite(losses_mp)), losses_mp
        for i, (a, b_) in enumerate(zip(losses_dp, losses_mp)):
            assert _close(a, b_), f"tp/sp loss diverges from dp at step {i}: {a} vs {b_}"
        for k, a in dp["params"].items():
            np.testing.assert_allclose(a.numpy(), mp["params"][k].numpy(), atol=2e-3,
                                       rtol=2e-3, err_msg=k)
        out["dp_tp_sp"] = losses_mp
        print(f"dryrun_multichip({n_devices}): mesh={mp['mesh']} "
              f"losses={[round(v, 4) for v in losses_mp]} OK (tp/sp trajectory + "
              f"updated-params parity; {mp['n_sharded']} parameters split)", flush=True)

    if n_devices % 2 == 0:
        losses_2p = spawn_two_process_dryrun(n_devices, steps=N_STEPS, timeout=int(timeout))
        assert all(np.isfinite(losses_2p)), losses_2p
        for i, (a, b_) in enumerate(zip(losses_dp, losses_2p)):
            assert _close(a, b_), f"2-process loss diverges from dp at step {i}: {a} vs {b_}"
        out["two_process"] = losses_2p
        print(f"dryrun_multichip({n_devices}): 2 processes (torch.distributed, gloo) "
              f"losses={[round(v, 4) for v in losses_2p]} OK (multi-process parity)",
              flush=True)

        big_dp, big_fs = res["big_dp"], res["big_fsdp"]
        n_sharded = big_fs["n_sharded"]
        assert n_sharded > 0, "no parameter leaf actually sharded over fsdp"
        for i, (a, b_) in enumerate(zip(_losses(big_dp), _losses(big_fs))):
            assert _close(a, b_), f"fsdp loss diverges from dp at step {i}: {a} vs {b_}"
        out["big_fsdp"] = _losses(big_fs)
        print(f"dryrun_multichip({n_devices}): 256-latent fsdp ({n_sharded} sharded "
              f"parameters) losses={[round(v, 4) for v in out['big_fsdp']]} OK (dp parity)",
              flush=True)
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
