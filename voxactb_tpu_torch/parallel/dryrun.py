"""The train step over several processes: the tiny set-up, the worker, the
two-process rendezvous, and a runner of meshes in spawned ranks.

Counterpart of ``voxactb_tpu.parallel.dryrun``. The reference runs N
processes with a TCP rendezvous and DDP over gloo (peract/train.py:95-105,
run_seed_fn.py:34-36); here one process is one rank of a ``torch.distributed``
group (gloo on the CPU and for ranks that share a card, NCCL across cards),
and ``parallel.mesh`` splits the step over them.

- ``tiny_train_setup``: the JAX dry run's config, cameras and numpy-seeded
  batch;
- ``run_worker``: one rank of an ``num_processes``-way data-parallel run
  (``python -m voxactb_tpu_torch.parallel.dryrun``), printing rank 0's losses;
- ``spawn_two_process_dryrun``: two such processes on this machine;
- ``run_job`` / ``spawn_jobs``: a list of meshes (``Job``), each run a few
  steps from one seeded state, in one process or in ``world`` spawned ranks,
  with their metrics, whole parameters, placement and times.

Every wait has a time limit, and a rank that fails fails the run.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

CAMERAS = ["wrist", "wrist2"]

# the JAX worker's options that one process per rank leaves without a use
NO_COUNTERPART = {
    "--local-devices": "one process is one rank: a process drives one device (or the "
                       "CPU), so there are no virtual devices per process",
    "--coordinator": "the rendezvous is torch.distributed's init_method (--init-method: a "
                     "file:// store on this machine, or tcp://host:port)",
}


def tiny_config(**overrides):
    """``dryrun.py:29``'s method config (apply ``overrides`` on top)."""
    from voxactb_tpu_torch.config import MethodConfig

    kw = dict(voxel_sizes=[10], num_latents=16, latent_dim=32, transformer_depth=1,
              cross_dim_head=16, latent_dim_head=16, final_dim=8, which_arm="dominant",
              arm_pred_loss=True, apply_se3=True)
    kw.update(overrides)
    return MethodConfig(**kw)


def tiny_batch(cfg, batch_size: int, img: int = 8) -> Dict[str, np.ndarray]:
    """``dryrun.py:44``'s batch: the same numpy stream, array for array."""
    rng = np.random.default_rng(0)
    b = batch_size
    batch = {
        "trans_action_indicies": rng.integers(0, 10, (b, 3)).astype(np.int32),
        "rot_grip_action_indicies": np.concatenate(
            [rng.integers(0, 72, (b, 3)), rng.integers(0, 2, (b, 1))], -1).astype(np.int32),
        "ignore_collisions": rng.integers(0, 2, (b, 1)).astype(np.int32),
        "gripper_pose": np.concatenate(
            [rng.uniform([-0.3, -0.5, 0.5], [0.7, 0.5, 1.5], (b, 3)),
             rng.normal(size=(b, 4))], -1).astype(np.float32),
        "lang_goal_emb": rng.normal(size=(b, 1024)).astype(np.float32),
        "lang_token_embs": rng.normal(size=(b, 77, 512)).astype(np.float32),
        "low_dim_state": rng.normal(size=(b, cfg.low_dim_size())).astype(np.float32),
        "label": rng.integers(0, 2, (b, 1)).astype(np.int32),
        "scene_bounds": np.asarray([-0.8, -1.0, 0.1, 1.2, 1.0, 2.1], np.float32),
    }
    batch["gripper_pose"][:, 3:] /= np.linalg.norm(batch["gripper_pose"][:, 3:], axis=-1,
                                                   keepdims=True)
    for c in CAMERAS:
        batch[f"{c}_rgb"] = rng.integers(0, 255, (b, img, img, 3)).astype(np.float32)
        batch[f"{c}_point_cloud"] = rng.uniform(-0.5, 1.5, (b, img, img, 3)).astype(
            np.float32)
    return batch


def tiny_train_setup(batch_size: int, img: int = 8, *, device="cpu", **overrides):
    """``(cfg, init_fn, train_step, batch)`` of the JAX dry run's set-up."""
    from voxactb_tpu_torch.agents.qfunction import make_optimizer, make_train_step

    cfg = tiny_config(**overrides)
    optimizer = make_optimizer(cfg, training_iterations=100)
    _, init_fn, train_step = make_train_step(cfg, optimizer, CAMERAS, device=device)
    return cfg, init_fn, train_step, tiny_batch(cfg, batch_size, img)


# -- meshes run as jobs -------------------------------------------------------------


def job(name: str, mesh: Dict[str, int], *, fsdp: bool = False, model_parallel: bool = False,
        steps: int = 3, cfg: Optional[dict] = None, batch: Optional[str] = None,
        batch_size: Optional[int] = None, cameras=None, fault: Optional[str] = None,
        init: Optional[str] = None, seed: int = 1, training_iterations: int = 100,
        first_params: bool = False, update_check: bool = False) -> dict:
    """A mesh to run: ``steps`` steps of the train step built from ``cfg``
    (``tiny_config`` overrides, or with ``"full": True`` a whole
    ``MethodConfig``'s keywords) on the batch saved at ``batch`` (a
    ``torch.save``d dict of arrays; None: ``tiny_batch`` of ``batch_size``),
    from the seeded weights or the parameters saved at ``init``, drawing from
    a generator seeded with ``seed`` on the rank's device. ``first_params``
    also keeps the parameters after the first step; ``update_check`` first
    applies the optimizer once to seeded gradients (``check_gradients``) and
    keeps the parameters it gives (``update_params``)."""
    return dict(name=name, mesh=dict(mesh), fsdp=fsdp, model_parallel=model_parallel,
                steps=steps, cfg=dict(cfg or {}), batch=batch, batch_size=batch_size,
                cameras=list(cameras or CAMERAS), fault=fault, init=init, seed=seed,
                training_iterations=training_iterations, first_params=first_params,
                update_check=update_check)


def check_gradients(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Seeded normal gradients of the parameters' shapes, on their device,
    with the scale of each parameter's entries."""
    g = torch.Generator().manual_seed(7)
    return {k: (torch.randn(v.shape, generator=g)
                * (float(v.detach().std(correction=0)) + 1e-3)).to(v.device)
            for k, v in params.items()}


def _build(spec: dict, device):
    from voxactb_tpu_torch.agents.qfunction import make_optimizer, make_train_step
    from voxactb_tpu_torch.config import MethodConfig

    kw = dict(spec["cfg"])
    cfg = MethodConfig(**{k: v for k, v in kw.items() if k != "full"}) if kw.get("full") \
        else tiny_config(**kw)
    optimizer = make_optimizer(cfg, training_iterations=spec["training_iterations"])
    _, init_fn, train_step = make_train_step(cfg, optimizer, spec["cameras"], device=device)
    if spec["batch"]:
        batch = torch.load(spec["batch"], weights_only=False)
    else:
        batch = tiny_batch(cfg, spec["batch_size"])
    if spec["init"]:
        saved = torch.load(spec["init"], weights_only=False)
        seeded = init_fn

        def init_fn():
            state = seeded()
            params = {k: saved[k].to(device=v.device, dtype=v.dtype)
                      for k, v in state.params.items()}
            return state._replace(params=params)
    return init_fn, train_step, batch


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_job(spec: dict, device="cpu") -> dict:
    """The job on ONE process at the global batch (its mesh ignored): the
    reference the ranks are held to. ``metrics``: per step, name -> float;
    ``params``: the parameters after the last step (``params_first``: after
    the first), on the CPU."""
    from voxactb_tpu_torch.ops import cuda as kernels

    init_fn, train_step, batch = _build(spec, device)
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    state = init_fn()
    updated = None
    if spec["update_check"]:
        new, _ = train_step.optimizer.update(check_gradients(state.params), state.opt_state,
                                             state.params)
        updated = _cpu(new)
    kernels.reset_launch_counts()
    metrics, walls, first = [], [], None
    for i in range(spec["steps"]):
        _sync(device)
        t0 = time.perf_counter()
        state, m = train_step(state, batch, gen)
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0 and spec["first_params"]:
            first = _cpu(state.params)
    return dict(name=spec["name"], metrics=metrics, ms_per_step=walls,
                launches=dict(kernels.launch_counts()), params=_cpu(state.params),
                params_first=first, update_params=updated)


def _cpu(params) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float().cpu() for k, v in params.items()}


def _run_rank_job(spec: dict, device) -> dict:
    import torch.distributed as dist

    from voxactb_tpu_torch.ops import cuda as kernels
    from voxactb_tpu_torch.parallel.mesh import make_mesh, make_parallel_train_step

    init_fn, train_step, batch = _build(spec, device)
    mesh = make_mesh(spec["mesh"])
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    state, place, step = make_parallel_train_step(
        mesh, init_fn, train_step, batch, gen, fsdp=spec["fsdp"],
        model_parallel=spec["model_parallel"], fault=spec["fault"])
    placed = place(batch)
    updated = None
    if spec["update_check"]:
        full = step.full_params(state)
        updated = _cpu(step.full_params(step.update_from(state, check_gradients(full))))
        del full
    kernels.reset_launch_counts()
    metrics, walls, first = [], [], None
    for i in range(spec["steps"]):
        _sync(device)
        t0 = time.perf_counter()
        state, m = step(state, placed)
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0 and spec["first_params"]:
            first = _cpu(step.full_params(state))
    launches = [None] * dist.get_world_size()
    dist.all_gather_object(launches, dict(kernels.launch_counts()))
    held = step.sharded_bytes(state)
    params = _cpu(step.full_params(state))
    plans = {n: None if p.shard is None else
             dict(dim=p.shard.dim, axis=p.shard.axis, compute=p.compute)
             for n, p in step.plans.items()}
    return dict(name=spec["name"], metrics=metrics, ms_per_step=walls, launches=launches,
                params=params, params_first=first, update_params=updated, plans=plans, sharded_bytes=held,
                n_sharded=sum(p is not None for p in plans.values()),
                mesh=spec["mesh"], rows=[step.rows.start, step.rows.stop])


def _jobs_worker(rank: int, world: int, init_method: str, jobs: List[dict], out: str,
                 backend: str, device: str, timeout_s: float) -> None:
    """One spawned rank: every job in turn; rank 0 saves the results. Over
    NCCL each rank takes a card of its own (rank modulo the cards)."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    if backend == "nccl" and torch.device(device).type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        results = [_run_rank_job(spec, device) for spec in jobs]
        if rank == 0:
            torch.save(results, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_jobs(world: int, jobs: List[dict], *, workdir: Optional[str] = None,
               timeout: float = 300.0, backend: str = "gloo", device: str = "cpu") -> List[dict]:
    """Run ``jobs`` in ``world`` spawned ranks (``_jobs_worker``), rendezvous
    through a ``file://`` store in ``workdir`` (a new temporary directory by
    default); returns rank 0's results. Raises when a rank fails, and kills
    every rank when the run outlasts ``timeout`` seconds."""
    import torch.multiprocessing as mp

    workdir = workdir or tempfile.mkdtemp(prefix="voxactb_ranks_")
    store = os.path.join(workdir, f"rendezvous_{time.time_ns()}")
    out = os.path.join(workdir, f"results_{time.time_ns()}.pt")
    ctx = mp.start_processes(_jobs_worker, args=(world, f"file://{store}", jobs, out, backend,
                                                 device, timeout),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish {[j['name'] for j in jobs]} "
                                   f"in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return torch.load(out, weights_only=False)


# -- the worker and the two-process rendezvous ---------------------------------------


def run_worker(process_id: int, num_processes: int, init_method: str, steps: int = 3, *,
               batch_size: Optional[int] = None, timeout_s: float = 300.0) -> List[float]:
    """One rank of the data-parallel dry run on the CPU, over gloo: the tiny
    set-up at a global batch of ``batch_size`` (default one row per rank),
    ``steps`` steps; rank 0 prints each step's loss. Returns the losses."""
    import torch.distributed as dist

    from voxactb_tpu_torch.parallel.mesh import make_mesh, make_parallel_train_step

    if steps < 1:
        raise ValueError(f"steps must be positive, got {steps}")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=process_id,
                            world_size=num_processes,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        _, init_fn, train_step, batch = tiny_train_setup(batch_size or num_processes)
        mesh = make_mesh({"dp": num_processes})
        gen = torch.Generator().manual_seed(1)
        state, place, step = make_parallel_train_step(mesh, init_fn, train_step, batch, gen)
        placed = place(batch)
        losses = []
        for i in range(steps):
            state, metrics = step(state, placed)
            loss = float(metrics["total_loss"])
            losses.append(loss)
            if process_id == 0:
                print(f"distributed step {i}: loss={loss:.6f}", flush=True)
        if not all(np.isfinite(losses)):
            raise FloatingPointError(f"non-finite losses {losses}")
        if process_id == 0:
            print(f"distributed dryrun OK: {num_processes} processes, losses={losses}",
                  flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return losses


def _tail(text: str, n: int = 3000) -> str:
    return text[-n:]


def spawn_two_process_dryrun(n_devices: int, steps: int = 3, timeout: int = 900) -> List[float]:
    """Launch two ``python -m voxactb_tpu_torch.parallel.dryrun`` ranks on this
    machine at a global batch of ``n_devices``; returns rank 0's losses.
    Raises, with the worker's tail, when a rank exits non-zero (the other is
    then killed) or the pair outlasts ``timeout`` seconds."""
    if n_devices % 2:
        raise ValueError("need an even device count for 2 processes")
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    workdir = tempfile.mkdtemp(prefix="voxactb_dryrun_")
    init_method = f"file://{os.path.join(workdir, 'rendezvous')}"
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "voxactb_tpu_torch.parallel.dryrun", "--process-id", str(r),
         "--num-processes", "2", "--init-method", init_method, "--steps", str(steps),
         "--batch-size", str(n_devices), "--timeout", str(timeout)],
        cwd=repo_root, env=env, stdout=logs[r], stderr=subprocess.STDOUT, text=True)
        for r in range(2)]

    def output(r):
        logs[r].flush()
        logs[r].seek(0)
        return logs[r].read()

    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed:
                r = failed[0]
                raise RuntimeError(f"distributed worker {r} rc={procs[r].returncode}:\n"
                                   f"{_tail(output(r))}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"distributed worker timed out:\n{_tail(output(0))}")
            time.sleep(0.2)
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"distributed worker {r} rc={p.returncode}:\n"
                                   f"{_tail(output(r))}")
        out = output(0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    losses = [float(line.rsplit("=", 1)[1]) for line in out.splitlines()
              if line.startswith("distributed step")]
    if len(losses) != steps:
        raise RuntimeError(f"rank 0 printed {len(losses)} losses, expected {steps}:\n"
                           f"{_tail(out)}")
    return losses


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--init-method", required=True,
                    help="torch.distributed rendezvous: file:///path or tcp://host:port")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=None,
                    help="global batch (default: one row per process)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait for a peer")
    args = ap.parse_args(argv)
    run_worker(args.process_id, args.num_processes, args.init_method, args.steps,
               batch_size=args.batch_size, timeout_s=args.timeout)


if __name__ == "__main__":
    main()
