"""Meshes of ranks and the BC train step split over them: data parallelism,
FSDP (parameters and moments sharded), Megatron tensor parallelism over the
attention heads and the GEGLU's hidden units, and the latent table sharded
over a sequence axis.

Counterpart of ``voxactb_tpu.parallel.mesh``. There one jitted step runs over
a ``jax.sharding.Mesh`` and GSPMD inserts the collectives. The port's kernels
take raw pointers (``ops/cuda/build.py``), so no distributed tensor can pass
through them: here every rank runs the step on local tensors, and the
collectives around them are named (``parallel/collectives.py``). The
sharding RULES are the JAX package's, applied to the flax layout of each
parameter (``weights.flax_targets``) and mapped onto the port's tensor.

Two kinds of split:

- storage: the rank keeps a slice of the parameter and of both optimizer
  moments, all-gathers the parameter before the forward (the fused kernels
  take whole weights), and keeps its slice of the averaged gradient. This is
  FSDP, the rank-5 conv kernels and ``dense0`` under ``tp``, any attention
  whose heads ``tp`` does not divide, and ``latents`` under ``sp`` (the JAX
  sp spec's storage; the activations are not split over ``sp``);
- compute (Megatron): ``to_q``, ``to_k``, ``to_v`` and ``w_in`` are
  column-parallel, ``to_out`` and ``w_out`` row-parallel; each ``tp`` rank
  runs the attention (K4 on the card) on its own heads, and the row-parallel
  products are summed over ``tp`` (``collectives._Reduce``).

One departure from the JAX layout: flax's fused ``to_kv`` leaf ``[ctx, 2
inner]`` is column-sharded there, which at ``tp`` 2 hands K to one rank and V
to the other; the port keeps ``to_k`` and ``to_v`` apart and shards each by
heads. The spec (dim and axis of the leaf) is the JAX one.

The batch is split over ``dp`` x ``fsdp`` (each rank its rows, in the order
of ``P(("dp", "fsdp"))``) and replicated over ``tp`` and ``sp``; gradients are
averaged over the data ranks. Every rank draws its randomness for the global
batch and keeps its rows, and the dropout masks are indexed by the global
sample and head (``ops/cuda/flash_attention_train.MaskIndex``), so N ranks
take the step one process takes at the global batch. LAMB's trust ratio and
``grad_norm`` take the norms of whole parameters (``Optimizer.update``'s
``sq_reduce``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from voxactb_tpu_torch.parallel import collectives as C

AXES = ("dp", "fsdp", "tp", "sp")
DATA_AXES = ("dp", "fsdp")
FAULTS = ("zero_dropout_offsets", "local_trust_ratio", "summed_grads")


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None, *, device_type: Optional[str] = None):
    """A ``DeviceMesh`` over the ranks of the default process group, with the
    JAX axis names. Default: every rank on ``dp``. ``axis_sizes`` e.g.
    ``{"dp": 2, "fsdp": 2}``; its product must equal the world size.
    ``device_type`` defaults to ``cuda`` over NCCL, else ``cpu`` (the mesh
    only carries the groups: gloo ranks may hold CUDA tensors)."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if not axis_sizes:
        axis_sizes = {"dp": world}
    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[n]) for n in names)
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {axis_sizes} != {world} ranks")
    unknown = [n for n in names if n not in AXES]
    if unknown:
        raise ValueError(f"mesh axes {unknown} are none of {AXES}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(sizes), mesh_dim_names=names)


def axis_size(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_coord(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names
    return mesh.get_coordinate()[names.index(axis)] if axis in names else 0


def axis_group(mesh, axes: Sequence[str]):
    """The process group of this rank's ranks along ``axes`` (the others
    fixed), made once per mesh. Every rank makes every group of the mesh, in
    one order."""
    names = mesh.mesh_dim_names
    axes = tuple(a for a in names if a in axes)
    if not hasattr(mesh, "_axis_groups"):
        mesh._axis_groups = {}
    cache = mesh._axis_groups
    if axes not in cache:
        ranks = mesh.mesh
        moved = ranks.permute([names.index(a) for a in names if a not in axes]
                              + [names.index(a) for a in axes])
        rows = moved.reshape(-1, int(np.prod([axis_size(mesh, a) for a in axes])))
        me = dist.get_rank()
        for row in rows.tolist():
            group = dist.new_group(row)
            if me in row:
                cache[axes] = group
    return cache[axes]


def data_index(mesh) -> Tuple[int, int]:
    """``(index, count)`` of this rank's shard of the batch: ``dp`` x ``fsdp``
    in row-major order (the JAX ``P(("dp", "fsdp"))`` layout)."""
    index, count = 0, 1
    for a in DATA_AXES:
        index, count = index * axis_size(mesh, a) + axis_coord(mesh, a), count * axis_size(mesh, a)
    return index, count


def batch_sharding(mesh, batch_size: int) -> slice:
    """The rows of a global batch that this rank keeps."""
    index, count = data_index(mesh)
    if batch_size % count:
        raise ValueError(f"batch {batch_size} does not split over {count} data ranks")
    b = batch_size // count
    return slice(index * b, (index + 1) * b)


def replicate(mesh, t: torch.Tensor) -> torch.Tensor:
    """A full copy of the mesh's first rank's ``t`` on every rank (in place)."""
    return C.broadcast(t, int(mesh.mesh.reshape(-1)[0]), axis_group(mesh, mesh.mesh_dim_names))


# -- the JAX package's rules, on flax shapes ------------------------------------------


def fsdp_param_spec(shape: Sequence[int], axis_size: int, min_elems: int = 2 ** 16) -> tuple:
    """``mesh.py:43``'s spec as a tuple (``tuple(P(...))``): the largest dim
    divisible by the axis size over ``fsdp`` (ties: the first), or ``()``
    (replicated) for leaves below ``min_elems`` or with no such dim."""
    if not shape or int(np.prod(shape)) < min_elems:
        return ()
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % axis_size == 0:
            spec = [None] * len(shape)
            spec[i] = "fsdp"
            return tuple(spec)
    return ()


_TP_COL = ("to_q/kernel", "to_kv/kernel", "w_in/kernel", "dense0")
_TP_ROW = ("to_out/kernel", "w_out/kernel")


def tp_param_spec(path: str, shape: Sequence[int], tp_size: int,
                  sp_size: int = 1) -> Optional[tuple]:
    """``mesh.py:86``'s Megatron spec of a flax leaf, or None when no rule
    applies: column-parallel projections shard their output features,
    row-parallel ones their input features, rank-5 conv kernels their output
    channels, and ``latents`` its rows over ``sp``."""
    if not shape:
        return None
    if path.endswith("latents") and sp_size > 1 and shape[0] % sp_size == 0:
        return ("sp",) + (None,) * (len(shape) - 1)
    if tp_size <= 1:
        return None
    if any(s in path for s in _TP_COL) and len(shape) == 2 and shape[1] % tp_size == 0:
        return (None, "tp")
    if any(s in path for s in _TP_ROW) and len(shape) == 2 and shape[0] % tp_size == 0:
        return ("tp", None)
    if len(shape) == 5 and shape[-1] % tp_size == 0 and shape[-1] >= 2 * tp_size:
        return (None, None, None, None, "tp")
    return None


class Leaf(NamedTuple):
    """A flax leaf of the model: its path, its flax shape, and the port
    parameters it fills with, for each, the flax dim of each torch dim."""

    path: str
    shape: Tuple[int, ...]
    params: Tuple[Tuple[str, Tuple[int, ...]], ...]


def flax_leaves(model) -> List[Leaf]:
    """Every parameter leaf of the model in flax layout (``weights.flax_targets``)."""
    from voxactb_tpu_torch import weights as W

    perms = {W._identity: None, W._transpose: (1, 0), W._dhwio_to_oidhw: (4, 3, 0, 1, 2)}
    names = {id(p): n for n, p in model.named_parameters()}
    out = []
    for path, targets in W.flax_targets(model).items():
        params = []
        for param, fn in targets:
            perm = perms.get(fn, (1, 0) if getattr(fn, "inverse", None) is W._transpose
                             else "?")
            if perm == "?":
                raise ValueError(f"no dim map for {'/'.join(path)}")
            params.append((names[id(param)], perm or tuple(range(param.dim()))))
        param0, perm0 = targets[0][0], params[0][1]
        shape = [0] * param0.dim()
        for i, d in enumerate(perm0):
            shape[d] = param0.shape[i]
        if len(targets) > 1:  # to_kv: the halves' columns side by side
            shape[1] = sum(p.shape[0] for p, _ in targets)
        out.append(Leaf("/".join(path), tuple(shape), tuple(params)))
    return out


class Shard(NamedTuple):
    """A parameter split along its torch dim ``dim`` over mesh axis ``axis``."""

    dim: int
    axis: str


def _port_shards(model, specs: Dict[str, tuple]) -> Dict[str, Optional[Shard]]:
    out = {}
    for leaf in flax_leaves(model):
        spec = specs.get(leaf.path) or ()
        axes = [(d, a) for d, a in enumerate(spec) if a is not None]
        for name, perm in leaf.params:
            out[name] = Shard(perm.index(axes[0][0]), axes[0][1]) if axes else None
    return out


def shard_params_fsdp(mesh, model, axis: str = "fsdp") -> Dict[str, Optional[Shard]]:
    """Parameter name -> its ``Shard`` over ``fsdp`` (largest-dim rule on the
    flax shape; ``to_k`` and ``to_v`` follow their fused leaf), or None."""
    size = axis_size(mesh, axis)
    if size <= 1:
        return {n: None for n, _ in model.named_parameters()}
    return _port_shards(model, {leaf.path: fsdp_param_spec(leaf.shape, size)
                                for leaf in flax_leaves(model)})


def shard_params_model_parallel(mesh, model) -> Dict[str, Optional[Shard]]:
    """Parameter name -> its ``Shard`` under the tp/sp rules with the fsdp
    fallback (``mesh.py:113``), or None."""
    tp, sp, fs = (axis_size(mesh, a) for a in ("tp", "sp", "fsdp"))
    specs = {}
    for leaf in flax_leaves(model):
        spec = tp_param_spec(leaf.path, leaf.shape, tp, sp)
        if spec is None and fs > 1:
            spec = fsdp_param_spec(leaf.shape, fs)
        specs[leaf.path] = spec
    return _port_shards(model, specs)


# -- the step -----------------------------------------------------------------------


class Plan(NamedTuple):
    """How one parameter lives on this rank."""

    shard: Optional[Shard]
    compute: bool = False  # Megatron: used as the local slice in the forward
    halves: bool = False   # GEGLU w_in: the rank's rows of both halves


class TensorParallel:
    """What a tensor-parallel ``Attention`` or ``FeedForward`` module holds
    (``models/perceiver.py``): the ``tp`` group, this rank's place in it, and
    whether its dropout masks take its heads' offset."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank
        self.mask_offsets = True

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return C.copy_to_tp(x, self.group)

    def column_input(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The input of column-parallel layers: rounded to the compute dtype
        as ``Dense`` rounds it, then held in f32 through Megatron's f, so that
        its gradient is summed over the ranks in f32 and rounded once, as the
        one-process layer's is."""
        return self.copy(x.to(dtype).to(torch.float32))

    def column_linear(self, dense, x32: torch.Tensor) -> torch.Tensor:
        """``dense`` (no bias) on this rank's output features, from
        ``column_input``: the product of compute-dtype operands in f32,
        rounded once to the compute dtype."""
        dt = dense.dtype
        return torch.nn.functional.linear(x32, dense.weight.to(dt).to(torch.float32)).to(dt)

    def row_linear(self, dense, x: torch.Tensor) -> torch.Tensor:
        """``dense`` (``blocks.Dense``) with its input features split over the
        ranks: each rank's product of compute-dtype operands in f32, summed
        over the ranks, rounded once to the compute dtype, then the bias."""
        dt = dense.dtype
        partial = torch.nn.functional.linear(x.to(dt).to(torch.float32),
                                             dense.weight.to(dt).to(torch.float32))
        y = C.reduce_from_tp(partial, self.group).to(dt)
        return y if dense.bias is None else y + dense.bias.to(dt)


def _slice(t: torch.Tensor, plan: Plan, size: int, coord: int) -> torch.Tensor:
    if plan.shard is None:
        return t
    dim = plan.shard.dim
    if plan.halves:
        return torch.cat([h.chunk(size, dim)[coord] for h in t.chunk(2, dim)], dim).clone()
    return t.chunk(size, dim)[coord].clone()


def _unslice(parts: torch.Tensor, plan: Plan, size: int) -> torch.Tensor:
    """The whole parameter from the ranks' slices concatenated along the dim."""
    if not plan.halves:
        return parts
    dim = plan.shard.dim
    ranks = [p.chunk(2, dim) for p in parts.chunk(size, dim)]
    return torch.cat([r[0] for r in ranks] + [r[1] for r in ranks], dim)


def _install_tensor_parallel(model, shards, group, size: int, rank: int) -> Dict[str, Plan]:
    """Make every attention whose heads ``tp`` divides, and every GEGLU,
    Megatron-parallel where all its projections carry the tp spec; returns
    their parameters' plans."""
    from voxactb_tpu_torch.models.perceiver import Attention, FeedForward

    plans = {}
    for prefix, mod in model.named_modules():
        p = prefix + "." if prefix else ""
        if isinstance(mod, Attention):
            want = {f"{p}to_q.weight": 0, f"{p}to_k.weight": 0, f"{p}to_v.weight": 0,
                    f"{p}to_out.weight": 1}
            ok = mod.heads % size == 0
        elif isinstance(mod, FeedForward):
            want = {f"{p}w_in.weight": 0, f"{p}w_out.weight": 1}
            ok = (mod.w_in.weight.shape[0] // 2) % size == 0
        else:
            continue
        mod.tp = None
        if ok and all(shards.get(n) == Shard(d, "tp") for n, d in want.items()):
            mod.tp = TensorParallel(group, size, rank)
            for n in want:
                plans[n] = Plan(shards[n], compute=True, halves=n.endswith("w_in.weight"))
    return plans


def make_parallel_train_step(mesh, init_fn, train_step, example_batch, generator=None, *,
                             fsdp: bool = False, model_parallel: bool = False,
                             fault: Optional[str] = None):
    """Place the state on the mesh; returns ``(state, place_batch, step)``
    (``mesh.py:130``'s).

    ``init_fn()`` and ``train_step`` are ``agents.qfunction.make_train_step``'s
    (the step's module is made tensor-parallel in place under
    ``model_parallel``); ``example_batch`` gives the global batch size.
    ``state`` holds this rank's slices; ``place_batch(batch)`` keeps this
    rank's rows of a global host batch (arrays whose leading dim is the
    batch; the rest, and ``target_object_scene_bounds`` whole, replicate);
    ``step(state, placed, generator=None) -> (state, metrics)`` draws from
    ``generator`` or the one given here, seeded alike on every rank; its
    metrics are the global batch's on every rank. ``step.full_params(state)``
    gathers the whole parameters, ``step.update_from(state, grads)`` applies
    the optimizer to given whole gradients, ``step.plans`` says how each
    parameter lives here.
    ``fault`` plants one of ``FAULTS`` (the dropout masks' offsets zeroed,
    LAMB's trust ratio from the local slices, gradients summed over the data
    ranks), for checks that must catch it.
    """
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault {fault!r} is none of {FAULTS}")
    model, optimizer = train_step.model, train_step.optimizer
    names = mesh.mesh_dim_names
    batch_size = int(np.shape(example_batch["trans_action_indicies"])[0])
    rows = batch_sharding(mesh, batch_size)
    size = {a: axis_size(mesh, a) for a in AXES}
    coord = {a: axis_coord(mesh, a) for a in AXES}

    if model_parallel:
        shards = shard_params_model_parallel(mesh, model)
    elif fsdp and "fsdp" in names:
        shards = shard_params_fsdp(mesh, model)
    else:
        shards = {n: None for n, _ in model.named_parameters()}
    plans = {n: Plan(s) for n, s in shards.items()}
    if model_parallel and size["tp"] > 1:
        tp_plans = _install_tensor_parallel(model, shards, axis_group(mesh, ("tp",)),
                                            size["tp"], coord["tp"])
        plans.update(tp_plans)
        if fault == "zero_dropout_offsets":
            for mod in model.modules():
                if getattr(mod, "tp", None) is not None:
                    mod.tp.mask_offsets = False
    groups = {a: axis_group(mesh, (a,)) for a in AXES if a in names}

    def local(name, t):
        p = plans[name]
        return t if p.shard is None else _slice(t, p, size[p.shard.axis], coord[p.shard.axis])

    full = init_fn()
    params = {n: local(n, replicate(mesh, t.detach().clone())) for n, t in full.params.items()}
    opt = full.opt_state._replace(mu={n: local(n, t) for n, t in full.opt_state.mu.items()},
                                  nu={n: local(n, t) for n, t in full.opt_state.nu.items()})
    state = full._replace(params=params, opt_state=opt)
    del full

    order = list(params)
    by_axis = {a: [i for i, n in enumerate(order) if plans[n].shard is not None
                   and plans[n].shard.axis == a] for a in ("fsdp", "tp", "sp")}

    def sq_reduce(sq: torch.Tensor) -> torch.Tensor:
        """Squared norms of local slices -> of whole parameters."""
        out = sq.clone()
        for a, idx in by_axis.items():
            if idx:
                part = C.all_reduce(sq[:, idx].contiguous(), groups[a])
                out[:, idx] = part
        return out

    def gathered(state_params):
        out = {}
        for n, t in state_params.items():
            p = plans[n]
            if p.shard is not None and not p.compute:
                t = C.all_gather(t, p.shard.dim, groups[p.shard.axis])
            out[n] = t
        return out

    # a gradient is summed over every rank that holds the same slice of it
    # (a replica's copy too: the ranks of a tp or sp group compute the same
    # sums, which atomics may round apart, and the sum keeps their states
    # equal), then divided by the number of those ranks: the mean over the
    # data ranks
    world = int(np.prod([size[a] for a in names]))
    others = lambda axis: tuple(a for a in names if a != axis)  # noqa: E731
    sum_over = {n: others("fsdp") if p.shard is not None and not p.compute
                and p.shard.axis == "fsdp" else others("tp") if p.compute else names
                for n, p in plans.items()}
    sum_groups = {axes: axis_group(mesh, axes) for axes in dict.fromkeys(sum_over.values())}
    everyone = axis_group(mesh, names)

    def sync(grads):
        """Gradients averaged over the data ranks, as this rank's slices."""
        out, buckets = {}, {axes: [] for axes in sum_groups}
        for n, g in grads.items():
            p = plans[n]
            if p.shard is not None and not p.compute and p.shard.axis == "fsdp":
                g = C.reduce_scatter(g, p.shard.dim, groups["fsdp"], coord["fsdp"])
            out[n] = g.contiguous()
            buckets[sum_over[n]].append(out[n])
        for axes, tensors in buckets.items():
            C.all_reduce_flat(tensors, sum_groups[axes])
        for n, g in out.items():
            if fault != "summed_grads":
                g.div_(world // size["tp"] if plans[n].compute else world)
            p = plans[n]
            if p.shard is not None and not p.compute and p.shard.axis != "fsdp":
                out[n] = local(n, g)
        return out

    def place_batch(batch: dict) -> dict:
        return {k: v[rows] if (np.ndim(v) and np.shape(v)[0] == batch_size
                               and k != "target_object_scene_bounds") else v
                for k, v in batch.items()}

    def step(state, batch: dict, gen=None):
        from voxactb_tpu_torch.agents.qfunction import TrainState
        from voxactb_tpu_torch.optim import global_norm

        gen = generator if gen is None else gen
        b = int(np.shape(batch["trans_action_indicies"])[0])
        if b != rows.stop - rows.start:
            raise ValueError(f"rank's batch has {b} rows, expected {rows.stop - rows.start}")
        metrics, grads = train_step.loss_and_grads(
            TrainState(state.step, gathered(state.params), None), batch, gen,
            rows=(rows.start, batch_size),
            mask_offset=0 if fault == "zero_dropout_offsets" else None)
        with torch.no_grad():
            grads = sync(grads)
            metrics["grad_norm"] = global_norm(grads, sq_reduce)
            keys = sorted(metrics)
            vals = C.all_reduce(torch.stack([metrics[k].to(torch.float32) for k in keys]),
                                everyone) / world
        return apply_update(state, grads), dict(zip(keys, vals.unbind(0)))

    @torch.no_grad()
    def apply_update(state, grads):
        """The optimizer's update of this rank's slices by their gradients."""
        from voxactb_tpu_torch.agents.qfunction import TrainState

        new_params, new_opt = optimizer.update(
            grads, state.opt_state, state.params,
            sq_reduce=None if fault == "local_trust_ratio" else sq_reduce)
        return TrainState(state.step + 1, new_params, new_opt)

    def update_from(state, full_grads):
        """``apply_update`` of the whole parameters' gradients (the same on
        every rank): each rank updates its slices."""
        return apply_update(state, {n: local(n, g) for n, g in full_grads.items()})

    def full_params(state) -> Dict[str, torch.Tensor]:
        out = {}
        for n, t in state.params.items():
            p = plans[n]
            if p.shard is not None:
                t = _unslice(C.all_gather(t, p.shard.dim, groups[p.shard.axis]), p,
                             size[p.shard.axis])
            out[n] = t
        return out

    def sharded_bytes(state) -> Dict[str, Tuple[int, int]]:
        """For every split parameter: (bytes this rank holds of it and its
        two moments, bytes of the whole of them)."""
        out = {}
        for n, p in plans.items():
            if p.shard is not None:
                held = sum(t[n].numel() * t[n].element_size() for t in
                           (state.params, state.opt_state.mu, state.opt_state.nu))
                whole = model.get_parameter(n).numel() * 3 * state.params[n].element_size()
                out[n] = (held, whole)
        return out

    step.full_params = full_params
    step.update_from = update_from
    step.sharded_bytes = sharded_bytes
    step.plans = plans
    step.rows = rows
    return state, place_batch, step
