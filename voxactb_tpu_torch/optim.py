"""Optimizers of the BC train step, written out to ``optax`` semantics.

Counterpart of ``voxactb_tpu.agents.qfunction.make_optimizer`` (qfunction.py:
240-279): LAMB (the default) is

    scale_by_adam(b1 0.9, b2 0.999, eps 1e-6, bias-corrected)
      -> add_decayed_weights(lambda_weight_l2)
      -> scale_by_trust_ratio        (||param|| / ||update|| per leaf)
      -> scale by -learning_rate,

and Adam couples its L2 term THROUGH the moments (``g + wd * p`` before
``scale_by_adam``, eps 1e-8), as ``torch.optim.Adam(weight_decay=..)`` does.

An optimizer here is a pure function of ``(grads, state, params)`` over
dictionaries ``name -> tensor`` and returns new tensors; state lives in f32 on
the params' device and nothing syncs with the host (the step count is a device
tensor). The trust ratio is taken per LEAF OF THE JAX PACKAGE'S TREE: the port
stores flax's fused ``to_kv`` kernel as two parameters (``to_k``, ``to_v``),
and ``leaf_groups`` names such sets so that their norms are taken over the
group as one leaf; two separate ratios would make the trained weights drift
from the JAX package's from the first step.

Where a parameter is split over ranks (``parallel.mesh``) the update runs on
each rank's slice; ``sq_reduce`` then completes the squared norms of the
slices to those of the whole parameters (a sum over the ranks that share it)
before the trust ratio and ``global_norm`` take them.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]


class OptState(NamedTuple):
    count: torch.Tensor  # int64 scalar on the device: updates applied so far
    mu: Tensors          # first moments, f32
    nu: Tensors          # second moments, f32


def cosine_hard_restarts_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                                  num_cycles: int) -> Schedule:
    """transformers.get_cosine_with_hard_restarts_schedule_with_warmup
    (qattention_peract_bc_agent.py:274-279), in f32 on the step's device."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        cycle_pos = torch.remainder(num_cycles * progress, 1.0)
        cos = torch.clamp(0.5 * (1.0 + torch.cos(math.pi * cycle_pos)), min=0.0)
        cos = torch.where(progress >= 1.0, torch.zeros_like(cos), cos)
        return base_lr * torch.where(step < warmup_steps, warm, cos)

    return schedule


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """f32 ``1 - decay ** count`` as the f32 JAX program gives it: the decay
    rounded to f32, its power taken exactly and rounded once."""
    base = torch.tensor(float(np.float32(decay)), dtype=torch.float64, device=count.device)
    return 1.0 - torch.pow(base, count.to(torch.float64)).to(torch.float32)


class Optimizer:
    """LAMB or coupled-L2 Adam over ``name -> tensor`` dictionaries.

    ``leaf_groups`` lists sets of parameter names whose trust ratio is taken
    over the set as one leaf; every other parameter is a leaf of its own.
    """

    def __init__(self, kind: str, learning_rate: Union[float, Schedule], *,
                 weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 leaf_groups: Sequence[Sequence[str]] = ()):
        if kind not in ("lamb", "adam"):
            raise ValueError(f"Unknown optimizer type {kind!r}")
        self.kind = kind
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.b1, self.b2 = b1, b2
        self.eps = 1e-6 if kind == "lamb" else 1e-8
        self.leaf_groups = [list(g) for g in leaf_groups]
        self._group_cache: dict = {}

    def with_leaf_groups(self, leaf_groups: Sequence[Sequence[str]]) -> "Optimizer":
        """The same optimizer with these trust-ratio leaves."""
        return Optimizer(self.kind, self.learning_rate, weight_decay=self.weight_decay,
                         b1=self.b1, b2=self.b2, leaf_groups=leaf_groups)

    def init(self, params: Tensors) -> OptState:
        some = next(iter(params.values()))
        zeros = lambda: {k: torch.zeros_like(v, dtype=torch.float32)
                         for k, v in params.items()}
        return OptState(torch.zeros((), dtype=torch.int64, device=some.device),
                        zeros(), zeros())

    def _group_index(self, names: List[str], device):
        """For every parameter, the index of its trust-ratio leaf (a tensor on
        ``device``), and the number of leaves."""
        key = (tuple(names), str(device))
        if key not in self._group_cache:
            group_of = {name: g[0] for g in self.leaf_groups for name in g}
            leaders: Dict[str, int] = {}
            idx = [leaders.setdefault(group_of.get(n, n), len(leaders)) for n in names]
            self._group_cache[key] = (
                torch.tensor(idx, dtype=torch.int64, device=device), len(leaders))
        return self._group_cache[key]

    def _trust_ratios(self, params: List[torch.Tensor], updates: List[torch.Tensor],
                      names: List[str], sq_reduce=None) -> List[torch.Tensor]:
        """``scale_by_trust_ratio``: ||param|| / ||update|| per leaf, 1 where
        either norm is 0."""
        group, n_leaves = self._group_index(names, params[0].device)
        sq = torch.stack([torch.stack(torch._foreach_norm(t)) ** 2
                          for t in (params, updates)])
        if sq_reduce is not None:
            sq = sq_reduce(sq)
        total = torch.zeros((2, n_leaves), dtype=sq.dtype, device=sq.device)
        pn, un = torch.sqrt(total.index_add_(1, group, sq))
        ratio = torch.where((pn == 0.0) | (un == 0.0), torch.ones_like(pn), pn / un)
        return list(ratio[group].unbind(0))

    def update(self, grads: Tensors, state: OptState, params: Tensors, *, sq_reduce=None):
        """One step: ``(new_params, new_state)``. Nothing is changed in place.
        ``sq_reduce`` maps the ``[2, n]`` squared norms of the parameters' and
        the updates' local slices to those of the whole parameters."""
        names = list(params)
        p = [params[n] for n in names]
        g = [grads[n].to(torch.float32) for n in names]
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        b1, b2 = self.b1, self.b2
        if self.kind == "adam" and self.weight_decay:
            g = torch._foreach_add(g, torch._foreach_mul(p, self.weight_decay))

        mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - b1), torch._foreach_mul(mu, b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2),
                                torch._foreach_mul(nu, b2))
        count = state.count + 1
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, count))
        nu_hat = torch._foreach_div(nu, _bias_correction(b2, count))
        u = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat),
                                                          self.eps))
        if self.kind == "lamb":
            if self.weight_decay:
                u = torch._foreach_add(u, torch._foreach_mul(p, self.weight_decay))
            ratios = self._trust_ratios(p, u, names, sq_reduce)
            u = torch._foreach_mul(u, ratios)

        lr = self.learning_rate
        step_size = -lr(state.count) if callable(lr) else -lr
        u = torch._foreach_mul(u, step_size)
        new_p = torch._foreach_add(p, u)
        return (dict(zip(names, new_p)),
                OptState(count, dict(zip(names, mu)), dict(zip(names, nu))))


def global_norm(tensors: Tensors, sq_reduce=None) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of all squared elements;
    ``sq_reduce`` as ``Optimizer.update``'s, on a ``[1, n]`` tensor."""
    vals = [t.to(torch.float32) for t in tensors.values()]
    sq = torch.stack(torch._foreach_norm(vals)).square()
    if sq_reduce is not None:
        sq = sq_reduce(sq[None])[0]
    return torch.sqrt(sq.sum())


def state_to_cpu(state: OptState) -> dict:
    """The optimizer state as plain CPU tensors (for ``torch.save``)."""
    return {"count": state.count.cpu(), "mu": {k: v.cpu() for k, v in state.mu.items()},
            "nu": {k: v.cpu() for k, v in state.nu.items()}}


def state_from_saved(saved: dict, device: Optional[torch.device] = None) -> OptState:
    """The inverse of ``state_to_cpu``, moved to ``device``."""
    move = lambda t: t.to(device=device)
    return OptState(move(saved["count"]).to(torch.int64),
                    {k: move(v) for k, v in saved["mu"].items()},
                    {k: move(v) for k, v in saved["nu"].items()})
