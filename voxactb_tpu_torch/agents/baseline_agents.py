"""Agent wrappers for the baseline policy zoo.

Counterpart of ``voxactb_tpu.agents.baseline_agents`` (``BCLangAgent``, the
reference's baselines/bc_lang/bc_lang_agent.py:34: MSE regression of the
continuous action; ``network='vit'`` is vit_bc_lang). Same Agent contract as
``QAttentionBCAgent``. Adam is ``optim.Optimizer('adam', lr)``, ``optax.adam``
written out; the network is built at the first ``update`` or ``act`` from the
shapes of that sample, as flax's ``init`` builds it, with weights drawn from a
``torch.Generator`` seeded with ``seed`` on the CPU (so a card agent and a CPU
agent of one seed start from the same weights).

Checkpoints keep the JAX file name ``{name}.msgpack`` and flax's layout
(``{'params': ...}`` in flax's msgpack, ``utils/msgpack_codec``), so either
package reads the other's files.

Departures from the JAX agent, each with its test
(``tests/test_torch_baselines.py``):

- weights loaded before the first ``update`` are the ones it trains (the JAX
  agent initialises afresh at its first update and drops them), and a load
  after training replaces the weights the next update starts from (the JAX
  agent keeps training its earlier state);
- ``update`` and ``act`` call ``build`` when it has not been called (the JAX
  agent fails on a missing attribute), so each resolves the device: CUDA
  unless the agent was given ``device='cpu'``, raising without CUDA.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from voxactb_tpu_torch.agents.base import ActResult, Agent, ScalarSummary
from voxactb_tpu_torch.agents.qfunction import normalize_rgb
from voxactb_tpu_torch.device import resolve_device
from voxactb_tpu_torch.models.baselines import build_policy
from voxactb_tpu_torch.optim import Optimizer, OptState


class BCLangAgent(Agent):
    """Direct-regression BC over camera features + language + proprio.

    ``network='cnn'`` or ``'vit'``. Trains with MSE on the 8-DoF continuous
    action (the reference's loss), acts by emitting the regressed action
    directly.
    """

    def __init__(self, camera_names: Sequence[str], network: str = "cnn",
                 lr: float = 1e-3, name: str = "BCLangAgent", device=None, seed: int = 0,
                 **net_kw):
        self._cameras = list(camera_names)
        self._network = network
        self._net_kw = net_kw
        self._lr = lr
        self._name = name
        self._requested_device = device
        self._seed = seed
        self._device: Optional[torch.device] = None
        self._net: Optional[torch.nn.Module] = None
        self._opt_state: Optional[OptState] = None
        self._pending: Optional[dict] = None  # a loaded tree the net is not built for yet
        self._summaries: Dict[str, float] = {}

    def build(self, training: bool, device=None) -> None:
        self._training = training
        self._device = resolve_device(device if device is not None
                                      else self._requested_device)
        self._optimizer = Optimizer("adam", self._lr)
        if self._net is not None:
            self._net.to(self._device)

    @property
    def network(self) -> Optional[torch.nn.Module]:
        """The policy network, once the first sample has sized it."""
        return self._net

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self._device)

    def _inputs(self, sample, key_rgb="_rgb", key_pcd="_point_cloud"):
        rgbs = [normalize_rgb(self._tensor(sample[f"{c}{key_rgb}"])) for c in self._cameras]
        pcds = [self._tensor(sample[f"{c}{key_pcd}"]) for c in self._cameras]
        return rgbs, pcds

    def _ensure_net(self, rgbs, pcds, proprio, lang) -> None:
        """Build the network from this sample's shapes (weights from the
        agent's seed), then fill it from a tree loaded before it existed."""
        if self._net is not None:
            return
        net = build_policy(self._network, rgbs, pcds, proprio, lang,
                           generator=torch.Generator().manual_seed(self._seed),
                           **self._net_kw)
        if self._pending is not None:
            from voxactb_tpu_torch.weights import load_flax_params

            load_flax_params(net, self._pending)
            self._pending = None
        self._net = net.to(self._device)

    def update(self, step: int, replay_sample: dict) -> dict:
        if self._device is None:
            self.build(training=True)
        rgbs, pcds = self._inputs(replay_sample)
        proprio = self._tensor(replay_sample["low_dim_state"])
        lang = self._tensor(replay_sample["lang_goal_emb"])
        pose = self._tensor(replay_sample["gripper_pose"])
        grip = self._tensor(replay_sample["rot_grip_action_indicies"])[:, 3:4]
        target = torch.cat([pose, grip], -1)
        self._ensure_net(rgbs, pcds, proprio, lang)
        params = dict(self._net.named_parameters())
        if self._opt_state is None:
            self._opt_state = self._optimizer.init(
                {k: v.detach() for k, v in params.items()})
        pred = self._net(rgbs, pcds, proprio, lang)
        loss = torch.mean((pred - target) ** 2)
        grads = torch.autograd.grad(loss, list(params.values()))
        new, self._opt_state = self._optimizer.update(
            dict(zip(params, grads)), self._opt_state,
            {k: v.detach() for k, v in params.items()})
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
        loss = loss.detach()
        self._summaries = {"losses/mse": float(loss)}
        return {"total_loss": loss}

    def act(self, step: int, observation: dict, deterministic: bool = False,
            which_arm: Optional[str] = None, **kw) -> ActResult:
        if self._device is None:
            self.build(training=False)
        rgbs, pcds = self._inputs(observation)
        key = {"right": "low_dim_state_right_arm",
               "left": "low_dim_state_left_arm"}.get(which_arm, "low_dim_state")
        proprio = self._tensor(np.asarray(observation[key], np.float32).reshape(1, -1)[:, :4])
        lang = self._tensor(np.asarray(observation["lang_goal_emb"], np.float32).reshape(1, -1))
        self._ensure_net(rgbs, pcds, proprio, lang)
        with torch.inference_mode():
            pred = self._net(rgbs, pcds, proprio, lang).cpu().numpy()[0]
        action = np.concatenate([pred, [1.0]])  # + ignore_collisions bit
        return ActResult(action)

    def update_summaries(self) -> List:
        return [ScalarSummary(f"{self._name}/{k}", v) for k, v in self._summaries.items()]

    def _tree(self):
        from voxactb_tpu_torch.weights import baseline_flax_tree

        return self._pending if self._net is None else baseline_flax_tree(self._net)

    def save_weights(self, savedir: str) -> None:
        from voxactb_tpu_torch.utils import msgpack_codec

        os.makedirs(savedir, exist_ok=True)
        msgpack_codec.save(os.path.join(savedir, f"{self._name}.msgpack"), self._tree())

    def load_weights(self, savedir: str) -> None:
        from voxactb_tpu_torch.utils import msgpack_codec
        from voxactb_tpu_torch.weights import load_flax_params

        restored = msgpack_codec.load(os.path.join(savedir, f"{self._name}.msgpack"))
        if self._net is None:
            self._pending = restored
        else:
            load_flax_params(self._net, restored)
