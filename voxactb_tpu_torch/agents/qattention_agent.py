"""QAttention BC agent: the YARR-contract wrapper around the act and train programs.

Counterpart of ``voxactb_tpu.agents.qattention_agent.QAttentionBCAgent``
(itself ``QAttentionPerActBCAgent`` + the decode half of
``QAttentionStackAgent``). All math runs inside ``make_infer_fn`` and
``make_train_step``; the host work here is dict plumbing, the proprio
selection by arm mode and the per-camera pixel projection. Checkpoints are the
port's own: one ``torch.save`` file of parameters, optimizer state and step.
The agent also reads the JAX package's ``.msgpack`` checkpoints (parameters,
step and optax state in flax's format, through ``utils/msgpack_codec``) and
writes that format on request (``save_weight`` to a ``.msgpack`` path).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from voxactb_tpu_torch.agents.base import ActResult, Agent, ScalarSummary, Summary
from voxactb_tpu_torch.agents.qfunction import (
    InferOutput, TrainState, make_infer_fn, make_optimizer, make_train_step)
from voxactb_tpu_torch.config import MethodConfig
from voxactb_tpu_torch.device import resolve_device
from voxactb_tpu_torch.optim import state_from_saved, state_to_cpu
from voxactb_tpu_torch.utils.observation import point_to_pixel_index
from voxactb_tpu_torch.utils.profiling import count, span

NAME = "QAttentionAgent"


def _with_batch(x, event_ndim: int, dtype=np.float32):
    """Reshape to [1, *event_shape] regardless of incoming batch dims."""
    a = np.asarray(x, dtype)
    return a.reshape((1,) + a.shape[a.ndim - event_ndim:])


def _to_host(out: InferOutput) -> dict:
    """The action's fields as host arrays: one blocking device -> host copy
    per field, each counted as ``act.d2h_copies``."""
    host = {}
    for key, t in (("trans_idx", out.trans_idx), ("rot_grip", out.rot_grip_idx),
                   ("collision", out.collision_idx), ("att", out.attention_coordinate),
                   ("cont", out.continuous_action)):
        count("act.d2h_copies")
        host[key] = t.cpu().numpy()
    count("act.d2h_copies")
    host["front_overflow"] = int(out.front_overflow.sum().item())
    return host


class QAttentionBCAgent(Agent):
    """Single Q-attention layer agent (depth 0 — the only depth PerAct uses).

    Language: ``lang_encoder`` maps token ids -> (lang_goal_emb [1,1024],
    lang_token_embs [1,77,512]); without one, act() reads precomputed
    embeddings from the observation (as the replay path stores them).
    Weights: seeded initialisation at ``build``; assign ``params`` a flax
    parameter tree (nested dicts of numpy arrays) or a ``state_dict`` to load.
    """

    def __init__(self, cfg: MethodConfig, camera_names: Sequence[str],
                 scene_bounds: Sequence[float], batch_size: int = 1,
                 training_iterations: int = 1_000_000,
                 lang_encoder: Optional[Callable] = None, layer: int = 0,
                 device=None, seed: int = 0):
        self._cfg = cfg
        self._camera_names = list(camera_names)
        self._scene_bounds = np.asarray(scene_bounds, np.float32)
        self._batch_size = batch_size
        self._training_iterations = training_iterations
        self._lang_encoder = lang_encoder
        self._layer = layer
        self._name = f"{NAME}_layer{layer}"
        self._device = device
        self._seed = seed
        self._model = None
        self._training = False
        self._state: Optional[TrainState] = None
        self._model_stale = False  # the state's weights are newer than the module's
        self._pending_opt = None
        self._summaries: Dict[str, torch.Tensor] = {}

    # -- lifecycle -----------------------------------------------------------------

    def build(self, training: bool, device=None) -> None:
        self._training = training
        self._device = resolve_device(device if device is not None else self._device)
        model = None
        if training:
            self._optimizer = make_optimizer(self._cfg, self._training_iterations)
            model, self._init_fn, self._train_step = make_train_step(
                self._cfg, self._optimizer, self._camera_names, device=self._device,
                seed=self._seed)
            # the crop jitter, the augmentation and the dropout draw from here
            self._generator = torch.Generator(device=self._device).manual_seed(self._seed)
        self._model, self._infer = make_infer_fn(self._cfg, device=self._device,
                                                 seed=self._seed, model=model)

    def _ensure_state(self) -> None:
        if self._state is None:
            # from the module's weights: seeded, or loaded before the first update
            self._state = self._init_fn()
            if self._pending_opt is not None:
                # resume: the checkpoint's optimizer state and step were loaded
                # before any state existed; dropping them would restart the
                # LAMB moments and the LR schedule from step 0
                step, saved = self._pending_opt
                self._state = TrainState(
                    torch.tensor(int(step), dtype=torch.int64, device=self._device),
                    self._state.params, state_from_saved(saved, self._device))
                self._pending_opt = None

    def _sync_model(self) -> None:
        """Bring the module's weights up to the train state's before acting."""
        if self._model_stale:
            self._model.load_state_dict(self._state.params)
            self._model_stale = False

    # -- training ------------------------------------------------------------------

    def update(self, step: int, replay_sample: dict) -> dict:
        if not self._training:
            raise RuntimeError("update() needs build(training=True)")
        with span("vx.update", step):
            batch = {k: v for k, v in replay_sample.items()
                     if isinstance(v, (np.ndarray, torch.Tensor, list, float, int))}
            if "scene_bounds" not in batch:
                batch["scene_bounds"] = self._scene_bounds
            self._ensure_state()
            self._state, metrics = self._train_step(self._state, batch, self._generator)
            self._model_stale = True
            self._summaries = {f"losses/{k}": v for k, v in metrics.items()}
            return {"total_loss": metrics["total_loss"]}

    # -- inference -----------------------------------------------------------------

    def act(self, step: int, observation: dict, deterministic: bool = False,
            which_arm: Optional[str] = None, new_scene_bounds=None,
            dominant_assitive_policy: bool = False, ep_number: int = 0,
            is_real_robot: bool = False) -> ActResult:
        with span("vx.act", step):
            with span("vx.act.prep"):
                inputs = self._act_inputs(observation, which_arm, new_scene_bounds,
                                          dominant_assitive_policy)
            with span("vx.act.sync_model"):
                if self._model is None:
                    self.build(training=False)
                self._sync_model()
            with span("vx.act.infer"):
                out: InferOutput = self._infer(self._model, *inputs)
            with span("vx.act.d2h"):
                host = _to_host(out)
            with span("vx.act.post"):
                return self._act_result(out, host, observation, which_arm, is_real_robot)

    def _act_inputs(self, observation: dict, which_arm, new_scene_bounds,
                    dominant_assitive_policy: bool) -> tuple:
        """The observation as ``infer``'s host arrays: ``(rgbs, pcds, proprio,
        lang_goal_emb, lang_token_embs, bounds)``."""
        bounds = (np.asarray(new_scene_bounds, np.float32)
                  if new_scene_bounds is not None else self._scene_bounds).reshape(1, 6)

        # language conditioning (qattention_peract_bc_agent.py:653-665)
        if "lang_goal_emb" in observation:
            lang_goal = _with_batch(observation["lang_goal_emb"], 1)
            lang_tok = _with_batch(observation["lang_token_embs"], 2)
        else:
            key = {"multiarm_left": "lang_goal_tokens_left",
                   "multiarm_right": "lang_goal_tokens_right"}.get(
                       which_arm, "lang_goal_tokens")
            tokens = np.asarray(observation[key]).reshape(1, -1)
            if self._lang_encoder is None:
                raise ValueError(
                    "observation has raw lang tokens but no lang_encoder was given")
            lang_goal, lang_tok = self._lang_encoder(tokens)

        # proprio selection by arm mode (:672-681)
        if dominant_assitive_policy:
            left = np.asarray(observation["low_dim_state_left_arm"], np.float32)
            right = np.asarray(observation["low_dim_state_right_arm"], np.float32)
            proprio = np.concatenate([left.reshape(1, -1)[:, :3],
                                      right.reshape(1, -1)], -1)
        elif which_arm in ("right", "multiarm_right"):
            proprio = np.asarray(
                observation["low_dim_state_right_arm"], np.float32).reshape(1, -1)
        elif which_arm in ("left", "multiarm_left"):
            proprio = np.asarray(
                observation["low_dim_state_left_arm"], np.float32).reshape(1, -1)
        elif self._cfg.variant == "one_policy_more_heads" \
                and "low_dim_state_right_arm" in observation:
            w = self._cfg.low_dim_size()
            proprio = np.concatenate([
                np.asarray(observation["low_dim_state_right_arm"],
                           np.float32).reshape(1, -1)[:, :w],
                np.asarray(observation["low_dim_state_left_arm"],
                           np.float32).reshape(1, -1)[:, :w]], -1)
        else:
            proprio = np.asarray(observation["low_dim_state"], np.float32).reshape(1, -1)
        proprio = proprio[:, : self._cfg.proprio_width()]

        rgbs = tuple(
            np.asarray(observation[f"{c}_rgb"], np.float32).reshape(
                1, *np.asarray(observation[f"{c}_rgb"]).shape[-3:])
            for c in self._camera_names)
        pcds = tuple(
            np.asarray(observation[f"{c}_point_cloud"], np.float32).reshape(
                1, *np.asarray(observation[f"{c}_point_cloud"]).shape[-3:])
            for c in self._camera_names)
        return rgbs, pcds, proprio, lang_goal, lang_tok, bounds

    def _act_result(self, out: InferOutput, host: dict, observation: dict, which_arm,
                    is_real_robot: bool) -> ActResult:
        trans_idx, rot_grip = host["trans_idx"], host["rot_grip"]
        collision, att, cont = host["collision"], host["att"], host["cont"]
        if self._cfg.variant == "one_policy_more_heads":
            head = 0 if which_arm in ("right", "multiarm_right", None) else 1
            trans_idx, rot_grip = trans_idx[head], rot_grip[head]
            collision, att, cont = collision[head], att[head], cont[head]

        observation_elements = {
            "attention_coordinate": att[0],
            "attention_coordinate_layer_0": att[0],
            "trans_action_indicies": trans_idx[0],
            "rot_grip_action_indicies": rot_grip[0],
        }
        if not is_real_robot:
            for cam in self._camera_names:
                ek, ik = f"{cam}_camera_extrinsics", f"{cam}_camera_intrinsics"
                if ek in observation and ik in observation:
                    px, py = point_to_pixel_index(
                        att[0], np.asarray(observation[ek]).reshape(4, 4),
                        np.asarray(observation[ik]).reshape(3, 3))
                    observation_elements[f"{cam}_pixel_coord"] = [py, px]

        info = {
            "voxel_grid_depth0": out.voxel_grid,
            "q_depth0": out.q_trans,
            "voxel_idx_depth0": trans_idx,
            "front_overflow": host["front_overflow"],
        }
        if is_real_robot:
            return ActResult((cont[0, :3], cont[0, 3:7], cont[0, 7:8]),
                             observation_elements=observation_elements, info=info)
        return ActResult(cont[0], observation_elements=observation_elements, info=info)

    # -- summaries / weights ---------------------------------------------------------

    def update_summaries(self) -> List[Summary]:
        return [ScalarSummary(f"{self._name}/{k}", float(v))
                for k, v in self._summaries.items()]

    def act_summaries(self) -> List[Summary]:
        return []

    def _ckpt_path(self, savedir: str, suffix: str = ".pt") -> str:
        return os.path.join(savedir, f"{self._name}{suffix}")

    def save_weights(self, savedir: str) -> None:
        """One ``torch.save`` file: parameters, step and, once training has
        begun, the optimizer state (all as CPU tensors)."""
        os.makedirs(savedir, exist_ok=True)
        self.save_weight(self._ckpt_path(savedir))

    def save_weight(self, ckpt_file: str) -> None:
        """Write the weights to ``ckpt_file``: the port's ``torch.save``
        format, or, for a ``.msgpack`` path, the JAX agent's
        (``{'params', 'step', 'opt_state'}`` in flax's msgpack, the optimizer
        state as optax lays it out), which the JAX package reads."""
        if self._model is None:
            self.build(training=False)
        self._sync_model()
        step = 0 if self._state is None else int(self._state.step)
        if str(ckpt_file).endswith(".msgpack"):
            from voxactb_tpu_torch.utils import msgpack_codec
            from voxactb_tpu_torch.weights import optax_state_tree, tensors_to_flax_tree

            payload = {"params": tensors_to_flax_tree(
                self._model, dict(self._model.named_parameters())),
                "step": np.asarray(step)}
            if self._state is not None:
                payload["opt_state"] = optax_state_tree(
                    self._model, self._state.opt_state, self._cfg.optimizer,
                    self._cfg.lr_scheduler)
            msgpack_codec.save(ckpt_file, payload)
            return
        payload = {"params": {k: v.detach().cpu()
                              for k, v in self._model.state_dict().items()},
                   "step": step}
        if self._state is not None:
            payload["opt_state"] = state_to_cpu(self._state.opt_state)
        torch.save(payload, ckpt_file)

    def load_weights(self, savedir: str) -> None:
        """The agent's checkpoint in ``savedir``: the port's ``.pt``, else the
        JAX package's ``.msgpack`` of the same name (a JAX run's weights
        directory)."""
        path = self._ckpt_path(savedir)
        if not os.path.exists(path) and os.path.exists(self._ckpt_path(savedir, ".msgpack")):
            path = self._ckpt_path(savedir, ".msgpack")
        self.load_weight(path)

    def load_weight(self, ckpt_file: str) -> None:
        """Load a checkpoint: the port's ``.pt`` or the JAX package's
        ``.msgpack``. In training, its optimizer state and step are restored
        at the next update (right away when the agent already trains)."""
        if self._model is None:
            self.build(training=False)
        if str(ckpt_file).endswith(".msgpack"):
            from voxactb_tpu_torch.utils import msgpack_codec
            from voxactb_tpu_torch.weights import load_flax_params, opt_state_from_flax

            payload = msgpack_codec.load(ckpt_file)
            load_flax_params(self._model, payload["params"])
            if self._training and "opt_state" in payload:
                payload["opt_state"] = state_to_cpu(
                    opt_state_from_flax(self._model, payload["opt_state"]))
            payload["step"] = int(np.asarray(payload.get("step", 0)))
        else:
            payload = torch.load(ckpt_file, map_location="cpu", weights_only=True)
            self._model.load_state_dict(payload["params"])
        self._model_stale = False
        had_state = self._state is not None
        self._state = None  # rebuilt from the loaded weights
        if self._training and "opt_state" in payload:
            # restored inside _ensure_state: right away when this agent already
            # trains, else at the first update (the resume path loads first)
            self._pending_opt = (payload.get("step", 0), payload["opt_state"])
            if had_state:
                self._ensure_state()

    @property
    def params(self) -> Optional[torch.nn.Module]:
        """The Q-network module that holds the weights."""
        if self._model is not None:
            self._sync_model()
        return self._model

    @params.setter
    def params(self, p) -> None:
        from voxactb_tpu_torch.weights import load_flax_params

        if self._model is None:
            self.build(training=False)
        if all(isinstance(v, torch.Tensor) for v in p.values()):
            self._model.load_state_dict(p)  # a state_dict
        else:
            load_flax_params(self._model, p)  # a flax tree of numpy arrays
        self._model_stale = False
        if self._state is not None:
            # keep the optimizer state, train on from the assigned weights
            self._state = self._state._replace(
                params={k: v.detach().clone() for k, v in self._model.named_parameters()})
