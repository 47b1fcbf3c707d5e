"""Weight bridge between a flax parameter tree and the port's modules.

``load_flax_params(module, tree)`` takes the JAX package's parameter tree as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``)
and fills the port's module, matching by name (the port's submodules carry the
flax names). It is strict on both sides: every leaf of the tree is consumed
exactly once, every torch parameter is set, every shape is checked, and any
mismatch raises before a single parameter is written.

Mappings: Dense ``kernel [in, out]`` -> ``weight [out, in]``; Conv ``kernel
DHWIO`` -> ``weight OIDHW`` and ``HWIO`` -> ``OIHW``; ConvTranspose ``kernel
[kh, kw, in, out]`` (flax's forward-conv orientation) -> torch's ``[in, out,
kh, kw]``, spatially flipped; LayerNorm ``scale/bias`` -> ``weight/bias``; the
attention's fused ``to_kv`` kernel splits into ``to_k`` (first half of the
output columns) and ``to_v`` (second half); everything else (``pos_encoding``,
``latents``, ``up0/out_kernel``, the towers' embeddings, ``rel_pos_h``...)
is copied as it is. The same bridge carries the VLM towers (CLIP text,
OWL-ViT, SAM encoder and decoder).

The same mapping carries anything laid out like the parameters:
``flax_tree_to_tensors`` turns a flax-layout tree (parameters, or optax's
``mu`` / ``nu``) into the port's ``name -> tensor`` dictionary,
``tensors_to_flax_tree`` is its inverse (parameters or gradients back into the
flax layout as numpy, ``to_k | to_v`` re-fused), and ``opt_state_from_optax``
builds the port's optimizer state from ``optax.lamb``'s ``count``, ``mu`` and
``nu``, so a test can start both packages from one state.

BatchNorm (the CLIP RN50 image tower's): flax keeps ``scale`` / ``bias`` in
``params`` and the running ``mean`` / ``var`` in the ``batch_stats``
collection; ``load_flax_params`` takes ``{'params': ..., 'batch_stats':
...}`` and fills the module's ``running_mean`` / ``running_var`` buffers,
``batch_stats_tree`` gives them back. A torch ``nn.Conv2d`` maps as the
port's ``Conv2D`` does.

Optimizer state in a JAX checkpoint: ``opt_state_from_flax`` reads the
``to_state_dict`` of ``optax.lamb``'s state (``count`` / ``mu`` / ``nu``
under ``'0'``) or of the Adam chain's (under ``'1'``), and
``optax_state_tree`` writes the port's state back in that layout, with the
learning-rate schedule's own ``count`` where the optimizer has a schedule.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from voxactb_tpu_torch.models.blocks import (
    Conv2D, Conv3D, ConvTranspose2D, Dense, LayerNorm)
from voxactb_tpu_torch.models.perceiver import Attention

_BatchNorm = nn.modules.batchnorm._BatchNorm
Path = Tuple[str, ...]
Target = Tuple[nn.Parameter, Callable[[np.ndarray], np.ndarray]]


def _identity(a: np.ndarray) -> np.ndarray:
    return a


def _transpose(a: np.ndarray) -> np.ndarray:
    return a.T


def _dhwio_to_oidhw(a: np.ndarray) -> np.ndarray:
    return a.transpose(4, 3, 0, 1, 2)


def _oidhw_to_dhwio(a: np.ndarray) -> np.ndarray:
    return a.transpose(2, 3, 4, 1, 0)


def _hwio_to_oihw(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1)


def _oihw_to_hwio(a: np.ndarray) -> np.ndarray:
    return a.transpose(2, 3, 1, 0)


def _flax_to_torch_transposed(a: np.ndarray) -> np.ndarray:
    return a[::-1, ::-1].transpose(2, 3, 0, 1)


def _torch_to_flax_transposed(a: np.ndarray) -> np.ndarray:
    return a.transpose(2, 3, 0, 1)[::-1, ::-1]


def _columns(lo: int, hi: int):
    """Columns ``lo:hi`` of a fused flax kernel, transposed to ``[out, in]``."""
    def fn(a: np.ndarray) -> np.ndarray:
        return a[:, lo:hi].T
    fn.inverse = _transpose
    return fn


# each mapping's inverse (torch layout -> the flax leaf, or its share of the
# columns of a fused leaf)
_identity.inverse = _identity
_transpose.inverse = _transpose
_dhwio_to_oidhw.inverse = _oidhw_to_dhwio
_hwio_to_oihw.inverse = _oihw_to_hwio
_flax_to_torch_transposed.inverse = _torch_to_flax_transposed


def flax_targets(module: nn.Module) -> Dict[Path, List[Target]]:
    """flax leaf path -> the torch parameter(s) it fills and how."""
    targets: Dict[Path, List[Target]] = {}

    def add(path: Path, param: nn.Parameter, fn) -> None:
        targets.setdefault(path, []).append((param, fn))

    def visit(mod: nn.Module, prefix: Path) -> None:
        if isinstance(mod, Dense):
            add(prefix + ("kernel",), mod.weight, _transpose)
            if mod.bias is not None:
                add(prefix + ("bias",), mod.bias, _identity)
            return
        if isinstance(mod, (LayerNorm, _BatchNorm)):  # BatchNorm's statistics: _stat_targets
            add(prefix + ("scale",), mod.weight, _identity)
            add(prefix + ("bias",), mod.bias, _identity)
            return
        if isinstance(mod, (Conv3D, Conv2D, ConvTranspose2D, nn.Conv2d)):
            fn = {Conv3D: _dhwio_to_oidhw, Conv2D: _hwio_to_oihw, nn.Conv2d: _hwio_to_oihw,
                  ConvTranspose2D: _flax_to_torch_transposed}[type(mod)]
            add(prefix + ("kernel",), mod.weight, fn)
            if mod.bias is not None:
                add(prefix + ("bias",), mod.bias, _identity)
            return
        if isinstance(mod, Attention):
            visit(mod.to_q, prefix + ("to_q",))
            visit(mod.to_out, prefix + ("to_out",))
            inner = mod.to_k.weight.shape[0]
            add(prefix + ("to_kv", "kernel"), mod.to_k.weight, _columns(0, inner))
            add(prefix + ("to_kv", "kernel"), mod.to_v.weight,
                _columns(inner, 2 * inner))
            return
        for name, p in mod.named_parameters(recurse=False):
            add(prefix + (name,), p, _identity)
        for name, child in mod.named_children():
            visit(child, prefix + (name,))

    visit(module, ())
    return targets


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    leaves: Dict[Path, np.ndarray] = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            leaves.update(_flatten(value, path))
        else:
            leaves[path] = np.asarray(value)
    return leaves


def _param_names(module: nn.Module) -> Dict[int, str]:
    return {id(p): name for name, p in module.named_parameters()}


def _split_variables(tree: Mapping):
    """``(params, batch_stats or None)`` of a flax variables dict, or
    ``(tree, None)`` for a bare parameter tree."""
    if "params" in tree and set(tree.keys()) <= {"params", "batch_stats"}:
        return tree["params"], tree.get("batch_stats")
    return tree, None


def flax_tree_to_tensors(module: nn.Module, tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax-layout tree (``{'params': {...}}`` or the inner dict; a
    ``batch_stats`` collection beside ``params`` is not read here) as the
    port's ``parameter name -> f32 CPU tensor``. Raises ``ValueError`` on an
    unexpected, missing or misshapen leaf, and on a torch parameter the tree
    does not set."""
    tree, _ = _split_variables(tree)
    leaves = _flatten(tree)
    targets = flax_targets(module)
    names = _param_names(module)

    errors = []
    unexpected = sorted(set(leaves) - set(targets))
    missing = sorted(set(targets) - set(leaves))
    errors += [f"unexpected leaf {'/'.join(p)}" for p in unexpected]
    errors += [f"missing leaf {'/'.join(p)}" for p in missing]
    covered = {id(param) for entries in targets.values() for param, _ in entries}
    errors += [f"torch parameter {name} has no flax leaf"
               for name, param in module.named_parameters() if id(param) not in covered]

    out: Dict[str, torch.Tensor] = {}
    for path in sorted(set(leaves) & set(targets)):
        for param, fn in targets[path]:
            value = np.ascontiguousarray(fn(leaves[path]))
            if tuple(value.shape) != tuple(param.shape):
                errors.append(f"shape of {'/'.join(path)}: flax "
                              f"{tuple(leaves[path].shape)} maps to "
                              f"{tuple(value.shape)}, torch {tuple(param.shape)}")
                continue
            out[names[id(param)]] = torch.tensor(value, dtype=param.dtype)
    if errors:
        raise ValueError("flax tree does not match the module:\n  " + "\n  ".join(errors))
    return out


def _stat_targets(module: nn.Module) -> Dict[Path, Tuple[str, torch.Tensor]]:
    """flax ``batch_stats`` leaf path -> (buffer name, the BatchNorm buffer
    it fills)."""
    targets: Dict[Path, Tuple[str, torch.Tensor]] = {}
    for name, mod in module.named_modules():
        if isinstance(mod, _BatchNorm):
            prefix = tuple(name.split(".")) if name else ()
            for leaf, buf in (("mean", "running_mean"), ("var", "running_var")):
                full = f"{name}.{buf}" if name else buf
                targets[prefix + (leaf,)] = (full, getattr(mod, buf))
    return targets


def batch_stats_to_tensors(module: nn.Module, stats: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``batch_stats`` tree as ``buffer name -> f32 CPU tensor`` of the
    module's BatchNorm running statistics; strict as ``flax_tree_to_tensors``."""
    leaves = _flatten(stats)
    targets = _stat_targets(module)
    errors = [f"unexpected batch_stats leaf {'/'.join(p)}"
              for p in sorted(set(leaves) - set(targets))]
    errors += [f"missing batch_stats leaf {'/'.join(p)}"
               for p in sorted(set(targets) - set(leaves))]
    out: Dict[str, torch.Tensor] = {}
    for path in sorted(set(leaves) & set(targets)):
        name, buf = targets[path]
        value = np.ascontiguousarray(leaves[path])
        if tuple(value.shape) != tuple(buf.shape):
            errors.append(f"shape of batch_stats {'/'.join(path)}: flax "
                          f"{tuple(value.shape)}, torch {tuple(buf.shape)}")
            continue
        out[name] = torch.tensor(value, dtype=buf.dtype)
    if errors:
        raise ValueError("batch_stats do not match the module:\n  " + "\n  ".join(errors))
    return out


def load_flax_params(module: nn.Module, tree: Mapping) -> None:
    """Fill ``module`` from a flax parameter tree, or from ``{'params': ...,
    'batch_stats': ...}`` (a module with BatchNorm needs the statistics).
    Strict as ``flax_tree_to_tensors``: any mismatch raises before a single
    parameter or buffer is written."""
    params_tree, stats = _split_variables(tree)
    values = flax_tree_to_tensors(module, params_tree)
    stat_values = {}
    if stats is not None or _stat_targets(module):
        stat_values = batch_stats_to_tensors(module, stats or {})
    params = dict(module.named_parameters())
    buffers = dict(module.named_buffers())
    with torch.no_grad():
        for name, value in values.items():
            params[name].copy_(value)
        for name, value in stat_values.items():
            buffers[name].copy_(value)


def batch_stats_tree(module: nn.Module) -> dict:
    """The module's BatchNorm running statistics as a flax ``batch_stats``
    tree of numpy arrays (the inverse of ``batch_stats_to_tensors``)."""
    tree: dict = {}
    for path, (_, buf) in _stat_targets(module).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = buf.detach().cpu().float().numpy().copy()
    return tree


def tensors_to_flax_tree(module: nn.Module, tensors: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of ``flax_tree_to_tensors``: ``parameter name -> tensor``
    (parameters, gradients or moments of ``module``) as ``{'params': nested
    dicts of numpy arrays}`` in the flax layout, ``to_k | to_v`` re-fused into
    ``to_kv``. Every parameter of the module must be present."""
    names = _param_names(module)
    missing = sorted(set(names.values()) - set(tensors))
    if missing:
        raise ValueError(f"no tensor for parameters {missing}")
    tree: dict = {}
    for path, entries in flax_targets(module).items():
        parts = [fn.inverse(tensors[names[id(param)]].detach().cpu().float().numpy())
                 for param, fn in entries]
        leaf = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=-1)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(leaf)
    return {"params": tree}


def leaf_groups(module: nn.Module) -> List[List[str]]:
    """Sets of parameter names that are ONE leaf of the flax tree (``to_k`` and
    ``to_v`` of each attention): the optimizer takes LAMB's trust ratio over
    each set as a whole."""
    names = _param_names(module)
    return [[names[id(param)] for param, _ in entries]
            for entries in flax_targets(module).values() if len(entries) > 1]


def opt_state_from_optax(module: nn.Module, count, mu: Mapping, nu: Mapping,
                         device=None):
    """``optax.lamb`` / ``scale_by_adam`` state, given as numpy (``count`` and
    the ``mu`` / ``nu`` trees in the flax parameter layout), as the port's
    ``optim.OptState`` on ``device``."""
    from voxactb_tpu_torch.optim import OptState

    move = lambda d: {k: v.to(device) for k, v in d.items()}
    return OptState(torch.tensor(int(count), dtype=torch.int64, device=device),
                    move(flax_tree_to_tensors(module, mu)),
                    move(flax_tree_to_tensors(module, nu)))


def _adam_entry(opt_state: Mapping) -> Mapping:
    """The ``scale_by_adam`` state (``count``, ``mu``, ``nu``) inside the
    ``to_state_dict`` of an optax chain's state."""
    entries = [v for v in opt_state.values()
               if isinstance(v, Mapping) and {"count", "mu", "nu"} <= set(v)]
    if len(entries) != 1:
        raise ValueError(f"no single scale_by_adam state in the optimizer state "
                         f"(entries {sorted(opt_state)})")
    return entries[0]


def opt_state_from_flax(module: nn.Module, opt_state: Mapping, device=None):
    """The port's ``OptState`` from a JAX checkpoint's ``opt_state``
    (``to_state_dict`` of ``optax.lamb``'s state, whose ``'0'`` holds the
    Adam moments, or of the Adam chain's, whose ``'1'`` does)."""
    adam = _adam_entry(opt_state)
    return opt_state_from_optax(module, np.asarray(adam["count"]), adam["mu"], adam["nu"],
                                device)


def optax_state_tree(module: nn.Module, state, kind: str, scheduled: bool) -> dict:
    """The port's ``OptState`` as the ``to_state_dict`` of the JAX agent's
    optimizer state, numpy leaves: ``optax.lamb`` (``'0'`` Adam moments,
    ``'1'``-``'3'`` empty but the schedule's count in ``'3'``) or the Adam
    chain (``'0'`` empty, ``'1'`` moments, ``'2'`` the schedule's count)."""
    count = np.asarray(int(state.count), np.int32)
    adam = {"count": count, "mu": tensors_to_flax_tree(module, state.mu),
            "nu": tensors_to_flax_tree(module, state.nu)}
    sched = {"count": count.copy()} if scheduled else {}
    if kind == "lamb":
        return {"0": adam, "1": {}, "2": {}, "3": sched}
    if kind == "adam":
        return {"0": {}, "1": adam, "2": sched}
    raise ValueError(f"Unknown optimizer type {kind!r}")


# -- the baseline zoo (models/baselines.py) ------------------------------------


def baseline_state_dict_from_flax(module: nn.Module, tree: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX baseline's flax tree (``{'params': ...}`` of numpy arrays, as
    ``BCLangAgent`` saves it, or the inner dict) as the state_dict of the
    port's ``CnnLangPolicy``, ``ViTLangPolicy`` or ``LingUNetQNet``.

    The baselines' modules carry flax's names, so the bridge above maps them:
    ``nn.Conv`` HWIO -> OIHW (``Conv3D`` DHWIO -> OIDHW), ``nn.Dense``
    transposed, LayerNorm ``scale`` -> ``weight``; the attention's
    ``DenseGeneral`` kernels and the ViT's ``pos`` are held in flax's layout
    and copied as they are. Strict: a ``pos`` sized for another token count,
    a camera too many or a missing leaf raises."""
    return flax_tree_to_tensors(module, tree)


def baseline_flax_tree(module: nn.Module,
                       state_dict: Mapping[str, torch.Tensor] = None) -> dict:
    """The inverse: the module's parameters (or ``state_dict``) as the JAX
    baseline's ``{'params': ...}`` tree of f32 numpy arrays, the tree the JAX
    ``BCLangAgent`` writes to ``{name}.msgpack``."""
    if state_dict is None:
        state_dict = dict(module.named_parameters())
    return tensors_to_flax_tree(module, state_dict)
