"""Weight bridge between a flax parameter tree and the port's modules.

``load_flax_params(module, tree)`` takes the JAX package's parameter tree as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``)
and fills the port's module, matching by name (the port's submodules carry the
flax names). It is strict on both sides: every leaf of the tree is consumed
exactly once, every torch parameter is set, every shape is checked, and any
mismatch raises before a single parameter is written.

Mappings: Dense ``kernel [in, out]`` -> ``weight [out, in]``; Conv ``kernel
DHWIO`` -> ``weight OIDHW``; LayerNorm ``scale/bias`` -> ``weight/bias``; the
attention's fused ``to_kv`` kernel splits into ``to_k`` (first half of the
output columns) and ``to_v`` (second half); everything else (``pos_encoding``,
``latents``, ``up0/out_kernel``, ``up0/out_bias``) is copied as it is.

The same mapping carries anything laid out like the parameters:
``flax_tree_to_tensors`` turns a flax-layout tree (parameters, or optax's
``mu`` / ``nu``) into the port's ``name -> tensor`` dictionary,
``tensors_to_flax_tree`` is its inverse (parameters or gradients back into the
flax layout as numpy, ``to_k | to_v`` re-fused), and ``opt_state_from_optax``
builds the port's optimizer state from ``optax.lamb``'s ``count``, ``mu`` and
``nu``, so a test can start both packages from one state.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from voxactb_tpu_torch.models.blocks import Conv3D, Dense, LayerNorm
from voxactb_tpu_torch.models.perceiver import Attention

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
        if isinstance(mod, LayerNorm):
            add(prefix + ("scale",), mod.weight, _identity)
            add(prefix + ("bias",), mod.bias, _identity)
            return
        if isinstance(mod, Conv3D):
            add(prefix + ("kernel",), mod.weight, _dhwio_to_oidhw)
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


def flax_tree_to_tensors(module: nn.Module, tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax-layout tree (``{'params': {...}}`` or the inner dict) as the
    port's ``parameter name -> f32 CPU tensor``. Raises ``ValueError`` on an
    unexpected, missing or misshapen leaf, and on a torch parameter the tree
    does not set."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
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


def load_flax_params(module: nn.Module, tree: Mapping) -> None:
    """Fill ``module`` from a flax parameter tree. Strict as
    ``flax_tree_to_tensors``: any mismatch raises before a single parameter is
    written."""
    values = flax_tree_to_tensors(module, tree)
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name, value in values.items():
            params[name].copy_(value)


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
